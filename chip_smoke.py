#!/usr/bin/env python3
"""The port's main path on one GPU, end to end — the quickest proof that
ptrt_tpu_torch still starts on the card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. environment: card name and power limit, torch / CUDA / nvcc versions;
  2. build: the CUDA kernels (nvcc, one process per source, all started
     together) and the native BVH builder (g++), from the checkout's
     sources;
  3. every kernel of the main path against its plain torch version on the
     card, on the inputs the path gives it: K1 closest_hit and K2 any_hit on
     a full 256x144 frame of camera, bounce and shadow rays over a ~20k
     triangle bench scene, and on the full scene's four 1920x1080
     wavefronts (camera, bounce 1, bounce 3 of a sample's PathState,
     shadow): on a 4096-ray sample, at full width held at those rays to
     the plain answers, permuted and on two streams at once (bit for bit
     the unpermuted answers), through the alive plane (K1, bit for bit
     the t_max plane's), timed beside each wavefront's own bound, and
     counted (nodes visited and triangles tested a ray, K1 also in slot
     order; the counting walk held to its plain walk on 256 rays); the
     walks' registers and occupancy; K6 tonemap_rgb8 on a 1920x1080 HDR
     frame (within 1 LSB, its exact share, beside its bound and the issue
     time of the SASS instructions a thread runs; its registers and blocks
     a SM); row_gather (off the
     main path since K3) at the Pallas probes' shapes
     (ptrt_tpu_torch/tools/probe_gather.py) and at the material gather's
     (the scene's table, 2,073,600 ids), bit for bit;
  3b. K3, shade_nee and shade_scatter, against their plain stages on the
     full 1920x1080 bench scene (the wavefronts of bounces 0-3 of sample 0,
     split off and on, the same state and hit records for both; each stage
     timed on each wavefront beside that wavefront's bound, with the share
     of warps that hold a live lane) and on random
     lanes of every material lobe and light type (65,536; a ragged 16,421
     with the tables in global memory, and again with 360 material rows
     staged, which pass 48 KB beside the scatter's list; 65,536 all
     dead): PCG states
     bit-exact, flags and lobes agreeing on at least 99.99% of lanes, values
     within the tiers of tests/test_torch_shading.py, under the record's
     contract (render/shade.py: a dead lane's record is unspecified);
     shade_scatter also on the plain stage's own inputs, equal on every
     lane; the K3 kernels' registers and resident blocks a SM;
  3c. K3's HDRI instantiations (shade_nee<true>, shade_scatter<true>: the
     HDRI sky fetch, env NEE through the alias table, the env MIS) against
     their plain stages on the "hdri" scene (the bench scene at 1920x1080
     with a directional and an area light besides its four, under a seeded
     4096x2048 float32 map at rotation 0.7: app/bench_scene.py
     build_hdri_scene): the wavefronts of bounces 0-3, split off and on,
     each stage and K2 on the env shadow rays timed beside its bound; random
     lanes of every lobe under maps at rotations 0.7 and -3.0 with
     directions at the map's wrap (ragged with the tables in global
     memory, and with tables staged that pass 48 KB beside the kernels'
     lists), and all dead: PCG states bit-exact, the env record under its
     contract (t_max equal on every lane, the rest where NEE, with the
     share of bit-exact lanes a field), shade_scatter equal to its plain
     stage on the same inputs on every lane; K2 on the env shadow rays
     against its plain walk on a sample; the registers and blocks a SM of
     both instantiations (those without env NEE held to what they had
     before the HDRI one existed: shade_nee 64 and 4, shade_scatter 64 and
     4 at bounce 0, 80 and 3 after; the HDRI kernels held to HDRI_DESIGN:
     registers, blocks a SM and ptxas's spill bytes, and their blocks,
     lanes and staged bytes to render/shade.py's launch plans); each time
     beside the first design's (HDRI_FIRST) and the four bounces' sums;
  4. the bench path: Scene.render_frame() on the bench scene at 1920x1080,
     4 spp, depth 4, ~1M triangles, post stack off — one warm-up and three
     timed frames, with the kernels' launch counts taken over exactly that
     run (K1, K2 and K3 once a bounce of each sample, no material-plane
     gather), then one frame under torch.profiler (device time, launches,
     and 10 launches a later bounce: no t_max select before K1, no bool
     cast after K2), then the progressive average once more under
     torch.cuda.set_sync_debug_mode("error") (no host copy);
  5. the balanced path: the same scene under the reference's default
     ("balanced") preset — 1 spp, depth 4, split trace, motion vectors,
     SVGF, bloom, tonemap — one warm-up and five timed frames with the
     camera orbiting 0.5 degrees before each, launch counts taken over the
     timed frames (the bloom one launch a frame and K6 one: no plain-torch
     bloom op); then the post stages timed one by one and one profiled
     frame, whose one bloom launch must come right before K6;
  6. svgf_temporal, svgf_atrous, the bloom chain and K6 against their plain
     versions on the 1920x1080 buffers of a balanced frame: svgf_temporal
     on each channel with and without a history cap and on both channels
     in one launch (bit for bit each channel alone), first frame off and
     on, at 1920x1080 and at odd sizes, timed queued (two readings) beside
     each launch's own bound; svgf_atrous
     exactly, at each of the seven passes a frame runs (diffuse at steps 1,
     2, 4, 8, 16, specular at 1, 2), each timed beside its own bound, and
     at odd sizes (crops that are no multiple of a tile, smaller than the
     halo, one pixel; steps without a kernel of their own; object ids on
     and off); bloom_chain (one cooperative launch: the bright pass, six
     mips, the upsample-add) bit for bit at every mip, at mip 0 after the
     upsample-add and on the composite, at 1920x1080 and the odd sizes, and
     K6 with the bloom's mip 0 within 1 LSB (its exact share), both timed
     queued (two readings) beside their bounds, then captured in a CUDA
     graph and replayed bit-identically; the temporal and a-trous kernels'
     tiles, registers and occupancy;
  7. the hdri scene's balanced path: one warm-up and five timed frames
     with the camera orbiting, launch counts taken over the timed frames
     (a bounce: K1, K2 twice, the HDRI instantiations of K3, never the
     others), then one profiled frame;
  8. the ultra preset on the hdri scene (1920x1080, 128 spp in eight
     chunks of 16, depth 32, roulette from bounce 8, bloom): one profiled
     warm-up frame and one timed frame, with its launches;
  9. end to end on small inputs: the bench frame, three balanced frames and
     an hdri frame rendered on the GPU and on the CPU (plain versions) must
     agree;
 10. dynamic geometry on the "dynamic" scene (app/bench_scene.py
     build_dynamic_scene: the 1920x1080 bench scene, balanced, with 192
     building slots moved every frame, a 130,050-triangle heightfield
     refilled, an 8,192-triangle sphere Morton-refilled): K4
     instances_closest / instances_any on the camera, bounce-1 and shadow
     wavefronts against their plain version on a 4096-ray sample (hit, mesh
     and instance equal, t within K4_T_ATOL), at full width, on two streams
     at once (bit for bit), against the same transforms baked into one
     static world walked by K1 / K2, each timed beside its bound, with the
     instance-tree boxes a live ray tests (the plain descent, beside the
     flat test's one a instance); K4 against its plain
     version on a world of two identical instances (the lower id wins) and
     on sets of 1, 9, 512, 513, 2,048 and 8,192 instances (each set's tree
     built on the host, timed, and the boxes a live ray tests; on 1M rays
     the kernel the set takes, the set staged in shared memory or read
     from global memory, timed beside the bound); a 256x144 Scene of 513 dynamic meshes (512 cubes
     and a Morton-refilled sphere past morton_sort's most) rendered on
     the GPU and on the CPU after an edit; K5 refit and the Morton refill
     bit for bit against their plain versions on every table, at the
     heightfield, the sphere, odd sizes and the refill's shapes (1,001 to
     1,045,506 triangles, and 1,001 with every code tied), refit bit for
     bit after its first refit and after its queued repeats at every
     shape, its root box that of the plain version, the counters back at
     zero, its registers, shared bytes and blocks a SM; the heightfield and the
     sphere refitted on two streams at once, bit for bit; an empty
     kernel's queued launch (the floor under the small kernels); the
     order through morton_sort up to its limit and through morton_codes
     and torch.sort at every size, each timed; one warm-up and five
     timed dynamic frames (the counters: no host BVH build, 192 transform
     updates, 2 refits, 1 LBVH build a frame; the launches) and a profiled
     one; a 64x48 dynamic frame on the GPU and on the CPU;
 11. the one-bounce RT backend on the "rt" scene (app/bench_scene.py
     build_rt_bench_scene: the bench scene's 1,007,574 triangles, 17
     materials, its four lights and gradient sky in an RTScene at
     1920x1080): a warm-up and three timed frames with their launches
     (K1, K2, rt_light_rays and rt_shade twice a frame, rt_glass_rays and
     rt_resolve once: the glass pass walks and shades 2G rays for the G
     glass lanes), the host time of a call, the image's RGB8 SHA-256, and
     one profiled frame split by pass and kernel;
     each K10 kernel (csrc/rt_shade.cu) against its plain version on the
     frame's own K1 / K2 records: hit and front flags, the shadow rays'
     t_max on missed lanes exact, the glass records (the lanes in lane
     order, the index plane, seeds, t_max) exact, rt_shade's colours on
     both passes exact, the rest within the RT_* tiers, K2 on the plain
     stage's shadow rays equal to the frame's occlusion bits where the
     rays are the same, RGB8 within 1 LSB; the frame against the frame the
     plain stages build from
     the same walk records (within 1 LSB on RT_FRAME_AGREE of the pixels,
     the rest counted by cause); each kernel timed queued beside its bound
     and its plain version, and alone by CUDA events around its launch
     (rt_glass_rays' time: its wrapper reads G to the host), with its
     registers, local bytes, blocks a SM
     and staged shared bytes, rt_shade and rt_light_rays also on the glass
     rays; a 256x144
     RTScene of the same scene on the GPU and on the CPU.  rt_resolve
     (the encode pass over every pixel) and rt_resolve_glass (the glass
     lanes' pixels again) equal to the plain resolve on every pixel, the
     RGB8 SHA-256 the earlier designs gave, each timed alone beside its
     bound (the encode pass also beside the issue time of its SASS;
     rt_resolve_glass by the profiler in the profiled frame, with its
     grid on the host's G and on a device count), and
     the encode's table equal to the plain encode on all 2^32 float32
     colours;
 12. the PT Scene API: render_wireframe at 1920x1080 (a 98-triangle scene
     GPU vs CPU within 1 LSB, the 1M-triangle bench scene's timed; its
     launches on the 98-triangle scene, the same with two instances (K4)
     and the bench scene counted from zero; its kept program, a CUDA
     graph, replayed bit for bit its eager body on each of the three with
     a thickness and two camera changes between calls, one program made,
     no synchronizing call in a replay, one replay's device ms and kernels,
     host ms a call eager against the program in turns),
     trace_single_ray GPU vs CPU, warmup() (the next balanced frames
     bit-identical to an unwarmed scene's) and a checkpoint after 3
     balanced frames (the 4th frame bit-identical after a load into a
     fresh scene);
 13. the tiled trace (run after phase 4, on the bench scene in its bench
     settings): trace_frame of the 1920x1080 frame whole, in 2x2 tiles and
     in an uneven 3x3 split, and split (the denoiser's channels) whole and
     in 2x2 tiles; tiles put together equal to the whole frame bit for bit
     (colour, split channels, G-buffer, the next PCG state, rays summed);
     the launches of K1, K2 and K3 a sample and bounce of each tile;
 14. the unified scene layer and the demo: UnifiedScenePresets.CornellBox
     and GlassDemo at 1920x1080 built into a PT Scene and an RTScene, a
     warm-up and three frames each; `python -m ptrt_tpu_torch.app.demo`'s
     main for --backend pt and rt, three 1920x1080 frames each, into a
     temporary directory (its PPM read back); frame ms and launches;
 15. the games (ptrt_tpu_torch/games) and K11 instances_update
     (csrc/instances.cu): K11 against instances_update_plain at 1, 10, 32,
     33, 192, 1,024 (the wrapper's one-block most), 1,025 and 8,192
     instances (rows and boxes equal, lanes that differ counted; the tree
     bit for bit build_tlas of K11's own boxes; K4 closest and any-hit over
     it bit for bit over build_tlas's tree), each timed queued beside its
     bound and the plain version with that version's launches (the log
     gives the first design's times beside them), the grid path's scratch allocated
     once (addresses fixed); K11's registers and local memory (no spills;
     only sinf / cosf's slow path); every game's fused run
     (games/fused.FusedRunner) under a guard that makes the host scene updates
     raise: cube slider and tycoon (192 slots) at 640x360 "fast", the 24x24
     fluid at 320x180 plain and Morton-refilled, tycoon and the 256x256 fluid
     (130,050 triangles) at 1920x1080 "balanced" — frames a second, the
     launches (K11 once a frame), one profiled frame (device ms, launches,
     K11's kernel), the upscale's device and host time, the synchronizing calls
     of one frame under torch.cuda.set_sync_debug_mode("warn"), each with its
     source line, and the profiler's trace of one frame (device-to-host
     copies and synchronizing runtime calls inside it): both must be none;
     K4 closest and any-hit over K11's tree bit for bit those over
     build_tlas's tree of the same boxes; each game's run_headless; a 224x126
     fused cube-slider frame GPU vs CPU;
 16. the pixel mesh (ptrt_tpu_torch/parallel): the balanced 1920x1080
     bench frame from one saved state, unmeshed and with its trace over
     meshes of 1, 2, 4 and 8 tiles (one card: a stream a tile), each bit for
     bit the unmeshed frame (RGB8, the next PCG state, the rays), with its
     host ms, device ms and launches (no timing claim); then
     parallel.dryrun.dryrun_multichip(8) on the card;
 17. the golden corpus: the eight recipes of ptrt_tpu_torch/tools/golden.py
     rendered on the card at 320x180, each at least 35 dB PSNR against its
     reference render in tests/golden/;
 18. the one-program frame (ptrt_tpu_torch/graphs.py): every fused game
     run of phase 15 and tycoon on a 19x19 map (1,083 instances: K11's
     grid path and torch.sort captured), each from one start eager
     (FusedRunner.frame, the frame index a host int) against the frame
     captured once as a CUDA graph and replayed (the index and inputs
     staged on the card): RGB8, game state, PCG state, denoiser history
     and view-projection bit for bit at each of 30 frames, with the camera
     still and moved at frame 15; frames a second and host ms a frame of
     both loops in turns; one replay's device ms and kernels (profiler);
     its synchronizing calls (sync debug mode and the trace: none);
     entry() captured, three replays bit for bit three eager calls;
     bench_games with 10 frames a run (three games x three presets);
 19. the scenes' frame programs (ptrt_tpu_torch/graphs.py Program: on the
     card a CUDA graph per configuration, replayed every later frame): K1
     and K2 on a device count against the host count (records bit for bit
     on the camera, bounce-1 and shadow wavefronts, times in turns); then,
     each from one state eager (Scene.render_world; RTScene.render_eager
     with the glass count read to the host; trace_frame) against its
     programs, bit for bit at every frame (RGB8, PCG state, denoiser
     history, progressive sum and count, prev_view_proj): the bench
     trace-only frame, balanced 1080p orbiting 0.5 degrees a frame, fast
     with the progressive average (the camera moved at frame 15), hdri
     balanced (an HDRI rotation at frame 10), ultra (3 frames: the chunk
     and post programs), dynamic (animate and its K5 refits each frame, a
     material and a light edit at frame 10, a mesh added at frame 20: a
     new key), rt (30 frames each); for each the programs made, their
     capture s and pool bytes, 0 synchronizing calls a frame with no edit,
     frames a second eager and through the programs in turns, host ms to
     issue a frame, one frame's device ms and kernels; the dynamic frame's
     host ms split; the port's bench.py at its defaults on phase 3's
     scene (its JSON line printed) and bench_presets at 640x360 (10 timed
     frames a preset, one for the two ultra presets);
 20. the fidelity corpus (ptrt_tpu_torch/tools/fidelity.py): its seven
     recipes (four showcase scenes and a frame of each game) through
     fidelity.render on the card at 640x360, 48 balanced frames each with
     motion vectors off, written to build/fidelity/ (mean, first frame ms,
     ms a frame; the renders' launches counted from zero), and each at
     96x54, 3 frames, on the card and on the CPU at least 35 dB apart (the
     largest LSB difference printed).
Every kernel's line carries its bound: the bytes it must move (each input
read once, each output written once) over 3.35 TB/s or its float operations
over 67 TFLOP/s, whichever is larger (a walk: each wavefront's own ray
plane for every ray, origin and direction only for its live rays, the
answers, and the BVH's rows read once).  A `[rank]` line gives the device
ms a frame each kernel stands over its bound.  The line
before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Without a GPU, or outside the repository,
the script fails.
"""

import collections
import json
import math
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

W, H, SPP, DEPTH, TRIS = 1920, 1080, 4, 4, 1_000_000
BENCH_RAYS_PER_FRAME = 20.59e6  # the reference's count for this config
SAMPLE_RAYS = 4096
K1_K2_AGREE = 0.9999
# the counting walks against their plain walk on this many sampled rays:
# node and triangle tallies within COUNT_RTOL (FMA contraction on the card
# can move a grazing slab or triangle test either way)
COUNT_SAMPLE, COUNT_RTOL = 256, 0.01
# kernels a later bounce of the bench frame launches (K1 of bounce 1 or 2
# to the next K1): K1, shade_nee, the NEE ray count (a cast, a sum, an add),
# K2, shade_scatter, the next bounce's ray count (3 more); without the t_max
# select before K1 and the bool cast after K2
BOUNCE_LAUNCHES = 10
# the balanced path: timed frames, orbit step about the bench camera's
# look-at point, and its bounce depth (the preset's)
BAL_FRAMES, ORBIT_DEG, BAL_DEPTH = 5, 0.5, 4
LOOKAT, ORBIT_R, EYE_Y = (0.0, 0.0, 6.0), 7.5, 1.2
# SVGF kernels vs plain on the card: share of pixels within
# rtol 1e-5 + atol 1e-6 (the plain version's x / 3.0 multiplies by a
# rounded reciprocal on the card; the kernel divides), and of equal
# history lengths
SVGF_AGREE = 0.9999
# shade_nee / shade_scatter vs their plain stages: least share of lanes
# whose flags (alive, specular, NEE, t_max < 0) agree and whose lobe agrees
# (sampled direction within rtol 1e-3); on those lanes the values are held
# to test_torch_shading.py's tiers, (rtol, least share of lanes)
SHADE_AGREE = 0.9999
DIRECTION = ((1e-5, 1.0),)
VALUE = ((1e-5, 0.995), (1e-3, 1.0))
AT_PEAK = ((1e-5, 0.85), (1e-3, 0.995), (0.5, 1.0))
SHADE_RANDOM_LANES = 1 << 16
# float operations per item, for the operations side of a bound: a floor
# counted from each kernel's source.  Every float add, multiply, divide,
# compare, min/max, abs and square root that the item runs whatever its
# data counts one, a transcendental (exp, log, pow) one; code behind a
# data-dependent branch or a short-circuited test counts nothing, and a
# term the compiler may share between two inlined functions counts once,
# so the bound stays a least time.
OPS_PER_ITEM = {
    # shade.cu shade_scatter, a live lane: material_scatter's code outside
    # its lobe branches (the Fresnel, coat and dielectric terms 76; three
    # draws and the lobe test 4; the sampled direction normalised, its
    # cosines and half vector 42; the coat attenuation 11; the base lobe's
    # D 10, G 14, F 12 and pdf 4 past the terms shared above; the sums 4)
    # and the roulette's 5
    "shade_scatter": 76 + 4 + 42 + 11 + 40 + 4 + 5,
}
SHADE_STAGED_BYTES = 48 * 1024  # shade.cu stages tables up to this size
# the static lists a K3 block keeps in shared memory from bounce 1 on:
# shade_scatter's 1,024 lanes and states, the HDRI shade_nee's 1,024 lanes,
# slots and states (and the counts); with them a block's tables and lists
# pass 48 KB, the default cap, so the kernels raise it.  A table of
# STAGED_BESIDE_LISTS material rows (128 B each) is staged past that sum.
SCATTER_LIST_BYTES, NEE_LIST_BYTES = 1024 * 8 + 4, 1024 * 12 + 8
STAGED_BESIDE_LISTS = 360
# K3's HDRI kernels as designed (csrc/shade.cu): registers, resident blocks
# of 256 threads a SM, and ptxas's spill bytes (stores, loads); each
# kernel's mangled name holds its key
HDRI_DESIGN = {"shade_nee (hdri)": (73, 3, (0, 0)),
               "shade_nee (hdri) from bounce 1": (75, 3, (0, 0)),
               "shade_scatter (hdri)": (64, 4, (56, 76)),
               "shade_scatter (hdri) from bounce 1": (80, 3, (20, 12))}
HDRI_KERNELS = {"shade_nee (hdri)": "shade_nee_kernel_hdriILb0E",
                "shade_nee (hdri) from bounce 1": "shade_nee_kernel_hdriILb1E",
                "shade_scatter (hdri)": "shade_scatter_kernelILi1ELb1E",
                "shade_scatter (hdri) from bounce 1":
                    "shade_scatter_kernelILi4ELb1E"}
# their first design's ms at bounces 0-3 on the 1080p "hdri" wavefronts,
# unsplit (False) and split (True), as PERF.md's kernel table keeps them
# (NVIDIA H100 80GB HBM3, 700 W)
HDRI_FIRST = {"shade_nee": {False: (0.2513, 0.2474, 0.1598, 0.1177),
                            True: (0.2751, 0.2713, 0.1647, 0.1259)},
              "shade_scatter": {False: (0.1570, 0.0998, 0.0752, 0.0550),
                                True: (0.1943, 0.1245, 0.0904, 0.0614)}}
# the odd sizes the post kernels are held at besides 1920x1080: crops that
# are no multiple of a tile, smaller than a halo, one pixel
ODD_SIZES = ((23, 37), (75, 101), (1, 1), (270, 333))
# K4 against its plain version: t within this (K1's own largest error on
# the bench wavefronts); against the same transforms baked into one
# static world walked by K1 / K2: the share of rays whose hit and mesh id
# agree (grazing rays may cross an edge either way)
K4_T_ATOL, K4_BAKED_AGREE = 2.8e-5, 0.9999
# K4 on hand-made instance sets too: the tie world (two identical
# instances), then sets of these sizes, each at this many seeded rays
K4_SET_SIZES = (1, 9, 512, 513, 2048, 8192)
K4_SET_RAYS = 4096
# the Scene past K4's former cap: this many dynamic cubes and a sphere
MANY_CUBES = 512
DYN_FRAMES = 5  # the dynamic frame's timed frames
# kernels a frame without dynamic meshes never launches
STATIC_NEVER = ("instances_closest", "instances_any", "refit", "morton_sort",
                "morton_codes")
# the "rt" scene (build_rt_bench_scene at W x H, TRIS): its triangles, its
# timed frames, the triangle target of its 256x144 GPU-vs-CPU frame; K10 against its plain version on the card, (rtol, least share
# of lanes): values (points, shadow rays, glass origins), directions, colours
# (test_torch_shading.py's tiers: a roughness-0.02 GGX peak turns an ulp of
# its terms into large relative errors); the frame against the plain
# stages' frame: least share of pixels within 1 LSB
RT_TRIS, RT_FRAMES, RT_SMALL_TRIS = 1_007_574, 3, 2_000
RT_VALUE = ((1e-5, 0.995), (1e-3, 1.0))
RT_DIRECTION = ((1e-5, 1.0),)
RT_COLOR = ((1e-5, 0.85), (1e-3, 0.995), (0.5, 1.0))
RT_FRAME_AGREE = 0.99
# float operations of the K10 kernels, a floor estimated from
# csrc/rt_shade.cu as OPS_PER_ITEM's: a hit lane's record (normal, facing
# test, point, shadow origin), each light's shadow ray, rt_shade's terms
# before its light loop and each lit light's lobe, a glass lane's two rays
# (the hash, the reflection, the refraction and two perturbations);
# rt_resolve's: tools/stages.py resolve_bounds
# what each K10 kernel replaces: the JAX package's fused XLA RT frame
RT_REPLACES = {
    "rt_light_rays": "ptrt_tpu/render/rt_shading.py:163",
    "rt_shade": "ptrt_tpu/render/rt_shading.py:111",
    "rt_glass_rays": "ptrt_tpu/render/rt_shading.py:261",
    "rt_resolve": "ptrt_tpu/scene/rt_scene.py:207",
    "rt_resolve_glass": "ptrt_tpu/render/rt_shading.py:289",
}
# the Scene API phase: the bench scene's triangle target, rays traced one by
# one on the GPU and on the CPU
API_TRIS, API_RAYS = 20_000, 8
RT_OPS = {"hit": 40, "light_ray": 14, "shade": 80, "shade_light": 125,
          "glass_rays": 150}
# the 1080p rt frame's RGB8 SHA-256, the image of every design of K10 so
# far (two trees' images compare bit for bit); rt_resolve's encode sweep: float32 colour bit patterns a
# launch (all 2^32 in turn), as a (RES_SWEEP_HW, RES_SWEEP_HW) frame
RT_RGB8_SHA256 = ("8c1d10035577b3da207111262296baa37e4d86e0bd8719cf00c54f9117"
                  "35dc36")
RES_SWEEP_HW = 1 << 14
# phase 15, the games.  K11's float operations an instance, a floor counted
# from csrc/instances.cu as OPS_PER_ITEM's: the rotation's 22 products and
# sums (its six sines and cosines one each), the scale's reciprocals 9, the
# rows 30, the normal matrix 9, the corners' products 9 and their 8 x 3 x 6
# sums and min / max, the centre 6 and its code 15
K11_OPS = 22 + 6 + 9 + 30 + 9 + 9 + 8 * 3 * 6 + 6 + 15
# K11 is held at these sizes, at the wrapper's one-block limit and one past
# it; K4 walks K11_WALK_RAYS rays over each tree.  K11_FIRST_DESIGN_MS:
# K11's first design (one block of 1,024 threads up to 1,024 instances, the
# grid path past it), ms queued on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md section 5), quoted in the log beside this run's times and
# nowhere in the result
K11_SIZES = (1, 10, 32, 33, 192, 1024, 8192)
K11_WALK_RAYS = 4096
K11_FIRST_DESIGN_MS = {1: 0.0054, 10: 0.0088, 192: 0.0202, 1024: 0.0527,
                       1025: 0.0663, 2048: 0.0681, 4096: 0.0750, 8192: 0.1024}
# the fused runs: (game, width, height, preset, frames, fluid grid); the
# reference's defaults, then the full-size ones
GAME_RUNS = (("cube_slider", 640, 360, "fast", 60, None),
             ("tycoon", 640, 360, "fast", 60, None),
             ("fluid", 320, 180, "fast", 30, 24),
             ("fluid lbvh", 320, 180, "fast", 30, 24),
             ("tycoon 1080p", W, H, "balanced", 10, None),
             ("fluid 1080p", W, H, "balanced", 10, 256))
# the fused cube slider on the GPU against the CPU: its size, and the least
# share of pixels within 1 LSB (phase 9's tolerance)
GAME_SMALL_WH, GAME_SMALL_AGREE = (224, 126), 0.99
# phase 18, the one-program frame: the frames of each lock-step run (eager
# against replayed), the frame the camera moves before, the tycoon set past
# K11's one-block 1,024 instances (a 19x19 map: 1,083 slots), and the
# frames of each bench_games run
GRAPH_FRAMES, GRAPH_MOVE_AT = 20, 10
GRAPH_BIG_TYCOON = ("tycoon 1083", 640, 360, "fast", GRAPH_FRAMES, 19)
GRAPH_BENCH_GAME_FRAMES = 10
# phase 19, the scenes' frame programs: the frames of each lock-step run
# (eager against the programs), of each timed turn, of the ultra run, the
# frame an edit comes before, the frame the progressive run's camera moves
# before, the frame the dynamic run adds a mesh before; bench_presets'
# timed frames a preset (one for the two ultra presets)
PROGRAM_FRAMES, PROGRAM_TURN, PROGRAM_ULTRA_FRAMES = 30, 20, 3
PROGRAM_EDIT_AT, PROGRAM_MOVE_AT, PROGRAM_MESH_AT = 10, 15, 20
# the hdri run puts its first camera back at this frame; the dynamic scene
# adds and removes a mesh this many times (the programs kept stay bounded)
PROGRAM_PUT_BACK_AT, PROGRAM_MESH_CYCLES = 25, 4
PRESET_FRAMES = 10
# phase 16: the pixel meshes the balanced 1080p frame is traced over (on
# one card, a stream a tile)
MESH_TILES = (1, 2, 4, 8)


def bound(nbytes: float, ops: float = 0.0) -> dict:
    """The least time the card could take for these bytes and float
    operations (``tools/stages.bound``, which holds the card's peaks)."""
    from ptrt_tpu_torch.tools.stages import bound as stages_bound

    return stages_bound(nbytes, ops)


def nbytes(*ts) -> int:
    """Bytes of tensors and Vec3s (None counts nothing)."""
    from ptrt_tpu_torch.core.vec import Vec3

    total = 0
    for t in ts:
        if isinstance(t, Vec3):
            total += nbytes(t.x, t.y, t.z)
        elif t is not None:
            total += t.element_size() * t.numel()
    return total


def log(*a):
    print(*a, flush=True)


class Laps:
    """The wall seconds of each phase of the run, logged as each ends:
    call with the next phase's name, and with None after the last."""

    def __init__(self):
        self.t_start = self.t0 = time.perf_counter()
        self.name = None
        self.s = {}

    def __call__(self, name):
        now = time.perf_counter()
        if self.name is not None:
            self.s[self.name] = now - self.t0
            log(f"[time] phase {self.name}: {self.s[self.name]:.1f} s")
        if name is None:
            log(f"[time] all phases: {now - self.t_start:.1f} s")
        self.name, self.t0 = name, now


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device ms of ``fn()`` over ``iters`` calls after a warm-up, by
    CUDA events (``ptrt_tpu_torch.tools.cuda_ms``)."""
    from ptrt_tpu_torch.tools import cuda_ms as tools_cuda_ms

    return tools_cuda_ms(fn, iters)


def bench_perf(sc, spp, depth):
    sc.perf.enable_denoiser = False
    sc.perf.enable_bloom = False
    sc.perf.enable_motion_vectors = False
    sc.perf.samples_per_pixel = spp
    sc.perf.max_bounce_depth = depth
    sc.perf.resolution_scale = 1.0
    return sc


def balanced(sc):
    """The reference's default settings: the "balanced" preset at 1 spp."""
    sc.set_performance_preset("balanced")
    sc.perf.samples_per_pixel = 1
    return sc


def orbit(sc, k: int) -> None:
    """The bench camera, (0, 1.2, -1.5) looking at (0, 0, 6), orbited by
    ``k`` steps of ORBIT_DEG about the look-at point."""
    a = math.radians(ORBIT_DEG * k)
    sc.set_camera((ORBIT_R * math.sin(a), EYE_Y,
                   LOOKAT[2] - ORBIT_R * math.cos(a)), LOOKAT, fov=60)


def agreement(got, want, rtol=1e-5, atol=1e-6):
    """(max abs error, max error relative to |want| + atol, share of pixels
    within rtol/atol) of two Vec3s or tensors; a Vec3 pixel agrees when all
    three components do."""
    import torch
    from ptrt_tpu_torch.core.vec import Vec3

    stack = lambda v: (torch.stack([v.x, v.y, v.z]) if isinstance(v, Vec3)
                       else v[None])
    g, w = stack(got).double(), stack(want).double()
    err = (g - w).abs()
    ok = (err <= rtol * w.abs() + atol).all(0)
    rel = float((err / (w.abs() + atol)).max())
    return float(err.max()), rel, float(ok.float().mean())


def check_row_gather(dev, mat_table, card, rng):
    """row_gather at the probes' shapes and at the material gather's, each
    bit for bit against index_select.  Returns the material-shape entry."""
    import torch
    from ptrt_tpu_torch.core.gather import row_gather, row_gather_plain
    from ptrt_tpu_torch.tools.probe_gather import run_probes

    probes = run_probes(dev)
    for row in probes:
        log(f"  row_gather {row['probe']}: exact, kernel {row['ms']:.4f} ms "
            f"vs index_select {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms [{card}]")
    table = mat_table.packed
    ids = torch.from_numpy(rng.integers(0, table.shape[0], W * H)).to(dev)
    got = row_gather(table, ids, field_major=True)
    want = row_gather_plain(table, ids, field_major=True)
    assert torch.equal(got, want), "row_gather: material gather not exact"
    ms = cuda_ms(lambda: row_gather(table, ids, field_major=True), 20)
    plain_ms = cuda_ms(lambda: row_gather_plain(table, ids, field_major=True),
                       20)
    library_ms = cuda_ms(lambda: table.t().contiguous().index_select(1, ids),
                         20)
    bnd = bound(nbytes(table, ids, got))
    log(f"  row_gather material ({tuple(table.shape)} table, {W * H} ids, "
        f"field-major): exact, kernel {ms:.4f} ms vs index_select + "
        f"transpose {plain_ms:.4f} ms, table.t().contiguous().index_select "
        f"{library_ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
        f"({bnd['bound_by']}) [{card}]")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, **bnd,
            "probes": probes}


def check_atrous_sizes(inputs, cfg) -> list:
    """svgf_atrous against its plain version, exactly, at sizes that stress
    its tiles: crops of the 1080p a-trous inputs whose width and height are
    no multiple of a tile, smaller than the halo of step 16, a single
    pixel; every instantiated step and two that run the kernel with a
    run-time step (3, 5); object ids on and off.  Returns what was run."""
    import dataclasses

    from ptrt_tpu_torch.core.vec import Vec3
    from ptrt_tpu_torch.render import denoiser as den

    ch, img, var, depth, normal, obj = inputs
    full_h, full_w = depth.shape
    ran = []
    for h, w in ODD_SIZES:
        y0, x0 = (full_h - h) // 2, (full_w - w) // 2
        crop = lambda c: (c.map(crop) if isinstance(c, Vec3)
                          else c[y0:y0 + h, x0:x0 + w].contiguous())
        planes = [crop(c) for c in (img, var, depth, normal, obj)]
        for use_ids in (True, False):
            c2 = dataclasses.replace(cfg, use_object_ids=use_ids)
            for step in (1, 2, 3, 4, 5, 8, 16):
                got = den.atrous_iteration(*planes, step, ch, c2)
                want = den.atrous_iteration_plain(*planes, step, ch, c2)
                for gv, wv in ((got[0].x, want[0].x), (got[0].y, want[0].y),
                               (got[0].z, want[0].z), (got[1], want[1])):
                    assert bool(((gv == wv) | (gv.isnan() & wv.isnan()))
                                .all()), ("svgf_atrous", h, w, step, use_ids)
        ran.append(f"{h}x{w}")
    log(f"  svgf_atrous at {ran}, steps 1, 2, 3, 4, 5, 8, 16, object ids on "
        f"and off: exact")
    return ran


def crop_temporal(t_inputs, h, w, first):
    """The temporal stage's inputs (``stages.temporal_inputs``) cut to their
    central (h, w) pixels, with the first-frame flag ``first``."""
    import dataclasses

    import torch
    from ptrt_tpu_torch.core.vec import Vec3
    from ptrt_tpu_torch.render import denoiser as den

    mvx, mvy, depth, normal, obj, state0, cfg = t_inputs["args"]
    full_h, full_w = depth.shape
    y0, x0 = (full_h - h) // 2, (full_w - w) // 2

    def cut(v):
        if v is None:
            return None
        if isinstance(v, Vec3):
            return v.map(cut)
        if isinstance(v, den.ChannelHistory):
            return den.ChannelHistory(cut(v.mean), cut(v.m2), cut(v.length))
        return v[y0:y0 + h, x0:x0 + w].contiguous()

    state = dataclasses.replace(
        state0, diffuse=cut(state0.diffuse), specular=cut(state0.specular),
        normal=cut(state0.normal), depth=cut(state0.depth),
        object_id=cut(state0.object_id),
        first_frame=torch.tensor(first, device=depth.device))
    return {"args": (cut(mvx), cut(mvy), cut(depth), cut(normal), cut(obj),
                     state, cfg),
            "channels": {k: (cut(src), cut(hist), ch, cut(cap))
                         for k, (src, hist, ch, cap)
                         in t_inputs["channels"].items()}}


def check_temporal(t_inputs) -> dict:
    """svgf_temporal against its plain version, at 1920x1080 and at
    ODD_SIZES, with the first-frame flag off and on: each channel alone with
    and without a history cap and both channels in one launch (bit for bit
    the channels alone), on SVGF_AGREE of the pixels within rtol 1e-5 and
    with equal history lengths.  Returns the largest error and what was
    run."""
    import torch
    from ptrt_tpu_torch.render import denoiser as den

    full_h, full_w = t_inputs["args"][2].shape
    out = {"max_abs_err": 0.0, "least_share": 1.0, "sizes": []}
    for h, w in ((full_h, full_w), *ODD_SIZES):
        for first in (False, True):
            inp = crop_temporal(t_inputs, h, w, first)
            mvx, mvy, depth, normal, obj, state, cfg = inp["args"]
            flag = state.first_frame
            g = (mvx, mvy, depth, normal, obj, state)
            d, sp = inp["channels"]["diffuse"], inp["channels"]["specular"]
            runs = {"diffuse": d, "specular": sp,
                    "specular without its cap": (*sp[:3], None),
                    "diffuse with the specular cap": (*d[:3], sp[3])}
            got = {k: den.temporal_accumulation(c[0], c[1], *g, c[2], cfg,
                                                hist_cap=c[3], first=flag)
                   for k, c in runs.items()}
            pair = den.temporal_accumulation_pair((d, sp), *g, cfg,
                                                  first=flag)
            for k, c in runs.items():
                hist = c[1]
                if first:  # the first frame's history is the current frame
                    hist = den.ChannelHistory(c[0], c[0] * c[0],
                                              torch.ones_like(depth))
                want = den.temporal_accumulation_plain(c[0], hist, *g, c[2],
                                                       cfg, hist_cap=c[3])
                for part in ("mean", "m2"):
                    err, rel, share = agreement(getattr(got[k], part),
                                                getattr(want, part))
                    assert share >= SVGF_AGREE, (h, w, first, k, part, share,
                                                 err, rel)
                    out["max_abs_err"] = max(out["max_abs_err"], err)
                    out["least_share"] = min(out["least_share"], share)
                same_len = float((got[k].length == want.length).float()
                                 .mean())
                assert same_len >= SVGF_AGREE, (h, w, first, k, same_len)
            for k, p in zip(("diffuse", "specular"), pair):
                for a, b in ((p.mean, got[k].mean), (p.m2, got[k].m2),
                             (p.length, got[k].length)):
                    assert exact(k, a, b) == 0, (
                        f"svgf_temporal at {h}x{w}, first={first}: the "
                        f"two-channel launch differs from {k} alone")
        out["sizes"].append(f"{h}x{w}")
    log(f"  svgf_temporal at {out['sizes']}, first frame off and on, each "
        f"channel with and without a history cap: at least "
        f"{out['least_share']:.6f} of pixels within rtol 1e-5 (bound "
        f"{SVGF_AGREE}), max |err| {out['max_abs_err']:.3g}; both channels "
        f"in one launch equal to each alone")
    out["kernels"] = {n: den.temporal_kernel_info(n) for n in (1, 2)}
    for n, v in out["kernels"].items():
        log(f"  svgf_temporal of {n} channel(s): {v['registers']} registers, "
            f"{v['local_bytes']} bytes of local memory a thread, "
            f"{v['shared_bytes']} bytes of shared memory a block, "
            f"{v['blocks_per_sm']} resident blocks of {v['threads']} threads "
            f"a SM")
    return out


def equal_vec(a, b) -> bool:
    import torch

    return all(bool(torch.equal(x, y)) for x, y in zip((a.x, a.y, a.z),
                                                       (b.x, b.y, b.z)))


def k6_agreement(got, want) -> tuple:
    """(largest byte difference, share of pixels with every byte equal)."""
    d = (got.int() - want.int()).abs()
    return int(d.max()), float((d == 0).all(-1).float().mean())


def check_bloom(color, card):
    """The bloom chain (one launch) against its plain version on a frame's
    colour: every blurred mip, mip 0 after the upsample-add chain and the
    composite hdr + up(mip 0) bit for bit, at 1920x1080 and at crops of
    the odd sizes; K6 with the bloom's mip 0 within 1 LSB of its plain
    version (its exact share); both timed queued beside their bounds (K6's
    also beside its SASS issue time); then bloom and K6 captured in a CUDA
    graph and replayed, bit-identical.  Returns (chain stats, K6-with-bloom
    stats)."""
    import torch

    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.build import BUILD_DIR
    from ptrt_tpu_torch.core.vec import Vec3
    from ptrt_tpu_torch.render import bloom, pipeline
    from ptrt_tpu_torch.tools import stages

    h, w = color.x.shape
    sizes = [(h, w)] + [s for s in ODD_SIZES]
    for sh, sw in sizes:
        x = Vec3(*[c[:sh, :sw].contiguous() for c in (color.x, color.y,
                                                       color.z)])
        km, kt, ko = bloom.bloom_chain(x, composite=True)
        pm, pt, po = bloom.bloom_chain_plain(x, composite=True)
        _, kt2, _ = bloom.bloom_chain(x)
        assert len(km) == len(pm), (sh, sw, len(km), len(pm))
        assert all(equal_vec(a, b) for a, b in zip(km, pm)), (sh, sw, "mips")
        assert pt is None or (equal_vec(kt, pt) and equal_vec(kt2, pt)), (
            sh, sw, "mip 0 after the upsample-add")
        assert equal_vec(ko, po), (sh, sw, "composite")
        lsb, share = k6_agreement(pipeline.tonemap_rgb8(x, 1.0, bloom=kt),
                                  pipeline.tonemap_rgb8_plain(x, 1.0, pt))
        assert lsb <= 1, (sh, sw, lsb)
        log(f"  bloom_chain {sh}x{sw}: {len(km)} mips, every mip, mip 0 "
            f"after the chain and the composite equal to the plain chain "
            f"bit for bit; K6 with its bloom within {lsb} LSB, exact on "
            f"{share:.6f} of pixels")
        if (sh, sw) == (h, w):
            k6_err, k6_exact = lsb, share
    info = bloom.chain_info(torch.cuda.current_device())
    launch = bloom.chain_launch(h, w, False, info["blocks_per_sm"],
                                info["sms"])
    log(f"  bloom_chain at {h}x{w}: grid {launch.grid} blocks of "
        f"{info['threads']} ({info['blocks_per_sm']} resident a SM on "
        f"{info['sms']} SMs), {info['registers']} registers, "
        f"{info['local_bytes']} bytes of local memory a thread, "
        f"{info['shared_bytes']} bytes of shared memory a block; phases "
        + ", ".join(f"{n} {b} blocks" for n, _, b in launch.phases))
    # the kernels' times, queued, beside their bounds (K6's also beside the
    # issue time of the SASS a thread of its 4-pixel vector path runs)
    body = stages.tonemap_sass(stages.kernel_resources(
        os.path.join(BUILD_DIR, kernels.LIBRARY),
        ("tonemap_rgb8",))["tonemap_rgb8"])
    t = stages.time_bloom(color, body)
    k6, k6_alone = t["k6"], t["k6_alone"]
    m0 = bloom.bloom_mips(color)
    chain = {**t["bloom"], "max_abs_err": 0.0,
             "ms": sum(t["bloom"]["queued_ms"]) / 2,
             "plain_ms": cuda_ms(lambda: bloom.bloom_chain_plain(color), 3),
             "grid": launch.grid, "registers": info["registers"],
             "blocks_per_sm": info["blocks_per_sm"],
             "host_ms_bloom_and_k6": t["host_ms"],
             "frame_queued_ms": t["frame_queued_ms"]}
    k6.update(ms=sum(k6["queued_ms"]) / 2, max_abs_err=k6_err,
              exact_share=k6_exact,
              plain_ms=cuda_ms(lambda: pipeline.tonemap_rgb8_plain(
                  color, 1.0, m0), 5),
              sass_instructions_a_thread=body[True],
              alone_queued_ms=k6_alone["queued_ms"],
              alone_bound_ms=k6_alone["bound_ms"],
              alone_bound_by=k6_alone["bound_by"],
              alone_sass_issue_ms=k6_alone["sass_issue_ms"],
              alone_sass_instructions_a_thread=body[False])
    for name, r in (("bloom_chain", chain), ("K6 with the bloom", k6),
                    ("K6 alone", k6_alone)):
        kms = ("not measured" if r["kernel_ms"] is None
               else f"{r['kernel_ms']:.4f} ms")
        extra = (f"; the SASS issues in {r['sass_issue_ms']:.4f} ms"
                 if "sass_issue_ms" in r else "")
        log(f"  {name} at {h}x{w}: queued "
            f"{' / '.join(f'{q:.4f}' for q in r['queued_ms'])} ms, the "
            f"kernel alone {kms}, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}{extra}) [{card}]")
    log(f"  bloom + K6 of a frame: queued "
        f"{' / '.join(f'{q:.4f}' for q in t['frame_queued_ms'])} ms, host "
        f"{t['host_ms']:.3f} ms a call; plain chain {chain['plain_ms']:.3f}"
        f" ms, plain K6 with the bloom {k6['plain_ms']:.3f} ms; K6 SASS "
        f"{body[True]} instructions a thread with the bloom, {body[False]} "
        f"without (4 pixels) [{card}]")

    # a CUDA graph holds the chain's cooperative launch and K6: replays are
    # bit-identical to the eager calls
    want = pipeline.tonemap_rgb8(color, 1.0, bloom=bloom.bloom_mips(color))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pipeline.tonemap_rgb8(color, 1.0, bloom=bloom.bloom_mips(color))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = pipeline.tonemap_rgb8(color, 1.0, bloom=bloom.bloom_mips(color))
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want), "the graph's replay differs"
    log("  bloom_chain and K6 captured in a CUDA graph: three replays "
        "bit-identical to the eager calls")
    chain["graph_replay_equal"] = True
    return chain, k6


def check_post_kernels(sc, state0, prev_vp, card):
    """svgf_temporal, svgf_atrous, bloom_chain and K6 with the bloom
    against their plain versions on the buffers of the scene's last frame
    (traced after ``state0`` / ``prev_vp``), each timed beside its own
    bound.  Returns {kernel: stats}."""
    from ptrt_tpu_torch.render import denoiser as den
    from ptrt_tpu_torch.tools import stages

    bufs = sc.last_frame
    rh, rw = sc.render_size
    cfg = den.DEFAULT_SETTINGS
    assert not bool(state0.first_frame)
    t_inputs = stages.temporal_inputs(sc, state0, prev_vp)
    mvx, mvy, *g, _, _ = t_inputs["args"]
    first = state0.first_frame
    out = {}

    temporal = check_temporal(t_inputs)
    rows = {r["channels"]: r for r in stages.time_temporal(t_inputs, first)}
    for k, r in rows.items():
        kms = ("not measured" if r["kernel_ms"] is None
               else f"{r['kernel_ms']:.4f} ms")
        log(f"  svgf_temporal {k} at {rh}x{rw}: queued "
            f"{' / '.join(f'{t:.4f}' for t in r['queued_ms'])} ms, the "
            f"kernel alone {kms}, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}) [{card}]")
    pair = rows["diffuse+specular"]
    plain = {k: cuda_ms(lambda c=c: den.temporal_accumulation_plain(
        c[0], c[1], mvx, mvy, *g, state0, c[2], cfg, hist_cap=c[3]), 5)
        for k, c in t_inputs["channels"].items()}
    # the kernel table's row: a balanced frame's temporal stage, both
    # channels in one launch
    temporal.update(
        ms=sum(pair["queued_ms"]) / 2, queued_ms=pair["queued_ms"],
        kernel_ms=pair["kernel_ms"], plain_ms=sum(plain.values()),
        bound_ms=pair["bound_ms"], bound_by=pair["bound_by"],
        channel_queued_ms={k: rows[k]["queued_ms"]
                           for k in ("diffuse", "specular")},
        channel_kernel_ms={k: rows[k]["kernel_ms"]
                           for k in ("diffuse", "specular")},
        channel_bound_ms={k: rows[k]["bound_ms"]
                          for k in ("diffuse", "specular")},
        channel_plain_ms=plain)
    out["svgf_temporal"] = temporal

    # the seven passes a balanced frame runs (diffuse 1-16, specular 1-2),
    # each fed the pass before it: exact against the plain version, timed,
    # beside its own bound
    inputs = stages.atrous_inputs(t_inputs, first)
    passes = stages.time_atrous(inputs, iters=20, plain_iters=3)
    for r in passes:
        log(f"  svgf_atrous {r['channel']} step {r['step']}: exact "
            f"{r['exact']} (max |err| {r['max_abs_err']:.3g}); kernel "
            f"{r['ms']:.4f} ms vs plain {r['plain_ms']:.2f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]")
        assert r["exact"], (r["channel"], r["step"], r["max_abs_err"])
    first_pass = passes[0]
    atrous = {"max_abs_err": max(r["max_abs_err"] for r in passes),
              "ms": first_pass["ms"], "plain_ms": first_pass["plain_ms"],
              "bound_ms": first_pass["bound_ms"],
              "bound_by": first_pass["bound_by"],
              "pass_ms": {f"{r['channel']} {r['step']}": r["ms"]
                          for r in passes},
              "pass_bound_ms": {f"{r['channel']} {r['step']}": r["bound_ms"]
                                for r in passes},
              "frame_ms": sum(r["ms"] for r in passes),
              "frame_bound_ms": sum(r["bound_ms"] for r in passes),
              "sky_share": first_pass["sky_share"]}
    # a step no frame runs takes the kernel with a run-time step
    ch, *planes = inputs["diffuse"]
    atrous["other_step_ms"] = cuda_ms(
        lambda: den.atrous_iteration(*planes, 3, ch, cfg), 20)
    log(f"  svgf_atrous step 3 (the run-time-step kernel, off the frame's "
        f"path): {atrous['other_step_ms']:.4f} ms [{card}]")
    atrous["odd_sizes"] = check_atrous_sizes(inputs["diffuse"], cfg)
    atrous["step_kernels"] = {
        str(step): den.atrous_kernel_info(rh, rw, step)
        for step in den.ATROUS_STEPS}
    for step, v in atrous["step_kernels"].items():
        log(f"  svgf_atrous step {step}: tile {v['tile']}, "
            f"{v['shared_bytes']} bytes of shared memory a block, "
            f"{v['registers']} registers, {v['local_bytes']} bytes of local "
            f"memory a thread, {v['blocks_per_sm']} resident blocks of 256 "
            f"threads a SM")
    out["svgf_atrous"] = atrous

    out["bloom_chain"], out["tonemap_rgb8"] = check_bloom(bufs.color, card)
    for k, v in out.items():
        log(f"  {k} at {rh}x{rw}: kernel {v['ms']:.4f} ms vs plain "
            f"{v['plain_ms']:.4f} ms, bound {v['bound_ms']:.4f} ms "
            f"({v['bound_by']}) [{card}]")
    return out


def take(rays, idx):
    name, o, d, t = rays
    pick = lambda c: c[idx].contiguous()
    return name, o.map(pick), d.map(pick), pick(t)


def walk(geom, rays):
    """The main path's walk of a ray set: K2 for shadow rays, else K1."""
    from ptrt_tpu_torch.render import traverse

    name, o, d, t = rays
    if name == "shadow":
        return (traverse.any_hit(geom, o, d, t),)
    return tuple(traverse.closest_hit(geom, o, d, t))


def walk_plain(geom, rays):
    from ptrt_tpu_torch.render import traverse

    name, o, d, t = rays
    if name == "shadow":
        return (traverse.any_hit_plain(geom, o, d, t),)
    return tuple(traverse.closest_hit_plain(geom, o, d, t))


def compare_walk(tag, got, want, stats):
    """Hold a walk's answer to another's (the plain version's): K1's hit
    flag and mesh id, and K2's flag, equal on K1_K2_AGREE of the rays, K1's
    t within rtol 1e-4 where both hit."""
    if len(want) == 1:
        mism = int((got[0] != want[0]).sum())
        frac = 1.0 - mism / want[0].numel()
        log(f"  K2 {tag}: {want[0].numel()} rays, occluded "
            f"{float(got[0].float().mean()):.4f}, mismatches {mism} "
            f"(agree {frac:.6f})")
        assert frac >= K1_K2_AGREE, f"K2 {tag}: agreement {frac}"
        stats["mismatches"] += mism
        stats["max_abs_err"] = max(stats["max_abs_err"], float(mism > 0))
        return
    tk, _, _, slot_k, mesh_k = got
    tp, _, _, slot_p, mesh_p = want
    hit_k, hit_p = slot_k >= 0, slot_p >= 0
    agree = (hit_k == hit_p) & (mesh_k == mesh_p)
    both = agree & hit_k
    t_err = (tk - tp).abs()[both]
    t_ok = bool(((tk - tp).abs() <= 1e-4 * tp.abs())[both].all())
    n = tp.numel()
    mism = int((~agree).sum())
    frac = 1.0 - mism / n
    max_err = float(t_err.max()) if t_err.numel() else 0.0
    log(f"  K1 {tag}: {n} rays, hit {float(hit_k.float().mean()):.4f}, "
        f"hit/mesh mismatches {mism} (agree {frac:.6f}), "
        f"max |dt| {max_err:.3g}, t within rtol 1e-4: {t_ok}")
    assert frac >= K1_K2_AGREE, f"K1 {tag}: agreement {frac}"
    assert t_ok, f"K1 {tag}: t differs beyond rtol 1e-4"
    stats["mismatches"] += mism
    stats["max_abs_err"] = max(stats["max_abs_err"], max_err)


def walk_stats(rays, stats):
    return stats["any_hit" if rays[0] == "shadow" else "closest_hit"]


def check_counts(geom, rays, idx):
    """The counting walks over a full wavefront (K1 near-first and in slot
    order, or K2): nodes visited and triangles tested a live ray; on the
    sampled rays ``idx`` the counting kernel is held to its plain version
    (the same walk, one ray at a time on the host): answers on
    K1_K2_AGREE of the rays, tallies within COUNT_RTOL."""
    import torch
    from ptrt_tpu_torch.render import traverse

    name, o, d, t = rays
    live = int((t > 0).sum())
    cpu = torch.device("cpu")
    small = take(rays, idx[:COUNT_SAMPLE])
    small_cpu = (name, small[1].map(lambda c: c.to(cpu)),
                 small[2].map(lambda c: c.to(cpu)), small[3].to(cpu))
    out = {}
    for w in (("any",) if name == "shadow"
              else ("closest", "closest_slot_order")):
        full = traverse.walk_counts(geom, o, d, t, w)
        if w != "closest_slot_order":  # the same walk as the main path's
            want = walk(geom, rays)
            got = (full.answer,) if w == "any" else tuple(full.answer)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (
                f"{w} counting walk differs from the main path's on {name}")
        k = traverse.walk_counts(geom, *small[1:], w)
        p = traverse.walk_counts_plain(geom, *small_cpu[1:], w)
        kk = (k.answer,) if w == "any" else tuple(k.answer)
        pp = (p.answer,) if w == "any" else tuple(p.answer)
        compare_walk(f"counting walk {w}, {name} sample vs its plain walk",
                     tuple(x.cpu() for x in kk), pp,
                     {"mismatches": 0, "max_abs_err": 0.0})
        for what, a, b in (("nodes", k.nodes, p.nodes),
                           ("triangles", k.tris, p.tris)):
            assert abs(a - b) <= COUNT_RTOL * max(b, 1), (w, name, what, a, b)
        out[w] = {"nodes_per_ray": full.nodes / max(live, 1),
                  "tris_per_ray": full.tris / max(live, 1)}
        log(f"  {'K2' if w == 'any' else 'K1'} {w} {name}: "
            f"{out[w]['nodes_per_ray']:.3f} nodes and "
            f"{out[w]['tris_per_ray']:.3f} triangles a live ray ({live} "
            f"live of {t.numel()}); on {COUNT_SAMPLE} sampled rays kernel "
            f"{k.nodes} / {k.tris} vs plain walk {p.nodes} / {p.tris}")
    return out


def check_full_walks(full, rng, card, stats):
    """Phase 3's walks on the full bench scene: the main path's four
    wavefronts (camera, bounce 1, bounce 3 of a sample's PathState, shadow)
    each on a SAMPLE_RAYS sample against the plain version, at full width
    held at the sampled rays to those plain answers, permuted (answers bit
    for bit the unpermuted run's), on two streams at once (bit for bit),
    through the live-lane entry (K1: bit for bit the t_max plane's), timed
    at full width, and counted; adds the
    mismatches and the largest t error into ``stats``.  Returns the kernel
    table's numbers, each time with the bound of its own entry and
    wavefront."""
    import torch
    from ptrt_tpu_torch.render import traverse
    from ptrt_tpu_torch.tools.stages import walk_bound
    from ptrt_tpu_torch.tools.walks import late_bounce, wavefronts

    g = full._geom
    rays = wavefronts(full)
    lname, lo, ld, alive = late_bounce(full, 3)
    rays.insert(2, (lname, lo, ld,
                    torch.where(alive, traverse.T_MAX, -1.0).contiguous()))
    n = rays[0][3].numel()
    idx = torch.from_numpy(rng.choice(n, min(n, SAMPLE_RAYS),
                                      replace=False)).to(g.device)
    res = {"ms": {}, "live_ms": {}, "counts": {}, "live": {}, "bound": {},
           "live_bound": {}}
    for r in rays:
        name, o, d, t = r
        st = walk_stats(r, stats)
        sample = take(r, idx)
        want = walk_plain(g, sample)
        compare_walk(f"full {name} sample", walk(g, sample), want, st)
        got = walk(g, r)
        compare_walk(f"full {name} at full width, at the sampled rays",
                     tuple(x[idx] for x in got), want, st)
        perm = torch.from_numpy(rng.permutation(n)).to(g.device)
        shuffled = walk(g, take(r, perm))
        back = tuple(torch.empty_like(x).index_copy_(0, perm, y)
                     for x, y in zip(got, shuffled))
        assert all(torch.equal(a, b) for a, b in zip(back, got)), (
            f"{name}: a permuted wavefront's answers differ")
        # the same walk on two streams at once: each launch takes its rays
        # from a counter of its own
        both = []
        for s in (torch.cuda.Stream(g.device), torch.cuda.Stream(g.device)):
            s.wait_stream(torch.cuda.current_stream(g.device))
            with torch.cuda.stream(s):
                both.append(walk(g, r))
        torch.cuda.synchronize(g.device)
        assert all(torch.equal(a, b) for ans in both
                   for a, b in zip(ans, got)), (
            f"{name}: walks on two streams at once differ")
        if name != "shadow":
            live = traverse.closest_hit_live(g, o, d, t > 0)
            assert all(torch.equal(a, b) for a, b in zip(live, got)), (
                f"{name}: closest_hit_live differs from closest_hit")
        res["ms"][name] = cuda_ms(lambda r=r: walk(g, r), 20)
        live = res["live"][name] = int((t > 0).sum())
        res["bound"][name] = walk_bound(g, n, live, 4, name == "shadow")
        live_ms = ""
        if name != "shadow":
            res["live_ms"][name] = cuda_ms(
                lambda o=o, d=d, a=t > 0: traverse.closest_hit_live(g, o, d, a),
                20)
            res["live_bound"][name] = walk_bound(g, n, live, 1, False)
            live_ms = (f", {res['live_ms'][name]:.4f} ms through the alive "
                       f"plane (bound "
                       f"{res['live_bound'][name]['bound_ms']:.4f} ms)")
        log(f"  {'K2' if name == 'shadow' else 'K1'} full {name}: {n} rays "
            f"({live} live), bit-identical when permuted, on two streams"
            f"{'' if name == 'shadow' else ' and through the alive plane'}; "
            f"{res['ms'][name]:.4f} ms ({n / res['ms'][name] / 1e3:.1f} "
            f"Mrays/s; bound {res['bound'][name]['bound_ms']:.4f} ms, "
            f"{res['bound'][name]['bound_by']}){live_ms} [{card}]")
        res["counts"][name] = check_counts(g, r, idx)
    # times on the same sample: kernel and plain
    _, o, d, t = take(rays[1], idx)
    res["k1_sample_ms"] = cuda_ms(lambda: traverse.closest_hit(g, o, d, t), 20)
    res["k1_plain_ms"] = cuda_ms(lambda: traverse.closest_hit_plain(g, o, d, t),
                                 1)
    _, o, d, t = take(rays[3], idx)
    res["k2_sample_ms"] = cuda_ms(lambda: traverse.any_hit(g, o, d, t), 20)
    res["k2_plain_ms"] = cuda_ms(lambda: traverse.any_hit_plain(g, o, d, t), 1)
    return res


def walk_info():
    """Registers, local bytes a thread and resident blocks a SM of K1 (on
    the alive plane, as the bounce loop calls it, and on a t_max plane) and
    K2, and of both on a device count (the RT frame's glass pass)."""
    import ctypes
    from ptrt_tpu_torch import kernels

    lib = kernels.get_lib()
    out = {}
    for k, name in enumerate(("closest_hit", "closest_hit t_max plane",
                              "any_hit", "closest_hit device count",
                              "any_hit device count")):
        regs, local, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        kernels.check(lib.ptrt_walk_info(k, ctypes.byref(regs),
                                         ctypes.byref(local),
                                         ctypes.byref(per_sm)), name)
        out[name] = {"registers": regs.value, "local_bytes": local.value,
                     "blocks_per_sm": per_sm.value,
                     "warps_per_scheduler": per_sm.value * 4 // 4}
    return out


# -- K3: shade_nee and shade_scatter against their plain stages ---------------


def lane_err(got, want):
    """Per-lane |error| (a Vec3's largest component) and |want|."""
    import torch
    from ptrt_tpu_torch.core.vec import Vec3

    stack = lambda v: (torch.stack([v.x, v.y, v.z]) if isinstance(v, Vec3)
                       else v[None])
    g, w = stack(got).double(), stack(want).double()
    return (g - w).abs().amax(0), w.abs().amax(0)


def hold(what, got, want, lanes, tiers, stats) -> None:
    """Assert the tiers on ``lanes`` (bool mask); keep the max error."""
    err, mag = lane_err(got, want)
    err, mag = err[lanes], mag[lanes]
    if err.numel() == 0:
        return
    for rtol, share in tiers:
        # counted, not averaged: a mean on the card multiplies by 1/n
        ok = int((err <= rtol * mag + 1e-6).sum())
        assert ok >= share * err.numel(), (what, rtol, ok, err.numel(),
                                           share)
    stats["max_abs_err"] = max(stats["max_abs_err"], float(err.max()))


def agree(what, a, b, stats, where=None) -> "torch.Tensor":
    """Lanes where two bool planes agree (of the lanes ``where``, if given:
    the others count as agreeing); asserts SHADE_AGREE of them."""
    same = a == b
    if where is not None:
        same = same | ~where
    share = float(same.double().mean())
    assert share >= SHADE_AGREE, (what, share)
    stats["flag_mismatches"] += int((~same).sum())
    return same


def compare_nee(tag, ka, pa, kn, pn, bounce, stats) -> None:
    """shade_nee's kernel (state ``ka``, record ``kn``) against its plain
    stage (``pa``, ``pn``) under the record's contract (render/shade.py):
    the alive, hit and NEE flags and the sign of t_max are held on every
    lane, the hit record on the lanes alive after the stage, the shadow
    record where the plain stage casts a shadow ray."""
    import torch

    assert torch.equal(ka.rng, pa.rng), f"{tag}: PCG states differ"
    ok = agree(f"{tag} alive", ka.alive, pa.alive, stats)
    ok &= agree(f"{tag} hit", kn.hit.hit, pn.hit.hit, stats)
    ok &= agree(f"{tag} do_nee", kn.do_nee, pn.do_nee, stats)
    if pn.shadow_t is not None:
        ok &= agree(f"{tag} t_max < 0", kn.shadow_t < 0, pn.shadow_t < 0,
                    stats)
    ok &= agree(f"{tag} front", kn.hit.front_face, pn.hit.front_face, stats,
                where=pa.alive)
    hits = ok & pa.alive
    hold(f"{tag} point", kn.hit.point, pn.hit.point, hits, DIRECTION, stats)
    hold(f"{tag} normal", kn.hit.normal, pn.hit.normal, hits, DIRECTION,
         stats)
    for name in ("throughput", "accum", "diffuse", "specular", "emission"):
        if getattr(pa, name) is not None:
            hold(f"{tag} {name}", getattr(ka, name), getattr(pa, name), ok,
                 VALUE, stats)
    if bounce == 0:
        for name in ("first_depth", "first_object_id", "first_roughness",
                     "first_transmission"):
            assert torch.equal(getattr(ka, name), getattr(pa, name)), name
        hold(f"{tag} first_normal", ka.first_normal, pa.first_normal, ok,
             DIRECTION, stats)
    if pn.env_t is not None:
        compare_env(tag, kn, pn, ok, stats)
    if pn.shadow_t is None:
        return
    nee = ok & pn.do_nee
    err, mag = lane_err(kn.shadow_d, pn.shadow_d)
    diverged = nee & ~(err <= 1e-3 * mag + 1e-6)
    share = 1.0 - float((diverged | ~ok).double().mean())
    assert share >= SHADE_AGREE, (tag, "light samples agree on", share)
    stats["diverged"] += int((diverged | ~ok).sum())
    stats["lanes"] += ok.numel()
    nee &= ~diverged
    hold(f"{tag} L", kn.shadow_d, pn.shadow_d, nee, DIRECTION, stats)
    hold(f"{tag} shadow origin", kn.shadow_o, pn.shadow_o, nee, DIRECTION,
         stats)
    for name in ("shadow_t", "pdf", "contrib", "contrib_s"):
        if getattr(pn, name) is not None:
            hold(f"{tag} {name}", getattr(kn, name), getattr(pn, name), nee,
                 VALUE, stats)


ENV_FIELDS = ("env_o", "env_d", "env_t", "env_pdf", "env_w", "env_c",
              "env_cs")


def compare_env(tag, kn, pn, ok, stats) -> None:
    """The env sample's record of shade_nee's HDRI instantiation against the
    plain stage's under the contract: the t_max plane equal on every lane
    (1e28 or -1), the rest on the lanes that cast a ray, where the sampled
    directions agree (on SHADE_AGREE of the lanes) held to the tiers, and
    the share of those lanes bit-exact kept a field in
    ``stats["env_exact"]`` as [exact lanes, lanes]."""
    bad_t = exact("env_t", kn.env_t, pn.env_t)
    assert bad_t == 0, (tag, "env t_max differs on", bad_t)
    nee = ok & pn.do_nee
    err, mag = lane_err(kn.env_d, pn.env_d)
    diverged = nee & ~(err <= 1e-3 * mag + 1e-6)
    share = 1.0 - float((diverged | ~ok).double().mean())
    assert share >= SHADE_AGREE, (tag, "env samples agree on", share)
    stats["env_diverged"] = stats.get("env_diverged", 0) + int(
        diverged.sum())
    nee &= ~diverged
    hold(f"{tag} env L", kn.env_d, pn.env_d, nee, DIRECTION, stats)
    hold(f"{tag} env shadow origin", kn.env_o, pn.env_o, nee, DIRECTION,
         stats)
    for name in ("env_pdf", "env_w", "env_c", "env_cs"):
        if getattr(pn, name) is not None:
            hold(f"{tag} {name}", getattr(kn, name), getattr(pn, name), nee,
                 VALUE, stats)
    tally = stats.setdefault("env_exact", {})
    lanes = int(nee.sum())
    for name in ENV_FIELDS:
        if getattr(pn, name) is not None:
            got = tally.setdefault(name, [0, 0])
            got[0] += lanes - exact(name, getattr(kn, name),
                                    getattr(pn, name), nee)
            got[1] += lanes


def compare_scatter(tag, ka, pa, stats) -> None:
    """shade_scatter's kernel (state ``ka``) against its plain stage."""
    import torch

    assert torch.equal(ka.rng, pa.rng), f"{tag}: PCG states differ"
    ok = agree(f"{tag} alive", ka.alive, pa.alive, stats)
    for name in ("ray_spec", "prev_was_specular", "path_still_specular"):
        ok &= agree(f"{tag} {name}", getattr(ka, name), getattr(pa, name),
                    stats)
    err, mag = lane_err(ka.d, pa.d)
    diverged = ok & pa.alive & ~(err <= 1e-3 * mag + 1e-6)
    share = 1.0 - float((diverged | ~ok).double().mean())
    assert share >= SHADE_AGREE, (tag, "lobes agree on", share)
    stats["diverged"] += int((diverged | ~ok).sum())
    stats["lanes"] += ok.numel()
    ok &= ~diverged
    for name in ("accum", "diffuse", "specular", "emission"):
        if getattr(pa, name) is not None:
            hold(f"{tag} {name}", getattr(ka, name), getattr(pa, name), ok,
                 VALUE, stats)
    hold(f"{tag} origin", ka.o, pa.o, ok, DIRECTION, stats)
    hold(f"{tag} direction", ka.d, pa.d, ok, DIRECTION, stats)
    # a lane that dies keeps its old throughput in the kernel
    hold(f"{tag} throughput", ka.throughput, pa.throughput, ok & pa.alive,
         AT_PEAK, stats)
    if pa.prev_pdf is not None:  # the env MIS carries, where the lane lives
        agree(f"{tag} prev_did_nee", ka.prev_did_nee, pa.prev_did_nee, stats,
              where=pa.alive)
        hold(f"{tag} prev_pdf", ka.prev_pdf, pa.prev_pdf, ok & pa.alive,
             AT_PEAK, stats)


def exact(what, got, want, lanes=None) -> int:
    """Lanes (of ``lanes``, if given) where two planes or Vec3s differ in
    value (NaN only against NaN)."""
    import torch
    from ptrt_tpu_torch.core.vec import Vec3

    comps = ((got.x, want.x), (got.y, want.y), (got.z, want.z)) if isinstance(
        want, Vec3) else ((got, want),)
    bad = torch.zeros_like(comps[0][1], dtype=torch.bool)
    for a, b in comps:
        fa, fb = a.is_floating_point(), b.is_floating_point()
        same = (a == b) | (a.isnan() & b.isnan()) if fa and fb else a == b
        bad |= ~same
    if lanes is not None:
        bad &= lanes
    return int(bad.sum())


def exact_scatter(tag, state, rec, occluded, mats, bounce, rr_start,
                  stats, env_occluded=None) -> None:
    """shade_scatter's kernel and its plain stage on the same state, NEE
    record and shadow answers: every plane, flag and PCG state equal on
    every lane, the throughput and the env MIS carries on the lanes alive
    after the stage (the record's contract: a lane that dies keeps its old
    throughput in the kernel, and its carries where it died in the
    roulette)."""
    from ptrt_tpu_torch.render import shade

    ka, pa = state.clone(), state.clone()
    shade.shade_scatter(ka, rec, occluded, mats, bounce, True, rr_start,
                        env_shadow=env_occluded)
    shade.shade_scatter_plain(pa, rec, occluded, mats, bounce, True,
                              rr_start, env_shadow=env_occluded)
    bad = {name: exact(name, getattr(ka, name), getattr(pa, name))
           for name in ("rng", "alive", "ray_spec", "prev_was_specular",
                        "path_still_specular", "o", "d", "accum", "diffuse",
                        "specular", "emission")
           if getattr(pa, name) is not None}
    for name in ("throughput", "prev_pdf", "prev_did_nee"):
        if getattr(pa, name) is not None:
            bad[name] = exact(name, getattr(ka, name), getattr(pa, name),
                              pa.alive)
    stats["exact_lanes"] += pa.alive.numel()
    stats["inexact"] += sum(bad.values())
    assert not any(bad.values()), (f"{tag}: shade_scatter differs from its "
                                   f"plain stage on the same inputs", bad)


def shade_bounces(tag, geom, closest, occluded, mats, lights, n_lights, sky,
                  ps, bounces, rr_start, stats, times=None,
                  env_occluded=None):
    """Run ``bounces`` of the shading stages, kernel and plain on the same
    inputs (the plain stage's output feeds the next bounce), comparing each.
    ``closest(ps)`` gives K1's answer, ``occluded(record)`` the shadow
    walk's, ``env_occluded(record)`` the env shadow walk's (a state with env
    NEE).  With ``times`` (a dict), the stages of every bounce are timed
    at this width, each beside the bound of its own wavefront:
    ``times[stage][bounce]``."""
    from ptrt_tpu_torch.render import shade
    from ptrt_tpu_torch.tools import stages

    for bounce in bounces:
        k1 = closest(ps)
        ka, pa = ps.clone(), ps.clone()
        kn = shade.shade_nee(ka, geom, k1, mats, lights, n_lights, sky,
                             bounce)
        pn = shade.shade_nee_plain(pa, geom, k1, mats, lights, n_lights, sky,
                                   bounce)
        compare_nee(f"{tag} bounce {bounce} nee", ka, pa, kn, pn, bounce,
                    stats["shade_nee"])
        # the scatter kernel continues the kernels' own chain: their state
        # and NEE record, and the shadow walk of the kernel's shadow rays
        occl, occl_k = occluded(pn), occluded(kn)
        agree(f"{tag} bounce {bounce} occluded", occl_k, occl,
              stats["shade_nee"])
        env_occl = env_occl_k = None
        if ps.env_nee:
            env_occl, env_occl_k = env_occluded(pn), env_occluded(kn)
            agree(f"{tag} bounce {bounce} env occluded", env_occl_k,
                  env_occl, stats["shade_nee"])
        before = pa.clone()
        exact_scatter(f"{tag} bounce {bounce} scatter", before, pn, occl,
                      mats, bounce, rr_start, stats["shade_scatter"],
                      env_occl)
        shade.shade_scatter(ka, kn, occl_k, mats, bounce, True, rr_start,
                            env_shadow=env_occl_k)
        shade.shade_scatter_plain(pa, pn, occl, mats, bounce, True, rr_start,
                                  env_shadow=env_occl)
        compare_scatter(f"{tag} bounce {bounce} scatter", ka, pa,
                        stats["shade_scatter"])
        if times is not None:
            nee = lambda s: shade.shade_nee(s, geom, k1, mats, lights,
                                            n_lights, sky, bounce)
            nee_p = lambda s: shade.shade_nee_plain(s, geom, k1, mats, lights,
                                                    n_lights, sky, bounce)
            sca = lambda s: shade.shade_scatter(s, kn, occl_k, mats, bounce,
                                                True, rr_start,
                                                env_shadow=env_occl_k)
            sca_p = lambda s: shade.shade_scatter_plain(
                s, pn, occl, mats, bounce, True, rr_start,
                env_shadow=env_occl)

            def fresh(state, k):  # checked once, as trace_path does
                out = [state.clone() for _ in range(k)]
                for s in out:
                    shade.check_state(s, mats)
                return out

            if ps.env_nee:  # K2 on this bounce's env shadow rays
                live = int((kn.env_t > 0).sum())
                times.setdefault("env_any_hit", {})[bounce] = {
                    "ms": cuda_ms(lambda: env_occluded(kn), 10),
                    "live": live,
                    **stages.walk_bound(geom, kn.env_t.numel(), live, 4,
                                        True)}
            for name, fn, fn_p, pre, moved, ops in (
                    ("shade_nee", nee, nee_p, ps,
                     stages.shade_bytes("shade_nee", ps, before, pn, k1=k1,
                                        first=bounce == 0, sky=sky),
                     stages.SHADE_NEE_OPS_LANE * ps.alive.numel()),
                    ("shade_scatter", sca, sca_p, before,
                     stages.shade_bytes("shade_scatter", before, pa, pn,
                                        occluded=occl,
                                        env_occluded=env_occl),
                     OPS_PER_ITEM["shade_scatter"] * int(before.alive.sum()))):
                direct, packed = stages.live_warps(
                    pre.alive, shade.scatter_launch(
                        pre.alive.numel(), mats, 1).chunk)
                times.setdefault(name, {})[bounce] = {
                    "ms": stages.clones_ms(fn, fresh(pre, 11)),
                    "queued_ms": stages.clones_ms(fn, fresh(pre, 11),
                                                  stages.SPIN_CYCLES),
                    "kernel_ms": stages.kernel_ms(fn, fresh(pre, 11),
                                                  f"{name}_kernel"),
                    "plain_ms": stages.clones_ms(
                        fn_p, [pre.clone() for _ in range(3)]),
                    "alive": int(pre.alive.sum()),
                    "warps": -(-pre.alive.numel() // 32),
                    "live_warps": direct, "packed_warps": packed,
                    **bound(moved, ops)}
        ps = pa
    return ps


def random_lanes(dev, n, seed, n_mats, misses=0):
    """``n`` lanes of random hits on per-lane triangles, with ``n_mats``
    random materials of every lobe (sheen, iridescence, clear coat, glass,
    metal, emission) and every light type, for the lobes the bench scene
    lacks; the first ``misses`` lanes miss.  Returns (geometry,
    closest(ps), materials, lights, n_lights, sky, state)."""
    import types

    import numpy as np
    import torch
    from ptrt_tpu_torch.core.vec import Vec3
    from ptrt_tpu_torch.render import shade, traverse
    from ptrt_tpu_torch.render.sky import SkyConfig
    from ptrt_tpu_torch.scene.lights import Light, LightTable, LightType
    from ptrt_tpu_torch.scene.materials import Material, MaterialTable

    r = np.random.default_rng(seed)
    mats = [Material.make(
        tuple(r.uniform(0.05, 1.0, 3)), float(r.uniform(0.0, 1.0)),
        float(r.choice([0.0, r.uniform(0, 1)])),
        transmission=float(r.choice([0.0, 0.0, r.uniform(0.3, 1.0)])),
        ior=float(r.uniform(1.1, 2.4)),
        clearcoat=float(r.choice([0.0, r.uniform(0, 1)])),
        clearcoat_roughness=float(r.uniform(0.0, 0.4)),
        sheen=float(r.choice([0.0, r.uniform(0, 1)])),
        sheen_tint=tuple(r.uniform(0, 1, 3)),
        iridescence=float(r.choice([0.0, r.uniform(0, 1)])),
        iridescence_thickness=float(r.uniform(250, 800)),
        emission=tuple(r.choice([0.0, 2.0]) * r.uniform(0, 1, 3)))
        for _ in range(n_mats)]
    lights = [Light.point((0.0, 4.0, 5.0), (1.0, 0.9, 0.8), 5.0, 20.0, 0.1),
              Light.spot((1.0, 6.0, 6.0), (0.1, -1.0, 0.2), (0.9, 0.9, 1.0),
                         6.0, 20.0, 0.3, 0.6, 0.2),
              Light(LightType.DIRECTIONAL, (0.0, 0.0, 0.0),
                    tuple(np.array([0.3, -1.0, 0.4]) / np.sqrt(1.25)),
                    (1.0, 0.95, 0.9), 2.0),
              Light(LightType.AREA, (-2.0, 5.0, 6.0), (0.0, -1.0, 0.0),
                    (1.0, 1.0, 0.9), 8.0, 100.0, radius=0.55, width=1.5,
                    height=0.8)]
    unit = lambda: (lambda a: a / np.linalg.norm(a, axis=1, keepdims=True))(
        r.normal(size=(n, 3)))
    n_geo, d = unit(), unit()
    flip = (np.sum(n_geo * d, 1) > 0) & (r.random(n) < 0.8)
    d[flip] = -d[flip]
    t = r.uniform(0.5, 5.0, n)
    o = r.uniform(-4, 4, (n, 3)) + [0, 0.5, 6] - d * t[:, None]
    e1 = unit()
    e1 -= n_geo * np.sum(e1 * n_geo, 1, keepdims=True)
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 = np.cross(n_geo, e1)
    v3 = lambda a: Vec3(*[torch.tensor(a[:, k], dtype=torch.float32,
                                       device=dev) for k in range(3)])
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    ps = shade.PathState.start(
        types.SimpleNamespace(origin=v3(o), direction=v3(d),
                              spec=torch.tensor(r.random(n) < 0.2,
                                                device=dev)),
        torch.tensor(r.integers(0, 2 ** 32, n), device=dev), split=True,
        camera_nee=False)
    ps.throughput = v3(r.uniform(0.05, 3.0, (n, 3)))
    ps.alive = torch.tensor(r.random(n) < 0.9, device=dev)
    ps.prev_was_specular = torch.tensor(r.random(n) < 0.5, device=dev)
    ps.path_still_specular = torch.tensor(r.random(n) < 0.3, device=dev)
    slot = torch.tensor(np.where((r.random(n) < 0.1) | (np.arange(n)
                                                         < misses),
                                 -1, np.arange(n)),
                        dtype=torch.int32, device=dev)
    ids = torch.tensor(r.integers(0, len(mats), n), dtype=torch.int32,
                       device=dev)

    def hits(state):
        return traverse.Closest(
            t=torch.where(slot >= 0, f32(t),
                          torch.where(state.alive, 1e30, -1.0)),
            u=torch.zeros(n, device=dev), v=torch.zeros(n, device=dev),
            slot=slot, mesh=torch.where(slot >= 0, ids, -1))

    geom = types.SimpleNamespace(e1=v3(e1), e2=v3(e2), num_tri_slots=n)
    return (geom, hits, MaterialTable.from_materials(mats, dev),
            LightTable.from_lights(lights, dev), len(lights),
            SkyConfig.gradient((0.35, 0.45, 0.65), (0.05, 0.05, 0.08),
                               device=dev), ps)


def check_shade(full, dev, card):
    """Phase 3b: the two K3 kernels against their plain stages on the full
    1080p bench scene (the wavefronts of bounces 0-3 of sample 0, split off
    and on, each stage timed on each beside that wavefront's bound) and on
    random lanes of every lobe and light type: sets whose length is no
    multiple of a block, with the tables in global memory and with tables
    staged that pass 48 KB beside the lists, and a wavefront that is
    wholly dead.  Returns {kernel: stats}."""
    import torch
    from ptrt_tpu_torch.render import pipeline, shade, traverse

    stats = {k: {"max_abs_err": 0.0, "flag_mismatches": 0, "diverged": 0,
                 "lanes": 0} for k in ("shade_nee", "shade_scatter")}
    stats["shade_scatter"].update(exact_lanes=0, inexact=0)
    times = {False: {}, True: {}}
    sc, g = full, full._geom
    closest = lambda ps: traverse.closest_hit_live(g, ps.o, ps.d, ps.alive)
    occluded = lambda rec: traverse.any_hit(g, rec.shadow_o, rec.shadow_d,
                                            rec.shadow_t)
    for split in (False, True):
        st, ray = pipeline.camera_rays(sc.camera, sc._rng_state, 0, 0,
                                       sc._blue_noise)
        ps = shade.PathState.start(ray, st, split)
        shade_bounces(f"bench split={split}", g, closest, occluded,
                      sc._mat_table, sc._light_table, len(sc.lights),
                      sc.sky(), ps, tuple(range(DEPTH)),
                      sc.perf.russian_roulette_start_bounce, stats,
                      times[split])
        del ps
        torch.cuda.empty_cache()
    # random lanes of every lobe; the second set is ragged (no multiple of
    # a block) and its material table is too large for shared memory, so
    # the kernels read both tables from global memory; the third stages
    # tables that fit only beside the scatter's list under the raised cap;
    # then the first set again with every lane dead
    for tag, lanes, n_mats, dead in (
            ("random lanes", SHADE_RANDOM_LANES, 24, False),
            ("random lanes, ragged, tables in global memory",
             SHADE_RANDOM_LANES // 4 + 37, 400, False),
            ("random lanes, ragged, tables staged beside the lists",
             SHADE_RANDOM_LANES // 4 + 37, STAGED_BESIDE_LISTS, False),
            ("random lanes, all dead", SHADE_RANDOM_LANES, 24, True)):
        geom, hits, mats, lights, n_lights, sky, ps = random_lanes(
            dev, lanes, 7, n_mats)
        staged = nbytes(mats.packed, lights.packed) <= SHADE_STAGED_BYTES
        assert staged == (n_mats != 400), (tag, nbytes(mats.packed,
                                                       lights.packed))
        if n_mats == STAGED_BESIDE_LISTS:
            assert nbytes(mats.packed) > 48 * 1024 - SCATTER_LIST_BYTES
        if dead:
            ps.alive = torch.zeros_like(ps.alive)
        mask = lambda rec, n=lanes: torch.arange(n, device=dev) % 3 == 0
        shade_bounces(tag, geom, hits, mask, mats, lights, n_lights, sky, ps,
                      (2, 3) if dead else (0, 2), 1, stats)
    info = shade.kernel_info(sc._mat_table, sc._light_table)
    for bounce, name in ((0, "shade_scatter"),
                         (1, "shade_scatter from bounce 1")):
        launch = shade.scatter_launch(W * H, sc._mat_table, bounce)
        got = info[name]
        assert (got["threads"], got["block_lanes"], got["shared_bytes"]) == (
            launch.threads, launch.chunk, launch.staged_bytes), (got, launch)
    later = info["shade_scatter from bounce 1"]
    log(f"  shade_scatter from bounce 1: {later['registers']} registers, "
        f"{later['local_bytes']} bytes of local memory a thread, "
        f"{later['blocks_per_sm']} resident blocks of {later['threads']} "
        f"threads ({later['block_lanes']} lanes a block) a SM")
    for k, s in stats.items():
        head = times[True][k][1]  # the table's line: split, bounce 1
        s.update(head)
        for key in ("kernel_ms", "call_ms", "queued_ms", "bound_ms", "alive",
                    "live_warps", "packed_warps"):
            s[f"bounce_{key}"] = {}
        for split, name in ((False, "bench"), (True, "split")):
            for b, t in times[split][k].items():
                for key in ("kernel_ms", "queued_ms", "bound_ms", "alive",
                            "live_warps", "packed_warps"):
                    s[f"bounce_{key}"][f"{name} {b}"] = t[key]
                s["bounce_call_ms"][f"{name} {b}"] = t["ms"]
                kms = ("not measured" if t["kernel_ms"] is None
                       else f"{t['kernel_ms']:.4f} ms")
                log(f"  {k} {W}x{H} {name} bounce {b} ({t['alive']} alive; "
                    f"{t['live_warps']} of {t['warps']} warps hold a live "
                    f"lane, {t['live_warps'] / t['warps']:.3f}; packed "
                    f"{t['packed_warps']}): a wrapper call {t['ms']:.4f} ms "
                    f"(CUDA events), queued {t['queued_ms']:.4f} ms, the "
                    f"kernel alone {kms} (profiler) vs plain "
                    f"{t['plain_ms']:.2f} ms, bound {t['bound_ms']:.4f} ms "
                    f"({t['bound_by']}) [{card}]")
        s.update(info[k])
        if k == "shade_scatter":
            s["from_bounce_1"] = later
        log(f"  {k}: PCG states bit-exact; flags differ on "
            f"{s['flag_mismatches']} lanes, lobes diverge on {s['diverged']} "
            f"of {s['lanes']} lane-stages; max |err| on agreeing lanes "
            f"{s['max_abs_err']:.3g}; {s['registers']} registers, "
            f"{s['local_bytes']} bytes of local memory a thread, "
            f"{s['blocks_per_sm']} resident blocks of {s['threads']} "
            f"threads ({s['block_lanes']} lanes a block) a SM")
    sc_stats = stats["shade_scatter"]
    log(f"  shade_scatter on the plain stage's own inputs: equal on every "
        f"lane of {sc_stats['exact_lanes']} lane-stages (planes, flags, PCG "
        f"states; the throughput where the lane lives on)")
    return stats


def edge_directions(n: int, rot: float):
    """``n`` unit directions whose map coordinate u sits just above 0 and
    just below 1 at rotation ``rot`` (where u wraps), over the map's rows."""
    import numpy as np

    phi = -np.pi - rot + np.tile([1e-6, -1e-6, 3e-4, -3e-4],
                                 -(-n // 4))[:n] * 2 * np.pi
    th = np.linspace(0.05, np.pi - 0.05, n)
    return np.stack([np.sin(th) * np.cos(phi), np.cos(th),
                     np.sin(th) * np.sin(phi)], 1)


def env_lanes(dev, n, seed, n_mats, rot):
    """``random_lanes`` with env NEE: a seeded 256x512 HDRI at rotation
    ``rot``, random MIS carries, and the first 256 lanes missing along
    ``edge_directions``."""
    import numpy as np
    import torch
    from ptrt_tpu_torch.app.hdri import synthetic_env
    from ptrt_tpu_torch.core.vec import Vec3
    from ptrt_tpu_torch.render.sky import SkyConfig

    edge = min(256, n)
    geom, hits, mats, lights, n_lights, _, ps = random_lanes(
        dev, n, seed, n_mats, misses=edge)
    r = np.random.default_rng(seed + 1)
    ps.prev_pdf = torch.tensor(r.exponential(1.0, n), dtype=torch.float32,
                               device=dev)
    ps.prev_did_nee = torch.tensor(r.random(n) < 0.6, device=dev)
    d = np.stack([c.cpu().numpy() for c in (ps.d.x, ps.d.y, ps.d.z)], 1)
    d[:edge] = edge_directions(edge, rot)
    ps.d = Vec3(*[torch.tensor(d[:, k], dtype=torch.float32, device=dev)
                  for k in range(3)])
    sky = SkyConfig.hdri(synthetic_env(256, 512, seed=seed), rot, device=dev)
    return geom, hits, mats, lights, n_lights, sky, ps


def check_hdri(hdri, dev, card, rng):
    """Phase 3c: K3's HDRI instantiations (shade_nee<true>,
    shade_scatter<true>) against their plain stages on the 1080p "hdri"
    scene's wavefronts of bounces 0-3, split off and on (each stage and the
    env K2 walk timed at each bounce beside its bound), and on random lanes
    of every lobe under HDRIs at rotations 0.7 and -3.0 with edge
    directions (ragged with the tables in global memory, and with tables
    staged that pass 48 KB beside the lists) and all dead;
    K2 on the env shadow rays against its plain walk on a sample.  Returns
    (stats by kernel, times by split)."""
    import ctypes

    import torch
    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.render import pipeline, shade, traverse
    from ptrt_tpu_torch.tools import stages

    stats = {k: {"max_abs_err": 0.0, "flag_mismatches": 0, "diverged": 0,
                 "lanes": 0} for k in ("shade_nee", "shade_scatter")}
    stats["shade_scatter"].update(exact_lanes=0, inexact=0)
    times = {False: {}, True: {}}
    sc, g = hdri, hdri._geom
    sky = sc.sky()
    assert sky.has_env_sampling
    closest = lambda ps: traverse.closest_hit_live(g, ps.o, ps.d, ps.alive)
    occluded = lambda rec: traverse.any_hit(g, rec.shadow_o, rec.shadow_d,
                                            rec.shadow_t)
    env_occluded = lambda rec: traverse.any_hit(g, rec.env_o, rec.env_d,
                                                rec.env_t)
    for split in (False, True):
        st, ray = pipeline.camera_rays(sc.camera, sc._rng_state, 0, 0,
                                       sc._blue_noise)
        ps = shade.PathState.start(ray, st, split, env_nee=True)
        shade_bounces(f"hdri split={split}", g, closest, occluded,
                      sc._mat_table, sc._light_table, len(sc.lights), sky, ps,
                      tuple(range(DEPTH)),
                      sc.perf.russian_roulette_start_bounce, stats,
                      times[split], env_occluded)
        del ps
        torch.cuda.empty_cache()
    for tag, lanes, n_mats, dead, rot in (
            ("hdri random lanes, rotation 0.7", SHADE_RANDOM_LANES, 24,
             False, 0.7),
            ("hdri random lanes, rotation -3.0, ragged, tables in global "
             "memory", SHADE_RANDOM_LANES // 4 + 37, 400, False, -3.0),
            ("hdri random lanes, rotation 0.7, ragged, tables staged "
             "beside the lists", SHADE_RANDOM_LANES // 4 + 37,
             STAGED_BESIDE_LISTS, False, 0.7),
            ("hdri random lanes, all dead", SHADE_RANDOM_LANES, 24, True,
             0.0)):
        geom, hits, mats, lights, n_lights, env_sky, ps = env_lanes(
            dev, lanes, 9, n_mats, rot)
        if n_mats == STAGED_BESIDE_LISTS:
            # staged, though not within 48 KB beside either kernel's lists
            both = nbytes(mats.packed, lights.packed)
            assert 48 * 1024 - NEE_LIST_BYTES < both <= SHADE_STAGED_BYTES
            assert nbytes(mats.packed) > 48 * 1024 - SCATTER_LIST_BYTES
        if dead:
            ps.alive = torch.zeros_like(ps.alive)
        mask = lambda rec, n=lanes, k=3: torch.arange(n, device=dev) % k == 0
        env_mask = lambda rec, n=lanes: torch.arange(n, device=dev) % 4 == 1
        shade_bounces(tag, geom, hits, mask, mats, lights, n_lights, env_sky,
                      ps, (2, 3) if dead else (0, 2), 1, stats,
                      env_occluded=env_mask)
    # K2 on bounce 0's env shadow rays: a sample against the plain walk, the
    # full wavefront held at the sampled rays
    st, ray = pipeline.camera_rays(sc.camera, sc._rng_state, 0, 0,
                                   sc._blue_noise)
    ps = shade.PathState.start(ray, st, False, env_nee=True)
    rec = shade.shade_nee(ps, g, closest(ps), sc._mat_table, sc._light_table,
                          len(sc.lights), sky, 0)
    rays = ("shadow", rec.env_o, rec.env_d, rec.env_t)
    n = rec.env_t.numel()
    idx = torch.from_numpy(rng.choice(n, min(n, SAMPLE_RAYS),
                                      replace=False)).to(dev)
    walk_st = {"mismatches": 0, "max_abs_err": 0.0}
    sample = take(rays, idx)
    want = walk_plain(g, sample)
    compare_walk("hdri env shadow rays, bounce 0, sample", walk(g, sample),
                 want, walk_st)
    compare_walk("hdri env shadow rays, bounce 0, full width at the sampled "
                 "rays", tuple(x[idx] for x in walk(g, rays)), want, walk_st)
    walk_st["sample_ms"] = cuda_ms(lambda: walk(g, sample), 20)
    walk_st["plain_ms"] = cuda_ms(lambda: walk_plain(g, sample), 1)
    stats["env_any_hit"] = walk_st
    info = shade.kernel_info(sc._mat_table, sc._light_table)
    info_h = shade.kernel_info(sc._mat_table, sc._light_table, hdri=True)
    for name, got in {**info, **info_h}.items():
        log(f"  {name}: {got['registers']} registers, {got['local_bytes']} "
            f"bytes of local memory a thread, {got['blocks_per_sm']} "
            f"resident blocks of {got['threads']} threads "
            f"({got['block_lanes']} lanes a block) a SM")
    # one predicate picks both kernels' instantiation: shade_nee refuses an
    # HDRI map without env NEE and env NEE without a map (rc 1, invalid
    # value) before it launches anything
    for env_map, env_nee in ((sc._mat_table.packed.data_ptr(), 0), (None, 1)):
        a = shade.ShadeArgs(n=0, env_map=env_map, env_nee=env_nee)
        rc = kernels.get_lib().ptrt_shade_nee(ctypes.addressof(a),
                                              kernels.stream_ptr(dev))
        assert rc == 1, (env_map, env_nee, rc)
    # the instantiations without env NEE keep the registers and blocks they
    # had before the HDRI instantiation existed
    for name, regs, blocks in (("shade_nee", 64, 4), ("shade_scatter", 64, 4),
                               ("shade_scatter from bounce 1", 80, 3)):
        got = info[name]
        assert (got["registers"], got["blocks_per_sm"]) == (regs, blocks), (
            name, got)
    # the HDRI kernels launch as render/shade.py plans them, and run with
    # the registers, resident blocks and spills they were designed for
    # (ptxas's report of this tree's csrc/shade.cu)
    spills = stages.spill_bytes(stages.source_ptxas(
        os.path.join(HERE, "ptrt_tpu_torch", "csrc"), "shade.cu"))
    mats, n_l = sc._mat_table, len(sc.lights)
    for name, launch in (
            ("shade_nee (hdri)", shade.nee_launch(W * H, mats,
                                                  sc._light_table, n_l, 0,
                                                  True)),
            ("shade_nee (hdri) from bounce 1", shade.nee_launch(
                W * H, mats, sc._light_table, n_l, 1, True)),
            ("shade_scatter (hdri)", shade.scatter_launch(W * H, mats, 0)),
            ("shade_scatter (hdri) from bounce 1",
             shade.scatter_launch(W * H, mats, 1))):
        got = info_h[name]
        assert (got["threads"], got["block_lanes"], got["shared_bytes"]) == (
            launch.threads, launch.chunk, launch.staged_bytes), (name, got,
                                                                 launch)
        regs, blocks, spilled = HDRI_DESIGN[name]
        got["spill_bytes"] = next(v for fn, v in spills.items()
                                  if HDRI_KERNELS[name] in fn)
        assert (got["registers"], got["blocks_per_sm"],
                got["spill_bytes"]) == (regs, blocks, spilled), (
                    name, got, HDRI_DESIGN[name])
    for k in ("shade_nee", "shade_scatter"):
        s = stats[k]
        s.update(info_h[f"{k} (hdri)"])
        s["from_bounce_1"] = info_h[f"{k} (hdri) from bounce 1"]
        exact_share = {f: round(a / max(b, 1), 6)
                       for f, (a, b) in s.get("env_exact", {}).items()}
        s["env_exact_share"] = exact_share
        log(f"  {k} (hdri): PCG states bit-exact; flags differ on "
            f"{s['flag_mismatches']} lanes, lobes diverge on {s['diverged']} "
            f"of {s['lanes']} lane-stages, env samples on "
            f"{s.get('env_diverged', 0)}; max |err| on agreeing lanes "
            f"{s['max_abs_err']:.3g}; bit-exact share of the env record's "
            f"NEE lanes: {exact_share}")
    log(f"  shade_scatter (hdri) on the plain stage's own inputs: equal on "
        f"every lane of {stats['shade_scatter']['exact_lanes']} lane-stages "
        f"(planes, flags, PCG states; the throughput and the MIS carries "
        f"where the lane lives on)")
    for split in (False, True):
        for b in range(DEPTH):
            line = []
            for k in ("shade_nee", "shade_scatter"):
                t = times[split][k][b]
                kms = ("not measured" if t["kernel_ms"] is None
                       else f"{t['kernel_ms']:.4f}")
                first = HDRI_FIRST[k][split][b]
                line.append(f"{k} (hdri) queued {t['queued_ms']:.4f} ms, "
                            f"kernel {kms} (first design {first}) vs plain "
                            f"{t['plain_ms']:.2f} ms, bound "
                            f"{t['bound_ms']:.4f} ms ({t['alive']} alive)")
            w = times[split]["env_any_hit"][b]
            line.append(f"K2 env shadow rays {w['ms']:.4f} ms ({w['live']} "
                        f"live), bound {w['bound_ms']:.4f} ms")
            log(f"  hdri {W}x{H} split={split} bounce {b}: "
                + "; ".join(line) + f" [{card}]")
        sums = {k: [sum((times[split][k][b]["kernel_ms"]
                         or times[split][k][b]["queued_ms"])
                        for b in range(DEPTH)),
                    sum(times[split][k][b]["bound_ms"] for b in range(DEPTH))]
                for k in ("shade_nee", "shade_scatter")}
        for k, (ms, bound_ms) in sums.items():
            stats[k][f"bounces_ms_split_{split}"] = ms
        log(f"  hdri split={split}, bounces 0-{DEPTH - 1}: " + "; ".join(
            f"{k} (hdri) {ms:.4f} ms (first design "
            f"{sum(HDRI_FIRST[k][split]):.4f}), "
            f"bound {bound_ms:.4f} ms" for k, (ms, bound_ms) in sums.items())
            + f" [{card}]")
    return stats, times


# -- 10. dynamic geometry: K4 and K5 ---------------------------------------------


def clone_geom(g):
    """A copy of a geometry's tables that K5 refits (the rest shared)."""
    import dataclasses
    import torch

    return dataclasses.replace(
        g, node_rows=g.node_rows.clone(), tri_rows=g.tri_rows.clone(),
        v0=g.v0.map(torch.clone), e1=g.e1.map(torch.clone),
        e2=g.e2.map(torch.clone))


def same_tables(a, b) -> bool:
    """K5's tables equal by value (a +0 and a -0 bound are one bound)."""
    import torch

    vec = lambda u, v: all(torch.equal(getattr(u, c), getattr(v, c))
                           for c in "xyz")
    return (torch.equal(a.node_rows, b.node_rows)
            and torch.equal(a.tri_rows, b.tri_rows) and vec(a.v0, b.v0)
            and vec(a.e1, b.e1) and vec(a.e2, b.e2))


def check_refit(label, geom, plan, tris, morton, card):
    """K5 on one mesh: ``refit`` (its plan's map, or with ``morton`` the
    Morton refill) against its plain version on copies of the tables, bit
    for bit on every table.  With ``morton``: the refill's order
    (``lbvh.morton_order``: one ``morton_sort`` launch up to the kernel's
    most, 16,384 triangles, else ``morton_codes`` and torch.sort) bit
    for bit the plain version's (``morton_codes_plain``, then a stable
    torch.sort), and both routes at every size they take: ``morton_codes``
    and its sort always, ``morton_sort`` (order and codes) up to its limit;
    each kernel timed queued beside its bound and its plain version, the
    library's sort (``torch.sort(codes, stable=True)``) beside them (the
    refill's launches and device time: ``tools/stages.py --refill``)."""
    import numpy as np
    import torch
    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.geometry import lbvh, refit
    from ptrt_tpu_torch.tools import stages

    dev = geom.device
    v = torch.from_numpy(np.ascontiguousarray(np.stack(tris))).to(dev)
    v0, v1, v2 = v[0], v[1], v[2]
    n = int(v0.shape[0])
    out = {}
    slot_map = None
    queued = lambda fn: [stages.clones_ms(lambda _: fn(), [None] * 21,
                                          stages.SPIN_CYCLES)
                         for _ in range(2)]
    if morton:
        want_codes = lbvh.morton_codes_plain(v0, v1, v2)
        want = torch.sort(want_codes, stable=True).indices.to(torch.int32)
        order = lbvh.morton_order(v0, v1, v2)
        assert torch.equal(order, want), f"morton {label}: order differs"
        codes = lbvh.morton_codes(v0, v1, v2)
        assert torch.equal(codes, want_codes), f"morton {label}: codes"
        assert torch.equal(torch.sort(codes, stable=True).indices.to(
            torch.int32), want), f"morton {label}: the sorted codes"
        distinct = int(want_codes.unique().numel())
        sort_ms = queued(lambda: torch.sort(codes, stable=True))
        out["morton_codes"] = {
            "tris": n, "distinct": distinct,
            "queued_ms": queued(lambda: lbvh.morton_codes(v0, v1, v2)),
            "plain_ms": cuda_ms(lambda: lbvh.morton_codes_plain(v0, v1, v2),
                                5),
            "torch_sort_ms": sort_ms, **stages.morton_bound(n)}
        if n <= kernels.get_lib().ptrt_morton_sort_max():
            o2, c2 = lbvh.morton_sort(v0, v1, v2, with_codes=True)
            assert torch.equal(o2, want) and torch.equal(c2, want_codes), (
                f"morton_sort {label}: order or codes differ")
            out["morton_sort"] = {
                "tris": n, "distinct": distinct,
                "queued_ms": queued(lambda: lbvh.morton_sort(v0, v1, v2)),
                "plain_ms": cuda_ms(
                    lambda: lbvh.morton_order_plain(v0, v1, v2), 5),
                "torch_sort_ms": sort_ms,
                **stages.morton_bound(n, codes=False, order=True)}
        slot_map = (plan.device_arrays(dev)["rank"], order)
    gb = clone_geom(geom)
    want_root = (torch.empty(3, device=dev), torch.empty(3, device=dev))
    refit.refit_apply_plain(gb, plan, v0, v1, v2, slot_map=slot_map,
                            root=want_root)
    aabb = refit.refit_root_aabb(gb, plan)
    assert all(torch.equal(a, b) for a, b in zip(want_root, aabb)), label
    counter = plan.device_arrays(dev)["counter"]
    # bit for bit after the first refit and after the queued repeats
    ga = clone_geom(geom)
    root = (torch.full((3,), float("nan"), device=dev),
            torch.full((3,), float("nan"), device=dev))
    refit.refit_apply(ga, plan, v0, v1, v2, slot_map=slot_map, root=root)
    torch.cuda.synchronize()
    assert same_tables(ga, gb), f"refit {label}: tables differ"
    assert not torch.equal(ga.node_rows, geom.node_rows), (
        f"refit {label}: nothing moved")
    assert all(torch.equal(a, b) for a, b in zip(root, want_root)), (
        f"refit {label}: root box")
    assert not bool(counter.any()), f"refit {label}: counters left"
    q = queued(lambda: refit.refit_apply(ga, plan, v0, v1, v2,
                                         slot_map=slot_map))
    torch.cuda.synchronize()
    assert same_tables(ga, gb), f"refit {label}: tables differ after repeats"
    assert not bool(counter.any()), f"refit {label}: counters left"
    r = out["refit"] = {
        "tris": n, "slots": plan.num_slots,
        "nodes": plan.num_nodes, "levels": len(plan.levels),
        "queued_ms": q,
        "plain_ms": cuda_ms(lambda: refit.refit_apply_plain(
            gb, plan, v0, v1, v2, slot_map=slot_map), 3),
        **refit.refit_info(), **stages.refit_bound(plan, n, morton)}
    log(f"  refit {label}: bit for bit after its repeats, the root box the "
        f"plain one, the counters back at zero; {r['registers']} registers, "
        f"{r['local_bytes']} bytes local, {r['shared_bytes']} bytes of "
        f"shared memory, {r['blocks_per_sm']} blocks of {r['threads']} a SM "
        f"[{card}]")
    if morton:
        log(f"  the Morton refill {label} ({n} triangles, "
            f"{out['morton_codes']['distinct']} distinct codes): order bit "
            f"for bit the plain stable sort's; torch.sort of its codes "
            f"{sort_ms[0]:.4f} / {sort_ms[1]:.4f} ms queued [{card}]")
    for k, r in out.items():
        log(f"  {k} {label} ({r['tris']} triangles): bit for bit its plain "
            f"version; queued {r['queued_ms'][0]:.4f} / "
            f"{r['queued_ms'][1]:.4f} ms vs plain {r['plain_ms']:.3f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]")
    return out


def check_refit_streams(geom, jobs, card) -> None:
    """K5 on two streams at once: each (label, plan, vertices, slot map)
    of ``jobs`` refitted on a stream of its own into one copy of the
    tables, five times over, the streams' launches interleaved; the tables
    bit for bit those of the plain versions run one after another (each
    plan's scratch and counters are its own)."""
    import torch
    from ptrt_tpu_torch.geometry import refit

    ga, gb = clone_geom(geom), clone_geom(geom)
    for _, plan, (v0, v1, v2), slot_map in jobs:
        refit.refit_apply_plain(gb, plan, v0, v1, v2, slot_map=slot_map)
    streams = [torch.cuda.Stream() for _ in jobs]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    for _ in range(5):
        for s, (_, plan, (v0, v1, v2), slot_map) in zip(streams, jobs):
            with torch.cuda.stream(s):
                refit.refit_apply(ga, plan, v0, v1, v2, slot_map=slot_map)
    torch.cuda.synchronize()
    assert same_tables(ga, gb), "refit on two streams: tables differ"
    log(f"  refit of {' and '.join(j[0] for j in jobs)} on "
        f"{len(streams)} streams at once, five rounds: every table bit for "
        f"bit the plain versions' [{card}]")


def check_instances(dyn, rng, card):
    """K4 on the 1080p dynamic frame's wavefronts (camera, bounce 1,
    shadow): on a SAMPLE_RAYS sample against the plain version (hit, mesh
    and instance equal on every ray, t within K4_T_ATOL), at full width
    held bit for bit at the sampled rays, on two streams at once (bit for
    bit), against the same transforms baked into one static world and
    walked by K1 / K2 (hit and mesh ids equal on K4_BAKED_AGREE of the
    rays), timed queued on copies of K1's record beside its bound."""
    import numpy as np
    import torch
    from ptrt_tpu_torch.geometry.scene_geom import assemble_geometry
    from ptrt_tpu_torch.render import traverse
    from ptrt_tpu_torch.tools import stages
    from ptrt_tpu_torch.tools.walks import wavefronts

    g = dyn._geom
    iset, dev = g.iset, g.device
    rays = wavefronts(dyn)
    trans = [m.transmission for m in dyn.mesh_materials]
    t0 = time.time()
    baked = assemble_geometry(dyn.meshes, trans, dev)
    bake_s = time.time() - t0
    n = rays[0][3].numel()
    idx = torch.from_numpy(rng.choice(n, min(n, SAMPLE_RAYS),
                                      replace=False)).to(dev)
    copy = lambda r: traverse.Closest(*[p.clone() for p in r])
    res = {"instances_closest": {"mismatches": 0, "max_abs_err": 0.0},
           "instances_any": {"mismatches": 0, "max_abs_err": 0.0}}
    for name, o, d, t in rays:
        pick = lambda v: v.map(lambda c: c[idx].contiguous())
        so, sd, st = pick(o), pick(d), t[idx].contiguous()
        if name == "shadow":
            k = "instances_any"
            h0 = traverse.any_hit(g.static, so, sd, st)
            got = traverse.instances_any(iset, so, sd, st, h0.clone())
            t1 = time.time()
            want = traverse.instances_any_plain(iset, so, sd, st, h0.clone())
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.time() - t1)
            mism = int((got != want).sum())
            full0 = traverse.any_hit(g.static, o, d, t)
            full = traverse.instances_any(iset, o, d, t, full0.clone())
            assert torch.equal(full[idx], got), f"K4 {name}: full width"
            both = []
            for s in (torch.cuda.Stream(dev), torch.cuda.Stream(dev)):
                s.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(s):
                    both.append(traverse.instances_any(iset, o, d, t,
                                                       full0.clone()))
            torch.cuda.synchronize()
            assert all(torch.equal(b, full) for b in both), (
                f"K4 {name}: two streams differ")
            agree = float((traverse.any_hit(baked, o, d, t) == full)
                          .float().mean())
            live_t = torch.where(~full0 & (t > 0), t, -1.0)
            live = int((live_t > 0).sum())
            states = [full0.clone() for _ in range(11)]
            ms = [stages.clones_ms(
                lambda h: traverse.instances_any(iset, o, d, t, h),
                [x.clone() for x in states], stages.SPIN_CYCLES)
                  for _ in range(2)]
            added = int((full & ~full0).sum())
            extra = f"{added} lanes occluded by an instance only"
            t_err = 0.0
        else:
            k = "instances_closest"
            rec = traverse.closest_hit(g.static, so, sd, st)
            got = traverse.instances_closest(iset, so, sd, copy(rec))
            t1 = time.time()
            want = traverse.instances_closest_plain(iset, so, sd, copy(rec))
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.time() - t1)
            hit_k, hit_p = got.slot >= 0, want.slot >= 0
            mism = int(((hit_k != hit_p) | (got.mesh != want.mesh)
                        | (got.inst != want.inst)).sum())
            bh = hit_k & hit_p
            t_err = float((got.t - want.t).abs()[bh].max()) if bh.any() \
                else 0.0
            assert bool(((got.t - want.t).abs() <= 1e-4 * want.t.abs())[bh]
                        .all()), f"K4 {name}: t beyond rtol 1e-4"
            full0 = traverse.closest_hit(g.static, o, d, t)
            full = traverse.instances_closest(iset, o, d, copy(full0))
            at = lambda r: [p[idx] for p in r] + [r.inst[idx]]
            assert all(torch.equal(a, b) for a, b in zip(
                at(full), [*got, got.inst])), f"K4 {name}: full width"
            both = []
            for s in (torch.cuda.Stream(dev), torch.cuda.Stream(dev)):
                s.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(s):
                    both.append(traverse.instances_closest(iset, o, d,
                                                           copy(full0)))
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for r in both
                       for a, b in zip([*r, r.inst], [*full, full.inst])), (
                f"K4 {name}: two streams differ")
            bk = traverse.closest_hit(baked, o, d, t)
            agree = float((((bk.slot >= 0) == (full.slot >= 0))
                           & (bk.mesh == full.mesh)).float().mean())
            live_t = full0.t
            live = int((live_t > 0).sum())
            states = [copy(full0) for _ in range(11)]
            ms = [stages.clones_ms(
                lambda r: traverse.instances_closest(iset, o, d, r),
                [copy(x) for x in states], stages.SPIN_CYCLES)
                  for _ in range(2)]
            share = float((full.inst >= 0)[t > 0].float().mean())
            extra = (f"instance hits on {share:.4f} of the live rays, max "
                     f"|dt| {t_err:.3g}")
        tests = box_tests(iset, o, d, live_t)
        b = stages.instances_bound(iset, n, live, name == "shadow")
        log(f"  K4 {k} {name}: boxes a live ray tests "
            + ", ".join(f"{w} {v:.2f}" for w, v in tests.items()))
        log(f"  K4 {k} {name}: {SAMPLE_RAYS} sampled rays vs plain "
            f"({plain_ms:.1f} ms): {mism} hit/mesh/inst mismatches; {extra};"
            f" full width equal at the sample, two streams bit for bit; "
            f"against the baked world (K1/K2, {baked.num_tri_slots} slots, "
            f"built in {bake_s:.1f} s) agree on {agree:.6f}; at {n} rays "
            f"({live} live) queued {ms[0]:.4f} / {ms[1]:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}) [{card}]")
        assert mism == 0, f"K4 {name}: {mism} mismatches"
        assert t_err <= K4_T_ATOL, f"K4 {name}: |dt| {t_err}"
        assert agree >= K4_BAKED_AGREE, f"K4 {name}: baked agree {agree}"
        r = res[k]
        r["max_abs_err"] = max(r["max_abs_err"], t_err)
        r.setdefault("wavefront_queued_ms", {})[name] = ms
        r.setdefault("wavefront_bound_ms", {})[name] = b["bound_ms"]
        r.setdefault("wavefront_live", {})[name] = live
        r.setdefault("baked_agree", {})[name] = agree
        r.setdefault("box_tests_per_live_ray", {})[name] = tests
        r.setdefault("plain_sample_ms", {})[name] = plain_ms
        r["bound_by"] = b["bound_by"]
    return res


def box_tests(iset, o, d, t) -> dict:
    """Instance boxes a live ray (``t > 0``) tests, as a mean: the tree's
    descent (the plain descent, which tests the boxes the kernel tests) and
    the flat test (every box)."""
    from ptrt_tpu_torch.geometry import tlas
    from ptrt_tpu_torch.render import traverse

    _, n = tlas.tlas_candidates(iset.tlas, iset.count, o,
                                traverse.safe_inv(d), t, candidates=False)
    return {"tree": float(n[t > 0.0].float().mean()),
            "flat": float(iset.count)}


def check_instance_sets(dev, card) -> dict:
    """K4 against its plain version on hand-made sets
    (``stages.instance_world``): the tie world (two identical instances in
    front of the rays: where they are hit, the instance is 0 in the
    kernel's record as in the plain version's), then sets of K4_SET_SIZES
    instances; K4_SET_RAYS seeded rays each, closest (hit, mesh and
    instance equal on every ray, t within K4_T_ATOL) and any-hit (equal).
    At each size also the tree's host build, the boxes a live ray tests,
    and K4 on ``stages.SET_RAYS`` rays timed queued beside the bound
    (``stages.time_instance_set``), with the kernel the set takes (staged
    or read from global memory)."""
    import numpy as np
    import torch
    from ptrt_tpu_torch.geometry.tlas import build_tlas
    from ptrt_tpu_torch.render import traverse
    from ptrt_tpu_torch.tools import stages

    out = {}
    copy = lambda x: traverse.Closest(*[p.clone() for p in x])
    for label, n, tie in (("tie", 2, True), *[(f"{k} instances", k, False)
                                              for k in K4_SET_SIZES]):
        g = stages.instance_world(n, 40 + n, dev, tie)
        iset = g.iset
        rng = np.random.default_rng(50 + n)
        r = K4_SET_RAYS
        o, d, to_aim = stages.set_rays(iset, rng, r)
        t = torch.full((r,), traverse.T_MAX, device=dev)
        rec = traverse.closest_hit(g.static, o, d, t)
        got = traverse.instances_closest(iset, o, d, copy(rec))
        want = traverse.instances_closest_plain(iset, o, d, copy(rec))
        hit_k, hit_p = got.slot >= 0, want.slot >= 0
        mism = int(((hit_k != hit_p) | (got.mesh != want.mesh)
                    | (got.inst != want.inst)).sum())
        bh = hit_k & hit_p
        t_err = float((got.t - want.t).abs()[bh].max()) if bh.any() else 0.0
        # shadow rays ending before or beyond the point aimed at
        reach = np.linalg.norm(to_aim, axis=1) * rng.uniform(0.5, 1.5, r)
        t_s = torch.tensor(reach, dtype=torch.float32, device=dev)
        h0 = traverse.any_hit(g.static, o, d, t_s)
        h_k = traverse.instances_any(iset, o, d, t_s, h0.clone())
        h_p = traverse.instances_any_plain(iset, o, d, t_s, h0.clone())
        mism_any = int((h_k != h_p).sum())
        share = float((got.inst >= 0).float().mean())
        tests = box_tests(iset, o, d, rec.t)
        bmin, bmax = iset.bb_min.cpu().numpy(), iset.bb_max.cpu().numpy()
        t0 = time.perf_counter()
        for _ in range(20):
            build_tlas(bmin, bmax)
        host_ms = 1e3 * (time.perf_counter() - t0) / 20
        log(f"  K4 {label} ({iset.count} instances, a tree of "
            f"{iset.tlas.shape[0]} nodes {iset.tlas.shape[1]} wide, built on "
            f"the host in {host_ms:.4f} ms): "
            f"{r} rays, closest {mism} hit/mesh/inst mismatches, max |dt| "
            f"{t_err:.3g}, instance hits on {share:.4f}; any-hit {mism_any} "
            f"mismatches ({int((h_k & ~h0).sum())} lanes occluded by an "
            f"instance only); boxes a live ray tests "
            + ", ".join(f"{w} {v:.2f}" for w, v in tests.items())
            + f" [{card}]")
        assert mism == 0 and mism_any == 0, (label, mism, mism_any)
        assert t_err <= K4_T_ATOL, (label, t_err)
        assert share > 0.05, (label, share)
        if tie:  # both instances are candidates; the lower id wins
            assert bool((got.inst != 1).all()) and share > 0.5
        out[label] = {"mismatches": mism + mism_any, "max_abs_err": t_err,
                      "instance_hit_share": share, "box_tests": tests,
                      "tlas_host_ms": host_ms}
        if tie:
            continue
        timed = stages.time_instance_set(g, rng, stages.SET_RAYS)
        del timed["records"]
        staged = timed["info"]["instances_closest"]["staged"]
        log(f"  K4 {label}, {'staged' if staged else 'from global memory'}: "
            f"{stages.SET_RAYS} rays, closest queued "
            f"{timed['closest_ms'][0]:.4f} / {timed['closest_ms'][1]:.4f} ms "
            f"(bound {timed['bound_ms']['closest']:.4f}), any "
            f"{timed['any_ms'][0]:.4f} / {timed['any_ms'][1]:.4f} ms (bound "
            f"{timed['bound_ms']['any']:.4f}); "
            + ", ".join(f"{k} {v['registers']} registers, "
                        f"{v['blocks_per_sm']} blocks a SM"
                        for k, v in timed["info"].items())
            + f" [{card}]")
        out[label].update(timed)
        del g, iset
        torch.cuda.empty_cache()
    return out


def check_many_instances(dev, card) -> dict:
    """A Scene past K4's former cap of 512 instances, at 256x144 (1 spp,
    depth 2, no post): a floor, MANY_CUBES dynamic cubes and a dynamic
    128-segment sphere refilled on the card (device_lbvh; 32,768 triangles,
    past morton_sort's most, so its order comes from morton_codes and
    torch.sort), MANY_CUBES + 1 instances.  The frame after an edit (every
    cube moved, the sphere refilled) on the GPU against the same frame on
    the CPU (the plain versions): object ids agree on 99.9% of pixels and
    the image within 1 LSB on 99% (phase 9's tolerance: K1's FMA
    contraction moves grazing hits); the GPU frame's launches."""
    import numpy as np
    import torch
    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.scene.materials import Material
    from ptrt_tpu_torch.scene.pt_scene import Scene

    rng = np.random.default_rng(61)
    place = rng.uniform([-6.0, -0.6, 5.0], [6.0, 2.5, 16.0], (MANY_CUBES, 3))
    turn = rng.uniform(0.0, 3.0, (MANY_CUBES, 3))
    size = rng.uniform(0.15, 0.45, MANY_CUBES)
    colours = rng.uniform(0.2, 0.9, (MANY_CUBES, 3))

    def edit(sc, cubes, blob, base, frame):
        for k, m in enumerate(cubes):
            m.transform.set_position(*(place[k] + 0.1 * frame)).set_rotation(
                *(turn[k] + 0.2 * frame)).set_scale(size[k])
        v, faces = base
        bump = 1.0 + 0.1 * np.sin(7.0 * v[:, 0] + frame) * np.cos(5.0 * v[:, 1])
        blob.set_triangles((v * bump[:, None]).astype(np.float32)[faces])
        sc.commit_object_changes()

    out = {}
    for name, d in (("cpu", torch.device("cpu")), ("gpu", dev)):
        sc = bench_perf(Scene(256, 144, device=d), 1, 2)
        sc.add_plane_xz(-1.0, 30.0)
        cubes = []
        for k in range(MANY_CUBES):
            m = sc.add_cube(Material.make(tuple(colours[k]), 0.6))
            m.is_dynamic = True
            cubes.append(m)
        blob = sc.add_sphere(128, Material.make((0.9, 0.6, 0.3), 0.3))
        blob.is_dynamic = True
        blob.device_lbvh = True
        blob.transform.set_position(4.5, 2.0, 9.0).set_scale(0.8)
        sc.add_point_light((0.0, 6.0, 4.0), (1.0, 1.0, 1.0), 40.0)
        sc.set_camera((0.0, 1.5, -2.0), (0.0, 0.5, 10.0), fov=60)
        base = (blob.vertices.copy(), blob.faces.copy())
        edit(sc, cubes, blob, base, 0)
        sc.render_frame()
        edit(sc, cubes, blob, base, 1)
        kernels.clear_counts()
        t0 = time.time()
        img = sc.render_frame()
        if d.type == "cuda":
            torch.cuda.synchronize()
        out[name] = (sc, img, time.time() - t0, dict(kernels.counts()))
    (sc_c, img_c, s_c, _), (sc_g, img_g, s_g, launches) = out["cpu"], out["gpu"]
    n_inst = sc_g._geom.iset.count
    oid = float((sc_c.last_frame.object_id
                 == sc_g.last_frame.object_id.cpu()).float().mean())
    lsb = float((np.abs(img_c.astype(int) - img_g.astype(int)).max(-1) <= 1)
                .mean())
    on_inst = float((sc_c.last_frame.object_id >= 1).float().mean())
    log(f"[many] 256x144, {n_inst} instances ({MANY_CUBES} cubes and a "
        f"{sc_g.meshes[-1].num_triangles}-triangle Morton-refilled sphere): "
        f"the edited frame GPU ({1e3 * s_g:.1f} ms) vs CPU ({s_c:.1f} s): "
        f"object id agree {oid:.5f} ({on_inst:.3f} of the pixels on an "
        f"instance), image within 1 LSB on {lsb:.4f} of pixels; GPU "
        f"launches {launches} [{card}]")
    assert n_inst == MANY_CUBES + 1 > 512, n_inst
    assert oid >= 0.999 and lsb >= 0.99, (oid, lsb)
    assert on_inst > 0.1, on_inst
    for k in ("instances_closest", "instances_any", "morton_codes", "refit"):
        assert launches.get(k, 0) > 0, (k, launches)
    assert launches.get("morton_sort", 0) == 0, launches
    return {"instances": n_inst, "object_id_agree": oid, "within_1_lsb": lsb,
            "launches": launches}


# -- 11. the one-bounce RT backend: K10 on the "rt" scene -----------------------


def rt_vec_tiers(what, got, want, lanes, stats, tiers=None) -> None:
    """A K10 output held to its plain version on ``lanes``: RT_VALUE's tiers
    (or ``tiers``), the largest error kept in ``stats``."""
    hold(what, got, want, lanes, tiers or RT_VALUE, stats)


def rt_bits(what, got, want, lanes=None) -> int:
    """Lanes (of ``lanes``) where two planes differ; asserts none do."""
    bad = exact(what, got, want, lanes)
    assert bad == 0, (what, bad)
    return bad


def launch_ms(rs, name: str, call, calls: int = 20) -> float:
    """Mean device ms of K10 kernel ``name``'s launches in ``call(None)``:
    CUDA events recorded around each launch, the card spinning before
    each, so that they time the kernel alone and not the wrapper's host
    work (``rt_glass_rays``' read of G among it).  The profiler would say
    the same, but inside this script it misses launches."""
    import torch
    from ptrt_tpu_torch.tools import stages

    launch, events = rs._launch, []

    def timed(k, a, dev):
        if k != name:
            return launch(k, a, dev)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(stages.SPIN_CYCLES // 20)
        ev[0].record()
        launch(k, a, dev)
        ev[1].record()
        events.append(ev)

    rs._launch = timed
    try:
        call(None)
        events.clear()
        for _ in range(calls):
            call(None)
        torch.cuda.synchronize()
    finally:
        rs._launch = launch
    assert len(events) == calls, (name, len(events))
    return sum(s.elapsed_time(e) for s, e in events) / calls


def rt_stage_bounds(sc, fr, n: int) -> dict:
    """Each K10 kernel's bound on this frame's data: bytes it must move
    (each input plane read once, each output written once, only the lanes
    that need them; the triangle edges of the hit slots, the material and
    light tables once) and its float operations (RT_OPS, a floor counted
    from the source), for the primary pass and the glass rays' pass."""
    import torch
    from ptrt_tpu_torch.render import rt_shading as rs
    from ptrt_tpu_torch.tools import stages

    lights = len(sc.lights)
    tables = nbytes(sc._mat_table.packed, sc._light_table.packed)

    def light_rays(k1):
        m = k1.t.shape[0]
        hit = k1.slot >= 0
        h = int(hit.sum())
        slots = int(torch.unique(k1.slot[hit]).numel())
        by = (m * (4 + 4) + h * (24 + 4) + slots * 24 + tables  # in
              + m * (1 + 1 + 24) + lights * (m * 4 + h * 24))  # out
        return bound(by, h * (RT_OPS["hit"] + lights * RT_OPS["light_ray"]))

    def shade(hit, occ):
        m = hit.hit.shape[0]
        h = int(hit.hit.sum())
        by = m * (1 + 12) + h * (4 + 24) + lights * h + tables + m * 12
        lit = int(occ.view(lights, m)[:, hit.hit].logical_not().sum())
        return bound(by, h * RT_OPS["shade"] + lit * RT_OPS["shade_light"])

    glass_lanes = fr.glass.lanes.shape[0] if fr.glass is not None else 0
    h = int(fr.hit.hit.sum())
    out = {"rt_light_rays": light_rays(fr.k1),
           "rt_shade": shade(fr.hit, fr.occluded)}
    if fr.glass is not None:
        # the hit flag and index plane of every lane, the mesh id of a hit
        # lane; a glass lane's ray direction, normal, point, front flag and
        # t in, its two rays (28 bytes each), seed (8) and lane (4) out
        out["rt_glass_rays"] = bound(
            n * (1 + 4) + h * 4 + tables
            + glass_lanes * ((12 + 12 + 12 + 1 + 4) + (2 * 28 + 8 + 4)),
            glass_lanes * RT_OPS["glass_rays"])
    if fr.sec_k1 is not None:
        out["rt_light_rays (glass rays)"] = light_rays(fr.sec_k1)
        out["rt_shade (glass rays)"] = shade(fr.sec_hit, fr.sec_occluded)
    # the encode pass over every pixel, the glass pass over the glass lanes
    out.update(stages.resolve_bounds(n, glass_lanes,
                                     nbytes(sc._mat_table.packed),
                                     nbytes(rs.encode_lut(fr.color.x.device))))
    return out


def check_rt_stages(sc, fr, stats) -> dict:
    """Each K10 kernel of the frame ``fr`` against its plain version on the
    frame's own K1 / K2 records (the same inputs to both): hit flags, front
    flags, shadow t_max on missed lanes, glass rays' t_max and seeds exact;
    points, normals, shadow rays, glass rays and colours within RT_VALUE's
    tiers (directions RT_DIRECTION's) on the lanes the contract specifies;
    the occlusion bits of K2 on the plain stage's shadow rays equal to the
    frame's on every ray where the two rays are bit-identical; RGB8 within
    1 LSB.  Returns the shares it measured."""
    import dataclasses

    import torch
    from ptrt_tpu_torch.core.vec import Vec3
    from ptrt_tpu_torch.render import rt_shading as rs
    from ptrt_tpu_torch.render import traverse

    geom, mats, lts = sc._geom, sc._mat_table, sc._light_table
    nl = len(sc.lights)
    params = sc.params()
    o, d = sc.camera_rays()
    out = {}

    def light_pass(tag, o, d, k1, hit, shadow, occ):
        ph, pshadow = rs.rt_light_rays_plain(geom, o, d, k1, lts, nl)
        s = stats["rt_light_rays"]
        rt_bits(f"{tag} hit", hit.hit, ph.hit)
        live = ph.hit
        rt_bits(f"{tag} front", hit.front_face, ph.front_face, live)
        rt_vec_tiers(f"{tag} point", hit.point, ph.point, live, s)
        rt_vec_tiers(f"{tag} normal", hit.normal, ph.normal, live, s,
                     RT_DIRECTION)
        rlive = pshadow.t > 0
        rt_bits(f"{tag} shadow live", shadow.t > 0, rlive)
        rt_vec_tiers(f"{tag} shadow t", shadow.t, pshadow.t, rlive, s)
        rt_vec_tiers(f"{tag} shadow o", shadow.o, pshadow.o, rlive, s)
        rt_vec_tiers(f"{tag} shadow d", shadow.d, pshadow.d, rlive, s,
                     RT_DIRECTION)
        # K2 on the plain stage's shadow rays: the same bits where the rays
        # are the same
        occ_p = traverse.any_hit(geom, pshadow.o, pshadow.d, pshadow.t)
        same_ray = torch.ones_like(rlive)
        for a, b in ((shadow.o, pshadow.o), (shadow.d, pshadow.d)):
            for ca, cb in ((a.x, b.x), (a.y, b.y), (a.z, b.z)):
                same_ray &= ca == cb
        same_ray &= shadow.t == pshadow.t
        same_ray |= ~rlive
        rt_bits(f"{tag} occlusion", occ, occ_p, same_ray)
        out[f"{tag} shadow rays bit-identical"] = float(
            same_ray.double().mean())
        out[f"{tag} occlusion agree"] = float((occ == occ_p).double().mean())
        out[f"{tag} occluded share of live shadow rays"] = float(
            occ[rlive].double().mean())

    def shade_pass(tag, hit, d, occ, color):
        pc = rs.rt_shade_plain(hit, d, occ, mats, lts, nl, params)
        rt_vec_tiers(f"{tag} colour", color, pc, torch.ones_like(hit.hit),
                     stats["rt_shade"], RT_COLOR)
        rt_bits(f"{tag} colour", color, pc)
        return pc

    light_pass("primary", o, d, fr.k1, fr.hit, fr.shadow, fr.occluded)
    shade_pass("primary", fr.hit, d, fr.occluded, fr.color)
    if fr.glass is not None:
        # the compacted records: the lanes, their places and seeds exact,
        # the rays within the RT tiers
        pg = rs.rt_glass_rays_plain(fr.hit, d, mats)
        s = stats["rt_glass_rays"]
        g = pg.lanes.shape[0]
        assert fr.glass.lanes.shape == (g,), (fr.glass.lanes.shape, g)
        rt_bits("glass lanes", fr.glass.lanes, pg.lanes)
        rt_bits("glass index", fr.glass.index, pg.index)
        rt_bits("glass seed", fr.glass.seed, pg.seed)
        rt_bits("glass t", fr.glass.t, pg.t)
        live2 = torch.ones_like(pg.t, dtype=torch.bool)
        rt_vec_tiers("glass o", fr.glass.o, pg.o, live2, s)
        rt_vec_tiers("glass d", fr.glass.d, pg.d, live2, s, RT_DIRECTION)
        out["glass lanes"] = g
        out["glass share of hit lanes"] = float(g / fr.hit.hit.sum())
        # past the tiles whose flags a thread keeps in a register: the
        # frame's hit record three times over (6.2M lanes)
        three = lambda v: (v.map(lambda c: torch.cat([c] * 3))
                           if isinstance(v, Vec3) else torch.cat([v] * 3))
        big = dataclasses.replace(fr.hit, **{
            f.name: three(getattr(fr.hit, f.name))
            for f in dataclasses.fields(fr.hit)})
        kg, pg = rs.rt_glass_rays(big, three(d), mats), rs.rt_glass_rays_plain(
            big, three(d), mats)
        assert kg.lanes.shape == pg.lanes.shape == (3 * g,), kg.lanes.shape
        for what in ("lanes", "index", "seed", "t"):
            rt_bits(f"glass {what} (3 frames)", getattr(kg, what),
                    getattr(pg, what))
        every = torch.ones_like(pg.t, dtype=torch.bool)
        rt_vec_tiers("glass o (3 frames)", kg.o, pg.o, every, s)
        rt_vec_tiers("glass d (3 frames)", kg.d, pg.d, every, s,
                     RT_DIRECTION)
        out["glass lanes (3 frames)"] = int(kg.lanes.shape[0])
        del big, kg, pg
    if fr.sec_k1 is not None:
        light_pass("glass rays", fr.glass.o, fr.glass.d, fr.sec_k1,
                   fr.sec_hit, fr.sec_shadow, fr.sec_occluded)
        shade_pass("glass rays", fr.sec_hit, fr.glass.d, fr.sec_occluded,
                   fr.sec_color)
    rgb_p = rs.rt_resolve_plain(fr.color, fr.hit, d, mats, fr.glass,
                                fr.sec_color, fr.sec_k1, sc.height, sc.width)
    diff = (fr.rgb8.int() - rgb_p.int()).abs()
    out["rt_resolve max LSB"] = int(diff.max())
    out["rt_resolve exact share"] = float((diff == 0).all(-1).double()
                                          .mean())
    # the encode pass and the glass pass write one image: equal on every
    # pixel, the glass lanes' pixels among them
    on_glass = torch.zeros(sc.height * sc.width, dtype=torch.bool,
                           device=diff.device)
    if fr.glass is not None:
        on_glass[fr.glass.lanes.long()] = True
    on_glass = on_glass.view(sc.height, sc.width).flip(0)
    stats["rt_resolve"]["max_abs_err"] = int(diff[~on_glass].max())
    stats["rt_resolve_glass"]["max_abs_err"] = (
        int(diff[on_glass].max()) if bool(on_glass.any()) else 0)
    assert int(diff.max()) == 0, int(diff.max())
    return out


def check_resolve_encode(dev, card) -> dict:
    """rt_resolve's encode table against the plain encode on every float32
    colour bit pattern: 2^32 / RES_SWEEP_HW^2 launches of the kernel (no
    glass lanes), each frame's colour planes the same run of bit patterns,
    against ``rt_resolve_plain`` on the same planes; and the table's plain
    reader against the plain encode on every Reinhard value r's bits."""
    import torch
    from ptrt_tpu_torch.core.vec import Vec3
    from ptrt_tpu_torch.render import rt_shading as rs

    t0 = time.time()
    step, hw = RES_SWEEP_HW * RES_SWEEP_HW, RES_SWEEP_HW
    lut = rs.encode_lut(dev)
    bad = bad_r = 0
    for lo in range(-(1 << 31), 1 << 31, step):
        bits = torch.arange(lo, lo + step, dtype=torch.int64, device=dev)
        c = bits.to(torch.int32).view(torch.float32)
        col = Vec3(c, c, c)
        nog = (None,) * 6 + (hw, hw)
        got = rs.rt_resolve(col, *nog)
        want = rs.rt_resolve_plain(col, *nog)
        bad += int((got != want).any(-1).sum())
        del got, want
        bad_r += int((rs.encode_lut_plain(c, lut) != rs.encode_plain(c))
                     .sum())
        del bits, c, col
    torch.cuda.synchronize()
    out = {"colours": 1 << 32, "colours_off": bad, "r_values_off": bad_r,
           "launches": (1 << 32) // step, "s": time.time() - t0}
    log(f"[rt] rt_resolve's encode table on all 2^32 float32 colour bit "
        f"patterns ({out['launches']} launches of {hw}x{hw}): {bad} "
        f"differ from the plain encode; its plain reader on every r bit "
        f"pattern: {bad_r} differ; {out['s']:.1f} s [{card}]")
    assert bad == 0 and bad_r == 0, out
    torch.cuda.empty_cache()
    return out


def rt_plain_frame(sc, fr):
    """The frame the plain stages build from ``fr``'s walk records (K1's
    answers and K2's occlusion bits of the kernel frame): (RGB8, the lanes
    that hit glass)."""
    from ptrt_tpu_torch.render import rt_shading as rs

    geom, mats, lts = sc._geom, sc._mat_table, sc._light_table
    nl = len(sc.lights)
    params = sc.params()
    o, d = sc.camera_rays()
    hit, _ = rs.rt_light_rays_plain(geom, o, d, fr.k1, lts, nl)
    color = rs.rt_shade_plain(hit, d, fr.occluded, mats, lts, nl, params)
    sec_color = None
    glass = rs.rt_glass_rays_plain(hit, d, mats) if fr.glass is not None \
        else None
    if fr.sec_k1 is not None:
        sec_hit, _ = rs.rt_light_rays_plain(geom, glass.o, glass.d,
                                            fr.sec_k1, lts, nl)
        sec_color = rs.rt_shade_plain(sec_hit, glass.d, fr.sec_occluded,
                                      mats, lts, nl, params)
    rgb = rs.rt_resolve_plain(color, hit, d, mats, glass, sec_color,
                              fr.sec_k1, sc.height, sc.width)
    on_glass = (glass.index >= 0) if glass is not None else hit.hit & False
    return rgb, on_glass.view(sc.height, sc.width).flip(0)


def check_rt(dev, card, resources=None) -> dict:
    """Phase 11: the one-bounce RT backend on the "rt" scene
    (build_rt_bench_scene at W x H, TRIS): the frame's launches, host and
    device time; each K10 kernel against its plain version on the frame's
    own records, timed queued beside its bound and its plain version; the
    whole frame against the frame the plain stages build from the same walk
    records (RGB8 within 1 LSB on RT_FRAME_AGREE of the pixels, the rest
    counted by cause); a 256x144 RTScene of the same scene on the GPU and on
    the CPU.  Also the frame's RGB8 SHA-256 (so that two trees' images
    compare bit for bit) and its profiled device time split by pass and
    kernel.  Returns the kernel table's entries and the frame's numbers."""
    import hashlib

    import numpy as np
    import torch
    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.app.bench_scene import build_rt_bench_scene
    from ptrt_tpu_torch.build import BUILD_DIR
    from ptrt_tpu_torch.render import rt_shading as rs
    from ptrt_tpu_torch.tools import stages

    t0 = time.time()
    sc = build_rt_bench_scene(W, H, TRIS, device=dev)
    sc._ensure()
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    n_tris = sum(m.num_triangles for m in sc.meshes)
    log(f"[rt] {W}x{H} RTScene of the bench scene: {n_tris} triangles, "
        f"{len(sc.mesh_materials)} materials, {len(sc.lights)} lights, "
        f"glass {sc._has_glass()}; set-up {setup_s:.2f} s [{card}]")
    assert n_tris == RT_TRIS and len(sc.mesh_materials) == 17, n_tris
    sc.render_frame()  # warm-up
    torch.cuda.synchronize()
    kernels.clear_counts()
    frame_s = []
    for _ in range(RT_FRAMES):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        img = sc.render_frame_device()
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t1)
    launches = {k: v / RT_FRAMES for k, v in kernels.counts().items()}
    host_ms = stages.host_ms(sc.render_frame_device, calls=RT_FRAMES)
    # behind a spin: launches right after the profiler starts may go
    # unrecorded
    prof = stages.frame_profile(sc, render=sc.render_frame_device,
                                lead_cycles=stages.SPIN_CYCLES)
    frame_ms = 1e3 * sum(frame_s) / len(frame_s)
    split = (stages.rt_frame_split(prof["kernels"]) if prof["kernels"]
             else None)
    rgb_sha = hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest()
    log(f"[rt] the 1080p rt frame's RGB8 sha256 {rgb_sha} (the earlier "
        f"designs': {RT_RGB8_SHA256}) [{card}]")
    assert rgb_sha == RT_RGB8_SHA256, rgb_sha
    log(f"[rt] the profiled frame by pass and kernel (device ms): {split} "
        f"[{card}]")
    log(f"[rt] frame {frame_ms:.3f} ms (frames "
        f"{[round(1e3 * s, 3) for s in frame_s]}), host {host_ms:.3f} ms "
        f"a call without waiting; one profiled frame: device "
        f"{prof['device_ms']} ms in {prof['launches']} launches, walks "
        f"{prof['walk_ms']} ms, top {prof['top']}; wrapper launches a frame "
        f"{launches} [{card}]")
    # the scene has glass lanes in view, so the glass pass runs
    n_glass = sc.last_frame.glass.lanes.shape[0]
    assert n_glass > 0, "no glass lane in the rt frame"
    per_frame = {"closest_hit": 2, "any_hit": 2, "rt_light_rays": 2,
                 "rt_shade": 2, "rt_glass_rays": 1, "rt_resolve": 1,
                 "rt_resolve_glass": 1}
    for k, v in per_frame.items():
        assert launches.get(k, 0) == v, (k, launches)
    assert split is not None, "the profiler saw no rt_glass_rays"
    assert prof["names"] is not None, "the profiler saw no kernels"
    seen = {k: sum(f"{k}_kernel" in nm for nm in prof["names"])
            for k in per_frame}
    log(f"[rt] the profiled frame's kernels of the path: {seen} (the "
        f"wrappers launched {per_frame}) [{card}]")
    assert img.shape == (H, W, 3) and float(img.float().std()) > 1.0

    # each kernel against its plain version on the frame's own records
    fr = sc.last_frame
    stats = {k: {"max_abs_err": 0.0} for k in rs.KERNELS}
    shares = check_rt_stages(sc, fr, stats)
    log(f"[rt] K10 vs plain on the frame's records: {shares}; largest "
        f"errors {stats} [{card}]")
    rgb_p, on_glass = rt_plain_frame(sc, fr)
    diff = (fr.rgb8.int() - rgb_p.int()).abs().amax(-1)
    within = float((diff <= 1).double().mean())
    off = diff > 1
    causes = {"glass lanes": int((off & on_glass).sum()),
              "other": int((off & ~on_glass).sum())}
    log(f"[rt] the frame vs the plain stages' frame on the same walk "
        f"records: within 1 LSB on {within:.6f} of pixels, exact on "
        f"{float((diff == 0).double().mean()):.6f}, max {int(diff.max())} "
        f"LSB; pixels off by more, by cause {causes} [{card}]")
    assert within >= RT_FRAME_AGREE, (within, causes)

    # times: each kernel queued behind a spin (two readings), its plain
    # version, its bound
    o, d = sc.camera_rays()
    n = d.x.shape[0]
    geom, mats, lts, nl = sc._geom, sc._mat_table, sc._light_table, len(
        sc.lights)
    params = sc.params()
    calls = {
        "rt_light_rays": (lambda _: rs.rt_light_rays(geom, o, d, fr.k1, lts,
                                                     nl),
                          lambda: rs.rt_light_rays_plain(geom, o, d, fr.k1,
                                                         lts, nl)),
        "rt_shade": (lambda _: rs.rt_shade(fr.hit, d, fr.occluded, mats, lts,
                                           nl, params),
                     lambda: rs.rt_shade_plain(fr.hit, d, fr.occluded, mats,
                                               lts, nl, params)),
        # (the wrapper reads G to the host: queued, its calls wait on it)
        "rt_glass_rays": (lambda _: rs.rt_glass_rays(fr.hit, d, mats),
                          lambda: rs.rt_glass_rays_plain(fr.hit, d, mats)),
        "rt_resolve": (lambda _: rs.rt_resolve(
            fr.color, fr.hit, d, mats, fr.glass, fr.sec_color, fr.sec_k1, H,
            W),
            lambda: rs.rt_resolve_plain(fr.color, fr.hit, d, mats, fr.glass,
                                        fr.sec_color, fr.sec_k1, H, W)),
    }
    bounds = rt_stage_bounds(sc, fr, n)
    info = rs.kernel_info(mats, lts, nl)
    entries = {}
    for k, (kern, plain) in calls.items():
        queued = [stages.clones_ms(kern, [None] * 21, stages.SPIN_CYCLES)
                  for _ in range(2)]
        alone = launch_ms(rs, k, kern)
        plain_ms = cuda_ms(plain, 2)
        # rt_glass_rays' time is the kernel's alone: its queued calls wait
        # on the host's read of G
        entries[k] = {"ms": alone if k == "rt_glass_rays" else sum(queued) / 2,
                      "ms_by": ("kernel alone (events around its launch)"
                                if k == "rt_glass_rays" else "queued"),
                      "queued_ms": queued, "kernel_ms": alone,
                      "plain_ms": plain_ms, **bounds[k],
                      "launches": launches.get(k, 0),
                      "launches_per": "frame",
                      "max_abs_err": stats[k]["max_abs_err"], **info[k]}
        log(f"  {k}: queued {queued[0]:.4f} / {queued[1]:.4f} ms, kernel "
            f"alone {alone:.4f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bounds[k]['bound_ms']:.4f} ms "
            f"({bounds[k]['bound_by']}); {info[k]['registers']} registers, "
            f"{info[k]['local_bytes']} bytes local, "
            f"{info[k]['blocks_per_sm']} blocks of {info[k]['threads']} a SM, "
            f"{info[k]['shared_bytes']} bytes dynamic shared; "
            f"{launches.get(k, 0)} launches a frame [{card}]")
    # rt_resolve's call launches two kernels: the encode pass over every
    # pixel, then the glass pass over the glass lanes.  Each is timed beside
    # its own bound: the encode pass queued in calls without glass lanes
    # (it alone launches; two readings), the glass pass by the profiler in
    # the profiled frame (its program reads G on the card); the frame's
    # call (both) queued, beside both bounds
    e = entries["rt_resolve"]
    nog = (fr.color,) + (None,) * 6 + (H, W)
    encode = [stages.clones_ms(lambda _: rs.rt_resolve(*nog), [None] * 21,
                               stages.SPIN_CYCLES) for _ in range(2)]
    e.update({"ms": sum(encode) / 2, "encode_queued_ms": encode,
              "ms_by": "the encode pass alone, queued (calls without "
                       "glass lanes)",
              "plain_ms": cuda_ms(lambda: rs.rt_resolve_plain(*nog), 2),
              "call_queued_ms": e["queued_ms"],
              "call_bound_ms": e["bound_ms"]
              + bounds["rt_resolve_glass"]["bound_ms"],
              "call_plain_ms": e["plain_ms"]})
    k = "rt_resolve_glass"
    glass_plain_ms = cuda_ms(lambda: rs.glass_color_plain(
        fr.color, fr.hit, d, mats, fr.glass, fr.sec_color, fr.sec_k1), 2)
    in_frame = [us / 1e3 for name, us in prof["kernels"]
                if "rt_resolve_glass_kernel" in name]
    assert len(in_frame) == 1, (
        f"the profiled rt frame's rt_resolve_glass kernels: {in_frame}")
    # beside it, under their own keys: what the glass pass adds to the
    # frame's queued call (its queued time less the encode pass's; the
    # measure of PR 19's row) and the profiler's reading of the kernel
    # alone on the host's G (None where it missed the launch)
    added = sum(e["call_queued_ms"]) / 2 - e["ms"]
    alone = stages.kernel_ms(calls["rt_resolve"][0], [None] * 21,
                             "rt_resolve_glass_kernel")
    grid = {"host count": rs.resolve_glass_grid(n_glass),
            "device count": rs.resolve_glass_grid(n)}
    entries[k] = {"ms": in_frame[0],
                  "ms_by": "the profiler, in the profiled frame",
                  "alone_profiler_ms": alone, "added_to_call_ms": added,
                  "grid": grid,
                  "plain_ms": glass_plain_ms,
                  **bounds[k],
                  "launches": launches.get(k, 0), "launches_per": "frame",
                  "max_abs_err": stats[k]["max_abs_err"], **info[k],
                  "glass_lanes": n_glass}
    assert grid["device count"] <= (torch.cuda.get_device_properties(
        dev).multi_processor_count * info[k]["blocks_per_sm"]), grid
    log(f"[rt] rt_resolve_glass by the profiler: {in_frame[0]:.4f} ms in "
        f"the profiled frame (G on the card), "
        f"{'not measured' if alone is None else f'{alone:.4f} ms'} alone on "
        f"the host's G; its grid {grid['host count']} blocks of 256 on the "
        f"host's G, {grid['device count']} on a device count (the "
        f"{n}-lane room) [{card}]")
    # the encode pass's SASS a thread (4 pixels) over the card's issue
    # rate, beside its bound (never as it); phase 2's listing where given
    res = resources or stages.kernel_resources(
        os.path.join(BUILD_DIR, kernels.LIBRARY), ("rt_resolve",))
    body = stages.resolve_sass(res["rt_resolve"])
    e.update({"sass_instructions_a_thread": body,
              "sass_issue_ms": stages.resolve_issue_ms(H, W, body)})
    log(f"[rt] rt_resolve: the encode pass alone {encode[0]:.4f} / "
        f"{encode[1]:.4f} ms queued, bound "
        f"{e['bound_ms']:.4f} ms ({e['bound_by']}), SASS issue time "
        f"{e['sass_issue_ms']:.4f} ms ({body} instructions a thread of 4 "
        f"pixels), plain {e['plain_ms']:.3f} ms, {e['registers']} "
        f"registers, {e['blocks_per_sm']} blocks of {e['threads']} a SM; "
        f"the glass pass adds {added:.4f} ms to the call, "
        f"bound {entries[k]['bound_ms']:.4f} ms ({entries[k]['bound_by']}) "
        f"on {n_glass} glass lanes, plain glass terms {glass_plain_ms:.3f} "
        f"ms, {entries[k]['registers']} registers, "
        f"{entries[k]['blocks_per_sm']} blocks of {entries[k]['threads']} a "
        f"SM; the frame's call queued {e['call_queued_ms'][0]:.4f} / "
        f"{e['call_queued_ms'][1]:.4f} ms against {e['call_bound_ms']:.4f} "
        f"[{card}]")
    sec_calls = {
        "rt_light_rays": lambda _: rs.rt_light_rays(
            geom, fr.glass.o, fr.glass.d, fr.sec_k1, lts, nl),
        "rt_shade": lambda _: rs.rt_shade(
            fr.sec_hit, fr.glass.d, fr.sec_occluded, mats, lts, nl, params)}
    for k, kern in sec_calls.items():
        queued = [stages.clones_ms(kern, [None] * 21, stages.SPIN_CYCLES)
                  for _ in range(2)]
        b = bounds[f"{k} (glass rays)"]
        entries[k]["glass_rays_queued_ms"] = queued
        entries[k]["glass_rays_bound_ms"] = b["bound_ms"]
        log(f"  {k} on the {2 * n_glass} glass rays (2G for the {n_glass} "
            f"glass lanes): queued {queued[0]:.4f} / "
            f"{queued[1]:.4f} ms, bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}) [{card}]")
    del fr, sc
    torch.cuda.empty_cache()

    # a small frame on the GPU and on the CPU (the plain versions)
    small = {}
    for name, dv in (("cpu", torch.device("cpu")), ("gpu", dev)):
        s = build_rt_bench_scene(256, 144, RT_SMALL_TRIS, device=dv)
        small[name] = s.render_frame()
    dsm = np.abs(small["cpu"].astype(int) - small["gpu"].astype(int)).max(-1)
    small_within = float((dsm <= 1).mean())
    log(f"[rt] 256x144 RTScene of the bench scene ({RT_SMALL_TRIS} "
        f"triangles target) GPU vs CPU: within 1 LSB on {small_within:.5f} of pixels, exact "
        f"on {float((dsm == 0).mean()):.5f}, max {int(dsm.max())} LSB "
        f"[{card}]")
    assert small_within >= RT_FRAME_AGREE, small_within
    return {"entries": entries, "frame_ms": frame_ms, "host_ms": host_ms,
            "device_ms": prof["device_ms"], "rgb8_sha256": rgb_sha,
            "split": split, "glass_lanes": n_glass,
            "profiled_launches": prof["launches"], "launches": launches,
            "frame_within_1_lsb": within, "frame_causes": causes,
            "stages": shares, "small_within_1_lsb": small_within}


# -- 12. the rest of the PT Scene API on the card --------------------------------


def wire_scene(dev, w: int, h: int, dynamic: bool = False):
    """A 98-triangle Scene (a floor, a sphere, a cube, an emissive cube) at
    w x h, small enough for the plain walk on the CPU at 1080p;
    ``dynamic``: the sphere and the cube walked as instances (K4)."""
    from ptrt_tpu_torch.scene.materials import Material
    from ptrt_tpu_torch.scene.pt_scene import Scene

    sc = Scene(w, h, device=dev)
    sc.add_plane_xz(-1.0, 8.0, Material.make((0.8, 0.8, 0.8), 0.6))
    sc.add_sphere(6, Material.make((0.7, 0.2, 0.2), 0.4)).transform \
        .set_position(0.0, -0.4, 4.0)
    sc.add_cube(Material.make((0.2, 0.3, 0.8), 0.3)).transform \
        .set_position(1.2, -0.5, 5.0)
    lamp = sc.add_cube(Material.make((1.0, 1.0, 1.0), 0.0).replace(
        emission=(4.0, 3.0, 2.0)))
    lamp.transform.set_position(-1.3, 0.2, 5.5).set_scale(0.6)
    sc.add_point_light((2, 3, 1), (1, 1, 1), 3.0)
    sc.set_camera((0, 0.5, 0), (0, 0, 4), fov=60)
    for m in (sc.meshes[1:3] if dynamic else ()):
        m.is_dynamic = True
    return sc


# the wireframe program's calls: (thickness, the camera moved before it)
WIRE_CALLS = ((0.05, False), (0.12, False), (0.12, True), (0.03, True))
WIRE_TURN = 20  # calls a turn, eager against the program


def wire_eager(sc, thickness):
    """The wireframe's body run eagerly on the scene's own tables, its host
    values staged as its program stages them: (H, W, 3) uint8 on the
    card."""
    from ptrt_tpu_torch import graphs
    from ptrt_tpu_torch.scene.pt_scene import _wire_body

    reads, _, values = sc._wire_inputs(thickness)
    staged = graphs.HostValues(sc.device).stage(values)
    return _wire_body(sc.width, sc.height, sc.device)(reads, None, staged)[0]


def check_wire_program(name, sc, card) -> dict:
    """Phase 12: ``Scene.render_wireframe``'s kept program (a CUDA graph
    replayed every call after the first) against its eager body, bit for
    bit, at each of WIRE_CALLS (a thickness change, then the camera moved
    twice); the scene's one program, under ("wire", W, H), made once
    whatever the calls changed; one replay's
    synchronizing calls (sync debug mode and the profiler's trace: none),
    device ms and kernels; host ms a call, eager against the program, in
    two turns of WIRE_TURN calls."""
    import torch
    from ptrt_tpu_torch.tools import stages

    differ = []
    for k, (thickness, move) in enumerate(WIRE_CALLS):
        if move:
            sc.camera = moved_camera(sc)
        want = wire_eager(sc, thickness)
        got = sc._wireframe_device(thickness)
        if not torch.equal(got, want):
            differ.append(k)
    key = ("wire", sc.width, sc.height)
    prog = sc._programs.get(key)
    out = {"calls": len(WIRE_CALLS), "calls_differing": differ,
           "programs_made": sc._programs.made,
           "captured": prog is not None and prog.graph is not None}
    call = lambda i=0: sc._wireframe_device(0.05 + 0.01 * (i % 2))
    out["sync_calls"] = sync_calls(call)
    out["trace"] = trace_waits(call)
    kern = stages.profiled_kernels(call, lead_cycles=stages.SPIN_CYCLES)
    out["device_ms"] = sum(us for _, us in kern) / 1e3
    out["kernels"] = collections.Counter(n[:40] for n, _ in kern)
    out["replay_launches"] = dict(prog.launches) if prog is not None else {}
    out["turns"] = [{"eager": loop_times(
        lambda i: wire_eager(sc, 0.05 + 0.01 * (i % 2)), WIRE_TURN),
        "program": loop_times(call, WIRE_TURN)} for _ in range(2)]
    t = out["turns"]
    log(f"[api] render_wireframe program, {name} at {sc.width}x"
        f"{sc.height}: {len(WIRE_CALLS)} calls (thickness and camera "
        f"changes) replayed bit for bit the eager body, differing {differ}; "
        f"programs made {out['programs_made']}, captured {out['captured']}; "
        f"host ms a call eager {[round(x['eager']['host_ms'], 3) for x in t]}"
        f", program {[round(x['program']['host_ms'], 3) for x in t]}; wall "
        f"ms a call eager {[round(x['eager']['frame_ms'], 3) for x in t]}, "
        f"program {[round(x['program']['frame_ms'], 3) for x in t]} (in "
        f"turns); one replay {out['device_ms']:.4f} device ms in "
        f"{sum(out['kernels'].values())} kernels {dict(out['kernels'])}, "
        f"launches {out['replay_launches']}; {len(out['sync_calls'])} "
        f"synchronizing calls, trace waits {out['trace']['waits']}, "
        f"device-to-host copies {out['trace']['dtoh_copies']} [{card}]")
    assert not differ, (name, differ)
    assert out["programs_made"] == 1 and out["captured"], (name, out)
    assert not out["sync_calls"], (name, out["sync_calls"])
    assert not out["trace"]["dtoh_copies"] and not out["trace"]["waits"], (
        name, out["trace"])
    assert out["replay_launches"].get("closest_hit", 0) >= 1, (name, out)
    return out


def check_scene_api(dev, card) -> dict:
    """Phase 12: the PT Scene API the port finished in this slice, on the
    card.  render_wireframe at W x H: a 98-triangle scene against the same
    scene on the CPU (the plain walk) within 1 LSB, and the 1M-triangle
    bench scene's timed; trace_single_ray on the bench scene (API_TRIS)
    against the CPU for API_RAYS rays (hit, mesh and front face equal, t and
    normal within 1e-5); warmup(): the next two balanced frames bit-identical
    to an unwarmed scene's; a checkpoint saved after 3 balanced frames and
    loaded into a fresh scene: the 4th frame bit-identical to the
    uninterrupted run's."""
    import numpy as np
    import torch
    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.app.bench_scene import build_bench_scene
    from ptrt_tpu_torch.build import BUILD_DIR
    from ptrt_tpu_torch.utils.checkpoint import (load_render_state,
                                                 save_render_state)

    out = {}
    cpu = torch.device("cpu")
    wires = {}
    for name, d in (("cpu", cpu), ("gpu", dev)):
        t0 = time.time()
        wires[name] = wire_scene(d, W, H).render_wireframe(0.05)
        out[f"wireframe_{name}_s"] = time.time() - t0
    diff = np.abs(wires["cpu"].astype(int) - wires["gpu"].astype(int))
    out["wireframe_max_lsb"] = int(diff.max())
    out["wireframe_exact"] = float((diff == 0).all(-1).mean())
    bench = build_bench_scene(W, H, TRIS, device=dev)
    bench.render_wireframe(0.05)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = bench.render_wireframe(0.05)
    out["wireframe_bench_ms"] = 1e3 * (time.perf_counter() - t0)
    # the slice's path: render_wireframe on the three scenes, its launches
    # counted from zero
    scenes = {"98 triangles": wire_scene(dev, W, H),
              "98 triangles, instances": wire_scene(dev, W, H, True),
              "bench": bench}
    kernels.clear_counts()
    for sc in scenes.values():
        sc.render_wireframe(0.07)
    out["wireframe_launches"] = dict(kernels.counts())
    log(f"[api] render_wireframe on the three scenes, launches "
        f"{out['wireframe_launches']} [{card}]")
    for k in ("closest_hit", "instances_closest"):
        assert out["wireframe_launches"].get(k, 0) > 0, (k, "not launched")
    out["wireframe_program"] = {
        name: check_wire_program(name, sc, card)
        for name, sc in scenes.items()}
    del scenes
    white = int(255.99 * 0.5 ** (1.0 / 2.2))  # a white edge, tonemapped
    log(f"[api] render_wireframe {W}x{H}: the 98-triangle scene GPU vs CPU "
        f"max {out['wireframe_max_lsb']} LSB, exact on "
        f"{out['wireframe_exact']:.6f} of pixels; the {TRIS}-triangle bench "
        f"scene's {out['wireframe_bench_ms']:.2f} ms on the host clock, "
        f"white edge pixels {float((img == white).all(-1).mean()):.4f} "
        f"[{card}]")
    assert out["wireframe_max_lsb"] <= 1
    assert len(np.unique(wires["gpu"].reshape(-1, 3), axis=0)) > 3
    del bench

    # trace_single_ray: the GPU's answer against the CPU's
    scs = {name: build_bench_scene(W, H, API_TRIS, device=d)
           for name, d in (("cpu", cpu), ("gpu", dev))}
    rng = np.random.default_rng(12)
    eye = np.array([0.0, 1.2, -1.5])
    hits = 0
    for _ in range(API_RAYS):
        target = rng.uniform([-4.0, -1.0, 3.0], [4.0, 1.0, 12.0])
        got = scs["gpu"].trace_single_ray(eye, target - eye)
        want = scs["cpu"].trace_single_ray(eye, target - eye)
        assert bool(got.hit) == bool(want.hit), (target, got, want)
        assert int(got.mesh_index) == int(want.mesh_index)
        if got.hit:
            hits += 1
            assert bool(got.front_face) == bool(want.front_face)
            assert abs(float(got.t) - float(want.t)) <= 1e-5 * max(
                1.0, abs(float(want.t)))
            for c in "xyz":
                assert abs(float(getattr(got.normal, c))
                           - float(getattr(want.normal, c))) <= 1e-5
    out["trace_single_ray_hits"] = hits
    log(f"[api] trace_single_ray: {API_RAYS} rays on the {API_TRIS}-triangle "
        f"target bench scene, GPU equal to CPU ({hits} hits) [{card}]")
    assert hits >= API_RAYS // 2
    del scs

    # warmup: the next frames of a warmed scene are an unwarmed scene's
    scenes = [balanced(build_bench_scene(W, H, API_TRIS, device=dev))
              for _ in range(2)]
    t0 = time.time()
    scenes[0].warmup()
    out["warmup_s"] = time.time() - t0
    for k in range(2):
        a, b = (sc.render_frame_device() for sc in scenes)
        assert torch.equal(a, b), f"warmed frame {k} differs"
    log(f"[api] warmup() {out['warmup_s']:.2f} s; the next two balanced "
        f"{W}x{H} frames bit-identical to an unwarmed scene's [{card}]")

    # the checkpoint: 3 frames, save, the 4th against a fresh scene's
    path = os.path.join(BUILD_DIR, "chip_smoke_state.npz")
    a = balanced(build_bench_scene(W, H, API_TRIS, device=dev))
    for _ in range(3):
        a.render_frame_device()
    save_render_state(a, path)
    fourth = a.render_frame_device()
    b = balanced(build_bench_scene(W, H, API_TRIS, device=dev))
    b._ensure_device_state()
    load_render_state(b, path)
    resumed = b.render_frame_device()
    out["checkpoint_bytes"] = os.path.getsize(path)
    os.remove(path)
    assert torch.equal(fourth, resumed), "the resumed frame differs"
    log(f"[api] checkpoint after 3 balanced {W}x{H} frames "
        f"({out['checkpoint_bytes']} bytes): the 4th frame bit-identical "
        f"after a load into a fresh scene [{card}]")
    return out


# -- 13. the tiled trace: trace_frame(tile=...) at 1080p ---------------------


# the cuts of the 1080p frame: row edges, column edges
TILE_CUTS = {"2x2": ((0, 540, 1080), (0, 960, 1920)),
             "uneven 3x3": ((0, 337, 801, 1080), (0, 1111, 1500, 1920))}
TILE_FIELDS = ("color", "diffuse", "specular", "emission", "normal", "depth",
               "object_id", "roughness", "transmission")


def tile_planes(bufs, name) -> list:
    v = getattr(bufs, name)
    if v is None:
        return []
    return [v.x, v.y, v.z] if hasattr(v, "x") else [v]


def trace_tiled(sc, state, spp, depth, split, rows, cols):
    """trace_frame of ``sc``'s tables over the tiles of the cut (rows,
    cols), put together: (state, {field: planes}, rays, tiles)."""
    import torch
    from ptrt_tpu_torch.render import pipeline

    h, w = state.shape
    state_out = torch.empty_like(state)
    planes, rays, tiles = None, 0, 0
    for y0, y1 in zip(rows, rows[1:]):
        for x0, x1 in zip(cols, cols[1:]):
            st, bufs = pipeline.trace_frame(
                sc._geom, sc._mat_table, sc._light_table, len(sc.lights),
                sc.sky(), sc.camera, state[y0:y1, x0:x1].clone(), 0,
                x1 - x0, y1 - y0, spp, depth, sc._blue_noise, split=split,
                tile=(y0, x0, h, w))
            if planes is None:
                planes = {f: [torch.empty((h, w), dtype=q.dtype,
                                          device=q.device)
                              for q in tile_planes(bufs, f)]
                          for f in TILE_FIELDS}
            state_out[y0:y1, x0:x1] = st
            for f in TILE_FIELDS:
                for dst, src in zip(planes[f], tile_planes(bufs, f)):
                    dst[y0:y1, x0:x1] = src
            rays += int(bufs.rays_traced)
            tiles += 1
    return state_out, planes, rays, tiles


def same_bits(a, b) -> bool:
    import torch

    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def check_tiles(sc, card) -> dict:
    """Phase 13: the bench frame's trace (``sc`` in its bench settings)
    whole and tiled, bit for bit; the launches of the tiled traces."""
    import torch
    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.render import pipeline

    sc._ensure_device_state()
    state = sc._rng_state.clone()
    out = {}
    for split, spp, cuts in ((False, SPP, ("2x2", "uneven 3x3")),
                             (True, 1, ("2x2",))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, whole = pipeline.trace_frame(
            sc._geom, sc._mat_table, sc._light_table, len(sc.lights),
            sc.sky(), sc.camera, state, 0, W, H, spp, DEPTH,
            sc._blue_noise, split=split)
        torch.cuda.synchronize()
        whole_ms = 1e3 * (time.perf_counter() - t0)
        for cut in cuts:
            rows, cols = TILE_CUTS[cut]
            kernels.launches.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            t_state, planes, rays, tiles = trace_tiled(
                sc, state, spp, DEPTH, split, rows, cols)
            torch.cuda.synchronize()
            tiled_ms = 1e3 * (time.perf_counter() - t0)
            launches = dict(kernels.launches)
            equal = {f: all(same_bits(a, b) for a, b in zip(
                planes[f], tile_planes(whole, f)))
                and len(planes[f]) == len(tile_planes(whole, f))
                for f in TILE_FIELDS}
            tag = f"{'split' if split else 'unsplit'} {spp} spp, {cut}"
            out[tag] = {"tiles": tiles, "equal": equal,
                        "state_equal": same_bits(t_state, st),
                        "rays": rays, "whole_rays": int(whole.rays_traced),
                        "whole_ms": whole_ms, "tiled_ms": tiled_ms,
                        "launches": launches}
            log(f"[tiles] 1080p bench frame, {tag} ({tiles} tiles) vs "
                f"whole: planes bit for bit {equal}, PCG state "
                f"{out[tag]['state_equal']}, rays {rays} vs "
                f"{int(whole.rays_traced)}; whole {whole_ms:.1f} ms, tiled "
                f"{tiled_ms:.1f} ms (host clock); launches {launches} "
                f"[{card}]")
            assert all(equal.values()) and out[tag]["state_equal"], out[tag]
            assert rays == int(whole.rays_traced), (rays, whole.rays_traced)
            for k in ("closest_hit", "any_hit", "shade_nee",
                      "shade_scatter"):
                assert launches.get(k, 0) == tiles * spp * DEPTH, (
                    k, launches)
        del whole
        torch.cuda.empty_cache()
    return out


# -- 14. the unified scene layer and the demo entry point ------------------------


def check_app(dev, card) -> dict:
    """Phase 14: two UnifiedScenePresets into both backends at 1080p, and
    the demo's main for both backends, each with its launches."""
    import contextlib
    import io
    import tempfile

    import numpy as np
    import torch
    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.app import demo
    from ptrt_tpu_torch.scene.unified import (UnifiedSceneBuilder,
                                              UnifiedScenePresets)
    from ptrt_tpu_torch.utils.imageio import load_ppm

    out = {}
    pt_kernels = ("closest_hit", "any_hit", "shade_nee", "shade_scatter",
                  "tonemap_rgb8")
    rt_kernels = ("closest_hit", "any_hit", "rt_light_rays", "rt_shade",
                  "rt_resolve")
    for preset in ("CornellBox", "GlassDemo"):
        u = getattr(UnifiedScenePresets, preset)(W, H)
        for backend in ("pt", "rt"):
            t0 = time.perf_counter()
            sc = getattr(UnifiedSceneBuilder, f"build_{backend}_scene")(
                u, device=dev)
            img = sc.render_frame_device()  # the warm-up, set-up included
            torch.cuda.synchronize()
            first_ms = 1e3 * (time.perf_counter() - t0)
            kernels.clear_counts()
            frame_ms = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = sc.render_frame_device()
                torch.cuda.synchronize()
                frame_ms.append(1e3 * (time.perf_counter() - t0))
            launches = dict(kernels.counts())
            tag = f"{preset} {backend}"
            out[tag] = {"first_ms": first_ms, "frame_ms": frame_ms,
                        "launches": launches,
                        "triangles": sum(m.num_triangles
                                         for m in sc.meshes)}
            log(f"[app] UnifiedScenePresets.{preset} {W}x{H} -> "
                f"{'Scene' if backend == 'pt' else 'RTScene'} "
                f"({out[tag]['triangles']} triangles): first frame "
                f"{first_ms:.1f} ms (set-up included), frames "
                f"{[round(x, 2) for x in frame_ms]} ms; launches {launches} "
                f"[{card}]")
            assert img.shape == (H, W, 3) and float(img.float().std()) > 0
            for k in (pt_kernels if backend == "pt" else rt_kernels):
                assert launches.get(k, 0) > 0, (tag, k, launches)
            if preset == "GlassDemo" and backend == "rt":
                assert launches.get("rt_glass_rays", 0) == 3, launches
            del sc, img
            torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        for backend in ("pt", "rt"):
            stem = os.path.join(tmp, f"demo_{backend}")
            said = io.StringIO()
            kernels.clear_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(said):
                rc = demo.main(["--backend", backend, "--frames", "3", "-w",
                                str(W), "-h", str(H), "-o", stem])
            run_s = time.perf_counter() - t0
            launches = dict(kernels.counts())
            img = load_ppm(stem + ".ppm")
            tag = f"demo {backend}"
            out[tag] = {"rc": rc, "s": run_s, "launches": launches,
                        "output": said.getvalue().strip().splitlines()}
            log(f"[app] python -m ptrt_tpu_torch.app.demo --backend "
                f"{backend} --frames 3 -w {W} -h {H}: rc {rc}, {run_s:.1f} s "
                f"with set-up; it printed {out[tag]['output']}; launches "
                f"{launches} [{card}]")
            assert rc == 0 and img.shape == (H, W, 3), (rc, img.shape)
            assert os.path.getsize(stem + ".png") > 0
            assert float(np.asarray(img, np.float32).std()) > 0
            for k in (pt_kernels if backend == "pt" else rt_kernels):
                assert launches.get(k, 0) > 0, (tag, k, launches)
    torch.cuda.empty_cache()
    return out


def k11_inputs(n: int, seed: int, dev):
    """Seeded TRS of ``n`` instances and their local boxes: scales of both
    signs, a tenth collapsed to 1e-6 at y = -100 (the games' hidden
    slots), some exactly 0; angles past 2 pi."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    pos = rng.uniform(-50.0, 50.0, (n, 3))
    rot = rng.uniform(-9.0, 9.0, (n, 3))
    scale = rng.uniform(0.2, 3.0, (n, 3)) * rng.choice([-1.0, 1.0], (n, 3))
    hidden = rng.random(n) < 0.1
    scale[hidden] = 1e-6
    pos[hidden, 1] = -100.0
    scale[rng.random((n, 3)) < 0.02] = 0.0
    lo = -rng.uniform(0.1, 2.0, (n, 3))
    hi = rng.uniform(0.1, 2.0, (n, 3))
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    return [t(a) for a in (pos, rot, scale, lo, hi)]


def k11_walks(world, k11_bufs, n: int, rng) -> dict:
    """K4 closest and any-hit over K11's tree against the same walks over
    build_tlas's tree of K11's boxes: ``n`` instances of ``world``'s cubes
    (its set's first ``n`` roots) moved by K11's rows; records bit for bit
    on K11_WALK_RAYS seeded rays at the boxes."""
    import numpy as np
    import torch
    from ptrt_tpu_torch.core.vec import Vec3
    from ptrt_tpu_torch.geometry.scene_geom import InstanceSet, WorldGeometry
    from ptrt_tpu_torch.geometry.tlas import build_tlas
    from ptrt_tpu_torch.render import traverse

    mats, bmin, bmax, tree = k11_bufs
    base = world.iset
    iset = InstanceSet(geom=base.geom, roots=base.roots[:n].contiguous(),
                       mats=mats, bb_min=bmin, bb_max=bmax, tlas=tree)
    host = torch.from_numpy(build_tlas(bmin.cpu().numpy(),
                                       bmax.cpu().numpy())).to(tree.device)
    worlds = [WorldGeometry(static=world.static, instances=(), iset=s)
              for s in (iset, InstanceSet(geom=base.geom, roots=iset.roots,
                                          mats=mats, bb_min=bmin,
                                          bb_max=bmax, tlas=host))]
    # rays from behind the field at the boxes' centres, and a quarter of
    # them anywhere through it
    r = K11_WALK_RAYS
    centre = 0.5 * (bmin + bmax).cpu().numpy()
    aim = centre[rng.integers(0, n, r)] + rng.uniform(-0.05, 0.05, (r, 3))
    aim = np.where((rng.random(r) < 0.25)[:, None],
                   rng.uniform(-50.0, 50.0, (r, 3)), aim)
    org = rng.normal([0.0, 0.0, -90.0], 1.0, (r, 3))
    dirs = aim - org
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    vec = lambda a: Vec3(*[torch.tensor(a[:, j], dtype=torch.float32,
                                        device=tree.device) for j in range(3)])
    o, d = vec(org), vec(dirs)
    t_max = torch.full_like(o.x, traverse.T_MAX)
    a, b = (traverse.closest_hit(w, o, d, t_max) for w in worlds)
    planes = lambda r: [p.view(torch.int32) for p in (*r, r.inst)]
    closest = all(bool((x == y).all()) for x, y in zip(planes(a), planes(b)))
    shadow_t = torch.where(a.mesh >= 0, a.t, 50.0)
    occ = [traverse.any_hit(w, o, d, shadow_t) for w in worlds]
    return {"rays": r, "closest_bit_for_bit": closest,
            "any_bit_for_bit": bool((occ[0] == occ[1]).all()),
            "on_instance": float((a.inst >= 0).float().mean())}


def check_k11(dev, card, resources=None) -> dict:
    """K11 against its plain version on the card at K11_SIZES, the
    wrapper's one-block limit and one past it: rows and boxes equal on
    every lane, the tree bit for bit build_tlas of K11's own boxes, K4 over
    it bit for bit K4 over build_tlas's, each timed queued beside its bound
    and the plain version (with that version's launches); the grid path
    with its scratch allocated once (the outputs' and scratch's addresses
    unchanged, the allocations a call); the kernels' registers and local
    memory (no spills; in the SASS only sinf / cosf's slow path)."""
    import numpy as np
    import torch
    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.geometry import dtransform as dt
    from ptrt_tpu_torch.geometry.mesh import Mesh
    from ptrt_tpu_torch.geometry.tlas import (TLAS_ROW, TLAS_WIDTH,
                                              build_tlas, build_tlas_plain,
                                              level_layout, tlas_node_count)
    from ptrt_tpu_torch.tools import stages

    limit = dt.one_block_max()
    sizes = sorted({*K11_SIZES, limit, limit + 1})
    cube = Mesh.cube().local_aabb()
    world = stages.instance_world(max(sizes), 77, dev)
    f32 = dict(dtype=torch.float32, device=dev)

    def outputs(n):
        return [torch.full((n, 24), np.nan, **f32),
                torch.full((n, 3), np.nan, **f32),
                torch.full((n, 3), np.nan, **f32),
                torch.full((tlas_node_count(n), TLAS_WIDTH, TLAS_ROW), np.nan,
                           **f32)]

    def held(ins, bufs):
        """Lanes whose rows / boxes differ from the plain version's, the
        largest errors, and the tree against build_tlas and the plain
        tree, bit for bit."""
        want = dt.instances_update_plain(*ins)
        host = build_tlas(bufs[1].cpu().numpy(), bufs[2].cpu().numpy())
        plain_tree = build_tlas_plain(bufs[1], bufs[2])
        return {
            "mats_lanes_differ": int((bufs[0] != want[0]).any(1).sum()),
            "box_lanes_differ": int(((bufs[1] != want[1])
                                     | (bufs[2] != want[2])).any(1).sum()),
            "max_abs_err": max(float((bufs[k] - want[k]).abs().max())
                               for k in range(3)),
            "max_rel_err_rows": float(((bufs[0] - want[0]).abs()
                                       / (want[0].abs() + 1e-6)).max()),
            "tree_bit_for_bit": np.array_equal(
                bufs[3].cpu().numpy().view(np.uint32), host.view(np.uint32)),
            "tree_equals_plain_tree": bool(
                (bufs[3].view(torch.int32)
                 == plain_tree.view(torch.int32)).all())}

    def queued(call):
        return [stages.clones_ms(lambda _: call(), [None] * 51,
                                 stages.SPIN_CYCLES) for _ in range(2)]

    out = {"sizes": {}}
    for n in sizes:
        ins = k11_inputs(n, n, dev)
        bufs = outputs(n)
        scratch = dt.instances_scratch(n, dev) if n > limit else None
        ptrs = [t.data_ptr() for t in bufs + list(scratch or ())]
        call = lambda: dt.instances_update(*ins, *bufs, scratch)
        call()
        torch.cuda.synchronize()
        r = held(ins, bufs)
        stats = torch.cuda.memory_stats(dev)["allocation.all.allocated"]
        call()
        r["allocations_a_call"] = (torch.cuda.memory_stats(dev)[
            "allocation.all.allocated"] - stats)
        r["addresses_fixed"] = ptrs == [t.data_ptr() for t in
                                        bufs + list(scratch or ())]
        r["queued_ms"] = queued(call)
        r["ms"] = sum(r["queued_ms"]) / 2
        kern = stages.profiled_kernels(call, lead_cycles=stages.SPIN_CYCLES)
        # (the profiler may miss a launch this short: then not measured)
        r["kernel_ms"] = sum(us for _, us in kern) / 1e3 if kern else None
        r["kernels"] = [k[:40] for k, _ in kern]
        kernels.launches.clear()
        call()
        r["launches"] = {k: v for k, v in kernels.launches.items() if v}
        r["plain_ms"] = cuda_ms(lambda: dt.instances_update_plain(*ins), 5)
        r["plain_launches"] = len(stages.profiled_kernels(
            lambda: dt.instances_update_plain(*ins)))
        nodes = tlas_node_count(n)
        r.update(bound(n * (60 + 120) + nodes * TLAS_WIDTH * TLAS_ROW * 4,
                       n * K11_OPS))
        r["path"] = "one block" if n <= limit else "grid"
        # K4 over the tree of the same transforms on cubes
        cubes = outputs(n)
        box = [torch.from_numpy(np.tile(np.asarray(c, np.float32), (n, 1)))
               .to(dev) for c in (cube.lo, cube.hi)]
        dt.instances_update(*ins[:3], *box, *cubes, scratch)
        r["walks"] = k11_walks(world, cubes, n, np.random.default_rng(90 + n))
        out["sizes"][n] = r
        log(f"[k11] {n} instances ({r['path']}): rows differ on {r['mats_lanes_differ']} lanes, boxes on "
            f"{r['box_lanes_differ']} (largest error {r['max_abs_err']:.3g}, "
            f"rows relative {r['max_rel_err_rows']:.3g}); tree bit for bit "
            f"build_tlas of its boxes {r['tree_bit_for_bit']}, "
            f"build_tlas_plain {r['tree_equals_plain_tree']}; K4 over it bit "
            f"for bit over build_tlas's: closest "
            f"{r['walks']['closest_bit_for_bit']}, any "
            f"{r['walks']['any_bit_for_bit']} ({r['walks']['rays']} rays, "
            f"{r['walks']['on_instance']:.3f} on an instance); queued "
            f"{r['queued_ms'][0]:.4f} / {r['queued_ms'][1]:.4f} ms (first "
            f"design: {K11_FIRST_DESIGN_MS.get(n, 'not measured')}), by the "
            f"profiler "
            + ("not measured" if r["kernel_ms"] is None
               else f"{r['kernel_ms']:.4f} ms") + " in "
            f"{len(kern)} launches, bound {r['bound_ms']:.7f} ms "
            f"({r['bound_by']}); plain {r['plain_ms']:.3f} ms in "
            f"{r['plain_launches']} launches; addresses fixed "
            f"{r['addresses_fixed']}, {r['allocations_a_call']} allocations "
            f"a call [{card}]")
        assert r["tree_bit_for_bit"] and r["tree_equals_plain_tree"], n
        assert r["mats_lanes_differ"] == 0 and r["box_lanes_differ"] == 0, (
            n, r["mats_lanes_differ"], r["box_lanes_differ"],
            r["max_abs_err"])
        assert r["walks"]["closest_bit_for_bit"] and r["walks"][
            "any_bit_for_bit"], n
        assert r["addresses_fixed"], n
        want = ({"instances_update": 1} if n <= limit else {
            "instances_rows": 1, "instances_codes": 1,
            "instances_level": len(level_layout(n)[0])})
        assert r["launches"] == want, (n, r["launches"])
        del ins, bufs, cubes, scratch
    if resources is not None:
        # the kernels that run instance_rows: the rows kernel and the one
        # block
        rows_keys = ("inst_update_kernel", "inst_rows_kernel")
        regs, runs_rows = {}, {}
        for key in rows_keys + ("inst_codes_kernel", "inst_level_kernel"):
            for fn, v in resources.get(key, {}).items():
                regs[fn[-40:]] = {k: v[k] for k in (
                    "registers", "stack_bytes", "local_bytes")} | {
                    "local_sass": v["sass"].get("local", 0)}
                runs_rows[fn[-40:]] = key in rows_keys
        out["resources"] = regs
        # no spills (local_bytes 0); the only local memory in the SASS is
        # sinf / cosf's slow path (Payne-Hanek, arguments past 105,615):
        # the kernels that run instance_rows run it once each, and the
        # codes and levels kernels hold none
        trig = next(regs[fn[-40:]]["local_sass"]
                    for fn in resources.get("inst_rows_kernel", {}))
        log(f"[k11] resources: {regs}; local memory only in sinf / cosf's "
            f"slow path ({trig} instructions an instance's rows) [{card}]")
        assert all(v["local_bytes"] == 0 for v in regs.values()), regs
        assert len(runs_rows) == 4 and trig > 0, regs
        for fn, v in regs.items():
            assert v["local_sass"] == (trig if runs_rows[fn] else 0), (
                fn, v, trig)
    return out


class forbid_host_updates:
    """Inside: the host scene update paths raise (Scene._rebuild_geometry,
    the host tree build, UnifiedSceneBuilder.update_pt_scene)."""

    def __enter__(self):
        from ptrt_tpu_torch.geometry import scene_geom, tlas
        from ptrt_tpu_torch.scene import pt_scene, unified

        def refuse(*a, **k):
            raise AssertionError("a fused frame went through a host scene "
                                 "update")

        self.saved = [(pt_scene.Scene, "_rebuild_geometry"),
                      (tlas, "build_tlas"), (scene_geom, "build_tlas"),
                      (unified.UnifiedSceneBuilder, "update_pt_scene")]
        self.saved = [(o, k, o.__dict__[k]) for o, k in self.saved]
        for o, k, _ in self.saved:
            setattr(o, k, staticmethod(refuse) if isinstance(o, type)
                    else refuse)
        return self

    def __exit__(self, *exc):
        for o, k, v in self.saved:
            setattr(o, k, v)
        return False


def sync_calls(fn) -> list:
    """The synchronizing CUDA calls of ``fn()`` under
    torch.cuda.set_sync_debug_mode("warn"): [(where, the source line)]."""
    import linecache
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # (switching the mode back warns from torch's own module)
    return [(f"{os.path.relpath(w.filename, HERE)}:{w.lineno}",
             linecache.getline(w.filename, w.lineno).strip())
            for w in got if "synchroniz" in str(w.message)
            and not w.filename.endswith(os.path.join("cuda", "__init__.py"))]


# runtime calls that make the host wait for the card
WAIT_CALLS = ("cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
              "cuCtxSynchronize", "cuStreamSynchronize",
              "cuEventSynchronize", "cuMemcpyDtoH", "cuMemcpyDtoH_v2")


def trace_waits(fn) -> dict:
    """What torch.profiler's trace of ``fn()`` shows of host waits: the
    device-to-host copies, the synchronizing runtime calls made inside
    ``fn`` (the profiler's own closing synchronize left out), and, for
    the record, the device's copies and the runtime calls counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("traced_call"):
            fn()
        torch.cuda.synchronize()
    ev = prof.events()
    host = [e for e in ev if getattr(e, "device_type", None) == DeviceType.CPU]
    call = next(e for e in host if e.name == "traced_call")
    inside = [e for e in host if e.name != "traced_call"
              and call.time_range.start <= e.time_range.start
              <= call.time_range.end]
    runtime = [e.name for e in inside if e.name.startswith(("cuda", "cu"))]
    copies = [e.name for e in ev
              if getattr(e, "device_type", None) == DeviceType.CUDA
              and e.name.startswith("Memcpy")]
    return {"dtoh_copies": [c for c in copies if "DtoH" in c],
            "waits": [n for n in runtime if n in WAIT_CALLS],
            "copies": dict(collections.Counter(copies)),
            "runtime_calls": dict(collections.Counter(runtime))}


def game_runner(name: str, w: int, h: int, preset: str, grid, dev):
    """(scene, runner, initial state, inputs_fn) of a fused game; ``grid``:
    the fluid's grid or the tycoon map's side."""
    import torch
    from ptrt_tpu_torch.games import cube_slider, fluid, tycoon

    if name.startswith("cube_slider"):
        _, sc = cube_slider.build_scene(w, h, dev)
        sc.set_performance_preset(preset)
        return (sc, cube_slider.make_runner(sc),
                cube_slider.init_state(0, dev), cube_slider.script_inputs)
    if name.startswith("tycoon"):
        # grid: the map's side (tycoon.GRID where None)
        _, sc, centers = tycoon.build_fused_scene(w, h, dev, grid)
        sc.set_performance_preset(preset)
        dt = torch.tensor(1.0 / 30.0, dtype=torch.float32)
        script = tycoon.run_script(200, grid)
        return (sc, tycoon.make_runner(sc, centers),
                tycoon.init_fused_state(device=dev, grid=grid),
                lambda i: (*script[i], dt))
    _, sc, state = fluid.build_scene(w, h, grid, dev)
    sc.set_performance_preset(preset)
    if "lbvh" in name:
        for m in sc.meshes:
            if m.is_dynamic:
                m.device_lbvh = True
    dt = fluid.step_scalars()[0]
    return sc, fluid.make_runner(sc), state, lambda i: dt


def check_instance_walks(runner, card) -> dict:
    """K4 closest and any-hit over K11's tree against the same walks over
    build_tlas's tree of the same boxes: records bit for bit, on the
    scene's camera rays at its display size."""
    import dataclasses

    import torch
    from ptrt_tpu_torch.geometry.scene_geom import WorldGeometry
    from ptrt_tpu_torch.geometry.tlas import build_tlas
    from ptrt_tpu_torch.render import traverse
    from ptrt_tpu_torch.scene.camera import pixel_grid

    sc, world = runner.scene, runner.world
    iset = world.iset
    host = torch.from_numpy(build_tlas(iset.bb_min.cpu().numpy(),
                                       iset.bb_max.cpu().numpy())).to(
        iset.tlas.device)
    other = WorldGeometry(static=world.static, instances=(),
                          iset=dataclasses.replace(iset, tlas=host))
    s, t = pixel_grid(sc.width, sc.height, sc.device)
    ray = sc.camera.get_ray_simple(s, t)
    o = ray.origin.map(lambda c: c.reshape(-1).contiguous())
    d = ray.direction.map(lambda c: c.reshape(-1).contiguous())
    t_max = torch.full_like(o.x, traverse.T_MAX)
    a = traverse.closest_hit(world, o, d, t_max)
    b = traverse.closest_hit(other, o, d, t_max)
    planes = lambda r: [p.view(torch.int32) for p in (*r, r.inst)]
    closest_same = all(bool((x == y).all())
                       for x, y in zip(planes(a), planes(b)))
    shadow_t = torch.where(a.mesh >= 0, a.t, 50.0)
    occ_a = traverse.any_hit(world, o, d, shadow_t)
    occ_b = traverse.any_hit(other, o, d, shadow_t)
    any_same = bool((occ_a == occ_b).all())
    on_inst = float((a.inst >= 0).float().mean())
    log(f"[games] K4 over K11's tree vs build_tlas's ({iset.count} "
        f"instances, {o.x.shape[0]} camera rays, {on_inst:.4f} on an "
        f"instance): closest records bit for bit {closest_same}, any-hit "
        f"{any_same} [{card}]")
    assert closest_same and any_same
    return {"rays": int(o.x.shape[0]), "on_instance": on_inst,
            "closest_bit_for_bit": closest_same,
            "any_bit_for_bit": any_same}


def check_games(dev, card, resources=None) -> dict:
    """Phase 15: K11 against its plain version, every game's fused run (the
    reference's defaults, then tycoon and a 256 fluid at 1080p balanced)
    with no host scene update, each with its frame rate, a profiled frame,
    K11's time in it and the synchronizing calls of a frame; K4 over K11's
    tree; each game's handle run; a small fused frame GPU vs CPU."""
    import numpy as np
    import torch
    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.games import cube_slider, fluid, tycoon
    from ptrt_tpu_torch.render import pipeline
    from ptrt_tpu_torch.core.vec import Vec3
    from ptrt_tpu_torch.tools import stages

    out = {"k11": check_k11(dev, card, resources), "runs": {}}
    main_path = collections.Counter()
    walks = {}
    for name, w, h, preset, frames, grid in GAME_RUNS:
        sc, runner, state, inputs = game_runner(name, w, h, preset, grid, dev)
        kernels.launches.clear()
        kernels.replays.clear()
        t0 = time.perf_counter()
        with forbid_host_updates():
            state, fps, img = runner.run(state, inputs, frames)
        run_s = time.perf_counter() - t0
        # the run's launches: the wrappers' (the eager warm-up frame; the
        # capture's warm-up counts nowhere) and the graph's replays (one a
        # timed frame)
        replayed = {k: v for k, v in kernels.replays.items() if v}
        launches = dict(collections.Counter(kernels.launches)
                        + collections.Counter(replayed))
        main_path.update(launches)
        k = frames + 1
        prev_vp = sc.camera.get_view_proj()
        one = lambda: runner.frame(state, inputs(k), sc.frame_count, prev_vp)
        with forbid_host_updates():
            syncs = sync_calls(one)
            trace = trace_waits(one)
            kern = stages.profiled_kernels(one, lead_cycles=stages.SPIN_CYCLES)
        dev_ms = sum(us for _, us in kern) / 1e3
        k11_us = [us for n_, us in kern if "inst_update_kernel" in n_]
        rh, rw = sc.render_size
        up_ms = up_host_ms = up_launches = None
        if (rh, rw) != (h, w):
            # the upscale's device time (the profiler, behind a spin) and a
            # call's host time: its plain torch ops outlast their kernels
            hdr = Vec3(*[torch.rand((rh, rw), device=dev) for _ in range(3)])
            up = lambda: pipeline.upscale_bilinear(hdr, h, w)
            up_kern = stages.profiled_kernels(up, calls=3,
                                              lead_cycles=stages.SPIN_CYCLES)
            up_ms = sum(us for _, us in up_kern) / 1e3 / 3
            up_launches = len(up_kern) // 3
            up_host_ms = stages.host_ms(up, calls=10)
        where = {}
        for at, line in syncs:
            where.setdefault(at, [line, 0])[1] += 1
        r = {"size": [w, h], "preset": preset, "render_size": [rw, rh],
             "frames": frames, "fps": fps, "frame_ms": 1e3 / fps,
             "run_s": run_s, "launches": launches,
             "profiled_device_ms": dev_ms, "profiled_launches": len(kern),
             "k11_kernel_ms": sum(k11_us) / 1e3 if k11_us else None,
             "upscale_ms": up_ms, "upscale_launches": up_launches,
             "upscale_host_ms": up_host_ms, "sync_calls": len(syncs),
             "replayed_launches": replayed,
             "sync_where": {k_: v for k_, v in where.items()},
             "trace": trace,
             "image_std": float(np.asarray(img, np.float32).std())}
        out["runs"][name] = r
        log(f"[games] fused {name} {w}x{h} {preset} (traced at {rw}x{rh}): "
            f"{fps:.1f} frames/s, {1e3 / fps:.2f} ms a frame on the host "
            f"clock over {frames} replayed frames; one profiled eager frame "
            f"{dev_ms:.3f} "
            f"device ms in {len(kern)} launches, K11 "
            f"{r['k11_kernel_ms']} ms, upscale {up_ms} device ms in "
            f"{up_launches} launches ({up_host_ms} ms a call on the host "
            f"clock); launches "
            f"{launches}; {len(syncs)} synchronizing calls a frame: "
            f"{r['sync_where']}; the frame's trace: {trace} [{card}]")
        assert img.shape == (h, w, 3) and r["image_std"] > 1.0, name
        # a fused frame reads nothing back: no call torch's sync debug mode
        # flags (it does not see every kind), and in the trace no
        # device-to-host copy and no synchronizing runtime call
        assert not syncs, (name, r["sync_where"])
        assert not trace["dtoh_copies"] and not trace["waits"], (name, trace)
        # K11 once a frame: the warm-up frame and a replay a timed frame
        # (the capture's warm-up counts nowhere)
        assert launches.get("instances_update", 0) == frames + 1, launches
        assert replayed.get("instances_update", 0) == frames, replayed
        for k_ in ("closest_hit", "instances_closest", "any_hit",
                   "instances_any", "shade_nee", "shade_scatter",
                   "tonemap_rgb8"):
            assert launches.get(k_, 0) > 0, (name, k_, launches)
        if name.startswith("fluid"):
            k5 = "morton_sort" if "lbvh" in name and grid <= 128 else None
            assert launches.get("refit", 0) == frames + 1, launches
            if k5:
                assert launches.get(k5, 0) == frames + 1, launches
        if name in ("cube_slider", "tycoon"):
            walks[name] = check_instance_walks(runner, card)
        del sc, runner, state
        torch.cuda.empty_cache()
    # the fused runs' own launches: not the extra frames profiled and
    # checked after each run
    out["main_path_launches"] = dict(main_path)
    out["instance_walks"] = walks

    headless = {}
    for name, fn in (("cube_slider", cube_slider.run_headless),
                     ("fluid", fluid.run_headless),
                     ("tycoon", tycoon.run_headless)):
        t0 = time.perf_counter()
        res = fn(device=dev)
        s_ = time.perf_counter() - t0
        frames = res[1]
        headless[name] = {"s": s_, "frames": len(frames)}
        log(f"[games] {name}.run_headless: {len(frames)} frames of "
            f"{frames[-1].shape}, {s_:.2f} s with set-up [{card}]")
        assert frames and frames[-1].std() > 0, name
    out["headless"] = headless

    w, h = GAME_SMALL_WH
    imgs = {d.type: cube_slider.run_fused(n_frames=2, width=w, height=h,
                                          device=d)[2]
            for d in (torch.device("cpu"), dev)}
    lsb = float((np.abs(imgs["cpu"].astype(int) - imgs["cuda"].astype(int))
                 .max(-1) <= 1).mean())
    out["small_gpu_vs_cpu_within_1_lsb"] = lsb
    log(f"[games] fused cube slider {w}x{h}, 2 frames after the warm-up, GPU "
        f"vs CPU: within 1 LSB on {lsb:.4f} of pixels")
    assert lsb >= GAME_SMALL_AGREE, lsb
    return out


def same_tree(a, b) -> bool:
    """Every tensor leaf of ``a`` equal to ``b``'s, bit for bit (floats
    compared as their bits: NaNs and signed zeros too)."""
    import torch
    from ptrt_tpu_torch.graphs import tree_leaves

    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(bits(x), bits(y))
        for x, y in zip(la, lb))


def moved_camera(sc):
    """The scene's camera 0.4 to the side and 0.2 up, looking where it
    looked: ``Camera.set_position``'s value-semantic move."""
    o = sc.camera.origin
    return sc.camera.set_position((float(o.x) + 0.4, float(o.y) + 0.2,
                                   float(o.z)))


def graph_lockstep(sc, runner, state, inputs, frames, move_at=None) -> dict:
    """From one start, ``frames`` eager frames (``runner.frame``, the frame
    index a host int) against as many replays of the runner's captured
    graph (the index and inputs staged on the card), in turns: RGB8, game
    state, PCG state and denoiser history must be equal bit for bit at
    every frame.  ``move_at``: before that frame the scene's camera moves
    (both paths see it).  Leaves the runner captured, its graph's buffers
    one frame past the start.  Returns the frames that differed."""
    f0 = sc.frame_count
    camera0 = sc.camera
    state, _, cam = runner.frame(state, inputs(0), f0, sc.prev_view_proj)
    prev_vp = cam.get_view_proj()
    e_rng, e_den = sc._rng_state, sc._denoiser_state
    runner.capture(state, inputs(0), prev_vp)
    st = runner.program.state
    bad = []
    for i in range(1, frames + 1):
        if i == move_at:
            sc.camera = moved_camera(sc)
        sc._rng_state, sc._denoiser_state = e_rng, e_den
        state, rgb_e, cam = runner.frame(state, inputs(i), f0 + i, prev_vp)
        prev_vp = cam.get_view_proj()
        e_rng, e_den = sc._rng_state, sc._denoiser_state
        rgb_g = runner.replay(inputs(i), f0 + i)
        same = {"rgb8": same_tree(rgb_e, rgb_g),
                "state": same_tree(state, st["state"]),
                "rng": same_tree(e_rng, st["rng"]),
                "denoiser": same_tree(e_den, st["den"]),
                "prev_view_proj": same_tree(prev_vp, st["prev_vp"])}
        if not all(same.values()):
            bad.append((i, [k for k, v in same.items() if not v]))
    sc._rng_state, sc._denoiser_state = st["rng"], st["den"]
    sc.camera = camera0
    return {"frames": frames, "camera_moved_at": move_at,
            "frames_differing": bad}


def loop_times(fn, n: int) -> dict:
    """``n`` calls of ``fn(i)``: frames a second over the loop with the card
    synchronized at both ends, and host ms a frame to issue them."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"fps": n / wall, "frame_ms": 1e3 * wall / n,
            "host_ms": 1e3 * issued / n}


def check_graphs(dev, card, runs=None) -> dict:
    """Phase 18: the one-program frame.  Each fused game run (GAME_RUNS and
    GRAPH_BIG_TYCOON: K11's grid path and torch.sort captured) eager
    against replayed, bit for bit over GRAPH_FRAMES frames, and again with
    the camera moved at GRAPH_MOVE_AT; frame rates eager and replayed in
    turns; one replay's device ms and kernels (profiler) and its
    synchronizing calls (none); entry() captured against eager calls;
    bench_games.  ``runs``: the game runs (all by default)."""
    import torch
    from ptrt_tpu_torch import entry, graphs
    from ptrt_tpu_torch.geometry.dtransform import one_block_max
    from ptrt_tpu_torch.tools import bench_games, stages

    out = {"runs": {}}
    if runs is None:
        runs = GAME_RUNS + (GRAPH_BIG_TYCOON,)
    for name, w, h, preset, _, grid in runs:
        sc, runner, state0, inputs = game_runner(name, w, h, preset, grid,
                                                 dev)
        start = (graphs.clone_tree(state0), sc.frame_count)
        r = {"size": [w, h], "preset": preset,
             "instances": runner.world.iset.count}
        with forbid_host_updates():
            for move_at in (None, GRAPH_MOVE_AT):
                sc.frame_count = start[1]
                sc._rng_state = sc._denoiser_state = None
                sc._ensure_rng_state()
                sc.prev_view_proj = sc.camera.get_view_proj()
                r["moved" if move_at else "still"] = graph_lockstep(
                    sc, runner, graphs.clone_tree(start[0]), inputs,
                    GRAPH_FRAMES, move_at)
            g = runner.program
            r["graph_launches"] = dict(g.launches)
            k = GRAPH_FRAMES + 1
            f0 = sc.frame_count + k
            e = {"state": graphs.clone_tree(g.state["state"]),
                 "prev": g.state["prev_vp"].clone()}

            def eager(i):
                e["state"], _, cam = runner.frame(e["state"], inputs(k + i),
                                                  f0 + i, e["prev"])
                e["prev"] = cam.get_view_proj()

            replay = lambda i: runner.replay(inputs(k + i), f0 + i)
            turns = []
            for _ in range(2):
                turns.append({"eager": loop_times(eager, GRAPH_FRAMES),
                              "replayed": loop_times(replay, GRAPH_FRAMES)})
            kern = stages.profiled_kernels(lambda: replay(0),
                                           lead_cycles=stages.SPIN_CYCLES)
            syncs = sync_calls(lambda: replay(0))
            trace = trace_waits(lambda: replay(0))
        r.update(turns=turns, replay_device_ms=sum(us for _, us in kern)
                 / 1e3, replay_profiled_launches=len(kern),
                 sync_calls=len(syncs), trace=trace)
        eager_fps = [t["eager"]["fps"] for t in turns]
        graph_fps = [t["replayed"]["fps"] for t in turns]
        log(f"[graphs] {name} {w}x{h} {preset} ({r['instances']} "
            f"instances): eager vs replayed bit for bit over {GRAPH_FRAMES} "
            f"frames: differing {r['still']['frames_differing']}, camera "
            f"moved at frame {GRAPH_MOVE_AT}: differing "
            f"{r['moved']['frames_differing']}; frames/s eager "
            f"{[round(v, 1) for v in eager_fps]}, replayed "
            f"{[round(v, 1) for v in graph_fps]} (in turns); host ms a frame "
            f"eager {[round(t['eager']['host_ms'], 3) for t in turns]}, "
            f"replayed {[round(t['replayed']['host_ms'], 3) for t in turns]};"
            f" one replay {r['replay_device_ms']:.3f} device ms in "
            f"{len(kern)} kernels; the graph's launches {r['graph_launches']}"
            f"; {len(syncs)} synchronizing calls a replay, trace {trace} "
            f"[{card}]")
        for case in ("still", "moved"):
            assert not r[case]["frames_differing"], (name, case, r[case])
        assert not syncs, (name, syncs)
        assert not trace["dtoh_copies"] and not trace["waits"], (name, trace)
        # K11 once a replay: one launch, or past its one-block most the
        # grid path (rows, codes, torch.sort, a launch a tree level)
        gl = r["graph_launches"]
        big = r["instances"] > one_block_max()
        assert gl.get("instances_rows" if big else "instances_update") == 1, r
        assert kern, (name, "the profiler saw no kernel of the replay")
        # torch.sort's kernels (torch's own or CUB's), not the port's
        # morton_sort
        r["sort_kernels"] = sorted({
            n_ for n_, _ in kern if "sort" in n_.lower()
            and ("at::native" in n_ or "cub" in n_.lower())})
        assert bool(r["sort_kernels"]) == big, (name, r["sort_kernels"])
        out["runs"][name] = r
        runner.release()
        del sc, runner, state0, g, e, eager, replay
        torch.cuda.empty_cache()

    # entry(): three replays against three eager calls
    fn, (rng, den, fidx) = entry.entry(device=dev)
    graph = entry.capture(fn, (rng, den, fidx))
    e_args = (rng, den)
    g_args = (rng, den)
    same = []
    for i in range(3):
        idx = torch.full((), i, dtype=torch.int32, device=dev)
        rgb_e, *e_args = fn(*e_args, idx)
        rgb_g, g_rng, g_den = graph(*g_args, idx)
        same.append(same_tree((rgb_e, *e_args), (rgb_g, g_rng, g_den)))
        g_args = (g_rng.clone(), graphs.clone_tree(g_den))
    out["entry"] = {"replays_equal_eager": same,
                    "launches": dict(graph.launches)}
    log(f"[graphs] entry(): 3 captured replays equal to 3 eager calls bit "
        f"for bit {same}; the graph's launches {dict(graph.launches)}")
    assert all(same), same
    del graph, fn

    # bench_games (bench.py and bench_presets run in phase 19)
    t0 = time.perf_counter()
    os.environ["PTRT_GAME_FRAMES"] = str(GRAPH_BENCH_GAME_FRAMES)
    try:
        games = bench_games.main([])
    finally:
        del os.environ["PTRT_GAME_FRAMES"]
    out["bench_games"] = {"s": time.perf_counter() - t0, "lines": games}
    assert len(games) == 9 and all(g_["fps"] > 0 for g_ in games)
    log(f"[graphs] bench_games {out['bench_games']['s']:.1f} s [{card}]")
    return out


# -- 19. the scenes' frame programs -----------------------------------------------


def scene_state(sc) -> list:
    """What a PT frame carries to the next: PCG state, denoiser history,
    progressive sum and count, the view-projection it was taken under,
    ``prev_view_proj`` and the frame count."""
    return [sc._rng_state, sc._denoiser_state, sc._accum,
            sc._accum_view_proj, sc.prev_view_proj, sc.frame_count]


def set_scene_state(sc, st) -> None:
    (sc._rng_state, sc._denoiser_state, sc._accum, sc._accum_view_proj,
     sc.prev_view_proj, sc.frame_count) = st


def eager_frame(sc):
    """One frame of the eager body (``Scene.render_world``), the frame
    count and ``prev_view_proj`` advanced as ``render_frame_device``
    advances them."""
    sc._ensure_device_state()
    img = sc.render_world(sc._geom, sc.camera, sc.frame_count,
                          sc.prev_view_proj,
                          bool(sc.perf.progressive_accumulation))
    sc.frame_count += 1
    sc.prev_view_proj = sc.camera.get_view_proj()
    return img


def program_lockstep(sc, frames: int, edit=None) -> dict:
    """``frames`` frames of ``sc`` from one state, each eagerly and through
    its programs (``render_frame_device``), in turns; ``edit(k)`` before
    frame k (once: the eager frame's ``_ensure_device_state`` takes it).
    The eager frame runs on copies of the state, so the programs keep
    their buffers as a frame loop keeps them.  RGB8, PCG state, denoiser
    history, progressive sum and count, ``prev_view_proj``, the frame
    count and the last frame's colour must be equal bit for bit.  Returns
    the frames that differed, the programs made and the kinds of those
    kept that are new."""
    from ptrt_tpu_torch import graphs

    before, made0 = set(sc._programs), sc._programs.made
    bad = []
    for k in range(frames):
        if edit is not None:
            edit(k)
        start = scene_state(sc)
        set_scene_state(sc, graphs.clone_tree(start))
        rgb_e = eager_frame(sc)
        e, e_color = scene_state(sc), sc.last_frame.color
        set_scene_state(sc, start)
        rgb_p = sc.render_frame_device()
        p = scene_state(sc)
        same = {"rgb8": same_tree(rgb_e, rgb_p), "rng": same_tree(e[0], p[0]),
                "denoiser": same_tree(e[1], p[1]),
                "progressive": same_tree(e[2:4], p[2:4]),
                "prev_view_proj": same_tree(e[4], p[4]),
                "frame_count": e[5] == p[5],
                "last_frame": same_tree(e_color, sc.last_frame.color)}
        if not all(same.values()):
            bad.append((k, [n for n, v in same.items() if not v]))
    return {"frames": frames, "frames_differing": bad,
            "programs_made": sc._programs.made - made0,
            "new_kinds": [k[0] for k in sc._programs if k not in before]}


def program_runs(sc) -> dict:
    """The frames each program of ``sc`` has run, by key."""
    return {k: p.runs for k, p in sc._programs.items()}


def program_stats(sc, runs0: dict) -> list:
    """Each program of ``sc`` that ran since ``program_runs`` gave
    ``runs0``: its kind, capture s, pool bytes, the kernels one replay
    launches and the frames it ran."""
    return [{"kind": k[0] if isinstance(k[0], str) else "rt frame",
             "capture_s": p.stats["capture_s"],
             "pool_bytes": p.stats["pool_bytes"],
             "launches": sum(p.launches.values()),
             "frames": p.runs - runs0.get(k, 0)}
            for k, p in sc._programs.items() if p.runs != runs0.get(k, 0)]


def replay_numbers(frame, eager, card, turn_frames: int, edit=None) -> dict:
    """A program frame's numbers: synchronizing calls of one frame with no
    edit (sync debug mode) and the profiler's host waits; one frame's
    device ms and kernels (profiler, behind a spin) and its kernel counts
    (``kernels.counts``); frames a second and host ms a frame,
    eager (``eager(i)``) against the programs (``frame(i)``), two turns of
    ``turn_frames`` each, ``edit(i)`` before each frame of both."""
    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.tools import stages

    syncs = sync_calls(lambda: frame(0))
    trace = trace_waits(lambda: frame(0))
    kernels.clear_counts()
    kern = stages.profiled_kernels(lambda: frame(0),
                                   lead_cycles=stages.SPIN_CYCLES)
    counts = dict(kernels.counts())
    step = (lambda fn: fn) if edit is None else (
        lambda fn: lambda i: (edit(i), fn(i))[1])
    turns = [{"eager": loop_times(step(eager), turn_frames),
              "replayed": loop_times(step(frame), turn_frames)}
             for _ in range(2)]
    return {"sync_calls": syncs, "trace": trace,
            "device_ms": sum(us for _, us in kern) / 1e3,
            "kernels": len(kern), "launches": counts, "turns": turns}


def log_program_run(name, r, card) -> None:
    t = r["turns"]
    lock = r["lockstep"]
    log(f"[programs] {name}: {lock['frames']} frames eager vs programs bit "
        f"for bit, differing {lock['frames_differing']}; programs made "
        f"{lock['programs_made']} {lock.get('new_kinds', '')} "
        f"({r['programs']}); frames/s eager "
        f"{[round(x['eager']['fps'], 2) for x in t]}, programs "
        f"{[round(x['replayed']['fps'], 2) for x in t]} (in turns); host ms "
        f"to issue a frame eager {[round(x['eager']['host_ms'], 3) for x in t]}"
        f", programs {[round(x['replayed']['host_ms'], 3) for x in t]}; one "
        f"frame {r['device_ms']:.3f} device ms in {r['kernels']} kernels, "
        f"{sum(r['launches'].values())} counted; {len(r['sync_calls'])} "
        f"synchronizing calls a frame, trace waits {r['trace']['waits']}, "
        f"device-to-host copies {r['trace']['dtoh_copies']} [{card}]")


def check_program_run(name, r) -> None:
    assert not r["lockstep"]["frames_differing"], (name, r["lockstep"])
    assert not r["sync_calls"], (name, r["sync_calls"])
    assert not r["trace"]["dtoh_copies"] and not r["trace"]["waits"], (
        name, r["trace"])
    assert r["kernels"] > 0 and r["launches"], (name, "no kernel seen")


def pt_program_run(name, sc, card, frames, edit=None, turn_edit=None,
                   turn_frames=PROGRAM_TURN) -> dict:
    """One phase-19 run of a PT scene: ``program_lockstep`` over
    ``frames`` frames with ``edit``, then ``replay_numbers`` (its turns
    with ``turn_edit``) and the stats of every program it used."""
    runs0 = program_runs(sc)
    lock = program_lockstep(sc, frames, edit)
    r = replay_numbers(lambda i: sc.render_frame_device(),
                       lambda i: eager_frame(sc), card, turn_frames,
                       turn_edit)
    r.update(lockstep=lock, programs=program_stats(sc, runs0))
    log_program_run(name, r, card)
    check_program_run(name, r)
    return r


def check_counted_walks(sc, card) -> dict:
    """K1 and K2 on a device count (the RT frame's glass pass) against the
    same walks on the host count, on the 1080p bench frame's camera,
    bounce-1 and shadow wavefronts (``t_max`` planes): counts naming every
    ray (scales 1 and 2) and 60% of them, the records equal bit for bit on
    every counted ray; each timed by CUDA events in turns (host, counted,
    counted, host) with the count naming every ray."""
    import torch
    from ptrt_tpu_torch.render import traverse
    from ptrt_tpu_torch.tools.walks import wavefronts

    geom, out = sc._geom, {}
    for name, o, d, t in wavefronts(sc):
        n = t.shape[0]
        if name == "shadow":
            walk = lambda **kw: (traverse.any_hit(geom, o, d, t, **kw),)
        else:
            walk = lambda **kw: tuple(traverse.closest_hit(geom, o, d, t,
                                                           **kw))
        host = walk()
        equal = {}
        for label, c, s in (("all", n, 1), ("all, scale 2", n // 2, 2),
                            ("60%", int(0.6 * n), 1)):
            cnt = torch.tensor([c], dtype=torch.int32, device=t.device)
            m = min(n, c * s)
            got = walk(count=cnt, count_scale=s)
            equal[label] = same_tree([a[:m] for a in got],
                                     [a[:m] for a in host])
        every = torch.tensor([n], dtype=torch.int32, device=t.device)
        ms = {"host": [], "counted": []}
        for which in ("host", "counted", "counted", "host"):
            kw = {} if which == "host" else {"count": every}
            ms[which].append(cuda_ms(lambda: walk(**kw), 10))
        kernel = "any_hit" if name == "shadow" else "closest_hit"
        out[f"{kernel} {name}"] = {"rays": n, "equal": equal, "ms": ms}
        log(f"[programs] {kernel} on the {name} wavefront ({n} rays, t_max "
            f"plane): device count equal to the host count {equal}; ms host "
            f"{[round(v, 4) for v in ms['host']]}, device count "
            f"{[round(v, 4) for v in ms['counted']]} (in turns) [{card}]")
        assert all(equal.values()), (name, equal)
    return out


def bench_program_run(sc, card) -> dict:
    """``bench.trace_only`` (the trace-only program) against
    ``pipeline.trace_frame`` eagerly from the same PCG state, in turns:
    FrameBuffers and PCG state bit for bit over PROGRAM_FRAMES frames;
    then ``replay_numbers``."""
    from ptrt_tpu_torch import bench
    from ptrt_tpu_torch.render import pipeline

    before, made0 = set(sc._programs), sc._programs.made
    runs0 = program_runs(sc)
    sc._ensure_device_state()

    def eager(i):
        state, bufs = pipeline.trace_frame(
            sc._geom, sc._mat_table, sc._light_table, len(sc.lights),
            sc.sky(), sc.camera, sc._rng_state.clone(), 7000 + i, W, H,
            SPP, DEPTH, sc._blue_noise)
        return state, bufs

    bad = []
    for i in range(PROGRAM_FRAMES):
        state, want = eager(i)
        got = bench.trace_only(sc, 7000 + i, SPP, DEPTH)
        if not (same_tree(got, want) and same_tree(sc._rng_state, state)):
            bad.append(i)
    lock = {"frames": PROGRAM_FRAMES, "frames_differing": bad,
            "programs_made": sc._programs.made - made0,
            "new_kinds": [k[0] for k in sc._programs if k not in before]}
    r = replay_numbers(lambda i: bench.trace_only(sc, 8000 + i, SPP, DEPTH),
                       eager, card, PROGRAM_TURN)
    r.update(lockstep=lock, programs=program_stats(sc, runs0))
    log_program_run("bench trace-only", r, card)
    check_program_run("bench trace-only", r)
    return r


def rt_program_run(dev, card) -> dict:
    """The 1080p "rt" scene: ``RTScene.render_frame_device`` (the program:
    the glass count on the card) against ``render_eager()`` (the glass
    count read to the host), in turns, the camera orbiting: RGB8 and the
    glass records (``last_frame``, cut to G) bit for bit over
    PROGRAM_FRAMES frames, the RGB8 SHA-256 of the first frame as phase
    11's; then ``replay_numbers``."""
    import hashlib

    from ptrt_tpu_torch.app.bench_scene import build_rt_bench_scene

    sc = build_rt_bench_scene(W, H, TRIS, device=dev)
    cam0 = sc.camera
    bad = []
    for k in range(PROGRAM_FRAMES):
        if k:
            orbit(sc, k)
        want = sc.render_eager()
        img = sc.render_frame_device()
        fr = sc.last_frame
        same = (same_tree(img, want.rgb8)
                and same_tree(fr.glass, want.glass)
                and same_tree(fr.sec_color, want.sec_color))
        if k == 0:
            sha = hashlib.sha256(img.cpu().numpy().tobytes()).hexdigest()
        if not same:
            bad.append(k)
    # the first camera put back renders as itself (the program copies it
    # in again)
    sc.camera = cam0
    put_back = same_tree(sc.render_frame_device(), sc.render_eager().rgb8)
    lock = {"frames": PROGRAM_FRAMES, "frames_differing": bad,
            "programs_made": sc._programs.made, "put_back_equal": put_back}
    r = replay_numbers(lambda i: sc.render_frame_device(),
                       lambda i: sc.render_eager().rgb8, card, PROGRAM_TURN)
    r.update(lockstep=lock, programs=program_stats(sc, {}),
             rgb8_sha256=sha)
    log_program_run("rt", r, card)
    check_program_run("rt", r)
    assert sha == RT_RGB8_SHA256, sha
    assert put_back, "the camera put back rendered another frame"
    return r


def bounded_programs_run(sc, card) -> dict:
    """A dynamic mesh added and removed PROGRAM_MESH_CYCLES times, a frame
    after each (each a new world: a program made, the old world's
    dropped): the programs kept after each cycle (one) and the card's
    reserved bytes (the allocator's cache emptied), which must grow by
    less than one program's pool from the first cycle to the last."""
    import gc

    import torch
    from ptrt_tpu_torch.scene.materials import Materials

    made0, kept, reserved, pools = sc._programs.made, [], [], []
    for i in range(PROGRAM_MESH_CYCLES):
        cube = sc.add_cube(Materials.Silver())
        cube.is_dynamic = True
        cube.transform.set_position(-1.5, 0.5, 5.0 + 0.1 * i)
        sc.render_frame_device()
        pools += [p.stats["pool_bytes"] for p in sc._programs.values()]
        sc.remove_mesh(cube)
        sc.render_frame_device()
        pools += [p.stats["pool_bytes"] for p in sc._programs.values()]
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        kept.append(len(sc._programs))
        reserved.append(torch.cuda.memory_reserved())
    r = {"cycles": PROGRAM_MESH_CYCLES,
         "programs_made": sc._programs.made - made0, "kept": kept,
         "reserved_bytes": reserved, "pool_bytes": pools,
         "growth_bytes": reserved[-1] - reserved[0]}
    log(f"[programs] bounded: a dynamic mesh added and removed "
        f"{PROGRAM_MESH_CYCLES} times, a frame after each: "
        f"{r['programs_made']} programs made, kept after each cycle {kept}, "
        f"reserved bytes {reserved} (growth {r['growth_bytes']}), pools "
        f"{pools} [{card}]")
    assert r["programs_made"] == 2 * PROGRAM_MESH_CYCLES, r
    assert kept == [1] * PROGRAM_MESH_CYCLES, r
    assert r["growth_bytes"] < min(pools), r
    return r


def check_programs(dev, card, full) -> dict:
    """Phase 19: the scenes' frame programs (``graphs.Program``).  K1 / K2
    on a device count against the host count; each run eager against its
    programs bit for bit (``program_lockstep``), with its synchronizing
    calls on a frame with no edit (none), frames a second eager and
    through the programs in turns, host ms to issue a frame, one frame's
    device ms and kernels, the programs' capture s and pool bytes: the
    bench trace-only frame, balanced (the camera orbiting), fast with the
    progressive average (the camera still, moved at PROGRAM_MOVE_AT), hdri
    balanced (an HDRI rotation at PROGRAM_EDIT_AT, its first camera put
    back at PROGRAM_PUT_BACK_AT), ultra (the chunk and post programs,
    PROGRAM_ULTRA_FRAMES frames), dynamic (``animate`` and its K5 refits
    each frame, a material and a light edit at PROGRAM_EDIT_AT, a mesh
    added at PROGRAM_MESH_AT: a new key, the old world's program dropped;
    its host ms split into the edits, the geometry update and the issue;
    then ``bounded_programs_run``), rt (its first camera put back); then
    ``bench.py``'s JSON line on ``full`` (phase 3's scene) and
    bench_presets at 640x360."""
    import torch
    from ptrt_tpu_torch import bench, kernels
    from ptrt_tpu_torch.app.bench_scene import (build_dynamic_scene,
                                                build_hdri_scene)
    from ptrt_tpu_torch.scene.materials import Materials
    from ptrt_tpu_torch.tools import bench_presets

    out = {}
    bench_perf(full, SPP, DEPTH)
    orbit(full, 0)
    out["counted_walks"] = check_counted_walks(full, card)
    out["bench trace-only"] = bench_program_run(full, card)

    balanced(full)
    out["balanced"] = pt_program_run(
        "balanced 1080p", full, card, PROGRAM_FRAMES,
        edit=lambda k: orbit(full, k), turn_edit=lambda i: orbit(full, i))
    # a camera move (set_camera: the host's numbers in one pinned copy)
    syncs = sync_calls(lambda: orbit(full, 7))
    trace = trace_waits(lambda: orbit(full, 8))
    out["camera_move"] = {"sync_calls": syncs, "trace": trace}
    log(f"[programs] a camera move (Scene.set_camera): {len(syncs)} "
        f"synchronizing calls {syncs}, trace waits {trace['waits']}, "
        f"device-to-host copies {trace['dtoh_copies']} [{card}]")
    assert not syncs and not trace["waits"] and not trace["dtoh_copies"], (
        "a camera move waits for the card", syncs, trace)
    full.set_performance_preset("fast")
    orbit(full, 0)
    out["fast progressive"] = pt_program_run(
        "fast 1080p, progressive", full, card, PROGRAM_FRAMES,
        edit=lambda k: k == PROGRAM_MOVE_AT and orbit(full, 3))
    bench_perf(full, SPP, DEPTH)
    torch.cuda.empty_cache()

    hdri = balanced(build_hdri_scene(W, H, target_tris=TRIS, device=dev))
    orbit(hdri, 0)

    cams = []

    def hdri_edit(k):
        orbit(hdri, k)
        cams.append(hdri.camera)
        if k == PROGRAM_EDIT_AT:
            hdri.set_environment_map(hdri.env_map, hdri.env_rotation + 0.5)
        if k == PROGRAM_PUT_BACK_AT:  # a camera held earlier, put back
            hdri.camera = cams[0]

    out["hdri balanced"] = pt_program_run(
        "hdri balanced 1080p", hdri, card, PROGRAM_FRAMES, edit=hdri_edit,
        turn_edit=lambda i: orbit(hdri, i))
    hdri.set_performance_preset("ultra")
    orbit(hdri, 0)
    out["ultra"] = pt_program_run("ultra 1080p (chunked)", hdri, card,
                                  PROGRAM_ULTRA_FRAMES, turn_frames=1)
    assert out["ultra"]["lockstep"]["programs_made"] == 2
    assert out["ultra"]["lockstep"]["new_kinds"] == ["chunk", "post"]
    del hdri
    torch.cuda.empty_cache()

    dyn = build_dynamic_scene(W, H, target_tris=TRIS, device=dev)
    orbit(dyn, 0)

    def dyn_edit(k):
        dyn.animate(k + 1)
        if k == PROGRAM_EDIT_AT:
            dyn.set_material(dyn.meshes[0], Materials.Gold())
            dyn.lights[0].intensity *= 1.5
            dyn.commit_light_changes()
        if k == PROGRAM_MESH_AT:
            cube = dyn.add_cube(Materials.Silver())
            cube.is_dynamic = True
            cube.transform.set_position(1.5, 0.5, 5.0)

    r = pt_program_run("dynamic 1080p", dyn, card, PROGRAM_FRAMES,
                       edit=dyn_edit,
                       turn_edit=lambda i: dyn.animate(100 + i))
    # the mesh added made a new key, and the old world's program went
    assert r["lockstep"]["programs_made"] == 2, r
    assert len(dyn._programs) == 1, list(dyn._programs)
    split = {"edit": 0.0, "geometry": 0.0, "issue": 0.0}
    torch.cuda.synchronize()
    for i in range(PROGRAM_TURN):
        t0 = time.perf_counter()
        dyn.animate(200 + i)
        t1 = time.perf_counter()
        dyn._ensure_device_state()
        t2 = time.perf_counter()
        dyn.render_frame_device()
        t3 = time.perf_counter()
        split["edit"] += t1 - t0
        split["geometry"] += t2 - t1
        split["issue"] += t3 - t2
    torch.cuda.synchronize()
    r["host_split_ms"] = {k: 1e3 * v / PROGRAM_TURN for k, v in split.items()}
    log(f"[programs] dynamic: host ms a frame split {r['host_split_ms']} "
        f"(animate, _ensure_device_state, render_frame_device) [{card}]")
    out["dynamic"] = r
    out["bounded"] = bounded_programs_run(dyn, card)
    del dyn
    torch.cuda.empty_cache()

    out["rt"] = rt_program_run(dev, card)
    torch.cuda.empty_cache()

    # the bench entry points: bench.py at its defaults on phase 3's scene
    # (its trace-only program already made above), bench_presets at 640x360
    kernels.clear_counts()
    t0 = time.perf_counter()
    line = bench.bench(dev, scene=full)
    print(json.dumps(line), flush=True)
    out["bench"] = {"s": time.perf_counter() - t0, "line": line,
                    "launches": dict(kernels.counts())}
    assert line["value"] > 0 and line["extra"]["phases"]["hbm_copy_gbps"] > 0
    t0 = time.perf_counter()
    sc = bench_presets.build_bench_scene(640, 360, target_tris=TRIS,
                                         device=dev)
    presets = []
    for p_ in bench_presets.PRESETS:
        line_ = bench_presets.run(sc, p_, 1 if p_.startswith("ultra")
                                  else PRESET_FRAMES)
        print(json.dumps(line_), flush=True)
        presets.append(line_)
    del sc
    out["bench_presets"] = {"s": time.perf_counter() - t0, "lines": presets}
    log(f"[programs] bench.py {out['bench']['s']:.1f} s "
        f"({line['value']} Mrays/s, {line['extra']['frame_ms']} ms a "
        f"frame); bench_presets at 640x360 {out['bench_presets']['s']:.1f} "
        f"s, ms a frame: "
        + ", ".join(f"{p_['preset']} {p_['frame_ms']}" for p_ in presets)
        + f" [{card}]")
    torch.cuda.empty_cache()
    return out


def check_mesh(sc, card) -> dict:
    """Phase 16: the balanced 1080p frame of ``sc`` (the bench scene) from
    one saved state, unmeshed and with its trace over pixel meshes of
    MESH_TILES tiles (one card: a stream a tile), each bit for bit the
    unmeshed frame (RGB8, the next PCG state, the rays), with its host ms,
    device ms and launches (no timing claim); then dryrun_multichip(8)."""
    import torch
    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.parallel import dryrun, sharding
    from ptrt_tpu_torch.tools import stages

    sc._ensure_device_state()
    saved = (sc._rng_state, sc._denoiser_state)
    index, prev_vp = sc.frame_count, sc.prev_view_proj

    def frame(mesh):
        sc._rng_state, sc._denoiser_state = saved
        return sc.render_world(sc._geom, sc.camera, index, prev_vp,
                               mesh=mesh)

    out = {}
    want = None
    for n in (None, *MESH_TILES):
        mesh = None if n is None else sharding.make_pixel_mesh(n)
        kernels.clear_counts()
        img = frame(mesh).cpu()
        launches = {k: v for k, v in kernels.counts().items() if v}
        got = (img, sc._rng_state.clone(), int(sc.last_frame.rays_traced))
        if want is None:
            want = got
        same = (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and got[2] == want[2])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame(mesh)
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
        kern = stages.profiled_kernels(lambda: frame(mesh),
                                       lead_cycles=stages.SPIN_CYCLES)
        label = "unmeshed" if n is None else f"{n} tiles"
        out[label] = {"mesh": None if mesh is None else list(mesh.shape),
                      "bit_for_bit": same, "host_ms": host_ms,
                      "device_ms": sum(us for _, us in kern) / 1e3,
                      "profiled_launches": len(kern), "launches": launches}
        log(f"[mesh] balanced {W}x{H} frame, {label}"
            + ("" if mesh is None else f" ({mesh.shape[0]}x{mesh.shape[1]}, "
               f"a stream a tile on {mesh.first_device})")
            + f": bit for bit the unmeshed frame {same}; {host_ms:.2f} ms on "
            f"the host clock, {out[label]['device_ms']:.3f} device ms in "
            f"{len(kern)} launches; launches {launches} [{card}]")
        assert same, label
        for k in ("closest_hit", "any_hit", "shade_nee", "shade_scatter",
                  "svgf_temporal", "svgf_atrous", "bloom_chain",
                  "tonemap_rgb8"):
            assert launches.get(k, 0) > 0, (label, k, launches)
    sc._rng_state, sc._denoiser_state = saved
    t0 = time.perf_counter()
    img = dryrun.dryrun_multichip(8)
    out["dryrun_multichip"] = {"s": time.perf_counter() - t0,
                               "shape": list(img.shape),
                               "mean": float(img.mean())}
    log(f"[mesh] dryrun_multichip(8) on the card: {out['dryrun_multichip']} "
        f"[{card}]")
    assert img.std() > 1.0
    return out


def check_golden(dev, card) -> dict:
    """Phase 17: the golden corpus's eight recipes (tools/golden.py)
    rendered on the card at 320x180, each held to its reference render in
    tests/golden/ at tests/test_golden.py's PSNR."""
    import numpy as np
    from ptrt_tpu_torch.tools import golden

    out = {}
    scenes = golden.golden_scenes(golden.GOLDEN_W, golden.GOLDEN_H, dev)
    for name in golden.CASES:
        t0 = time.perf_counter()
        img = np.asarray(scenes[name]())
        s_ = time.perf_counter() - t0
        ref = golden.load_golden(name)
        assert img.shape == ref.shape, (name, img.shape)
        db = golden.psnr(img, ref)
        out[name] = {"psnr_db": db, "s": s_, "mean": float(img.mean())}
        log(f"[golden] {name}: PSNR {db:.2f} dB against the reference's "
            f"render (bound {golden.MIN_PSNR}), {s_:.2f} s with set-up "
            f"[{card}]")
    bad = {k: v["psnr_db"] for k, v in out.items()
           if v["psnr_db"] < golden.MIN_PSNR}
    assert not bad, bad
    return out


# phase 20, the fidelity corpus: its size and frames on the card, and the
# small render held against the CPU's (the plain versions)
FID_W, FID_H, FID_FRAMES = 640, 360, 48
FID_SMALL_W, FID_SMALL_H, FID_SMALL_FRAMES = 96, 54, 3
# the kernels its balanced frames must launch (K4 for the games' instances)
FID_KERNELS = ("closest_hit", "any_hit", "shade_nee", "shade_scatter",
               "svgf_temporal", "svgf_atrous", "bloom_chain", "tonemap_rgb8",
               "instances_closest", "instances_any")


def check_fidelity(dev, card) -> dict:
    """Phase 20: the fidelity corpus (ptrt_tpu_torch/tools/fidelity.py).
    Its seven recipes rendered on the card through ``fidelity.render`` at
    FID_W x FID_H, FID_FRAMES balanced frames each, written to
    build/fidelity/ (mean, first frame ms, ms a frame), the launches of
    those renders counted from zero (each of FID_KERNELS at least once);
    then each recipe at FID_SMALL_W x FID_SMALL_H, FID_SMALL_FRAMES
    frames, on the card and on the CPU (the plain versions), at least
    golden.MIN_PSNR apart, with the largest LSB difference."""
    import numpy as np
    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.tools import fidelity, golden
    from ptrt_tpu_torch.utils.imageio import save_png

    out = {"scenes": {}, "small": {}}
    os.makedirs(fidelity.OUT_DIR, exist_ok=True)
    kernels.clear_counts()
    for name in fidelity.SCENES:
        st = {}
        img = fidelity.render(name, FID_W, FID_H, FID_FRAMES, dev, st)
        save_png(os.path.join(fidelity.OUT_DIR, f"{name}.png"), img)
        out["scenes"][name] = dict(st, mean=float(img.mean()),
                                   std=float(img.std()))
        log(f"[fidelity] {name} {FID_W}x{FID_H}: mean {img.mean():.4f}, "
            f"std {img.std():.4f}; first frame {st['first_ms']:.1f} ms, "
            f"{st['frame_ms']:.3f} ms a frame of the other "
            f"{FID_FRAMES - 1} [{card}]")
        assert img.shape == (FID_H, FID_W, 3) and img.std() > 2.0, name
    out["launches"] = dict(kernels.counts())
    log(f"[fidelity] launches of the seven renders "
        f"({7 * FID_FRAMES} frames): {out['launches']} [{card}]")
    for k in FID_KERNELS:
        assert out["launches"].get(k, 0) > 0, (k, "not launched")
    for name in fidelity.SCENES:
        t0 = time.perf_counter()
        gpu = fidelity.render(name, FID_SMALL_W, FID_SMALL_H,
                              FID_SMALL_FRAMES, dev)
        cpu = fidelity.render(name, FID_SMALL_W, FID_SMALL_H,
                              FID_SMALL_FRAMES, "cpu")
        diff = np.abs(gpu.astype(int) - cpu.astype(int))
        r = out["small"][name] = {
            "psnr_db": golden.psnr(gpu, cpu), "max_lsb": int(diff.max()),
            "within_1_lsb": float((diff.max(-1) <= 1).mean()),
            "s": time.perf_counter() - t0}
        log(f"[fidelity] {name} {FID_SMALL_W}x{FID_SMALL_H}, "
            f"{FID_SMALL_FRAMES} frames, GPU vs CPU: PSNR {r['psnr_db']:.2f}"
            f" dB (bound {golden.MIN_PSNR}), max {r['max_lsb']} LSB, within "
            f"1 LSB on {r['within_1_lsb']:.4f} of pixels, {r['s']:.1f} s "
            f"[{card}]")
    bad = {k: v["psnr_db"] for k, v in out["small"].items()
           if v["psnr_db"] < golden.MIN_PSNR}
    assert not bad, bad
    return out


def bounce_launches(names, samples, depth):
    """Kernel launches from each of a sample's K1 launches to its next (one
    bounce), in a profiled frame's timeline."""
    at = [i for i, n in enumerate(names) if "closest_hit_kernel" in n]
    assert len(at) == samples * depth, (len(at), samples, depth)
    return [at[j + 1] - at[j] for j in range(len(at) - 1)
            if j % depth != depth - 1]


def later_bounces(per_bounce, depth):
    """The launch counts of the bounces from bounce 1 on (bounce 0 of a
    sample launches one kernel more)."""
    return [k for j, k in enumerate(per_bounce) if j % (depth - 1) != 0]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a GPU")
    pkg = os.path.join(HERE, "ptrt_tpu_torch")
    if not os.path.isdir(pkg):
        raise SystemExit(f"chip_smoke: no ptrt_tpu_torch beside {HERE}; run "
                         "it from the root of a checkout")
    sys.path.insert(0, HERE)
    import ptrt_tpu_torch
    from ptrt_tpu_torch import graphs, kernels, native
    from ptrt_tpu_torch.app.bench_scene import (HDRI_HW, HDRI_ROTATION,
                                                build_bench_scene,
                                                build_hdri_scene)
    from ptrt_tpu_torch.build import BUILD_DIR
    from ptrt_tpu_torch.core.vec import Vec3
    from ptrt_tpu_torch.render import pipeline
    from ptrt_tpu_torch.tools.walks import wavefronts

    assert os.path.dirname(os.path.abspath(ptrt_tpu_torch.__file__)) == pkg
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. environment ------------------------------------------------------
    lap = Laps()
    lap("1")
    card = card_line()
    log(card)
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()
    log(f"[env] {nvcc[-1]}")

    # -- 2. build ------------------------------------------------------------
    lap("2")
    t0 = time.time()
    kernels.get_lib()
    t_nvcc = time.time() - t0
    t0 = time.time()
    native.get_lib()
    t_gxx = time.time() - t0
    log(f"[build] CUDA kernels {t_nvcc:.1f} s (nvcc), native BVH builder "
        f"{t_gxx:.1f} s (g++), into {os.path.relpath(BUILD_DIR, HERE)}")

    # what was compiled: registers, stack and static SASS instructions of
    # every kernel (the a-trous taps are unrolled, so its count is close to
    # what a surface pixel runs)
    from ptrt_tpu_torch.tools import stages
    resources = stages.kernel_resources(
        os.path.join(BUILD_DIR, kernels.LIBRARY),
        ("closest_hit", "any_hit", "walk_count", "tonemap_rgb8",
         "gather_rows", "svgf_temporal", "svgf_atrous", "bloom_chain",
         "shade_nee", "shade_scatter", "instances_closest", "instances_any",
         "refit_kernel", "morton_sort", "morton_codes", "rt_light_rays",
         "rt_shade_kernel", "rt_glass_rays", "rt_resolve",
         "inst_update_kernel", "inst_rows_kernel", "inst_codes_kernel",
         "inst_level_kernel"))
    for k, fns in resources.items():
        for fn, r in fns.items():
            log(f"[build] {k} ({fn[-40:]}): {r['registers']} registers, "
                f"stack {r['stack_bytes']} bytes, SASS {r['sass']}")
    sass = {k: {fn[-40:]: r["sass"].get("all") for fn, r in fns.items()}
            for k, fns in resources.items()}
    # no trap in the walk loops: each K1 and K2 kernel, on a host count and
    # on a device count, pairs every BSSY with a BSYNC (the warp reconverges)
    for k in ("closest_hit", "any_hit"):
        for fn, r in resources[k].items():
            assert r["sass"].get("bssy", 0) == r["sass"].get("bsync", 0) > 0, (
                fn, r["sass"])

    # -- 3. kernels against their plain versions -----------------------------
    lap("3")
    rng = np.random.default_rng(0)
    small = bench_perf(build_bench_scene(256, 144, target_tris=20_000,
                                         device=dev), SPP, DEPTH)
    small._ensure_device_state()
    log(f"[kernels] small scene: {sum(m.num_triangles for m in small.meshes)} "
        f"triangles, {small._geom.num_tri_slots} tri slots, "
        f"{small._geom.num_nodes} nodes, stack bound "
        f"{small._geom.stack_depth}")
    stats = {k: {"mismatches": 0, "max_abs_err": 0.0}
             for k in ("closest_hit", "any_hit")}
    for r in wavefronts(small):
        compare_walk(f"small {r[0]}", walk(small._geom, r),
                     walk_plain(small._geom, r), walk_stats(r, stats))

    t0 = time.time()
    full = bench_perf(build_bench_scene(W, H, target_tris=TRIS, device=dev),
                      SPP, DEPTH)
    full._ensure_device_state()
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    n_tris = sum(m.num_triangles for m in full.meshes)
    log(f"[kernels] full scene: {n_tris} triangles, "
        f"{full._geom.num_tri_slots} tri slots, {full._geom.num_nodes} "
        f"nodes, stack bound {full._geom.stack_depth}; set-up {setup_s:.2f} s")
    walks = check_full_walks(full, rng, card, stats)
    info = walk_info()
    # the kernel table's walk times and their bounds: K1 on the bounce-1
    # rays through the alive plane (as the bounce loop calls it), K2 on the
    # shadow rays
    k1_bound = walks["live_bound"]["bounce"]
    k2_bound = walks["bound"]["shadow"]
    log(f"  K1 bounce sample: kernel {walks['k1_sample_ms']:.4f} ms vs plain "
        f"{walks['k1_plain_ms']:.2f} ms on {SAMPLE_RAYS} rays; K2 shadow "
        f"sample: kernel {walks['k2_sample_ms']:.4f} ms vs plain "
        f"{walks['k2_plain_ms']:.2f} ms; at {W * H} rays K1 bounce 1 "
        f"through the alive plane {walks['live_ms']['bounce']:.4f} ms "
        f"(bound {k1_bound['bound_ms']:.4f} ms, {k1_bound['bound_by']}), K2 "
        f"shadow {walks['ms']['shadow']:.4f} ms (bound "
        f"{k2_bound['bound_ms']:.4f} ms, {k2_bound['bound_by']}) [{card}]")
    for k, v in info.items():
        log(f"  {k}: {v['registers']} registers, {v['local_bytes']} bytes of "
            f"local memory a thread, {v['blocks_per_sm']} resident blocks of "
            f"128 threads a SM ({v['warps_per_scheduler']} warps a scheduler)")

    hdr = Vec3(*[torch.from_numpy(rng.lognormal(-1.0, 1.5, (H, W)).astype(
        np.float32)).to(dev) for _ in range(3)])
    img_k = pipeline.tonemap_rgb8(hdr, 0.25)
    img_p = pipeline.tonemap_rgb8_plain(hdr, 0.25)
    k6_err = int((img_k.int() - img_p.int()).abs().max())
    k6_exact = float((img_k == img_p).all(-1).float().mean())
    # queued behind a spin of the card, two readings: its wrapper's host
    # time outlasts the kernel
    k6_queued = [stages.clones_ms(lambda _: pipeline.tonemap_rgb8(hdr, 0.25),
                                  [None] * 51, stages.SPIN_CYCLES)
                 for _ in range(2)]
    k6_ms = sum(k6_queued) / 2
    k6_plain_ms = cuda_ms(lambda: pipeline.tonemap_rgb8_plain(hdr, 0.25), 10)
    log(f"  K6 {H}x{W}: max |diff| {k6_err} LSB, exact on {k6_exact:.6f} of "
        f"pixels; kernel queued {k6_queued[0]:.4f} / {k6_queued[1]:.4f} ms "
        f"vs plain {k6_plain_ms:.4f} ms [{card}]")
    assert k6_err <= 1, f"K6 differs from its plain version by {k6_err} LSB"
    # its bound, and the issue time of the SASS a thread runs (4 pixels)
    k6_body = stages.tonemap_sass(resources["tonemap_rgb8"])[False]
    k6_bound = stages.tonemap_bound(H, W, False, k6_body)
    log(f"  K6 bound {k6_bound['bound_ms']:.4f} ms ({k6_bound['bound_by']});"
        f" its {k6_body} SASS instructions a thread issue in "
        f"{k6_bound['sass_issue_ms']:.4f} ms [{card}]")
    k6_info = pipeline.tonemap_info()
    log("  K6 (128 threads a block): " + "; ".join(
        f"{k} {v['registers']} registers, {v['blocks_per_sm']} resident "
        f"blocks a SM" for k, v in k6_info.items()))
    gather = check_row_gather(dev, full._mat_table, card, rng)

    # -- 3b. K3: the shading stages against their plain versions -------------
    lap("3b")
    del hdr
    torch.cuda.empty_cache()
    shade_stats = check_shade(full, dev, card)
    torch.cuda.empty_cache()

    # -- 3c. K3's HDRI instantiations on the "hdri" scene ---------------------
    lap("3c")
    t0 = time.time()
    hdri = balanced(build_hdri_scene(W, H, target_tris=TRIS, device=dev))
    hdri._ensure_device_state()
    hdri_sky = hdri.sky()
    torch.cuda.synchronize()
    hdri_setup_s = time.time() - t0
    log(f"[hdri] {W}x{H} bench scene + a directional and an area light + a "
        f"{HDRI_HW[1]}x{HDRI_HW[0]} float32 map at rotation "
        f"{HDRI_ROTATION} (importance map {hdri_sky.env_sample_hw[1]}x"
        f"{hdri_sky.env_sample_hw[0]}): set-up {hdri_setup_s:.2f} s, "
        f"{len(hdri.lights)} lights")
    hstats, htimes = check_hdri(hdri, dev, card, rng)
    torch.cuda.empty_cache()
    # shade_scatter's issue time at each bounce if every warp its live lanes
    # occupy ran the kernel's whole static SASS (every lobe: more than a
    # warp runs, so an upper estimate), over the card's rate: a warp for
    # every warp of lanes that holds one (one thread a lane) or packed in
    # each block's list
    sass_live = max(r["sass"]["all"]
                    for r in resources["shade_scatter"].values())
    warps = shade_stats["shade_scatter"]
    floor = lambda w: f"{w * sass_live / stages.WARP_ISSUE_PER_S * 1e3:.4f}"
    log(f"  shade_scatter issue time at {sass_live} instructions a warp, a "
        f"thread a lane vs packed: " + "; ".join(
            f"{b} {floor(w)} vs {floor(warps['bounce_packed_warps'][b])} ms"
            for b, w in warps["bounce_live_warps"].items()
            if b.startswith("bench")) + f" [{card}]")

    # -- 4. the bench path at full size --------------------------------------
    lap("4")
    torch.cuda.reset_peak_memory_stats()
    kernels.clear_counts()
    t0 = time.time()
    img = full.render_frame()
    torch.cuda.synchronize()
    first_s = time.time() - t0
    frame_s, rays = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        img = full.render_frame()
        torch.cuda.synchronize()
        frame_s.append(time.time() - t0)
        rays.append(int(full.last_frame.rays_traced))
    launches = dict(kernels.counts())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    frame_ms = 1e3 * sum(frame_s) / len(frame_s)
    mrays = sum(rays) / sum(frame_s) / 1e6
    log(f"[main] {W}x{H} {SPP} spp depth {DEPTH}, {n_tris} triangles: "
        f"frame {frame_ms:.1f} ms (frames {[round(1e3 * s, 1) for s in frame_s]}"
        f" ms, first {1e3 * first_s:.1f} ms), {mrays:.1f} Mrays/s, "
        f"{rays[-1]} rays/frame, set-up {setup_s:.2f} s, peak memory "
        f"{peak_gb:.2f} GB [{card}]")
    log(f"[main] launches over the 4 frames: {launches}")
    hdr = full.last_frame.color
    assert img.shape == (H, W, 3) and img.dtype == np.uint8, img.shape
    assert img.std() > 1.0, "the image is constant"
    assert all(bool(torch.isfinite(c).all()) for c in (hdr.x, hdr.y, hdr.z))
    assert launches.get("tonemap_rgb8", 0) > 0, "tonemap_rgb8 not launched"
    for k in ("closest_hit", "any_hit", "shade_nee", "shade_scatter"):
        # once a bounce of each sample
        assert launches.get(k, 0) == 4 * SPP * DEPTH, (k, launches)
    assert launches.get("row_gather", 0) == 0, "the main path gathers planes"
    for k in STATIC_NEVER:  # a scene without dynamic meshes
        assert launches.get(k, 0) == 0, (k, launches)
    prof = stages.frame_profile(full)
    log(f"[main] one profiled frame: device kernel time {prof['device_ms']} "
        f"ms in {prof['launches']} kernel launches (busy share "
        f"{None if prof['device_ms'] is None else round(prof['device_ms'] / frame_ms, 3)}"
        f" of the unprofiled frame), the walks {prof['walk_ms']} ms; top "
        f"kernels (ms) {prof['top']} [{card}]")
    assert prof["names"] is not None, "the profiler saw no device kernels"
    per_bounce = bounce_launches(prof["names"], SPP, DEPTH)
    k1_at = [i for i, nm in enumerate(prof["names"])
             if "closest_hit_kernel" in nm]
    log(f"[main] launches a bounce (K1 to the next K1 of a sample): "
        f"{per_bounce}; the second bounce's: "
        f"{[nm[:48] for nm in prof['names'][k1_at[1]:k1_at[2]]]}")
    assert all(k == BOUNCE_LAUNCHES
               for k in later_bounces(per_bounce, DEPTH)), per_bounce
    for r in rays:
        assert abs(r - BENCH_RAYS_PER_FRAME) <= 0.1 * BENCH_RAYS_PER_FRAME, r
    # the progressive average copies nothing to the host: a still camera's
    # second frame (sum and count selected on the card) under the sync
    # debug mode, which raises on any synchronising call
    assert full.perf.progressive_accumulation and not full.perf.enable_denoiser
    count = full._accum[1].clone()
    torch.cuda.set_sync_debug_mode("error")
    try:
        full._accumulate(full.last_frame.color, H, W)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(full._accum[1]) == float(count) + 1, (count, full._accum[1])
    log(f"[main] the progressive average of frame {int(count) + 1} ran under "
        f"torch.cuda.set_sync_debug_mode(\"error\"): no host copy")

    # -- 13. the tiled trace, on the bench scene in its bench settings -------
    lap("13")
    tiled = check_tiles(full, card)
    torch.cuda.empty_cache()

    # -- 5. the balanced path at full size -----------------------------------
    lap("5")
    from ptrt_tpu_torch.render import denoiser as den
    from ptrt_tpu_torch.render.bloom import bloom_mips
    from ptrt_tpu_torch.render.motion import motion_vectors

    bal = balanced(full)
    orbit(bal, 0)
    t0 = time.time()
    bal.render_frame()
    torch.cuda.synchronize()
    bal_first_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.clear_counts()
    bal_s, bal_rays = [], []
    for k in range(1, BAL_FRAMES + 1):
        orbit(bal, k)
        torch.cuda.synchronize()
        t0 = time.time()
        img = bal.render_frame()
        torch.cuda.synchronize()
        bal_s.append(time.time() - t0)
        bal_rays.append(int(bal.last_frame.rays_traced))
    bal_launches = dict(kernels.counts())
    bal_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bal_ms = 1e3 * sum(bal_s) / len(bal_s)
    bufs, state = bal.last_frame, bal._denoiser_state
    mv = motion_vectors(bufs.depth, bal.camera, bal.prev_view_proj, W, H)
    mip0 = bloom_mips(bufs.color)
    post_ms = {
        "motion_vectors": cuda_ms(lambda: motion_vectors(
            bufs.depth, bal.camera, bal.prev_view_proj, W, H), 10),
        "svgf": cuda_ms(lambda: den.denoise_frame(bufs, mv, state), 5),
        "bloom": cuda_ms(lambda: bloom_mips(bufs.color), 10),
        "tonemap": cuda_ms(lambda: pipeline.tonemap_rgb8(
            bufs.color, 1.0, bloom=mip0), 20)}
    log(f"[balanced] {W}x{H} 1 spp depth {BAL_DEPTH}, denoiser + bloom + "
        f"motion vectors, {ORBIT_DEG} deg orbit per frame: frame "
        f"{bal_ms:.1f} ms (frames {[round(1e3 * s, 1) for s in bal_s]} ms, "
        f"first {1e3 * bal_first_s:.1f} ms), {bal_rays[-1]} rays/frame, "
        f"{sum(bal_rays) / sum(bal_s) / 1e6:.1f} Mrays/s, peak memory "
        f"{bal_peak_gb:.2f} GB [{card}]")
    log(f"[balanced] post stages one by one (CUDA events): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in post_ms.items())
        + f"; trace = frame - post ~ {bal_ms - sum(post_ms.values()):.1f} ms"
        f" [{card}]")
    log(f"[balanced] launches over the {BAL_FRAMES} timed frames: "
        f"{bal_launches}")
    # the bloom is one launch a frame (at most two allowed) and K6 one, with
    # the composite: no plain-torch bloom op between them
    per_frame = {"closest_hit": BAL_DEPTH, "any_hit": BAL_DEPTH,
                 "shade_nee": BAL_DEPTH, "shade_scatter": BAL_DEPTH,
                 "svgf_temporal": 1, "svgf_atrous": 7, "tonemap_rgb8": 1,
                 "bloom_chain": 1, **dict.fromkeys(STATIC_NEVER, 0)}
    for k, n in per_frame.items():
        assert bal_launches.get(k, 0) == n * BAL_FRAMES, (k, bal_launches)
    assert bal_launches.get("row_gather", 0) == 0, bal_launches
    bloom_launches = sum(v for k, v in bal_launches.items()
                         if k.startswith("bloom"))
    assert bloom_launches <= 2 * BAL_FRAMES, bal_launches
    assert img.shape == (H, W, 3) and img.dtype == np.uint8, img.shape
    assert img.std() > 1.0, "the balanced image is constant"
    for v in (bufs.color, bufs.diffuse, bufs.specular, bufs.emission,
              state.diffuse.mean, state.specular.mean):
        assert all(bool(torch.isfinite(c).all()) for c in (v.x, v.y, v.z))
    surface = bufs.depth < den.SKY_DEPTH_THRESHOLD
    kept = float((state.diffuse.length[surface] > 1).float().mean())
    kept_s = float((state.specular.length[surface] > 1).float().mean())
    log(f"[balanced] history length > 1 after the last move: diffuse on "
        f"{kept:.4f}, specular on {kept_s:.4f} of {int(surface.sum())} "
        f"surface pixels")
    assert kept > 0.5, f"SVGF history kept on only {kept:.4f} of pixels"
    orbit(bal, BAL_FRAMES + 1)
    bal_prof = stages.frame_profile(bal)
    # the profiled frame's bloom is the chain's one launch, right before K6
    # (what comes between the last a-trous pass and the chain is the
    # denoiser's remodulation)
    names = bal_prof["names"]
    assert names is not None, "the profiler saw no device kernels"
    last_atrous = max(i for i, nm in enumerate(names) if "atrous" in nm)
    k6_at = max(i for i, nm in enumerate(names) if "tonemap_rgb8" in nm)
    after = [nm[:40] for nm in names[last_atrous + 1:k6_at + 1]]
    log(f"[balanced] launches from the last a-trous pass to K6: {after}")
    assert "bloom_chain" in names[k6_at - 1], after
    assert sum("bloom" in nm for nm in names) == 1, after
    log(f"[balanced] one profiled frame: {bal_prof['launches']} kernel "
        f"launches, against 2,057 with the bloom of the design before (six "
        f"bloom_blur_down launches and ~440 plain-torch bloom ops)")
    log(f"[balanced] one profiled frame: device kernel time "
        f"{bal_prof['device_ms']} ms in {bal_prof['launches']} kernel "
        f"launches (busy share "
        f"{None if bal_prof['device_ms'] is None else round(bal_prof['device_ms'] / bal_ms, 3)}"
        f" of the unprofiled frame); top kernels (ms) {bal_prof['top']} "
        f"[{card}]")

    # -- 6. the post kernels against their plain versions, 1080p buffers -----
    lap("6")
    # copies: the next frame advances the frame program's buffers in place
    state0 = graphs.clone_tree(bal._denoiser_state)
    prev_vp = bal.prev_view_proj.clone()
    orbit(bal, BAL_FRAMES + 2)
    bal.render_frame()
    post = check_post_kernels(bal, state0, prev_vp, card)
    del bufs, state, state0, mv
    torch.cuda.empty_cache()

    # -- 7. the hdri scene's balanced path -----------------------------------
    lap("7")
    orbit(hdri, 0)
    hdri.render_frame()
    torch.cuda.synchronize()
    kernels.clear_counts()
    hdri_s, hdri_rays = [], []
    for k in range(1, BAL_FRAMES + 1):
        orbit(hdri, k)
        torch.cuda.synchronize()
        t0 = time.time()
        img = hdri.render_frame()
        torch.cuda.synchronize()
        hdri_s.append(time.time() - t0)
        hdri_rays.append(int(hdri.last_frame.rays_traced))
    hdri_launches = dict(kernels.counts())
    hdri_ms = 1e3 * sum(hdri_s) / len(hdri_s)
    log(f"[hdri] {W}x{H} balanced, 1 spp depth {BAL_DEPTH}, env NEE, "
        f"{ORBIT_DEG} deg orbit per frame: frame {hdri_ms:.1f} ms (frames "
        f"{[round(1e3 * s, 1) for s in hdri_s]} ms), {hdri_rays[-1]} "
        f"rays/frame, {sum(hdri_rays) / sum(hdri_s) / 1e6:.1f} Mrays/s "
        f"[{card}]")
    log(f"[hdri] launches over the {BAL_FRAMES} timed frames: "
        f"{hdri_launches}")
    # a bounce: K1, K2 on the env and on the light shadow rays, the HDRI
    # instantiations of both K3 stages and never the others
    per_frame = {"closest_hit": BAL_DEPTH, "any_hit": 2 * BAL_DEPTH,
                 "shade_nee (hdri)": BAL_DEPTH,
                 "shade_scatter (hdri)": BAL_DEPTH, "svgf_temporal": 1,
                 "svgf_atrous": 7, "tonemap_rgb8": 1, "bloom_chain": 1,
                 "shade_nee": 0, "shade_scatter": 0,
                 **dict.fromkeys(STATIC_NEVER, 0)}
    for k, n in per_frame.items():
        assert hdri_launches.get(k, 0) == n * BAL_FRAMES, (k, hdri_launches)
    assert img.shape == (H, W, 3) and img.std() > 1.0, "hdri image"
    for v in (hdri.last_frame.color, hdri.last_frame.diffuse,
              hdri.last_frame.specular):
        assert all(bool(torch.isfinite(c).all()) for c in (v.x, v.y, v.z))
    orbit(hdri, BAL_FRAMES + 1)
    hdri_prof = stages.frame_profile(hdri)
    assert hdri_prof["names"] is not None, "the profiler saw no kernels"
    log(f"[hdri] one profiled balanced frame: device kernel time "
        f"{hdri_prof['device_ms']:.3f} ms in {hdri_prof['launches']} kernel "
        f"launches (busy share {hdri_prof['device_ms'] / hdri_ms:.3f} of "
        f"the unprofiled frame), the walks {hdri_prof['walk_ms']:.3f} ms; "
        f"top kernels (ms) {hdri_prof['top']} [{card}]")

    # -- 8. the ultra preset on the hdri scene --------------------------------
    lap("8")
    ultra = hdri
    ultra.set_performance_preset("ultra")
    up = ultra.perf
    assert (up.samples_per_pixel, up.max_bounce_depth,
            up.russian_roulette_start_bounce) == (128, 32, 8)
    assert up.enable_bloom and not up.enable_denoiser
    # the first frame makes the chunk and post programs (an eager warm-up of
    # each and its capture); the profiled and the timed frames replay them
    t0 = time.time()
    ultra.render_frame()
    torch.cuda.synchronize()
    ultra_first_s = time.time() - t0
    ultra_prof = stages.frame_profile(ultra)
    assert ultra_prof["names"] is not None, "the profiler saw no kernels"
    kernels.clear_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    img = ultra.render_frame()
    torch.cuda.synchronize()
    ultra_s = time.time() - t0
    ultra_launches = dict(kernels.counts())
    ultra_rays = int(ultra.last_frame.rays_traced)
    log(f"[ultra] {W}x{H} 128 spp depth 32, roulette from bounce 8, bloom, "
        f"the hdri scene: frame {1e3 * ultra_s:.0f} ms, {ultra_rays} rays "
        f"({ultra_rays / ultra_s / 1e6:.1f} Mrays/s), the first (its "
        f"programs made) {1e3 * ultra_first_s:.0f} ms; a profiled "
        f"frame: device {ultra_prof['device_ms']:.1f} ms in "
        f"{ultra_prof['launches']} kernel launches (busy share "
        f"{ultra_prof['device_ms'] / (1e3 * ultra_s):.3f}), the walks "
        f"{ultra_prof['walk_ms']:.1f} ms; top kernels (ms) "
        f"{ultra_prof['top']} [{card}]")
    log(f"[ultra] launches of the timed frame: {ultra_launches}")
    for k, n in (("closest_hit", 128 * 32), ("any_hit", 2 * 128 * 32),
                 ("shade_nee (hdri)", 128 * 32),
                 ("shade_scatter (hdri)", 128 * 32), ("bloom_chain", 1),
                 ("tonemap_rgb8", 1)):
        assert ultra_launches.get(k, 0) == n, (k, ultra_launches)
    hdr = ultra.last_frame.color
    assert all(bool(torch.isfinite(c).all()) for c in (hdr.x, hdr.y, hdr.z))
    assert img.shape == (H, W, 3) and img.std() > 1.0, "ultra image"
    del hdr
    torch.cuda.empty_cache()

    # -- 9. end to end on small inputs: GPU kernels vs CPU plain -------------
    lap("9")
    cpu_sc = bench_perf(build_bench_scene(64, 48, target_tris=2000,
                                          device="cpu"), 2, 3)
    gpu_sc = bench_perf(build_bench_scene(64, 48, target_tris=2000,
                                          device=dev), 2, 3)
    img_c, img_g = cpu_sc.render_frame(), gpu_sc.render_frame()
    fc, fg = cpu_sc.last_frame, gpu_sc.last_frame
    oid_agree = float((fc.object_id == fg.object_id.cpu()).float().mean())
    e_c = np.array([float(c.sum()) for c in (fc.color.x, fc.color.y,
                                              fc.color.z)])
    e_g = np.array([float(c.sum()) for c in (fg.color.x, fg.color.y,
                                              fg.color.z)])
    e_rel = float(np.abs(e_g / e_c - 1.0).max())
    lsb = float((np.abs(img_c.astype(int) - img_g.astype(int)).max(-1) <= 1)
                .mean())
    log(f"[e2e] 64x48 GPU vs CPU: object id agree {oid_agree:.5f}, energy "
        f"rel diff {e_rel:.2e}, image within 1 LSB on {lsb:.4f} of pixels, "
        f"rays {int(fg.rays_traced)} vs {int(fc.rays_traced)}")
    assert oid_agree >= 0.999 and e_rel <= 0.02 and lsb >= 0.97

    small_bal = {}
    for name, d in (("cpu", torch.device("cpu")), ("gpu", dev)):
        sc = balanced(build_bench_scene(64, 48, target_tris=2000, device=d))
        for k in range(3):
            orbit(sc, k)
            img_b = sc.render_frame()
        small_bal[name] = (sc, img_b)
    (sc_c, img_c), (sc_g, img_g) = small_bal["cpu"], small_bal["gpu"]
    fc, fg = sc_c.last_frame, sc_g.last_frame
    oid_agree = float((fc.object_id == fg.object_id.cpu()).float().mean())
    # a bilinearly fetched length is not an integer: compare to rtol 1e-5
    hist_agree = float(torch.isclose(
        sc_g._denoiser_state.diffuse.length.cpu(),
        sc_c._denoiser_state.diffuse.length, rtol=1e-5, atol=0.0)
        .float().mean())
    lum = lambda s: float(s._denoiser_state.diffuse.mean.luminance().sum())
    e_rel = abs(lum(sc_g) / lum(sc_c) - 1.0)
    diff = np.abs(img_c.astype(int) - img_g.astype(int)).max(-1)
    lsb2 = float((diff <= 2).mean())
    log(f"[e2e] 64x48 balanced, 3 frames, GPU vs CPU: object id agree "
        f"{oid_agree:.5f}, diffuse history length agree {hist_agree:.5f}, "
        f"diffuse history energy rel diff {e_rel:.2e}, image within 2 LSB "
        f"on {lsb2:.4f} of pixels (mean |diff| {diff.mean():.3f} LSB)")
    assert oid_agree >= 0.999 and hist_agree >= 0.99
    assert e_rel <= 0.02 and lsb2 >= 0.95

    small_hdri = {}
    for name, d in (("cpu", torch.device("cpu")), ("gpu", dev)):
        sc = bench_perf(build_hdri_scene(64, 48, target_tris=2000, device=d,
                                         env_hw=(256, 512)), 2, 3)
        small_hdri[name] = (sc, sc.render_frame())
    (sc_c, img_c), (sc_g, img_g) = small_hdri["cpu"], small_hdri["gpu"]
    fc, fg = sc_c.last_frame, sc_g.last_frame
    oid_agree = float((fc.object_id == fg.object_id.cpu()).float().mean())
    e_c = np.array([float(c.sum()) for c in (fc.color.x, fc.color.y,
                                              fc.color.z)])
    e_g = np.array([float(c.sum()) for c in (fg.color.x, fg.color.y,
                                              fg.color.z)])
    e_rel = float(np.abs(e_g / e_c - 1.0).max())
    lsb = float((np.abs(img_c.astype(int) - img_g.astype(int)).max(-1) <= 1)
                .mean())
    log(f"[e2e] 64x48 hdri scene (a 512x256 map, env NEE, 6 lights of four "
        f"types), GPU vs CPU: object id agree {oid_agree:.5f}, energy rel "
        f"diff {e_rel:.2e}, image within 1 LSB on {lsb:.4f} of pixels, rays "
        f"{int(fg.rays_traced)} vs {int(fc.rays_traced)}")
    assert oid_agree >= 0.999 and e_rel <= 0.02 and lsb >= 0.97

    # -- 10. dynamic geometry: K4, K5 and the "dynamic" frame ----------------
    lap("10")
    from ptrt_tpu_torch.app.bench_scene import build_dynamic_scene

    del ultra, hdri
    torch.cuda.empty_cache()
    t0 = time.time()
    dyn = build_dynamic_scene(W, H, target_tris=TRIS, device=dev)
    dyn._ensure_device_state()
    torch.cuda.synchronize()
    dyn_setup_s = time.time() - t0
    iset = dyn._geom.iset
    dyn_meshes = [i for i, m in enumerate(dyn.meshes) if m.is_dynamic]
    log(f"[dynamic] {W}x{H} bench scene + {iset.count} dynamic meshes "
        f"(192 building slots, a {dyn.meshes[-2].num_triangles}-triangle "
        f"heightfield refilled, a {dyn.meshes[-1].num_triangles}-triangle "
        f"Morton-refilled sphere): the set {iset.geom.num_nodes} nodes, "
        f"{iset.geom.num_tri_slots} slots, stack bound "
        f"{iset.geom.stack_depth}; set-up {dyn_setup_s:.2f} s")
    kstats = check_instances(dyn, rng, card)
    from ptrt_tpu_torch.render import traverse as trav

    k4_sets = check_instance_sets(dev, card)
    many = check_many_instances(dev, card)
    from ptrt_tpu_torch.geometry.tlas import build_tlas

    bmin, bmax = iset.bb_min.cpu().numpy(), iset.bb_max.cpu().numpy()
    t0 = time.perf_counter()
    for _ in range(200):
        build_tlas(bmin, bmax)
    tlas_host_ms = 1e3 * (time.perf_counter() - t0) / 200
    log(f"  the instance tree: {iset.tlas.shape[0]} nodes "
        f"{iset.tlas.shape[1]} wide over {iset.count} instances, built on "
        f"the host in {tlas_host_ms:.4f} ms (mean of 200 builds)")
    k4_info = trav.instances_info(iset)
    # no trap in the walk loops: each K4 kernel's SASS pairs its BSSY with
    # BSYNC, the warp reconverging as K1's does (phase 2's listing)
    for k in ("instances_closest", "instances_any"):
        for fn, r in resources[k].items():
            assert r["sass"].get("bssy", 0) == r["sass"].get("bsync", 0) > 0, (
                fn, r["sass"])
    for k, v in k4_info.items():
        log(f"  {k}: {v['registers']} registers, {v['local_bytes']} bytes "
            f"of local memory a thread, {v['blocks_per_sm']} resident blocks "
            f"of 128 threads a SM with {iset.count} instances and their tree "
            f"{'staged' if v['staged'] else 'read from global memory'}")
        assert v["staged"] and v["blocks_per_sm"] == (
            7 if k == "instances_closest" else 8), (k, v)
    plans = dyn._iset_cache["plans"]
    kres, jobs = {}, []
    from ptrt_tpu_torch.geometry import lbvh

    for label, pos, mesh, morton in (
            ("heightfield", len(plans) - 2, dyn.meshes[-2], False),
            ("sphere", len(plans) - 1, dyn.meshes[-1], True)):
        tris = dyn.animate.pool_triangles(40) if not morton else \
            dyn.animate.blob_triangles(40)
        kres[label] = check_refit(label, iset.geom, plans[pos],
                                  [tris[:, j] for j in range(3)], morton,
                                  card)
        v = torch.from_numpy(np.ascontiguousarray(np.stack(
            [tris[:, j] for j in range(3)]))).to(dev)
        jobs.append((label, plans[pos], (v[0], v[1], v[2]),
                     (plans[pos].device_arrays(dev)["rank"],
                      lbvh.morton_order(v[0], v[1], v[2])) if morton
                     else None))
    check_refit_streams(iset.geom, jobs, card)
    del jobs
    floor = stages.launch_floor()
    log(f"  an empty kernel's launch, queued: {floor[0]:.4f} / "
        f"{floor[1]:.4f} ms (the floor under the small kernels' times) "
        f"[{card}]")
    # odd sizes: a 37x29-cell heightfield refit; the Morton refill's shapes
    # (stages.refill_meshes: 1,001, 8,192, 130,050 and 1,045,506 triangles,
    # both sides of morton_sort's most), each standalone, and a soup of 1,001
    # triangles that are 143 repeated seven times (every code tied)
    from ptrt_tpu_torch.app.bench_scene import heightfield_to_triangles
    from ptrt_tpu_torch.geometry.mesh import Mesh
    from ptrt_tpu_torch.geometry.refit import build_refit_plan
    from ptrt_tpu_torch.geometry.scene_geom import assemble_geometry

    odd_rng = np.random.default_rng(5)
    hf = odd_rng.normal(size=(30, 30)).astype(np.float32) * 0.1
    odd_tris = heightfield_to_triangles(hf)[:1621]
    shapes = [("odd heightfield", odd_tris,
               odd_tris * np.float32(1.1) + np.float32(0.05), False)]
    for label, tris0, tris1 in stages.refill_meshes():
        shapes.append((f"morton {label}", tris0, tris1, True))
    tied = shapes[1][2][:143][odd_rng.permutation(np.arange(1001) % 143)]
    shapes.append(("morton tied soup", tied + np.float32(0.3),
                   tied * np.float32(0.9), True))
    for label, tris0, tris1, morton in shapes:
        og = assemble_geometry([Mesh.from_triangles(tris0)], None, dev,
                               world=False)
        kres[label] = check_refit(label, og, build_refit_plan(og),
                                  [tris1[:, j] for j in range(3)], morton,
                                  card)
        del og
    assert kres["morton tied soup"]["morton_codes"]["distinct"] <= 143
    torch.cuda.empty_cache()

    # the dynamic frame: balanced, the camera orbiting, every frame's edits
    orbit(dyn, 0)
    dyn.animate(1)
    dyn.render_frame()
    torch.cuda.synchronize()
    before = (dyn.stats_world_builds, dyn.stats_blas_builds,
              dyn.stats_tlas_updates, dyn.stats_device_refits,
              dyn.stats_device_lbvh_builds)
    kernels.clear_counts()
    dyn_s, edit_s, dyn_rays = [], [], []
    for k in range(2, 2 + DYN_FRAMES):
        orbit(dyn, k)
        torch.cuda.synchronize()
        t0 = time.time()
        dyn.animate(k)
        t1 = time.time()
        img = dyn.render_frame()
        torch.cuda.synchronize()
        dyn_s.append(time.time() - t0)
        edit_s.append(t1 - t0)
        dyn_rays.append(int(dyn.last_frame.rays_traced))
    dyn_launches = dict(kernels.counts())
    after = (dyn.stats_world_builds, dyn.stats_blas_builds,
             dyn.stats_tlas_updates, dyn.stats_device_refits,
             dyn.stats_device_lbvh_builds)
    dyn_ms = 1e3 * sum(dyn_s) / len(dyn_s)
    ids = dyn.last_frame.object_id
    dyn_share = float(torch.isin(ids, torch.tensor(
        dyn_meshes, device=dev)).float().mean())
    log(f"[dynamic] {W}x{H} balanced, {ORBIT_DEG} deg orbit and the scene's "
        f"edits a frame: frame {dyn_ms:.1f} ms (frames "
        f"{[round(1e3 * s, 1) for s in dyn_s]} ms; of them the host edits "
        f"{[round(1e3 * s, 1) for s in edit_s]} ms), {dyn_rays[-1]} "
        f"rays/frame, {sum(dyn_rays) / sum(dyn_s) / 1e6:.1f} Mrays/s; "
        f"camera rays on a dynamic mesh {dyn_share:.4f} [{card}]")
    log(f"[dynamic] counters (world builds, instance builds, transform "
        f"updates, device refits, device LBVH builds) {before} -> {after} "
        f"over {DYN_FRAMES} frames; launches {dyn_launches}")
    delta = tuple(a - b for a, b in zip(after, before))
    assert delta == (0, 0, 192 * DYN_FRAMES, 2 * DYN_FRAMES, DYN_FRAMES), (
        delta)
    per_frame = {"closest_hit": BAL_DEPTH, "instances_closest": BAL_DEPTH,
                 "any_hit": BAL_DEPTH, "instances_any": BAL_DEPTH,
                 "shade_nee": BAL_DEPTH, "shade_scatter": BAL_DEPTH,
                 "refit": 2, "morton_sort": 1, "morton_codes": 0,
                 "bloom_chain": 1,
                 "tonemap_rgb8": 1}
    for k, n in per_frame.items():
        assert dyn_launches.get(k, 0) == n * DYN_FRAMES, (k, dyn_launches)
    assert dyn_share >= 0.10, dyn_share
    assert img.shape == (H, W, 3) and img.std() > 1.0, "dynamic image"
    for v in (dyn.last_frame.color, dyn.last_frame.diffuse):
        assert all(bool(torch.isfinite(c).all()) for c in (v.x, v.y, v.z))
    orbit(dyn, 2 + DYN_FRAMES)
    dyn.animate(2 + DYN_FRAMES)
    dyn_prof = stages.frame_profile(dyn)
    assert dyn_prof["names"] is not None, "the profiler saw no kernels"
    k4_launches = sum("instances_" in nm for nm in dyn_prof["names"])
    log(f"[dynamic] one profiled frame: device kernel time "
        f"{dyn_prof['device_ms']:.3f} ms in {dyn_prof['launches']} kernel "
        f"launches ({k4_launches} K4), busy share "
        f"{dyn_prof['device_ms'] / dyn_ms:.3f} of the unprofiled frame, the "
        f"walks K1/K2 {dyn_prof['walk_ms']:.3f} ms; top kernels (ms) "
        f"{dyn_prof['top']} [{card}]")
    del dyn, iset
    torch.cuda.empty_cache()

    small_dyn = {}
    for name, d in (("cpu", torch.device("cpu")), ("gpu", dev)):
        sc = bench_perf(build_dynamic_scene(64, 48, target_tris=2000,
                                            device=d), 2, 3)
        sc.animate(1)
        small_dyn[name] = (sc, sc.render_frame())
    (sc_c, img_c), (sc_g, img_g) = small_dyn["cpu"], small_dyn["gpu"]
    fc, fg = sc_c.last_frame, sc_g.last_frame
    oid_agree = float((fc.object_id == fg.object_id.cpu()).float().mean())
    lsb = float((np.abs(img_c.astype(int) - img_g.astype(int)).max(-1) <= 1)
                .mean())
    dyn_ids = torch.isin(fc.object_id, torch.tensor(
        [i for i, m in enumerate(sc_c.meshes) if m.is_dynamic]))
    log(f"[e2e] 64x48 dynamic scene (2 spp, depth 3; the frame-1 edits), GPU "
        f"vs CPU: object id agree {oid_agree:.5f} ({float(dyn_ids.float().mean()):.3f}"
        f" of the pixels on a dynamic mesh), image within 1 LSB on "
        f"{lsb:.4f} of pixels, rays {int(fg.rays_traced)} vs "
        f"{int(fc.rays_traced)}")
    assert oid_agree >= 0.999 and lsb >= 0.99, (oid_agree, lsb)
    del small_dyn, sc_c, sc_g, fc, fg
    torch.cuda.empty_cache()

    # -- 11. the one-bounce RT backend: K10 on the "rt" scene ---------------
    lap("11")
    rt = check_rt(dev, card, resources)
    torch.cuda.empty_cache()

    # -- 12. the rest of the PT Scene API on the card ------------------------
    lap("12")
    api = check_scene_api(dev, card)
    torch.cuda.empty_cache()

    # rt_resolve's encode table on every float32 colour
    sweep = check_resolve_encode(dev, card)

    # -- 14. the unified scene layer and the demo at 1080p -------------------
    lap("14")
    app = check_app(dev, card)

    # -- 15. the games: K11 and the fused step-and-render runner -------------
    lap("15")
    games = check_games(dev, card, resources)
    k11 = games["k11"]["sizes"][192]
    torch.cuda.empty_cache()

    # -- 16. the pixel mesh: the balanced frame's trace over tiles ----------
    lap("16")
    mesh = check_mesh(bal, card)

    # -- 17. the golden corpus on the card -----------------------------------
    lap("17")
    gold = check_golden(dev, card)

    # -- 18. the one-program fused frame: CUDA graphs, bench_games ----------
    lap("18")
    graphs_out = check_graphs(dev, card)
    torch.cuda.empty_cache()

    # -- 19. the scenes' frame programs, the bench entry points -------------
    lap("19")
    programs = check_programs(dev, card, full)
    torch.cuda.empty_cache()

    # -- 20. the fidelity corpus on the card, and against the CPU -----------
    lap("20")
    fid = check_fidelity(dev, card)

    for k in ("shade_nee", "shade_scatter"):
        hs = hstats[k]
        hs.update(htimes[True][k][1])  # the table's line: split, bounce 1
        for key in ("kernel_ms", "queued_ms", "bound_ms", "plain_ms",
                    "alive"):
            hs[f"bounce_{key}"] = {
                f"{'split' if split else 'unsplit'} {b}": t[key]
                for split in (False, True)
                for b, t in htimes[split][k].items()}
    hstats["env_any_hit"]["bounce_ms"] = {
        f"{'split' if split else 'unsplit'} {b}": t["ms"]
        for split in (False, True)
        for b, t in htimes[split]["env_any_hit"].items()}
    src = lambda f: os.path.join("ptrt_tpu_torch", "csrc", f)
    both = lambda k: {"launches": launches.get(k, 0) + bal_launches.get(k, 0),
                      "launches_bench": launches.get(k, 0),
                      "launches_balanced": bal_launches.get(k, 0),
                      "frames_bench": 4, "frames_balanced": BAL_FRAMES}
    table = {"kernels": [
        {"name": "closest_hit", "route": "cuda", "source": src("traverse.cu"),
         "replaces": "ptrt_tpu/render/traverse.py:1267",
         **both("closest_hit"), **stats["closest_hit"],
         "ms": walks["live_ms"]["bounce"], "rays": W * H,
         "live_rays": walks["live"]["bounce"], **k1_bound,
         "plain_ms": walks["k1_plain_ms"], "sample_ms": walks["k1_sample_ms"],
         "plain_rays": SAMPLE_RAYS, "library_ms": None,
         "device_count": {k: v for k, v in programs["counted_walks"].items()
                          if k.startswith("closest_hit")},
         "device_count_info": info["closest_hit device count"],
         "wavefront_ms": walks["live_ms"],
         "wavefront_bound_ms": {k: v["bound_ms"]
                                for k, v in walks["live_bound"].items()},
         "t_max_plane_ms": {k: v for k, v in walks["ms"].items()
                            if k != "shadow"},
         "t_max_plane_bound_ms": {k: v["bound_ms"]
                                  for k, v in walks["bound"].items()
                                  if k != "shadow"},
         "per_ray": {k: v for k, v in walks["counts"].items()
                     if k != "shadow"},
         **info["closest_hit"],
         "t_max_plane_kernel": info["closest_hit t_max plane"]},
        {"name": "any_hit", "route": "cuda", "source": src("traverse.cu"),
         "replaces": "ptrt_tpu/render/traverse.py:1601",
         **both("any_hit"), **stats["any_hit"],
         "ms": walks["ms"]["shadow"], "rays": W * H,
         "live_rays": walks["live"]["shadow"], **k2_bound,
         "plain_ms": walks["k2_plain_ms"], "sample_ms": walks["k2_sample_ms"],
         "plain_rays": SAMPLE_RAYS, "library_ms": None,
         "per_ray": walks["counts"]["shadow"]["any"], **info["any_hit"],
         "env_shadow_rays": hstats["env_any_hit"],
         "launches_hdri_balanced": hdri_launches.get("any_hit", 0),
         "launches_ultra": ultra_launches.get("any_hit", 0),
         "device_count": {k: v for k, v in programs["counted_walks"].items()
                          if k.startswith("any_hit")},
         "device_count_info": info["any_hit device count"]},
        {"name": "tonemap_rgb8", "route": "cuda", "source": src("tonemap.cu"),
         "replaces": "ptrt_tpu/render/pipeline.py:181",
         **both("tonemap_rgb8"), "max_abs_err": k6_err,
         "exact_share": k6_exact, "ms": k6_ms, "plain_ms": k6_plain_ms,
         **k6_bound, "sass_instructions_a_thread": k6_body,
         "occupancy": k6_info,
         "library_ms": None, "pixels": W * H, "redesigned": True},
        {"name": "row_gather", "route": "cuda", "source": src("gather.cu"),
         "replaces": "tools/probe_pallas_gather_r5.py:42",
         "also_replaces": ["tools/probe_pallas_gather2_r5.py:38,133,158",
                           "tools/prof_pallas_gather.py:79,107,138,166"],
         **both("row_gather"), "max_abs_err": 0.0,
         "ms": gather["ms"], "plain_ms": gather["plain_ms"],
         "bound_ms": gather["bound_ms"], "bound_by": gather["bound_by"],
         "library_ms": gather["library_ms"],
         "shape": "material table, 2,073,600 ids, field-major",
         "probes": [{k: r[k] for k in ("probe", "ms", "plain_ms",
                                       "library_ms", "bound_ms")}
                    for r in gather["probes"]]},
        {"name": "svgf_temporal", "route": "cuda", "source": src("svgf.cu"),
         "replaces": "ptrt_tpu/render/denoiser.py:276",
         **both("svgf_temporal"), **post["svgf_temporal"],
         "library_ms": None, "pixels": W * H,
         "sass_instructions": sass["svgf_temporal"], "redesigned": True,
         "earlier": "PERF.md keeps the times of the design before"},
        {"name": "svgf_atrous", "route": "cuda", "source": src("svgf.cu"),
         "replaces": "ptrt_tpu/render/denoiser.py:425",
         **both("svgf_atrous"), **post["svgf_atrous"], "library_ms": None,
         "pixels": W * H, "sass_instructions": sass["svgf_atrous"],
         "redesigned": True,
         "earlier": "PERF.md keeps the times of the design before"},
        {"name": "bloom_chain", "route": "cuda", "source": src("bloom.cu"),
         "replaces": "ptrt_tpu/render/bloom.py:92",
         **both("bloom_chain"), **post["bloom_chain"],
         "library_ms": None, "pixels": W * H, "redesigned": True,
         "earlier": "PERF.md keeps the times of bloom_blur_down, the "
                    "design before"},
        {"name": "tonemap_rgb8 with the bloom", "route": "cuda",
         "source": src("tonemap.cu"),
         "replaces": "ptrt_tpu/render/pipeline.py:181, "
                     "ptrt_tpu/render/bloom.py:118",
         **both("tonemap_rgb8"), **post["tonemap_rgb8"],
         "library_ms": None, "pixels": W * H, "redesigned": True},
        *[{"name": k, "route": "cuda", "source": src("shade.cu"),
           "replaces": "ptrt_tpu/render/integrator.py:285",
           **both(k), **shade_stats[k], "library_ms": None, "lanes": W * H,
           "sass_instructions": sass[k],
           "redesigned": True,
           "earlier": "PERF.md keeps the times of the design before"}
          for k in ("shade_nee", "shade_scatter")],
        *[{"name": f"{k} (hdri)", "route": "cuda",
           "source": src("shade.cu"),
           "replaces": ("ptrt_tpu/render/integrator.py:326"
                        if k == "shade_nee" else
                        "ptrt_tpu/render/integrator.py:375"),
           "also_replaces": (["ptrt_tpu/render/sky.py:171,215,232",
                              "ptrt_tpu/render/nee.py:164"]
                             if k == "shade_nee" else
                             ["ptrt_tpu/render/integrator.py:431"]),
           "launches": hdri_launches.get(f"{k} (hdri)", 0)
           + ultra_launches.get(f"{k} (hdri)", 0),
           "launches_hdri_balanced": hdri_launches.get(f"{k} (hdri)", 0),
           "frames_hdri_balanced": BAL_FRAMES,
           "launches_ultra": ultra_launches.get(f"{k} (hdri)", 0),
           "frames_ultra": 1, **hstats[k], "library_ms": None,
           "lanes": W * H, "sass_instructions": sass[k]}
          for k in ("shade_nee", "shade_scatter")],
        *[{"name": k, "route": "cuda", "source": src("traverse.cu"),
           "replaces": ("ptrt_tpu/render/traverse.py:986" if k ==
                        "instances_closest" else
                        "ptrt_tpu/render/traverse.py:1041"),
           "also_replaces": (["ptrt_tpu/render/traverse.py:897,958-979,833"]
                             if k == "instances_closest" else
                             ["ptrt_tpu/render/traverse.py:897,958-970"]),
           "launches": dyn_launches.get(k, 0),
           "frames_dynamic": DYN_FRAMES,
           "max_abs_err": kstats[k]["max_abs_err"],
           "ms": sum(kstats[k]["wavefront_queued_ms"][w]) / 2,
           "bound_ms": kstats[k]["wavefront_bound_ms"][w],
           "bound_by": kstats[k]["bound_by"],
           "plain_ms": kstats[k]["plain_sample_ms"][w],
           "plain_rays": SAMPLE_RAYS, "wavefront": w, "library_ms": None,
           "rays": W * H, **{key: v for key, v in kstats[k].items()
                             if key.startswith(("wavefront", "baked",
                                                "box"))},
           "instance_sets": {lbl: {
               "mismatches": r["mismatches"], "box_tests": r["box_tests"],
               "tlas_host_ms": r["tlas_host_ms"],
               **({"staged": r["info"][k]["staged"],
                   "rays": stages.SET_RAYS,
                   "queued_ms": r["closest_ms" if k == "instances_closest"
                                 else "any_ms"],
                   "bound_ms": r["bound_ms"]["closest"
                                             if k == "instances_closest"
                                             else "any"]}
                  if "info" in r else {})}
               for lbl, r in k4_sets.items()},
           "many_instances_scene": many,
           "tlas_host_ms": tlas_host_ms, **k4_info[k]}
          for k, w in (("instances_closest", "bounce"),
                       ("instances_any", "shadow"))],
        *[{"name": k, "route": "cuda", "source": src("refit.cu"),
           "replaces": {"refit": "ptrt_tpu/geometry/refit.py:110",
                        "morton_sort": "ptrt_tpu/geometry/lbvh.py:59",
                        "morton_codes": "ptrt_tpu/geometry/lbvh.py:41"}[k],
           # morton_codes: the 513-instance Scene's refill (a mesh past
           # morton_sort's most); the others: the dynamic frames
           "launches": (many["launches"].get(k, 0) if k == "morton_codes"
                        else dyn_launches.get(k, 0)),
           "launched_by": ("the 513-instance Scene's frame"
                           if k == "morton_codes" else
                           f"{DYN_FRAMES} dynamic frames"),
           "max_abs_err": 0.0,
           "ms": sum(kres[m][k]["queued_ms"]) / 2,
           "bound_ms": kres[m][k]["bound_ms"],
           "bound_by": kres[m][k]["bound_by"],
           "plain_ms": kres[m][k]["plain_ms"], "library_ms": None,
           "mesh": m, "tris": kres[m][k]["tris"],
           "launch_floor_ms": floor,
           "sizes": {lbl: {key: r[k][key] for key in (
               "tris", "slots", "nodes", "levels", "queued_ms", "plain_ms",
               "bound_ms", "torch_sort_ms", "distinct") if key in r[k]}
               for lbl, r in kres.items() if k in r}}
          for k, m in (("refit", "heightfield"), ("morton_sort", "sphere"),
                       ("morton_codes", "morton heightfield 256x256"))],
        *[{"name": k, "route": "cuda", "source": src("rt_shade.cu"),
           "replaces": RT_REPLACES[k], **rt["entries"][k],
           "library_ms": None, "lanes": W * H}
          for k in ("rt_light_rays", "rt_shade", "rt_glass_rays")],
        # the RT frame's numbers and the Scene API phase's ride on the
        # frame's last kernel
        {"name": "rt_resolve", "route": "cuda", "source": src("rt_shade.cu"),
         "replaces": RT_REPLACES["rt_resolve"], **rt["entries"]["rt_resolve"],
         "library_ms": None, "lanes": W * H,
         "rt_frame": {key: rt[key] for key in (
             "frame_ms", "host_ms", "device_ms", "rgb8_sha256", "split",
             "glass_lanes", "profiled_launches",
             "launches", "frame_within_1_lsb", "frame_causes",
             "small_within_1_lsb", "stages")},
         "scene_api": api, "encode_sweep": sweep},
        # the tiled trace's and the app phase's numbers ride on the last
        {"name": "rt_resolve_glass", "route": "cuda",
         "source": src("rt_shade.cu"),
         "replaces": RT_REPLACES["rt_resolve_glass"],
         **rt["entries"]["rt_resolve_glass"], "library_ms": None,
         "launch_floor_ms": floor,
         "tiled_trace": tiled, "unified_and_demo": app},
        # K11 at tycoon's 192 instances; every size, the grid path and the
        # game runs ride on it
        {"name": "instances_update", "route": "cuda",
         "source": src("instances.cu"),
         "replaces": "ptrt_tpu/geometry/dtransform.py:41",
         "also_replaces": ["ptrt_tpu/geometry/dtransform.py:64",
                           "ptrt_tpu/games/fused.py:112-130",
                           "ptrt_tpu_torch/geometry/tlas.py:90 (build_tlas "
                           "on the host)"],
         "launches": games["main_path_launches"].get("instances_update", 0),
         "launched_by": "the phase's fused game runs",
         "max_abs_err": max(r["max_abs_err"]
                            for r in games["k11"]["sizes"].values()),
         "ms": k11["ms"], "plain_ms": k11["plain_ms"],
         "plain_launches": k11["plain_launches"],
         "bound_ms": k11["bound_ms"], "bound_by": k11["bound_by"],
         "library_ms": None, "instances": 192,
         "sizes": games["k11"]["sizes"],
         "resources": games["k11"].get("resources"),
         "game_runs": games["runs"],
         "instance_walks": games["instance_walks"],
         "headless": games["headless"],
         "small_gpu_vs_cpu_within_1_lsb":
             games["small_gpu_vs_cpu_within_1_lsb"],
         # phases 16-19 ride on the last kernel too
         "pixel_mesh": mesh, "golden": gold, "graphs": graphs_out,
         "programs": programs, "fidelity": fid},
    ]}
    # the later slices' paths, each counted from zero: render_wireframe
    # (phase 12) and the fidelity corpus (phase 20)
    for e in table["kernels"]:
        k = "tonemap_rgb8" if e["name"].startswith("tonemap_rgb8") \
            else e["name"]
        e["launches_wireframe"] = api["wireframe_launches"].get(k, 0)
        e["launches_fidelity"] = fid["launches"].get(k, 0)
    # the ranking: device ms a frame that each kernel stands over its bound,
    # summed over the passes and bounces the frames really run (a bench
    # frame: SPP samples of DEPTH unsplit bounces; a balanced frame: one
    # split sample and the seven a-trous passes)
    over = {"svgf_atrous": {"balanced": post["svgf_atrous"]["frame_ms"]
                            - post["svgf_atrous"]["frame_bound_ms"]}}
    for k in ("shade_nee", "shade_scatter"):
        gap = lambda name: sum(
            (shade_stats[k]["bounce_kernel_ms"][f"{name} {b}"]
             or shade_stats[k]["bounce_queued_ms"][f"{name} {b}"])
            - shade_stats[k]["bounce_bound_ms"][f"{name} {b}"]
            for b in range(DEPTH))
        over[k] = {"bench": SPP * gap("bench"), "balanced": gap("split")}
    for k in ("shade_nee", "shade_scatter"):
        over[f"{k} (hdri)"] = {"hdri balanced": sum(
            (htimes[True][k][b]["kernel_ms"] or htimes[True][k][b]["queued_ms"])
            - htimes[True][k][b]["bound_ms"] for b in range(DEPTH))}
    # the small kernels on their queued times, each of two readings: the
    # temporal stage's one launch, the bloom chain's, K6 with the bloom (a
    # balanced frame) and without (a bench frame)
    readings = {k: [post[k]["queued_ms"][j] - post[k]["bound_ms"]
                    for j in range(2)]
                for k in ("svgf_temporal", "bloom_chain", "tonemap_rgb8")}
    for k, v in readings.items():
        over[k] = {"balanced": sum(v) / 2}
    over["tonemap_rgb8"]["bench"] = sum(
        t - k6_bound["bound_ms"] for t in k6_queued) / 2
    # the dynamic frame's K4 at the wavefronts measured (bounces 0 and 1 of
    # the closest walk, bounce 0's shadow rays), its refits and codes
    gap = lambda k, w: (sum(kstats[k]["wavefront_queued_ms"][w]) / 2
                        - kstats[k]["wavefront_bound_ms"][w])
    over["instances_closest"] = {"dynamic (bounces 0-1)":
                                 gap("instances_closest", "camera")
                                 + gap("instances_closest", "bounce")}
    over["instances_any"] = {"dynamic (bounce 0)":
                             gap("instances_any", "shadow")}
    over["refit"] = {"dynamic": sum(
        sum(kres[m]["refit"]["queued_ms"]) / 2 - kres[m]["refit"]["bound_ms"]
        for m in ("heightfield", "sphere"))}
    over["morton_sort"] = {"dynamic": sum(
        kres["sphere"]["morton_sort"]["queued_ms"]) / 2
        - kres["sphere"]["morton_sort"]["bound_ms"]}
    # the RT frame: each K10 kernel on the primary pass, and rt_light_rays
    # and rt_shade once more on the glass rays
    for k, e in rt["entries"].items():
        if e["ms"] is None:  # the profiler missed a launch: not measured
            continue
        gap = e["ms"] - e["bound_ms"]
        if "glass_rays_queued_ms" in e:
            gap += (sum(e["glass_rays_queued_ms"]) / 2
                    - e["glass_rays_bound_ms"])
        over[k] = {"rt": gap}
    log("[rank] device ms a frame over the bound (launches x (time - "
        "bound), each pass, bounce, channel pair and mip at its own time; "
        "the small kernels queued, the two readings in brackets): "
        + "; ".join(f"{k} " + ", ".join(f"{f} {v:.3f}" for f, v in d.items())
                    + (f" ({readings[k][0]:.3f}, {readings[k][1]:.3f})"
                       if k in readings else "")
                    for k, d in sorted(over.items(),
                                       key=lambda kv: -max(kv[1].values())))
        + f" [{card}]")
    lap(None)
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
