"""The post kernels and the K3 shading stages, timed pass by pass, channel
by channel and bounce by bounce on the card, for this tree or another one.

``chip_smoke.py`` uses the helpers here (``atrous_taps``, ``shade_bytes``,
``walk_bound``, ``live_warps``, ``temporal_inputs``, ``time_temporal``, ``time_atrous``,
``time_bloom``, ``bloom_bound``, ``tonemap_bound``, ``clones_ms``,
``kernel_ms``, ``kernel_resources``, ``frame_profile``, ``instance_world``,
``set_rays``, ``time_instance_set``).
Run as a script on a GPU, this file measures one tree's kernels:

    python3 ptrt_tpu_torch/tools/stages.py [--tree DIR] [--out DIR]
                                           [--bloom | --dynamic | --refill]
                                           [--sets N,N,...] [--rt] [--hdri]
                                           [--frames] [--glue]

``--tree DIR`` measures the checkout in ``DIR`` (a variant of this tree or
a later commit unpacked with ``git archive``, say) in a process of its own
that imports that tree's package, with this file's bounds; it needs the
wrappers this tree offers (``bloom_mips`` and K6's bloom composite among
them), so a tree before them is measured by its own copy of this file.
``--out DIR`` also appends the log to ``DIR/stages.log``.  ``--bloom``
measures only the bloom and K6 (and the kernels' resources).
``--dynamic`` measures only K4 on the 1080p "dynamic" configuration's
three wavefronts (queued times beside the bound, the boxes a live ray
tests, a digest of the records, so that two trees' records compare bit for
bit) and one profiled and three timed frames of the dynamic, balanced,
bench and hdri balanced configurations (``measure_dynamic``).
``--refill`` measures only the Morton refill of a dynamic mesh at 1,001,
8,192, 130,050 and 1,045,506 triangles: its launches and device time, the
codes kernel, the one-launch sort where the tree has it, the library's
sort, K5's refit alone, an empty kernel's
launch, and digests of the order and the tables (``measure_refill``);
``--refill --dynamic`` runs both in one process.  ``--sets 320,512``
measures only K4 on hand-made sets of those instance counts
(``measure_sets``: 1M rays, queued times beside the bound, the kernel the
set takes, a digest of the records).  ``--hdri`` measures only the K3
kernels' registers, stack and SASS digests and the HDRI stages and frame
(``measure_hdri_only``), so that a variant of the HDRI kernels is compared
with this tree in turns.  ``--frames`` measures only one replay of the
1080p balanced, bench, fast, performance, hdri balanced and ultra frame
programs and of the fused cube slider's frame at 640x360 "fast"
(``measure_frames``: device ms, kernels, the counted launches, host ms a
frame, a SHA-256 of the last frame's image and its ray count; each
profiled behind a spin of the card), so that two trees' frames compare on
one card.  ``--glue`` measures only the shade_scatter instantiations'
registers and blocks a SM, both K3 stages at bounces 0-3 of the bench
(unsplit and split) and hdri wavefronts (``time_shading``: shade_scatter
with the ray count where the tree's takes it), and K12 at the four
shapes the main path gives it (``measure_upscale``: queued twice beside
its bound and ``interpolate``, a SHA-256 of its output).  ``--rt``
measures
only the RT frame on the 1080p
"rt" configuration (``measure_rt``: a digest of its RGB8, the
frame profiled and split by pass and kernel, host and frame ms, K10's
``rt_shade`` and ``rt_glass_rays`` timed, ``rt_shade``'s registers and
ptxas report); ``--tree DIR --rt`` in turns with this tree compares two
trees' images and glass passes on one card.

On the 1920x1080 bench scene (~1M triangles) it prints:

* each kernel's registers, stack and shared bytes (``cuobjdump
  --dump-resource-usage``), its static SASS instruction count by class
  (``cuobjdump -sass``; the à-trous tap loop is unrolled, so its count is
  close to the instructions a surface pixel runs);
* ``shade_nee`` and ``shade_scatter`` on the wavefront of each bounce 0-3
  of sample 0, unsplit (the bench path) and split (the balanced path): a
  wrapper call (CUDA events), the calls queued behind a spin of the card
  (CUDA events around launches back to back: device time), and the kernel
  alone (torch.profiler), with the bytes that wavefront must move and the
  warps that hold a live lane; then the same for their HDRI instantiations
  on the "hdri" configuration (``app/bench_scene.build_hdri_scene``: the
  bench scene under a 4096x2048 map with env NEE), with K2 on each bounce's
  env shadow rays beside its own bound;
* ``svgf_temporal`` on each channel of a balanced frame and on both in one
  launch (where the tree has it), queued twice and alone, each beside its
  own bound;
* ``svgf_atrous`` at each of the seven passes a balanced frame runs (diffuse
  settings at steps 1, 2, 4, 8, 16, specular at 1, 2, each fed the pass
  before it), held to the plain version, with each pass's own bound;
* the bloom and K6 of a balanced frame: ``bloom_chain`` (one launch) and
  K6 with and without the bloom composite, queued behind a spin twice,
  alone (profiler), the host's time of a call, each beside its bound (K6
  also beside the issue time of the SASS instructions a thread runs);
* one profiled balanced and one profiled bench frame (device ms, kernel
  launches) and three timed frames of each.

The card's name and power limit lead the output; the last line is JSON.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import re
import subprocess
import sys

# the card's peaks for a kernel's bound (NVIDIA's H100 SXM data sheet, at
# its 700 W limit): device memory, and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
W, H, TRIS, DEPTH = 1920, 1080, 1_000_000, 4
ATROUS_PASSES = (("diffuse", (1, 2, 4, 8, 16)), ("specular", (1, 2)))
# svgf.cu a-trous, a pixel: the centre's luminance and edge-stopping scale
# 14 and the normalisation 7, and per tap inside the image 21: the kernel
# weight 1, the luminance difference 7, its exp weight 3, the tap weight 1,
# the colour sum 6, the variance sum 2, the weight sum 1 (the edge tests
# short-circuit)
ATROUS_OPS_PIXEL, ATROUS_OPS_TAP = 21, 21
# bloom.cu, float operations: the bright pass an input pixel (max 2, the
# knee 3, the clamp 2, 3 products), a mip's output pixel 3 channels x (5
# rows x (the 5-tap horizontal blur 7 + the row weight 1) + 4 row sums), and
# an output pixel of the upsample-add 3 x (the bilinear 9 + the add 1)
BLOOM_BRIGHT_OPS_PIXEL = 10
BLUR_DOWN_OPS_PIXEL = 3 * (5 * 8 + 4)
UPSAMPLE_ADD_OPS_PIXEL = 3 * 10
# tonemap.cu, a pixel: scale 3; ACES input matrix 3 x 5; the fitted curve 3
# x 10 (7 adds and multiplies, a divide, a clamp of 2); output matrix and
# clamp 3 x 7; the encode table's bucket compare 3
TONEMAP_OPS_PIXEL = 3 + 15 + 30 + 21 + 3
TONEMAP_PIXELS = 4  # K6's pixels a thread (csrc/tonemap.cu)
# svgf.cu temporal, a pixel and channel: the 3x3 window 9 x 16 (the weighted
# sums of colour 6 and its square 9, the count 1; the edge tests
# short-circuit); the window's mean, variance and clamp box 36; the
# reprojection 7; the bilinear set-up 22 and weights' sum, fallback test,
# nearest pixel and reciprocal 12 (the history fetch branches); the
# variance-adaptive alpha 23; the new length 2; the blend 22; the sky test 1
TEMPORAL_OPS_PIXEL = 144 + 36 + 7 + 34 + 23 + 2 + 22 + 1
SHADE_NEE_OPS_LANE = 22  # the hit record's normal, facing test and point
SPIN_CYCLES = 20_000_000  # ~11 ms: the host enqueues ten calls meanwhile
SET_RAYS = 1 << 20  # rays K4 is timed on at a hand-made instance set
# warp instructions the card issues a second: 132 SMs x 4 schedulers at the
# H100 SXM's 1.755 GHz boost clock (the issue floor of a kernel's warps)
WARP_ISSUE_PER_S = 132 * 4 * 1.755e9
# svgf_temporal's planes at a pixel (f32 or int32), each read or written
# once: the geometry the channels share (depth, normal, id, motion, and the
# previous frame's depth, normal and id), and a channel's own (colour,
# history mean, second moment and length read; mean, second moment and
# length written; its history cap, where it has one)
TEMPORAL_SHARED_PLANES = 1 + 3 + 1 + 2 + 1 + 3 + 1
TEMPORAL_CHANNEL_PLANES = 3 + 3 + 3 + 1 + 7


def atrous_taps(h: int, w: int, step: int) -> int:
    """Taps an a-trous pass of ``step`` reads inside an (h, w) image: per
    axis, the pixels whose tap at each of the offsets -2..2 lies inside."""
    axis = lambda n: sum(max(0, n - abs(o) * step) for o in range(-2, 3))
    return axis(h) * axis(w)


def bound(nbytes: float, ops: float = 0.0) -> dict:
    """The least time the card could take: bytes moved (each input read
    once, each output written once) over the memory rate, or operations
    over the float32 rate, whichever is larger."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def atrous_bound(h: int, w: int, step: int) -> dict:
    """An a-trous pass reads 9 planes and writes 4 (f32 or int32)."""
    return bound(13 * 4 * h * w, ATROUS_OPS_PIXEL * h * w
                 + ATROUS_OPS_TAP * atrous_taps(h, w, step))


def walk_bound(geom, n: int, live: int, plane_bytes: int,
               shadow: bool) -> dict:
    """The bound of one walk over a wavefront of ``n`` rays of which
    ``live`` are live: the ray plane read for every ray (``plane_bytes``: 1
    for the alive flags, 4 for t_max), origin and direction (24 bytes) for
    the live rays only (a dead lane never loads them), the answers written
    for every ray (K1: t, u, v, slot, mesh; K2: a byte), and the BVH's node
    and triangle rows read once."""
    rows = sum(t.element_size() * t.numel()
               for t in (geom.node_rows, geom.tri_rows))
    return bound(n * (plane_bytes + (1 if shadow else 20)) + live * 24
                 + rows)


def instances_bound(iset, n: int, live: int, shadow: bool) -> dict:
    """The bound of one K4 call over ``n`` rays of which ``live`` walk
    (t > 0, and for any-hit not yet occluded): ``walk_bound`` over the
    instance set's tables (the t or t_max plane read for every ray) plus
    the instance table read once (a row of 24 floats, the world box, the
    root) and, where the set has one, its instance tree."""
    out = walk_bound(iset.geom, n, live, 4, shadow)
    table = iset.count * (24 + 6 + 1) * 4
    tree = getattr(iset, "tlas", None)
    if tree is not None:  # the instance tree, read once
        table += tree.numel() * tree.element_size()
    return bound(1e-3 * out["bound_ms"] * HBM_BYTES_PER_S + table)


def refit_bound(plan, n_tris: int, morton_refill: bool) -> dict:
    """The bound of K5's refit of one mesh: its vertices read (36 bytes a
    triangle), the plan's slot map (4 bytes a slot; a Morton refill reads
    its rank a slot and its order a triangle instead), each node's metadata
    (16 bytes), each leaf block's node (4 bytes), each node's parent and
    used-slot count (8 bytes), its counter read and written (8 bytes), and
    written: the triangle rows' nine fields and the v0 / e1 / e2 mirrors (36
    + 36 bytes a slot) and the node boxes (192 bytes a node)."""
    m, n, b = plan.num_slots, plan.num_nodes, plan.num_blocks
    slot_map = 4 * m + (4 * n_tris if morton_refill else 0)
    return bound(36 * n_tris + slot_map + 4 * b + 32 * n + 72 * m + 192 * n)


def morton_bound(n_tris: int, codes: bool = True,
                 order: bool = False) -> dict:
    """The bound of K5's Morton kernels: the vertices read (36 bytes a
    triangle), the codes and / or the order written (4 bytes each)."""
    return bound((36 + 4 * codes + 4 * order) * n_tris)


# the env sample's record a NEE lane: origin, direction, pdf and MIS
# weight, and the contribution (a half more when split)
ENV_RECORD = 12 + 12 + 4 + 4 + 12


def env_table_bytes(sky, miss_d, mis, sample_d) -> int:
    """The HDRI's bytes a ``shade_nee`` launch must read, each texel and
    table entry once: the map texels (12 bytes) of the fetches of the
    misses (directions ``miss_d``) and of the env samples (``sample_d``),
    the pdf entries of the misses MIS-weighted (the mask ``mis`` over the
    misses) and of the samples' texels, and the alias rows the samples
    pick, uniform draws over the table: as many as the samples, at most
    the table."""
    import torch

    from ptrt_tpu_torch.render.sky import env_texels

    tex_m, pdf_m = env_texels(sky, miss_d)
    tex_s, pdf_s = env_texels(sky, sample_d)
    texels = torch.cat([tex_m.reshape(-1), tex_s.reshape(-1)]).unique()
    pdfs = torch.cat([pdf_m[mis], pdf_s]).unique()
    rows = min(pdf_s.numel(), sky.env_alias.shape[0])
    return texels.numel() * 12 + pdfs.numel() * 4 + rows * 8


def shade_bytes(stage, pre, post, rec, k1=None, first=False,
                occluded=None, sky=None, env_occluded=None) -> int:
    """Bytes a K3 stage must move on these inputs, from the state before
    (``pre``) and after (``post``) it, the NEE record and (``shade_scatter``)
    the shadow walk's answer: each plane read once and written once on the
    lanes that need it.  Every lane reads its alive flag and moves its PCG
    state; a dead lane needs nothing else but (``shade_nee``) its hit and
    NEE flags and shadow t_max; a live lane that misses needs only K1's
    slot, its direction and throughput for the sky term; an accumulator
    moves only where a term changes it, a flag only where its value
    changes; ``shade_scatter`` reads the NEE record only where the lane
    casts a shadow ray with a positive pdf (the contribution only where it
    is lit) and the hit point and writes the ray only where the lane lives
    on.  Under an HDRI (``sky``; env NEE, ``pre.prev_pdf`` set) a live miss
    also reads its MIS flags and, where the weight applies, its
    ``prev_pdf``; every lane writes its env ``t_max``, a NEE lane writes
    ENV_RECORD, and the map and its tables are read as
    ``env_table_bytes`` counts them; ``shade_scatter`` reads the env record
    as it reads the light's (``env_occluded``: the env walk's answer) and
    writes the MIS carries where the lane lives on.  The material and
    light tables (a few KB) are left out."""
    n, split = pre.alive.numel(), pre.split
    cnt = lambda m: int(m.sum())
    changed = lambda a, b: (a.x != b.x) | (a.y != b.y) | (a.z != b.z)
    # each accumulator a term changes, read and written
    b = sum(cnt(changed(getattr(post, k), getattr(pre, k))) * 24
            for k in ("accum", "diffuse", "specular", "emission")
            if getattr(pre, k) is not None)
    nee = rec.shadow_t is not None
    env = getattr(pre, "prev_pdf", None) is not None
    live = pre.alive
    if stage == "shade_nee":
        hit = live & (k1.slot >= 0)
        miss = live & ~hit
        b += n * 3 + (n * 16 if nee else 0)  # alive, hit, do_nee; PCG state
        b += cnt(live) * (4 + 12 + 12)  # K1's slot, direction, throughput
        # the lane dies; which split channel takes the sky term
        b += cnt(miss) * (1 + (1 if split else 0))
        # K1's t and mesh, origin, the two flags; triangle edges; point,
        # normal, front
        b += cnt(hit) * (8 + 12 + 2 + 24 + 25)
        b += cnt(changed(post.throughput, pre.throughput)) * 12
        if first:
            b += n * 28  # the G-buffer
        if nee:  # every t_max; origin, L, pdf, contribution where NEE
            b += n * 4 + cnt(rec.do_nee) * (40 + (12 if split else 0))
        if env:
            # the MIS flags of a miss, and where the weight applies its
            # prev_pdf; every env t_max; the NEE lanes' record; the map and
            # its tables
            mis = miss & pre.prev_did_nee & ~pre.prev_was_specular
            b += cnt(miss) * 2 + cnt(mis) * 4 + n * 4
            b += cnt(rec.do_nee) * (ENV_RECORD + (12 if split else 0))
            b += env_table_bytes(sky, pre.d.map(lambda c: c[miss]), mis[miss],
                                 rec.env_d.map(lambda c: c[rec.do_nee]))
        return b
    b += n * (1 + 16)  # alive, PCG state
    # material id, normal, front, direction, throughput
    b += cnt(live) * (4 + 12 + 1 + 12 + 12)
    if nee or env:  # the NEE flag
        b += cnt(live)
    if nee:  # its pdf; occlusion and L; the contribution
        cast = rec.do_nee & live
        sampled = cast & (rec.pdf > 0)
        b += cnt(cast) * 4 + cnt(sampled) * (1 + 12)
        b += cnt(sampled & ~occluded) * (24 if split else 12)
    if env:  # the env pdf; occlusion and MIS weight; the contribution
        cast = rec.do_nee & live
        sampled = cast & (rec.env_pdf > 0)
        b += cnt(cast) * 4 + cnt(sampled) * (1 + 4)
        b += cnt(sampled & ~env_occluded & (rec.env_pdf > 1e-12)) * (
            24 if split else 12)
        b += cnt(post.alive) * (4 + 1)  # the MIS carries written
    # the flags that change: alive, the three specular flags
    b += sum(cnt(getattr(post, k) != getattr(pre, k))
             for k in ("alive", "ray_spec", "prev_was_specular",
                       "path_still_specular"))
    # hit point read; throughput, origin, direction written
    return b + cnt(post.alive) * (12 + 12 + 12 + 12)


def live_warps(alive, chunk: int) -> tuple:
    """(warps that hold a live lane when each lane keeps its thread, warps
    the live lanes fill when each block of ``chunk`` lanes packs them
    together) of a wavefront's alive plane."""
    import torch

    n = alive.numel()
    padded = lambda m: torch.nn.functional.pad(alive.reshape(-1).int(),
                                               (0, -n % m)).view(-1, m)
    direct = int(padded(32).any(1).sum())
    packed = int(((padded(chunk).sum(1) + 31) // 32).sum())
    return direct, packed


def temporal_bound(h: int, w: int, caps) -> dict:
    """The bound of one ``svgf_temporal`` launch over an (h, w) frame for
    the channels ``caps`` (whether each reads a history cap): the shared
    planes once, each channel's own planes."""
    planes = TEMPORAL_SHARED_PLANES + sum(TEMPORAL_CHANNEL_PLANES + int(c)
                                          for c in caps)
    return bound(4 * h * w * planes, TEMPORAL_OPS_PIXEL * h * w * len(caps))


def bloom_bound(h: int, w: int) -> dict:
    """The bloom chain of an (h, w) image to mip 0 after the upsample-add:
    the image's three planes read once and that mip 0 written once (the
    smaller mips need not leave the chip); operations: the bright pass a
    pixel, each mip's blur an output, the upsample-add an output of every
    level but the coarsest."""
    from ptrt_tpu_torch.render.bloom import mip_shapes

    shapes = mip_shapes(h, w)
    mh, mw = shapes[0]
    ops = (BLOOM_BRIGHT_OPS_PIXEL * h * w
           + sum(BLUR_DOWN_OPS_PIXEL * a * b for a, b in shapes)
           + sum(UPSAMPLE_ADD_OPS_PIXEL * a * b for a, b in shapes[:-1]))
    return bound(3 * 4 * (h * w + mh * mw), ops)


def tonemap_bound(h: int, w: int, bloom: bool, instructions=None) -> dict:
    """K6 over an (h, w) image: its three planes read once, the bytes
    written once and, with the bloom, mip 0 read once; its float operations
    (with the bloom, the composite's too).  With the SASS ``instructions``
    a thread of the kernel runs, also ``sass_issue_ms``, those warps'
    instructions over the card's issue rate: reported beside the bound,
    never as it, since it counts the kernel's own address arithmetic and
    repeated taps and so grows with what the kernel wastes."""
    from ptrt_tpu_torch.render.bloom import mip_shapes

    mh, mw = mip_shapes(h, w)[0] if bloom else (0, 0)
    out = bound(3 * 4 * h * w + 3 * h * w + 3 * 4 * mh * mw,
                (TONEMAP_OPS_PIXEL + bloom * UPSAMPLE_ADD_OPS_PIXEL) * h * w)
    if instructions:
        threads = -(-w // TONEMAP_PIXELS)  # a row's
        warps = -(-threads // 32) * h
        out["sass_issue_ms"] = 1e3 * warps * instructions / WARP_ISSUE_PER_S
    return out


# float operations of rt_resolve: a pixel's Reinhard and encode-table
# compare (3 x 3); a glass lane's glass terms (csrc/rt_shade.cu glass_color)
RESOLVE_OPS_PIXEL, RESOLVE_OPS_GLASS = 9, 40


def resolve_bounds(n: int, glass_lanes: int, table_bytes: int,
                   lut_bytes: int) -> dict:
    """rt_resolve's two kernels over n pixels with ``glass_lanes`` glass
    lanes: the encode pass reads a pixel's colour (12 bytes) and writes its
    RGB8 (3), the encode table once; the glass pass reads a glass lane's
    place, colour, mesh id, ray direction, normal, front flag, two
    secondary colours and refraction t and slot (73 bytes) and writes its
    3 bytes, the material and encode tables once."""
    return {"rt_resolve": bound(n * (12 + 3) + lut_bytes,
                                n * RESOLVE_OPS_PIXEL),
            "rt_resolve_glass": bound(
                table_bytes + lut_bytes + glass_lanes * (73 + 3),
                glass_lanes * (RESOLVE_OPS_GLASS + RESOLVE_OPS_PIXEL))}


def resolve_sass(resources) -> int:
    """The SASS instructions a thread of rt_resolve's vector encode pass
    runs (4 pixels), from ``kernel_resources``' "rt_resolve" entry."""
    return next(r["sass"]["body"] for fn, r in resources.items()
                if "ILb1EE" in fn)


def resolve_issue_ms(h: int, w: int, instructions: int) -> float:
    """The issue time of rt_resolve's encode pass over an (h, w) frame:
    its warps (a thread a 4 pixels of a row) times ``instructions`` a
    thread over the card's issue rate; beside the bound, never as it."""
    threads = -(-w // TONEMAP_PIXELS)  # a row's
    warps = -(-threads // 32) * h
    return 1e3 * warps * instructions / WARP_ISSUE_PER_S


def profiled_kernels(fn, calls: int = 1, lead_cycles: int = 0) -> list:
    """The device kernels torch.profiler records over ``calls`` calls of
    ``fn()`` (no warm-up; memory copies and sets left out), in launch
    order: [(name, device us)].  With ``lead_cycles`` the card first spins
    that long inside the profiled window (the spin left out of the list):
    kernels launched right after the profiler starts may go unrecorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if lead_cycles:
            torch.cuda._sleep(lead_cycles)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if getattr(e, "device_type", None) == DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))
            and not (lead_cycles and "spin_kernel" in e.name)]
    return [(e.name, e.time_range.elapsed_us())
            for e in sorted(kern, key=lambda e: e.time_range.start)]


def refill_profile(refill, calls: int = 3) -> dict:
    """Kernel launches and device ms of one call of ``refill`` (a Morton
    refill), from ``calls`` calls profiled behind a lead spin; the
    launches are None where the profiler's count is no multiple of
    ``calls`` (it missed some)."""
    prof = profiled_kernels(refill, calls, SPIN_CYCLES // 20)
    whole = len(prof) % calls == 0
    return {"launches": len(prof) // calls if whole else None,
            "device_ms": (sum(us for _, us in prof) / 1e3 / calls
                          if whole else None),
            "kernels": [name[:40] for name, _ in prof[:len(prof) // calls]]}


def kernel_ms(fn, states, kernel):
    """Mean device ms of ``kernel``'s launches in ``fn(state)`` over fresh
    copies of the state, as torch.profiler records them (the kernel alone,
    without the wrapper's host work between launches); None where the
    profiler does not see every launch."""
    fn(states[0])
    rest = iter(states[1:])
    ev = [us for name, us in profiled_kernels(lambda: fn(next(rest)),
                                               len(states) - 1)
          if kernel in name]
    if len(ev) != len(states) - 1:
        say(f"  (the profiler saw {len(ev)} of {len(states) - 1} {kernel} "
            f"launches: its device time is not measured)")
        return None
    return sum(ev) / 1e3 / len(ev)


def clones_ms(fn, states, spin_cycles: int = 0) -> float:
    """Mean ms of a call ``fn(state)`` over fresh copies of the state (the
    stages update it in place), CUDA events around the whole run.  With
    ``spin_cycles`` the card first spins that long, so the host enqueues
    every call meanwhile and the events time the launches back to back: the
    device's time, where a call's host work outlasts its kernel."""
    import torch

    fn(states[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if spin_cycles:
        torch.cuda._sleep(spin_cycles)
    start.record()
    for s in states[1:]:
        fn(s)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (len(states) - 1)


# -- what was compiled ---------------------------------------------------------

_SASS_CLASSES = (("global_load", r"LDG"), ("global_store", r"STG"),
                 ("shared_load", r"LDS"), ("shared_store", r"STS"),
                 ("local", r"LDL|STL"), ("mufu", r"MUFU"),
                 ("float", r"F(ADD|MUL|FMA|MNMX|SETP|SEL|CHK)"),
                 ("branch", r"BRA|BSSY|BSYNC|CALL|RET|EXIT|BAR"),
                 # the warp's reconvergence points (a subset of branch)
                 ("bssy", r"BSSY"), ("bsync", r"BSYNC"))


def kernel_resources(lib_path: str, names) -> dict:
    """{kernel: registers, stack and static shared bytes, SASS instruction
    counts} of the kernels whose (mangled) name holds one of ``names``,
    read from the built library with ``cuobjdump``.  ``sass["body"]``
    counts the instructions a thread runs through a kernel without loops:
    those before its first called subroutine, less each call to one (the
    division's slow path: the CALL and the moves before it) and NOPs.
    ``sass_sha256`` digests the listing (two builds of a kernel compiled to
    the same SASS have the same digest)."""
    import hashlib

    from ptrt_tpu_torch import kernels

    tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    run = lambda *a: subprocess.run([tool, *a, lib_path], capture_output=True,
                                    text=True, check=True, timeout=600).stdout
    key = lambda fn: next((n for n in names if n in fn), None)
    out, fn = {}, None
    for line in run("--dump-resource-usage").splitlines():
        m = re.search(r"Function (\S+?):", line)
        if m:
            fn = m.group(1)
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", line)
        if m and fn and key(fn):
            out.setdefault(key(fn), {})[fn] = {
                "registers": int(m.group(1)), "stack_bytes": int(m.group(2)),
                "shared_bytes": int(m.group(3)),
                "local_bytes": int(m.group(4)), "sass": {}}
    listing, fn = {}, None
    for line in run("-sass").splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][\w.]*)(.*)", line)
        if m and fn and key(fn) and fn in out[key(fn)]:
            listing.setdefault(fn, []).append(
                (int(m.group(1), 16), m.group(2), m.group(3)))
            sass = out[key(fn)][fn]["sass"]
            sass["all"] = sass.get("all", 0) + 1
            for cls, pat in _SASS_CLASSES:
                if re.match(pat, m.group(2)):
                    sass[cls] = sass.get(cls, 0) + 1
    for fn, ins in listing.items():
        out[key(fn)][fn]["sass_sha256"] = hashlib.sha256("\n".join(
            op + rest for _, op, rest in ins).encode()).hexdigest()
        calls = [int(t, 16) for _, op, rest in ins if op.startswith("CALL")
                 for t in re.findall(r"0x([0-9a-f]+)", rest)[:1]]
        end = min(calls, default=ins[-1][0] + 1)
        body = [op for at, op, _ in ins if at < end]
        skipped = 0
        for j, op in enumerate(body):
            if op.startswith("CALL"):
                skipped += 1
                while j > 0 and body[j - 1].startswith("MOV"):
                    skipped, j = skipped + 1, j - 1
        out[key(fn)][fn]["sass"]["body"] = (
            len(body) - skipped - sum(op.startswith("NOP") for op in body))
    return out


# -- the post stages ------------------------------------------------------------


def orbit_frames(sc, frames: int = 3):
    """Render ``frames`` balanced frames with the camera orbiting 0.5
    degrees a frame; returns copies of the denoiser state and
    view-projection the last one started from (the scene's are its frame
    program's buffers, which each frame advances in place)."""
    import math

    from ptrt_tpu_torch import graphs

    sc.set_performance_preset("balanced")
    sc.perf.samples_per_pixel = 1
    for k in range(frames):
        a = math.radians(0.5 * k)
        state0 = graphs.clone_tree(sc._denoiser_state)
        prev_vp = sc.prev_view_proj.clone()
        sc.set_camera((7.5 * math.sin(a), 1.2, 6.0 - 7.5 * math.cos(a)),
                      (0.0, 0.0, 6.0), fov=60)
        sc.render_frame()
    return state0, prev_vp


def temporal_inputs(sc, state0, prev_vp) -> dict:
    """What the temporal stage of ``sc``'s last frame takes, as
    ``denoise_frame`` builds it from the state ``state0`` and the
    view-projection ``prev_vp`` that frame started from:
    {"args": (mvx, mvy, depth, normal, id, state0, cfg), "channels":
    {channel: (firefly-clamped colour, history, settings, cap)}}."""
    from ptrt_tpu_torch.render import denoiser as den
    from ptrt_tpu_torch.render.motion import motion_vectors

    bufs, cfg = sc.last_frame, den.DEFAULT_SETTINGS
    rh, rw = bufs.depth.shape
    mvx, mvy = motion_vectors(bufs.depth, sc.camera, prev_vp, rw, rh)
    caps = {"diffuse": None, "specular": den.specular_history_cap(
        bufs.roughness, bufs.transmission, cfg)}
    channels = {}
    for name in ("diffuse", "specular"):
        ch = getattr(cfg, name)
        src = den.firefly_suppression(getattr(bufs, name), bufs.depth,
                                      bufs.normal, ch.firefly_threshold,
                                      cfg.sky_depth_threshold)
        channels[name] = (src, getattr(state0, name), ch, caps[name])
    return {"args": (mvx, mvy, bufs.depth, bufs.normal, bufs.object_id,
                     state0, cfg), "channels": channels}


def time_temporal(inputs, first, iters: int = 20) -> list:
    """``svgf_temporal`` on each channel alone and, where the tree has the
    two-channel launch, on both at once (held bit for bit to the channels
    alone): queued behind a spin of the card, two readings, and alone
    (profiler), each beside its own bound.  Returns one row a launch."""
    from ptrt_tpu_torch.render import denoiser as den

    mvx, mvy, depth, normal, obj, state0, cfg = inputs["args"]
    h, w = depth.shape
    chans = inputs["channels"]
    runs = [(name, [c], lambda c=c: den.temporal_accumulation(
        c[0], c[1], mvx, mvy, depth, normal, obj, state0, c[2], cfg,
        hist_cap=c[3], first=first)) for name, c in chans.items()]
    pair = getattr(den, "temporal_accumulation_pair", None)
    if pair is not None:
        both = (chans["diffuse"], chans["specular"])
        runs.append(("diffuse+specular", list(both), lambda: pair(
            both, mvx, mvy, depth, normal, obj, state0, cfg, first=first)))
        got = runs[-1][2]()
        for a, b in zip(got, (runs[0][2](), runs[1][2]())):
            for x, y in ((a.mean.x, b.mean.x), (a.mean.y, b.mean.y),
                         (a.mean.z, b.mean.z), (a.m2.x, b.m2.x),
                         (a.m2.y, b.m2.y), (a.m2.z, b.m2.z),
                         (a.length, b.length)):
                assert bool(((x == y) | (x.isnan() & y.isnan())).all()), (
                    "svgf_temporal: the two-channel launch differs from the "
                    "channels alone")
    rows = []
    for name, cs, fn in runs:
        calls = [None] * (iters + 1)
        rows.append({"channels": name,
                     "queued_ms": [clones_ms(lambda _: fn(), calls,
                                             SPIN_CYCLES) for _ in range(2)],
                     "kernel_ms": kernel_ms(lambda _: fn(), calls[:11],
                                            "svgf_temporal_kernel"),
                     **temporal_bound(h, w, [c[3] is not None for c in cs])})
    return rows


def host_ms(fn, calls: int = 10) -> float:
    """Mean host ms of a call ``fn()``, enqueued back to back (no
    synchronisation between them)."""
    import time

    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * t / calls


def tonemap_sass(resources) -> dict:
    """{with the bloom: the SASS instructions a thread of K6's vector path
    runs (4 pixels)} from ``kernel_resources``' "tonemap_rgb8"."""
    return {b: r["sass"]["body"] for fn, r in resources.items()
            for b in (False, True) if f"ILb{int(b)}ELb1EEEv" in fn}


def time_bloom(color, sass=None, iters: int = 10) -> dict:
    """The bloom and K6 of a balanced frame from its colour ``color``:
    ``bloom_chain`` (``bloom_mips``, held bit for bit to the plain chain),
    K6 with its composite and K6 alone.  Each queued behind a spin of the
    card, two readings, and alone (profiler), with its bound (K6's also
    with the issue time of ``sass``, ``tonemap_sass``); the bloom and K6 of
    a frame together queued, by the profiler's kernels and on the host.
    Returns {"bloom", "k6", "k6_alone" (each {"queued_ms", "kernel_ms",
    bound}; the bloom's with its "device_ms"), "host_ms",
    "frame_queued_ms", "frame_device_ms"}."""
    import torch

    from ptrt_tpu_torch.render import bloom, pipeline

    h, w = color.x.shape
    run_bloom = lambda: bloom.bloom_mips(color)
    mip0 = run_bloom()
    want = bloom.bloom_chain_plain(color)[1]
    assert all(torch.equal(a, b) for a, b in zip(
        (mip0.x, mip0.y, mip0.z), (want.x, want.y, want.z))), (
        "bloom_chain: mip 0 after the chain differs from the plain version")
    run_k6 = lambda: pipeline.tonemap_rgb8(color, 1.0, bloom=mip0)
    frame = lambda: pipeline.tonemap_rgb8(color, 1.0,
                                          bloom=bloom.bloom_mips(color))
    calls = [None] * (iters + 1)
    row = lambda fn, kernel: {
        "queued_ms": [clones_ms(lambda _: fn(), calls, SPIN_CYCLES)
                      for _ in range(2)],
        "kernel_ms": kernel_ms(lambda _: fn(), calls[:6], kernel)}
    return {"bloom": {**row(run_bloom, "bloom_chain_kernel"),
                      **bloom_bound(h, w), "device_ms": device_ms(run_bloom)},
            "k6": {**row(run_k6, "tonemap_rgb8_kernel"),
                   **tonemap_bound(h, w, True, sass and sass[True])},
            "k6_alone": {**row(lambda: pipeline.tonemap_rgb8(color, 1.0),
                               "tonemap_rgb8_kernel"),
                         **tonemap_bound(h, w, False, sass and sass[False])},
            "host_ms": host_ms(frame),
            "frame_queued_ms": [clones_ms(lambda _: frame(), calls,
                                          SPIN_CYCLES) for _ in range(2)],
            "frame_device_ms": device_ms(frame)}


def device_ms(fn, calls: int = 3) -> float:
    """Device ms of a call ``fn()`` (after one warm-up call): the kernels
    the profiler sees over ``calls`` calls, summed, over ``calls``."""
    fn()
    return sum(us for _, us in profiled_kernels(fn, calls)) / 1e3 / calls


def frame_profile(sc, frames: int = 0, render=None,
                  lead_cycles: int = 0) -> dict:
    """One frame of ``sc`` (``render()``, by default ``sc.render_frame()``)
    under torch.profiler (behind a spin of ``lead_cycles``, as
    ``profiled_kernels``), then ``frames`` frames timed on the host clock,
    each ending in a synchronisation: {"device_ms", "launches", "top" (the
    five kernels with the most device time, ms), "names" (every kernel in
    launch order), "kernels" (each with its device us, in launch order),
    "walk_ms" (K1 and K2), "k4_ms" (K4), "frame_ms"}; the
    profiled values are None where the profiler saw no device kernel."""
    import time

    import torch

    render = render or sc.render_frame
    kern = profiled_kernels(render, lead_cycles=lead_cycles)
    ms = []
    for _ in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    if not kern:
        return {"device_ms": None, "launches": None, "top": None,
                "names": None, "kernels": None, "walk_ms": None,
                "k4_ms": None, "frame_ms": ms}
    by_name = {}
    for name, us in kern:
        by_name[name] = by_name.get(name, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    walk_us = sum(v for k, v in by_name.items()
                  if "closest_hit_kernel" in k or "any_hit_kernel" in k)
    k4_us = sum(v for k, v in by_name.items() if "instances_" in k)
    return {"device_ms": sum(by_name.values()) / 1e3, "launches": len(kern),
            "top": [(k[:60], round(v / 1e3, 3)) for k, v in top],
            "names": [name for name, _ in kern], "kernels": kern,
            "walk_ms": walk_us / 1e3,
            "k4_ms": k4_us / 1e3, "frame_ms": ms}


def atrous_inputs(t_inputs, first) -> dict:
    """The a-trous inputs of each channel, as ``denoise_channel`` builds
    them from the temporal stage's: {channel: (settings, image, variance,
    depth, normal, id)}."""
    from ptrt_tpu_torch.render import denoiser as den

    mvx, mvy, depth, normal, obj, state0, cfg = t_inputs["args"]
    g = (depth, normal, obj)
    out = {}
    for name, (src, hist, ch, cap) in t_inputs["channels"].items():
        new = den.temporal_accumulation(src, hist, mvx, mvy, *g, state0, ch,
                                        cfg, hist_cap=cap, first=first)
        out[name] = (ch, new.mean, den.estimate_variance(new, *g, cfg), *g)
    return out


def time_atrous(inputs, iters: int = 20, plain_iters: int = 0) -> list:
    """Each of the seven a-trous passes of a balanced frame: the kernel held
    to the plain version (exact: every value equal or both NaN), timed with
    CUDA events, beside the pass's own bound.  Returns one row a pass."""
    import torch

    from ptrt_tpu_torch.render import denoiser as den
    from ptrt_tpu_torch.tools import cuda_ms

    cfg = den.DEFAULT_SETTINGS
    rows = []
    for name, steps in ATROUS_PASSES:
        ch, img, var, depth, normal, obj = inputs[name]
        h, w = depth.shape
        sky = float(((depth > cfg.sky_depth_threshold)
                     | (normal.dot(normal) < 0.1)).float().mean())
        for step in steps:
            a = (img, var, depth, normal, obj, step, ch, cfg)
            got, want = den.atrous_iteration(*a), den.atrous_iteration_plain(*a)
            same = lambda x, y: bool(((x == y) | (x.isnan() & y.isnan())).all())
            exact = (all(same(x, y) for x, y in zip(
                (got[0].x, got[0].y, got[0].z), (want[0].x, want[0].y,
                                                 want[0].z)))
                and same(got[1], want[1]))
            err = max(float((x - y).abs().nan_to_num().max()) for x, y in (
                (got[0].x, want[0].x), (got[0].y, want[0].y),
                (got[0].z, want[0].z), (got[1], want[1])))
            row = {"channel": name, "step": step, "exact": exact,
                   "max_abs_err": err, "sky_share": sky,
                   "ms": cuda_ms(lambda: den.atrous_iteration(*a), iters),
                   **atrous_bound(h, w, step)}
            if plain_iters:
                row["plain_ms"] = cuda_ms(
                    lambda: den.atrous_iteration_plain(*a), plain_iters)
            rows.append(row)
            img, var = got
    return rows


# -- the shading stages --------------------------------------------------------


def time_shading(sc, split: bool, depth: int = DEPTH,
                 clones: int = 11) -> list:
    """``shade_nee`` and ``shade_scatter`` on the wavefront of each bounce
    of sample 0 of ``sc``'s camera, as ``trace_path`` runs them (K1 through
    the alive plane, the kernels' own state and record carried on,
    ``shade_scatter`` counting the rays where the tree's does): a
    wrapper call (CUDA events) and the kernel alone (profiler) over fresh
    copies of the state, and the bytes the wavefront must move, counted
    from the plain stages run on a copy.  Under an HDRI with sampling
    tables the stages do env NEE (their HDRI instantiations) and the row
    also times K2 on the env shadow rays beside its ``walk_bound``.
    Returns one row a bounce."""
    import torch

    from ptrt_tpu_torch.render import pipeline, shade, traverse
    from ptrt_tpu_torch.tools import cuda_ms

    sc._ensure_device_state()
    g, mats, lights = sc._geom, sc._mat_table, sc._light_table
    n_lights, sky = len(sc.lights), sc.sky()
    # (a tree from before the HDRI port takes no env arguments)
    env = getattr(sky, "has_env_sampling", False)
    env_kw = lambda **kw: kw if env else {}
    rr = int(sc.perf.russian_roulette_start_bounce)
    st, ray = pipeline.camera_rays(sc.camera, sc._rng_state, 0, 0,
                                   sc._blue_noise)
    ps = shade.PathState.start(ray, st, split, **env_kw(env_nee=True))
    shade.check_state(ps, mats)
    # shade_scatter counts the trace's rays where the tree's takes them
    counted = "rays" in inspect.signature(shade.shade_scatter).parameters
    counter = torch.zeros((), dtype=torch.int64, device=st.device)
    casts = int(env) + int(n_lights > 0)

    def fresh(state):  # checked once, as trace_path does
        out = [state.clone() for _ in range(clones)]
        for s in out:
            shade.check_state(s, mats)
        return out

    rows = []
    for bounce in range(depth):
        k1 = traverse.closest_hit_live(g, ps.o, ps.d, ps.alive)
        nee = lambda s: shade.shade_nee(s, g, k1, mats, lights, n_lights,
                                        sky, bounce)
        row = {"split": split, "bounce": bounce, "lanes": ps.alive.numel(),
               "alive": int(ps.alive.sum()), "hit": int((ps.alive & (
                   k1.slot >= 0)).sum())}
        # the plain stages on a copy: the bytes this wavefront needs
        pre, pa = ps.clone(), ps.clone()
        pn = shade.shade_nee_plain(pa, g, k1, mats, lights, n_lights, sky,
                                   bounce)
        row["do_nee"] = int(pn.do_nee.sum())
        times = {"shade_nee": {
            "ms": clones_ms(nee, fresh(ps)),
            "queued_ms": clones_ms(nee, fresh(ps), SPIN_CYCLES),
            "kernel_ms": kernel_ms(nee, fresh(ps), "shade_nee_kernel"),
            **bound(shade_bytes("shade_nee", pre, pa, pn, k1=k1,
                                first=bounce == 0, sky=sky),
                    SHADE_NEE_OPS_LANE * ps.alive.numel())}}
        kn = nee(ps)
        assert torch.equal(ps.rng, pa.rng), f"bounce {bounce}: PCG differs"
        row["flags_equal"] = bool(torch.equal(ps.alive, pa.alive)
                                  and torch.equal(kn.do_nee, pn.do_nee))
        occl = (traverse.any_hit(g, kn.shadow_o, kn.shadow_d, kn.shadow_t)
                if n_lights else None)
        occl_p = (traverse.any_hit(g, pn.shadow_o, pn.shadow_d, pn.shadow_t)
                  if n_lights else None)
        env_occl = env_occl_p = None
        if env:
            env_walk = lambda r: traverse.any_hit(g, r.env_o, r.env_d,
                                                  r.env_t)
            env_occl, env_occl_p = env_walk(kn), env_walk(pn)
            live = int((kn.env_t > 0).sum())
            times["env_any_hit"] = {
                "ms": cuda_ms(lambda: env_walk(kn), 20), "live": live,
                **walk_bound(g, kn.env_t.numel(), live, 4, True)}
        count = (dict(rays=counter, casts=casts,
                      next_bounce=bounce + 1 < depth,
                      base=ps.alive.numel() if bounce == 0 else 0)
                 if counted else {})
        sca = lambda s: shade.shade_scatter(s, kn, occl, mats, bounce, True,
                                            rr, **env_kw(env_shadow=env_occl),
                                            **count)
        before = pa.clone()
        shade.shade_scatter_plain(pa, pn, occl_p, mats, bounce, True, rr,
                                  **env_kw(env_shadow=env_occl_p))
        times["shade_scatter"] = {
            "ms": clones_ms(sca, fresh(ps)),
            "queued_ms": clones_ms(sca, fresh(ps), SPIN_CYCLES),
            "kernel_ms": kernel_ms(sca, fresh(ps), "shade_scatter_kernel"),
            **bound(shade_bytes("shade_scatter", before, pa, pn,
                                occluded=occl_p, env_occluded=env_occl_p))}
        sca(ps)
        assert torch.equal(ps.rng, pa.rng), f"bounce {bounce}: PCG differs"
        row.update(times)
        rows.append(row)
        del pre, pa, pn, before
        torch.cuda.empty_cache()
    return rows


# -- the script ----------------------------------------------------------------


def say(*a) -> None:
    """Print a line and, with ``--out DIR``, append it to
    ``DIR/stages.log`` (a remote run may show only the end of a long
    output)."""
    print(*a, flush=True)
    if say.out:
        os.makedirs(say.out, exist_ok=True)
        with open(os.path.join(say.out, "stages.log"), "a") as fh:
            print(*a, file=fh)


say.out = None


def measure(tag: str, card: str, bloom_only: bool = False) -> dict:
    """Build the imported tree's kernels and run the measurements (with
    ``bloom_only``, only the kernels' resources and the bloom and K6)."""
    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.app.bench_scene import build_bench_scene
    from ptrt_tpu_torch.build import BUILD_DIR

    sc = build_bench_scene(W, H, target_tris=TRIS, device="cuda")
    state0, prev_vp = orbit_frames(sc)
    t_inputs = temporal_inputs(sc, state0, prev_vp)
    first = state0.first_frame
    color = sc.last_frame.color
    log = lambda *a: say(f"[{tag}]", *a)
    out = {"tag": tag, "card": card, "shading": []}
    out["resources"] = kernel_resources(
        os.path.join(BUILD_DIR, kernels.LIBRARY),
        ("svgf_temporal", "svgf_atrous", "shade_nee", "shade_scatter",
         "tonemap_rgb8", "bloom"))
    for k, fns in out["resources"].items():
        for fn, r in fns.items():
            log(f"{k} {fn[-48:]}: {r['registers']} registers, stack "
                f"{r['stack_bytes']}, static shared {r['shared_bytes']} "
                f"bytes; SASS {r['sass']}")
    out["bloom"] = time_bloom(color, tonemap_sass(
        out["resources"]["tonemap_rgb8"]))
    for name, r in out["bloom"].items():
        if name in ("bloom", "k6", "k6_alone"):
            issue = (f"; the SASS issues in {r['sass_issue_ms']:.4f} ms"
                     if "sass_issue_ms" in r else "")
            log(f"{name}: queued "
                f"{' / '.join(f'{t:.4f}' for t in r['queued_ms'])} ms, "
                f"kernel {r['kernel_ms'] or float('nan'):.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}{issue}) [{card}]")
    b = out["bloom"]
    log(f"bloom + K6 of a frame: queued "
        f"{' / '.join(f'{t:.4f}' for t in b['frame_queued_ms'])} ms, device "
        f"{b['frame_device_ms']:.4f} ms (the bloom "
        f"{b['bloom']['device_ms']:.4f}), host {b['host_ms']:.3f} ms a call "
        f"[{card}]")
    if bloom_only:
        return out
    for split in (False, True):
        rows = time_shading(sc, split)
        out["shading"] += rows
        for r in rows:
            log(f"split={split} bounce {r['bounce']}: alive {r['alive']}, "
                f"hit {r['hit']}, NEE {r['do_nee']} of {r['lanes']}; "
                + "; ".join(
                    f"{k} call {r[k]['ms']:.4f} queued "
                    f"{r[k]['queued_ms']:.4f} kernel "
                    f"{r[k]['kernel_ms'] or float('nan'):.4f} bound "
                    f"{r[k]['bound_ms']:.4f} ms ({r[k]['bound_by']})"
                    for k in ("shade_nee", "shade_scatter"))
                + f"; flags equal the plain stage's: {r['flags_equal']}"
                f" [{card}]")
        log(f"split={split}, bounces 0-{DEPTH - 1}: " + ", ".join(
            f"{k} kernel {sum(r[k]['kernel_ms'] or 0.0 for r in rows):.4f}"
            f" queued {sum(r[k]['queued_ms'] for r in rows):.4f}"
            f" bound {sum(r[k]['bound_ms'] for r in rows):.4f} ms"
            for k in ("shade_nee", "shade_scatter")))
    out["temporal"] = time_temporal(t_inputs, first)
    for r in out["temporal"]:
        log(f"svgf_temporal {r['channels']}: queued "
            f"{' / '.join(f'{t:.4f}' for t in r['queued_ms'])} ms, kernel "
            f"{r['kernel_ms'] or float('nan'):.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}) [{card}]")
    out["atrous"] = time_atrous(atrous_inputs(t_inputs, first))
    for r in out["atrous"]:
        log(f"svgf_atrous {r['channel']} step {r['step']}: {r['ms']:.4f} "
            f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), exact "
            f"{r['exact']} (max |err| {r['max_abs_err']:.3g}), sky share "
            f"{r['sky_share']:.3f} [{card}]")
    log(f"svgf_atrous, the seven passes: "
        f"{sum(r['ms'] for r in out['atrous']):.4f} ms, bound "
        f"{sum(r['bound_ms'] for r in out['atrous']):.4f} ms")
    out["frames"] = {}
    bench_frames(sc, out)
    del sc, state0, t_inputs, color
    measure_hdri(out, log, card)
    log_frames(out, log, card)
    return out


def bench_frames(sc, out: dict) -> None:
    """One profiled and three timed frames of the bench scene ``sc`` (after
    ``orbit_frames``) balanced, then with the bench preset, into
    ``out["frames"]``."""
    sc.render_frame()
    out["frames"]["balanced"] = frame_profile(sc, 3)
    sc.perf.enable_denoiser = sc.perf.enable_bloom = False
    sc.perf.enable_motion_vectors = False
    sc.perf.samples_per_pixel, sc.perf.max_bounce_depth = 4, DEPTH
    sc.render_frame()
    out["frames"]["bench"] = frame_profile(sc, 3)


def measure_frames(tag: str, card: str) -> dict:
    """One profiled replay of each scene frame program at 1920x1080 (the
    frame before it made the program): balanced, bench (4 spp, depth 4, no
    post stack), fast, performance, hdri balanced and ultra (its chunk and
    post programs), and of the fused cube slider's captured frame at
    640x360 "fast" (traced at 224x125), each with its device ms, kernels
    and the launches of each counted kernel (``kernels.counts``), and three
    frames on the host clock."""
    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.app.bench_scene import build_bench_scene
    from ptrt_tpu_torch.games import cube_slider

    log = lambda *a: say(f"[{tag}]", *a)
    out = {"tag": tag, "card": card, "frames": {}}

    def frame(name, sc, timed=3, render=None):
        render = render or sc.render_frame
        render()  # makes the program (or replays it)
        kernels.clear_counts()
        r = frame_profile(sc, timed, render=render,
                          lead_cycles=SPIN_CYCLES)
        del r["names"], r["kernels"]  # the line stays short
        kernels.clear_counts()
        img = render()
        r["counts"] = dict(kernels.counts())
        r["rgb8_sha256"] = digest(img)[:16]
        r["rays"] = (int(sc.last_frame.rays_traced)
                     if render == sc.render_frame else None)
        out["frames"][name] = r
        log(f"{name} frame: device {r['device_ms']:.3f} ms in "
            f"{r['launches']} kernels; frames "
            f"{[round(t, 2) for t in r['frame_ms']]} ms; counted "
            f"{r['counts']}; last image {r['rgb8_sha256']}, rays "
            f"{r['rays']} [{card}]")

    sc = build_bench_scene(W, H, target_tris=TRIS, device="cuda")
    sc.set_performance_preset("balanced")
    sc.perf.samples_per_pixel = 1
    sc.render_frame()
    frame("balanced", sc)
    sc.perf.enable_denoiser = sc.perf.enable_bloom = False
    sc.perf.enable_motion_vectors = False
    sc.perf.samples_per_pixel, sc.perf.max_bounce_depth = 4, DEPTH
    frame("bench", sc)
    sc.set_performance_preset("fast")
    sc.perf.samples_per_pixel = 1
    frame("fast", sc)
    sc.set_performance_preset("performance")
    frame("performance", sc)
    del sc
    _, sc = cube_slider.build_scene(640, 360, "cuda")
    sc.set_performance_preset("fast")
    runner = cube_slider.make_runner(sc)
    inputs = cube_slider.script_inputs
    vp = sc.camera.get_view_proj()
    state, _, _ = runner.frame(cube_slider.init_state(0, "cuda"), inputs(0),
                               0, vp)
    runner.capture(state, inputs(1), vp)
    index = [1]

    def replay():
        index[0] += 1
        return runner.replay(inputs(index[0]), index[0])

    frame("fused cube_slider 640x360 fast", sc, render=replay)
    runner.release()
    del sc, runner
    sc = hdri_scene()
    sc.render_frame()
    frame("hdri balanced", sc)
    sc.set_performance_preset("ultra")
    frame("ultra", sc, timed=1)
    return out


def digest(*arrays) -> str:
    """SHA-256 of tensors' or arrays' bytes, in order."""
    import numpy as np
    import torch

    h = hashlib.sha256()
    for a in arrays:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


# K12's shapes on the main path: the fused games' "fast" 224x125 ->
# 640x360 and 112x62 -> 320x180, the scenes' "fast" 672x378 and
# "performance" 1440x810 -> 1920x1080
UPSCALES = (((125, 224), (360, 640)), ((62, 112), (180, 320)),
            ((378, 672), (1080, 1920)), ((810, 1440), (1080, 1920)))


def measure_upscale(log, card: str) -> dict:
    """K12 at ``UPSCALES``, on seeded lognormal planes: queued twice (20
    calls behind a spin) beside its bound (each plane read and written
    once) and ``interpolate`` of the stacked planes, and a SHA-256 of its
    output, so that two trees' designs compare bit for bit."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ptrt_tpu_torch.core.vec import Vec3
    from ptrt_tpu_torch.render import pipeline

    rng = np.random.default_rng(24)
    out = {}
    for (ih, iw), (oh, ow) in UPSCALES:
        img = Vec3(*[torch.from_numpy(rng.lognormal(-1.0, 1.5, (ih, iw))
                                      .astype(np.float32)).cuda()
                     for _ in range(3)])
        stacked = torch.stack([img.x, img.y, img.z])[None]
        up = lambda _: pipeline.upscale_bilinear(img, oh, ow)
        lib = lambda _: F.interpolate(stacked, size=(oh, ow),
                                      mode="bilinear", align_corners=False)
        got = up(None)
        r = {"queued_ms": [clones_ms(up, [None] * 21, SPIN_CYCLES)
                           for _ in range(2)],
             "library_ms": [clones_ms(lib, [None] * 21, SPIN_CYCLES)
                            for _ in range(2)],
             "sha256": digest(got.x, got.y, got.z)[:16],
             **bound(12 * (ih * iw + oh * ow))}
        tag = f"{iw}x{ih} -> {ow}x{oh}"
        out[tag] = r
        log(f"upscale_bilinear {tag}: queued "
            f"{' / '.join(f'{t:.4f}' for t in r['queued_ms'])} ms, "
            f"interpolate {' / '.join(f'{t:.4f}' for t in r['library_ms'])}"
            f" ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); output "
            f"{r['sha256']} [{card}]")
    return out


def measure_glue(tag: str, card: str) -> dict:
    """The glue kernels' measurements for turns with another tree:
    ``measure_upscale``, the shade_scatter instantiations' registers and
    blocks a SM, and both K3 stages at bounces 0-3 of the bench (unsplit,
    split) and hdri (split) wavefronts with ``time_shading``."""
    from ptrt_tpu_torch.app.bench_scene import build_bench_scene
    from ptrt_tpu_torch.render import shade

    log = lambda *a: say(f"[{tag}]", *a)
    out = {"tag": tag, "card": card,
           "upscale": measure_upscale(log, card)}
    sc = build_bench_scene(W, H, target_tris=TRIS, device="cuda")
    sc.set_performance_preset("balanced")
    sc.perf.samples_per_pixel = 1
    sc.render_frame()
    info = {**shade.kernel_info(sc._mat_table, sc._light_table),
            **shade.kernel_info(sc._mat_table, sc._light_table, True)}
    out["scatter"] = {k: (v["registers"], v["blocks_per_sm"])
                      for k, v in info.items() if "scatter" in k}
    log(f"shade_scatter registers and blocks a SM: {out['scatter']}")
    out["shading"] = {}
    for name, scene, splits in (("bench", sc, (False, True)),
                                ("hdri", None, (True,))):
        if scene is None:
            scene = hdri_scene()
            scene.render_frame()
        for split in splits:
            rows = time_shading(scene, split)
            out["shading"][f"{name} split={split}"] = rows
            for k in ("shade_nee", "shade_scatter"):
                log(f"{name} split={split} {k} queued (bounces 0-3): "
                    + " / ".join(f"{r[k]['queued_ms']:.4f}" for r in rows)
                    + " ms, kernel "
                    + " / ".join(f"{r[k]['kernel_ms'] or float('nan'):.4f}"
                                 for r in rows)
                    + " ms, bound "
                    + " / ".join(f"{r[k]['bound_ms']:.4f}" for r in rows)
                    + f" ms [{card}]")
    return out


def hdri_scene():
    """The 1080p "hdri" configuration, balanced at 1 spp, on the card."""
    from ptrt_tpu_torch.app.bench_scene import build_hdri_scene

    sc = build_hdri_scene(W, H, target_tris=TRIS, device="cuda")
    sc.set_performance_preset("balanced")
    sc.perf.samples_per_pixel = 1
    return sc


def hdri_frame(sc, out: dict) -> None:
    """One profiled and three timed balanced frames of ``hdri_scene()``,
    and the device memory its frame program holds: the bytes allocated
    and reserved across the first frame (the program's copies of what it
    reads and its graph's pool), beside the sky's own tensors."""
    import gc

    import torch

    from ptrt_tpu_torch import graphs

    sky = sc.sky()
    # (a tree without Shared leaves has no shared_leaves)
    shared = getattr(graphs, "shared_leaves", lambda tree: [])(sky)
    sky_bytes = sum(t.numel() * t.element_size() for t in
                    graphs.tree_leaves(sky) + [s.tensor for s in shared])
    gc.collect()
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated()
    reserved = torch.cuda.memory_reserved()
    sc.render_frame()
    torch.cuda.synchronize()
    memory = {"sky_mb": sky_bytes / 2 ** 20,
              "program_allocated_mb":
                  (torch.cuda.memory_allocated() - alloc) / 2 ** 20,
              "program_reserved_mb":
                  (torch.cuda.memory_reserved() - reserved) / 2 ** 20}
    out["frames"]["hdri balanced"] = dict(frame_profile(sc, 3), **memory)


def log_frames(out: dict, log, card: str) -> None:
    for name, r in out["frames"].items():
        k4 = f" (K4 {r['k4_ms']:.3f} ms)" if r.get("k4_ms") else ""
        mem = (f"; sky {r['sky_mb']:.1f} MB, its program "
               f"{r['program_allocated_mb']:.1f} MB allocated, "
               f"{r['program_reserved_mb']:.1f} MB reserved"
               if "sky_mb" in r else "")
        log(f"{name} frame: device {r['device_ms']:.3f} ms{k4} in "
            f"{r['launches']} launches; frames "
            f"{[round(t, 1) for t in r['frame_ms']]} ms{mem} [{card}]")


def measure_hdri(out: dict, log, card: str) -> None:
    """The HDRI stages and the env shadow walk at bounces 0-3, unsplit and
    split, on the "hdri" configuration, and one profiled balanced frame of
    it, into ``out`` (a tree without the HDRI port is passed over)."""
    import torch

    from ptrt_tpu_torch.app import bench_scene

    if not hasattr(bench_scene, "build_hdri_scene"):
        log("no HDRI in this tree: its stages are not measured")
        return
    torch.cuda.empty_cache()
    sc = hdri_scene()
    out["shading_hdri"] = []
    for split in (False, True):
        rows = time_shading(sc, split)
        out["shading_hdri"] += rows
        for r in rows:
            w = r["env_any_hit"]
            log(f"hdri split={split} bounce {r['bounce']}: alive "
                f"{r['alive']}, NEE {r['do_nee']} of {r['lanes']}; "
                + "; ".join(
                    f"{k} call {r[k]['ms']:.4f} queued "
                    f"{r[k]['queued_ms']:.4f} kernel "
                    f"{r[k]['kernel_ms'] or float('nan'):.4f} bound "
                    f"{r[k]['bound_ms']:.4f} ms ({r[k]['bound_by']})"
                    for k in ("shade_nee", "shade_scatter"))
                + f"; K2 env shadow rays {w['ms']:.4f} ms ({w['live']} "
                f"live) bound {w['bound_ms']:.4f} ms; flags equal the plain "
                f"stage's: {r['flags_equal']} [{card}]")
    for split in (False, True):
        rows = [r for r in out["shading_hdri"] if r["split"] == split]
        log(f"hdri split={split}, bounces 0-{DEPTH - 1}: " + ", ".join(
            f"{k} kernel {sum(r[k]['kernel_ms'] or 0.0 for r in rows):.4f}"
            f" queued {sum(r[k]['queued_ms'] for r in rows):.4f}"
            f" bound {sum(r[k]['bound_ms'] for r in rows):.4f} ms"
            for k in ("shade_nee", "shade_scatter")) + f" [{card}]")
    hdri_frame(sc, out)


def measure_hdri_only(tag: str, card: str) -> dict:
    """The K3 kernels' resources (registers, stack, SASS digests, ptxas's
    spills) and the HDRI stages and frame of ``measure_hdri``, alone."""
    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.build import BUILD_DIR

    log = lambda *a: say(f"[{tag}]", *a)
    out = {"tag": tag, "card": card, "frames": {}}
    kernels.get_lib()
    out["resources"] = kernel_resources(
        os.path.join(BUILD_DIR, kernels.LIBRARY), ("shade_nee",
                                                   "shade_scatter"))
    for k, fns in out["resources"].items():
        for fn, r in fns.items():
            log(f"{k} {fn[-48:]}: {r['registers']} registers, stack "
                f"{r['stack_bytes']}, local {r['local_bytes']}, static "
                f"shared {r['shared_bytes']} bytes; SASS sha256 "
                f"{r['sass_sha256'][:16]}, {r['sass'].get('all')} "
                f"instructions")
    out["ptxas"] = source_ptxas(os.path.join(os.path.dirname(
        os.path.abspath(kernels.__file__)), "csrc"), "shade.cu")
    for line in out["ptxas"]:
        log(f"ptxas {line[line.index('shade_'):]}")
    measure_hdri(out, log, card)
    log_frames(out, log, card)
    return out


def k4_wavefront(iset, static, name, o, d, t) -> tuple:
    """K4 on one of ``walks.wavefronts``' ray sets after its static pass:
    (a call on a fresh copy of the static answer, the fresh copy, the
    planes of a result, the bound a live ray descends with: K1's t, or the
    shadow rays' t_max where K2 left them unoccluded, -1 elsewhere)."""
    import torch

    from ptrt_tpu_torch.render import traverse

    if name == "shadow":
        base = traverse.any_hit(static, o, d, t)
        return (lambda h: traverse.instances_any(iset, o, d, t, h),
                lambda: base.clone(), lambda res: [res],
                torch.where(~base & (t > 0), t, -1.0))
    base = traverse.closest_hit(static, o, d, t)
    return (lambda r: traverse.instances_closest(iset, o, d, r),
            lambda: traverse.Closest(*[p.clone() for p in base]),
            lambda res: [*res, res.inst], base.t)


def records_digest(planes) -> str:
    """A SHA-256 of the planes' bytes: two trees' records compare bit for
    bit by their digests."""
    import hashlib

    h = hashlib.sha256()
    for p in planes:
        h.update(p.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def instance_world(n: int, seed: int, dev, tie: bool = False):
    """A floor and ``n`` dynamic cubes at seeded transforms over a 24 x 24
    field, every third one hidden (scale 1e-6 at y = -100, as the dynamic
    scene's empty slots); with ``tie`` the first two are identical (the
    same mesh at the same transform: instances 0 and 1)."""
    import numpy as np
    from ptrt_tpu_torch.geometry.mesh import Mesh
    from ptrt_tpu_torch.geometry.scene_geom import assemble_world

    rng = np.random.default_rng(seed)
    meshes = [Mesh.plane_xz(-1.0, 40.0)]
    for k in range(n):
        m = Mesh.cube()
        pos = rng.uniform([-12.0, -0.5, 4.0], [12.0, 3.0, 28.0])
        rot = rng.uniform(0.0, 3.0, 3)
        scale = rng.uniform(0.3, 1.2, 3)
        if tie and k == 1:
            pos, rot, scale = first
        first = (pos, rot, scale) if k == 0 else first
        m.transform.set_position(*pos).set_rotation(*rot).set_scale(*scale)
        if k % 3 == 2 and not tie:
            m.transform.set_position(pos[0], -100.0, pos[2]).set_scale(1e-6)
        m.is_dynamic = True
        meshes.append(m)
    return assemble_world(meshes, None, dev)


def set_rays(iset, rng, r: int):
    """``r`` seeded rays at an instance set over instance_world's field:
    three in four at an instance's centre (inside its cube whatever its
    rotation), the rest anywhere over the field; (origins, directions, the
    points aimed at)."""
    import numpy as np
    import torch
    from ptrt_tpu_torch.core.vec import Vec3

    org = rng.normal([0.0, 2.0, -6.0], 0.5, (r, 3))
    centre = 0.5 * (iset.bb_min + iset.bb_max).cpu().numpy()
    shown = np.flatnonzero(centre[:, 1] > -50.0)
    aim = centre[rng.choice(shown, r)] + rng.uniform(-0.05, 0.05, (r, 3))
    field = rng.uniform([-12.0, -1.0, 4.0], [12.0, 3.5, 28.0], (r, 3))
    aim = np.where((rng.uniform(size=r) < 0.25)[:, None], field, aim)
    dirs = aim - org
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dev = iset.bb_min.device
    vec = lambda a: Vec3(*[torch.tensor(a[:, j], dtype=torch.float32,
                                        device=dev) for j in range(3)])
    return vec(org), vec(dirs), aim - org


def time_instance_set(g, rng, rays: int) -> dict:
    """K4 on ``rays`` of ``set_rays``' rays at ``instance_world`` ``g``'s
    set after its static passes (K1; K2 on shadow rays ending before or
    beyond the point aimed at): closest and any queued behind a spin twice,
    each beside its bound, the kernels' resources and whether the set is
    staged (``traverse.instances_info``), and the records (closest's planes
    and instance, any's plane)."""
    import numpy as np
    import torch

    from ptrt_tpu_torch.render import traverse

    iset = g.iset
    o, d, aim = set_rays(iset, rng, rays)
    t = torch.full((rays,), traverse.T_MAX, device=iset.bb_min.device)
    t_s = torch.tensor(np.linalg.norm(aim, axis=1)
                       * rng.uniform(0.5, 1.5, rays), dtype=torch.float32,
                       device=iset.bb_min.device)
    rec = traverse.closest_hit(g.static, o, d, t)
    h0 = traverse.any_hit(g.static, o, d, t_s)
    copy = lambda x: traverse.Closest(*[p.clone() for p in x])
    res = traverse.instances_closest(iset, o, d, copy(rec))
    hit = traverse.instances_any(iset, o, d, t_s, h0.clone())
    return {
        "closest_ms": [clones_ms(
            lambda x: traverse.instances_closest(iset, o, d, x),
            [copy(rec) for _ in range(11)], SPIN_CYCLES) for _ in range(2)],
        "any_ms": [clones_ms(
            lambda x: traverse.instances_any(iset, o, d, t_s, x),
            [h0.clone() for _ in range(11)], SPIN_CYCLES) for _ in range(2)],
        "bound_ms": {
            "closest": instances_bound(iset, rays, int((rec.t > 0).sum()),
                                       False)["bound_ms"],
            "any": instances_bound(iset, rays,
                                   int((~h0 & (t_s > 0)).sum()),
                                   True)["bound_ms"]},
        "info": traverse.instances_info(iset),
        "records": [*res, res.inst, hit]}


def measure_sets(tag: str, card: str, sizes) -> dict:
    """K4 on ``instance_world``'s sets of each of ``sizes`` instances
    (``time_instance_set`` on SET_RAYS rays), with a digest of the records,
    so that two trees' records compare bit for bit."""
    import numpy as np
    import torch

    log = lambda *a: say(f"[{tag}]", *a)
    out = {"tag": tag, "card": card, "sets": {}}
    for n in sizes:
        g = instance_world(n, 40 + n, "cuda")
        r = time_instance_set(g, np.random.default_rng(50 + n), SET_RAYS)
        r["digest"] = records_digest(r.pop("records"))
        out["sets"][n] = r
        staged = r["info"]["instances_closest"]["staged"]
        log(f"K4 on {n} instances ({'staged' if staged else 'from global memory'}), "
            f"{SET_RAYS} rays: closest queued "
            f"{' / '.join(f'{x:.4f}' for x in r['closest_ms'])} ms (bound "
            f"{r['bound_ms']['closest']:.4f}), any "
            f"{' / '.join(f'{x:.4f}' for x in r['any_ms'])} ms (bound "
            f"{r['bound_ms']['any']:.4f}); "
            + ", ".join(f"{k} {v['registers']} registers, "
                        f"{v['blocks_per_sm']} blocks a SM"
                        for k, v in r["info"].items())
            + f"; records sha256 {r['digest'][:16]} [{card}]")
        del g
        torch.cuda.empty_cache()
    return out


def measure_dynamic(tag: str, card: str) -> dict:
    """K4 on the 1080p "dynamic" configuration's camera, bounce-1 and
    shadow wavefronts (each call on a fresh copy of its static pass's
    answer: queued behind a spin twice, beside its bound; the digest of its
    records; with an instance tree, the boxes a live ray tests), the K1, K2
    and K4 kernels' registers, blocks a SM and SASS digests, then one
    profiled and three timed frames of each configuration: dynamic (with
    its edits a frame), balanced, bench and hdri balanced."""
    import torch

    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.app.bench_scene import (build_bench_scene,
                                                build_dynamic_scene)
    from ptrt_tpu_torch.build import BUILD_DIR
    from ptrt_tpu_torch.render import traverse
    from ptrt_tpu_torch.tools.walks import wavefronts

    log = lambda *a: say(f"[{tag}]", *a)
    out = {"tag": tag, "card": card, "k4": {}, "frames": {}}
    sc = build_dynamic_scene(W, H, target_tris=TRIS, device="cuda")
    sc._ensure_device_state()
    g = sc._geom
    iset = g.iset
    tree = getattr(iset, "tlas", None)  # None: a tree before the TLAS
    info = traverse.instances_info(iset if tree is not None else iset.count)
    for k, v in info.items():
        log(f"{k}: {v['registers']} registers, {v['local_bytes']} bytes of "
            f"local memory a thread, {v['blocks_per_sm']} blocks a SM")
    out["k4_info"] = info
    res = kernel_resources(os.path.join(BUILD_DIR, kernels.LIBRARY),
                           ("closest_hit_kernel", "any_hit_kernel",
                            "instances_closest", "instances_any"))
    for k, fns in res.items():
        for fn, r in fns.items():
            log(f"{k} {fn[-32:]}: {r['registers']} registers, stack "
                f"{r['stack_bytes']}; SASS {r['sass'].get('all')} "
                f"instructions, sha256 {r['sass_sha256'][:16]}")
    out["resources"] = res
    for name, o, d, t in wavefronts(sc):
        fn, fresh, planes, live_t = k4_wavefront(iset, g.static, name, o, d,
                                                 t)
        digest = records_digest(planes(fn(fresh())))
        ms = [clones_ms(fn, [fresh() for _ in range(11)], SPIN_CYCLES)
              for _ in range(2)]
        live = int((live_t > 0).sum())
        b = instances_bound(iset, live_t.numel(), live, name == "shadow")
        tests = {"flat": float(iset.count)}
        if tree is not None:
            from ptrt_tpu_torch.geometry import tlas

            _, n = tlas.tlas_candidates(tree, iset.count, o,
                                        traverse.safe_inv(d), live_t,
                                        candidates=False)
            tests["tree"] = float(n[live_t > 0].float().mean())
        out["k4"][name] = {"queued_ms": ms, "live": live, "digest": digest,
                           "box_tests": tests, **b}
        log(f"K4 {name}: {live} live of {live_t.numel()}; queued "
            f"{' / '.join(f'{x:.4f}' for x in ms)} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}); boxes a live ray "
            + ", ".join(f"{w} {v:.2f}" for w, v in tests.items())
            + f"; records sha256 {digest} [{card}]")
    frame = [1]

    def edited_frame():
        frame[0] += 1
        sc.animate(frame[0])
        sc.render_frame()

    edited_frame()
    out["frames"]["dynamic"] = frame_profile(sc, 3, edited_frame)
    del sc, g, iset, tree
    torch.cuda.empty_cache()
    sc = build_bench_scene(W, H, target_tris=TRIS, device="cuda")
    orbit_frames(sc)
    bench_frames(sc, out)
    del sc
    torch.cuda.empty_cache()
    hdri_frame(hdri_scene(), out)
    log_frames(out, log, card)
    for r in out["frames"].values():
        r.pop("names", None)
    return out


def grid_triangles(height) -> "np.ndarray":
    """(R, C) heights on a unit-spaced grid -> (2 (R-1)(C-1), 3, 3)
    triangles in ``bench_scene.heightfield_to_triangles``' layout (a
    rectangular grid too)."""
    import numpy as np

    r, c = height.shape
    px = np.broadcast_to(np.arange(c, dtype=np.float32)[None, :], (r, c))
    pz = np.broadcast_to(np.arange(r, dtype=np.float32)[:, None], (r, c))
    p = np.stack([px, height.astype(np.float32), pz], axis=-1)
    a, b, cc, d = p[:-1, :-1], p[:-1, 1:], p[1:, 1:], p[1:, :-1]
    t1 = np.stack([a, cc, b], axis=-2)
    t2 = np.stack([a, d, cc], axis=-2)
    return np.concatenate([t1.reshape(-1, 3, 3), t2.reshape(-1, 3, 3)])


def refill_meshes(seed: int = 7) -> list:
    """The Morton refill's shapes, seeded: (label, the triangles the tree is
    built from, the triangles of the refill), each (T, 3, 3) float32: a
    1,001-triangle soup, the dynamic scene's 8,192-triangle sphere with its
    vertices displaced, a 256 x 256 heightfield (130,050 triangles) and a
    1024 x 512 one (1,045,506), each refilled with moved vertices."""
    import numpy as np

    from ptrt_tpu_torch.geometry.mesh import Mesh

    rng = np.random.default_rng(seed)
    soup = (rng.uniform(-3, 3, (1001, 1, 3))
            + rng.uniform(-0.2, 0.2, (1001, 3, 3))).astype(np.float32)
    sphere = Mesh.sphere(64)
    k = rng.uniform(3.0, 7.0, (3, 3)).astype(np.float32)
    bump = 1.0 + 0.08 * np.sin(sphere.vertices @ k + 0.4).sum(axis=1) / 3.0
    blob = (sphere.vertices * bump[:, None]).astype(np.float32)

    def waves(rows, cols, t):
        z, x = np.mgrid[0:rows, 0:cols].astype(np.float32)
        return 0.3 * np.sin(0.11 * x + 0.07 * z + t) + 0.2 * np.sin(
            0.05 * x - 0.13 * z + 2.0 * t)

    out = [("soup", soup, soup * np.float32(1.1) + np.float32(0.05)),
           ("sphere", sphere.vertices[sphere.faces].astype(np.float32),
            blob[sphere.faces])]
    for rows, cols in ((256, 256), (512, 1024)):
        out.append((f"heightfield {cols}x{rows}",
                    grid_triangles(waves(rows, cols, 0.0)),
                    grid_triangles(waves(rows, cols, 0.7))))
    return out


def measure_refill(tag: str, card: str) -> dict:
    """The Morton refill (``lbvh.lbvh_update``: the order, then the refit)
    of each of ``refill_meshes``: one profiled refill (its kernel launches
    and their device time), the refill queued behind a spin twice, the
    codes kernel (``lbvh.morton_codes``) and, where the tree has it, the
    one-launch ``lbvh.morton_sort``, queued, and ``torch.sort(codes,
    stable=True)`` (the library's sort) likewise; digests of the order and
    of the tables after the refill, so that two trees compare bit for
    bit."""
    import numpy as np
    import torch

    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.geometry import lbvh, refit
    from ptrt_tpu_torch.geometry.mesh import Mesh
    from ptrt_tpu_torch.geometry.scene_geom import assemble_geometry

    log = lambda *a: say(f"[{tag}]", *a)
    out = {"tag": tag, "card": card, "refill": {}}
    queued = lambda fn: [clones_ms(lambda _: fn(), [None] * 21, SPIN_CYCLES)
                         for _ in range(2)]
    for label, tris0, tris1 in refill_meshes():
        g = assemble_geometry([Mesh.from_triangles(tris0)], None, "cuda",
                              world=False)
        plan = refit.build_refit_plan(g)
        v = torch.from_numpy(np.ascontiguousarray(
            np.stack([tris1[:, j] for j in range(3)]))).to("cuda")
        v0, v1, v2 = v[0], v[1], v[2]
        refill = lambda: lbvh.lbvh_update(g, plan, v0, v1, v2)
        refill()
        order = lbvh.morton_order(v0, v1, v2)
        codes = lbvh.morton_codes(v0, v1, v2)
        r = {"tris": int(v0.shape[0]),
             "distinct_codes": int(codes.unique().numel()),
             **refill_profile(refill),
             "queued_ms": queued(refill),
             "codes_ms": queued(lambda: lbvh.morton_codes(v0, v1, v2)),
             "torch_sort_ms": queued(lambda: torch.sort(codes, stable=True)),
             "order_digest": records_digest([order]),
             "tables_digest": records_digest([g.node_rows, g.tri_rows]),
             "refit_ms": refit_turns(g, plan, v0, v1, v2, order, queued)}
        sort = getattr(lbvh, "morton_sort", None)
        if sort is not None and r["tris"] <= (
                kernels.get_lib().ptrt_morton_sort_max()):
            r["morton_sort_ms"] = queued(lambda: sort(v0, v1, v2))
        out["refill"][label] = r
        log(f"refill {label} ({r['tris']} triangles, {r['distinct_codes']} "
            f"distinct codes): {r['launches']} launches, device "
            f"{r['device_ms']} ms, queued "
            f"{' / '.join(f'{x:.4f}' for x in r['queued_ms'])} ms; codes "
            f"kernel {' / '.join(f'{x:.4f}' for x in r['codes_ms'])}"
            + (f", morton_sort "
               f"{' / '.join(f'{x:.4f}' for x in r['morton_sort_ms'])}"
               if "morton_sort_ms" in r else "")
            + f", torch.sort "
            f"{' / '.join(f'{x:.4f}' for x in r['torch_sort_ms'])} ms; "
            f"the refit alone " + ", ".join(
                f"{k} {' / '.join(f'{x:.4f}' for x in v)}"
                for k, v in r["refit_ms"].items()) + " ms; "
            f"order sha256 {r['order_digest'][:16]}, tables sha256 "
            f"{r['tables_digest'][:16]}; kernels {r['kernels']} [{card}]")
        del g, plan, v, v0, v1, v2, order, codes
        torch.cuda.empty_cache()
    out["launch_floor_ms"] = launch_floor()
    if out["launch_floor_ms"] is not None:
        log(f"an empty kernel's launch, queued: "
            f"{' / '.join(f'{x:.4f}' for x in out['launch_floor_ms'])} ms "
            f"[{card}]")
    return out


def refit_turns(g, plan, v0, v1, v2, order, queued) -> dict:
    """K5's refit alone on the Morton refill's slot map, queued (two
    readings), under the name of the tree's design: "arrival" (counters),
    or "cooperative" (a grid sync a level, a tree before the counters)."""
    from ptrt_tpu_torch.geometry import refit

    slot_map = (plan.device_arrays(v0.device)["rank"], order)
    design = "arrival" if hasattr(refit.RefitPlan, "climb") else "cooperative"
    return {design: queued(lambda: refit.refit_apply(
        g, plan, v0, v1, v2, slot_map=slot_map))}


def launch_floor():
    """An empty kernel's launch queued behind a spin (two readings): the
    floor under a small kernel's time, where the tree's library has one
    (None before it)."""
    import torch

    from ptrt_tpu_torch import kernels

    lib = kernels.get_lib()
    if not hasattr(lib, "ptrt_empty_launch"):
        return None
    dev = torch.device("cuda", torch.cuda.current_device())
    call = lambda _: kernels.check(
        lib.ptrt_empty_launch(kernels.stream_ptr(dev)), "empty launch")
    return [clones_ms(call, [None] * 21, SPIN_CYCLES) for _ in range(2)]


# the RT frame's kernels by the names the profiler gives them
RT_KERNELS = (("closest_hit", "closest_hit_kernel"),
              ("any_hit", "any_hit_kernel"),
              ("rt_light_rays", "rt_light_rays_kernel"),
              ("rt_shade", "rt_shade_kernel"),
              ("rt_glass_rays", "rt_glass_rays_kernel"),
              ("rt_resolve", "rt_resolve_kernel"),
              ("rt_resolve_glass", "rt_resolve_glass_kernel"))


def rt_frame_split(kern) -> dict:
    """An RT frame's profiled kernels (``profiled_kernels``: launch order)
    split into its passes: {"primary", "glass rays", "glass pass",
    "resolve"}, each {kernel: device ms} (launches of other kernels under
    "other"); the glass pass is what runs between ``rt_glass_rays`` and
    ``rt_resolve``.  None where the profiler saw no ``rt_glass_rays``."""
    names = [name for name, _ in kern]
    at = lambda k: next((j for j, nm in enumerate(names) if k in nm), None)
    glass, resolve = at("rt_glass_rays_kernel"), at("rt_resolve_kernel")
    if glass is None or resolve is None:
        return None
    out = {}
    for part, lo, hi in (("primary", 0, glass), ("glass rays", glass,
                                                  glass + 1),
                         ("glass pass", glass + 1, resolve),
                         ("resolve", resolve, len(kern))):
        ms = {}
        for name, us in kern[lo:hi]:
            k = next((k for k, nm in RT_KERNELS if nm in name), "other")
            ms[k] = ms.get(k, 0.0) + us / 1e3
        out[part] = ms
    return out


def source_ptxas(csrc: str, source: str) -> list:
    """nvcc's ``-Xptxas -v`` report of ``csrc/<source>`` (this tree's
    flags): one line a kernel of its stack frame, spill stores and loads,
    and registers."""
    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.build import BUILD_DIR
    from ptrt_tpu_torch.tools.walks import ptxas_report

    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"{os.path.splitext(source)[0]}_ptxas.o")
    proc = subprocess.run(
        [kernels.nvcc_path(), *kernels.NVCC_FLAGS,
         *kernels.SOURCE_FLAGS[source], "-Xptxas", "-v", "-c",
         os.path.join(csrc, source), "-o", out],
        capture_output=True, text=True, timeout=600, check=True)
    return ptxas_report(proc.stdout + proc.stderr)


def spill_bytes(report: list) -> dict:
    """{kernel (mangled): (spill store bytes, spill load bytes)} of a
    ``source_ptxas`` report."""
    out = {}
    for line in report:
        m = re.match(r"(\S+): (\d+) bytes stack frame, (\d+) bytes spill "
                     r"stores, (\d+) bytes spill loads", line)
        if m:
            out[m.group(1)] = (int(m.group(3)), int(m.group(4)))
    return out


def measure_rt(tag: str, card: str, frames: int = 5) -> dict:
    """The RT frame on the 1080p "rt" configuration
    (``build_rt_bench_scene(1920, 1080, 1_000_000)``): a SHA-256 of its
    RGB8 (two trees' images compare bit for bit), its wrapper launches,
    ``frames`` frames on the host clock, the host ms of a call, one frame
    profiled behind a spin and split by pass and kernel
    (``rt_frame_split``); ``rt_shade`` on both passes, ``rt_light_rays``
    on the glass rays and ``rt_resolve`` (both its kernels) queued behind a
    spin (two readings each), each K10 kernel alone by the profiler over 20
    calls, beside ``rt_resolve``'s bounds; ``rt_shade``'s registers,
    local bytes, blocks a SM (``kernel_info``) and ptxas report."""
    import time

    import torch

    from ptrt_tpu_torch import kernels
    from ptrt_tpu_torch.app.bench_scene import build_rt_bench_scene
    from ptrt_tpu_torch.render import rt_shading as rs

    log = lambda *a: say(f"[{tag}]", *a)
    sc = build_rt_bench_scene(1920, 1080, 1_000_000, device="cuda")
    sc.render_frame_device()  # warm-up
    out = {"tag": tag, "card": card,
           "rgb8_sha256": records_digest([sc.render_frame_device()])}
    kernels.launches.clear()
    frame_ms = []
    for _ in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sc.render_frame_device()
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t0))
    out["launches"] = {k: v / frames for k, v in kernels.launches.items()}
    out["frame_ms"] = frame_ms
    out["host_ms"] = host_ms(sc.render_frame_device, calls=frames)
    kern = profiled_kernels(sc.render_frame_device, lead_cycles=SPIN_CYCLES)
    out["device_ms"] = sum(us for _, us in kern) / 1e3
    out["profiled_launches"] = len(kern)
    out["split"] = rt_frame_split(kern)
    fr = sc.last_frame
    d = sc.camera_rays()[1]
    mats, lts, nl, params = (sc._mat_table, sc._light_table, len(sc.lights),
                             sc.params())
    calls = {
        "rt_shade": lambda _: rs.rt_shade(fr.hit, d, fr.occluded, mats, lts,
                                          nl, params),
        "rt_shade (glass rays)": lambda _: rs.rt_shade(
            fr.sec_hit, fr.glass.d, fr.sec_occluded, mats, lts, nl, params),
        "rt_light_rays (glass rays)": lambda _: rs.rt_light_rays(
            sc._geom, fr.glass.o, fr.glass.d, fr.sec_k1, lts, nl),
        "rt_glass_rays": lambda _: rs.rt_glass_rays(fr.hit, d, mats),
        "rt_resolve": lambda _: rs.rt_resolve(
            fr.color, fr.hit, d, mats, fr.glass, fr.sec_color, fr.sec_k1,
            1080, 1920)}
    # a tree from before rt_resolve's two launches has no glass pass
    two = hasattr(rs, "encode_lut")
    out["glass_rays"] = int(fr.glass.d.x.shape[0])
    out["queued_ms"] = {k: [clones_ms(fn, [None] * 21, SPIN_CYCLES)
                            for _ in range(2)]
                        for k, fn in calls.items() if k != "rt_glass_rays"}
    out["kernel_ms"] = {k: kernel_ms(fn, [None] * 21, name)
                        for k, fn, name in (
                            ("rt_shade", calls["rt_shade"],
                             "rt_shade_kernel"),
                            ("rt_shade (glass rays)",
                             calls["rt_shade (glass rays)"],
                             "rt_shade_kernel"),
                            ("rt_glass_rays", calls["rt_glass_rays"],
                             "rt_glass_rays_kernel"),
                            ("rt_resolve (the encode pass)",
                             calls["rt_resolve"], "rt_resolve_kernel"))
                        + ((("rt_resolve_glass", calls["rt_resolve"],
                             "rt_resolve_glass_kernel"),) if two else ())}
    out["resolve_bounds"] = resolve_bounds(
        d.x.shape[0], out["glass_rays"] // 2,
        mats.packed.numel() * 4,
        rs.encode_lut(d.x.device).numel() * 4 if two else 0)
    out["info"] = rs.kernel_info(mats, lts, nl)
    out["launch_floor_ms"] = launch_floor()
    if hasattr(rs, "resolve_glass_grid"):
        g = out["glass_rays"] // 2
        out["resolve_glass_grid"] = {
            "host count": rs.resolve_glass_grid(g),
            "device count": rs.resolve_glass_grid(d.x.shape[0])}
    out["ptxas"] = source_ptxas(os.path.join(os.path.dirname(
        os.path.abspath(kernels.__file__)), "csrc"), "rt_shade.cu")
    from ptrt_tpu_torch.build import BUILD_DIR

    out["sass"] = {
        fn[-48:]: {"registers": r["registers"], "stack": r["stack_bytes"],
                   "instructions": r["sass"].get("all"),
                   "sha256": r.get("sass_sha256", "")[:16]}
        for fns in kernel_resources(
            os.path.join(BUILD_DIR, kernels.LIBRARY),
            ("rt_shade_kernel", "rt_glass_rays_kernel")).values()
        for fn, r in fns.items()}
    log(f"rt frame 1920x1080: RGB8 sha256 {out['rgb8_sha256']}; frames "
        f"{[round(x, 3) for x in frame_ms]} ms, host {out['host_ms']:.3f} ms "
        f"a call; profiled device {out['device_ms']:.4f} ms in "
        f"{out['profiled_launches']} launches; {out['glass_rays']} glass "
        f"rays; wrapper launches {out['launches']} [{card}]")
    log(f"rt frame split (device ms by pass and kernel): {out['split']} "
        f"[{card}]")
    for k, v in out["queued_ms"].items():
        log(f"{k}: queued {v[0]:.4f} / {v[1]:.4f} ms [{card}]")
    for k, v in out["kernel_ms"].items():
        log(f"{k}: kernel (profiler) "
            f"{'not measured' if v is None else f'{v:.4f} ms'} [{card}]")
    log("rt_resolve bounds: " + ", ".join(
        f"{k} {v['bound_ms']:.4f} ms ({v['bound_by']})"
        for k, v in out["resolve_bounds"].items())
        + f"; an empty kernel's launch {out['launch_floor_ms']} ms queued; "
        f"rt_resolve_glass's grid {out.get('resolve_glass_grid')} [{card}]")
    info = out["info"]["rt_shade"]
    log(f"rt_shade: {info['registers']} registers, {info['local_bytes']} "
        f"bytes local, {info['blocks_per_sm']} blocks of {info['threads']} "
        f"a SM, {info['shared_bytes']} bytes dynamic shared; ptxas: "
        + " | ".join(out["ptxas"]) + f"; SASS {out['sass']} [{card}]")
    del fr, sc
    torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", help="measure the checkout in this directory")
    ap.add_argument("--out", help="also append the log to DIR/stages.log")
    ap.add_argument("--bloom", action="store_true",
                    help="measure only the bloom and K6")
    ap.add_argument("--dynamic", action="store_true",
                    help="measure only K4 and the four configurations' "
                    "frames")
    ap.add_argument("--refill", action="store_true",
                    help="measure only the Morton refill (K5)")
    ap.add_argument("--sets", help="measure only K4 on hand-made sets of "
                    "these instance counts (comma-separated)")
    ap.add_argument("--rt", action="store_true",
                    help="measure only the RT frame and K10")
    ap.add_argument("--hdri", action="store_true",
                    help="measure only the K3 kernels' resources and the "
                    "HDRI stages and frame")
    ap.add_argument("--frames", action="store_true",
                    help="measure only one replay of the balanced, bench, "
                    "fast, performance, hdri and ultra frame programs and "
                    "of a fused game frame")
    ap.add_argument("--glue", action="store_true",
                    help="measure only the K3 stages at bounces 0-3 (the "
                    "ray count in shade_scatter) and K12")
    args = ap.parse_args(argv)
    say.out = args.out and os.path.abspath(args.out)
    here = os.path.abspath(__file__)
    if args.tree:
        # a process of its own, which finds the other tree's package first
        tree = os.path.abspath(args.tree)
        proc = subprocess.Popen(
            [sys.executable, here] + ["--bloom"] * args.bloom
            + ["--dynamic"] * args.dynamic + ["--refill"] * args.refill
            + ["--rt"] * args.rt + ["--hdri"] * args.hdri
            + ["--frames"] * args.frames + ["--glue"] * args.glue
            + (["--sets", args.sets] if args.sets else []),
            cwd=tree,
            stdout=subprocess.PIPE, text=True,
            env={**os.environ, "PYTHONPATH": tree})
        for line in proc.stdout:  # the log is kept here
            say(line.rstrip("\n"))
        return proc.wait()
    # behind PYTHONPATH, so that a tree named there is the one measured
    sys.path.append(os.path.dirname(os.path.dirname(os.path.dirname(here))))
    import torch

    import ptrt_tpu_torch

    if not torch.cuda.is_available():
        raise SystemExit("stages: needs a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    say(card)
    tag = os.path.basename(os.path.dirname(os.path.dirname(
        os.path.abspath(ptrt_tpu_torch.__file__))))
    if args.refill:
        say(json.dumps(measure_refill(tag, card)))
    if args.dynamic:
        say(json.dumps(measure_dynamic(tag, card)))
    if args.sets:
        say(json.dumps(measure_sets(tag, card, [
            int(n) for n in args.sets.split(",")])))
    if args.rt:
        say(json.dumps(measure_rt(tag, card)))
    if args.hdri:
        say(json.dumps(measure_hdri_only(tag, card)))
    if args.glue:
        say(json.dumps(measure_glue(tag, card)))
    if args.frames:
        say(json.dumps(measure_frames(tag, card)))
    if not (args.refill or args.dynamic or args.sets or args.rt
            or args.hdri or args.frames or args.glue):
        say(json.dumps(measure(tag, card, args.bloom)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
