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
     triangle bench scene and on a 4096-ray sample of the full scene; K6
     tonemap_rgb8 on a 1920x1080 HDR frame; row_gather at the Pallas
     probes' shapes (ptrt_tpu_torch/tools/probe_gather.py) and at the
     material gather's (the scene's table, 2,073,600 ids), bit for bit;
  4. the bench path: Scene.render_frame() on the bench scene at 1920x1080,
     4 spp, depth 4, ~1M triangles, post stack off — one warm-up and three
     timed frames, with the kernels' launch counts taken over exactly that
     run;
  5. the balanced path: the same scene under the reference's default
     ("balanced") preset — 1 spp, depth 4, split trace, motion vectors,
     SVGF, bloom, tonemap — one warm-up and five timed frames with the
     camera orbiting 0.5 degrees before each, launch counts taken over the
     timed frames; then the post stages timed one by one;
  6. svgf_temporal, svgf_atrous and bloom_blur_down against their plain
     versions on the 1920x1080 buffers of a balanced frame;
  7. end to end on small inputs: the bench frame and three balanced frames
     rendered on the GPU and on the CPU (plain versions) must agree.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Without a GPU, or outside the repository,
the script fails.
"""

import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

W, H, SPP, DEPTH, TRIS = 1920, 1080, 4, 4, 1_000_000
BENCH_RAYS_PER_FRAME = 20.59e6  # the reference's count for this config
SAMPLE_RAYS = 4096
K1_K2_AGREE = 0.9999
# the balanced path: timed frames, orbit step about the bench camera's
# look-at point, and its bounce depth (the preset's)
BAL_FRAMES, ORBIT_DEG, BAL_DEPTH = 5, 0.5, 4
LOOKAT, ORBIT_R, EYE_Y = (0.0, 0.0, 6.0), 7.5, 1.2
# SVGF kernels vs plain on the card: share of pixels within
# rtol 1e-5 + atol 1e-6 (the plain version's x / 3.0 multiplies by a
# rounded reciprocal on the card; the kernel divides), and of equal
# history lengths
SVGF_AGREE = 0.9999


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``iters`` launches (after
    one warm-up call), timed with CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
            f"vs index_select {row['plain_ms']:.4f} ms [{card}]")
    table = mat_table.packed
    ids = torch.from_numpy(rng.integers(0, table.shape[0], W * H)).to(dev)
    got = row_gather(table, ids, field_major=True)
    want = row_gather_plain(table, ids, field_major=True)
    assert torch.equal(got, want), "row_gather: material gather not exact"
    ms = cuda_ms(lambda: row_gather(table, ids, field_major=True), 20)
    plain_ms = cuda_ms(lambda: row_gather_plain(table, ids, field_major=True),
                       20)
    log(f"  row_gather material ({tuple(table.shape)} table, {W * H} ids, "
        f"field-major): exact, kernel {ms:.4f} ms vs index_select + "
        f"transpose {plain_ms:.4f} ms [{card}]")
    return {"ms": ms, "plain_ms": plain_ms, "probes": probes}


def check_post_kernels(sc, state0, prev_vp, card):
    """svgf_temporal, svgf_atrous and bloom_blur_down against their plain
    versions on the buffers of the scene's last frame (traced after
    ``state0`` / ``prev_vp``).  Returns {kernel: stats}."""
    import torch
    from ptrt_tpu_torch.render import bloom
    from ptrt_tpu_torch.render import denoiser as den
    from ptrt_tpu_torch.render.motion import motion_vectors

    bufs = sc.last_frame
    rh, rw = sc.render_size
    cfg = den.DEFAULT_SETTINGS
    assert not bool(state0.first_frame)
    mvx, mvy = motion_vectors(bufs.depth, sc.camera, prev_vp, rw, rh)
    g = (bufs.depth, bufs.normal, bufs.object_id)
    spec_cap = den.specular_history_cap(bufs.roughness, bufs.transmission,
                                        cfg)
    out = {}

    temporal = {"max_abs_err": 0.0}
    hists = {}
    for name, ch, cap in (("diffuse", cfg.diffuse, None),
                          ("specular", cfg.specular, spec_cap)):
        src = den.firefly_suppression(getattr(bufs, name), bufs.depth,
                                      bufs.normal, ch.firefly_threshold,
                                      cfg.sky_depth_threshold)
        hist = getattr(state0, name)
        args = (src, hist, mvx, mvy, *g, state0, ch, cfg)
        got = den.temporal_accumulation(*args, hist_cap=cap,
                                        first=state0.first_frame)
        want = den.temporal_accumulation_plain(*args, hist_cap=cap)
        hists[name] = got
        for part in ("mean", "m2"):
            err, rel, share = agreement(getattr(got, part),
                                        getattr(want, part))
            log(f"  svgf_temporal {name} {part}: max |err| {err:.3g}, max "
                f"rel {rel:.3g}, {share:.6f} of pixels within rtol 1e-5 "
                f"(bound {SVGF_AGREE})")
            assert share >= SVGF_AGREE, (name, part, share)
            temporal["max_abs_err"] = max(temporal["max_abs_err"], err)
        same_len = float((got.length == want.length).float().mean())
        log(f"  svgf_temporal {name} length: equal on {same_len:.6f}")
        assert same_len >= SVGF_AGREE, (name, same_len)
        if name == "diffuse":
            temporal["ms"] = cuda_ms(lambda: den.temporal_accumulation(
                *args, hist_cap=cap, first=state0.first_frame), 20)
            temporal["plain_ms"] = cuda_ms(
                lambda: den.temporal_accumulation_plain(*args, hist_cap=cap),
                5)
    out["svgf_temporal"] = temporal

    atrous = {"max_abs_err": 0.0}
    img = hists["diffuse"].mean
    var = den.estimate_variance(hists["diffuse"], *g, cfg)
    for step in (1, 2, 4, 8, 16):
        a = (img, var, *g, step, cfg.diffuse, cfg)
        got, want = den.atrous_iteration(*a), den.atrous_iteration_plain(*a)
        for part, gv, wv in (("image", got[0], want[0]),
                             ("variance", got[1], want[1])):
            err, rel, share = agreement(gv, wv)
            log(f"  svgf_atrous step {step} {part}: max |err| {err:.3g}, "
                f"max rel {rel:.3g}, {share:.6f} of pixels within rtol "
                f"1e-5 (bound {SVGF_AGREE})")
            assert share >= SVGF_AGREE, (step, part, share)
            atrous["max_abs_err"] = max(atrous["max_abs_err"], err)
        if step == 1:
            atrous["ms"] = cuda_ms(lambda: den.atrous_iteration(*a), 20)
            atrous["plain_ms"] = cuda_ms(
                lambda: den.atrous_iteration_plain(*a), 5)
        img, var = got
    out["svgf_atrous"] = atrous

    blur = {"max_abs_err": 0.0}
    cur = bloom.bright_pass(bufs.color)
    first = cur
    sizes = []
    while cur.x.shape[0] // 2 and cur.x.shape[1] // 2 and len(sizes) < 6:
        got, want = bloom.blur_down(cur), bloom.blur_down_plain(cur)
        err, rel, share = agreement(got, want, rtol=1e-6, atol=1e-7)
        assert share == 1.0, (tuple(cur.x.shape), err, rel)
        blur["max_abs_err"] = max(blur["max_abs_err"], err)
        sizes.append(tuple(got.x.shape))
        cur = got
    log(f"  bloom_blur_down mips {sizes}: max |err| {blur['max_abs_err']:.3g}"
        f" (rtol 1e-6 on every pixel)")
    blur["ms"] = cuda_ms(lambda: bloom.blur_down(first), 50)
    blur["plain_ms"] = cuda_ms(lambda: bloom.blur_down_plain(first), 10)
    out["bloom_blur_down"] = blur
    for k, v in out.items():
        log(f"  {k} at {rh}x{rw}: kernel {v['ms']:.4f} ms vs plain "
            f"{v['plain_ms']:.4f} ms [{card}]")
    return out


def wavefronts(sc):
    """Sample-0 camera rays of the scene, one bounce of scattered rays and
    the NEE shadow rays from the camera hits — the three ray sets the main
    path hands K1 and K2, as flat (R,) tensors: [(name, o, d, t_max)]."""
    import torch
    from ptrt_tpu_torch.core.vec import Vec3, where
    from ptrt_tpu_torch.render import pipeline, traverse
    from ptrt_tpu_torch.render.bsdf import material_scatter
    from ptrt_tpu_torch.render.nee import sample_light

    sc._ensure_device_state()
    state, ray = pipeline.camera_rays(sc.camera, sc._rng_state, 0, 0,
                                      sc._blue_noise)
    flat = lambda v: v.map(lambda c: c.reshape(-1).contiguous())
    o, d = flat(ray.origin), flat(ray.direction)
    state = state.reshape(-1)
    t_cam = torch.full_like(o.x, 1e30)
    hit = traverse.intersect_closest(sc._geom, o, d, t_cam)
    mat = sc._mat_table.gather(hit.mesh_index.clamp_min(0))
    state, sc_res = material_scatter(state, hit.normal, hit.front_face, mat,
                                     d)
    alive = hit.hit & sc_res.valid
    off = where(sc_res.direction.dot(hit.normal) > 0.0, hit.normal * 1e-4,
                hit.normal * -1e-4)
    o_b = flat(where(alive, hit.point + off, o))
    d_b = flat(where(alive, sc_res.direction, d))
    t_b = torch.where(alive, 1e30, -1.0).contiguous()
    _, l, _, _, _, dist = sample_light(state, sc._light_table,
                                       len(sc.lights), hit.point)
    off = where(hit.normal.dot(l) > 0.0, hit.normal * 1e-4,
                hit.normal * -1e-4)
    o_s = flat(hit.point + off)
    t_s = torch.where(hit.hit, dist - 1e-3, -1.0).contiguous()
    return [("camera", o, d, t_cam), ("bounce", o_b, d_b, t_b),
            ("shadow", o_s, flat(l), t_s)]


def take(rays, idx):
    name, o, d, t = rays
    pick = lambda c: c[idx].contiguous()
    return name, o.map(pick), d.map(pick), pick(t)


def check_k1(geom, rays, tag, stats):
    from ptrt_tpu_torch.render import traverse

    name, o, d, t = rays
    tk, _, _, slot_k, mesh_k = traverse.closest_hit(geom, o, d, t)
    tp, _, _, slot_p, mesh_p = traverse.closest_hit_plain(geom, o, d, t)
    hit_k, hit_p = slot_k >= 0, slot_p >= 0
    agree = (hit_k == hit_p) & (mesh_k == mesh_p)
    both = agree & hit_k
    t_err = (tk - tp).abs()[both]
    t_ok = bool(((tk - tp).abs() <= 1e-4 * tp.abs())[both].all())
    n = t.numel()
    mism = int((~agree).sum())
    frac = 1.0 - mism / n
    max_err = float(t_err.max()) if t_err.numel() else 0.0
    log(f"  K1 {tag} {name}: {n} rays, hit {float(hit_k.float().mean()):.4f}, "
        f"hit/mesh mismatches {mism} (agree {frac:.6f}), "
        f"max |dt| {max_err:.3g}, t within rtol 1e-4: {t_ok}")
    assert frac >= K1_K2_AGREE, f"K1 {tag} {name}: agreement {frac}"
    assert t_ok, f"K1 {tag} {name}: t differs beyond rtol 1e-4"
    stats["mismatches"] += mism
    stats["max_abs_err"] = max(stats["max_abs_err"], max_err)


def check_k2(geom, rays, tag, stats):
    from ptrt_tpu_torch.render import traverse

    name, o, d, t = rays
    hk = traverse.any_hit(geom, o, d, t)
    hp = traverse.any_hit_plain(geom, o, d, t)
    mism = int((hk != hp).sum())
    frac = 1.0 - mism / t.numel()
    log(f"  K2 {tag} {name}: {t.numel()} rays, occluded "
        f"{float(hk.float().mean()):.4f}, mismatches {mism} "
        f"(agree {frac:.6f})")
    assert frac >= K1_K2_AGREE, f"K2 {tag} {name}: agreement {frac}"
    stats["mismatches"] += mism
    stats["max_abs_err"] = max(stats["max_abs_err"], float(mism > 0))


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
    from ptrt_tpu_torch import kernels, native
    from ptrt_tpu_torch.app.bench_scene import build_bench_scene
    from ptrt_tpu_torch.build import BUILD_DIR
    from ptrt_tpu_torch.core.vec import Vec3
    from ptrt_tpu_torch.render import pipeline, traverse

    assert os.path.dirname(os.path.abspath(ptrt_tpu_torch.__file__)) == pkg
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. environment ------------------------------------------------------
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
    t0 = time.time()
    kernels.get_lib()
    t_nvcc = time.time() - t0
    t0 = time.time()
    native.get_lib()
    t_gxx = time.time() - t0
    log(f"[build] CUDA kernels {t_nvcc:.1f} s (nvcc), native BVH builder "
        f"{t_gxx:.1f} s (g++), into {os.path.relpath(BUILD_DIR, HERE)}")

    # -- 3. kernels against their plain versions -----------------------------
    rng = np.random.default_rng(0)
    k1 = {"mismatches": 0, "max_abs_err": 0.0}
    k2 = {"mismatches": 0, "max_abs_err": 0.0}
    small = bench_perf(build_bench_scene(256, 144, target_tris=20_000,
                                         device=dev), SPP, DEPTH)
    small_rays = wavefronts(small)
    log(f"[kernels] small scene: {sum(m.num_triangles for m in small.meshes)} "
        f"triangles, {small._geom.num_tri_slots} tri slots, "
        f"{small._geom.num_nodes} nodes, stack bound "
        f"{small._geom.stack_depth}")
    for r in small_rays:
        (check_k2 if r[0] == "shadow" else check_k1)(small._geom, r, "small",
                                                      k2 if r[0] == "shadow"
                                                      else k1)

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
    full_rays = wavefronts(full)
    idx = torch.from_numpy(rng.choice(W * H, SAMPLE_RAYS, replace=False)).to(
        dev)
    sampled = [take(r, idx) for r in full_rays]
    for r in sampled:
        (check_k2 if r[0] == "shadow" else check_k1)(full._geom, r, "full",
                                                      k2 if r[0] == "shadow"
                                                      else k1)

    # times: kernel and plain on the same 4096-ray sample of the full
    # scene, and the kernel alone at the main path's full wavefronts
    g = full._geom
    _, o, d, t = sampled[1]
    k1_ms = cuda_ms(lambda: traverse.closest_hit(g, o, d, t), 20)
    k1_plain_ms = cuda_ms(lambda: traverse.closest_hit_plain(g, o, d, t), 1)
    _, so, sd, st = sampled[2]
    k2_ms = cuda_ms(lambda: traverse.any_hit(g, so, sd, st), 20)
    k2_plain_ms = cuda_ms(lambda: traverse.any_hit_plain(g, so, sd, st), 1)
    main_ms = {}
    for name, o, d, t in full_rays:
        fn = ((lambda o=o, d=d, t=t: traverse.any_hit(g, o, d, t))
              if name == "shadow"
              else (lambda o=o, d=d, t=t: traverse.closest_hit(g, o, d, t)))
        main_ms[name] = cuda_ms(fn, 5)
        log(f"  {'K2' if name == 'shadow' else 'K1'} full {name}: "
            f"{t.numel()} rays, {main_ms[name]:.3f} ms "
            f"({t.numel() / main_ms[name] / 1e3:.1f} Mrays/s) [{card}]")
    log(f"  K1 bounce sample: kernel {k1_ms:.4f} ms vs plain {k1_plain_ms:.2f}"
        f" ms on {SAMPLE_RAYS} rays; K2 shadow sample: kernel {k2_ms:.4f} ms "
        f"vs plain {k2_plain_ms:.2f} ms [{card}]")

    hdr = Vec3(*[torch.from_numpy(rng.lognormal(-1.0, 1.5, (H, W)).astype(
        np.float32)).to(dev) for _ in range(3)])
    img_k = pipeline.tonemap_rgb8(hdr, 0.25)
    img_p = pipeline.tonemap_rgb8_plain(hdr, 0.25)
    k6_err = int((img_k.int() - img_p.int()).abs().max())
    k6_exact = float((img_k == img_p).all(-1).float().mean())
    k6_ms = cuda_ms(lambda: pipeline.tonemap_rgb8(hdr, 0.25), 50)
    k6_plain_ms = cuda_ms(lambda: pipeline.tonemap_rgb8_plain(hdr, 0.25), 10)
    log(f"  K6 {H}x{W}: max |diff| {k6_err} LSB, exact on {k6_exact:.6f} of "
        f"pixels; kernel {k6_ms:.4f} ms vs plain {k6_plain_ms:.4f} ms [{card}]")
    assert k6_err <= 1, f"K6 differs from its plain version by {k6_err} LSB"
    gather = check_row_gather(dev, full._mat_table, card, rng)

    # -- 4. the bench path at full size --------------------------------------
    del small_rays, full_rays, sampled, hdr
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()
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
    launches = dict(kernels.launches)
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
    for k in ("closest_hit", "any_hit", "tonemap_rgb8", "row_gather"):
        assert launches.get(k, 0) > 0, f"{k} was not launched by the main path"
    for r in rays:
        assert abs(r - BENCH_RAYS_PER_FRAME) <= 0.1 * BENCH_RAYS_PER_FRAME, r

    # -- 5. the balanced path at full size -----------------------------------
    from ptrt_tpu_torch.render import denoiser as den
    from ptrt_tpu_torch.render.bloom import apply_bloom
    from ptrt_tpu_torch.render.motion import motion_vectors

    bal = balanced(full)
    orbit(bal, 0)
    t0 = time.time()
    bal.render_frame()
    torch.cuda.synchronize()
    bal_first_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()
    bal_s, bal_rays = [], []
    for k in range(1, BAL_FRAMES + 1):
        orbit(bal, k)
        torch.cuda.synchronize()
        t0 = time.time()
        img = bal.render_frame()
        torch.cuda.synchronize()
        bal_s.append(time.time() - t0)
        bal_rays.append(int(bal.last_frame.rays_traced))
    bal_launches = dict(kernels.launches)
    bal_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    bal_ms = 1e3 * sum(bal_s) / len(bal_s)
    bufs, state = bal.last_frame, bal._denoiser_state
    mv = motion_vectors(bufs.depth, bal.camera, bal.prev_view_proj, W, H)
    post_ms = {
        "motion_vectors": cuda_ms(lambda: motion_vectors(
            bufs.depth, bal.camera, bal.prev_view_proj, W, H), 10),
        "svgf": cuda_ms(lambda: den.denoise_frame(bufs, mv, state), 5),
        "bloom": cuda_ms(lambda: apply_bloom(bufs.color), 10),
        "tonemap": cuda_ms(lambda: pipeline.tonemap_rgb8(bufs.color, 1.0),
                           20)}
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
    per_frame = {"closest_hit": BAL_DEPTH, "any_hit": BAL_DEPTH,
                 "row_gather": BAL_DEPTH, "svgf_temporal": 2,
                 "svgf_atrous": 7, "tonemap_rgb8": 1}
    for k, n in per_frame.items():
        assert bal_launches.get(k, 0) == n * BAL_FRAMES, (k, bal_launches)
    assert bal_launches.get("bloom_blur_down", 0) >= BAL_FRAMES
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

    # -- 6. the post kernels against their plain versions, 1080p buffers -----
    state0, prev_vp = bal._denoiser_state, bal.prev_view_proj
    orbit(bal, BAL_FRAMES + 1)
    bal.render_frame()
    post = check_post_kernels(bal, state0, prev_vp, card)
    del bufs, state, state0, mv
    torch.cuda.empty_cache()

    # -- 7. end to end on small inputs: GPU kernels vs CPU plain -------------
    cpu_sc = bench_perf(build_bench_scene(64, 48, target_tris=2000), 2, 3)
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

    src = lambda f: os.path.join("ptrt_tpu_torch", "csrc", f)
    both = lambda k: {"launches": launches.get(k, 0) + bal_launches.get(k, 0),
                      "launches_bench": launches.get(k, 0),
                      "launches_balanced": bal_launches.get(k, 0)}
    table = {"kernels": [
        {"name": "closest_hit", "route": "cuda", "source": src("traverse.cu"),
         "replaces": "ptrt_tpu/render/traverse.py:1267",
         **both("closest_hit"),
         "max_abs_err": k1["max_abs_err"], "mismatches": k1["mismatches"],
         "ms": k1_ms, "plain_ms": k1_plain_ms, "rays": SAMPLE_RAYS,
         "main_camera_ms": main_ms["camera"],
         "main_bounce_ms": main_ms["bounce"], "main_rays": W * H},
        {"name": "any_hit", "route": "cuda", "source": src("traverse.cu"),
         "replaces": "ptrt_tpu/render/traverse.py:1601",
         **both("any_hit"),
         "max_abs_err": k2["max_abs_err"], "mismatches": k2["mismatches"],
         "ms": k2_ms, "plain_ms": k2_plain_ms, "rays": SAMPLE_RAYS,
         "main_shadow_ms": main_ms["shadow"], "main_rays": W * H},
        {"name": "tonemap_rgb8", "route": "cuda", "source": src("tonemap.cu"),
         "replaces": "ptrt_tpu/render/pipeline.py:181",
         **both("tonemap_rgb8"), "max_abs_err": k6_err,
         "ms": k6_ms, "plain_ms": k6_plain_ms, "pixels": W * H},
        {"name": "row_gather", "route": "cuda", "source": src("gather.cu"),
         "replaces": "tools/probe_pallas_gather_r5.py:42",
         "also_replaces": ["tools/probe_pallas_gather2_r5.py:38,133,158",
                           "tools/prof_pallas_gather.py:79,107,138,166"],
         **both("row_gather"), "max_abs_err": 0.0,
         "ms": gather["ms"], "plain_ms": gather["plain_ms"],
         "shape": "material table, 2,073,600 ids, field-major",
         "probes": [{k: r[k] for k in ("probe", "ms", "plain_ms")}
                    for r in gather["probes"]]},
        {"name": "svgf_temporal", "route": "cuda", "source": src("svgf.cu"),
         "replaces": "ptrt_tpu/render/denoiser.py:276",
         **both("svgf_temporal"), **post["svgf_temporal"],
         "pixels": W * H},
        {"name": "svgf_atrous", "route": "cuda", "source": src("svgf.cu"),
         "replaces": "ptrt_tpu/render/denoiser.py:425",
         **both("svgf_atrous"), **post["svgf_atrous"], "pixels": W * H},
        {"name": "bloom_blur_down", "route": "cuda", "source": src("bloom.cu"),
         "replaces": "ptrt_tpu/render/bloom.py:30,47",
         **both("bloom_blur_down"), **post["bloom_blur_down"],
         "pixels": W * H},
    ]}
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
