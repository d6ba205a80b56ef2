#!/usr/bin/env python3
"""The port's main path on one GPU, end to end — the quickest proof that
ptrt_tpu_torch still starts on the card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. environment: card name and power limit, torch / CUDA / nvcc versions;
  2. build: the CUDA kernels (nvcc) and the native BVH builder (g++), from
     the checkout's sources;
  3. every kernel of the main path against its plain torch version on the
     card, on the inputs the path gives it: K1 closest_hit and K2 any_hit on
     a full 256x144 frame of camera, bounce and shadow rays over a ~20k
     triangle bench scene and on a 4096-ray sample of the full scene; K6
     tonemap_rgb8 on a 1920x1080 HDR frame;
  4. the main path: Scene.render_frame() on the bench scene at 1920x1080,
     4 spp, depth 4, ~1M triangles — one warm-up and three timed frames,
     with the kernels' launch counts taken over exactly that run;
  5. end to end on a small input: the same frame rendered on the GPU and on
     the CPU (plain versions) must agree.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Without a GPU, or outside the repository,
the script fails.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

W, H, SPP, DEPTH, TRIS = 1920, 1080, 4, 4, 1_000_000
BENCH_RAYS_PER_FRAME = 20.59e6  # the reference's count for this config
SAMPLE_RAYS = 4096
K1_K2_AGREE = 0.9999


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

    # -- 4. the main path at full size ---------------------------------------
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
    for k in ("closest_hit", "any_hit", "tonemap_rgb8"):
        assert launches.get(k, 0) > 0, f"{k} was not launched by the main path"
    for r in rays:
        assert abs(r - BENCH_RAYS_PER_FRAME) <= 0.1 * BENCH_RAYS_PER_FRAME, r

    # -- 5. end to end on a small input: GPU kernels vs CPU plain ------------
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

    src = lambda f: os.path.join("ptrt_tpu_torch", "csrc", f)
    table = {"kernels": [
        {"name": "closest_hit", "route": "cuda", "source": src("traverse.cu"),
         "replaces": "ptrt_tpu/render/traverse.py:1267",
         "launches": launches["closest_hit"],
         "max_abs_err": k1["max_abs_err"], "mismatches": k1["mismatches"],
         "ms": k1_ms, "plain_ms": k1_plain_ms, "rays": SAMPLE_RAYS,
         "main_camera_ms": main_ms["camera"],
         "main_bounce_ms": main_ms["bounce"], "main_rays": W * H},
        {"name": "any_hit", "route": "cuda", "source": src("traverse.cu"),
         "replaces": "ptrt_tpu/render/traverse.py:1601",
         "launches": launches["any_hit"],
         "max_abs_err": k2["max_abs_err"], "mismatches": k2["mismatches"],
         "ms": k2_ms, "plain_ms": k2_plain_ms, "rays": SAMPLE_RAYS,
         "main_shadow_ms": main_ms["shadow"], "main_rays": W * H},
        {"name": "tonemap_rgb8", "route": "cuda", "source": src("tonemap.cu"),
         "replaces": "ptrt_tpu/render/pipeline.py:181",
         "launches": launches["tonemap_rgb8"], "max_abs_err": k6_err,
         "ms": k6_ms, "plain_ms": k6_plain_ms, "pixels": W * H},
    ]}
    print(json.dumps(table), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
