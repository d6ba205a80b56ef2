#!/usr/bin/env python
"""Preset frame rates and warm-up times on the canonical bench scene (the
port's counterpart of the repo's ``tools/bench_presets.py``).

The reference's five presets and the "ultra ultra" settings (256 spp,
depth 32, Russian roulette from bounce 16, no post stack), each on the
bench scene of ~1M triangles at 640x360: one warm-up frame, then
``--frames`` timed ``render_frame_device`` frames, the card synchronized
after them.  The scene is built once; before each preset its settings
return to the defaults and its frame state to a fresh scene's (frame
count, PCG state, denoiser history, progressive average), so each preset
runs as on the reference's freshly built scene.

    python -m ptrt_tpu_torch.tools.bench_presets [--tris N] [--w W] [--h H]
        [--frames N] [--presets a,b,c] [--device cuda|cpu]

Prints one JSON line a preset with the reference's keys: {"preset",
"fps", "frame_ms", "compile_s" (the warm-up frame), "render_size": [h, w],
"tris"}, and "rays_per_frame_M" (the last frame's rays) and the card's
name and power limit.  Any failure raises.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ptrt_tpu_torch.app.bench_scene import build_bench_scene
from ptrt_tpu_torch.app.demo import card_line
from ptrt_tpu_torch.scene.pt_scene import PerformanceSettings

PRESETS = ["fast", "performance", "balanced", "quality", "ultra",
           "ultra_ultra"]


def apply_preset(sc, name: str) -> None:
    """The reference's ``apply_preset``: a ``Scene`` preset, or the
    "ultra ultra" settings (raw 256 spp, depth 32, no post)."""
    if name == "ultra_ultra":
        p = sc.perf
        p.enable_denoiser = False
        p.enable_bloom = False
        p.enable_motion_vectors = False
        p.samples_per_pixel = 256
        p.max_bounce_depth = 32
        p.resolution_scale = 1.0
        p.russian_roulette_start_bounce = 16
    else:
        sc.set_performance_preset(name)


def fresh_state(sc) -> None:
    """The scene's settings and frame state as a newly built scene's."""
    sc.perf = PerformanceSettings()
    sc.frame_count = 0
    sc._rng_state = None
    sc._denoiser_state = None
    sc._accum = None
    sc._accum_view_proj = None
    sc.prev_view_proj = sc.camera.get_view_proj()
    sc.last_frame = None


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(sc, preset: str, frames: int) -> dict:
    """One preset on the prepared scene ``sc``: its result line."""
    fresh_state(sc)
    apply_preset(sc, preset)
    n_tris = sum(m.num_triangles for m in sc.meshes)
    sc._ensure_device_state()
    dev = sc.device
    _sync(dev)
    t0 = time.perf_counter()
    sc.render_frame_device()
    _sync(dev)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(frames):
        sc.render_frame_device()
    _sync(dev)
    dt = time.perf_counter() - t0
    rh, rw = sc.render_size
    return {"preset": preset, "fps": round(frames / dt, 3),
            "frame_ms": round(dt / frames * 1e3, 3),
            "compile_s": round(compile_s, 3), "render_size": [rh, rw],
            "tris": n_tris,
            "rays_per_frame_M": round(int(sc.last_frame.rays_traced) / 1e6,
                                      3),
            "card": card_line(dev)}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tris", type=int, default=1_000_000)
    ap.add_argument("--w", type=int, default=640)
    ap.add_argument("--h", type=int, default=360)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--presets", type=str, default=",".join(PRESETS))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    sc = build_bench_scene(args.w, args.h, target_tris=args.tris,
                           device=args.device)
    out = []
    for preset in args.presets.split(","):
        line = run(sc, preset, args.frames)
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


if __name__ == "__main__":
    main()
