#!/usr/bin/env python
"""The port's benchmark harness — prints ONE JSON line (counterpart of the
repo's ``bench.py``, which runs the JAX package).

Metric: Mrays/s on the canonical bench scene (``app/bench_scene.py``),
counting every traced ray (camera, bounce and NEE shadow rays, from each
frame's ``rays_traced``), and frames a second, at the reference's
interactive configuration: 1920x1080, 4 spp, depth 4, ~1M triangles, the
trace-only frame (no denoiser, bloom or motion vectors), 4 timed frames
after one warm-up frame.  The frame is a program kept per (spp, depth,
camera NEE), as the reference's jitted ``_trace_only``: on the card the
warm-up frame captures it into a CUDA graph and each timed frame (and
each phase probe's) is one replay.  ``vs_baseline`` is Mrays/s over the reference's
north-star target of 1000 Mrays/s.

    python -m ptrt_tpu_torch.bench [--device cuda|cpu]

On the card by default; ``--device cpu`` runs the kernels' plain versions
at 256x144 and 20k triangles.  Env overrides: PTRT_BENCH_W/H,
PTRT_BENCH_SPP, PTRT_BENCH_DEPTH, PTRT_BENCH_TRIS, PTRT_BENCH_FRAMES, and
PTRT_BENCH_PHASES=0 to skip the phase probes.  ``extra`` holds the
reference's keys (fps, platform, setup_s, compile_s: the warm-up frame,
frames, rays_per_frame in millions, retried: always false, phases) and the
kernels' nvcc build time, the card's name and power limit, the torch and
CUDA versions, whether nvcc and triton are present, and each timed
frame's exact ray count.  Any failure raises: the process exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import time

import numpy as np
import torch

from ptrt_tpu_torch import graphs, kernels
from ptrt_tpu_torch.app.bench_scene import build_bench_scene
from ptrt_tpu_torch.app.demo import card_line
from ptrt_tpu_torch.build import BuildError
from ptrt_tpu_torch.render import pipeline as pl
from ptrt_tpu_torch.scene.pt_scene import frame_camera, program_world

BASELINE_MRAYS = 1000.0
# (width, height, triangles) by device type; spp, depth and frames alike
DEFAULT_SIZE = {"cuda": (1920, 1080, 1_000_000), "cpu": (256, 144, 20_000)}
SPP, DEPTH, FRAMES = 4, 4, 4
# the roofline anchors' sizes: the copy's buffer and the gathered rows
ANCHOR_BYTES = {"cuda": 256 << 20, "cpu": 16 << 20}
GATHER_ROWS = {"cuda": 1 << 20, "cpu": 1 << 16}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def configure(sc, spp: int, depth: int) -> None:
    """The bench settings: the post stack off, ``spp`` and ``depth``, full
    resolution."""
    sc.perf.enable_denoiser = False
    sc.perf.enable_bloom = False
    sc.perf.enable_motion_vectors = False
    sc.perf.samples_per_pixel = spp
    sc.perf.max_bounce_depth = depth
    sc.perf.resolution_scale = 1.0


def _trace_body(n_lights: int, spp: int, depth: int, camera_nee: bool):
    """The trace-only program's body: the trace of the staged frame index
    from the frame's camera (``pt_scene.frame_camera``); returns
    (FrameBuffers, the new PCG state)."""
    def body(reads, st, values):
        index, cam_in = values
        cam = frame_camera(reads, cam_in)
        rng = st["rng"]
        rng, bufs = pl.trace_frame(
            program_world(reads), reads["mats"], reads["lights"], n_lights,
            reads["sky"], cam, rng, index, rng.shape[1],
            rng.shape[0], spp, depth, reads["bn"], camera_nee=camera_nee)
        return bufs, {"rng": rng}
    return body


def trace_only(sc, frame_index: int, spp: int, depth: int,
               camera_nee: bool = True):
    """The reference's ``_trace_only`` frame of the scene's tables (the
    trace, no post stack) at ``frame_index``, as a program the scene keeps
    per (spp, depth, camera_nee; the camera's form) and the shapes it reads
    and carries: on the card captured at its first frame and replayed
    after.  Advances the scene's PCG state (afterwards the program's
    buffer) and returns the FrameBuffers (on the card the program's, which
    its next frame overwrites)."""
    reads = sc._frame_reads()
    world = graphs.signature(reads)
    key, reads, first, values = sc._with_camera(
        ("trace_only", spp, depth, camera_nee, len(sc.lights),
         tuple(sc._rng_state.shape)), reads, (0,), (int(frame_index),))
    prog = sc._program(key, world, lambda: graphs.Program(
        _trace_body(len(sc.lights), spp, depth, camera_nee), reads,
        {"rng": sc._rng_state}, first, sc.device, edited=("set_geom",)))
    bufs = prog.run(reads, {"rng": sc._rng_state}, values)
    sc._rng_state = prog.state["rng"]
    return bufs


def run_measured(sc, spp: int, depth: int, frames: int):
    """One warm-up frame (index 0, which makes the program), then
    ``frames`` timed ones, the PCG state carried: (warm-up s, timed s, each
    timed frame's rays).  The ray counts stay on the card until the timing
    ends."""
    dev = sc.device
    t0 = time.perf_counter()
    trace_only(sc, 0, spp, depth)
    _sync(dev)
    compile_s = time.perf_counter() - t0
    rays = []
    t0 = time.perf_counter()
    for i in range(frames):
        rays.append(trace_only(sc, i + 1, spp, depth).rays_traced.clone())
    _sync(dev)
    dt = time.perf_counter() - t0
    return compile_s, dt, [int(r) for r in rays]


def _time_fn(call, device, frames: int = 2) -> float:
    """Seconds a call of ``call(i)`` over ``frames`` calls after one
    warm-up call, the card synchronized before and after."""
    call(0)
    _sync(device)
    t0 = time.perf_counter()
    for i in range(frames):
        call(i + 1)
    _sync(device)
    return (time.perf_counter() - t0) / frames


def phase_probes(sc, depth: int) -> dict:
    """The reference's per-phase ladder of spp-1 trace-only frames (depth 1
    without the camera's NEE, depth 1, depth 2, ``depth``), differenced
    into camera, camera NEE, bounce 1 and deeper bounces, and the roofline
    anchors: an ``x + 1`` over a float32 buffer (read and write: the
    practical memory rate) and ``index_select`` of random rows of the
    scene's BVH8 node table (the walks' currency)."""
    dev = sc.device
    kind = dev.type

    def trace_ms(d: int, camera_nee: bool = True) -> float:
        return 1e3 * _time_fn(lambda i: trace_only(
            sc, 1000 + i, 1, d, camera_nee), dev)

    d1n = trace_ms(1, camera_nee=False)
    d1 = trace_ms(1)
    d2 = trace_ms(min(2, depth))
    dfull = trace_ms(depth) if depth > 2 else d2
    phases = {"spp1_camera_ms": round(d1n, 3),
              "spp1_camera_nee_ms": round(max(d1 - d1n, 0.0), 3),
              "spp1_bounce1_ms": round(max(d2 - d1, 0.0), 3),
              "spp1_deep_bounces_ms": round(max(dfull - d2, 0.0), 3),
              "spp1_total_ms": round(dfull, 3)}

    big = torch.zeros(ANCHOR_BYTES[kind] // 4, dtype=torch.float32,
                      device=dev)
    dt = _time_fn(lambda i: big + 1.0, dev)
    phases["hbm_copy_gbps"] = round(2 * big.numel() * 4 / dt / 1e9, 1)
    phases["hbm_copy_mb"] = ANCHOR_BYTES[kind] >> 20
    del big

    g = sc._geom
    rows = (g.static if hasattr(g, "static") else g).node_rows
    n = GATHER_ROWS[kind]
    idx = torch.from_numpy(np.random.default_rng(0).integers(
        0, rows.shape[0], n).astype(np.int64)).to(dev)
    dt = _time_fn(lambda i: torch.index_select(rows, 0, idx), dev)
    phases["gather_ns_idx"] = round(dt / n * 1e9, 3)
    phases["gather_gbps"] = round(n * rows.shape[1] * 4 / dt / 1e9, 1)
    phases["gather_rows"] = n
    phases["node_row_bytes"] = rows.shape[1] * 4
    return phases


def environment(device) -> dict:
    """The card's name and power limit (``nvidia-smi``), the torch and CUDA
    versions, and whether nvcc and triton are present."""
    try:
        kernels.nvcc_path()
        nvcc = True
    except BuildError:
        nvcc = False
    card = card_line(device)
    name, _, limit = card.rpartition(", ")
    return {"card": card, "device_name": name or card,
            "power_limit": limit if name else None,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "nvcc": nvcc,
            "triton": importlib.util.find_spec("triton") is not None}


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def settings(device) -> dict:
    """The run's size: the device's defaults under the env overrides."""
    w, h, tris = DEFAULT_SIZE[device.type]
    return {"w": _env_int("PTRT_BENCH_W", w), "h": _env_int("PTRT_BENCH_H", h),
            "spp": _env_int("PTRT_BENCH_SPP", SPP),
            "depth": _env_int("PTRT_BENCH_DEPTH", DEPTH),
            "tris": _env_int("PTRT_BENCH_TRIS", tris),
            "frames": _env_int("PTRT_BENCH_FRAMES", FRAMES),
            "phases": bool(_env_int("PTRT_BENCH_PHASES", 1))}


def bench(device="cuda", scene=None) -> dict:
    """The benchmark's result line as a dict.  ``scene``: a bench scene of
    the run's size to measure instead of building one (its set-up then
    reported as 0)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: no CUDA device here; pass --device cpu")
    cfg = settings(device)
    t0 = time.perf_counter()
    if device.type == "cuda":
        kernels.get_lib()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sc = scene if scene is not None else build_bench_scene(
        cfg["w"], cfg["h"], target_tris=cfg["tris"], device=device)
    configure(sc, cfg["spp"], cfg["depth"])
    if (sc.width, sc.height) != (cfg["w"], cfg["h"]):
        raise ValueError(f"the scene is {sc.width}x{sc.height}, the run "
                         f"{cfg['w']}x{cfg['h']}")
    n_tris = sum(m.num_triangles for m in sc.meshes)
    sc._ensure_device_state()
    _sync(device)
    setup_s = 0.0 if scene is not None else time.perf_counter() - t0

    compile_s, dt, rays = run_measured(sc, cfg["spp"], cfg["depth"],
                                       cfg["frames"])
    phases = phase_probes(sc, cfg["depth"]) if cfg["phases"] else None
    frames = cfg["frames"]
    total = float(sum(rays))
    mrays = total / dt / 1e6
    extra = {
        "fps": round(frames / dt, 2),
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "setup_s": round(setup_s, 2),
        "compile_s": round(compile_s, 3),
        "frames": frames,
        "rays_per_frame": round(total / frames / 1e6, 2),
        "retried": False,
        "build_s": round(build_s, 2),
        **environment(device),
        "rays_traced": rays,
        "frame_ms": round(dt / frames * 1e3, 3),
    }
    if phases is not None:
        extra["phases"] = phases
    return {
        "metric": "Mrays/s (all traced rays, showcase scene, %dx%d@%dspp "
                  "d%d, %d tris)" % (cfg["w"], cfg["h"], cfg["spp"],
                                     cfg["depth"], n_tris),
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 4),
        "extra": extra,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    print(json.dumps(bench(args.device)), flush=True)


if __name__ == "__main__":
    main()
