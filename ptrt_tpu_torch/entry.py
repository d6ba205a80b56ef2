"""The product frame as one function, and its capture: the port's
counterpart of ``__graft_entry__.entry``.

``entry()`` returns ``(fn, example_args)``: ``fn(rng_state, den_state,
frame_idx) -> (rgb8, rng_state, den_state)`` is the balanced pipeline
(split-channel trace, motion vectors, SVGF, bloom, tonemap) on the bench
scene at 4,000 triangles, 320x180, 2 spp, depth 4, with ``frame_idx`` a
0-d int32 tensor on the scene's device.  ``capture(fn, args)``
(``graphs.capture``) is what ``jax.jit(fn)`` is in the reference: on the
card it records the frame once as a CUDA graph and each call replays it.

    python -m ptrt_tpu_torch.entry [--cpu] [--devices N]

runs one captured frame and then ``parallel.dryrun.dryrun_multichip``.
"""

from __future__ import annotations

import argparse

import torch

from ptrt_tpu_torch.app.bench_scene import build_bench_scene
from ptrt_tpu_torch.graphs import capture
from ptrt_tpu_torch.parallel.dryrun import dryrun_multichip
from ptrt_tpu_torch.render import pipeline as pl
from ptrt_tpu_torch.render.bloom import apply_bloom
from ptrt_tpu_torch.render.denoiser import denoise_frame, init_denoiser_state
from ptrt_tpu_torch.render.motion import motion_vectors

__all__ = ["capture", "entry"]

WIDTH, HEIGHT, SPP, DEPTH, TRIS = 320, 180, 2, 4, 4_000


def entry(width: int = WIDTH, height: int = HEIGHT, tris: int = TRIS,
          device="cuda"):
    """(fn, example_args): the balanced frame at ``width`` x ``height``
    on the bench scene of ``tris`` triangles, ``SPP`` spp and depth
    ``DEPTH`` (the reference's sizes by default; a test passes smaller
    ones), its tables closed over.  ``example_args``: the scene's seeded
    PCG state, a fresh denoiser history and frame index 0 (int32) on
    ``device``."""
    sc = build_bench_scene(width, height, target_tris=tris, device=device)
    sc._ensure_device_state()
    n_lights = len(sc.lights)
    geom, mats, lights = sc._geom, sc._mat_table, sc._light_table
    sky, camera, bn = sc.sky(), sc.camera, sc._blue_noise
    prev_vp = camera.get_view_proj()
    den0 = init_denoiser_state(height, width, sc.device)

    def fn(rng_state, den_state, frame_idx):
        state, bufs = pl.trace_frame(
            geom, mats, lights, n_lights, sky, camera, rng_state, frame_idx,
            width, height, SPP, DEPTH, bn, split=True)
        mv = motion_vectors(bufs.depth, camera, prev_vp, width, height)
        color, den_state = denoise_frame(bufs, mv, den_state, camera,
                                         frame_idx)
        rgb8 = pl.tonemap_to_rgb8(apply_bloom(color))
        return rgb8, state, den_state

    return fn, (sc._rng_state, den0,
                torch.zeros((), dtype=torch.int32, device=sc.device))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--devices", type=int, default=8,
                    help="tiles of the dry run's pixel mesh")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    fn, example = entry(device=device)
    out = capture(fn, example)(*example)
    if device == "cuda":
        torch.cuda.synchronize()
    print("entry ok:", tuple(out[0].shape))
    dryrun_multichip(args.devices, device)


if __name__ == "__main__":
    main()
