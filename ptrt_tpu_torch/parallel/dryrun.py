"""The multi-device dry run: one fused step of a frame over a pixel mesh.

Counterpart of ``__graft_entry__.dryrun_multichip``, which jits a camera
step fused with the sharded split trace, SVGF, bloom and the tonemap on an
n-device mesh and runs it once on tiny shapes.  Here the step is eager: the
camera moves on the host, the trace runs tile by tile over the mesh
(``parallel.sharding``), and the post stack runs whole on the mesh's first
device (``Scene.render_world(mesh=)``).

    python -m ptrt_tpu_torch.parallel.dryrun [N] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ptrt_tpu_torch.app.bench_scene import build_bench_scene
from ptrt_tpu_torch.parallel.sharding import make_pixel_mesh
from ptrt_tpu_torch.scene.camera import Camera

SMALL_TRIS = 4_000  # the reference dry run's bench scene


def _small_scene(w: int, h: int, device):
    """The bench scene at 4,000 triangles, 1 spp, depth 3, full resolution,
    with the denoiser, motion vectors and bloom on (the reference's
    ``_frame_fn(..., 1, 3, True, True)``)."""
    sc = build_bench_scene(w, h, target_tris=SMALL_TRIS, device=device)
    sc.perf.enable_denoiser = True
    sc.perf.enable_motion_vectors = True
    sc.perf.enable_bloom = True
    sc.perf.samples_per_pixel = 1
    sc.perf.max_bounce_depth = 3
    sc.perf.resolution_scale = 1.0
    sc._ensure_device_state()
    return sc


def dryrun_multichip(n_devices: int, device: str = "cuda") -> np.ndarray:
    """Build an ``n_devices``-tile pixel mesh (cards, round-robin past the
    card count, each tile on its own stream; ``device="cpu"``: n CPU
    tiles), one camera step at t = 1/60 s, then the frame at (16 dx) x
    (8 dy) with its trace over the mesh; prints the reference's line and
    returns the (h, w, 3) uint8 frame."""
    devices = [device] * n_devices if device == "cpu" else None
    mesh = make_pixel_mesh(n_devices, devices=devices)
    dy, dx = mesh.shape
    h, w = 8 * dy, 16 * dx
    sc = _small_scene(w, h, mesh.first_device)
    prev_vp = sc.camera.get_view_proj()

    # the game step: the camera's orbit at t = 1/60 s, float32 as the
    # reference's jitted step computes it
    f32 = np.float32
    game_t = f32(0.0) + f32(1.0 / 60.0)
    angle = game_t * f32(0.5)
    eye = (float(np.sin(angle) * f32(1.5)),
           float(f32(1.2) + f32(0.2) * np.sin(game_t)),
           float(f32(-1.5) + np.cos(angle) * f32(0.3)))
    camera = Camera.make(eye, (0.0, 0.0, 6.0), (0.0, 1.0, 0.0), 60.0, w / h,
                         device=mesh.first_device)
    rgb8 = sc.render_world(sc._geom, camera, 0, prev_vp, mesh=mesh)
    img = rgb8.cpu().numpy()
    assert img.shape == (h, w, 3), img.shape
    print(f"dryrun_multichip ok: mesh {dy}x{dx}, frame {img.shape}, "
          f"mean {img.mean():.1f}")
    return img


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", nargs="?", type=int, default=8)
    ap.add_argument("--cpu", action="store_true",
                    help="tiles on the CPU (the kernels' plain versions)")
    a = ap.parse_args(argv)
    dryrun_multichip(a.n_devices, "cpu" if a.cpu else "cuda")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
