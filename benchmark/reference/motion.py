"""Motion vectors for temporal reprojection — counterpart of
``ptrt_tpu/render/motion.py``: each pixel's world position from the pinhole
camera ray and its linear depth, reprojected through the previous frame's
view-projection, as a uv-space delta.

A frozen copy of the plain version in ``ptrt_tpu_torch/render/motion.py``
(``motion_vectors_plain``), which the benchmark's reference runs on every
device.
"""

from __future__ import annotations

import torch

from benchmark.reference import mat as m4
from benchmark.reference.camera import Camera, pixel_grid

# the motion vectors' sky threshold; the denoiser's is 1e9
SKY_DEPTH_THRESHOLD = 1e29


def motion_vectors_plain(depth: torch.Tensor, camera: Camera,
                         prev_view_proj: torch.Tensor, width: int,
                         height: int):
    """Plain version of K7 (``motion.motion_vectors``)."""
    s, t = pixel_grid(width, height, depth.device)
    ray = camera.get_ray_simple(s, t)
    world = ray.origin + ray.direction * depth
    ndc, w = m4.project_point(prev_view_proj, world)
    # current uv - previous uv; t is bottom-up, as across the pipeline
    mx = s - (ndc.x * 0.5 + 0.5)
    my = t - (ndc.y * 0.5 + 0.5)
    valid = (depth < SKY_DEPTH_THRESHOLD) & (w > 0.0)
    return torch.where(valid, mx, 0.0), torch.where(valid, my, 0.0)
