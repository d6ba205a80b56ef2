"""Motion vectors for temporal reprojection — counterpart of
``ptrt_tpu/render/motion.py``: each pixel's world position from the pinhole
camera ray and its linear depth, reprojected through the previous frame's
view-projection, as a uv-space delta.

``motion_vectors`` launches the hand-written K7 kernel (``csrc/motion.cu``)
for CUDA tensors and runs its plain version, ``motion_vectors_plain``, for
CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ptrt_tpu_torch import kernels
from ptrt_tpu_torch.core import mat as m4
from ptrt_tpu_torch.scene.camera import Camera, pixel_grid

# the motion vectors' sky threshold; the denoiser's is 1e9
SKY_DEPTH_THRESHOLD = 1e29

_P3 = ctypes.c_void_p * 3


class MotionArgs(kernels.Args):
    """``struct MotionArgs`` of ``csrc/motion.cu``."""

    _fields_ = [
        ("depth", ctypes.c_void_p), ("origin", _P3), ("llc", _P3),
        ("horizontal", _P3), ("vertical", _P3),
        ("view_proj", ctypes.c_void_p), ("mx", ctypes.c_void_p),
        ("my", ctypes.c_void_p), ("h", ctypes.c_int), ("w", ctypes.c_int),
        ("sky_depth", ctypes.c_float),
    ]


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


def motion_vectors(depth: torch.Tensor, camera: Camera,
                   prev_view_proj: torch.Tensor, width: int, height: int):
    """Returns (mx, my) uv-space motion, each (H, W); zero on sky pixels
    and where the point lies behind the previous camera (K7)."""
    dev = depth.device
    kernels.require_supported(dev)
    if dev.type == "cpu":
        return motion_vectors_plain(depth, camera, prev_view_proj, width,
                                    height)
    kernels.check_tensor("depth", depth, torch.float32, 2, dev)
    if tuple(depth.shape) != (height, width):
        raise ValueError(f"depth {tuple(depth.shape)} is not the "
                         f"{height}x{width} frame")
    kernels.check_tensor("prev_view_proj", prev_view_proj, torch.float32, 2,
                         dev)
    if tuple(prev_view_proj.shape) != (4, 4):
        raise ValueError(f"prev_view_proj: shape "
                         f"{tuple(prev_view_proj.shape)}, expected (4, 4)")
    out = torch.empty((2, height, width), dtype=torch.float32, device=dev)
    a = MotionArgs()
    a.depth = depth.data_ptr()
    a.origin = _P3(*kernels.vec_ptrs("camera.origin", camera.origin, dev))
    a.llc = _P3(*kernels.vec_ptrs("camera.lower_left_corner",
                                  camera.lower_left_corner, dev))
    a.horizontal = _P3(*kernels.vec_ptrs("camera.horizontal",
                                         camera.horizontal, dev))
    a.vertical = _P3(*kernels.vec_ptrs("camera.vertical", camera.vertical,
                                       dev))
    a.view_proj = prev_view_proj.data_ptr()
    a.mx, a.my = out[0].data_ptr(), out[1].data_ptr()
    a.h, a.w = height, width
    a.sky_depth = SKY_DEPTH_THRESHOLD
    rc = kernels.get_lib().ptrt_motion_vectors(ctypes.addressof(a),
                                               kernels.stream_ptr(dev))
    kernels.launches["motion_vectors"] += 1
    kernels.check(rc, "motion_vectors")
    return out[0], out[1]
