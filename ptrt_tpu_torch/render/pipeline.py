"""The per-frame trace and the K6 tonemap wrapper.

Counterpart of ``ptrt_tpu/render/pipeline.py``: ``trace_frame`` generates
jittered camera rays (TAA + blue noise, one PCG sub-stream per sample),
runs the integrator and averages the samples; ``tonemap_to_rgb8`` turns HDR
into the display image through the hand-written ``csrc/tonemap.cu`` kernel
(K6) for CUDA tensors, or its plain version for CPU tensors.

Each sample is traced as its own (H, W) wavefront.  Every lane's arithmetic
depends only on its own pixel and sample, so the result is the same as the
reference's single (spp, H, W) wavefront.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ptrt_tpu_torch import kernels
from ptrt_tpu_torch.core import rng as prng
from ptrt_tpu_torch.core.bluenoise import next_blue_noise
from ptrt_tpu_torch.core.color import aces_tonemap, srgb_oetf, to_rgb8
from ptrt_tpu_torch.core.taa import taa_jitter
from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.render.integrator import trace_path


class FrameBuffers(NamedTuple):
    """Per-frame HDR radiance (mean over spp) + the sample-0 G-buffer."""

    color: Vec3
    normal: Vec3
    depth: torch.Tensor
    object_id: torch.Tensor
    roughness: torch.Tensor
    transmission: torch.Tensor
    rays_traced: torch.Tensor  # int64 scalar (all spp)


def camera_rays(camera, rng_state: torch.Tensor, frame_index: int,
                sample: int, blue_noise_tbl: torch.Tensor):
    """Jittered primary rays of one sample over the (H, W) pixel grid of
    ``rng_state``, each with its own PCG sub-stream.  Returns
    (sub_state, RayBatch)."""
    dev = rng_state.device
    height, width = rng_state.shape
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    fidx = torch.tensor(frame_index + sample, dtype=torch.int64, device=dev)
    jx_t, jy_t = taa_jitter(fidx)
    bx, by = next_blue_noise(blue_noise_tbl, xs, ys, fidx)
    jitter_x = jx_t + (bx - 0.5) * 0.25
    jitter_y = jy_t + (by - 0.5) * 0.25
    # pixel coords -> camera uv, bottom-up
    sg = (xs.to(torch.float32) + 0.5 + jitter_x) / float(width)
    tg = (ys.to(torch.float32) + 0.5 + jitter_y) / float(height)
    sub = prng.fold(rng_state, sample + 1)
    return camera.get_ray(sg, tg, sub)


def trace_frame(geom, materials, lights, n_lights: int, sky, camera,
                rng_state: torch.Tensor, frame_index: int, width: int,
                height: int, spp: int, max_depth: int,
                blue_noise_tbl: torch.Tensor, rr_enabled: bool = True,
                rr_start: int = 2, camera_nee: bool = True):
    """One frame of ``spp`` samples.  Returns (rng_state, FrameBuffers)."""
    dev = rng_state.device
    if tuple(rng_state.shape) != (height, width):
        raise ValueError(f"rng_state {tuple(rng_state.shape)} does not match "
                         f"the {height}x{width} frame")
    color = None
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(spp):
        sub, ray = camera_rays(camera, rng_state, frame_index, s,
                               blue_noise_tbl)
        _, out = trace_path(geom, materials, lights, n_lights, sky, ray, sub,
                            max_depth, rr_enabled=rr_enabled,
                            rr_start=rr_start, camera_nee=camera_nee)
        color = out.radiance if color is None else color + out.radiance
        rays = rays + out.rays_traced
        if s == 0:
            first = out
    # the persistent per-pixel stream advances once per frame
    state, _ = prng.uniform(rng_state)
    return state, FrameBuffers(
        color=color * (1.0 / float(spp)), normal=first.first_normal,
        depth=first.first_depth, object_id=first.first_object_id,
        roughness=first.first_roughness,
        transmission=first.first_transmission, rays_traced=rays)


# -- K6 ----------------------------------------------------------------------


def tonemap_rgb8(hdr: Vec3, scale: float) -> torch.Tensor:
    """(H, W) float32 HDR planes, times ``scale`` -> ACES -> exact sRGB OETF
    -> uint8 -> Y-flip.  Returns (H, W, 3) uint8."""
    dev = hdr.x.device
    kernels.require_supported(dev)
    for name, c in (("hdr.x", hdr.x), ("hdr.y", hdr.y), ("hdr.z", hdr.z)):
        kernels.check_tensor(name, c, torch.float32, 2, dev)
        if c.shape != hdr.x.shape:
            raise ValueError(f"{name}: shape {tuple(c.shape)} != "
                             f"{tuple(hdr.x.shape)}")
    if dev.type == "cpu":
        return tonemap_rgb8_plain(hdr, scale)
    h, w = hdr.x.shape
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=dev)
    rc = kernels.get_lib().ptrt_tonemap_rgb8(
        hdr.x.data_ptr(), hdr.y.data_ptr(), hdr.z.data_ptr(), h, w,
        float(scale), out.data_ptr(), kernels.stream_ptr(dev))
    kernels.launches["tonemap_rgb8"] += 1
    kernels.check(rc, "tonemap_rgb8")
    return out


def tonemap_rgb8_plain(hdr: Vec3, scale: float) -> torch.Tensor:
    """Plain version of K6 (``pipeline.tonemap_to_rgb8``)."""
    c = aces_tonemap(hdr * scale)
    return to_rgb8(srgb_oetf(c)).flip(0)


def tonemap_to_rgb8(hdr: Vec3, total_samples: int = 1) -> torch.Tensor:
    """Average over ``total_samples``, tonemap, quantize, Y-flip (K6)."""
    return tonemap_rgb8(hdr, 1.0 / float(total_samples))
