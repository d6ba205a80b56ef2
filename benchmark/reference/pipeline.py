"""The frame's camera rays and tonemap in plain torch: a frozen copy of
the plain versions in ``ptrt_tpu_torch/render/pipeline.py``
(``camera_rays_plain``, taken here over any list of pixels, and
``tonemap_rgb8_plain``), which the benchmark's reference runs on every
device.  ``MAX_FINAL_RADIANCE`` is the sample sums' final clamp."""

from __future__ import annotations

import torch

from benchmark.reference import bloom as bloom_mod
from benchmark.reference import rng as prng
from benchmark.reference.bluenoise import next_blue_noise
from benchmark.reference.color import aces_tonemap, srgb_oetf, to_rgb8
from benchmark.reference.taa import taa_jitter
from benchmark.reference.vec import Vec3, clamp_vector_soft

MAX_FINAL_RADIANCE = 100.0


def camera_rays_plain(camera, rng_state: torch.Tensor, frame_index,
                      sample: int, blue_noise_tbl: torch.Tensor, ys, xs,
                      size: tuple):
    """The jittered camera rays of ``sample`` through pixels (``ys``,
    ``xs``) (integer tensors of one shape, ``rng_state`` theirs) of a frame
    of ``size`` (height, width): (the sample's PCG sub-state, RayBatch)."""
    full_h, full_w = size
    # the frame's jitter and blue-noise rotation: from a host index as host
    # numbers (no copy to the card), from a device index on the card
    fidx = (frame_index + sample if torch.is_tensor(frame_index)
            else int(frame_index) + sample)
    jx_t, jy_t = taa_jitter(fidx)
    bx, by = next_blue_noise(blue_noise_tbl, xs, ys, fidx)
    jitter_x = jx_t + (bx - 0.5) * 0.25
    jitter_y = jy_t + (by - 0.5) * 0.25
    # global pixel coords -> camera uv, bottom-up
    sg = (xs.to(torch.float32) + 0.5 + jitter_x) / float(full_w)
    tg = (ys.to(torch.float32) + 0.5 + jitter_y) / float(full_h)
    sub = prng.fold(rng_state, sample + 1)
    return camera.get_ray(sg, tg, sub)


def tonemap_rgb8_plain(hdr: Vec3, scale: float,
                       bloom: Vec3 | None = None) -> torch.Tensor:
    """Plain version of K6 (``pipeline.tonemap_to_rgb8``), after
    ``hdr + up(bloom)`` where ``bloom`` is given."""
    if bloom is not None:
        hdr = hdr + bloom_mod.upsample_bilinear(bloom, *hdr.x.shape)
    c = aces_tonemap(hdr * scale)
    return to_rgb8(srgb_oetf(c)).flip(0)
