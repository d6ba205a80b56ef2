"""The per-frame trace, the upscale and the K6 tonemap wrapper.

Counterpart of ``ptrt_tpu/render/pipeline.py``: ``trace_frame`` generates
jittered camera rays (TAA + blue noise, one PCG sub-stream per sample),
runs the integrator and averages the samples (and, with ``split``, the
denoiser's diffuse/specular/emission channels); ``upscale_bilinear`` is
``jax.image.resize(..., "bilinear")`` in plain torch; ``tonemap_to_rgb8``
turns HDR into the display image through the hand-written
``csrc/tonemap.cu`` kernel (K6) for CUDA tensors, or its plain version for
CPU tensors; given the bloom chain's mip 0, K6 first adds its upsample to
the image (the last step of ``bloom.apply_bloom``).

Each sample is traced as its own (H, W) wavefront.  Every lane's arithmetic
depends only on its own pixel and sample, so the result is the same as the
reference's single (spp, H, W) wavefront.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ptrt_tpu_torch import kernels
from ptrt_tpu_torch.core import rng as prng
from ptrt_tpu_torch.core.bluenoise import next_blue_noise
from ptrt_tpu_torch.core.color import aces_tonemap, srgb_oetf, to_rgb8
from ptrt_tpu_torch.core.taa import taa_jitter
from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.render import bloom as bloom_mod
from ptrt_tpu_torch.render.integrator import trace_path


class FrameBuffers(NamedTuple):
    """Per-frame HDR radiance (mean over spp), the split channels (None
    unless traced with ``split``) and the sample-0 G-buffer."""

    color: Vec3
    diffuse: Vec3 | None
    specular: Vec3 | None
    emission: Vec3 | None
    normal: Vec3
    depth: torch.Tensor
    object_id: torch.Tensor
    roughness: torch.Tensor
    transmission: torch.Tensor
    rays_traced: torch.Tensor  # int64 scalar (all spp)


def camera_rays(camera, rng_state: torch.Tensor, frame_index: int,
                sample: int, blue_noise_tbl: torch.Tensor, tile=None):
    """Jittered primary rays of one sample over the (H, W) pixel grid of
    ``rng_state``, each with its own PCG sub-stream.  ``tile`` as
    ``trace_frame``'s.  Returns (sub_state, RayBatch)."""
    dev = rng_state.device
    height, width = rng_state.shape
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    if tile is not None:
        y0, x0, full_h, full_w = tile
        ys, xs = ys + y0, xs + x0
    else:
        full_h, full_w = height, width
    fidx = torch.tensor(frame_index + sample, dtype=torch.int64, device=dev)
    jx_t, jy_t = taa_jitter(fidx)
    bx, by = next_blue_noise(blue_noise_tbl, xs, ys, fidx)
    jitter_x = jx_t + (bx - 0.5) * 0.25
    jitter_y = jy_t + (by - 0.5) * 0.25
    # global pixel coords -> camera uv, bottom-up
    sg = (xs.to(torch.float32) + 0.5 + jitter_x) / float(full_w)
    tg = (ys.to(torch.float32) + 0.5 + jitter_y) / float(full_h)
    sub = prng.fold(rng_state, sample + 1)
    return camera.get_ray(sg, tg, sub)


def trace_frame(geom, materials, lights, n_lights: int, sky, camera,
                rng_state: torch.Tensor, frame_index: int, width: int,
                height: int, spp: int, max_depth: int,
                blue_noise_tbl: torch.Tensor, split: bool = False,
                rr_enabled: bool = True, rr_start: int = 2,
                camera_nee: bool = True, tile=None):
    """One frame of ``spp`` samples.  Returns (rng_state, FrameBuffers).

    ``tile``: ``(y0, x0, full_h, full_w)`` — this call renders the
    (height, width) tile whose top-left global pixel is (y0, x0) of a
    full_h x full_w frame, ``rng_state`` being the tile's slice of the
    whole frame's state.  The camera uv, the blue-noise lookup and the TAA
    jitter use global pixel coordinates and every lane's work depends only
    on its own pixel and sample, so tiles put together are the whole frame
    bit for bit (``rays_traced`` summed)."""
    dev = rng_state.device
    if tuple(rng_state.shape) != (height, width):
        raise ValueError(f"rng_state {tuple(rng_state.shape)} does not match "
                         f"the {height}x{width} frame")
    if tile is not None:
        y0, x0, full_h, full_w = (int(v) for v in tile)
        if not (0 <= y0 and y0 + height <= full_h and 0 <= x0
                and x0 + width <= full_w):
            raise ValueError(f"tile {tuple(tile)} of {height}x{width} lies "
                             "outside its frame")
        tile = (y0, x0, full_h, full_w)
    sums = None
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(spp):
        sub, ray = camera_rays(camera, rng_state, frame_index, s,
                               blue_noise_tbl, tile)
        _, out = trace_path(geom, materials, lights, n_lights, sky, ray, sub,
                            max_depth, split=split, rr_enabled=rr_enabled,
                            rr_start=rr_start, camera_nee=camera_nee)
        parts = (out.radiance, out.diffuse, out.specular, out.emission)
        sums = parts if sums is None else tuple(
            a if b is None else a + b for a, b in zip(sums, parts))
        rays = rays + out.rays_traced
        if s == 0:
            first = out
    # the persistent per-pixel stream advances once per frame
    state, _ = prng.uniform(rng_state)
    inv = 1.0 / float(spp)
    color, diff, spec, emis = (None if a is None else a * inv for a in sums)
    return state, FrameBuffers(
        color=color, diffuse=diff, specular=spec, emission=emis,
        normal=first.first_normal,
        depth=first.first_depth, object_id=first.first_object_id,
        roughness=first.first_roughness,
        transmission=first.first_transmission, rays_traced=rays)


def _resize_axis(a: torch.Tensor, dim: int, out_n: int) -> torch.Tensor:
    """Linear resize of one axis as ``jax.image.resize``'s bilinear: sample
    positions ``(j + 0.5) * in / out - 0.5``, triangle weights on the two
    neighbouring input samples, taps outside the input dropped and the
    rest renormalised."""
    in_n = a.shape[dim]
    if out_n < in_n:
        # jax's downscale widens the triangle (antialias); not ported
        raise ValueError(f"upscale only: {in_n} -> {out_n}")
    dev = a.device
    # jax: arange(out) + 0.5, times float32(1 / scale), minus 0.5
    inv_scale = torch.tensor(1.0 / (out_n / in_n), dtype=torch.float32)
    f = (torch.arange(out_n, dtype=torch.float32, device=dev) + 0.5) \
        * inv_scale.to(dev) - 0.5
    i0 = torch.floor(f)
    taps = []
    for i in (i0, i0 + 1.0):
        wgt = torch.clamp(1.0 - torch.abs(f - i), min=0.0)
        inside = (i >= 0) & (i <= in_n - 1)
        taps.append((i.clamp(0, in_n - 1).long(),
                     torch.where(inside, wgt, 0.0)))
    total = taps[0][1] + taps[1][1]
    norm = torch.where(total != 0, total, 1.0)
    shape = [1] * a.dim()
    shape[dim] = out_n
    out = None
    for idx, wgt in taps:
        wn = torch.where(torch.abs(total) > 1000.0 * 1.1920929e-07,
                         wgt / norm, 0.0).view(shape)
        term = a.index_select(dim, idx) * wn
        out = term if out is None else out + term
    return out


def upscale_bilinear(img: Vec3, out_h: int, out_w: int) -> Vec3:
    """Bilinear resize of (h, w) planes to (out_h, out_w), as the
    reference's ``jax.image.resize(..., "bilinear")`` (rows, then
    columns)."""
    return img.map(lambda c: _resize_axis(_resize_axis(c, 0, out_h), 1,
                                          out_w))


# -- K6 ----------------------------------------------------------------------

# the encode table's buckets: float bits of [0, 1] shifted right by LUT_SHIFT
LUT_SHIFT = 16

_P3 = ctypes.c_void_p * 3


class TonemapArgs(ctypes.Structure):
    """``struct TonemapArgs`` of ``csrc/tonemap.cu``."""

    _fields_ = [
        ("hdr", _P3), ("bloom", _P3), ("bx", ctypes.c_void_p),
        ("by", ctypes.c_void_p), ("lut", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("h", ctypes.c_int), ("w", ctypes.c_int),
        ("bw", ctypes.c_int), ("scale", ctypes.c_float),
    ]


def encode_plain(v: torch.Tensor) -> torch.Tensor:
    """The plain sRGB OETF and 8-bit quantisation of one plane of
    tonemapped values (``srgb_oetf`` then ``to_rgb8``, the same
    operations)."""
    return to_rgb8(srgb_oetf(Vec3(v, v, v)))[..., 0]


_thresholds: dict = {}

ONE_BITS = 0x3F800000  # the bits of 1.0


def encode_thresholds(device, encode=None, top: int = ONE_BITS
                      ) -> torch.Tensor:
    """(256,) float32 on ``device``: entry k >= 1 is the least float in
    [0, top] (``top`` as float bits) that the plain ``encode`` (a plane of
    floats to uint8; ``encode_plain`` where None), run on ``device``, maps
    to k or more (entry 0 is 0 and unused).  A bisection over the floats'
    bit patterns (which order as the floats do), 31 steps for every k at
    once; where the plain encode is monotone, the count of thresholds at or
    below v is its byte.  ``top`` must encode to 255."""
    encode = encode or encode_plain
    key = (str(device), encode, top)
    if key not in _thresholds:
        k = torch.arange(1, 256, dtype=torch.int32, device=device)
        lo = torch.zeros_like(k)
        hi = torch.full_like(k, top)
        for _ in range(31):
            mid = (lo + hi) // 2
            ge = encode(mid.view(torch.float32)).to(torch.int32) >= k
            hi = torch.where(ge, mid, hi)
            lo = torch.where(ge, lo, mid + 1)
        _thresholds[key] = torch.cat([torch.zeros(1, device=device),
                                      hi.view(torch.float32)])
    return _thresholds[key]


_luts: dict = {}


def encode_lut(device, encode=None, top: int = ONE_BITS) -> torch.Tensor:
    """The encode's table as ``csrc/tonemap.cu`` reads it, int32 on
    ``device``: one word for each bucket of 2^LUT_SHIFT float bit patterns
    of [0, top] (the bucket of ``top`` last), holding the byte at the
    bucket's start (the thresholds at or below it, bits 17 up) and the
    offset in the bucket of the next threshold (low 17 bits; 2^16 where
    the bucket holds none).  The byte of v is then the number of
    thresholds at or below v; raises if a bucket holds two thresholds.
    ``encode`` and ``top`` as ``encode_thresholds``'."""
    encode = encode or encode_plain
    key = (str(device), encode, top)
    if key not in _luts:
        bits = encode_thresholds(device, encode, top)[1:].view(torch.int32)
        if not bool((bits[1:] >= bits[:-1]).all()):
            raise RuntimeError("the encode's thresholds are not in order")
        span = 1 << LUT_SHIFT
        starts = torch.arange((top >> LUT_SHIFT) + 1,
                              dtype=torch.int32, device=device) * span
        base = torch.searchsorted(bits, starts, right=True)
        nxt = bits[base.clamp(max=254)]
        inside = (base < 255) & (nxt < starts + span)
        after = bits[(base + 1).clamp(max=254)]
        if bool((inside & (base < 254) & (after < starts + span)).any()):
            raise RuntimeError("a bucket of the encode's table holds two "
                               "thresholds")
        offset = torch.where(inside, nxt - starts, span)
        _luts[key] = ((base.to(torch.int32) << 17) | offset).to(torch.int32)
    return _luts[key]


def encode_lut_plain(v: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """The byte ``csrc/tonemap.cu`` reads from ``lut`` for values of [0, 1]
    (its bucket's byte, plus one at or past the bucket's threshold)."""
    b = v.view(torch.int32) & 0x7FFFFFFF
    e = lut[(b >> LUT_SHIFT).long()]
    return ((e >> 17) + ((b & 0xFFFF) >= (e & 0x1FFFF)).int()).to(
        torch.uint8)


def tonemap_rgb8(hdr: Vec3, scale: float,
                 bloom: Vec3 | None = None) -> torch.Tensor:
    """(H, W) float32 HDR planes, plus ``up(bloom)`` where the bloom
    chain's mip 0 is given, times ``scale`` -> ACES -> exact sRGB OETF ->
    uint8 -> Y-flip.  Returns (H, W, 3) uint8."""
    dev = hdr.x.device
    kernels.require_supported(dev)
    comps = [("hdr", hdr)] + ([("bloom", bloom)] if bloom is not None
                              else [])
    for what, v in comps:
        for i, c in enumerate((v.x, v.y, v.z)):
            name = f"{what}.{'xyz'[i]}"
            kernels.check_tensor(name, c, torch.float32, 2, dev)
            if c.shape != v.x.shape:
                raise ValueError(f"{name}: shape {tuple(c.shape)} != "
                                 f"{tuple(v.x.shape)}")
    if dev.type == "cpu":
        return tonemap_rgb8_plain(hdr, scale, bloom)
    h, w = hdr.x.shape
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=dev)
    a = TonemapArgs()
    a.hdr = _P3(hdr.x.data_ptr(), hdr.y.data_ptr(), hdr.z.data_ptr())
    if bloom is not None:
        bh, bw = bloom.x.shape
        a.bloom = _P3(bloom.x.data_ptr(), bloom.y.data_ptr(),
                      bloom.z.data_ptr())
        a.bx = bloom_mod.axis_table(bw, w, dev).data_ptr()
        a.by = bloom_mod.axis_table(bh, h, dev).data_ptr()
        a.bw = bw
    a.lut = encode_lut(dev).data_ptr()
    a.out, a.h, a.w, a.scale = out.data_ptr(), h, w, float(scale)
    rc = kernels.get_lib().ptrt_tonemap_rgb8(ctypes.addressof(a),
                                             kernels.stream_ptr(dev))
    kernels.launches["tonemap_rgb8"] += 1
    kernels.check(rc, "tonemap_rgb8")
    return out


def tonemap_info() -> dict:
    """{"alone" | "with the bloom": registers, resident blocks a SM} of K6's
    vector path (measurement only; needs the card)."""
    lib = kernels.get_lib()
    out = {}
    for bloom, name in ((0, "alone"), (1, "with the bloom")):
        regs, per_sm = ctypes.c_int(), ctypes.c_int()
        kernels.check(lib.ptrt_tonemap_info(bloom, ctypes.byref(regs),
                                            ctypes.byref(per_sm)),
                      "tonemap_rgb8")
        out[name] = {"registers": regs.value, "blocks_per_sm": per_sm.value}
    return out


def tonemap_rgb8_plain(hdr: Vec3, scale: float,
                       bloom: Vec3 | None = None) -> torch.Tensor:
    """Plain version of K6 (``pipeline.tonemap_to_rgb8``), after
    ``hdr + up(bloom)`` where ``bloom`` is given."""
    if bloom is not None:
        hdr = hdr + bloom_mod.upsample_bilinear(bloom, *hdr.x.shape)
    c = aces_tonemap(hdr * scale)
    return to_rgb8(srgb_oetf(c)).flip(0)


def tonemap_to_rgb8(hdr: Vec3, total_samples: int = 1) -> torch.Tensor:
    """Average over ``total_samples``, tonemap, quantize, Y-flip (K6)."""
    return tonemap_rgb8(hdr, 1.0 / float(total_samples))
