"""The per-frame trace, the upscale and the K6 tonemap wrapper.

Counterpart of ``ptrt_tpu/render/pipeline.py``: ``trace_frame`` generates
jittered camera rays (TAA + blue noise, one PCG sub-stream per sample:
``camera_rays``, the hand-written K0 ``csrc/camera.cu`` for CUDA tensors,
its plain version ``camera_rays_plain`` for CPU tensors), runs the
integrator and sums the samples (``sample_sums``, K13 ``csrc/frame.cu``
for CUDA tensors: each sample's final soft clamp and, with ``split``, the
denoiser's diffuse/specular/emission channels; the mean and the frame's
PCG advance at the last); ``upscale_bilinear`` is
``jax.image.resize(..., "bilinear")`` (K12 ``csrc/upscale.cu`` for CUDA
tensors, its plain version ``upscale_bilinear_plain`` for CPU tensors,
both on the taps of ``resize_taps``); ``tonemap_to_rgb8``
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

import numpy as np
import torch

from ptrt_tpu_torch import kernels
from ptrt_tpu_torch.core import rng as prng
from ptrt_tpu_torch.core.bluenoise import next_blue_noise
from ptrt_tpu_torch.core.color import aces_tonemap, srgb_oetf, to_rgb8
from ptrt_tpu_torch.core.taa import halton_table as taa_halton_table
from ptrt_tpu_torch.core.taa import taa_jitter
from ptrt_tpu_torch.core.vec import Vec3, clamp_vector_soft
from ptrt_tpu_torch.render import bloom as bloom_mod
from ptrt_tpu_torch.render.integrator import MAX_FINAL_RADIANCE, trace_bounces
from ptrt_tpu_torch.render.ray import RayBatch


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


def camera_rays_plain(camera, rng_state: torch.Tensor, frame_index,
                      sample: int, blue_noise_tbl: torch.Tensor, tile=None):
    """Plain version of K0 (``pipeline.camera_rays``)."""
    dev = rng_state.device
    height, width = rng_state.shape
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    if tile is not None:
        y0, x0, full_h, full_w = tile
        ys, xs = ys + y0, xs + x0
    else:
        full_h, full_w = height, width
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


_P3 = ctypes.c_void_p * 3


class CameraRaysArgs(kernels.Args):
    """``struct CameraRaysArgs`` of ``csrc/camera.cu``."""

    _fields_ = [
        ("rng", ctypes.c_void_p), ("rng_pitch", ctypes.c_longlong),
        ("blue_noise", ctypes.c_void_p), ("halton", ctypes.c_void_p),
        ("frame", ctypes.c_void_p), ("frame_host", ctypes.c_longlong),
        ("frame_bytes", ctypes.c_int), ("sample", ctypes.c_int),
        ("salt", ctypes.c_uint), ("origin", _P3), ("llc", _P3),
        ("horizontal", _P3), ("vertical", _P3), ("u", _P3), ("v", _P3),
        ("lens_radius", ctypes.c_void_p), ("sub", ctypes.c_void_p),
        ("o", _P3), ("d", _P3), ("spec", ctypes.c_void_p),
        ("h", ctypes.c_int), ("w", ctypes.c_int), ("y0", ctypes.c_int),
        ("x0", ctypes.c_int), ("full_h", ctypes.c_int),
        ("full_w", ctypes.c_int),
    ]


def camera_rays(camera, rng_state: torch.Tensor, frame_index,
                sample: int, blue_noise_tbl: torch.Tensor, tile=None):
    """Jittered primary rays of one sample over the (H, W) pixel grid of
    ``rng_state``, each with its own PCG sub-stream (K0).  ``frame_index``:
    a Python int, or a 0-d integer tensor on the state's device (the same
    bits; a frame captured into a CUDA graph reads its index there).
    ``tile`` as ``trace_frame``'s.  Returns (sub_state, RayBatch); on the
    card every plane is its own contiguous (H, W) tensor."""
    dev = rng_state.device
    kernels.require_supported(dev)
    if dev.type == "cpu":
        return camera_rays_plain(camera, rng_state, frame_index, sample,
                                 blue_noise_tbl, tile)
    height, width = rng_state.shape
    y0, x0, full_h, full_w = ((0, 0, height, width) if tile is None
                              else (int(v) for v in tile))
    if rng_state.dtype != torch.int64 or rng_state.stride(1) != 1:
        raise ValueError("rng_state: expected int64 rows of unit stride, got "
                         f"{rng_state.dtype} strides {rng_state.stride()}")
    kernels.check_tensor("blue_noise_tbl", blue_noise_tbl, torch.float32, 3,
                         dev)
    a = CameraRaysArgs()
    if torch.is_tensor(frame_index) and frame_index.device.type == "cuda":
        if frame_index.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"frame_index: {frame_index.dtype}, expected "
                            "int32 or int64")
        kernels.check_tensor("frame_index", frame_index, frame_index.dtype,
                             0, dev)
        a.frame = frame_index.data_ptr()
        a.frame_bytes = frame_index.element_size()
    else:  # a host number, or a 0-d CPU tensor: read here, as torch would
        a.frame_host = int(frame_index)
    halton = taa_halton_table(dev)
    a.rng, a.rng_pitch = rng_state.data_ptr(), rng_state.stride(0)
    a.blue_noise, a.halton = blue_noise_tbl.data_ptr(), halton.data_ptr()
    a.sample = sample
    a.salt = prng.mul32(sample + 1, prng.GOLDEN)
    for field in ("origin", "horizontal", "vertical", "u", "v"):
        setattr(a, field, _P3(*kernels.vec_ptrs(
            f"camera.{field}", getattr(camera, field), dev)))
    a.llc = _P3(*kernels.vec_ptrs("camera.lower_left_corner",
                                  camera.lower_left_corner, dev))
    a.lens_radius = kernels.scalar_ptr("camera.lens_radius",
                                       camera.lens_radius, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    sub = torch.empty((height, width), dtype=torch.int64, device=dev)
    o = torch.empty((3, height, width), **f32)
    d = torch.empty((3, height, width), **f32)
    spec = torch.empty((height, width), dtype=torch.bool, device=dev)
    a.sub, a.spec = sub.data_ptr(), spec.data_ptr()
    a.o = _P3(*[o[k].data_ptr() for k in range(3)])
    a.d = _P3(*[d[k].data_ptr() for k in range(3)])
    a.h, a.w = height, width
    a.y0, a.x0, a.full_h, a.full_w = y0, x0, full_h, full_w
    rc = kernels.get_lib().ptrt_camera_rays(ctypes.addressof(a),
                                            kernels.stream_ptr(dev))
    kernels.launches["camera_rays"] += 1
    kernels.check(rc, "camera_rays")
    return sub, RayBatch(Vec3(o[0], o[1], o[2]), Vec3(d[0], d[1], d[2]),
                         spec)


def trace_frame(geom, materials, lights, n_lights: int, sky, camera,
                rng_state: torch.Tensor, frame_index, width: int,
                height: int, spp: int, max_depth: int,
                blue_noise_tbl: torch.Tensor, split: bool = False,
                rr_enabled: bool = True, rr_start: int = 2,
                camera_nee: bool = True, tile=None):
    """One frame of ``spp`` samples.  Returns (rng_state, FrameBuffers).
    ``frame_index``: as ``camera_rays``'.

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
    sums = state = None
    # the frame's own ray counter: every sample's walks count into it
    rays = torch.zeros((), dtype=torch.int64, device=dev)
    for s in range(spp):
        sub, ray = camera_rays(camera, rng_state, frame_index, s,
                               blue_noise_tbl, tile)
        ps = trace_bounces(geom, materials, lights, n_lights, sky, ray, sub,
                           max_depth, rays, split=split,
                           rr_enabled=rr_enabled, rr_start=rr_start,
                           camera_nee=camera_nee, own_ray=True)
        # at the last sample the mean, and the persistent per-pixel stream
        # advanced once a frame
        sums, state = sample_sums(sums, ps, s, spp, rng_state)
        if s == 0:
            first = (ps.first_normal, ps.first_depth, ps.first_object_id,
                     ps.first_roughness, ps.first_transmission)
    rs = lambda v: (v.map(rs) if isinstance(v, Vec3)
                    else v.reshape(height, width))
    normal, depth, object_id, roughness, transmission = (rs(v)
                                                         for v in first)
    color, diff, spec, emis = sums
    return state, FrameBuffers(
        color=color, diffuse=diff, specular=spec, emission=emis,
        normal=normal, depth=depth, object_id=object_id,
        roughness=roughness, transmission=transmission, rays_traced=rays)


# -- K13 sample_sums -----------------------------------------------------------

# the soft clamp's luminance weights (core/vec.py Vec3.luminance) and the
# floor of its divisor (clamp_vector_soft)
LUMINANCE_WEIGHTS = (0.2126, 0.7152, 0.0722)
LUMINANCE_FLOOR = 1e-30


class SampleSumsArgs(kernels.Args):
    """``struct SampleSumsArgs`` of ``csrc/frame.cu``."""

    _fields_ = [
        ("radiance", _P3), ("part", ctypes.c_void_p * 9),
        ("sum", ctypes.c_void_p * 12), ("planes", ctypes.c_int),
        ("first", ctypes.c_int), ("last", ctypes.c_int),
        ("inv", ctypes.c_float), ("lum_w", ctypes.c_float * 3),
        ("max_lum", ctypes.c_float), ("lum_floor", ctypes.c_float),
        ("rng", ctypes.c_void_p), ("rng_pitch", ctypes.c_longlong),
        ("rng_out", ctypes.c_void_p), ("h", ctypes.c_int),
        ("w", ctypes.c_int),
    ]


def _channels(ps) -> tuple:
    """A sample's (radiance, diffuse, specular, emission) planes of
    ``ps``: the radiance before its final clamp; the split channels None
    unless split."""
    return (ps.accum, ps.diffuse, ps.specular, ps.emission)


def sample_sums_plain(sums, ps, sample: int, spp: int,
                      rng_state: torch.Tensor):
    """Plain version of K13 ``sample_sums``."""
    height, width = rng_state.shape
    rs = lambda v: None if v is None else v.map(
        lambda c: c.reshape(height, width))
    radiance, *split = _channels(ps)
    parts = (rs(clamp_vector_soft(radiance, MAX_FINAL_RADIANCE)),
             *(rs(v) for v in split))
    sums = parts if sums is None else tuple(
        a if b is None else a + b for a, b in zip(sums, parts))
    if sample != spp - 1:
        return sums, None
    state, _ = prng.uniform(rng_state)
    inv = 1.0 / float(spp)
    return tuple(None if a is None else a * inv for a in sums), state


def sample_sums(sums, ps, sample: int, spp: int, rng_state: torch.Tensor):
    """Sample ``sample`` of a frame of ``spp`` into its sums (K13): the
    sample's radiance (``ps.accum``, a ``PathState``'s flat planes)
    soft-clamped at ``MAX_FINAL_RADIANCE`` and, with a split state, its
    diffuse, specular and emission channels, each added to ``sums`` (the
    previous sample's return; None at the first sample starts them); at the
    last sample (``sample == spp - 1``) each sum times ``1 / spp`` and the
    frame's persistent PCG state ``rng_state`` ((H, W), rows of unit
    stride) advanced one step.  Returns (the (colour, diffuse, specular,
    emission) sums as (H, W) Vec3s, None where not split; the advanced
    state, or None before the last sample).  On the card the sums are the
    planes of one (3 or 12, H, W) tensor, which each sample's launch
    updates in place."""
    dev = rng_state.device
    kernels.require_supported(dev)
    if dev.type == "cpu":
        return sample_sums_plain(sums, ps, sample, spp, rng_state)
    height, width = rng_state.shape
    n = height * width
    if rng_state.dtype != torch.int64 or rng_state.stride(1) != 1:
        raise ValueError("rng_state: expected int64 rows of unit stride, got "
                         f"{rng_state.dtype} strides {rng_state.stride()}")
    if not 0 <= sample < spp:
        raise ValueError(f"sample {sample} of a frame of {spp}")
    channels = _channels(ps)
    split = channels[1] is not None
    planes = 12 if split else 3
    for name, v in zip(("accum", "diffuse", "specular", "emission"),
                       channels[:4 if split else 1]):
        for k, c in zip("xyz", (v.x, v.y, v.z)):
            kernels.check_tensor(f"ps.{name}.{k}", c, torch.float32, 1, dev)
            if c.numel() != n:
                raise ValueError(f"ps.{name}.{k}: {c.numel()} lanes for the "
                                 f"{height}x{width} frame")
    if sums is None:
        buf = torch.empty((planes, height, width), dtype=torch.float32,
                          device=dev)
        sums = tuple(Vec3(buf[3 * j], buf[3 * j + 1], buf[3 * j + 2])
                     if 3 * j < planes else None for j in range(4))
        first = 1
    else:
        first = 0
    out = [c for v in sums if v is not None for c in (v.x, v.y, v.z)]
    if len(out) != planes:
        raise ValueError(f"sums: {len(out)} planes for a state of {planes}")
    for c in out:
        kernels.check_tensor("sums", c, torch.float32, 2, dev)
        if tuple(c.shape) != (height, width):
            raise ValueError(f"sums: shape {tuple(c.shape)} for the "
                             f"{height}x{width} frame")
    a = SampleSumsArgs()
    acc = channels[0]
    a.radiance = _P3(acc.x.data_ptr(), acc.y.data_ptr(), acc.z.data_ptr())
    if split:
        a.part = (ctypes.c_void_p * 9)(*[c.data_ptr() for v in channels[1:]
                                         for c in (v.x, v.y, v.z)])
    a.sum = (ctypes.c_void_p * 12)(*[c.data_ptr() for c in out])
    a.planes, a.first = planes, first
    a.last = int(sample == spp - 1)
    a.inv = 1.0 / float(spp)
    a.lum_w = (ctypes.c_float * 3)(*LUMINANCE_WEIGHTS)
    a.max_lum, a.lum_floor = MAX_FINAL_RADIANCE, LUMINANCE_FLOOR
    state = None
    if a.last:
        state = torch.empty((height, width), dtype=torch.int64, device=dev)
        a.rng, a.rng_pitch = rng_state.data_ptr(), rng_state.stride(0)
        a.rng_out = state.data_ptr()
    a.h, a.w = height, width
    rc = kernels.get_lib().ptrt_sample_sums(ctypes.addressof(a),
                                            kernels.stream_ptr(dev))
    kernels.launches["sample_sums"] += 1
    kernels.check(rc, "sample_sums")
    return sums, state


# -- K12 upscale_bilinear --------------------------------------------------------


class AxisTaps(NamedTuple):
    """The bilinear resize of one axis: each output sample's two input
    taps and their renormalised weights."""

    index: torch.Tensor  # (2, out) int64
    weight: torch.Tensor  # (2, out) float32
    index32: torch.Tensor  # (2, out) int32: ``index`` as K12 reads it


_taps: dict = {}


def resize_taps(in_n: int, out_n: int, device) -> AxisTaps:
    """The taps of ``jax.image.resize``'s bilinear from ``in_n`` to
    ``out_n`` samples, on ``device``, made once for each (in, out) size
    and device (a frame captured into a CUDA graph builds no tensor from
    host data): sample positions ``(j + 0.5) * in / out - 0.5``, triangle
    weights on the two neighbouring input samples, taps outside the input
    dropped and the rest renormalised."""
    in_n, out_n = int(in_n), int(out_n)
    key = (in_n, out_n, str(torch.device(device)))
    if key in _taps:
        return _taps[key]
    if out_n < in_n:
        # jax's downscale widens the triangle (antialias); not ported
        raise ValueError(f"upscale only: {in_n} -> {out_n}")
    # jax: arange(out) + 0.5, times float32(1 / scale), minus 0.5
    inv_scale = float(np.float32(1.0 / (out_n / in_n)))
    f = (torch.arange(out_n, dtype=torch.float32, device=device) + 0.5) \
        * inv_scale - 0.5
    i0 = torch.floor(f)
    taps = []
    for i in (i0, i0 + 1.0):
        wgt = torch.clamp(1.0 - torch.abs(f - i), min=0.0)
        inside = (i >= 0) & (i <= in_n - 1)
        taps.append((i.clamp(0, in_n - 1).long(),
                     torch.where(inside, wgt, 0.0)))
    total = taps[0][1] + taps[1][1]
    norm = torch.where(total != 0, total, 1.0)
    weights = [torch.where(torch.abs(total) > 1000.0 * 1.1920929e-07,
                           wgt / norm, 0.0) for _, wgt in taps]
    index = torch.stack([idx for idx, _ in taps])
    _taps[key] = AxisTaps(index, torch.stack(weights),
                          index.to(torch.int32))
    return _taps[key]


def _resize_axis(a: torch.Tensor, dim: int, out_n: int) -> torch.Tensor:
    """Linear resize of one axis as ``jax.image.resize``'s bilinear, on the
    taps of ``resize_taps``."""
    taps = resize_taps(a.shape[dim], out_n, a.device)
    shape = [1] * a.dim()
    shape[dim] = out_n
    out = None
    for k in range(2):
        term = a.index_select(dim, taps.index[k]) * taps.weight[k].view(
            shape)
        out = term if out is None else out + term
    return out


def upscale_bilinear_plain(img: Vec3, out_h: int, out_w: int) -> Vec3:
    """Plain version of K12 (``pipeline.upscale_bilinear``)."""
    return img.map(lambda c: _resize_axis(_resize_axis(c, 0, out_h), 1,
                                          out_w))


class UpscaleArgs(kernels.Args):
    """``struct UpscaleArgs`` of ``csrc/upscale.cu``."""

    _fields_ = [
        ("src", _P3), ("dst", _P3), ("row_index", ctypes.c_void_p),
        ("row_weight", ctypes.c_void_p), ("col_index", ctypes.c_void_p),
        ("col_weight", ctypes.c_void_p), ("in_h", ctypes.c_int),
        ("in_w", ctypes.c_int), ("out_h", ctypes.c_int),
        ("out_w", ctypes.c_int),
    ]


def upscale_bilinear(img: Vec3, out_h: int, out_w: int) -> Vec3:
    """Bilinear resize of (h, w) float32 planes to (out_h, out_w), as the
    reference's ``jax.image.resize(..., "bilinear")`` (rows, then columns):
    K12, one launch for the three planes, which it returns as the planes of
    one (3, out_h, out_w) tensor."""
    dev = img.x.device
    kernels.require_supported(dev)
    if dev.type == "cpu":
        return upscale_bilinear_plain(img, out_h, out_w)
    for k, c in zip("xyz", (img.x, img.y, img.z)):
        kernels.check_tensor(f"img.{k}", c, torch.float32, 2, dev)
        if c.shape != img.x.shape:
            raise ValueError(f"img.{k}: shape {tuple(c.shape)} != "
                             f"{tuple(img.x.shape)}")
    in_h, in_w = img.x.shape
    rows, cols = resize_taps(in_h, out_h, dev), resize_taps(in_w, out_w, dev)
    out = torch.empty((3, out_h, out_w), dtype=torch.float32, device=dev)
    a = UpscaleArgs()
    a.src = _P3(img.x.data_ptr(), img.y.data_ptr(), img.z.data_ptr())
    a.dst = _P3(*[out[k].data_ptr() for k in range(3)])
    a.row_index, a.row_weight = (rows.index32.data_ptr(),
                                 rows.weight.data_ptr())
    a.col_index, a.col_weight = (cols.index32.data_ptr(),
                                 cols.weight.data_ptr())
    a.in_h, a.in_w, a.out_h, a.out_w = in_h, in_w, out_h, out_w
    rc = kernels.get_lib().ptrt_upscale_bilinear(ctypes.addressof(a),
                                                 kernels.stream_ptr(dev))
    kernels.launches["upscale_bilinear"] += 1
    kernels.check(rc, "upscale_bilinear")
    return Vec3(out[0], out[1], out[2])


# -- K6 ----------------------------------------------------------------------

# the encode table's buckets: float bits of [0, 1] shifted right by LUT_SHIFT
LUT_SHIFT = 16

class TonemapArgs(kernels.Args):
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
