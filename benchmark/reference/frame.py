"""The reference's frame: the trace of a list of pixels from scratch, and
the post stack of a whole frame, in plain torch.

``trace_pixels`` works out a frame's trace at given pixels from the scene
description alone: each pixel's PCG state from its coordinates and the
frames rendered before (``pcg_state``), the camera rays of every sample
(TAA and blue-noise jitter, the PCG sub-streams), the closest-hit and
any-hit walks over the reference's own triangle table, the K3 shading
(materials, lights, NEE, MIS, scatter, Russian roulette, the env NEE over
the alias tables built from the map) and the sample sums, with each
pixel's ray count.  Every pixel's path depends only on its own pixel, so
the pixels need not be neighbours: all samples of all pixels are one
wavefront.

``post_frame`` is the frame after its trace (the port's ``_post_frame``
at full size without the progressive average): motion vectors, the SVGF
firefly clamp, temporal stage, variance and à-trous passes over the
carried history, the bloom and the tonemap to RGB8.

``rnd`` rounds a plane where the reference stores it; the identity
computes in float32, ``bf16`` keeps every stored plane in bfloat16's
precision (the control: the reference a precision below the
configuration's)."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch

from benchmark.reference import rng as prng
from benchmark.reference import traverse
from benchmark.reference.bloom import bloom_mips
from benchmark.reference.denoiser import (DEFAULT_SETTINGS, DenoiserState,
                                          denoise_frame)
from benchmark.reference.motion import motion_vectors_plain
from benchmark.reference.pipeline import (MAX_FINAL_RADIANCE,
                                          camera_rays_plain,
                                          tonemap_rgb8_plain)
from benchmark.reference.ray import RayBatch
from benchmark.reference.shade import (PathState, shade_nee_plain,
                                       shade_scatter_plain)
from benchmark.reference.vec import Vec3, clamp_vector_soft


def f32(t):
    return t


def bf16(t):
    """A float32 tensor (or a Vec3 of them) rounded to bfloat16."""
    if isinstance(t, Vec3):
        return t.map(bf16)
    if torch.is_tensor(t) and t.dtype == torch.float32:
        return t.to(torch.bfloat16).to(torch.float32)
    return t


def pcg_state(ys: torch.Tensor, xs: torch.Tensor, frames: int):
    """The persistent PCG state of pixels (``ys``, ``xs``) before the
    ``frames``-th frame since the scene seeded it (seed 0): the seed hash
    advanced one step a frame.  The advance is an affine map mod 2^32, so
    ``frames`` steps compose into one (square and multiply)."""
    state = prng.seed(xs, ys, 0)
    a, c = 747796405, 2891336453
    mult, add = 1, 0
    k = int(frames)
    while k:
        if k & 1:
            mult, add = (mult * a) & prng.MASK32, (add * a + c) & prng.MASK32
        a, c = (a * a) & prng.MASK32, (c * (a + 1)) & prng.MASK32
        k >>= 1
    return (prng.mul32(state, mult) + add) & prng.MASK32


def round_tree(tree, rnd):
    """``tree`` (a dataclass of tensors, Vec3s and such dataclasses) with
    ``rnd`` applied to every tensor and Vec3."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, Vec3):
        return dataclasses.replace(tree, **{
            f.name: round_tree(getattr(tree, f.name), rnd)
            for f in dataclasses.fields(tree)})
    return rnd(tree)


def _round_state(ps: PathState, rnd) -> None:
    for f in dataclasses.fields(ps):
        v = getattr(ps, f.name)
        if v is not None:
            setattr(ps, f.name, rnd(v))


def trace_pixels(t: dict, camera, state: torch.Tensor, frame_index: int,
                 ys: torch.Tensor, xs: torch.Tensor, size: tuple, spp: int,
                 depth: int, split: bool, rr_enabled: bool, rr_start: int,
                 camera_nee: bool = True, rnd=f32) -> SimpleNamespace:
    """The trace of pixels (``ys``, ``xs``) ((P,) integer tensors) of a
    frame of ``size`` (height, width) at ``frame_index``, their PCG states
    ``state`` ((P,)), over the tables ``t`` (``scene.Scene.tables``):
    {color, diffuse, specular, emission (None unless ``split``): (P,)
    Vec3s, the sample means; normal, depth, object_id, roughness,
    transmission: sample 0's first hit; rays: (P,) int64, each pixel's
    rays traced; state: the PCG state after the frame}."""
    p = ys.shape[0]
    ys2, xs2, st2 = ys[None], xs[None], state[None]
    subs, rays = [], []
    for s in range(spp):
        sub, ray = camera_rays_plain(camera, st2, frame_index, s, t["bn"],
                                     ys2, xs2, size)
        subs.append(sub.reshape(-1))
        rays.append(ray)
    cat = lambda get: torch.cat([get(r).reshape(-1) for r in rays])
    ray = RayBatch(Vec3(cat(lambda r: r.origin.x), cat(lambda r: r.origin.y),
                        cat(lambda r: r.origin.z)),
                   Vec3(cat(lambda r: r.direction.x),
                        cat(lambda r: r.direction.y),
                        cat(lambda r: r.direction.z)),
                   cat(lambda r: r.spec))
    ps, count = _bounces(t, ray, torch.cat(subs), depth, split, rr_enabled,
                         rr_start, camera_nee, rnd)
    # each sample's final clamp, summed in sample order, times 1 / spp
    per = lambda v: [v.map(lambda c: c[s * p:(s + 1) * p])
                     for s in range(spp)]
    parts = [per(clamp_vector_soft(ps.accum, MAX_FINAL_RADIANCE))]
    if split:
        parts += [per(ps.diffuse), per(ps.specular), per(ps.emission)]
    inv = 1.0 / float(spp)
    means = []
    for samples in parts:
        acc = samples[0]
        for v in samples[1:]:
            acc = acc + v
        means.append(rnd(acc * inv))
    first = lambda v: (v.map(lambda c: c[:p]) if isinstance(v, Vec3)
                       else v[:p])
    new_state, _ = prng.uniform(state)
    return SimpleNamespace(
        color=means[0], diffuse=means[1] if split else None,
        specular=means[2] if split else None,
        emission=means[3] if split else None,
        normal=first(ps.first_normal), depth=first(ps.first_depth),
        object_id=first(ps.first_object_id),
        roughness=first(ps.first_roughness),
        transmission=first(ps.first_transmission),
        rays=count.view(spp, p).sum(0), state=new_state)


def _bounces(t: dict, ray: RayBatch, state, max_depth: int, split: bool,
             rr_enabled: bool, rr_start: int, camera_nee: bool, rnd):
    """The bounce loop (the port's ``trace_bounces``) over flat lanes:
    (the ``PathState`` after ``max_depth`` bounces, each lane's rays: its
    camera ray, a shadow ray an NEE sample, and the walk of each later
    bounce it is alive for)."""
    sky, n_lights = t["sky"], t["n_lights"]
    env_nee = sky.has_env_sampling
    ray = RayBatch(rnd(ray.origin), rnd(ray.direction), ray.spec)
    ps = PathState.start(ray, state, split, camera_nee, env_nee)
    casts = int(env_nee) + int(n_lights > 0)
    count = torch.ones_like(state)
    for bounce in range(max_depth):
        k1 = traverse.closest_hit_live(t["tris"], t["chunks"], ps.o, ps.d,
                                       ps.alive)
        nee = shade_nee_plain(ps, t["tris"], k1, t["mats"], t["lights"],
                              n_lights, sky, bounce)
        in_shadow = env_shadow = None
        if env_nee:
            env_shadow = traverse.any_hit(t["tris"], t["chunks"], nee.env_o,
                                          nee.env_d, nee.env_t)
        if n_lights > 0:
            in_shadow = traverse.any_hit(t["tris"], t["chunks"],
                                         nee.shadow_o, nee.shadow_d,
                                         nee.shadow_t)
        shade_scatter_plain(ps, nee, in_shadow, t["mats"], bounce,
                            rr_enabled, rr_start, env_shadow=env_shadow)
        count = count + nee.do_nee.to(torch.int64) * casts
        if bounce + 1 < max_depth:
            count = count + ps.alive.to(torch.int64)
        _round_state(ps, rnd)
    return ps, count


def post_frame(bufs, camera, prev_view_proj: torch.Tensor,
               history: DenoiserState | None, denoise: bool,
               motion_vectors: bool, bloom: bool, rnd=f32):
    """The frame after its trace at full size: (RGB8 (H, W, 3) uint8, the
    new history or None).  ``bufs``: the trace's planes (attributes as the
    port's ``FrameBuffers``), ``history`` the SVGF history the frame
    starts from."""
    bufs = SimpleNamespace(**{k: rnd(v) for k, v in vars(bufs).items()})
    current = bufs.color
    den = None
    if denoise:
        history = round_tree(history, rnd)
        rh, rw = bufs.depth.shape
        if motion_vectors:
            mv = motion_vectors_plain(bufs.depth, camera, prev_view_proj, rw,
                                      rh)
        else:
            zero = torch.zeros((rh, rw), dtype=torch.float32,
                               device=bufs.depth.device)
            mv = (zero, zero)
        current, den = denoise_frame(bufs, mv, history, camera, None,
                                     settings=DEFAULT_SETTINGS)
    current = rnd(current)
    mip0 = bloom_mips(current) if bloom else None
    return tonemap_rgb8_plain(current, 1.0, mip0), den
