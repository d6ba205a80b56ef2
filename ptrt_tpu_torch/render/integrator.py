"""Wavefront path integrator — counterpart of ``ptrt_tpu/render/integrator.py``
(``trace_path``).

Each bounce is four steps over every lane of the wavefront: the closest-hit
walk (K1), ``shade_nee``, the NEE shadow walks (K2: the env sample's rays
with env NEE, then the light's) and ``shade_scatter`` (``render/shade.py``;
on the card the two shading stages are the hand-written K3 kernels).  Terminated lanes stay in the wavefront as dead
lanes: K1 takes the alive plane (``traverse.closest_hit_live``), so they
come back as misses at ``t = -1``, and every accumulation is masked.
Radiometry matches the reference: Beer–Lambert
interior absorption, emission on bounce 0 / after specular, one-sample NEE
with power-2 MIS (with an HDRI, also the alias-sampled env NEE, MIS-weighted
against the BSDF, and BSDF-sampled sky hits weighted against it), Russian
roulette from ``rr_start``, throughput soft clamp
50, NEE clamp 500, final clamp 100.  With ``split`` the radiance is also
routed into the denoiser's diffuse, specular and emission channels: bounce-0
emission to emission; later emission and sky by whether the path has been
specular throughout; NEE by the BSDF's diffuse/specular split.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ptrt_tpu_torch.core.vec import Vec3, clamp_vector_soft
from ptrt_tpu_torch.render import traverse
from ptrt_tpu_torch.render.ray import RayBatch
# the roulette floor and the throughput clamp live with the scatter stage
from ptrt_tpu_torch.render.shade import (MAX_BOUNCE_WEIGHT,  # noqa: F401
                                         RUSSIAN_ROULETTE_MIN_PROB, PathState,
                                         check_state, shade_nee,
                                         shade_scatter)
from ptrt_tpu_torch.render.sky import SkyConfig

RUSSIAN_ROULETTE_START_BOUNCE = 2
MAX_FINAL_RADIANCE = 100.0


class PathOutput(NamedTuple):
    rays_traced: torch.Tensor  # int64 scalar: closest-hit + shadow rays
    radiance: Vec3
    # split channels (None unless split=True)
    diffuse: Vec3 | None
    specular: Vec3 | None
    emission: Vec3 | None
    first_normal: Vec3
    first_depth: torch.Tensor
    first_object_id: torch.Tensor
    first_roughness: torch.Tensor
    first_transmission: torch.Tensor


def trace_path(geom, materials, lights, n_lights: int, sky: SkyConfig,
               ray: RayBatch, state, max_depth: int, split: bool = False,
               rr_enabled: bool = True,
               rr_start: int = RUSSIAN_ROULETTE_START_BOUNCE,
               camera_nee: bool = True):
    """Trace the wavefront to completion.  Returns (rng_state, PathOutput).

    ``camera_nee=True`` keeps the reference's fix: the camera ray's spec
    flag does not suppress bounce-0 NEE.  An HDRI sky turns on its
    importance-sampled NEE (env NEE).

    Every bounce of ``max_depth`` runs, also once no lane is alive: reading
    the alive plane back to stop early would wait for the card."""
    env_nee = sky.has_env_sampling
    shape = ray.direction.x.shape
    ps = PathState.start(ray, state, split, camera_nee, env_nee)
    check_state(ps, materials)  # once: the kernels update ps in place
    rays = torch.zeros((), dtype=torch.int64, device=ps.alive.device)

    for bounce in range(max_depth):
        rays = rays + ps.alive.sum()
        # dead lanes return misses at t = -1
        k1 = traverse.closest_hit_live(geom, ps.o, ps.d, ps.alive)
        nee = shade_nee(ps, geom, k1, materials, lights, n_lights, sky,
                        bounce)
        # a shadow ray a NEE lane for each of the env and the light sample
        casts = int(env_nee) + int(n_lights > 0)
        if casts:
            n_nee = nee.do_nee.sum()
            rays = rays + (n_nee if casts == 1 else n_nee * 2)
        in_shadow = env_shadow = None
        if env_nee:
            env_shadow = traverse.any_hit(geom, nee.env_o, nee.env_d,
                                          nee.env_t)
        if n_lights > 0:
            in_shadow = traverse.any_hit(geom, nee.shadow_o, nee.shadow_d,
                                         nee.shadow_t)
        shade_scatter(ps, nee, in_shadow, materials, bounce,
                      rr_enabled=rr_enabled, rr_start=rr_start,
                      env_shadow=env_shadow)

    rs = lambda v: (None if v is None else v.map(rs)
                    if isinstance(v, Vec3) else v.reshape(shape))
    return rs(ps.rng), PathOutput(
        rays_traced=rays,
        radiance=rs(clamp_vector_soft(ps.accum, MAX_FINAL_RADIANCE)),
        diffuse=rs(ps.diffuse), specular=rs(ps.specular),
        emission=rs(ps.emission), first_normal=rs(ps.first_normal),
        first_depth=rs(ps.first_depth),
        first_object_id=rs(ps.first_object_id),
        first_roughness=rs(ps.first_roughness),
        first_transmission=rs(ps.first_transmission))
