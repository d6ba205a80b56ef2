"""Wavefront path integrator — counterpart of ``ptrt_tpu/render/integrator.py``
(``trace_path``).

Each bounce is four steps over every lane of the wavefront: the
closest-hit walk (K1), ``shade_nee``, the NEE shadow walks (K2: the env
sample's rays with env NEE, then the light's) and ``shade_scatter``
(``render/shade.py``; on the card the two shading stages are the
hand-written K3 kernels), which also adds the bounce's rays into the
trace's int64 counter on the device (the bounce's NEE lanes and the next
bounce's live lanes; ``shade.count_rays_plain`` on the CPU).  Terminated
lanes stay in the wavefront as dead lanes: K1 takes the alive plane
(``traverse.closest_hit_live``), so they come back as misses at
``t = -1``, and every accumulation is masked.
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


def trace_bounces(geom, materials, lights, n_lights: int, sky: SkyConfig,
                  ray: RayBatch, state, max_depth: int, rays: torch.Tensor,
                  split: bool = False, rr_enabled: bool = True,
                  rr_start: int = RUSSIAN_ROULETTE_START_BOUNCE,
                  camera_nee: bool = True,
                  own_ray: bool = False) -> PathState:
    """The bounce loop of ``trace_path``: the wavefront's ``PathState``
    after ``max_depth`` bounces (its flat planes), the rays traced (closest
    hit and shadow rays) added into ``rays``, a 0-d int64 tensor on the
    state's device.

    One count a bounce, in ``shade_scatter``: the bounce's NEE lanes (a
    shadow ray each for the env and the light sample) and the lanes alive
    for the next bounce's closest-hit walk, the plane K1 walks there (the
    shading stages clear ``alive`` on misses and on roulette); bounce 0's
    walk takes every lane, since ``PathState.start`` makes each alive."""
    env_nee = sky.has_env_sampling
    ps = PathState.start(ray, state, split, camera_nee, env_nee,
                         own=own_ray)
    check_state(ps, materials)  # once: the kernels update ps in place
    # a shadow ray a NEE lane for each of the env and the light sample
    casts = int(env_nee) + int(n_lights > 0)

    for bounce in range(max_depth):
        # dead lanes return misses at t = -1
        k1 = traverse.closest_hit_live(geom, ps.o, ps.d, ps.alive)
        nee = shade_nee(ps, geom, k1, materials, lights, n_lights, sky,
                        bounce)
        in_shadow = env_shadow = None
        if env_nee:
            env_shadow = traverse.any_hit(geom, nee.env_o, nee.env_d,
                                          nee.env_t)
        if n_lights > 0:
            in_shadow = traverse.any_hit(geom, nee.shadow_o, nee.shadow_d,
                                         nee.shadow_t)
        shade_scatter(ps, nee, in_shadow, materials, bounce,
                      rr_enabled=rr_enabled, rr_start=rr_start,
                      env_shadow=env_shadow, rays=rays, casts=casts,
                      next_bounce=bounce + 1 < max_depth,
                      base=ps.alive.numel() if bounce == 0 else 0)
    return ps


def trace_path(geom, materials, lights, n_lights: int, sky: SkyConfig,
               ray: RayBatch, state, max_depth: int, split: bool = False,
               rr_enabled: bool = True,
               rr_start: int = RUSSIAN_ROULETTE_START_BOUNCE,
               camera_nee: bool = True, own_ray: bool = False):
    """Trace the wavefront to completion.  Returns (rng_state, PathOutput).

    ``camera_nee=True`` keeps the reference's fix: the camera ray's spec
    flag does not suppress bounce-0 NEE.  An HDRI sky turns on its
    importance-sampled NEE (env NEE).  ``own_ray``: the ray's planes and
    ``state`` are the trace's to update in place (``PathState.start``'s
    ``own``), as ``trace_frame``'s camera rays are.

    Every bounce of ``max_depth`` runs, also once no lane is alive: reading
    the alive plane back to stop early would wait for the card.  A frame
    (``pipeline.trace_frame``) runs ``trace_bounces`` and takes the final
    clamp into its sample sums (K13 ``sample_sums``)."""
    shape = ray.direction.x.shape
    rays = torch.zeros((), dtype=torch.int64, device=state.device)
    ps = trace_bounces(geom, materials, lights, n_lights, sky, ray, state,
                       max_depth, rays, split=split, rr_enabled=rr_enabled,
                       rr_start=rr_start, camera_nee=camera_nee,
                       own_ray=own_ray)
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
