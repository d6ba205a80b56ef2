"""Wavefront path integrator — counterpart of ``ptrt_tpu/render/integrator.py``
(``trace_path`` without environment NEE).

Each bounce is one pass of elementwise torch work over every lane of the
wavefront, with the two walks — closest hit (K1) and the NEE shadow ray
(K2) — as kernels.  Terminated lanes stay in the wavefront as dead lanes:
they trace with ``t_max = -1`` and come back as misses, and every
accumulation is masked.  Radiometry matches the reference: Beer–Lambert
interior absorption, emission on bounce 0 / after specular, one-sample NEE
with power-2 MIS, Russian roulette from ``rr_start``, throughput soft clamp
50, NEE clamp 500, final clamp 100.  With ``split`` the radiance is also
routed into the denoiser's diffuse, specular and emission channels: bounce-0
emission to emission; later emission and sky by whether the path has been
specular throughout; NEE by the BSDF's diffuse/specular split.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ptrt_tpu_torch.core import rng as prng
from ptrt_tpu_torch.core.vec import Vec3, clamp_vector_soft, fmax, where
from ptrt_tpu_torch.render import traverse
from ptrt_tpu_torch.render.bsdf import material_pdf, material_scatter, mis_weight
from ptrt_tpu_torch.render.nee import sample_direct_lighting
from ptrt_tpu_torch.render.pbr import beer_lambert
from ptrt_tpu_torch.render.ray import RayBatch
from ptrt_tpu_torch.render.sky import SkyConfig, sample_sky

RUSSIAN_ROULETTE_START_BOUNCE = 2
RUSSIAN_ROULETTE_MIN_PROB = 0.05
MAX_BOUNCE_WEIGHT = 50.0
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
    flag does not suppress bounce-0 NEE."""
    d = ray.direction
    shape = d.x.shape
    dev = d.x.device
    o = ray.origin.broadcast_to(shape)
    zero3 = Vec3.zeros(shape, dev)
    full = lambda v: torch.full(shape, v, dtype=torch.float32, device=dev)

    ray_spec = (torch.zeros(shape, dtype=torch.bool, device=dev)
                if camera_nee else ray.spec.expand(shape))
    throughput = Vec3.ones(shape, dev)
    alive = torch.ones(shape, dtype=torch.bool, device=dev)
    accum = zero3
    acc_diff = acc_spec = acc_emis = zero3
    prev_was_specular = torch.ones(shape, dtype=torch.bool, device=dev)
    path_still_specular = torch.ones(shape, dtype=torch.bool, device=dev)
    first_normal, first_depth = zero3, full(1e30)
    first_object_id = torch.full(shape, -1, dtype=torch.int32, device=dev)
    first_roughness, first_transmission = full(1.0), full(0.0)
    rays = torch.zeros((), dtype=torch.int64, device=dev)

    any_hit = lambda oo, dd, tt: traverse.intersect_any(geom, oo, dd, tt)

    for bounce in range(max_depth):
        is_first = bounce == 0
        rays = rays + alive.sum()
        # dead lanes walk with t_max = -1 and return misses
        hit = traverse.intersect_closest(geom, o, d,
                                         torch.where(alive, 1e30, -1.0))

        mat = materials.gather(hit.mesh_index.clamp_min(0))
        if is_first:
            # bounce-0 G-buffer export
            first_normal = where(hit.hit, hit.normal, zero3)
            first_depth = torch.where(hit.hit, hit.t, 1e30)
            first_object_id = torch.where(hit.hit, hit.mesh_index, -1)
            first_roughness = torch.where(hit.hit, mat.roughness, 1.0)
            first_transmission = torch.where(hit.hit, mat.transmission, 0.0)

        # sky on miss
        miss = alive & ~hit.hit
        sky_c = sample_sky(d, sky) * throughput
        accum = accum + where(miss, sky_c, zero3)
        if split:
            acc_spec = acc_spec + where(miss & path_still_specular, sky_c,
                                        zero3)
            acc_diff = acc_diff + where(miss & ~path_still_specular, sky_c,
                                        zero3)
        alive = alive & hit.hit

        # interior Beer–Lambert absorption, coefficient -log(albedo)
        t_unit = mat.albedo.map(lambda a: fmax(a, 1e-6))
        absorb = beer_lambert(t_unit.map(lambda a: -torch.log(a)), hit.t)
        inside = alive & ~hit.front_face
        throughput = where(inside, throughput * absorb, throughput)

        # emission (bounce 0 or after a specular bounce)
        emissive = ((mat.emission.x > 0.0) | (mat.emission.y > 0.0)
                    | (mat.emission.z > 0.0))
        emit_on = alive & emissive & (is_first | prev_was_specular)
        contrib_e = throughput * mat.emission
        accum = accum + where(emit_on, contrib_e, zero3)
        if split and is_first:
            acc_emis = acc_emis + where(emit_on, contrib_e, zero3)
        elif split:
            acc_spec = acc_spec + where(emit_on & path_still_specular,
                                        contrib_e, zero3)
            acc_diff = acc_diff + where(emit_on & ~path_still_specular,
                                        contrib_e, zero3)

        # NEE with MIS
        do_nee = alive & ~ray_spec
        if n_lights > 0:
            rays = rays + do_nee.sum()
            state, l_nee, pdf_nee, nee_c = sample_direct_lighting(
                state, hit.point, hit.normal, hit.front_face, mat, d, lights,
                n_lights, any_hit, split=split, active=do_nee)
            pdf_brdf = material_pdf(hit.normal, hit.front_face, mat, -d,
                                    l_nee)
            w = mis_weight(pdf_nee, pdf_brdf)
            gate = do_nee & (pdf_nee > 0.0)
            if split:
                nee_d, nee_s = nee_c
                acc_diff = acc_diff + where(gate, throughput * nee_d * w,
                                            zero3)
                acc_spec = acc_spec + where(gate, throughput * nee_s * w,
                                            zero3)
                nee_c = nee_d + nee_s
            accum = accum + where(gate, throughput * nee_c * w, zero3)

        # scatter
        state, sc = material_scatter(state, hit.normal, hit.front_face, mat,
                                     d)
        alive = alive & sc.valid
        prev_was_specular = torch.where(alive, sc.is_specular,
                                        prev_was_specular)
        path_still_specular = path_still_specular & torch.where(
            alive, sc.is_specular, True)

        # Russian roulette
        state, u_rr = prng.uniform(state)
        p = torch.clamp(throughput.max_component(),
                        RUSSIAN_ROULETTE_MIN_PROB, 0.95)
        if rr_enabled and bounce >= rr_start:
            alive = alive & ~(u_rr > p)
            throughput = where(alive, throughput / p, throughput)

        # advance the ray
        throughput = clamp_vector_soft(throughput * sc.attenuation,
                                       MAX_BOUNCE_WEIGHT)
        offset = where(sc.direction.dot(hit.normal) > 0.0,
                       hit.normal * 1e-4, hit.normal * -1e-4)
        o = where(alive, hit.point + offset, o)
        d = where(alive, sc.direction, d)
        ray_spec = torch.where(alive, sc.is_specular, ray_spec)

    radiance = clamp_vector_soft(accum, MAX_FINAL_RADIANCE)
    return state, PathOutput(
        rays_traced=rays, radiance=radiance,
        diffuse=acc_diff if split else None,
        specular=acc_spec if split else None,
        emission=acc_emis if split else None, first_normal=first_normal,
        first_depth=first_depth, first_object_id=first_object_id,
        first_roughness=first_roughness,
        first_transmission=first_transmission)
