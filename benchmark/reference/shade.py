"""Per-bounce shading (K3): the two stages of a bounce around the shadow
walk, over a struct-of-arrays ``PathState``.

A bounce is  K1 ``closest_hit`` -> ``shade_nee`` -> K2 ``any_hit`` ->
``shade_scatter``:

* ``shade_nee`` — the hit record from K1's triangle slot, the material
  fetch, the bounce-0 G-buffer, sky on a miss (routed into the split
  channels; with env NEE MIS-weighted against the env sampler where the
  previous hit drew an env sample off a non-specular scatter), the alive
  update, Beer–Lambert absorption, emission, and the NEE samples: with env
  NEE first the env sample (four PCG draws: its shadow ray, direction, pdf,
  MIS weight against ``material_pdf`` and clamped, unshadowed
  contribution), then the light sample: the shadow rays (``t_max = -1``
  where NEE is off or the lane is dead), the light direction, its pdf and
  the clamped, unshadowed contribution (its diffuse and specular halves
  when ``split``).
* ``shade_scatter`` — the lit tests, the env sample's accumulation, MIS
  against ``material_pdf`` and the light's accumulation,
  ``material_scatter``, the env MIS carries (the scatter direction's
  ``material_pdf`` and whether the lane drew an env sample), Russian
  roulette, the throughput soft clamp and the ray advance.

Both follow the reference's order of operations
(``ptrt_tpu/render/integrator.py:307-466``): the env sample's numbers are
drawn before the light's, and its term is added before the light's.  Env
NEE runs exactly where the sky is an HDRI: such a trace starts with
``PathState.start(..., env_nee=True)`` and carries ``prev_pdf`` and
``prev_did_nee``; the stages refuse an HDRI sky without env NEE and env NEE
without one.

A frozen copy of the plain stages of ``ptrt_tpu_torch/render/shade.py``
(``shade_nee_plain``, ``shade_scatter_plain``, ``count_rays_plain``),
which the benchmark's reference runs on every device.  The plain stages
rebind the ``PathState`` fields to new tensors.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import torch

from benchmark.reference import rng as prng
from benchmark.reference.vec import PI, Vec3, clamp_vector_soft, fmax, where
from benchmark.reference import traverse
from benchmark.reference.bsdf import material_pdf, material_scatter, mis_weight
from benchmark.reference.nee import (direct_lighting_lit,
                                       direct_lighting_setup, env_lighting_lit,
                                       env_lighting_setup)
from benchmark.reference.pbr import beer_lambert
from benchmark.reference.sky import SkyConfig, env_pdf_dir, sample_sky
from benchmark.reference.lights import LightTable
from benchmark.reference.materials import MaterialTable

RUSSIAN_ROULETTE_MIN_PROB = 0.05
MAX_BOUNCE_WEIGHT = 50.0


@dataclass
class PathState:
    """Every lane's path, as flat (N,) planes.  ``diffuse``, ``specular``
    and ``emission`` are the split channels (None unless split); ``rng`` is
    the PCG state (int64 holding values in [0, 2^32)); ``first_*`` is the
    bounce-0 G-buffer; ``prev_pdf`` and ``prev_did_nee`` are the env MIS
    carries (None unless the trace does env NEE): the ``material_pdf`` of
    the last scatter's direction and whether that hit drew an env sample."""

    o: Vec3
    d: Vec3
    throughput: Vec3
    accum: Vec3
    diffuse: Vec3 | None
    specular: Vec3 | None
    emission: Vec3 | None
    alive: torch.Tensor
    ray_spec: torch.Tensor
    prev_was_specular: torch.Tensor
    path_still_specular: torch.Tensor
    rng: torch.Tensor
    first_normal: Vec3
    first_depth: torch.Tensor
    first_object_id: torch.Tensor
    first_roughness: torch.Tensor
    first_transmission: torch.Tensor
    prev_pdf: torch.Tensor | None = None
    prev_did_nee: torch.Tensor | None = None

    @staticmethod
    def start(ray, rng: torch.Tensor, split: bool, camera_nee: bool = True,
              env_nee: bool = False, own: bool = False) -> "PathState":
        """The state before bounce 0 for the rays of a ``RayBatch`` of any
        shape, every plane its own contiguous tensor.  ``camera_nee=True``
        keeps the reference's fix: the camera ray's spec flag does not
        suppress bounce-0 NEE.  ``env_nee`` allocates the env MIS
        carries.  ``own``: the ray's planes and ``rng`` are the caller's
        to give (``camera_rays``' fresh planes): a contiguous one of the
        full shape is taken as it is, not copied, and the kernels then
        update it in place."""
        shape = ray.direction.x.shape
        dev = ray.direction.x.device
        n = ray.direction.x.numel()

        def flat(c):
            if own and c.is_contiguous() and c.shape == shape:
                return c.reshape(-1)
            return c.expand(shape).reshape(-1).clone()

        full = lambda v, dt=torch.float32: torch.full((n,), v, dtype=dt,
                                                      device=dev)
        v3 = lambda v: Vec3(full(v), full(v), full(v))
        ray_spec = (full(False, torch.bool) if camera_nee
                    else flat(ray.spec))
        return PathState(
            o=ray.origin.map(flat), d=ray.direction.map(flat),
            throughput=v3(1.0), accum=v3(0.0),
            diffuse=v3(0.0) if split else None,
            specular=v3(0.0) if split else None,
            emission=v3(0.0) if split else None,
            alive=full(True, torch.bool), ray_spec=ray_spec,
            prev_was_specular=full(True, torch.bool),
            path_still_specular=full(True, torch.bool),
            rng=flat(rng), first_normal=v3(0.0), first_depth=full(1e30),
            first_object_id=full(-1, torch.int32), first_roughness=full(1.0),
            first_transmission=full(0.0),
            prev_pdf=full(0.0) if env_nee else None,
            prev_did_nee=full(False, torch.bool) if env_nee else None)

    @property
    def split(self) -> bool:
        return self.diffuse is not None

    @property
    def env_nee(self) -> bool:
        return self.prev_pdf is not None

    def clone(self) -> "PathState":
        cp = lambda v: (None if v is None else v.map(torch.clone)
                        if isinstance(v, Vec3) else v.clone())
        return PathState(**{f.name: cp(getattr(self, f.name))
                            for f in dataclasses.fields(self)})


class NeeRecord(NamedTuple):
    """What ``shade_nee`` hands the shadow walks and ``shade_scatter``.  The
    shadow fields are None when there is no light to sample, the ``env_*``
    fields without env NEE.  Only ``do_nee``, ``shadow_t``, ``env_t`` and
    ``hit.hit`` hold on every lane; the rest is unspecified where the lane
    is dead or ``do_nee`` is false (the module's note has the contract)."""

    hit: traverse.Hit
    do_nee: torch.Tensor  # bool: the lane casts a shadow ray
    shadow_o: Vec3 | None
    shadow_d: Vec3 | None  # the light direction L
    shadow_t: torch.Tensor | None  # -1 where NEE is off
    pdf: torch.Tensor | None
    contrib: Vec3 | None  # unshadowed, clamped; the diffuse half if split
    contrib_s: Vec3 | None  # the specular half (split only)
    env_o: Vec3 | None = None  # the env shadow ray's origin
    env_d: Vec3 | None = None  # the env sample's direction
    env_t: torch.Tensor | None = None  # 1e28 where do_nee, else -1
    env_pdf: torch.Tensor | None = None  # its solid-angle pdf
    env_w: torch.Tensor | None = None  # MIS weight against material_pdf
    env_c: Vec3 | None = None  # unshadowed, clamped; diffuse half if split
    env_cs: Vec3 | None = None  # the specular half (split only)


# -- the plain stages ----------------------------------------------------------


def shade_nee_plain(ps: PathState, geom, k1: traverse.Closest,
                    materials: MaterialTable, lights: LightTable,
                    n_lights: int, sky: SkyConfig, bounce: int) -> NeeRecord:
    """Plain version of ``shade_nee``: the integrator's torch code from the
    hit to the NEE samples."""
    split, env_nee = ps.split, ps.env_nee
    _check_env(ps, sky)
    is_first = bounce == 0
    d = ps.d
    hit = traverse.hit_record(geom, ps.o, d, k1)
    if not is_first:
        # a lane dead on entry reports no hit, whatever K1's planes hold
        # there (through the alive plane K1 reports none either)
        hit = dataclasses.replace(hit, hit=hit.hit & ps.alive)

    mat = materials.gather(hit.mesh_index.clamp_min(0))
    if is_first:
        # bounce-0 G-buffer export
        ps.first_normal = where(hit.hit, hit.normal, 0.0)
        ps.first_depth = torch.where(hit.hit, hit.t, 1e30)
        ps.first_object_id = torch.where(hit.hit, hit.mesh_index, -1)
        ps.first_roughness = torch.where(hit.hit, mat.roughness, 1.0)
        ps.first_transmission = torch.where(hit.hit, mat.transmission, 0.0)

    # sky on miss; with env NEE, MIS-weighted against the env sampler where
    # the previous hit drew an env sample and did not scatter specularly
    miss = ps.alive & ~hit.hit
    sky_c = sample_sky(d, sky) * ps.throughput
    if env_nee:
        sky_c = sky_c * torch.where(
            ps.prev_did_nee & ~ps.prev_was_specular,
            mis_weight(ps.prev_pdf, env_pdf_dir(sky, d)), 1.0)
    ps.accum = ps.accum + where(miss, sky_c, 0.0)
    if split:
        ps.specular = ps.specular + where(miss & ps.path_still_specular,
                                          sky_c, 0.0)
        ps.diffuse = ps.diffuse + where(miss & ~ps.path_still_specular,
                                        sky_c, 0.0)
    ps.alive = ps.alive & hit.hit

    # interior Beer–Lambert absorption, coefficient -log(albedo)
    t_unit = mat.albedo.map(lambda a: fmax(a, 1e-6))
    absorb = beer_lambert(t_unit.map(lambda a: -torch.log(a)), hit.t)
    inside = ps.alive & ~hit.front_face
    ps.throughput = where(inside, ps.throughput * absorb, ps.throughput)

    # emission (bounce 0 or after a specular bounce)
    emissive = ((mat.emission.x > 0.0) | (mat.emission.y > 0.0)
                | (mat.emission.z > 0.0))
    emit_on = ps.alive & emissive & (is_first | ps.prev_was_specular)
    contrib_e = ps.throughput * mat.emission
    ps.accum = ps.accum + where(emit_on, contrib_e, 0.0)
    if split and is_first:
        ps.emission = ps.emission + where(emit_on, contrib_e, 0.0)
    elif split:
        ps.specular = ps.specular + where(emit_on & ps.path_still_specular,
                                          contrib_e, 0.0)
        ps.diffuse = ps.diffuse + where(emit_on & ~ps.path_still_specular,
                                        contrib_e, 0.0)

    # the NEE samples and their shadow rays: the env's, then the light's
    do_nee = ps.alive & ~ps.ray_spec
    env = ()
    if env_nee:
        ps.rng, l_e, pdf_e, o_e, t_e, out_e = env_lighting_setup(
            ps.rng, hit.point, hit.normal, hit.front_face, mat, d, sky,
            split=split, active=do_nee)
        w_e = mis_weight(pdf_e, material_pdf(hit.normal, hit.front_face, mat,
                                             -d, l_e))
        env = (o_e, l_e, t_e, pdf_e, w_e,
               *(out_e if split else (out_e, None)))
    if n_lights == 0:
        return NeeRecord(hit, do_nee, None, None, None, None, None, None,
                         *env)
    ps.rng, l, pdf, shadow_o, shadow_t, out = direct_lighting_setup(
        ps.rng, hit.point, hit.normal, hit.front_face, mat, d, lights,
        n_lights, split=split, active=do_nee)
    c, c_s = out if split else (out, None)
    return NeeRecord(hit, do_nee, shadow_o, l, shadow_t, pdf, c, c_s, *env)


def _check_env(ps: PathState, sky: SkyConfig) -> None:
    if ps.env_nee != sky.has_env_sampling:
        raise ValueError("env NEE runs exactly where the sky is an HDRI: "
                         "start the PathState with env_nee="
                         "sky.has_env_sampling")


def shade_scatter_plain(ps: PathState, nee: NeeRecord, in_shadow,
                        materials: MaterialTable, bounce: int,
                        rr_enabled: bool, rr_start: int,
                        env_shadow=None) -> None:
    """Plain version of ``shade_scatter``: the integrator's torch code from
    the shadow walks' answers to the next ray."""
    hit, d = nee.hit, ps.d
    mat = materials.gather(hit.mesh_index.clamp_min(0))

    # the env sample, MIS-weighted (its weight computed by shade_nee)
    if ps.env_nee:
        contrib = (nee.env_c, nee.env_cs) if ps.split else nee.env_c
        env_c = env_lighting_lit(contrib, nee.env_pdf, env_shadow)
        w_e = nee.env_w
        gate_e = nee.do_nee & (nee.env_pdf > 0.0)
        if ps.split:
            env_d, env_s = env_c
            ps.diffuse = ps.diffuse + where(gate_e,
                                            ps.throughput * env_d * w_e, 0.0)
            ps.specular = ps.specular + where(
                gate_e, ps.throughput * env_s * w_e, 0.0)
            env_c = env_d + env_s
        ps.accum = ps.accum + where(gate_e, ps.throughput * env_c * w_e, 0.0)

    # NEE with MIS
    if nee.shadow_t is not None:
        contrib = (nee.contrib, nee.contrib_s) if ps.split else nee.contrib
        nee_c = direct_lighting_lit(contrib, nee.pdf, in_shadow)
        pdf_brdf = material_pdf(hit.normal, hit.front_face, mat, -d,
                                nee.shadow_d)
        w = mis_weight(nee.pdf, pdf_brdf)
        gate = nee.do_nee & (nee.pdf > 0.0)
        if ps.split:
            nee_d, nee_s = nee_c
            ps.diffuse = ps.diffuse + where(gate, ps.throughput * nee_d * w,
                                            0.0)
            ps.specular = ps.specular + where(
                gate, ps.throughput * nee_s * w, 0.0)
            nee_c = nee_d + nee_s
        ps.accum = ps.accum + where(gate, ps.throughput * nee_c * w, 0.0)

    # scatter
    ps.rng, sc = material_scatter(ps.rng, hit.normal, hit.front_face, mat, d)
    alive = ps.alive & sc.valid
    if ps.env_nee:
        # the scatter direction's pdf, to MIS-weight a sky hit next bounce
        ps.prev_pdf = torch.where(alive, material_pdf(
            hit.normal, hit.front_face, mat, -d, sc.direction), ps.prev_pdf)
        ps.prev_did_nee = torch.where(alive, nee.do_nee, ps.prev_did_nee)
    ps.prev_was_specular = torch.where(alive, sc.is_specular,
                                       ps.prev_was_specular)
    ps.path_still_specular = ps.path_still_specular & torch.where(
        alive, sc.is_specular, True)

    # Russian roulette
    ps.rng, u_rr = prng.uniform(ps.rng)
    throughput = ps.throughput
    p = torch.clamp(throughput.max_component(), RUSSIAN_ROULETTE_MIN_PROB,
                    0.95)
    if rr_enabled and bounce >= rr_start:
        alive = alive & ~(u_rr > p)
        throughput = where(alive, throughput / p, throughput)

    # advance the ray
    ps.throughput = clamp_vector_soft(throughput * sc.attenuation,
                                      MAX_BOUNCE_WEIGHT)
    offset = where(sc.direction.dot(hit.normal) > 0.0, hit.normal * 1e-4,
                   hit.normal * -1e-4)
    ps.o = where(alive, hit.point + offset, ps.o)
    ps.d = where(alive, sc.direction, d)
    ps.ray_spec = torch.where(alive, sc.is_specular, ps.ray_spec)
    ps.alive = alive


def count_rays_plain(rays: torch.Tensor, alive=None, do_nee=None,
                     casts: int = 0, base: int = 0) -> None:
    """Plain version of the ray count that ``shade_scatter`` adds into the
    0-d int64 counter ``rays`` (in place): ``base``, the true lanes of the
    bool plane ``alive`` and ``casts`` times those of ``do_nee`` (either
    plane None for none)."""
    if base:
        rays += base
    if alive is not None:
        rays += alive.sum()
    if do_nee is not None and casts:
        rays += do_nee.sum() * casts
