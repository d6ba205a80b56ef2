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

On CUDA tensors each wrapper launches its hand-written kernel
(``csrc/shade.cu``); on CPU tensors it runs the plain version beside it,
which is the reference's integrator body in plain torch.  There is no
fallback between the two.

The kernels update the ``PathState`` planes in place; the plain versions
rebind the ``PathState`` fields to new tensors.  Either way the state holds
the new values after the call, but a caller that kept a reference to an old
plane sees it change on the card and not on the CPU: clone first
(``PathState.clone``) where that matters.  Every lane draws the same PCG
numbers in both.

The record's contract (``NeeRecord``): ``do_nee`` and ``shadow_t`` hold on
every lane (``shadow_t = -1`` where ``do_nee`` is false), and so do
``env_t`` with env NEE (1e28 where ``do_nee``, -1 elsewhere) and
``hit.hit``: K1 found a triangle and, from bounce 1 on, the lane was alive
on entry (K1 through the alive plane reports no hit on a dead lane; the
stage does not read K1's planes there).  On a ``WorldGeometry`` K4 adds
the ``inst`` plane to K1's record; the stage reads it only where K1's slot
holds a hit.  The hit point, normal and front flag are specified only on lanes
still alive after the stage; the shadow origin, L, pdf and contribution,
and the env sample's origin, direction, pdf, MIS weight and contribution,
only where ``do_nee`` is true.  Elsewhere the plain stage holds what it
computed and masks away, and the kernel's planes are never written: a dead
lane moves only its flags, its PCG state and its ``shadow_t`` and
``env_t``.  Nothing
downstream reads an unspecified value: ``shade_scatter`` gates on ``alive``
and ``do_nee``, and the shadow walks skip a ray with ``t_max < 0`` before
they load the ray.  Likewise the kernels leave the throughput of a lane that
dies in a stage as it was, and ``prev_pdf`` and ``prev_did_nee`` are
written only where the lane survives its scatter (the plain stage keeps
the old values elsewhere).

The wrappers check the ``PathState`` planes once a trace: the checked
pointers are kept on the state and used again while its fields are the same
tensors, which on the card they stay for the whole trace.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ptrt_tpu_torch import kernels
from ptrt_tpu_torch.core import rng as prng
from ptrt_tpu_torch.core.vec import PI, Vec3, clamp_vector_soft, fmax, where
from ptrt_tpu_torch.render import traverse
from ptrt_tpu_torch.render.bsdf import material_pdf, material_scatter, mis_weight
from ptrt_tpu_torch.render.nee import (direct_lighting_lit,
                                       direct_lighting_setup, env_lighting_lit,
                                       env_lighting_setup)
from ptrt_tpu_torch.render.pbr import beer_lambert
from ptrt_tpu_torch.render.sky import SkyConfig, env_pdf_dir, sample_sky
from ptrt_tpu_torch.scene.lights import LightTable
from ptrt_tpu_torch.scene.materials import MaterialTable

RUSSIAN_ROULETTE_MIN_PROB = 0.05
MAX_BOUNCE_WEIGHT = 50.0
# ``kernels.launches``' name for the shade_scatter launches that carry the
# ray count (it has no kernel of its own)
COUNT_RAYS = "count_rays (in shade_scatter)"


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


# -- the kernel wrappers ---------------------------------------------------------

_P3 = ctypes.c_void_p * 3
_P = ctypes.c_void_p


class ShadeArgs(kernels.Args):
    """``struct ShadeArgs`` of ``csrc/shade.cu``."""

    _fields_ = [
        ("n", ctypes.c_longlong),
        ("mat", _P), ("lights", _P), ("sky", _P), ("e1", _P3), ("e2", _P3),
        ("n_mats", ctypes.c_int), ("mat_width", ctypes.c_int),
        ("n_light_rows", ctypes.c_int), ("light_width", ctypes.c_int),
        ("n_lights", ctypes.c_int), ("pdf_pick", ctypes.c_float),
        ("hit_t", _P), ("hit_slot", _P), ("hit_mesh", _P),
        ("o", _P3), ("d", _P3), ("thr", _P3), ("acc", _P3), ("acc_d", _P3),
        ("acc_s", _P3), ("acc_e", _P3),
        ("alive", _P), ("ray_spec", _P), ("prev_spec", _P),
        ("path_spec", _P), ("rng", _P),
        ("first_normal", _P3), ("first_depth", _P), ("first_obj", _P),
        ("first_rough", _P), ("first_trans", _P),
        ("hit", _P), ("point", _P3), ("normal", _P3), ("front", _P),
        ("do_nee", _P), ("shadow_o", _P3), ("l", _P3), ("shadow_t", _P),
        ("pdf_nee", _P), ("nee_c", _P3), ("nee_s", _P3), ("in_shadow", _P),
        ("split", ctypes.c_int), ("bounce", ctypes.c_int),
        ("rr_enabled", ctypes.c_int), ("rr_start", ctypes.c_int),
        # the HDRI sky and env NEE (null / 0 without them)
        ("env_map", _P), ("env_alias", _P), ("env_pdf_table", _P),
        ("env_map_h", ctypes.c_int), ("env_map_w", ctypes.c_int),
        ("env_sh", ctypes.c_int), ("env_sw", ctypes.c_int),
        ("env_inv_sh", ctypes.c_float), ("env_inv_sw", ctypes.c_float),
        ("env_pi_sh", ctypes.c_float), ("env_nee", ctypes.c_int),
        ("prev_pdf", _P), ("prev_nee", _P),
        ("env_o", _P3), ("env_l", _P3), ("env_t", _P), ("env_pdf", _P),
        ("env_mis", _P), ("env_c", _P3), ("env_cs", _P3),
        ("in_shadow_env", _P),
        # instances (null without them)
        ("hit_inst", _P), ("inst_e1", _P3), ("inst_e2", _P3),
        ("inst_mats", _P),
        # the trace's ray count (shade_scatter; null: none)
        ("rays", _P), ("count_base", ctypes.c_longlong),
        ("count_casts", ctypes.c_int), ("count_next", ctypes.c_int),
    ]


_F32, _BOOL, _I32 = torch.float32, torch.bool, torch.int32
# PathState field -> (ShadeArgs field, dtype); the split channels may be None
_STATE = (("o", "o", _F32), ("d", "d", _F32), ("throughput", "thr", _F32),
          ("accum", "acc", _F32), ("diffuse", "acc_d", _F32),
          ("specular", "acc_s", _F32), ("emission", "acc_e", _F32),
          ("alive", "alive", _BOOL), ("ray_spec", "ray_spec", _BOOL),
          ("prev_was_specular", "prev_spec", _BOOL),
          ("path_still_specular", "path_spec", _BOOL),
          ("rng", "rng", torch.int64), ("first_normal", "first_normal", _F32),
          ("first_depth", "first_depth", _F32),
          ("first_object_id", "first_obj", _I32),
          ("first_roughness", "first_rough", _F32),
          ("first_transmission", "first_trans", _F32),
          ("prev_pdf", "prev_pdf", _F32), ("prev_did_nee", "prev_nee", _BOOL))
_OPTIONAL = ("diffuse", "specular", "emission", "contrib_s", "prev_pdf",
             "prev_did_nee", "env_contrib_s")


def _ptrs(name: str, v, n: int, dtype, dev) -> list:
    """Check the flat (n,) planes of a Vec3 or tensor; return their
    pointers (three nulls for an optional Vec3 that is None)."""
    if v is None and name in _OPTIONAL:
        return [None] * 3
    comps = [v.x, v.y, v.z] if isinstance(v, Vec3) else [v]
    for k, c in enumerate(comps):
        if (isinstance(c, torch.Tensor) and c.dtype == dtype
                and c.dim() == 1 and c.shape[0] == n and c.device == dev
                and c.is_contiguous()):
            continue
        cname = f"{name}.{'xyz'[k]}" if isinstance(v, Vec3) else name
        kernels.check_tensor(cname, c, dtype, 1, dev)
        raise ValueError(f"{cname}: length {c.shape[0]} != {n} lanes")
    return [c.data_ptr() for c in comps]


def _set(a: ShadeArgs, field: str, ptrs: list) -> None:
    """Set a pointer field (null stays null: ``ShadeArgs`` starts zeroed)."""
    if any(p is not None for p in ptrs):
        setattr(a, field, _P3(*ptrs) if len(ptrs) == 3 else ptrs[0])


def _out(v) -> list:
    """Pointers of an output the wrapper allocated (None: three nulls)."""
    if v is None:
        return [None] * 3
    return ([c.data_ptr() for c in (v.x, v.y, v.z)] if isinstance(v, Vec3)
            else [v.data_ptr()])


def _check_table(name: str, t: torch.Tensor, min_width: int, dev) -> None:
    kernels.check_tensor(name, t, _F32, 2, dev)
    if t.shape[0] < 1 or t.shape[1] < min_width:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, need at least "
                         f"(1, {min_width})")


def _kept(ps: PathState, tag: str, key: tuple, build):
    """``build()``, kept on ``ps`` under ``tag`` and rebuilt only when an
    object of ``key`` is not the one it was built from.  On the card the
    kernels update the planes in place, so a trace checks its planes and
    fills their pointers once, not once a stage; the plain stages rebind
    the planes, so on the CPU every call checks them again.  (A plane
    resized or restrided in place is not seen.)"""
    kept = ps.__dict__.setdefault("_kernel_args", {})
    entry = kept.get(tag)
    if entry is None or any(a is not b for a, b in zip(entry[0], key)):
        entry = kept[tag] = (key, build())
    return entry[1]


def _checked(ps: PathState, materials: MaterialTable, inputs) -> tuple:
    """Check every plane of ``ps``, the material table and ``inputs``
    ((ShadeArgs field, name, value, dtype) of the stage's records) as the
    kernels take them: the dtype, flat, one length, one device, contiguous.
    Returns (lanes, device, a fresh ShadeArgs with their pointers)."""
    key = (materials.packed, *(getattr(ps, name) for name, _, _ in _STATE))

    def build():
        dev = ps.alive.device
        kernels.require_supported(dev)
        kernels.check_tensor("alive", ps.alive, _BOOL, 1, dev)
        n = ps.alive.shape[0]
        if not (ps.diffuse is None) == (ps.specular is None) == (
                ps.emission is None):
            raise ValueError("the split channels are all set or all None")
        if (ps.prev_pdf is None) != (ps.prev_did_nee is None):
            raise ValueError("the env MIS carries are both set or both None")
        _check_table("materials.packed", materials.packed, 27, dev)
        a = ShadeArgs()
        for name, field, dtype in _STATE:
            _set(a, field, _ptrs(name, getattr(ps, name), n, dtype, dev))
        a.n = n
        a.mat = materials.packed.data_ptr()
        a.n_mats, a.mat_width = materials.packed.shape
        a.split = int(ps.split)
        return n, dev, a

    n, dev, kept = _kept(ps, "state", key, build)
    a = ShadeArgs.from_buffer_copy(kept)
    for field, name, v, dtype in inputs:
        _set(a, field, _ptrs(name, v, n, dtype, dev))
    return n, dev, a


def check_state(ps: PathState, materials: MaterialTable) -> None:
    """Check ``ps``'s planes and the material table as the kernels take
    them and keep their pointers on ``ps`` (the wrappers do it at their
    first call on a state, and again only when a plane is replaced)."""
    _checked(ps, materials, [])


def _planes(n: int, dev, dtype, rows: int) -> list:
    """``rows`` fresh (n,) planes from one allocation."""
    return list(torch.empty((rows, n), dtype=dtype, device=dev).unbind(0))


def shade_nee(ps: PathState, geom, k1: traverse.Closest,
              materials: MaterialTable, lights: LightTable, n_lights: int,
              sky: SkyConfig, bounce: int) -> NeeRecord:
    """The first stage of a bounce (kernel ``shade_nee``; with an HDRI sky
    its HDRI instantiation), after K1 gave ``k1`` for the rays ``ps.o``,
    ``ps.d``.  Updates ``ps`` (in place on the card) and returns the hit
    record and the shadow rays, specified as the module's note says.
    ``n_lights == 0`` means no light sample: no light shadow rays and no PCG
    draws for it; a state with env NEE (``ps.env_nee``) draws the env
    sample whatever ``n_lights``."""
    inputs = [("hit_t", "k1.t", k1.t, _F32),
              ("hit_slot", "k1.slot", k1.slot, _I32),
              ("hit_mesh", "k1.mesh", k1.mesh, _I32)]
    iset = traverse.iset_of(geom)
    if (k1.inst is None) != (iset is None):
        raise ValueError("k1.inst: the instance plane comes with a "
                         "WorldGeometry's instance set, and only with it")
    if iset is not None:
        inputs.append(("hit_inst", "k1.inst", k1.inst, _I32))
    n, dev, a = _checked(ps, materials, inputs)
    if n_lights > 0:
        _check_table("lights.packed", lights.packed, 17, dev)
    env_nee = ps.env_nee
    _check_env(ps, sky)
    if dev.type == "cpu":
        return shade_nee_plain(ps, geom, k1, materials, lights, n_lights,
                               sky, bounce)
    static = traverse.static_of(geom)
    inst_geom = None if iset is None else iset.geom

    def scene_args():  # the triangle edges and the sky: once a trace
        m = static.num_tri_slots
        # top, bottom, use_sky; an HDRI's rotation (read only by the HDRI
        # instantiation) after them
        sky_v = torch.stack([sky.top.x, sky.top.y, sky.top.z, sky.bottom.x,
                             sky.bottom.y, sky.bottom.z, sky.use_sky]
                            + ([sky.env_rotation] if env_nee else [])).to(
            device=dev, dtype=_F32)
        if env_nee:
            if sky.env_quads is None:
                raise ValueError("sky.env_quads: None; a SkyConfig whose "
                                 "map lies on the card makes its quads")
            quads = sky.env_quads.tensor
            kernels.check_tensor("sky.env_quads", quads, _F32, 4, dev)
            if quads.shape != (*sky.env.shape[:2], 4, 4):
                raise ValueError(f"sky.env_quads: shape "
                                 f"{tuple(quads.shape)}, need the map's "
                                 f"(H, W, 4, 4) quads")
            sh, sw = sky.env_sample_hw
            _check_table("sky.env_alias", sky.env_alias, 2, dev)
            kernels.check_tensor("sky.env_pdf", sky.env_pdf, _F32, 1, dev)
            if not (sky.env_alias.shape[0] == sky.env_pdf.shape[0]
                    == sh * sw > 0):
                raise ValueError("the env tables do not hold SH x SW rows")
        inst = ()
        if inst_geom is not None:
            mi = inst_geom.num_tri_slots
            inst = (_ptrs("iset.e1", inst_geom.e1, mi, _F32, dev),
                    _ptrs("iset.e2", inst_geom.e2, mi, _F32, dev))
        return (_ptrs("geom.e1", static.e1, m, _F32, dev),
                _ptrs("geom.e2", static.e2, m, _F32, dev), sky_v, inst)

    e1, e2, sky_v, inst_edges = _kept(ps, "scene", (
        static.e1, static.e2, sky.top, sky.bottom, sky.use_sky,
        sky.env_quads, sky.env_rotation, sky.env_alias, sky.env_pdf,
        None if inst_geom is None else inst_geom.e1,
        None if inst_geom is None else inst_geom.e2), scene_args)
    if iset is not None:
        _check_table("iset.mats", iset.mats, 24, dev)
        _set(a, "inst_e1", inst_edges[0])
        _set(a, "inst_e2", inst_edges[1])
        a.inst_mats = iset.mats.data_ptr()
    _set(a, "e1", e1)
    _set(a, "e2", e2)
    a.sky = sky_v.data_ptr()
    if env_nee:
        a.env_map = sky.env_quads.tensor.data_ptr()
        a.env_map_h, a.env_map_w = sky.env_quads.tensor.shape[:2]
        sh, sw = sky.env_sample_hw
        a.env_nee = 1
        a.env_alias = sky.env_alias.data_ptr()
        a.env_pdf_table = sky.env_pdf.data_ptr()
        a.env_sh, a.env_sw = sh, sw
        # the reference's Python-side constants, rounded once to float32
        a.env_inv_sh, a.env_inv_sw = 1.0 / sh, 1.0 / sw
        a.env_pi_sh = PI / sh
    a.bounce = int(bounce)
    found, front, do_nee = _planes(n, dev, _BOOL, 3)
    nee = n_lights > 0
    f = _planes(n, dev, _F32, 6 + (14 + 3 * ps.split if nee else 0))
    v3 = lambda k: Vec3(*f[k:k + 3])
    point, normal = v3(0), v3(3)
    for field, v in (("hit", found), ("front", front), ("do_nee", do_nee),
                     ("point", point), ("normal", normal)):
        _set(a, field, _out(v))
    shadow = [None] * 6
    if nee:
        a.lights = lights.packed.data_ptr()
        a.n_light_rows, a.light_width = lights.packed.shape
        a.n_lights = int(n_lights)
        a.pdf_pick = 1.0 / float(n_lights)
        shadow = [v3(6), v3(9), f[12], f[13], v3(14),
                  v3(17) if ps.split else None]
        for field, v in zip(("shadow_o", "l", "shadow_t", "pdf_nee", "nee_c",
                             "nee_s"), shadow):
            _set(a, field, _out(v))
    env = ()
    if env_nee:
        e = _planes(n, dev, _F32, 12 + 3 * ps.split)
        ev3 = lambda k: Vec3(*e[k:k + 3])
        env = (ev3(0), ev3(3), e[6], e[7], e[8], ev3(9),
               ev3(12) if ps.split else None)
        for field, v in zip(("env_o", "env_l", "env_t", "env_pdf", "env_mis",
                             "env_c", "env_cs"), env):
            _set(a, field, _out(v))
    rc = kernels.get_lib().ptrt_shade_nee(ctypes.addressof(a),
                                          kernels.stream_ptr(dev))
    name = "shade_nee (hdri)" if env_nee else "shade_nee"
    kernels.launches[name] += 1
    kernels.check(rc, name)
    hit = traverse.Hit(hit=found, t=k1.t, point=point, normal=normal,
                       front_face=front, mesh_index=k1.mesh, u=k1.u, v=k1.v)
    return NeeRecord(hit, do_nee, *shadow, *env)


def shade_scatter(ps: PathState, nee: NeeRecord, in_shadow,
                  materials: MaterialTable, bounce: int,
                  rr_enabled: bool = True, rr_start: int = 2,
                  env_shadow=None, rays: torch.Tensor | None = None,
                  casts: int = 0, next_bounce: bool = False,
                  base: int = 0) -> None:
    """The second stage of a bounce (kernel ``shade_scatter``; with env NEE
    its HDRI instantiation): ``in_shadow`` is K2's answer for ``nee``'s
    light shadow rays (None without lights), ``env_shadow`` for its env
    shadow rays (None without env NEE).  Updates ``ps`` (in place on the
    card).

    With ``rays``, the trace's 0-d int64 counter on the state's device, it
    also counts the bounce's rays into it (the kernel's epilogue; on the
    CPU ``count_rays_plain`` after the plain stage): ``base``, ``casts``
    (0-2) shadow rays for each lane with ``nee.do_nee`` and, with
    ``next_bounce``, the lanes left alive for the next bounce's walk."""
    if rays is None:
        if casts or next_bounce or base:
            raise ValueError("the ray count's arguments come with rays, "
                             "the trace's counter")
    elif casts not in (0, 1, 2):
        raise ValueError(f"casts: {casts!r}, a NEE lane casts 0-2 shadow "
                         f"rays")
    hit = nee.hit
    inputs = [("point", "hit.point", hit.point, _F32),
              ("normal", "hit.normal", hit.normal, _F32),
              ("front", "hit.front_face", hit.front_face, _BOOL),
              ("hit_mesh", "hit.mesh_index", hit.mesh_index, _I32),
              ("do_nee", "do_nee", nee.do_nee, _BOOL)]
    has_nee = nee.shadow_t is not None
    if has_nee:
        if ps.split != (nee.contrib_s is not None):
            raise ValueError("contrib_s: the split state needs the specular "
                             "half of the NEE record, and only it")
        inputs += [("in_shadow", "in_shadow", in_shadow, _BOOL),
                   ("l", "shadow_d", nee.shadow_d, _F32),
                   ("pdf_nee", "pdf", nee.pdf, _F32),
                   ("nee_c", "contrib", nee.contrib, _F32),
                   ("nee_s", "contrib_s", nee.contrib_s, _F32)]
    if ps.env_nee:
        if nee.env_t is None or ps.split != (nee.env_cs is not None):
            raise ValueError("env NEE needs the record's env sample, with "
                             "its specular half exactly when split")
        inputs += [("in_shadow_env", "env_shadow", env_shadow, _BOOL),
                   ("env_pdf", "env_pdf", nee.env_pdf, _F32),
                   ("env_mis", "env_w", nee.env_w, _F32),
                   ("env_c", "env_contrib", nee.env_c, _F32),
                   ("env_cs", "env_contrib_s", nee.env_cs, _F32)]
    n, dev, a = _checked(ps, materials, inputs)
    if rays is not None:
        kernels.check_tensor("rays", rays, torch.int64, 0, dev)
    if dev.type == "cpu":
        shade_scatter_plain(ps, nee, in_shadow, materials, bounce,
                            rr_enabled, rr_start, env_shadow)
        if rays is not None:
            count_rays_plain(rays, ps.alive if next_bounce else None,
                             nee.do_nee if casts else None, casts, base)
        return
    a.n_lights = int(has_nee)  # > 0: the NEE record is there
    a.env_nee = int(ps.env_nee)
    a.bounce = int(bounce)
    a.rr_enabled, a.rr_start = int(bool(rr_enabled)), int(rr_start)
    if rays is not None:
        a.rays, a.count_base = rays.data_ptr(), int(base)
        a.count_casts, a.count_next = int(casts), int(bool(next_bounce))
    rc = kernels.get_lib().ptrt_shade_scatter(ctypes.addressof(a),
                                              kernels.stream_ptr(dev))
    name = "shade_scatter (hdri)" if ps.env_nee else "shade_scatter"
    kernels.launches[name] += 1
    if rays is not None:  # the count rode on this launch
        kernels.launches[COUNT_RAYS] += 1
    kernels.check(rc, name)


# the K3 launches (csrc/shade.cu): a shade_nee block of NEE_THREADS threads
# takes NEE_CHUNK lanes, its HDRI kernel's from bounce 1 on NEE_THREADS *
# ENV_NEE_LANES (kNeeThreads, kNeeChunk, kEnvNeeLanes), and stages the
# material and light tables when they fit together; a shade_scatter block
# of SCATTER_THREADS threads takes one lane a thread at bounce 0 and
# SCATTER_LANES from bounce 1 on (kScatterThreads, kScatterLanes), and
# stages the material table when it fits (kMaxStagedBytes)
NEE_THREADS, NEE_CHUNK, ENV_NEE_LANES = 256, 512, 4
SCATTER_THREADS, SCATTER_LANES = 256, 4
MAX_STAGED_BYTES = 48 * 1024


class Launch(NamedTuple):
    """How a K3 kernel cuts ``n`` lanes into blocks."""

    threads: int
    chunk: int  # lanes a block
    blocks: int
    staged_bytes: int  # the tables in shared memory, 0: not staged

    def block_lanes(self, b: int, n: int) -> range:
        """The lanes block ``b`` takes."""
        return range(b * self.chunk, min(n, (b + 1) * self.chunk))


def _launch(n: int, threads: int, chunk: int, tables) -> Launch:
    nbytes = sum(t.numel() * t.element_size() for t in tables)
    return Launch(threads, chunk, -(-n // chunk),
                  nbytes if nbytes <= MAX_STAGED_BYTES else 0)


def nee_launch(n: int, materials: MaterialTable, lights: LightTable,
               n_lights: int, bounce: int, hdri: bool) -> Launch:
    """The blocks and shared memory of a ``shade_nee`` launch over ``n``
    lanes at ``bounce`` with these tables (the light table only where
    ``n_lights > 0``); ``hdri``: its HDRI kernel, which lists each block's
    live lanes from bounce 1 on."""
    chunk = (NEE_THREADS * ENV_NEE_LANES if hdri and bounce > 0
             else NEE_CHUNK)
    tables = [materials.packed] + ([lights.packed] if n_lights > 0 else [])
    return _launch(n, NEE_THREADS, chunk, tables)


def scatter_launch(n: int, materials: MaterialTable,
                   bounce: int) -> Launch:
    """The blocks and shared memory of a ``shade_scatter`` launch over ``n``
    lanes at ``bounce`` with this material table (its HDRI kernel's
    alike)."""
    chunk = SCATTER_THREADS * (1 if bounce == 0 else SCATTER_LANES)
    return _launch(n, SCATTER_THREADS, chunk, [materials.packed])


def kernel_info(materials: MaterialTable, lights: LightTable,
                hdri: bool = False) -> dict:
    """{kernel: registers, local-memory bytes a thread, threads and lanes a
    block, resident blocks a SM and dynamic shared bytes a block} of the K3
    kernels as built, with these tables: ``shade_nee``, ``shade_scatter``
    at bounce 0 and from bounce 1 on, or with ``hdri`` their HDRI (env NEE)
    kernels, named with " (hdri)", and the HDRI ``shade_nee`` from bounce 1
    on too (measurement only; needs the card)."""
    a = ShadeArgs()
    a.env_nee = int(hdri)  # selects the instantiation
    a.n = 1
    a.mat = materials.packed.data_ptr()
    a.n_mats, a.mat_width = materials.packed.shape
    a.lights = lights.packed.data_ptr()
    a.n_light_rows, a.light_width = lights.packed.shape
    out = {}
    tag = " (hdri)" if hdri else ""
    kinds = ((0, 0, f"shade_nee{tag}"),) + (
        ((0, 1, f"shade_nee{tag} from bounce 1"),) if hdri else ()) + (
        (1, 0, f"shade_scatter{tag}"),
        (1, 1, f"shade_scatter{tag} from bounce 1"))
    for stage, bounce, name in kinds:
        a.bounce = bounce
        vals = [ctypes.c_int() for _ in range(6)]
        rc = kernels.get_lib().ptrt_shade_info(
            stage, ctypes.addressof(a), *[ctypes.byref(v) for v in vals])
        kernels.check(rc, f"{name} info")
        out[name] = dict(zip(("registers", "local_bytes", "threads",
                              "block_lanes", "blocks_per_sm", "shared_bytes"),
                             (v.value for v in vals)))
    return out
