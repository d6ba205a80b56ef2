"""The per-bounce shading stages against the JAX reference, and their
kernel wrappers on the CPU.

``shade_nee_plain`` -> a given occlusion mask -> ``shade_scatter_plain``
runs one bounce over fixed random lanes: the materials of
``test_torch_shading.py`` (the bench scene's presets plus random mixes of
every lobe, from the same numpy seed), a point, a soft spot, a directional
and an area light (the reference's ``Light`` factories and
``LightTable.from_lights``), hits from per-lane triangles, misses, dead
lanes, specular rays (no NEE), and random path flags and accumulators.  The
reference runs the same bounce as its integrator's body composes it
(``ptrt_tpu/render/integrator.py:307-466``: sky, Beer–Lambert, emission,
``sample_direct_lighting``, ``material_pdf``, ``mis_weight``,
``material_scatter``, Russian roulette, the advance), with the same mask as
its shadow walk.

Bounds: PCG states and every flag (alive, specular flags, NEE lanes) exact;
values at the tiers of ``test_torch_shading.py`` and for its reasons —
directions and shadow origins to rtol 1e-5 on every lane, NEE and MIS
terms (accumulators, pdf, shadow t_max) at rtol 1e-5 on 99.5% and 1e-3 on
all, the throughput (times the scatter attenuation f/pdf) at the GGX-peak
tiers.

The slice: a 32x24 scene with a glass sphere, a clear-coated cube, a
directional and an area light, depth 3, the port's ``trace_frame`` against
the reference's, as ``test_torch_slice.py`` compares them (object id and
the material G-buffer exact, depth and normal to rtol 1e-5, energy within
1%).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ptrt_tpu.app.bench_scene import build_bench_scene as ref_bench_scene
from ptrt_tpu.core import rng as ref_rng
from ptrt_tpu.core.vec import Vec3 as RefVec3
from ptrt_tpu.core.vec import clamp_vector_soft as ref_clamp_soft
from ptrt_tpu.core.vec import where as ref_where
from ptrt_tpu.render import bsdf as ref_bsdf
from ptrt_tpu.render import nee as ref_nee
from ptrt_tpu.render import pipeline as ref_pipeline
from ptrt_tpu.render.pbr import beer_lambert as ref_beer_lambert
from ptrt_tpu.render.sky import SkyConfig as RefSky
from ptrt_tpu.render.sky import sample_sky as ref_sample_sky
from ptrt_tpu.scene.lights import Light as RefLight
from ptrt_tpu.scene.lights import LightTable as RefLightTable
from ptrt_tpu.scene.materials import Material as RefMaterial
from ptrt_tpu.scene.materials import MaterialTable as RefMaterialTable
from ptrt_tpu.scene.materials import Materials as RefMaterials
from ptrt_tpu.scene.pt_scene import Scene as RefScene

from ptrt_tpu_torch import tables
from ptrt_tpu_torch.app.bench_scene import build_bench_scene
from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.render import pipeline, shade, traverse
from ptrt_tpu_torch.render.nee import direct_lighting_lit
from ptrt_tpu_torch.render.sky import SkyConfig
from ptrt_tpu_torch.scene.lights import LightTable
from ptrt_tpu_torch.scene.materials import MaterialTable
from ptrt_tpu_torch.scene.pt_scene import Scene
from test_torch_kernels_cpu import no_kernels  # noqa: F401
from test_torch_shading import (AT_PEAK, DIRECTION, VALUE, _close,  # noqa: F401
                                torch_one_thread)
from test_torch_slice import ref_np

N = 4096
CPU = torch.device("cpu")
SHADOW = np.arange(N) % 3 == 0  # the occlusion mask both sides get


def _unit(r, n):
    a = r.normal(size=(n, 3)).astype(np.float32)
    return a / np.linalg.norm(a, axis=1, keepdims=True)


def _materials(r):
    """The materials of test_torch_shading.py, drawn the same way."""
    sc = ref_bench_scene(32, 24, target_tris=500)
    mats = list(sc.mesh_materials)
    for _ in range(16):  # random mixes of every lobe
        mats.append(RefMaterial.make(
            tuple(r.uniform(0.05, 1.0, 3)), float(r.uniform(0.0, 1.0)),
            float(r.choice([0.0, r.uniform(0, 1)])),
            transmission=float(r.choice([0.0, 0.0, r.uniform(0.3, 1.0)])),
            ior=float(r.uniform(1.1, 2.4)),
            clearcoat=float(r.choice([0.0, r.uniform(0, 1)])),
            clearcoat_roughness=float(r.uniform(0.0, 0.4)),
            sheen=float(r.choice([0.0, r.uniform(0, 1)])),
            sheen_tint=tuple(r.uniform(0, 1, 3)),
            iridescence=float(r.choice([0.0, r.uniform(0, 1)])),
            iridescence_thickness=float(r.uniform(250, 800))))
    return mats


LIGHTS = [
    RefLight.point((0.0, 4.0, 5.0), (1.0, 0.9, 0.8), 5.0, range=20.0,
                   radius=0.1),
    RefLight.spot((1.0, 6.0, 6.0), (0.1, -1.0, 0.2), (0.9, 0.9, 1.0), 6.0,
                  inner_cone=0.3, outer_cone=0.6, radius=0.2),
    RefLight.directional((0.3, -1.0, 0.4), (1.0, 0.95, 0.9), 2.0),
    RefLight.area((-2.0, 5.0, 6.0), (0.2, -1.0, 0.0), 1.5, 0.8,
                  (1.0, 1.0, 0.9), 8.0),
]


@pytest.fixture(scope="module")
def lanes():
    r = np.random.default_rng(2024)
    mats = _materials(r)
    ref_table = RefMaterialTable.from_materials(mats)
    ids = r.integers(0, len(mats), N).astype(np.int32)
    n_geo = _unit(r, N)
    d = _unit(r, N)
    # most rays arrive from the geometric normal's side, some from behind
    flip = (np.sum(n_geo * d, 1) > 0) & (r.random(N) < 0.8)
    d[flip] = -d[flip]
    point = (r.uniform(-4, 4, (N, 3)) + [0, 0.5, 6]).astype(np.float32)
    t = r.uniform(0.5, 5.0, N).astype(np.float32)
    o = (point - d * t[:, None]).astype(np.float32)
    # per-lane triangles whose edge cross product is the geometric normal
    e1 = _unit(r, N)
    e1 = e1 - n_geo * np.sum(e1 * n_geo, 1, keepdims=True)
    e1 = (e1 / np.linalg.norm(e1, axis=1, keepdims=True)).astype(np.float32)
    e2 = np.cross(n_geo, e1).astype(np.float32)
    miss = r.random(N) < 0.1
    ref_lights = RefLightTable.from_lights(LIGHTS)
    return dict(
        mats=mats, ref_table=ref_table, ids=ids, d=d, o=o, t=t, e1=e1, e2=e2,
        slot=np.where(miss, -1, np.arange(N)).astype(np.int32),
        alive=r.random(N) < 0.88, ray_spec=r.random(N) < 0.2,
        prev_spec=r.random(N) < 0.5, path_spec=r.random(N) < 0.3,
        throughput=r.uniform(0.05, 3.0, (N, 3)).astype(np.float32),
        accum=[r.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
               for _ in range(4)],
        state=r.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32),
        ref_lights=ref_lights,
        lights=LightTable(torch.from_numpy(np.array(ref_lights.packed))),
        table=MaterialTable(torch.from_numpy(np.array(ref_table.packed))),
    )


def _pv(a):
    return Vec3(*[torch.from_numpy(np.ascontiguousarray(a[:, k]))
                  for k in range(3)])


def _rv(v):
    """A port Vec3 (or an (N, 3) array) as a reference Vec3."""
    if isinstance(v, Vec3):
        return RefVec3(*[jnp.asarray(c.numpy()) for c in (v.x, v.y, v.z)])
    return RefVec3(*[jnp.asarray(v[:, k]) for k in range(3)])


def _port_state(x, split) -> shade.PathState:
    t = lambda a: torch.from_numpy(np.array(a))
    acc = [_pv(a) for a in x["accum"]]
    zeros = lambda: torch.zeros(N)
    return shade.PathState(
        o=_pv(x["o"]), d=_pv(x["d"]), throughput=_pv(x["throughput"]),
        accum=acc[0], diffuse=acc[1] if split else None,
        specular=acc[2] if split else None,
        emission=acc[3] if split else None, alive=t(x["alive"]),
        ray_spec=t(x["ray_spec"]), prev_was_specular=t(x["prev_spec"]),
        path_still_specular=t(x["path_spec"]),
        rng=t(x["state"].astype(np.int64)),
        first_normal=Vec3(zeros(), zeros(), zeros()),
        first_depth=torch.full((N,), 1e30),
        first_object_id=torch.full((N,), -1, dtype=torch.int32),
        first_roughness=torch.ones(N), first_transmission=zeros())


def _geom(x):
    return types.SimpleNamespace(e1=_pv(x["e1"]), e2=_pv(x["e2"]),
                                 num_tri_slots=N)


def _k1(x):
    slot = torch.from_numpy(x["slot"])
    ids = torch.from_numpy(x["ids"])
    return traverse.Closest(
        t=torch.where(slot >= 0, torch.from_numpy(x["t"]),
                      torch.from_numpy(np.where(x["alive"], 1e30, -1.0)
                                       .astype(np.float32))),
        u=torch.zeros(N), v=torch.zeros(N), slot=slot,
        mesh=torch.where(slot >= 0, ids, -1))


def _sky():
    top, bottom = (0.35, 0.45, 0.65), (0.05, 0.05, 0.08)
    return (SkyConfig.gradient(top, bottom, device=CPU),
            RefSky.gradient(top, bottom))


def _ref_bounce(x, hit, split, bounce, n_lights, rr_start):
    """One bounce of the reference's integrator body on the same lanes.
    Returns (state dict, the shadow walk's arguments)."""
    acc = [_rv(a) for a in x["accum"]]
    zero3 = RefVec3.zeros((N,))
    ref_table, sky = x["ref_table"], _sky()[1]
    alive, d = jnp.asarray(x["alive"]), _rv(x["d"])
    throughput, rng = _rv(x["throughput"]), jnp.asarray(x["state"])
    ray_spec = jnp.asarray(x["ray_spec"])
    prev_spec, path_spec = (jnp.asarray(x["prev_spec"]),
                            jnp.asarray(x["path_spec"]))
    accum, acc_d, acc_s, acc_e = acc
    is_first = bounce == 0
    out = {}
    mat = ref_table.gather(jnp.maximum(hit.mesh_index, 0))
    if is_first:
        out["first_normal"] = ref_where(hit.hit, hit.normal, zero3)
        out["first_depth"] = jnp.where(hit.hit, hit.t, 1e30)
        out["first_object_id"] = jnp.where(hit.hit, hit.mesh_index, -1)
        out["first_roughness"] = jnp.where(hit.hit, mat.roughness, 1.0)
        out["first_transmission"] = jnp.where(hit.hit, mat.transmission, 0.0)

    miss = alive & ~hit.hit
    sky_c = ref_sample_sky(d, sky) * throughput
    accum = accum + ref_where(miss, sky_c, zero3)
    acc_s = acc_s + ref_where(miss & path_spec, sky_c, zero3)
    acc_d = acc_d + ref_where(miss & ~path_spec, sky_c, zero3)
    alive = alive & hit.hit

    t_unit = RefVec3(*[jnp.maximum(c, 1e-6) for c in (
        mat.albedo.x, mat.albedo.y, mat.albedo.z)])
    absorb = ref_beer_lambert(RefVec3(-jnp.log(t_unit.x), -jnp.log(t_unit.y),
                                      -jnp.log(t_unit.z)), hit.t)
    throughput = ref_where(alive & ~hit.front_face, throughput * absorb,
                           throughput)

    emissive = ((mat.emission.x > 0.0) | (mat.emission.y > 0.0)
                | (mat.emission.z > 0.0))
    emit_on = alive & emissive & (is_first | prev_spec)
    contrib_e = throughput * mat.emission
    accum = accum + ref_where(emit_on, contrib_e, zero3)
    acc_e = acc_e + ref_where(emit_on & is_first, contrib_e, zero3)
    acc_s = acc_s + ref_where(emit_on & (not is_first) & path_spec,
                              contrib_e, zero3)
    acc_d = acc_d + ref_where(emit_on & (not is_first) & ~path_spec,
                              contrib_e, zero3)

    do_nee = alive & ~ray_spec
    walk = {}

    def any_hit(o, dd, t, li=None):
        walk.update(o=o, d=dd, t=t)
        return jnp.asarray(SHADOW)

    if n_lights > 0:
        rng, l_nee, pdf_nee, nee_c = ref_nee.sample_direct_lighting(
            rng, hit.point, hit.normal, hit.front_face, mat, d,
            x["ref_lights"], n_lights, any_hit, split=split, active=do_nee)
        walk.update(l=l_nee, pdf=pdf_nee, contrib=nee_c)
        w = ref_bsdf.mis_weight(pdf_nee, ref_bsdf.material_pdf(
            hit.normal, hit.front_face, mat, -d, l_nee))
        gate = do_nee & (pdf_nee > 0.0)
        if split:
            nee_d, nee_s = nee_c
            acc_d = acc_d + ref_where(gate, throughput * nee_d * w, zero3)
            acc_s = acc_s + ref_where(gate, throughput * nee_s * w, zero3)
            nee_c = nee_d + nee_s
        accum = accum + ref_where(gate, throughput * nee_c * w, zero3)

    rng, sc = ref_bsdf.material_scatter(rng, hit.normal, hit.front_face, mat,
                                        d)
    alive = alive & sc.valid
    prev_spec = jnp.where(alive, sc.is_specular, prev_spec)
    path_spec = path_spec & jnp.where(alive, sc.is_specular, True)
    rng, u_rr = ref_rng.uniform(rng)
    p = jnp.clip(throughput.max_component(), 0.05, 0.95)
    rr_on = bounce >= rr_start
    alive = alive & ~(rr_on & (u_rr > p))
    throughput = ref_where(rr_on & alive, throughput / p, throughput)
    throughput = ref_clamp_soft(throughput * sc.attenuation, 50.0)
    offset = ref_where(sc.direction.dot(hit.normal) > 0.0, hit.normal * 1e-4,
                       hit.normal * -1e-4)
    out.update(
        o=ref_where(alive, hit.point + offset, _rv(x["o"])),
        d=ref_where(alive, sc.direction, d),
        ray_spec=jnp.where(alive, sc.is_specular, ray_spec),
        throughput=throughput, alive=alive, accum=accum, diffuse=acc_d,
        specular=acc_s, emission=acc_e, prev_was_specular=prev_spec,
        path_still_specular=path_spec, rng=rng, do_nee=do_nee)
    return out, walk


def _ref_hit(hit: traverse.Hit):
    """The port's hit record (from the per-lane triangles) for the
    reference: both sides shade the same hits."""
    c = lambda a: jnp.asarray(a.numpy())
    return types.SimpleNamespace(
        hit=c(hit.hit), t=c(hit.t), point=_rv(hit.point),
        normal=_rv(hit.normal), front_face=c(hit.front_face),
        mesh_index=c(hit.mesh_index))


def _exact(got, want, what):
    assert np.array_equal(got.numpy(), np.asarray(want)), what


@pytest.mark.parametrize("split,bounce,n_lights", [
    (False, 0, 4), (True, 0, 4), (False, 2, 4), (True, 2, 4), (True, 1, 0)],
    ids=["plain-b0", "split-b0", "plain-b2", "split-b2", "split-no-lights"])
def test_stages_match_reference(lanes, split, bounce, n_lights):
    x = lanes
    ps = _port_state(x, split)
    sky = _sky()[0]
    nee = shade.shade_nee_plain(ps, _geom(x), _k1(x), x["table"],
                                x["lights"], n_lights, sky, bounce)
    want, walk = _ref_bounce(x, _ref_hit(nee.hit), split, bounce, n_lights,
                             rr_start=1)
    dead = ~x["alive"]
    assert dead.mean() > 0.1 and (x["alive"] & (x["slot"] < 0)).any()
    assert (x["alive"] & x["ray_spec"]).any()
    if n_lights:
        _exact(nee.do_nee, want["do_nee"], "do_nee")
        _close(nee.shadow_o, walk["o"], "shadow origin", DIRECTION)
        _close(nee.shadow_d, walk["l"], "L", DIRECTION)
        _close(nee.shadow_t, walk["t"], "shadow t_max")
        _close(nee.pdf, walk["pdf"], "NEE pdf")
        assert (nee.shadow_t.numpy()[~nee.do_nee.numpy()] == -1.0).all()
        lit = direct_lighting_lit(
            (nee.contrib, nee.contrib_s) if split else nee.contrib, nee.pdf,
            torch.from_numpy(SHADOW))
        for k, got in enumerate(lit if split else [lit]):
            ref_c = walk["contrib"][k] if split else walk["contrib"]
            _close(got, ref_c, f"NEE contribution {k}")
    else:
        assert nee.shadow_t is None and not walk

    shade.shade_scatter_plain(ps, nee, torch.from_numpy(SHADOW), x["table"],
                              bounce, rr_enabled=True, rr_start=1)
    _exact(ps.rng, np.asarray(want["rng"]).astype(np.int64), "PCG state")
    for name in ("alive", "ray_spec", "prev_was_specular",
                 "path_still_specular"):
        _exact(getattr(ps, name), want[name], name)
    assert 0.2 < ps.alive.float().mean() < 0.9
    for name in ("accum",) + (("diffuse", "specular", "emission")
                              if split else ()):
        _close(getattr(ps, name), want[name], name)
        # dead lanes keep their accumulators
        _close(getattr(ps, name).map(lambda c: c[torch.from_numpy(dead)]),
               _rv(x["accum"][("accum", "diffuse", "specular",
                               "emission").index(name)][dead]), name)
    _close(ps.o, want["o"], "origin", DIRECTION)
    _close(ps.d, want["d"], "direction", DIRECTION)
    _close(ps.throughput, want["throughput"], "throughput", AT_PEAK)
    if bounce == 0:
        _close(ps.first_normal, want["first_normal"], "first normal",
               DIRECTION)
        for name in ("first_depth", "first_object_id", "first_roughness",
                     "first_transmission"):
            _exact(getattr(ps, name), want[name], name)


def test_no_lights_draws_no_nee_numbers(lanes):
    """Without lights a bounce draws only the scatter's three numbers and
    the roulette's one."""
    x = lanes
    ps = _port_state(x, False)
    nee = shade.shade_nee_plain(ps, _geom(x), _k1(x), x["table"],
                                x["lights"], 0, _sky()[0], 1)
    assert torch.equal(ps.rng, torch.from_numpy(x["state"].astype(np.int64)))
    shade.shade_scatter_plain(ps, nee, None, x["table"], 1, True, 2)
    s = jnp.asarray(x["state"])
    for _ in range(4):
        s, _ = ref_rng.uniform(s)
    _exact(ps.rng, np.asarray(s).astype(np.int64), "PCG state")


# -- the wrappers on the CPU ----------------------------------------------------


def _wrapper_inputs(x, split=True):
    ps = _port_state(x, split)
    return ps, (_geom(x), _k1(x), x["table"], x["lights"], 4, _sky()[0])


def _assert_states_equal(a: shade.PathState, b: shade.PathState):
    for f in dataclasses.fields(shade.PathState):
        u, v = getattr(a, f.name), getattr(b, f.name)
        if isinstance(u, Vec3):
            assert all(torch.equal(p, q) for p, q in zip(
                (u.x, u.y, u.z), (v.x, v.y, v.z))), f.name
        elif u is not None:
            assert torch.equal(u, v), f.name


@pytest.mark.parametrize("split", [False, True])
def test_wrappers_use_plain_on_cpu(lanes, no_kernels, split):
    ps, args = _wrapper_inputs(lanes, split)
    ps2 = ps.clone()
    nee = shade.shade_nee(ps, *args, bounce=0)
    nee2 = shade.shade_nee_plain(ps2, *args, bounce=0)
    _assert_states_equal(ps, ps2)
    for a, b in zip(nee[1:], nee2[1:]):
        if isinstance(a, Vec3):
            assert all(torch.equal(p, q) for p, q in zip(
                (a.x, a.y, a.z), (b.x, b.y, b.z)))
        elif a is not None:
            assert torch.equal(a, b)
    occl = torch.from_numpy(SHADOW)
    shade.shade_scatter(ps, nee, occl, lanes["table"], 0, True, 1)
    shade.shade_scatter_plain(ps2, nee2, occl, lanes["table"], 0, True, 1)
    _assert_states_equal(ps, ps2)


def _bad_states():
    """(name, mutate) pairs: mutate(ps) breaks one plane as a kernel would
    refuse it."""
    def set_(name, fn):
        def mutate(ps):
            setattr(ps, name, fn(getattr(ps, name)))
        return mutate
    return [
        ("float64 throughput", set_("throughput",
                                    lambda v: Vec3(v.x.double(), v.y, v.z))),
        ("2-D alive", set_("alive", lambda a: a.reshape(64, -1))),
        ("strided origin", set_("o", lambda v: Vec3(
            torch.stack([v.x, v.x], 1)[:, 0], v.y, v.z))),
        ("short accumulator", set_("accum", lambda v: Vec3(v.x[:-1], v.y,
                                                           v.z))),
        ("int32 PCG state", set_("rng", lambda a: a.int())),
        ("float alive", set_("alive", lambda a: a.float())),
        ("split channels half set", set_("emission", lambda v: None)),
    ]


@pytest.mark.parametrize("case", range(len(_bad_states())),
                         ids=[n for n, _ in _bad_states()])
@pytest.mark.parametrize("stage", ["shade_nee", "shade_scatter"])
def test_wrappers_refuse_bad_state(lanes, no_kernels, stage, case):
    ps, args = _wrapper_inputs(lanes)
    nee = shade.shade_nee_plain(ps.clone(), *args, bounce=1)
    _bad_states()[case][1](ps)
    with pytest.raises((TypeError, ValueError)):
        if stage == "shade_nee":
            shade.shade_nee(ps, *args, bounce=1)
        else:
            shade.shade_scatter(ps, nee, torch.from_numpy(SHADOW),
                                lanes["table"], 1)


def test_wrappers_refuse_bad_records(lanes, no_kernels):
    ps, (geom, k1, table, lights, n_lights, sky) = _wrapper_inputs(lanes)
    with pytest.raises(TypeError):  # int64 triangle slots
        shade.shade_nee(ps, geom, k1._replace(slot=k1.slot.long()), table,
                        lights, n_lights, sky, 1)
    with pytest.raises(ValueError):  # a material row too short
        shade.shade_nee(ps, geom, k1, MaterialTable(table.packed[:, :20]),
                        lights, n_lights, sky, 1)
    nee = shade.shade_nee_plain(ps.clone(), geom, k1, table, lights,
                                n_lights, sky, 1)
    with pytest.raises(TypeError):  # the walk's answer as uint8
        shade.shade_scatter(ps, nee, torch.from_numpy(SHADOW).to(torch.uint8),
                            table, 1)
    with pytest.raises(ValueError):  # a non-contiguous pdf plane
        shade.shade_scatter(ps, nee._replace(
            pdf=torch.stack([nee.pdf, nee.pdf], 1)[:, 0]),
            torch.from_numpy(SHADOW), table, 1)


def test_wrappers_check_the_state_once(lanes, monkeypatch):
    """A state's planes are checked once while they stay the same tensors
    (as on the card, where the kernels update them in place), and again
    when one is replaced."""
    ps, (geom, k1, table, lights, n_lights, sky) = _wrapper_inputs(lanes)
    seen = []
    ptrs = shade._ptrs
    monkeypatch.setattr(shade, "_ptrs", lambda name, *a: (
        seen.append(name), ptrs(name, *a))[1])
    shade.check_state(ps, table)
    once = len(seen)
    assert once == len(shade._STATE)
    _, _, a = shade._checked(ps, table, [])
    _, _, b = shade._checked(ps, table, [])
    assert len(seen) == once and a is not b and bytes(a) == bytes(b)
    ps.throughput = ps.throughput.map(torch.clone)
    shade.check_state(ps, table)
    assert len(seen) == 2 * once
    ps.accum = Vec3(ps.accum.x[:-1], ps.accum.y, ps.accum.z)
    with pytest.raises(ValueError, match="accum.x"):
        shade.check_state(ps, table)


def test_wrappers_refuse_other_devices(lanes):
    ps, args = _wrapper_inputs(lanes)
    meta = ps.clone()  # one plane elsewhere
    meta.throughput = meta.throughput.map(lambda c: c.to("meta"))
    with pytest.raises(ValueError, match="meta"):
        shade.shade_nee(meta, *args, bounce=0)
    meta = dataclasses.replace(
        ps, **{f.name: (None if getattr(ps, f.name) is None
                        else getattr(ps, f.name).map(lambda c: c.to("meta"))
                        if isinstance(getattr(ps, f.name), Vec3)
                        else getattr(ps, f.name).to("meta"))
               for f in dataclasses.fields(ps)})
    with pytest.raises(ValueError):
        shade.shade_nee(meta, *args, bounce=0)


def test_scene_needs_a_card():
    """Entry points render on the card unless asked for the CPU: on a host
    without CUDA they raise instead of rendering on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the CUDA-less contract is moot")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        Scene(8, 8)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        build_bench_scene(8, 8, target_tris=50)
    assert Scene(8, 8, device="cpu").device == CPU


# -- the bounce loop on the CPU: the same operations as before the split -------


def _unsplit_trace_path(geom, materials, lights, n_lights, sky, ray, state,
                        max_depth, split, rr_start):
    """The bounce loop as one body of plain functions, the way the
    integrator composed them before it was cut into the two stages."""
    from ptrt_tpu_torch.core import rng as prng
    from ptrt_tpu_torch.core.vec import clamp_vector_soft, fmax, where
    from ptrt_tpu_torch.render import bsdf, nee
    from ptrt_tpu_torch.render.pbr import beer_lambert
    from ptrt_tpu_torch.render.sky import sample_sky

    d = ray.direction
    shape, dev = d.x.shape, d.x.device
    o = ray.origin.broadcast_to(shape)
    zero3 = Vec3.zeros(shape, dev)
    full = lambda v: torch.full(shape, v, dtype=torch.float32, device=dev)
    ray_spec = torch.zeros(shape, dtype=torch.bool, device=dev)
    throughput = Vec3.ones(shape, dev)
    alive = torch.ones(shape, dtype=torch.bool, device=dev)
    accum = acc_diff = acc_spec = acc_emis = zero3
    prev_spec = torch.ones(shape, dtype=torch.bool, device=dev)
    path_spec = torch.ones(shape, dtype=torch.bool, device=dev)
    first = dict(normal=zero3, depth=full(1e30),
                 object_id=torch.full(shape, -1, dtype=torch.int32))
    rays = torch.zeros((), dtype=torch.int64)
    any_hit = lambda oo, dd, tt: traverse.intersect_any(geom, oo, dd, tt)
    for bounce in range(max_depth):
        is_first = bounce == 0
        rays = rays + alive.sum()
        hit = traverse.intersect_closest(geom, o, d,
                                         torch.where(alive, 1e30, -1.0))
        mat = materials.gather(hit.mesh_index.clamp_min(0))
        if is_first:
            first = dict(normal=where(hit.hit, hit.normal, zero3),
                         depth=torch.where(hit.hit, hit.t, 1e30),
                         object_id=torch.where(hit.hit, hit.mesh_index, -1),
                         roughness=torch.where(hit.hit, mat.roughness, 1.0),
                         transmission=torch.where(hit.hit, mat.transmission,
                                                  0.0))
        miss = alive & ~hit.hit
        sky_c = sample_sky(d, sky) * throughput
        accum = accum + where(miss, sky_c, zero3)
        if split:
            acc_spec = acc_spec + where(miss & path_spec, sky_c, zero3)
            acc_diff = acc_diff + where(miss & ~path_spec, sky_c, zero3)
        alive = alive & hit.hit
        t_unit = mat.albedo.map(lambda a: fmax(a, 1e-6))
        absorb = beer_lambert(t_unit.map(lambda a: -torch.log(a)), hit.t)
        throughput = where(alive & ~hit.front_face, throughput * absorb,
                           throughput)
        emissive = ((mat.emission.x > 0.0) | (mat.emission.y > 0.0)
                    | (mat.emission.z > 0.0))
        emit_on = alive & emissive & (is_first | prev_spec)
        contrib_e = throughput * mat.emission
        accum = accum + where(emit_on, contrib_e, zero3)
        if split and is_first:
            acc_emis = acc_emis + where(emit_on, contrib_e, zero3)
        elif split:
            acc_spec = acc_spec + where(emit_on & path_spec, contrib_e, zero3)
            acc_diff = acc_diff + where(emit_on & ~path_spec, contrib_e,
                                        zero3)
        do_nee = alive & ~ray_spec
        rays = rays + do_nee.sum()
        state, l_nee, pdf_nee, nee_c = nee.sample_direct_lighting(
            state, hit.point, hit.normal, hit.front_face, mat, d, lights,
            n_lights, any_hit, split=split, active=do_nee)
        w = bsdf.mis_weight(pdf_nee, bsdf.material_pdf(
            hit.normal, hit.front_face, mat, -d, l_nee))
        gate = do_nee & (pdf_nee > 0.0)
        if split:
            nee_d, nee_s = nee_c
            acc_diff = acc_diff + where(gate, throughput * nee_d * w, zero3)
            acc_spec = acc_spec + where(gate, throughput * nee_s * w, zero3)
            nee_c = nee_d + nee_s
        accum = accum + where(gate, throughput * nee_c * w, zero3)
        state, sc = bsdf.material_scatter(state, hit.normal, hit.front_face,
                                          mat, d)
        alive = alive & sc.valid
        prev_spec = torch.where(alive, sc.is_specular, prev_spec)
        path_spec = path_spec & torch.where(alive, sc.is_specular, True)
        state, u_rr = prng.uniform(state)
        p = torch.clamp(throughput.max_component(), 0.05, 0.95)
        if bounce >= rr_start:
            alive = alive & ~(u_rr > p)
            throughput = where(alive, throughput / p, throughput)
        throughput = clamp_vector_soft(throughput * sc.attenuation, 50.0)
        offset = where(sc.direction.dot(hit.normal) > 0.0, hit.normal * 1e-4,
                       hit.normal * -1e-4)
        o = where(alive, hit.point + offset, o)
        d = where(alive, sc.direction, d)
        ray_spec = torch.where(alive, sc.is_specular, ray_spec)
    out = dict(rays_traced=rays,
               radiance=clamp_vector_soft(accum, 100.0),
               **{f"first_{k}": v for k, v in first.items()})
    if split:
        out.update(diffuse=acc_diff, specular=acc_spec, emission=acc_emis)
    return state, out


@pytest.mark.parametrize("split", [False, True])
def test_trace_path_same_operations_as_unsplit(split):
    """The two stages compute exactly what one bounce body of the plain
    functions computes: every output bit for bit on the CPU."""
    from ptrt_tpu_torch.render.integrator import trace_path

    sc = build_bench_scene(24, 16, target_tris=400, device="cpu")
    sc._ensure_device_state()
    state, ray = pipeline.camera_rays(sc.camera, sc._rng_state, 0, 0,
                                      sc._blue_noise)
    args = (sc._geom, sc._mat_table, sc._light_table, len(sc.lights),
            sc.sky(), ray, state, 4)
    got_state, got = trace_path(*args, split=split, rr_start=1)
    want_state, want = _unsplit_trace_path(*args, split, 1)
    assert torch.equal(got_state, want_state)
    assert got.diffuse is None if not split else True
    for name, w in want.items():
        g = getattr(got, name)
        comps = (lambda v: [v.x, v.y, v.z]) if isinstance(w, Vec3) else (
            lambda v: [v])
        for a, b in zip(comps(g), comps(w)):
            assert a.shape == b.shape and torch.equal(a, b), name
    assert int(got.rays_traced) > 24 * 16


# -- the slice ------------------------------------------------------------------

W, H, DEPTH = 32, 24, 3


def test_trace_frame_lights_and_lobes():
    """Directional and area lights, glass and clear coat, through the port's
    trace_frame and the reference's."""
    sc = RefScene(W, H)
    sc.add_plane_xz(-1.0, 10.0, RefMaterial.make((0.8, 0.8, 0.8), 0.6))
    sc.add_sphere(8, RefMaterials.Glass()).transform.set_position(-0.6, -0.4,
                                                                  4.0)
    cube = sc.add_cube(RefMaterials.CarPaint((0.8, 0.1, 0.1)))
    cube.transform.set_position(0.9, -0.3, 4.6).set_rotation(0.2, 0.6, 0.0)
    sc.add_directional_light((0.3, -1.0, 0.5), (1.0, 0.95, 0.9), 2.0)
    sc.add_area_light((0.0, 3.0, 4.0), (0.0, -1.0, 0.1), 1.5, 1.0,
                      (1.0, 1.0, 0.9), 6.0)
    sc.set_sky_gradient((0.4, 0.5, 0.7), (0.1, 0.1, 0.1))
    sc.set_camera((0, 0.6, 0), (0, -0.2, 4.3), fov=55)
    sc._ensure_device_state()
    n_lights = len(sc.lights)
    fn = jax.jit(lambda g, m, l, s, c, st, bn: ref_pipeline.trace_frame(
        g, m, l, n_lights, s, c, st, jnp.int32(0), W, H, 1, DEPTH,
        split=True, use_brute=True, blue_noise_tbl=bn, rr_start=1))
    ref_state, ref = fn(sc._geom, sc._mat_table, sc._light_table, sc._sky(),
                        sc.camera, sc._rng_state, sc._blue_noise)
    port = tables.from_reference(
        device=CPU, geometry=ref_np(sc._geom),
        materials=ref_np(sc._mat_table), lights=ref_np(sc._light_table),
        sky=ref_np(sc._sky()), camera=ref_np(sc.camera),
        rng_state=np.asarray(sc._rng_state),
        blue_noise=np.asarray(sc._blue_noise))
    state, got = pipeline.trace_frame(
        port["geometry"], port["materials"], port["lights"], n_lights,
        port["sky"], port["camera"], port["rng_state"], 0, W, H, 1, DEPTH,
        port["blue_noise"], split=True, rr_start=1)
    assert np.array_equal(np.asarray(ref_state), state.numpy().astype(
        np.uint32))
    oid = got.object_id.numpy()
    assert np.array_equal(oid, np.asarray(ref.object_id))
    assert set(np.unique(oid)) == {-1, 0, 1, 2}
    for name in ("roughness", "transmission"):
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(ref, name))), name
    hit = oid >= 0
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth),
                               rtol=1e-5)
    v = lambda c: np.stack([np.asarray(a) for a in (c.x, c.y, c.z)])
    np.testing.assert_allclose(v(got.normal)[:, hit], v(ref.normal)[:, hit],
                               rtol=1e-5, atol=1e-6)
    r, g = float(ref.rays_traced), int(got.rays_traced)
    assert abs(g - r) <= 0.005 * r, (g, r)
    for name in ("color", "diffuse", "specular"):
        rc, gc = v(getattr(ref, name)), v(getattr(got, name))
        assert np.isfinite(gc).all() and rc.sum() > 0, name
        np.testing.assert_allclose(gc.sum(axis=(1, 2)), rc.sum(axis=(1, 2)),
                                   rtol=0.01, err_msg=name)
