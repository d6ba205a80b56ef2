"""The one-bounce RT backend against the JAX reference, on the CPU.

``render/rt_shading.py``'s helpers, ``shade_core`` and ``shade_primary``
get the same random lanes in both packages (made with numpy): every
material branch (anisotropy of both signs, sheen, the subsurface wrap,
clearcoat, iridescence, smooth and rough glass, emission) under the three
light types (an area light is shaded as a point light), with the same
occlusion given to both through the reference's ``any_hit_fn`` seam (and
the same hit records through ``closest_fn``).  ``_hash_seed`` and the
seeds of ``perturb_direction_ggx`` must be exact.  The directions are held
at rtol 1e-5 on every lane: XLA's rsqrt, cos and sin differ from torch's
by an ulp on 29%, 5% and 5% of float32 inputs (measured on 1e5 inputs), so
a direction through them cannot be bit-exact across the two packages; the
exact share is asserted too.  Values use test_torch_shading.py's tiers
(rtol, least share of lanes), colours its GGX-peak tiers.

``RTScene`` frames at 64x48 of ``build_scene_by_id`` 0 and 4-7 (7 has 242
triangles, above the reference's brute-force threshold of 192, so the
reference walks its BVH there) must be within 1 LSB of the reference's on
at least 99% of pixels; pixels off by more are counted by cause (glass
lanes, whose perturbed rays hang on a hash of the hit point's bits; the
rest).  The reference's brute-force frames run eagerly (``disable_jit``:
its jitted program compiles for ~20 s a scene); scene 7 runs jitted.  The
staged frame (the plain versions of the K10 stages) equals the unstaged
``shade_primary`` composition bit for bit, and the scenes' tables equal
the reference's.

``rt_glass_rays`` lists the glass lanes: its records (plain version) must
be the dense composition's (every lane's two rays, the dead ones with
origin 0 and ``t = -1``, kept here as the oracle) at the glass lanes, bit
for bit, with the lanes in increasing order and the index plane their
inverse.  A scene with glass but no glass lane in view skips the glass pass
and renders the no-glass composition's frame.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptrt_tpu.app.rt_demo_scenes import build_scene_by_id as ref_build
from ptrt_tpu.core.vec import Vec3 as RefVec3
from ptrt_tpu.render import pbr as ref_pbr
from ptrt_tpu.render import rt_shading as ref_rs
from ptrt_tpu.render.traverse import Hit as RefHit
from ptrt_tpu.scene.lights import Light as RefLight
from ptrt_tpu.scene.lights import LightTable as RefLightTable
from ptrt_tpu.scene.materials import Material as RefMaterial
from ptrt_tpu.scene.materials import MaterialTable as RefMaterialTable
from ptrt_tpu.scene.materials import Materials as RefMaterials

from ptrt_tpu_torch import tables
from ptrt_tpu_torch.app.rt_demo_scenes import build_scene_by_id
from ptrt_tpu_torch.core.vec import Vec3, fmax, where
from ptrt_tpu_torch.render import pbr
from ptrt_tpu_torch.render import rt_shading as rs
from ptrt_tpu_torch.render import traverse
from ptrt_tpu_torch.scene import rt_scene
from ptrt_tpu_torch.scene.lights import Light, LightTable
from ptrt_tpu_torch.scene.materials import Material, MaterialTable
from test_torch_shading import torch_one_thread  # noqa: F401

N = 4096
ATOL = 1e-6
# (rtol, least share of lanes within it)
DIRECTION = ((1e-5, 1.0),)
VALUE = ((1e-5, 0.995), (1e-3, 1.0))
AT_PEAK = ((1e-5, 0.85), (1e-3, 0.995), (0.5, 1.0))
FRAME_AGREE = 0.99
FRAME_SIZE = (64, 48)
SCENES = (0, 4, 5, 6, 7)


def _unit(r, n):
    a = r.normal(size=(n, 3)).astype(np.float32)
    return a / np.linalg.norm(a, axis=1, keepdims=True)


def _rv(a):
    return RefVec3(*[jnp.asarray(a[:, k]) for k in range(3)])


def _pv(a):
    return Vec3(*[torch.from_numpy(np.ascontiguousarray(a[:, k]))
                  for k in range(3)])


def _np(v):
    if isinstance(v, (Vec3, RefVec3)):
        return np.stack([np.asarray(c) for c in (v.x, v.y, v.z)])
    return np.asarray(v)[None]


def _close(got, want, what, tiers=VALUE, lanes=None):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    err, mag = np.abs(g - w).max(0), np.abs(w).max(0)
    if lanes is not None:
        err, mag = err[lanes], mag[lanes]
    for rtol, share in tiers:
        ok = err <= rtol * mag + ATOL
        assert ok.mean() >= share, (
            f"{what}: {(~ok).sum()} of {ok.size} lanes exceed rtol={rtol}")


def _materials(r):
    """Every branch of shade_core and the glass branch, and random mixes."""
    m = RefMaterials
    mats = [m.BrushedAluminum(), m.Silk((0.1, 0.3, 0.8)),
            RefMaterial.make((0.6, 0.5, 0.4), 0.4, 0.5, anisotropy=-0.7),
            m.Velvet((0.5, 0.1, 0.6)), m.Skin(), m.Jade(),
            m.CarPaint((0.8, 0.1, 0.1)), m.MarbleCarrara(), m.OilSlick(),
            m.SoapBubble(), m.PearlescentPaint((0.9, 0.9, 1.0)), m.Glass(),
            m.FrostedGlass(), m.Diamond(), m.Water(),
            m.EmissiveLamp((1.0, 0.8, 0.6), 4.0), m.Gold(), m.Chrome(),
            m.PlasticRed(), m.RubberBlack()]
    for _ in range(12):
        mats.append(RefMaterial.make(
            tuple(r.uniform(0.05, 1.0, 3)), float(r.uniform(0.0, 1.0)),
            float(r.choice([0.0, r.uniform(0, 1)])),
            transmission=float(r.choice([0.0, 0.0, r.uniform(0.3, 1.0)])),
            transmission_roughness=float(r.choice([0.0, r.uniform(0, 0.6)])),
            ior=float(r.uniform(1.1, 2.4)),
            clearcoat=float(r.choice([0.0, r.uniform(0, 1)])),
            clearcoat_roughness=float(r.uniform(0.0, 0.4)),
            sheen=float(r.choice([0.0, r.uniform(0, 1)])),
            sheen_tint=tuple(r.uniform(0, 1, 3)),
            subsurface_radius=float(r.choice([0.0, r.uniform(0, 1)])),
            subsurface_color=tuple(r.uniform(0, 1, 3)),
            anisotropy=float(r.choice([0.0, r.uniform(-0.9, 0.9)])),
            iridescence=float(r.choice([0.0, r.uniform(0, 1)])),
            iridescence_thickness=float(r.uniform(250, 800)),
            emission=tuple(r.choice([0.0, 2.0]) * r.uniform(0, 1, 3))))
    return mats


def _lights():
    """(reference lights, port lights): point, directional, spot, area."""
    args = [("point", ((1.0, 4.0, 2.0), (1.0, 0.9, 0.8), 3.0, 20.0)),
            ("directional", ((-0.3, -0.6, -0.5), (1.0, 0.95, 0.8), 1.5)),
            ("spot", ((0.0, 6.0, 6.0), (0.0, -1.0, -0.2), (1.0, 1.0, 1.0),
                      6.0, 30.0, 0.3, 0.7)),
            ("area", ((3.0, 4.0, 7.0), (-0.3, -1.0, 0.1), 2.0, 1.0,
                      (1.0, 0.9, 0.8), 6.0))]
    return ([getattr(RefLight, k)(*a) for k, a in args],
            [getattr(Light, k)(*a) for k, a in args])


def _hit(r, n, n_mats, miss=0.1):
    """The same random hit record for both packages (numpy arrays)."""
    nrm = _unit(r, n)
    return dict(hit=r.random(n) > miss,
                t=r.uniform(0.2, 12.0, n).astype(np.float32),
                point=(r.uniform(-4, 4, (n, 3)) + [0, 0.5, 6]).astype(
                    np.float32),
                normal=nrm, front=r.random(n) < 0.8,
                mesh=r.integers(0, n_mats, n).astype(np.int32),
                u=r.random(n).astype(np.float32),
                v=r.random(n).astype(np.float32))


def _ref_hit(h):
    return RefHit(hit=jnp.asarray(h["hit"]), t=jnp.asarray(h["t"]),
                  point=_rv(h["point"]), normal=_rv(h["normal"]),
                  front_face=jnp.asarray(h["front"]),
                  mesh_index=jnp.asarray(h["mesh"]), u=jnp.asarray(h["u"]),
                  v=jnp.asarray(h["v"]))


def _port_hit(h):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    return traverse.Hit(hit=t(h["hit"]), t=t(h["t"]), point=_pv(h["point"]),
                        normal=_pv(h["normal"]), front_face=t(h["front"]),
                        mesh_index=t(h["mesh"]), u=t(h["u"]), v=t(h["v"]))


@pytest.fixture(scope="module")
def lanes():
    r = np.random.default_rng(1234)
    mats = _materials(r)
    ref_table = RefMaterialTable.from_materials(mats)
    table = MaterialTable.from_materials(
        [Material(**dataclasses.asdict(m)) for m in mats], "cpu")
    ref_l, port_l = _lights()
    h = _hit(r, N, len(mats))
    d = _unit(r, N)
    # most rays arrive from the normal's side, some from behind
    flip = (np.sum(h["normal"] * d, 1) > 0) & (r.random(N) < 0.8)
    d[flip] = -d[flip]
    occ = r.random((len(port_l), N)) < 0.3
    return dict(
        mats=mats, ref_table=ref_table, table=table,
        ref_lights=RefLightTable.from_lights(ref_l),
        lights=LightTable.from_lights(port_l, "cpu"), n_lights=len(port_l),
        hit=h, d=d, occ=occ,
        ambient=(0.03, 0.04, 0.05), top=(0.5, 0.7, 1.0),
        bottom=(1.0, 1.0, 1.0), secondary=[_hit(r, N, len(mats), 0.3)
                                           for _ in range(2)])


def test_tables_equal(lanes):
    assert np.array_equal(lanes["table"].packed.numpy(),
                          np.asarray(lanes["ref_table"].packed))
    assert np.array_equal(lanes["lights"].packed.numpy(),
                          np.asarray(lanes["ref_lights"].packed))


def test_helpers():
    r = np.random.default_rng(7)
    n, nrm, h, t, b = (_unit(r, N) for _ in range(5))
    nrm[:64, :] = [0.0, 0.0, 1.0]  # the tangent frame's other branch
    for got, want in zip(rs.build_tangent_frame(_pv(nrm)),
                         ref_rs.build_tangent_frame(_rv(nrm))):
        _close(got, want, "tangent frame", DIRECTION)
    rough = r.uniform(0.02, 1.0, N).astype(np.float32)
    aniso = r.uniform(-0.95, 0.95, N).astype(np.float32)
    ax, ay = rs.anisotropy_to_alpha(torch.from_numpy(rough),
                                    torch.from_numpy(aniso))
    rax, ray = ref_rs.anisotropy_to_alpha(jnp.asarray(rough),
                                          jnp.asarray(aniso))
    _close(ax, rax, "ax")
    _close(ay, ray, "ay")
    _close(rs.distribution_ggx_aniso(_pv(n), _pv(h), _pv(t), _pv(b), ax, ay),
           ref_rs.distribution_ggx_aniso(_rv(n), _rv(h), _rv(t), _rv(b), rax,
                                         ray), "D aniso", AT_PEAK)
    _close(rs.geometry_smith_aniso(_pv(n), _pv(h), _pv(t), _pv(b), _pv(nrm),
                                   ax, ay),
           ref_rs.geometry_smith_aniso(_rv(n), _rv(h), _rv(t), _rv(b),
                                       _rv(nrm), rax, ray), "G aniso")
    trans = r.uniform(0, 1.2, (N, 3)).astype(np.float32)
    dist = r.uniform(0, 8, N).astype(np.float32)
    dist[:32] = 0.0
    trans[32:64] = 0.0
    _close(rs.beer_lambert_rt(_pv(trans), torch.from_numpy(dist)),
           ref_rs.beer_lambert_rt(_rv(trans), jnp.asarray(dist)), "beer")
    f32 = lambda v: RefVec3(*[jnp.float32(c) for c in v])
    t32 = lambda v: Vec3(*[torch.tensor(c, dtype=torch.float32) for c in v])
    _close(rs.sample_sky_rt(_pv(n), t32((0.5, 0.7, 1.0)),
                            t32((1.0, 0.9, 0.8)), torch.tensor(1.0)),
           ref_rs.sample_sky_rt(_rv(n), f32((0.5, 0.7, 1.0)),
                                f32((1.0, 0.9, 0.8)), jnp.float32(1.0)),
           "sky")
    cos = r.uniform(-0.2, 1.0, N).astype(np.float32)
    f0 = r.uniform(0, 1, (N, 3)).astype(np.float32)
    _close(pbr.fresnel_schlick_roughness(torch.from_numpy(cos), _pv(f0),
                                         torch.from_numpy(rough)),
           ref_pbr.fresnel_schlick_roughness(jnp.asarray(cos), _rv(f0),
                                             jnp.asarray(rough)), "F rough")
    thick = r.uniform(250, 800, N).astype(np.float32)
    _close(rs.calculate_iridescence(torch.from_numpy(thick),
                                    torch.from_numpy(cos)),
           ref_pbr.calculate_iridescence(jnp.asarray(thick),
                                         jnp.asarray(cos)), "iridescence")


def test_hash_seed_and_perturb():
    r = np.random.default_rng(11)
    p = (r.normal(size=(N, 3)) * 5).astype(np.float32)
    seed = rs._hash_seed(_pv(p))
    ref_seed = ref_rs._hash_seed(_rv(p))
    assert np.array_equal(seed.numpy().astype(np.uint32),
                          np.asarray(ref_seed))
    d = _unit(r, N)
    rough = r.choice([0.0, 0.005, 0.3, 0.5, 1.0], N).astype(np.float32)
    got, s2 = rs.perturb_direction_ggx(_pv(d), _pv(d),
                                       torch.from_numpy(rough), seed)
    want, rs2 = ref_rs.perturb_direction_ggx(_rv(d), _rv(d),
                                             jnp.asarray(rough), ref_seed)
    assert np.array_equal(s2.numpy().astype(np.uint32), np.asarray(rs2))
    _close(got, want, "perturbed direction", DIRECTION)
    exact = (_np(got) == _np(want)).all(0)
    assert exact[rough < 0.01].all()  # returned unperturbed
    assert exact.mean() > 0.5, exact.mean()


def _ref_any(occ):
    it = iter(occ)
    return lambda o, d, t: jnp.asarray(next(it))


def _port_any(occ):
    it = iter(occ)
    return lambda o, d, t: torch.from_numpy(next(it))


def _params(x):
    f32 = lambda v: RefVec3(*[jnp.float32(c) for c in v])
    t32 = lambda v: Vec3(*[torch.tensor(c, dtype=torch.float32) for c in v])
    return ((f32(x["ambient"]), f32(x["top"]), f32(x["bottom"]),
             jnp.float32(1.0)),
            (t32(x["ambient"]), t32(x["top"]), t32(x["bottom"]),
             torch.tensor(1.0)))


def test_shade_core(lanes):
    x = lanes
    rp, pp = _params(x)
    rh, ph = _ref_hit(x["hit"]), _port_hit(x["hit"])
    ids = np.maximum(x["hit"]["mesh"], 0)
    want = ref_rs.shade_core(rh, _rv(x["d"]), x["ref_table"].gather(
        jnp.asarray(ids)), x["ref_lights"], x["n_lights"], *rp, None,
        _ref_any(x["occ"]))
    got = rs.shade_core(ph, _pv(x["d"]), x["table"].gather(
        torch.from_numpy(ids)), x["lights"], x["n_lights"], *pp, None,
        _port_any(x["occ"]))
    _close(got, want, "shade_core", AT_PEAK)
    # the stage's plain version reads the same bits from the K2 layout
    stage = rs.rt_shade_plain(ph, _pv(x["d"]), torch.from_numpy(
        x["occ"].reshape(-1)), x["table"], x["lights"], x["n_lights"],
        rs.rt_params(x["ambient"], x["top"], x["bottom"], True, "cpu"))
    hit = x["hit"]["hit"]
    assert (_np(stage)[:, hit] == _np(got)[:, hit]).all()


def test_shade_primary(lanes):
    x = lanes
    rp, pp = _params(x)
    sec = x["secondary"]

    def ref_closest():
        it = iter(sec)
        return lambda o, d: _ref_hit(next(it))

    def port_closest():
        it = iter(sec)
        return lambda o, d: _port_hit(next(it))

    occ = np.concatenate([x["occ"], x["occ"][::-1], x["occ"]])
    want = ref_rs.shade_primary(
        None, x["ref_table"], x["ref_lights"], x["n_lights"], *rp,
        _ref_hit(x["hit"]), _rv(x["d"]), ref_closest(), _ref_any(occ), True)
    got = rs.shade_primary(
        None, x["table"], x["lights"], x["n_lights"], *pp,
        _port_hit(x["hit"]), _pv(x["d"]), port_closest(), _port_any(occ),
        True)
    glass = np.array([m.transmission > 0 and m.metallic < 0.1
                      for m in x["mats"]])[x["hit"]["mesh"]]
    assert 0.1 < glass.mean() < 0.9
    _close(got, want, "shade_primary", AT_PEAK)
    _close(got, want, "shade_primary (glass lanes)", AT_PEAK, lanes=glass)


def test_shade_one_bounce(lanes):
    x = lanes
    rp, pp = _params(x)
    sec = x["secondary"][0]
    o = np.random.default_rng(5).normal(size=(N, 3)).astype(np.float32)
    want = ref_rs.shade_one_bounce(
        None, x["ref_table"], x["ref_lights"], x["n_lights"], *rp, _rv(o),
        _rv(x["d"]), lambda oo, dd: _ref_hit(sec), _ref_any(x["occ"]))
    got = rs.shade_one_bounce(
        None, x["table"], x["lights"], x["n_lights"], *pp, _pv(o),
        _pv(x["d"]), lambda oo, dd: _port_hit(sec), _port_any(x["occ"]))
    assert not sec["hit"].all()  # the sky on a miss
    _close(got, want, "shade_one_bounce", AT_PEAK)


def _frame_diff(img, ref, glass):
    diff = np.abs(img.astype(int) - ref.astype(int)).max(-1)
    off = diff > 1
    return ((diff <= 1).mean(),
            {"glass": int((off & glass).sum()),
             "other": int((off & ~glass).sum())})


@pytest.mark.parametrize("scene_id", SCENES)
def test_frame_against_reference(scene_id):
    w, h = FRAME_SIZE
    ref_sc, _ = ref_build(scene_id, w, h)
    n_tris = sum(m.num_triangles for m in ref_sc.meshes)
    if n_tris <= 192:
        with jax.disable_jit():  # brute force: a quick eager frame
            ref = ref_sc.render_frame()
    else:
        ref = ref_sc.render_frame()
    sc, _ = build_scene_by_id(scene_id, w, h, device="cpu")
    img = sc.render_frame()
    assert img.shape == ref.shape == (h, w, 3) and img.dtype == np.uint8
    fr = sc.last_frame
    glass = (np.zeros((h, w), bool) if fr.glass is None else
             fr.glass.index.numpy().reshape(h, w)[::-1] >= 0)
    within, causes = _frame_diff(img, ref, glass)
    assert within >= FRAME_AGREE, (scene_id, within, causes)
    assert causes["other"] <= 0.005 * w * h, (scene_id, causes)
    assert img.std() > 1.0
    if scene_id == 7:
        assert n_tris > 192 and sc._has_glass() and glass.any()

    # the scene's tables are the reference's
    ref_sc.upload_to_gpu()
    sc._ensure()
    assert np.array_equal(sc._mat_table.packed.numpy(),
                          np.asarray(ref_sc._mat_table.packed))
    assert np.array_equal(sc._light_table.packed.numpy(),
                          np.asarray(ref_sc._light_table.packed))
    mine = tables.to_numpy(sc._geom)
    for k in ("node_rows", "tri_rows", "tri_mesh_id", "tri_shadow_opaque"):
        assert np.array_equal(mine[k], np.asarray(getattr(ref_sc._geom, k))), k


def test_staged_frame_equals_shade_primary():
    """The frame's plain stages (rt_frame on the CPU) give the image the
    unstaged ``shade_primary`` composition gives, bit for bit."""
    sc, _ = build_scene_by_id(7, 48, 32, device="cpu")
    img = sc.render_frame_device()
    o, d = sc.camera_rays()
    geom, mats, lts, nl = (sc._geom, sc._mat_table, sc._light_table,
                           len(sc.lights))
    p = sc.params()
    top, bottom = rs.params_vec(p, 3), rs.params_vec(p, 6)
    hit = traverse.intersect_closest(geom, o, d)
    color = rs.shade_primary(
        geom, mats, lts, nl, rs.params_vec(p, 0), top, bottom, p[9], hit, d,
        lambda oo, dd: traverse.intersect_closest(geom, oo, dd),
        lambda oo, dd, tt: traverse.intersect_any(geom, oo, dd, tt), True)
    color = where(hit.hit, color, rs.sample_sky_rt(d, top, bottom, p[9]))
    want = rs.rt_resolve_plain(color, hit, d, mats, None, None, None, 32,
                               48)
    assert torch.equal(img, want)


def test_rt_scene_needs_cuda_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        rt_scene.RTScene(8, 8)
    with pytest.raises(RuntimeError):
        build_scene_by_id(0, 8, 8)
    assert rt_scene.RTScene(8, 8, device="cpu").device.type == "cpu"


def test_light_rays_layout():
    """One shadow ray a light a lane, light-major, t_max -1 on a miss: the
    rays ``shade_core`` casts, in the order K2 walks them."""
    sc, _ = build_scene_by_id(5, 24, 16, device="cpu")
    sc.render_frame()
    fr = sc.last_frame
    n, nl = 24 * 16, len(sc.lights)
    assert fr.shadow.t.shape == (nl * n,)
    t = fr.shadow.t.view(nl, n)
    assert (t[:, ~fr.hit.hit] == -1.0).all()
    assert (t[:, fr.hit.hit] > 0).all()
    seen = []
    mat = sc._mat_table.gather(fr.hit.mesh_index.clamp_min(0))
    o, d = sc.camera_rays()
    p = sc.params()
    rs.shade_core(fr.hit, d, mat, sc._light_table, nl, rs.params_vec(p, 0),
                  rs.params_vec(p, 3), rs.params_vec(p, 6), p[9], None,
                  lambda oo, dd, tt: seen.append((oo, dd, tt)) or
                  torch.zeros(n, dtype=torch.bool))
    live = fr.hit.hit
    for i, (oo, dd, tt) in enumerate(seen):
        k = slice(i * n, (i + 1) * n)
        assert torch.equal(tt[live], fr.shadow.t[k][live])
        for a, b in ((oo, fr.shadow.o), (dd, fr.shadow.d)):
            for c in "xyz":
                assert torch.equal(getattr(a, c)[live],
                                   getattr(b, c)[k][live])


def _dense_glass_rays(hit, d, materials):
    """The dense glass rays: a reflection ray for every lane (0..N-1) and a
    refraction ray (N..2N-1), a lane that is not glass given origin 0, its
    primary direction and t = -1, and seed 0.  Returns (the glass mask,
    origins, directions, t, seeds)."""
    mat = materials.gather(fmax(hit.mesh_index, 0))
    g = rs.glass_terms(hit, d, mat)
    live = hit.hit & g.is_glass
    nf = hit.normal
    zero = Vec3.full(0.0)
    o_r = where(live, hit.point + nf * g.eps, zero)
    o_t = where(live, hit.point - nf * g.eps, zero)
    d_r, d_t = where(live, g.r_dir, d), where(live, g.t_dir, d)
    t = torch.where(live, traverse.T_MAX, -1.0)
    cat = lambda a, b: Vec3(torch.cat([a.x, b.x]), torch.cat([a.y, b.y]),
                            torch.cat([a.z, b.z]))
    return (live, cat(o_r, o_t), cat(d_r, d_t), torch.cat([t, t]),
            torch.where(live, g.seed, 0))


def _frame_hit():
    """A 48x32 frame of demo scene 7 (glass panes in view): its hit record,
    camera directions and material table."""
    sc, _ = build_scene_by_id(7, 48, 32, device="cpu")
    sc.render_frame_device()
    return sc.last_frame.hit, sc.camera_rays()[1], sc._mat_table


@pytest.mark.parametrize("source", ("random lanes", "frame"))
def test_glass_rays_compacted(lanes, source):
    if source == "frame":
        hit, d, table = _frame_hit()
    else:
        hit, d, table = (_port_hit(lanes["hit"]), _pv(lanes["d"]),
                         lanes["table"])
    n = d.x.shape[0]
    live, o, dirs, t, seed = _dense_glass_rays(hit, d, table)
    got = rs.rt_glass_rays(hit, d, table)  # the plain version on the CPU
    g = int(live.sum())
    assert g > 0
    assert got.lanes.dtype == got.index.dtype == torch.int32
    assert torch.equal(got.lanes.long(), torch.nonzero(live).squeeze(1))
    assert bool((got.lanes[1:] > got.lanes[:-1]).all())
    assert got.index.shape == (n,)
    assert bool((got.index[~live] == -1).all())
    assert torch.equal(got.index[got.lanes.long()],
                       torch.arange(g, dtype=torch.int32))
    where_ = torch.cat([got.lanes, got.lanes + n]).long()
    for a, b in ((got.o, o), (got.d, dirs)):
        for c in "xyz":
            assert getattr(a, c).shape == (2 * g,)
            assert torch.equal(getattr(a, c), getattr(b, c)[where_]), c
    assert torch.equal(got.t, t[where_])
    assert bool((got.t == traverse.T_MAX).all())
    assert torch.equal(got.seed, seed[got.lanes.long()])


def test_frame_without_glass_lanes():
    """Glass in the scene, none in view: no glass ray is walked (G = 0, no
    secondary records), and the frame is the no-glass composition's."""
    sc, _ = build_scene_by_id(7, 48, 32, device="cpu")
    sc.set_camera((0, 4, -6), (0, 1, 10), fov=60)
    img = sc.render_frame_device()
    fr = sc.last_frame
    assert sc._has_glass() and fr.hit.hit.any()
    assert fr.glass.lanes.numel() == 0 and fr.glass.o.x.numel() == 0
    assert bool((fr.glass.index == -1).all())
    assert fr.sec_k1 is None and fr.sec_color is None
    o, d = sc.camera_rays()
    want = rs.rt_frame(sc._geom, sc._mat_table, sc._light_table,
                       len(sc.lights), sc.params(), o, d, 32, 48, False)
    assert want.glass is None
    assert torch.equal(img, want.rgb8)
