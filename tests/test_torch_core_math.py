"""The port's leaf helpers against the JAX reference, and the public-name
coverage check.

* ``TestVec3``, ``TestRNG``, ``TestColor`` and ``TestSequences`` mirror
  ``tests/test_core_math.py`` on the port (the same analytic values).
* One case for each public name that the port had lacked (``core/vec``,
  ``core/color``, ``core/rng``, ``core/taa``, ``core/bluenoise``,
  ``render/ray``, ``render/nee``, ``render/pbr``, ``render/sky``,
  ``render/integrator``, ``scene/camera``, ``scene/lights``,
  ``scene/materials``, ``geometry/transform``): seeded numpy inputs through
  both packages.  PCG states, discrete outcomes and host-side numbers are
  held bit for bit; float32 tensors to rtol 1e-6 where both sides round
  the same operations (XLA's and torch's elementwise add, multiply,
  divide and sqrt are correctly rounded), and to the shading tests' tiers
  where a transcendental (sin, cos, log, pow) or a fused multiply-add on
  XLA's side moves an ulp.
* ``test_every_public_name_has_a_counterpart`` compares every module of
  ``ptrt_tpu/`` with its counterpart in ``ptrt_tpu_torch/`` by AST: each
  public function, class, method and module-level name must exist in the
  port (defined or imported there) or stand in ``NOT_PORTED`` with its
  reason.
"""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ptrt_tpu.core import bluenoise as ref_bn
from ptrt_tpu.core import color as ref_color
from ptrt_tpu.core import rng as ref_rng
from ptrt_tpu.core import taa as ref_taa
from ptrt_tpu.core import vec as ref_vec
from ptrt_tpu.core.vec import Vec3 as RefVec3
from ptrt_tpu.geometry import transform as ref_transform
from ptrt_tpu.render import nee as ref_nee
from ptrt_tpu.render import pbr as ref_pbr
from ptrt_tpu.render import ray as ref_ray
from ptrt_tpu.render import sky as ref_sky
from ptrt_tpu.scene import camera as ref_camera
from ptrt_tpu.scene import lights as ref_lights
from ptrt_tpu.scene import materials as ref_materials

from ptrt_tpu_torch import tables
from ptrt_tpu_torch.app.hdri import synthetic_env
from ptrt_tpu_torch.core import bluenoise, color, rng as prng, taa
from ptrt_tpu_torch.core import vec
from ptrt_tpu_torch.core.vec import (Vec3, clamp_vector_soft, cross, dot,
                                     lerp, normalize, reflect, refract, vec3)
from ptrt_tpu_torch.geometry import transform
from ptrt_tpu_torch.render import integrator, nee, pbr, ray, shade, sky
from ptrt_tpu_torch.scene import camera, lights, materials
from test_torch_shading import VALUE, _close, torch_one_thread  # noqa: F401
from test_torch_slice import ref_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4096
# the port's direction sampling against XLA's: its cos / sin differ by an
# ulp or two (test_torch_shading.py's DIRECTION tier, on every lane)
DIRECTION = ((1e-5, 1.0),)
# sums and products both sides round the same way, from the same inputs
EXACT_RTOL = ((1e-6, 1.0),)


def v(x, y, z):
    return Vec3(*[torch.tensor(c, dtype=torch.float32) for c in (x, y, z)])


def _arr(r, n=N, lo=-3.0, hi=3.0):
    return r.uniform(lo, hi, (n, 3)).astype(np.float32)


def _pv(a):
    return Vec3(*[torch.from_numpy(np.ascontiguousarray(a[:, k]))
                  for k in range(3)])


def _rv(a):
    return RefVec3(*[jnp.asarray(a[:, k]) for k in range(3)])


def _states(n, frame):
    ys = np.zeros(n, np.int64)
    xs = np.arange(n, dtype=np.int64)
    return (prng.seed(torch.from_numpy(xs), torch.from_numpy(ys), frame),
            ref_rng.seed(jnp.asarray(xs.astype(np.int32)),
                         jnp.asarray(ys.astype(np.int32)), frame))


def _same_state(got, want):
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


# -- tests/test_core_math.py's classes on the port ----------------------------


class TestVec3:
    def test_dot_cross(self):
        a, b = v(1, 2, 3), v(4, 5, 6)
        assert np.isclose(float(dot(a, b)), 32.0)
        c = cross(a, b)
        assert np.allclose([float(c.x), float(c.y), float(c.z)], [-3, 6, -3])

    def test_normalize(self):
        n = normalize(v(3, 0, 4))
        assert np.allclose([float(n.x), float(n.y), float(n.z)], [0.6, 0, 0.8])

    def test_batched_soa(self):
        a = Vec3(torch.arange(8.0), torch.zeros(8), torch.ones(8))
        b = a * 2.0 + vec3(1.0)
        assert b.x.shape == (8,)
        assert np.allclose(b.y.numpy(), np.ones(8))

    def test_reflect(self):
        r = reflect(v(1, -1, 0), v(0, 1, 0))
        assert np.allclose([float(r.x), float(r.y), float(r.z)], [1, 1, 0])

    def test_refract_tir(self):
        i = normalize(v(1, -0.05, 0))
        _, ok = refract(i, v(0, 1, 0), 1.5)
        assert not bool(ok)
        _, ok2 = refract(v(0, -1, 0), v(0, 1, 0), 1.0 / 1.5)
        assert bool(ok2)

    def test_lerp(self):
        l = lerp(vec3(0.0), vec3(1.0), 0.25)
        assert np.isclose(float(l.x), 0.25)

    def test_clamp_vector_soft(self):
        c = clamp_vector_soft(v(100.0, 100.0, 100.0), 1.0)
        assert np.isclose(float(c.luminance()), 1.0, atol=1e-5)
        small = clamp_vector_soft(v(0.1, 0.2, 0.3), 1.0)
        assert np.isclose(float(small.y), 0.2)


class TestRNG:
    def test_uniform_range_and_determinism(self):
        s = prng.seed(torch.arange(1024), torch.zeros(1024, dtype=torch.int64),
                      7)
        s2, u = prng.uniform(s)
        assert u.shape == (1024,)
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
        _, u_again = prng.uniform(s)
        assert torch.equal(u, u_again)
        _, u2 = prng.uniform(s2)
        assert not torch.allclose(u, u2)

    def test_uniform_mean(self):
        s = prng.seed(torch.arange(1 << 14),
                      torch.zeros(1 << 14, dtype=torch.int64), 0)
        _, u = prng.uniform(s)
        assert abs(float(u.mean()) - 0.5) < 0.01

    def test_cosine_hemisphere_distribution(self):
        s = prng.seed(torch.arange(1 << 14),
                      torch.zeros(1 << 14, dtype=torch.int64), 3)
        _, d = prng.sample_cosine_hemisphere(s)
        assert np.allclose(d.length().numpy(), 1.0, atol=1e-4)
        assert float(d.z.min()) >= 0.0
        assert abs(float(d.z.mean()) - 2.0 / 3.0) < 0.01

    def test_onb_orthonormal(self):
        n = normalize(Vec3(torch.linspace(-1, 1, 64),
                           torch.linspace(1, -1, 64), torch.ones(64)))
        t, b = prng.ortho_normal_basis(n)
        assert np.allclose(dot(t, n).numpy(), 0.0, atol=1e-5)
        assert np.allclose(dot(b, n).numpy(), 0.0, atol=1e-5)
        assert np.allclose(t.length().numpy(), 1.0, atol=1e-4)

    def test_cone_sampling_within_cone(self):
        s = prng.seed(torch.arange(4096), torch.zeros(4096, dtype=torch.int64),
                      1)
        axis = normalize(v(1, 2, 3)).broadcast_to((4096,))
        _, d = prng.sample_cone_direction(s, axis, torch.tensor(0.9))
        assert float(dot(d, axis).min()) >= 0.9 - 1e-4

    def test_ggx_roughness_zero_is_normal(self):
        s = prng.seed(torch.arange(64), torch.zeros(64, dtype=torch.int64), 2)
        n = v(0, 0, 1).broadcast_to((64,))
        _, h = prng.importance_sample_ggx(s, n, torch.tensor(0.001))
        assert float(dot(h, n).min()) > 0.999


class TestColor:
    def test_aces_monotone_and_bounded(self):
        xs = Vec3(*[torch.linspace(0, 20, 64)] * 3)
        o = color.aces_tonemap(xs).x.numpy()
        assert o.min() >= 0.0 and o.max() <= 1.0
        assert np.all(np.diff(o) >= -1e-6)

    def test_reinhard(self):
        out = color.reinhard_tonemap(vec3(torch.tensor(1.0)))
        assert np.isclose(float(out.x), 0.5)

    def test_rgb8(self):
        img = color.to_rgb8(Vec3(torch.ones((4, 4)), torch.zeros((4, 4)),
                                 torch.full((4, 4), 0.5)))
        assert img.shape == (4, 4, 3) and img.dtype == torch.uint8
        assert int(img[0, 0, 0]) == 255 and int(img[0, 0, 1]) == 0


class TestSequences:
    def test_halton_matches_table(self):
        assert np.isclose(taa.halton(1, 2), 0.5)
        assert np.isclose(taa.halton(3, 3), 1.0 / 9.0, atol=1e-6)
        assert np.isclose(taa.halton(3, 2), 0.75)
        jx, jy = taa.taa_jitter(0)
        assert np.isclose(jx, 0.0) and np.isclose(jy, -0.166667, atol=1e-5)

    def test_r2(self):
        x0, y0 = taa.r2_jitter(0)
        assert np.isclose(x0, 0.0) and np.isclose(y0, 0.0)

    def test_blue_noise(self):
        table = bluenoise.blue_noise_table("cpu")
        assert tuple(table.shape) == (64, 64, bluenoise.BLUE_NOISE_CHANNELS)
        u, _ = bluenoise.next_blue_noise(table, torch.arange(128),
                                         torch.arange(128), 5)
        assert float(u.min()) >= 0 and float(u.max()) < 1
        u2, _ = bluenoise.next_blue_noise(table, torch.arange(128),
                                          torch.arange(128), 6)
        assert not torch.allclose(u, u2)


# -- each added name against the reference ------------------------------------


def test_vec3_methods_match_reference():
    r = np.random.default_rng(1)
    a, b = _arr(r), _arr(r)
    pa, ra = _pv(a), _rv(a)
    pos = np.abs(a) + 0.1
    assert vec.Scalar is not None and vec.INV_PI == ref_vec.INV_PI
    assert np.array_equal(Vec3.from_array(a).to_array().numpy(),
                          np.asarray(RefVec3.from_array(a).to_array()))
    assert pa.dtype == torch.float32 and ra.dtype == jnp.float32
    assert pa.astype(torch.float64).x.dtype == torch.float64
    assert tuple(pa.reshape(64, 64).shape) == ra.reshape(64, 64).shape
    _close(pa.length(), ra.length(), "length", EXACT_RTOL)
    _close(pa.abs(), ra.abs(), "abs", EXACT_RTOL)
    _close(_pv(pos).log(), _rv(pos).log(), "log", VALUE)
    _close(_pv(pos).pow(1.7), _rv(pos).pow(1.7), "pow", VALUE)
    _close(pa.min_component(), ra.min_component(), "min", EXACT_RTOL)
    _close(pa.sum(), ra.sum(), "sum", EXACT_RTOL)
    _close(vec.dot(pa, _pv(b)), ref_vec.dot(ra, _rv(b)), "dot", EXACT_RTOL)
    _close(vec.clamp(pa, -1.0, 0.5), ref_vec.clamp(ra, -1.0, 0.5), "clamp",
           EXACT_RTOL)
    _close(vec.vec3(pa.x, pa.y, pa.z), ref_vec.vec3(ra.x, ra.y, ra.z),
           "vec3", EXACT_RTOL)
    _close(vec.face_forward(pa, _pv(b)), ref_vec.face_forward(ra, _rv(b)),
           "face_forward", EXACT_RTOL)
    _close(vec.clamp_vector(pa, 2.0), ref_vec.clamp_vector(ra, 2.0),
           "clamp_vector", VALUE)


def test_refract_matches_reference():
    r = np.random.default_rng(2)
    i = _arr(r)
    i /= np.linalg.norm(i, axis=1, keepdims=True)
    n = _arr(r)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    eta = r.uniform(0.5, 1.6, N).astype(np.float32)
    t, ok = refract(_pv(i), _pv(n), torch.from_numpy(eta))
    rt, rok = ref_vec.refract(_rv(i), _rv(n), jnp.asarray(eta))
    assert np.array_equal(ok.numpy(), np.asarray(rok))
    _close(t, rt, "refract", VALUE)


@pytest.mark.parametrize("name", ["reinhard_tonemap", "uncharted2_tonemap",
                                  "linear_to_srgb", "srgb_to_linear",
                                  "linear_to_srgb_fast"])
def test_color_curves_match_reference(name):
    r = np.random.default_rng(3)
    a = r.uniform(-0.5, 8.0, (N, 3)).astype(np.float32)
    if name == "srgb_to_linear":  # x ** 2.2 of a negative is NaN both sides
        a = np.abs(a)
    tiers = EXACT_RTOL if name in ("reinhard_tonemap",
                                   "linear_to_srgb_fast") else VALUE
    _close(getattr(color, name)(_pv(a)), getattr(ref_color, name)(_rv(a)),
           name, tiers)


@pytest.mark.parametrize("name", ["sample_cosine_hemisphere",
                                  "sample_unit_sphere",
                                  "importance_sample_ggx"])
def test_samplers_match_reference(name):
    ps, rs = _states(N, 11)
    if name == "importance_sample_ggx":
        r = np.random.default_rng(4)
        n = _arr(r)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        rough = r.uniform(0.02, 1.0, N).astype(np.float32)
        ps, d = prng.importance_sample_ggx(ps, _pv(n), torch.from_numpy(rough))
        rs, rd = ref_rng.importance_sample_ggx(rs, _rv(n), jnp.asarray(rough))
    else:
        ps, d = getattr(prng, name)(ps)
        rs, rd = getattr(ref_rng, name)(rs)
    _same_state(ps, rs)
    _close(d, rd, name, DIRECTION)


@pytest.mark.parametrize("frame", [0, 1, 7, 15, 16, 17, 100, 4097])
def test_taa_sequences_match_reference(frame):
    """Of a host int: the reference's float32 values exactly; of an int
    tensor: the same values as float32 tensors."""
    pairs = [(taa.taa_jitter_ndc(frame, 1920, 1080),
              ref_taa.taa_jitter_ndc(frame, 1920, 1080)),
             (taa.taa_jitter_extended(frame),
              ref_taa.taa_jitter_extended(frame)),
             (taa.r2_jitter(frame), ref_taa.r2_jitter(frame)),
             ((taa.halton(frame, 2), taa.halton(frame, 3)),
              (ref_taa.halton(frame, 2), ref_taa.halton(frame, 3)))]
    for got, want in pairs:
        assert all(isinstance(g, float) for g in got)
        assert np.array_equal(np.float32(got), np.asarray(want, np.float32))
    idx = torch.arange(frame, frame + 64)
    ridx = jnp.arange(frame, frame + 64)
    for got, want in ((taa.taa_jitter_extended(idx),
                       ref_taa.taa_jitter_extended(ridx)),
                      (taa.r2_jitter(idx), ref_taa.r2_jitter(ridx)),
                      (taa.taa_jitter_ndc(idx, 640, 360),
                       ref_taa.taa_jitter_ndc(ridx, 640, 360))):
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            assert np.array_equal(g.numpy(), np.asarray(w))


def test_generate_blue_noise_matches_reference():
    """The generator against the reference's at a small size (the default
    64x64, 25 relaxations, takes ~20 s: the slow case below)."""
    got = bluenoise.generate_blue_noise_2d(16, 4)
    want = ref_bn.generate_blue_noise_2d(16, 4)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert bluenoise.BLUE_NOISE_CHANNELS == ref_bn.BLUE_NOISE_CHANNELS


@pytest.mark.slow
def test_generate_blue_noise_reproduces_the_stored_table():
    assert np.array_equal(bluenoise.generate_blue_noise_2d(),
                          np.load(bluenoise.TABLE_PATH))


def test_raybatch_at_make_replace():
    r = np.random.default_rng(5)
    o, d = _arr(r, 64), _arr(r, 64)
    t = r.uniform(0, 4, 64).astype(np.float32)
    pb = ray.RayBatch.make(_pv(o), _pv(d))
    rb = ref_ray.RayBatch.make(_rv(o), _rv(d))
    assert pb.spec.dtype == torch.bool and not bool(pb.spec.any())
    assert np.array_equal(pb.spec.numpy(), np.asarray(rb.spec))
    _close(pb.at(torch.from_numpy(t)), rb.at(jnp.asarray(t)), "at",
           EXACT_RTOL)
    spec = torch.ones(64, dtype=torch.bool)
    pb2 = pb.replace(spec=spec)
    assert pb2.spec is spec and pb2.origin is pb.origin


def test_pbr_helpers_match_reference():
    r = np.random.default_rng(6)
    ndoth = r.uniform(0, 1, N).astype(np.float32)
    a2 = r.uniform(1e-4, 1, N).astype(np.float32)
    ior = r.uniform(1.0, 2.5, N).astype(np.float32)
    c = r.uniform(-0.2, 1.2, N).astype(np.float32)
    t = torch.from_numpy
    _close(pbr.distribution_ggx_fast(t(ndoth), t(a2)),
           ref_pbr.distribution_ggx_fast(jnp.asarray(ndoth), jnp.asarray(a2)),
           "distribution_ggx_fast", EXACT_RTOL)
    _close(pbr.schlick_dielectric_one_ior(t(c), t(ior)),
           ref_pbr.schlick_dielectric_one_ior(jnp.asarray(c),
                                              jnp.asarray(ior)),
           "schlick_dielectric_one_ior", EXACT_RTOL)
    a = r.uniform(-1, 5, (N, 3)).astype(np.float32)
    _close(pbr.log_safe(_pv(a)), ref_pbr.log_safe(_rv(a)), "log_safe", VALUE)


def test_sky_off_and_integrator_constants():
    off = sky.SkyConfig.off(device="cpu")
    ref = tables.from_reference(device="cpu", sky=ref_np(
        ref_sky.SkyConfig.off()))["sky"]
    for f in ("top", "bottom"):
        a, b = getattr(off, f), getattr(ref, f)
        assert [float(c) for c in (a.x, a.y, a.z)] == [
            float(c) for c in (b.x, b.y, b.z)]
    assert float(off.use_sky) == float(ref.use_sky) == 0.0
    assert off.env is None
    from ptrt_tpu.render import integrator as ref_integrator
    assert (integrator.RUSSIAN_ROULETTE_MIN_PROB
            == ref_integrator.RUSSIAN_ROULETTE_MIN_PROB
            == shade.RUSSIAN_ROULETTE_MIN_PROB)
    assert (integrator.MAX_BOUNCE_WEIGHT == ref_integrator.MAX_BOUNCE_WEIGHT
            == shade.MAX_BOUNCE_WEIGHT)


@pytest.mark.parametrize("split", [False, True], ids=["plain", "split"])
def test_sample_env_lighting_matches_reference(split):
    """The composed env NEE on random lanes under a seeded HDRI, the same
    occlusion mask given to both walks: PCG states and the walk's rays
    held as ``test_torch_env.py`` holds the stages."""
    r = np.random.default_rng(7)
    env = synthetic_env(32, 64, seed=3)
    rs = ref_sky.SkyConfig.hdri(env, 0.7)
    ps_sky = tables.from_reference(device="cpu", sky=ref_np(rs))["sky"]
    mats = [ref_materials.Material(), ref_materials.Materials.Gold(),
            ref_materials.Materials.Glass(),
            ref_materials.Materials.PlasticRed()]
    pmats = [materials.Material(**dataclasses.asdict(m)) for m in mats]
    ids = r.integers(0, len(mats), N).astype(np.int32)
    rmat = ref_materials.MaterialTable.from_materials(mats).gather(
        jnp.asarray(ids))
    pmat = materials.MaterialTable.from_materials(pmats, "cpu").gather(
        torch.from_numpy(ids.astype(np.int64)))
    n = _arr(r)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    d = _arr(r)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    point = _arr(r, lo=-4, hi=4)
    front = r.random(N) < 0.8
    active = r.random(N) < 0.9
    occluded = np.arange(N) % 5 == 2
    walks = {}

    def port_walk(o, dd, t):
        walks["port"] = (o, dd, t)
        return torch.from_numpy(occluded)

    def ref_walk(o, dd, t, li=None):
        walks["ref"] = (o, dd, t)
        return jnp.asarray(occluded)

    ps, rst = _states(N, 13)
    ps, l, pdf, c = nee.sample_env_lighting(
        ps, _pv(point), _pv(n), torch.from_numpy(front), pmat, _pv(d), ps_sky,
        port_walk, split=split, active=torch.from_numpy(active))
    rst, rl, rpdf, rc = ref_nee.sample_env_lighting(
        rst, _rv(point), _rv(n), jnp.asarray(front), rmat, _rv(d), rs,
        ref_walk, split=split, active=jnp.asarray(active))
    _same_state(ps, rst)
    _close(l, rl, "L", DIRECTION)
    _close(pdf, rpdf, "pdf", VALUE)
    (po, pd, pt), (ro, rd, rt) = walks["port"], walks["ref"]
    _close(po, ro, "shadow origin", VALUE)
    assert np.array_equal(pt.numpy(), np.asarray(rt))
    env_value = ((1e-5, 0.99), (1e-3, 1.0))  # test_torch_env.py's ENV_VALUE
    for got, want in zip(c if split else (c,), rc if split else (rc,)):
        _close(got, want, "contribution", env_value)


def test_camera_edits_match_reference():
    cams = (camera.Camera.make((0.5, 1.2, -3.0), (0.1, 0.3, 4.0), (0, 1, 0),
                               55.0, 16 / 9, aperture=0.1, focus_dist=6.5,
                               device="cpu"),
            ref_camera.Camera.make((0.5, 1.2, -3.0), (0.1, 0.3, 4.0),
                                   (0, 1, 0), 55.0, 16 / 9, aperture=0.1,
                                   focus_dist=6.5))
    for edit in (lambda c: c.set_position((2.0, 3.0, -1.0)),
                 lambda c: c.look_at((-1.0, 0.5, 2.0)),
                 lambda c: c.look_at((0.0, 0.0, 10.0), (0.0, 0.0, 1.0))
                 .set_position((1.0, -2.0, 0.5))):
        got, want = edit(cams[0]), edit(cams[1])
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            a = a.to_array().numpy() if isinstance(a, Vec3) else a.numpy()
            b = (np.asarray(b.to_array()) if isinstance(b, RefVec3)
                 else np.asarray(b))
            # normalize's rsqrt and tan differ by an ulp between the two
            assert np.allclose(a, b, rtol=1e-5, atol=1e-6), f.name


def test_table_counts_and_material_lanes():
    mats = [ref_materials.Material(), ref_materials.Materials.Gold(),
            ref_materials.Materials.Glass(),
            ref_materials.Materials.EmissiveLamp((1.0, 0.8, 0.5), 4.0),
            ref_materials.Materials.CarPaint((0.2, 0.3, 0.9))]
    pmats = [materials.Material(**dataclasses.asdict(m)) for m in mats]
    rt = ref_materials.MaterialTable.from_materials(mats)
    pt = materials.MaterialTable.from_materials(pmats, "cpu")
    assert pt.count == rt.count == len(mats)
    ids = np.arange(len(mats), dtype=np.int32).repeat(3)
    rl, pl = rt.gather(jnp.asarray(ids)), pt.gather(torch.from_numpy(ids))
    for name in ("is_simple", "is_emissive"):
        assert np.array_equal(getattr(pl, name)().numpy(),
                              np.asarray(getattr(rl, name)()))
    assert np.allclose(pl.emission_luminance().numpy(),
                       np.asarray(rl.emission_luminance()), rtol=1e-6)
    for n_ in (0.0, 1.0, 10.0, 128.0, 1e4):
        assert (materials.phong_shininess_to_roughness(n_)
                == ref_materials.phong_shininess_to_roughness(n_))
    ls = [ref_lights.Light.point((0, 3, 0), intensity=5.0),
          ref_lights.Light.spot((1, 2, 3), (0, -1, 0))]
    pls = [lights.Light(**dataclasses.asdict(x)) for x in ls]
    assert (lights.LightTable.from_lights(pls, "cpu").count
            == ref_lights.LightTable.from_lights(ls).count == 2)
    assert (lights.LightTable.from_lights([], "cpu").count
            == ref_lights.LightTable.from_lights([]).count == 1)


def test_transform_helpers_match_reference():
    a = transform.Transform3D((1, 2, 3), (0.1, 0.2, 0.3), (1, 2, 1))
    b = transform.Transform3D((-4, 0, 2), (1.0, -0.5, 2.0), (3, 1, 0.5))
    ra = ref_transform.Transform3D(a.position, a.rotation, a.scale)
    rb = ref_transform.Transform3D(b.position, b.rotation, b.scale)
    for t in (0.0, 0.3, 1.0):
        got, want = transform.lerp_transform(a, b, t), \
            ref_transform.lerp_transform(ra, rb, t)
        assert (got.position, got.rotation, got.scale) == (
            want.position, want.rotation, want.scale)
        assert np.array_equal(got.world_matrix(), want.world_matrix())
    for ang in (0.0, 1.3, -7.0):
        assert transform.orbit_around((1, 2, 3), 4.0, ang, 0.5) == \
            ref_transform.orbit_around((1, 2, 3), 4.0, ang, 0.5)
        assert transform.oscillate((1, 2, 3), (0, 2, 1), 0.7, ang) == \
            ref_transform.oscillate((1, 2, 3), (0, 2, 1), 0.7, ang)


# -- every public name of the reference has a counterpart --------------------

# reference name (module path under ptrt_tpu/, then Class.method or name)
# -> why the port has none.  A module listed as "path" covers its names.
NOT_PORTED = {
    "utils/aotcache.py": "the jax.export program cache: the port compiles "
                         "its kernels once into build/ (nvcc)",
    "render/packet.py": "interval packet walks of the TPU's lock-step "
                        "traversal; K1 / K2 walk a ray a thread",
    "geometry/bvh.py:FlatBVH": "the binary skip-pointer tree of the TPU's "
                               "lock-step walk; the port walks BVH8",
    "geometry/bvh.py:FlatBVH.num_nodes": "as FlatBVH",
    "geometry/bvh.py:build_bvh": "builds FlatBVH",
    "native/__init__.py:native_build_bvh": "the native builder of FlatBVH; "
                                           "the port's builds BVH8",
    "render/integrator.py:BOUNCE_COMPACT": "the TPU compaction ladder",
    "render/integrator.py:BOUNCE_COMPACT_FROM": "the TPU compaction ladder",
    "render/integrator.py:BOUNCE_COMPACT_MIN": "the TPU compaction ladder",
    "render/integrator.py:NEE_PK_LIGHTS": "packet-NEE routing of the TPU "
                                          "walk",
    "render/pipeline.py:MAX_WAVEFRONT_LANES": "the TPU wavefront lane cap; "
                                              "a CUDA wavefront is a frame",
    "scene/pt_scene.py:BRUTE_FORCE_TRI_THRESHOLD": "the port walks K1 / K2 "
                                                   "at every size",
    "scene/rt_scene.py:BRUTE_FORCE_TRI_THRESHOLD": "as in pt_scene.py",
    "render/traverse.py:intersect_any_brute": "the brute-force "
                                              "intersectors: K1 / K2 at "
                                              "every size",
    "render/traverse.py:intersect_closest_brute": "as intersect_any_brute",
}
# traverse.py's compaction, packet and sorted-packet knobs of the TPU walk
NOT_PORTED.update({f"render/traverse.py:{k}": "a knob of the TPU walk's "
                   "compaction or packets" for k in (
                       "ANY_COMPACT_SHRINK", "ANY_COMPACT_STAGES",
                       "ANY_LEAF_EVERY", "ANY_LEAF_EVERY_COH",
                       "ANY_SCATTER_SHRINK", "ANY_SCATTER_STAGES",
                       "BIG_COMPACT_LANES", "BIG_COMPACT_SHRINK",
                       "COMPACT_SHRINK", "COMPACT_STAGES", "FUSED_COMPACT",
                       "LEAF_EVERY", "MIN_COMPACT_LANES", "MT_CM", "NODE_CM",
                       "PACKET_ANY", "PACKET_CLOSEST", "PASS_MIN_ITERS",
                       "SCATTER_SHRINK", "SCATTER_STAGES", "SORTPK",
                       "SORTPK_MIN_LANES", "STACK_CM")})
# JAX pytree hooks: a torch dataclass needs none
PYTREE_HOOKS = ("tree_flatten", "tree_unflatten")


def _public_names(path: str, with_imports: bool) -> set:
    """Top-level functions, classes, their methods and assigned names of a
    module that do not start with an underscore; with ``with_imports``
    also the names it imports."""
    out = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{b.name}" for b in node.body
                           if isinstance(b, ast.FunctionDef)
                           and not b.name.startswith("_"))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            out.update(n.id for t in targets for n in ast.walk(t)
                       if isinstance(n, ast.Name)
                       and not n.id.startswith("_"))
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
    return out


def test_every_public_name_has_a_counterpart():
    ref_root = os.path.join(REPO, "ptrt_tpu")
    missing = []
    for dirpath, _, files in os.walk(ref_root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), ref_root)
            if rel in NOT_PORTED:
                continue
            port = os.path.join(REPO, "ptrt_tpu_torch", rel)
            have = (_public_names(port, True) if os.path.exists(port)
                    else set())
            for name in sorted(_public_names(os.path.join(dirpath, f),
                                             False)):
                if (name in have or f"{rel}:{name}" in NOT_PORTED
                        or name.rsplit(".", 1)[-1] in PYTREE_HOOKS):
                    continue
                missing.append(f"{rel}:{name}")
    assert not missing, f"public names of ptrt_tpu/ with no counterpart: " \
                        f"{missing}"


def test_exclusions_name_real_reference_names():
    """Each exclusion names a module or a public name the reference has
    and the port lacks: a stale entry fails here."""
    for key in NOT_PORTED:
        rel, _, name = key.partition(":")
        path = os.path.join(REPO, "ptrt_tpu", rel)
        assert os.path.exists(path), key
        if name:
            assert name in _public_names(path, False), key
            port = os.path.join(REPO, "ptrt_tpu_torch", rel)
            assert not (os.path.exists(port)
                        and name in _public_names(port, True)), key
