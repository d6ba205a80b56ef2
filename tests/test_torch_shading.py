"""Shading functions against the JAX reference on fixed random inputs.

``evaluate_bsdf``, ``material_pdf``, ``material_scatter`` and
``sample_direct_lighting`` get the same normals, directions, materials
(the bench scene's 16 presets plus random ones) and PCG states in both
packages.  RNG states and discrete outcomes (lobe validity, specular
flags) must agree exactly; sampled directions to rtol=1e-5 on every lane.

Values are compared per lane, a Vec3 as a vector (max-norm), at rtol=1e-5,
atol=1e-6 on most lanes and a looser rtol on every lane.  The reason:
XLA's rsqrt, sqrt, cos, exp and log differ from torch's by a few ulps
(measured on 1e5 random inputs: 35% of rsqrts, 5% of cosines), and near the
GGX peak the microfacet term's denominator 1 - ndoth^2 (1 - a^2) cancels in
float32, which turns those ulps into up to 1e-3 relative (and up to 0.3
for a roughness-0.02 mirror, whose peak float32 cannot resolve).  The
reference runs eagerly: inside ``jax.jit`` XLA also contracts a*b+c*d into
FMAs, which moves sampled directions by up to 9e-4 relative.  Measured
(8192 lanes, eager reference), lanes above rtol 1e-5 / 1e-3 / 1e-2:
evaluate_bsdf 5/0/0, material_pdf 6/0/0, scatter attenuation 70/4/1,
scatter pdf 902/15/2 (its directions sit at the GGX peak by construction),
NEE pdf 11/0/0, NEE contribution 2/0/0; sampled directions 0/0/0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ptrt_tpu.app.bench_scene import build_bench_scene as ref_bench_scene
from ptrt_tpu.core.vec import Vec3 as RefVec3
from ptrt_tpu.render import bsdf as ref_bsdf
from ptrt_tpu.render import nee as ref_nee
from ptrt_tpu.scene.lights import LightTable as RefLightTable
from ptrt_tpu.scene.materials import Material as RefMaterial
from ptrt_tpu.scene.materials import MaterialTable as RefMaterialTable

from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.render import bsdf, nee
from ptrt_tpu_torch.scene.lights import LightTable
from ptrt_tpu_torch.scene.materials import MaterialTable

N = 8192
ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """One torch intra-op thread per test module.  The suite runs in several
    worker processes at once, and torch's default of a thread per core makes
    their OpenMP pools spin against each other: six concurrent runs of
    ``test_torch_scene.py`` took 752 s with the default and 27 s with one
    thread on an 8-core host.  The other ``test_torch_*`` modules import
    this fixture."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
# (rtol, least share of lanes within it)
DIRECTION = ((1e-5, 1.0),)
VALUE = ((1e-5, 0.995), (1e-3, 1.0))
AT_PEAK = ((1e-5, 0.85), (1e-3, 0.995), (0.5, 1.0))


def _unit(r, n):
    a = r.normal(size=(n, 3)).astype(np.float32)
    return a / np.linalg.norm(a, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def inputs():
    r = np.random.default_rng(2024)
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
    ref_table = RefMaterialTable.from_materials(mats)
    table = MaterialTable(torch.from_numpy(np.array(ref_table.packed)))
    ids = r.integers(0, len(mats), N).astype(np.int32)
    n = _unit(r, N)
    d = _unit(r, N)
    # most rays arrive from the normal's side, some from behind
    flip = (np.sum(n * d, 1) > 0) & (r.random(N) < 0.8)
    d[flip] = -d[flip]
    lights = RefLightTable.from_lights(sc.lights)
    return dict(
        ref_mat=ref_table.gather(jnp.asarray(ids)),
        mat=table.gather(torch.from_numpy(ids)),
        n=n, d=d, l=_unit(r, N),
        front=r.random(N) < 0.85,
        point=(r.uniform(-4, 4, (N, 3)) + [0, 0.5, 6]).astype(np.float32),
        state=r.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32),
        ref_lights=lights, n_lights=len(sc.lights),
        lights=LightTable(torch.from_numpy(np.array(lights.packed))),
    )


def _rv(a):
    return RefVec3(*[jnp.asarray(a[:, k]) for k in range(3)])


def _pv(a):
    return Vec3(*[torch.from_numpy(np.ascontiguousarray(a[:, k]))
                  for k in range(3)])


def _lane_err(got, want):
    """Per-lane error relative to the lane's magnitude: a Vec3 is compared
    as a vector (max-norm), so a near-zero component of a unit direction
    is held to the direction's scale, not its own."""
    if isinstance(want, RefVec3):
        g = np.stack([c.numpy() for c in (got.x, got.y, got.z)])
        w = np.stack([np.asarray(c) for c in (want.x, want.y, want.z)])
    else:
        g, w = got.numpy()[None], np.asarray(want)[None]
    assert g.shape == w.shape
    err = np.abs(g - w).max(0)
    return err, np.abs(w).max(0)


def _close(got, want, what, tiers=VALUE):
    err, mag = _lane_err(got, want)
    for rtol, share in tiers:
        ok = err <= rtol * mag + ATOL
        assert ok.mean() >= share, (
            f"{what}: {(~ok).sum()} of {ok.size} lanes exceed rtol={rtol}")


def test_mis_weight(inputs):
    r = np.random.default_rng(3)
    a, b = (r.exponential(2.0, N).astype(np.float32) for _ in range(2))
    _close(bsdf.mis_weight(torch.from_numpy(a), torch.from_numpy(b)),
           ref_bsdf.mis_weight(jnp.asarray(a), jnp.asarray(b)), "mis")


def test_evaluate_bsdf(inputs):
    x = inputs
    ref = ref_bsdf.evaluate_bsdf(
        _rv(x["n"]), jnp.asarray(x["front"]), x["ref_mat"], _rv(x["l"]),
        _rv(-x["d"]))
    got = bsdf.evaluate_bsdf(_pv(x["n"]), torch.from_numpy(x["front"]),
                             x["mat"], _pv(x["l"]), _pv(-x["d"]))
    _close(got, ref, "evaluate_bsdf")


def test_material_pdf(inputs):
    x = inputs
    ref = ref_bsdf.material_pdf(
        _rv(x["n"]), jnp.asarray(x["front"]), x["ref_mat"], _rv(-x["d"]),
        _rv(x["l"]))
    got = bsdf.material_pdf(_pv(x["n"]), torch.from_numpy(x["front"]),
                            x["mat"], _pv(-x["d"]), _pv(x["l"]))
    _close(got, ref, "material_pdf")


def test_material_scatter(inputs):
    x = inputs
    rs, ref = ref_bsdf.material_scatter(
        jnp.asarray(x["state"]), _rv(x["n"]), jnp.asarray(x["front"]),
        x["ref_mat"], _rv(x["d"]))
    ps, got = bsdf.material_scatter(
        torch.from_numpy(x["state"].astype(np.int64)), _pv(x["n"]),
        torch.from_numpy(x["front"]), x["mat"], _pv(x["d"]))
    assert np.array_equal(np.asarray(rs), ps.numpy().astype(np.uint32))
    assert np.array_equal(got.valid.numpy(), np.asarray(ref.valid))
    assert np.array_equal(got.is_specular.numpy(),
                          np.asarray(ref.is_specular))
    assert 0.05 < got.is_specular.numpy().mean() < 0.95
    _close(got.direction, ref.direction, "direction", DIRECTION)
    _close(got.attenuation, ref.attenuation, "attenuation", AT_PEAK)
    _close(got.pdf, ref.pdf, "pdf", AT_PEAK)


def test_sample_direct_lighting(inputs):
    x = inputs
    shadow = np.arange(N) % 3 == 0  # a fixed occlusion pattern
    active = np.arange(N) % 5 != 0
    seen = {}

    def ref_any(o, d, t, li=None):
        seen["ref_t"] = t
        return jnp.asarray(shadow)

    def port_any(o, d, t):
        seen["t"] = t
        return torch.from_numpy(shadow)

    rs, rl, rpdf, rc = ref_nee.sample_direct_lighting(
        jnp.asarray(x["state"]), _rv(x["point"]), _rv(x["n"]),
        jnp.asarray(x["front"]), x["ref_mat"], _rv(x["d"]), x["ref_lights"],
        x["n_lights"], ref_any, active=jnp.asarray(active))
    ps, pl_, ppdf, pc = nee.sample_direct_lighting(
        torch.from_numpy(x["state"].astype(np.int64)), _pv(x["point"]),
        _pv(x["n"]), torch.from_numpy(x["front"]), x["mat"], _pv(x["d"]),
        x["lights"], x["n_lights"], port_any,
        active=torch.from_numpy(active))
    assert np.array_equal(np.asarray(rs), ps.numpy().astype(np.uint32))
    _close(pl_, rl, "L", DIRECTION)
    _close(ppdf, rpdf, "pdf")
    _close(pc, rc, "contribution")
    _close(seen["t"], seen["ref_t"], "shadow t_max")
    assert (seen["t"].numpy()[~active] == -1.0).all()
