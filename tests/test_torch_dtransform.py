"""The port's instance transforms on the device (``core/mat.py``'s TRS
helpers, ``geometry/dtransform.py``, ``refit_root_aabb``) and K11's plain
version against the JAX reference.

Inputs are seeded numpy arrays handed to both packages.  Tolerances:

* ``core/mat``: rtol 1e-5, atol 1e-6 — XLA's CPU ``sin`` / ``cos`` and
  torch's differ by ulps, and the products of 4x4 matrices sum in another
  order (``jnp`` dot against torch's matmul);
* the instance rows (``instance_mats``): rtol 1e-5, atol 1e-5 — the
  reference's own host-vs-device tolerance is atol 1e-5
  (``tests/test_fused.py:27-28``), relative because a collapsed instance's
  rows hold 1/1e-6 = 1e6; besides, each element within 1e-6 of the
  magnitude of its terms (a rotation entry that cancels to ~0 keeps its
  terms' ulps times 1/s; the translation -S⁻¹Rᵀt sums terms of 5e7 to
  1e4 on a collapsed instance): XLA's CPU backend fuses multiply-adds in
  ``rot_xyz`` and that sum, torch rounds each product;
* the world boxes: rtol 1e-5, atol 1e-4 (``tests/test_fused.py:128-129``;
  positions up to 50 carry the rotation's ulps);
* ``refit_root_aabb``, a min / max of the refitted tables: exact;
* K11's tree (``build_tlas_plain``): bit for bit ``build_tlas`` of the same
  boxes, signed zeros, NaNs and inverted boxes included, and its candidate
  sets equal to the flat ``slab`` test (``tests/test_torch_tlas.py``'s
  rays).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ptrt_tpu.core import mat as ref_mat
from ptrt_tpu.core.vec import Vec3 as RefVec3
from ptrt_tpu.geometry import dtransform as ref_dt
from ptrt_tpu.geometry import refit as ref_refit
from ptrt_tpu.geometry import scene_geom as ref_sg
from ptrt_tpu.geometry.mesh import Mesh as RefMesh

from ptrt_tpu_torch import tables
from ptrt_tpu_torch.core import mat
from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.geometry import dtransform as dt
from ptrt_tpu_torch.geometry import refit, tlas
from ptrt_tpu_torch.geometry.transform import AABB, Transform3D
from ptrt_tpu_torch.render import traverse
from test_torch_shading import torch_one_thread  # noqa: F401
from test_torch_tables import ref_np
from test_torch_tlas import _flat, _rays, _vec

MAT_TOL = dict(rtol=1e-5, atol=1e-6)
ROW_TOL = dict(rtol=1e-5, atol=1e-5)
BOX_TOL = dict(rtol=1e-5, atol=1e-4)
SET_SIZES = (1, 9, 192, 4097)


def _trs(n: int, seed: int):
    """Seeded TRS of ``n`` instances: scales of both signs, some 0 and some
    1e-6 (a hidden slot, at y = -100), angles past 2 pi."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-50.0, 50.0, (n, 3)).astype(np.float32)
    rot = rng.uniform(-9.0, 9.0, (n, 3)).astype(np.float32)
    scale = (rng.uniform(0.2, 3.0, (n, 3))
             * rng.choice([-1.0, 1.0], (n, 3))).astype(np.float32)
    scale[rng.random((n, 3)) < 0.05] = 0.0
    hidden = rng.random(n) < 0.2
    scale[hidden] = 1e-6
    pos[hidden, 1] = -100.0
    lo = -rng.uniform(0.1, 2.0, (n, 3)).astype(np.float32)
    hi = rng.uniform(0.1, 2.0, (n, 3)).astype(np.float32)
    return pos, rot, scale, lo, hi


def _t(*arrays):
    return [torch.from_numpy(np.array(a, order="C")) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _assert_rows(got: np.ndarray, want: np.ndarray, pos: np.ndarray,
                 scale: np.ndarray):
    """The rows within ROW_TOL, and also within 1e-6 of the magnitude of
    the terms each element is made of: a rotation entry over its scale
    (up to 1e6 on a collapsed instance) and, for the translation, the sum
    of |S⁻¹Rᵀ| |t|."""
    inv = 1.0 / np.maximum(np.abs(scale.astype(np.float64)), 1e-12)
    terms = np.zeros(want.shape, np.float64)
    aff = terms[:, 0:12].reshape(-1, 3, 4)
    aff[:, :, :3] = inv[:, :, None]
    aff[:, :, 3] = np.einsum("nij,nj->ni", np.abs(
        want[:, 0:12].reshape(-1, 3, 4)[:, :, :3].astype(np.float64)),
        np.abs(pos))
    terms[:, 0:12] = aff.reshape(-1, 12)
    terms[:, 12:21] = np.repeat(inv[:, None, :], 3, 1).reshape(-1, 9)
    err = np.abs(got.astype(np.float64) - want)
    tol = ROW_TOL["rtol"] * np.abs(want) + ROW_TOL["atol"] + 1e-6 * terms
    assert (err <= tol).all(), (err - tol).max()


# -- core/mat -----------------------------------------------------------------

def _mat_cases():
    rng = np.random.default_rng(3)
    v = rng.uniform(-2.0, 2.0, 3).astype(np.float32)
    r = rng.uniform(-7.0, 7.0, 3).astype(np.float32)
    s = rng.uniform(0.3, 2.0, 3).astype(np.float32)
    p = rng.uniform(-3.0, 3.0, (3, 16)).astype(np.float32)
    a = float(r[0])
    pv = lambda: Vec3(*_t(*p))
    rv = lambda: RefVec3(*_j(*p))
    port_trs = lambda: mat.trs(Vec3(*_t(*v)), Vec3(*_t(*r)), Vec3(*_t(*s)))
    ref_trs = lambda: ref_mat.trs(RefVec3(*_j(*v)), RefVec3(*_j(*r)),
                                  RefVec3(*_j(*s)))
    vec = lambda x: np.stack([np.asarray(c) for c in (x.x, x.y, x.z)])
    return {
        "identity": (mat.identity, ref_mat.identity),
        "translate": (lambda: mat.translate(tuple(map(float, v))),
                      lambda: ref_mat.translate(tuple(map(float, v)))),
        "scale": (lambda: mat.scale(tuple(map(float, s))),
                  lambda: ref_mat.scale(tuple(map(float, s)))),
        "scale_uniform": (lambda: mat.scale(1.5), lambda: ref_mat.scale(1.5)),
        "rotation_x": (lambda: mat.rotation_x(a),
                       lambda: ref_mat.rotation_x(a)),
        "rotation_y": (lambda: mat.rotation_y(a),
                       lambda: ref_mat.rotation_y(a)),
        "rotation_z": (lambda: mat.rotation_z(a),
                       lambda: ref_mat.rotation_z(a)),
        "rotation_euler_xyz": (
            lambda: mat.rotation_euler_xyz(*map(float, r)),
            lambda: ref_mat.rotation_euler_xyz(*map(float, r))),
        "rotation_axis_angle": (
            lambda: mat.rotation_axis_angle(Vec3(*_t(*v)), a),
            lambda: ref_mat.rotation_axis_angle(RefVec3(*_j(*v)), a)),
        "trs": (port_trs, ref_trs),
        "inverse_rigid_trs": (lambda: mat.inverse_rigid_trs(port_trs()),
                              lambda: ref_mat.inverse_rigid_trs(ref_trs())),
        "transform_point": (
            lambda: vec(mat.transform_point(port_trs(), pv())),
            lambda: vec(ref_mat.transform_point(ref_trs(), rv()))),
        "transform_dir": (
            lambda: vec(mat.transform_dir(port_trs(), pv())),
            lambda: vec(ref_mat.transform_dir(ref_trs(), rv()))),
        "transform_normal": (
            lambda: vec(mat.transform_normal(mat.normal_matrix(port_trs()),
                                             pv())),
            lambda: vec(ref_mat.transform_normal(
                ref_mat.normal_matrix(ref_trs()), rv()))),
        "normal_matrix": (lambda: mat.normal_matrix(port_trs()),
                          lambda: ref_mat.normal_matrix(ref_trs())),
    }


@pytest.mark.parametrize("name", sorted(_mat_cases()))
def test_mat_matches_reference(name):
    port, ref = _mat_cases()[name]
    got = np.asarray(port())
    want = np.asarray(ref())
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **MAT_TOL)


def test_trs_composes_transform3d():
    """``trs`` is Transform3D's world matrix, and the normal matrix its
    inverse transpose."""
    t = Transform3D(position=(1.0, -2.0, 0.5), rotation=(0.3, -1.1, 2.0),
                    scale=(1.5, 0.5, 2.0))
    m = mat.trs(Vec3(*_t(*np.float32(t.position))),
                Vec3(*_t(*np.float32(t.rotation))),
                Vec3(*_t(*np.float32(t.scale))))
    np.testing.assert_allclose(m.numpy(), t.world_matrix(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(mat.normal_matrix(m).numpy()[:3, :3],
                               t.normal_matrix()[:3, :3], rtol=1e-5,
                               atol=1e-5)


# -- geometry/dtransform ------------------------------------------------------

def test_rot_xyz_matches_reference():
    _, rot, _, _, _ = _trs(64, 1)
    got = dt.rot_xyz(*_t(rot[:, 0], rot[:, 1], rot[:, 2])).numpy()
    want = np.asarray(ref_dt.rot_xyz(*_j(rot[:, 0], rot[:, 1], rot[:, 2])))
    np.testing.assert_allclose(got, want, **MAT_TOL)


def test_instance_mats_matches_reference():
    pos, rot, scale, _, _ = _trs(256, 2)
    got = dt.instance_mats(*_t(pos, rot, scale)).numpy()
    want = np.asarray(ref_dt.instance_mats(*_j(pos, rot, scale)))
    assert got.shape == (256, 24)
    _assert_rows(got, want, pos, scale)
    assert (got[:, 21:] == 0).all()


def test_instance_world_aabbs_matches_reference():
    args = _trs(256, 3)
    lo, hi = dt.instance_world_aabbs(*_t(*args))
    rlo, rhi = ref_dt.instance_world_aabbs(*_j(*args))
    np.testing.assert_allclose(lo.numpy(), np.asarray(rlo), **BOX_TOL)
    np.testing.assert_allclose(hi.numpy(), np.asarray(rhi), **BOX_TOL)
    assert (lo <= hi).all()


def test_apply_world_matches_reference():
    pos, rot, scale, _, _ = _trs(1, 4)
    p = np.random.default_rng(4).uniform(-1, 1, (3, 32)).astype(np.float32)
    got = dt.apply_world(*_t(pos[0], rot[0], scale[0]), Vec3(*_t(*p)))
    want = ref_dt.apply_world(*_j(pos[0], rot[0], scale[0]),
                              RefVec3(*_j(*p)))
    for a, b in zip((got.x, got.y, got.z), (want.x, want.y, want.z)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **BOX_TOL)


@pytest.mark.parametrize("trs", [
    ((1.0, 2.0, -0.5), (0.3, -0.8, 1.2), (1.0, 1.0, 1.0)),
    ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), (2.0, 0.5, 1.5)),
    ((-3.0, 1.0, 4.0), (2.1, 0.4, -0.9), (0.7, 1.3, 2.2)),
])
def test_device_matrices_match_host(trs):
    """The reference's ``test_fused.py`` check on the port: the device rows
    equal the host Transform3D's (atol 1e-5)."""
    pos, rot, scale = trs
    t = Transform3D(position=pos, rotation=rot, scale=scale)
    mats = dt.instance_mats(*_t(*[np.float32([v]) for v in trs]))
    np.testing.assert_allclose(mats[0, 0:12].reshape(3, 4).numpy(),
                               t.inverse_matrix()[:3, :4], atol=1e-5)
    np.testing.assert_allclose(mats[0, 12:21].reshape(3, 3).numpy(),
                               t.normal_matrix()[:3, :3], atol=1e-5)


def test_device_world_aabb_matches_host():
    pos, rot, scale = (1.0, -2.0, 3.0), (0.5, 1.1, -0.3), (1.5, 0.5, 2.0)
    t = Transform3D(position=pos, rotation=rot, scale=scale)
    lo_l = np.array([-0.5, -0.25, -1.0], np.float32)
    hi_l = np.array([0.5, 0.75, 1.0], np.float32)
    host = AABB(lo_l.astype(np.float64),
                hi_l.astype(np.float64)).transformed(t.world_matrix())
    lo, hi = dt.instance_world_aabbs(*_t(*[np.float32([v]) for v in
                                           (pos, rot, scale)]),
                                     *_t(lo_l[None], hi_l[None]))
    np.testing.assert_allclose(lo[0].numpy(), host.lo, atol=1e-4)
    np.testing.assert_allclose(hi[0].numpy(), host.hi, atol=1e-4)


# -- refit_root_aabb ----------------------------------------------------------

def _heightfield(cls, n: int = 8):
    xs = np.linspace(-2.0, 2.0, n, dtype=np.float32)
    h = (0.3 * np.sin(xs[:, None] * 2.0) * np.cos(xs[None, :])).astype(
        np.float32)
    p = np.stack(np.broadcast_arrays(xs[None, :], h, xs[:, None]), -1)
    a, b, c, d = p[:-1, :-1], p[:-1, 1:], p[1:, 1:], p[1:, :-1]
    tris = np.concatenate([np.stack([a, c, b], -2).reshape(-1, 3, 3),
                           np.stack([a, d, c], -2).reshape(-1, 3, 3)])
    return cls.from_triangles(tris.astype(np.float32)), tris


def test_refit_root_aabb_matches_reference():
    """On a refitted 8x8 heightfield: the root row's used slot boxes, their
    union, exactly the reference's."""
    rm, tris = _heightfield(RefMesh)
    rg = ref_sg.assemble_geometry([rm], world=False)
    rplan = ref_refit.build_refit_plan(rg)
    new = (tris * np.float32(1.3) + np.float32(0.1)).astype(np.float32)
    new[..., 1] += np.float32(0.4) * np.sin(new[..., 0])
    rg2 = ref_refit.refit_apply(rg, rplan, *_j(*(new[:, k] for k in range(3))))
    want = ref_refit.refit_root_aabb(rg2, rplan)

    port = tables.from_reference(device=torch.device("cpu"),
                                 geometry=ref_np(rg),
                                 refit_plan=ref_np(rplan))
    g, plan = port["geometry"], port["refit_plan"]
    refit.refit_apply(g, plan, *_t(*(new[:, k] for k in range(3))))
    got = refit.refit_root_aabb(g, plan)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    # the box of the new triangles
    assert np.array_equal(got[0].numpy(), new.reshape(-1, 3).min(0))
    assert np.array_equal(got[1].numpy(), new.reshape(-1, 3).max(0))


# -- K11's plain version ------------------------------------------------------

@pytest.mark.parametrize("n", SET_SIZES)
def test_instances_update_plain(n):
    """Rows and boxes the reference's; the tree ``build_tlas``'s of the same
    boxes, bit for bit; the plain descent's candidate sets over it the flat
    test's; the wrapper on CPU tensors writes the same into its buffers."""
    args = _trs(n, 10 + n)
    mats, lo, hi, tree = dt.instances_update_plain(*_t(*args))
    _assert_rows(mats.numpy(),
                 np.asarray(ref_dt.instance_mats(*_j(*args[:3]))), args[0],
                 args[2])
    rlo, rhi = ref_dt.instance_world_aabbs(*_j(*args))
    np.testing.assert_allclose(lo.numpy(), np.asarray(rlo), **BOX_TOL)
    np.testing.assert_allclose(hi.numpy(), np.asarray(rhi), **BOX_TOL)
    host = tlas.build_tlas(lo.numpy(), hi.numpy())
    assert np.array_equal(tree.numpy().view(np.uint32), host.view(np.uint32))

    bufs = [torch.full_like(mats, np.nan), torch.full_like(lo, np.nan),
            torch.full_like(hi, np.nan), torch.full_like(tree, np.nan)]
    dt.instances_update(*_t(*args), *bufs)
    for a, b in zip(bufs, (mats, lo, hi, tree)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))

    box_lo, box_hi = lo.numpy(), hi.numpy()
    o, d, t = _rays(box_lo, box_hi, seed=n, n=256 if n > 512 else 1024)
    o, d, t = _vec(o), _vec(d), torch.from_numpy(t)
    inv = traverse.safe_inv(d)
    cand, _ = tlas.tlas_candidates(tree, n, o, inv, t)
    assert torch.equal(cand, _flat(box_lo, box_hi, o, inv, t))


@pytest.mark.parametrize("n", (5, 17, 300))
def test_tree_plain_signed_zeros_nan_inverted(n):
    """``build_tlas_plain`` bit for bit ``build_tlas`` on boxes holding +0
    and -0 bounds, a NaN, an infinite box and inverted boxes: the tree's
    fmin / fmax are numpy's (a tie takes the second operand)."""
    rng = np.random.default_rng(n)
    lo = rng.normal(size=(n, 3)).astype(np.float32)
    hi = lo + rng.random((n, 3)).astype(np.float32)
    lo[0] = hi[0] + 1.0
    lo[1, 0], hi[1, 0] = -0.0, 0.0
    lo[2, 1] = np.nan
    hi[3] = np.inf
    lo[4], hi[4] = 0.0, -0.0
    got = tlas.build_tlas_plain(*_t(lo, hi)).numpy()
    assert np.array_equal(got.view(np.uint32),
                          tlas.build_tlas(lo, hi).view(np.uint32))


def test_instances_update_refuses_what_the_kernel_does_not_take():
    args = _t(*_trs(4, 0))
    good = [torch.zeros((4, 24)), torch.zeros((4, 3)), torch.zeros((4, 3)),
            torch.zeros((tlas.tlas_node_count(4), tlas.TLAS_WIDTH,
                         tlas.TLAS_ROW))]
    with pytest.raises(ValueError, match="tlas"):
        dt.instances_update(*args, *good[:3], torch.zeros((2, 4, 8)))
    with pytest.raises(TypeError):
        dt.instances_update(*args, good[0].double(), *good[1:])
    with pytest.raises(ValueError, match="contiguous"):
        dt.instances_update(*args[:4], args[4].t().contiguous().t(), *good)
