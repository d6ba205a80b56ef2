"""K5's plain versions against the JAX reference: the device refit
(``geometry/refit.py``) and the Morton-sorted refill (``geometry/lbvh.py``).

On the CPU ``refit_apply`` and ``morton_codes`` run their plain versions,
which the kernels are held to bit for bit on the card.  Here the same
meshes and new vertices, made from a numpy seed, go through the reference's
``refit_apply`` / ``lbvh_update`` and the port's: every table (node rows,
triangle rows, the v0 / e1 / e2 mirrors) equal, standalone and for an
instance at nonzero offsets inside a merged set.  Equality is by value
(``np.array_equal``): a box bound of +0 and one of -0 are the same bound,
and the min/max of the two packages may pick either.  Morton codes are
equal bit for bit; the order is the reference's ``morton_order`` (its
``jax.lax.sort`` keeps tied codes in index order) on a mesh whose codes tie
many times over, and ``lbvh_update``'s tables equal the reference's there
as where every code is distinct; after a full re-shape the port's tree
walked ray by ray (``walk_counts_plain``, the kernel's walk) gives the
brute-force answers.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ptrt_tpu.geometry import lbvh as ref_lbvh
from ptrt_tpu.geometry import refit as ref_refit
from ptrt_tpu.geometry import scene_geom as ref_sg
from ptrt_tpu.geometry.mesh import Mesh as RefMesh
from ptrt_tpu.scene import pt_scene as ref_pt_scene

from ptrt_tpu_torch import tables
from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.geometry import lbvh, refit, scene_geom
from ptrt_tpu_torch.geometry.mesh import Mesh
from ptrt_tpu_torch.render import traverse
from test_torch_shading import torch_one_thread  # noqa: F401
from test_torch_tables import ref_np

CPU = torch.device("cpu")


def _soup(rng, n, span=4.0, size=0.15):
    c = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    b = c + rng.uniform(-size, size, (n, 3)).astype(np.float32)
    d = c + rng.uniform(-size, size, (n, 3)).astype(np.float32)
    return np.stack([c, b, d], axis=1)


def _meshes(ref: bool):
    """A sphere, a triangle soup and a cube, in the mesh classes of one
    package."""
    rng = np.random.default_rng(11)
    cls = RefMesh if ref else Mesh
    soup = _soup(rng, 150)
    return [cls.sphere(10), cls.from_triangles(soup), cls.cube()]


def _wobble(tris: np.ndarray, seed: int) -> np.ndarray:
    """The same triangle count, new vertices."""
    rng = np.random.default_rng(seed)
    w = 1.0 + 0.25 * np.sin(tris[..., 0] * 9.0 + rng.uniform(0, 6))
    return (tris * w[..., None]).astype(np.float32)


def _tris(m) -> np.ndarray:
    return np.stack(m.triangle_arrays(world=False), axis=1)


def _assert_tables(ref_geom, port_geom, slot_range=None):
    r = ref_np(ref_geom)
    p = tables.to_numpy(port_geom)
    for k in ("node_rows", "tri_rows"):
        assert np.array_equal(r[k], p[k]), k
    for k in ("v0", "e1", "e2"):
        for a, b in zip(r[k], p[k]):
            assert np.array_equal(a, b), k


def _port_geom(ref_geom):
    g = tables.from_reference(device=CPU, geometry=ref_np(ref_geom))
    return g["geometry"]


@pytest.mark.parametrize("where", ["standalone", "merged"])
def test_refit_apply_matches_reference(where):
    """The plain refit writes the reference's tables, bit for bit by value:
    a standalone sphere, or the second of three instances of a merged set
    (nonzero node, block and slot offsets)."""
    ref_m, port_m = _meshes(True), _meshes(False)
    if where == "standalone":
        rg = ref_sg.assemble_geometry([ref_m[0]], world=False)
        pg = scene_geom.assemble_geometry([port_m[0]], None, CPU, world=False)
        _assert_tables(rg, pg)
        rplan = ref_refit.build_refit_plan(rg)
        pplan = refit.build_refit_plan(pg)
        k = 0
    else:
        rinst = tuple(ref_sg.assemble_instance(m, i) for i, m in
                      enumerate(ref_m))
        pinst = tuple(scene_geom.assemble_instance(m, i, None, CPU)
                      for i, m in enumerate(port_m))
        rg, pg = (ref_sg.merge_instances(rinst).geom,
                  scene_geom.merge_instances(pinst).geom)
        _assert_tables(rg, pg)
        rplan = ref_pt_scene._merged_refit_plans(rinst)[1]
        entries = [dict(inst=i, plan=refit.build_refit_plan(i.geom))
                   for i in pinst]
        from ptrt_tpu_torch.scene.pt_scene import _merged_refit_plans
        pplan = _merged_refit_plans(entries)[1]
        assert (pplan.node_off, pplan.blk_off, pplan.slot_off) == (
            rplan.node_off, rplan.blk_off, rplan.slot_off) != (0, 0, 0)
        k = 1
    new = _wobble(_tris(port_m[k]), 5)
    assert np.array_equal(new, _wobble(_tris(ref_m[k]), 5))
    rg2 = ref_refit.refit_apply(rg, rplan, *(jnp.asarray(new[:, j])
                                             for j in range(3)))
    out = refit.refit_apply(pg, pplan, *(torch.from_numpy(
        np.ascontiguousarray(new[:, j])) for j in range(3)))
    assert out is pg  # written in place
    _assert_tables(rg2, pg)
    # the tables moved: the refit is no copy of the build
    assert not np.array_equal(np.asarray(rg2.node_rows),
                              np.asarray(rg.node_rows))


def test_refit_plan_matches_reference():
    rg = ref_sg.assemble_geometry([_meshes(True)[0]], world=False)
    pg = scene_geom.assemble_geometry([_meshes(False)[0]], None, CPU,
                                      world=False)
    rp, pp = ref_refit.build_refit_plan(rg), refit.build_refit_plan(pg)
    for k in ("slot_tri", "cba", "lb", "lmask", "imask"):
        assert np.array_equal(getattr(rp, k), getattr(pp, k)), k
    assert len(rp.levels) == len(pp.levels) > 1
    assert all(np.array_equal(a, b) for a, b in zip(rp.levels, pp.levels))


def test_refit_refuses_a_plan_that_does_not_fit():
    pg = scene_geom.assemble_geometry([Mesh.cube()], None, CPU, world=False)
    plan = refit.build_refit_plan(pg).placed(5, 0, 0)
    v = torch.zeros((12, 3))
    with pytest.raises(ValueError, match="does not fit"):
        refit.refit_apply(pg, plan, v, v, v)


@pytest.mark.parametrize("n", [300, 1024])
def test_morton_codes_match_reference(n):
    tris = _soup(np.random.default_rng(n), n)
    v = [tris[:, j] for j in range(3)]
    cent = (np.minimum(np.minimum(v[0], v[1]), v[2])
            + np.maximum(np.maximum(v[0], v[1]), v[2])) * np.float32(0.5)
    want = np.asarray(ref_lbvh.morton_codes(
        *(jnp.asarray(cent[:, a]) for a in range(3)),
        jnp.asarray(cent.min(0)), jnp.asarray(cent.max(0))))
    got = lbvh.morton_codes(*(torch.from_numpy(np.ascontiguousarray(x))
                              for x in v))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    order = lbvh.morton_order(*(torch.from_numpy(np.ascontiguousarray(x))
                                for x in v))
    assert sorted(order.tolist()) == list(range(n))
    assert (np.diff(want[order.numpy()]) >= 0).all()


def test_lbvh_update_matches_reference_when_codes_are_distinct():
    rng = np.random.default_rng(21)
    tris0 = _soup(rng, 200)
    rg = ref_sg.assemble_geometry([RefMesh.from_triangles(tris0)],
                                  world=False)
    pg = scene_geom.assemble_geometry([Mesh.from_triangles(tris0)], None,
                                      CPU, world=False)
    rplan, pplan = ref_refit.build_refit_plan(rg), refit.build_refit_plan(pg)
    tris1 = _soup(rng, 200)
    cols = [torch.from_numpy(np.ascontiguousarray(tris1[:, j]))
            for j in range(3)]
    codes = lbvh.morton_codes(*cols)
    assert codes.unique().numel() == 200  # no ties: one order
    rg2 = ref_lbvh.lbvh_update(rg, rplan, *(jnp.asarray(tris1[:, j])
                                            for j in range(3)))
    lbvh.lbvh_update(pg, pplan, *cols)
    _assert_tables(rg2, pg)
    slot_map = lbvh.lbvh_slot_map(pplan, lbvh.morton_order(*cols))
    assert np.array_equal(slot_map.numpy(), np.asarray(ref_lbvh.lbvh_slot_map(
        rplan, ref_lbvh.morton_order(*(jnp.asarray(tris1[:, j])
                                       for j in range(3))))))


def test_lbvh_update_traces_like_brute_force():
    """A complete re-shape with tied codes (each triangle twice, the copy
    shrunk about the middle of its box, the centroid the codes take): the port's tree, walked ray by ray as the
    kernel walks it, finds the brute-force answers."""
    rng = np.random.default_rng(4)
    tris0 = _soup(rng, 400)
    pg = scene_geom.assemble_geometry([Mesh.from_triangles(tris0)], None,
                                      CPU, world=False)
    plan = refit.build_refit_plan(pg)
    half = _soup(rng, 200, span=2.0, size=0.8)
    mid = 0.5 * (half.min(axis=1, keepdims=True)
                 + half.max(axis=1, keepdims=True))
    tris1 = np.concatenate([half, mid + 0.5 * (half - mid)]).astype(
        np.float32)
    cols = [torch.from_numpy(np.ascontiguousarray(tris1[:, j]))
            for j in range(3)]
    assert lbvh.morton_codes(*cols).unique().numel() < 400
    lbvh.lbvh_update(pg, plan, *cols)
    n = 160
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.5 + [0, 0, 8]
    d = rng.uniform(-1.5, 1.5, (n, 3)) - o  # towards the soup
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    vec = lambda a: Vec3(*[torch.from_numpy(np.ascontiguousarray(
        a[:, k], np.float32)) for k in range(3)])
    t = torch.full((n,), traverse.T_MAX)
    walked = traverse.walk_counts_plain(pg, vec(o), vec(d), t, "closest")
    brute = traverse.closest_hit_plain(pg, vec(o), vec(d), t)
    hit = brute.slot >= 0
    assert hit.float().mean() > 0.3
    assert torch.equal(walked.answer.slot >= 0, hit)
    assert torch.equal(walked.answer.mesh, brute.mesh)
    torch.testing.assert_close(walked.answer.t[hit], brute.t[hit], rtol=1e-5,
                               atol=0.0)
    t_s = torch.full((n,), 20.0)
    assert torch.equal(
        traverse.walk_counts_plain(pg, vec(o), vec(d), t_s, "any").answer,
        traverse.any_hit_plain(pg, vec(o), vec(d), t_s))



def _tied_soup(rng, n_distinct: int, copies: int) -> np.ndarray:
    """``n_distinct`` soup triangles each repeated ``copies`` times in a
    seeded order: every code tied ``copies`` times at least."""
    base = _soup(rng, n_distinct)
    return base[rng.permutation(np.arange(n_distinct * copies)
                                % n_distinct)]


def test_morton_order_matches_reference_with_tied_codes():
    """The plain order (the kernel's oracle) is the reference's stable order
    where codes tie: duplicated triangles, and a heightfield whose two
    triangles a cell share their centroid's x and z."""
    rng = np.random.default_rng(31)
    soup = _tied_soup(rng, 150, 4)
    z, x = np.mgrid[0:12, 0:17].astype(np.float32)
    h = np.stack([x, 0.05 * np.sin(x + z), z], axis=-1)
    a, b, c, d = h[:-1, :-1], h[:-1, 1:], h[1:, 1:], h[1:, :-1]
    field = np.concatenate([np.stack([a, c, b], -2).reshape(-1, 3, 3),
                            np.stack([a, d, c], -2).reshape(-1, 3, 3)])
    for tris in (soup, field.astype(np.float32)):
        cols = [torch.from_numpy(np.ascontiguousarray(tris[:, j]))
                for j in range(3)]
        order, codes = lbvh.morton_sort(*cols, with_codes=True)
        assert codes.unique().numel() < 0.6 * tris.shape[0]  # many ties
        want = np.asarray(ref_lbvh.morton_order(
            *(jnp.asarray(tris[:, j]) for j in range(3))))
        assert order.dtype == torch.int32
        assert np.array_equal(order.numpy(), want)
        assert torch.equal(lbvh.morton_order(*cols), order)
        assert torch.equal(codes, lbvh.morton_codes(*cols))


def test_lbvh_update_matches_reference_with_tied_codes():
    """The Morton refill of a mesh whose codes tie (each triangle four
    times) writes the reference's tables: the tied triangles fill their
    slots in index order in both."""
    rng = np.random.default_rng(37)
    tris0 = _soup(rng, 240)
    rg = ref_sg.assemble_geometry([RefMesh.from_triangles(tris0)],
                                  world=False)
    pg = scene_geom.assemble_geometry([Mesh.from_triangles(tris0)], None,
                                      CPU, world=False)
    rplan, pplan = ref_refit.build_refit_plan(rg), refit.build_refit_plan(pg)
    tris1 = _tied_soup(rng, 60, 4)
    cols = [torch.from_numpy(np.ascontiguousarray(tris1[:, j]))
            for j in range(3)]
    assert lbvh.morton_codes(*cols).unique().numel() <= 60
    rg2 = ref_lbvh.lbvh_update(rg, rplan, *(jnp.asarray(tris1[:, j])
                                            for j in range(3)))
    lbvh.lbvh_update(pg, pplan, *cols)
    _assert_tables(rg2, pg)
