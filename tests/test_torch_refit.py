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

import dataclasses

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


# -- the arrival design: the plan's arrays and a walk of it on the host -------


def _port_plan(rp) -> refit.RefitPlan:
    """The reference's plan as the port keeps it (host arrays)."""
    a = lambda k: np.asarray(getattr(rp, k), np.int32)
    return refit.RefitPlan(
        slot_tri=a("slot_tri"), levels=tuple(np.asarray(x, np.int32)
                                             for x in rp.levels),
        cba=a("cba"), lb=a("lb"), lmask=a("lmask"), imask=a("imask"),
        node_off=int(rp.node_off), blk_off=int(rp.blk_off),
        slot_off=int(rp.slot_off))


def _arrival_cases(where: str):
    """(geometry, [(plan, new triangles)]): the reference's plan of a
    sphere (standalone), every instance's plan placed in a merged set of a
    sphere, a soup and a cube (nonzero offsets from the second on), or a
    4,000-triangle soup whose tree is deeper than the arrival kernel's top
    (levels of 177, 64, 8 and 1 nodes)."""
    if where == "deep":
        tris = _soup(np.random.default_rng(3), 4000)
        pg = scene_geom.assemble_geometry([Mesh.from_triangles(tris)], None,
                                          CPU, world=False)
        plan = refit.build_refit_plan(pg)
        assert len(plan.levels) > refit.TOP_LEVELS
        return pg, [(plan, _wobble(tris, 9))]
    if where == "reference":
        rg = ref_sg.assemble_geometry([_meshes(True)[0]], world=False)
        m = _meshes(False)[0]
        pg = scene_geom.assemble_geometry([m], None, CPU, world=False)
        return pg, [(_port_plan(ref_refit.build_refit_plan(rg)),
                     _wobble(_tris(m), 5))]
    from ptrt_tpu_torch.scene.pt_scene import _merged_refit_plans

    port_m = _meshes(False)
    pinst = tuple(scene_geom.assemble_instance(m, i, None, CPU)
                  for i, m in enumerate(port_m))
    pg = scene_geom.merge_instances(pinst).geom
    plans = _merged_refit_plans([dict(inst=i, plan=refit.build_refit_plan(
        i.geom)) for i in pinst])
    return pg, [(p, _wobble(_tris(m), 7 + k))
                for k, (p, m) in enumerate(zip(plans, port_m))]


def _cols(tris):
    return [torch.from_numpy(np.ascontiguousarray(tris[:, j]))
            for j in range(3)]


@pytest.mark.parametrize("where", ["reference", "merged", "deep"])
def test_refit_plan_arrival_arrays(where):
    """(~1 s) The arrival path's arrays agree with the tree the plan keeps
    (``levels``, ``lmask``, ``imask``, ``cba``, ``lb``): each node but the
    root held by one internal slot of a node one level up, each held leaf
    block by the leaf slot that names it, each node's used slots counted
    once and equal to the arrivals it gets (its held blocks and children),
    the empty nodes those with none."""
    _, cases = _arrival_cases(where)
    for plan, _ in cases:
        up = plan.arrival()
        n, b = plan.num_nodes, plan.num_blocks
        depth = {int(x): d for d, ids in enumerate(reversed(plan.levels))
                 for x in ids}
        assert sorted(depth) == list(range(n))
        parent, blk_node, blk_slot = (up["parent"], up["blk_node"],
                                      up["blk_slot"])
        assert parent.shape == (n,) and blk_node.shape == (b,)
        assert parent[0] == -1
        for x in range(1, n):
            p = int(parent[x])
            s = x - int(plan.cba[p])
            assert depth[p] == depth[x] - 1 and 0 <= s < 8
            assert (plan.imask[p] >> s) & 1 and not (plan.lmask[p] >> s) & 1
        held = blk_node >= 0
        assert held.any()
        for blk in np.nonzero(held)[0]:
            x, s = int(blk_node[blk]), int(blk_slot[blk])
            assert (plan.lmask[x] >> s) & 1 and plan.lb[x] + s == blk
        assert (blk_slot[~held] == -1).all()
        masks = (plan.lmask | plan.imask) & 0xFF
        assert np.array_equal(up["used"],
                              [bin(int(m)).count("1") for m in masks])
        arrivals = (np.bincount(blk_node[held], minlength=n)
                    + np.bincount(parent[1:], minlength=n))
        assert np.array_equal(arrivals, up["used"])
        assert np.array_equal(up["empty"], np.nonzero(up["used"] == 0)[0])
        # the climb: cut at the top (depth <= 2), which the last block works
        cl = plan.climb()
        top = {x for x in range(n) if depth[x] <= 2}
        assert sorted(cl["top_ids"].tolist()) == sorted(top)
        assert cl["top_ids"][-1] == 0
        assert [depth[int(x)] for x in cl["top_ids"]] == sorted(
            (depth[x] for x in top), reverse=True)
        assert cl["top_starts"][-1] == len(top)
        for k in ("parent", "blk_node"):
            want = np.where(np.isin(up[k], sorted(top)), -1, up[k])
            assert np.array_equal(cl[k], want), k
        assert not set(cl["empty"].tolist()) & top
        place = {int(x): j for j, x in enumerate(cl["top_ids"])}
        src = cl["top_src"].view(np.uint32)
        for j, x in enumerate(cl["top_ids"]):
            for s in range(8):
                kind, at = int(src[j, s]) >> 30, int(src[j, s]) & (2**30 - 1)
                if (plan.lmask[x] >> s) & 1:
                    assert (kind, at) == (1, plan.lb[x] + s)
                elif (plan.imask[x] >> s) & 1:
                    c = int(plan.cba[x]) + s
                    assert (kind, at) == ((3, place[c]) if c in top
                                          else (2, c))
                else:
                    assert kind == 0
        dev = plan.device_arrays(CPU)
        for k in ("parent", "blk_node", "empty", "top_ids", "top_src"):
            assert np.array_equal(dev[k].numpy(), cl[k]), k
        assert np.array_equal(dev["used"].numpy(), up["used"])
        assert dev["counter"].shape == (n + 1,) and not dev["counter"].any()
        assert dev["scratch"].shape == (b + n, 6)
        # a placed copy shares them
        assert plan.placed(1, 2, 3).device_arrays(CPU) is dev


def _arrival_walk(geom, plan, tris, rng):
    """The arrival design run on the host, as the kernel runs it: the
    block boxes from the slots; then the leaf blocks and empty nodes below
    the top in a shuffled order, each counted at its node, the arrival
    that completes a node's used slots working it (its slot bounds from the
    block and child boxes, read through its row's merged indices, the
    unused (0, -1)) and climbing up to the top; then the top (depth <= 2)
    level by level from ``climb``'s ``top_src``, as the last block does.
    Returns the plan's node rows (N, 48) and the root's box."""
    B, N, BIG = plan.num_blocks, plan.num_nodes, np.float32(refit.BIG)
    st = plan.slot_tri
    pad = st < 0
    src = tris if len(tris) else np.zeros((1, 3, 3), np.float32)
    v = [np.where(pad[:, None], np.float32(0), src[:, j][np.maximum(st, 0)])
         for j in range(3)]
    lo = np.where(pad[:, None], BIG, np.minimum(np.minimum(v[0], v[1]), v[2]))
    hi = np.where(pad[:, None], -BIG,
                  np.maximum(np.maximum(v[0], v[1]), v[2]))
    blk_lo, blk_hi = (lo.reshape(B, 8, 3).min(1), hi.reshape(B, 8, 3).max(1))
    rows = geom.node_rows.numpy()[plan.node_off:plan.node_off + N].copy()
    node_lo = np.zeros((N, 3), np.float32)
    node_hi = np.zeros((N, 3), np.float32)
    used, cl = plan.arrival()["used"], plan.climb()
    counter = np.zeros(N, np.int64)
    visits = np.zeros(N, np.int64)

    def put(x, s_lo, s_hi, slot_used):
        rows[x, 0:24].reshape(3, 8)[:] = np.where(slot_used, s_lo.T, 0.0)
        rows[x, 24:48].reshape(3, 8)[:] = np.where(slot_used, s_hi.T, -1.0)
        node_lo[x], node_hi[x] = s_lo.min(0), s_hi.max(0)
        visits[x] += 1

    def work(x):
        row = rows[x]
        cba = int(row[48]) - plan.node_off
        lb = int(row[49]) - plan.blk_off
        lmask, imask = int(row[50]), int(row[51])
        s_lo = np.full((8, 3), BIG, np.float32)
        s_hi = np.full((8, 3), -BIG, np.float32)
        for s in range(8):
            if (lmask >> s) & 1:
                s_lo[s], s_hi[s] = blk_lo[lb + s], blk_hi[lb + s]
            elif (imask >> s) & 1:
                s_lo[s], s_hi[s] = node_lo[cba + s], node_hi[cba + s]
        put(x, s_lo, s_hi, ((lmask | imask) >> np.arange(8)) & 1 == 1)

    items = [(False, k) for k in range(B)] + [(True, int(e))
                                             for e in cl["empty"]]
    for j in rng.permutation(len(items)):
        empty, k = items[j]
        if empty:
            work(k)
            x = int(cl["parent"][k])
        else:
            x = int(cl["blk_node"][k])
        while x >= 0:
            counter[x] += 1
            if counter[x] < used[x]:
                break
            work(x)
            counter[x] = 0
            x = int(cl["parent"][x])
    # the last block: the top, deepest level first
    top_src = cl["top_src"].view(np.uint32)
    top_lo = np.zeros((len(cl["top_ids"]), 3), np.float32)
    top_hi = np.zeros_like(top_lo)
    tables = {1: (blk_lo, blk_hi), 2: (node_lo, node_hi), 3: (top_lo, top_hi)}
    for j, x in enumerate(cl["top_ids"]):
        s_lo = np.full((8, 3), BIG, np.float32)
        s_hi = np.full((8, 3), -BIG, np.float32)
        for s in range(8):
            kind, at = int(top_src[j, s]) >> 30, int(top_src[j, s]) & (
                2**30 - 1)
            if kind:
                t_lo, t_hi = tables[kind]
                s_lo[s], s_hi[s] = t_lo[at], t_hi[at]
        put(int(x), s_lo, s_hi, (top_src[j] >> 30) != 0)
        top_lo[j], top_hi[j] = node_lo[x], node_hi[x]
    assert not counter.any() and (visits == 1).all()
    return rows[:, :48], (node_lo[0], node_hi[0])


@pytest.mark.parametrize("where", ["reference", "merged", "deep"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_arrival_walk_matches_plain(where, seed):
    """(~1 s) The arrival design, walked on the host over the plan's
    arrays with the leaf blocks arriving in a shuffled order, writes
    ``refit_apply_plain``'s node rows bit for bit (by value) and its root
    box (``refit_apply_plain``'s ``root`` and ``refit_root_aabb``)."""
    geom, cases = _arrival_cases(where)
    rng = np.random.default_rng(seed)
    for plan, tris in cases:
        g = dataclasses.replace(geom, node_rows=geom.node_rows.clone(),
                                tri_rows=geom.tri_rows.clone(),
                                v0=geom.v0.map(torch.clone),
                                e1=geom.e1.map(torch.clone),
                                e2=geom.e2.map(torch.clone))
        root = (torch.empty(3), torch.empty(3))
        refit.refit_apply_plain(g, plan, *_cols(tris), root=root)
        want = g.node_rows.numpy()[plan.node_off:plan.node_off
                                   + plan.num_nodes, :48]
        got, (rlo, rhi) = _arrival_walk(geom, plan, tris, rng)
        assert np.array_equal(got, want)
        assert not np.array_equal(
            got, geom.node_rows.numpy()[plan.node_off:plan.node_off
                                        + plan.num_nodes, :48])
        alo, ahi = refit.refit_root_aabb(g, plan)
        for a, b, c in ((rlo, root[0], alo), (rhi, root[1], ahi)):
            assert np.array_equal(a, b.numpy())
            assert np.array_equal(a, c.numpy())


def test_arrival_walk_without_a_top(monkeypatch):
    """(~1 s) A plan past ``TOP_MAX_SLOTS`` has no top: its climb arrays
    are ``arrival``'s uncut, the arrivals climb to the root, and the walk
    still writes ``refit_apply_plain``'s node rows and root box, under
    three seeds."""
    monkeypatch.setattr(refit, "TOP_MAX_SLOTS", 0)
    geom, [(plan, tris)] = _arrival_cases("deep")
    cl, up = plan.climb(), plan.arrival()
    assert cl["top_ids"].size == 0 and cl["top_starts"].tolist() == [0]
    for k in ("parent", "blk_node", "empty"):
        assert np.array_equal(cl[k], up[k]), k
    g = dataclasses.replace(geom, node_rows=geom.node_rows.clone())
    root = (torch.empty(3), torch.empty(3))
    refit.refit_apply_plain(g, plan, *_cols(tris), root=root)
    want = g.node_rows.numpy()[:, :48]
    for seed in range(3):
        got, (rlo, rhi) = _arrival_walk(geom, plan, tris,
                                        np.random.default_rng(seed))
        assert np.array_equal(got, want)
        assert np.array_equal(rlo, root[0].numpy())
        assert np.array_equal(rhi, root[1].numpy())


@pytest.mark.parametrize("morton", [False, True])
def test_refit_root_box_is_refit_root_aabb(morton):
    """(~1 s) ``refit_apply`` / ``lbvh_update`` with ``root`` write the
    root node's box into it: ``refit_root_aabb`` of the tables they wrote,
    at every instance of a merged set; the tables are those of a call
    without ``root``."""
    geom, cases = _arrival_cases("merged")
    for plan, tris in cases:
        g1 = dataclasses.replace(geom, node_rows=geom.node_rows.clone(),
                                 tri_rows=geom.tri_rows.clone())
        g2 = dataclasses.replace(geom, node_rows=geom.node_rows.clone(),
                                 tri_rows=geom.tri_rows.clone())
        lo = torch.full((2, 3), np.nan)
        hi = torch.full((2, 3), np.nan)
        if morton:
            lbvh.lbvh_update(g1, plan, *_cols(tris), root=(lo[1], hi[1]))
            lbvh.lbvh_update(g2, plan, *_cols(tris))
        else:
            refit.refit_apply(g1, plan, *_cols(tris), root=(lo[1], hi[1]))
            refit.refit_apply(g2, plan, *_cols(tris))
        assert torch.equal(g1.node_rows, g2.node_rows)
        want = refit.refit_root_aabb(g1, plan)
        assert torch.equal(lo[1], want[0]) and torch.equal(hi[1], want[1])
        assert torch.isnan(lo[0]).all() and torch.isnan(hi[0]).all()


def test_refit_apply_refuses_bad_root_and_path():
    """(~0.1 s) A root box must be two (3,) float32 tensors; the kernel has
    one path, so ``refit_apply`` takes no path to choose."""
    pg = scene_geom.assemble_geometry([Mesh.cube()], None, CPU, world=False)
    plan = refit.build_refit_plan(pg)
    v = torch.zeros((12, 3))
    with pytest.raises(ValueError, match=r"need \(3,\)"):
        refit.refit_apply(pg, plan, v, v, v,
                          root=(torch.zeros(4), torch.zeros(4)))
    with pytest.raises(TypeError):
        refit.refit_apply(pg, plan, v, v, v, root=(
            torch.zeros(3, dtype=torch.float64), torch.zeros(3)))
    with pytest.raises(TypeError, match="path"):
        refit.refit_apply(pg, plan, v, v, v, path="arrival")


@pytest.mark.parametrize("morton", [False, True])
def test_fused_frame_takes_the_refit_root_box(morton):
    """(~3 s) A fused fluid frame on the CPU (refit, or the Morton refill):
    the local box it hands K11 for the refilled mesh is ``refit_root_aabb``
    of the tables its refit wrote."""
    from ptrt_tpu_torch.games import fluid

    _, sc, state = fluid.build_scene(48, 32, 8, device="cpu")
    sc.set_performance_preset("fast")
    if morton:
        for m in sc.meshes:
            if m.is_dynamic:
                m.device_lbvh = True
    runner = fluid.make_runner(sc)
    dt = fluid.step_scalars()[0]
    runner.run(state, lambda i: dt, 1)
    assert runner._dyn
    for k in range(len(runner._dyn)):
        lo, hi = refit.refit_root_aabb(runner._geom, runner._plans[k])
        assert torch.equal(runner._llo[k], lo)
        assert torch.equal(runner._lhi[k], hi)
    assert not torch.equal(runner._llo, runner._local_lo)


def test_arrival_walk_of_an_empty_mesh():
    """(~0.1 s) A mesh without triangles: its plan's one node (the root)
    has no used slot, so no block arrives at it; the plan lists it as
    empty, and the walk's first phase writes it: unused slots (0, -1) and
    the inverted +-BIG box, ``refit_root_aabb``'s answer on those rows."""
    pg = scene_geom.assemble_geometry(
        [Mesh.from_triangles(np.zeros((0, 3, 3), np.float32))], None, CPU,
        world=False)
    plan = refit.build_refit_plan(pg)
    up = plan.arrival()
    assert plan.num_nodes == 1 and up["used"].tolist() == [0]
    assert up["empty"].tolist() == [0] and (up["blk_node"] == -1).all()
    rows, (lo, hi) = _arrival_walk(pg, plan, np.zeros((0, 3, 3), np.float32),
                                   np.random.default_rng(0))
    assert (rows[:, :24] == 0).all() and (rows[:, 24:48] == -1).all()
    g = dataclasses.replace(pg, node_rows=pg.node_rows.clone())
    g.node_rows[0, :48] = torch.from_numpy(rows[0])
    alo, ahi = refit.refit_root_aabb(g, plan)
    assert np.array_equal(lo, alo.numpy()) and np.array_equal(hi, ahi.numpy())
    assert (lo == np.float32(refit.BIG)).all() and (hi == -lo).all()
