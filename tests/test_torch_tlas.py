"""The instance tree (``geometry/tlas.py``) that K4 descends, against the
flat box test it replaces and the JAX reference's.

K4 finds a ray's candidate instances by descending the tree; the answer
must be exactly the instances whose world box the flat test passes.  Here,
on hand-made instance sets of 1, 8, 9, 194, 512 and 2,048 boxes (a third
of the larger ones collapsed to 1e-6 at y = -100, as the dynamic scene's
hidden slots):

* the tree's structure (also at the sizes where a level just fills or
  just overflows, and past the 512 instances of one closest window at
  513, 2,048 and 8,192): every instance in exactly one leaf, its box there
  verbatim, every inner box the min / max of its children bit for bit,
  every node but the root the child of exactly one node, and a depth the
  kernel's descent stack for that size holds, up to the 2^24 instances
  the tree's float ids encode;
* the candidate set of the plain descent (``tlas_candidates``, which
  tests the boxes the kernel tests, in the kernel's arithmetic) equal to
  the flat ``traverse.slab`` test bit for bit, on seeded rays with
  axis-parallel directions, origins on box faces and a bound equal to a
  box's entry distance, and equal to the bits of the reference's
  ``_inst_hit_words`` on the same rays (run in JAX on the CPU);
* the tie rule: two identical instances (same mesh, same transform) give
  ``inst`` = the lower id through ``instances_closest_plain``, and the
  lower instance's mesh id, which is the reference's answer too;
* the sets the port builds (``merge_instances``, a transform update,
  ``tables.from_reference``) carry the tree of their own boxes.
"""

import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ptrt_tpu.core.vec import Vec3 as RefVec3
from ptrt_tpu.geometry import scene_geom as ref_sg
from ptrt_tpu.geometry.mesh import Mesh as RefMesh
from ptrt_tpu.render import traverse as ref_traverse

from ptrt_tpu_torch import tables
from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.geometry import scene_geom, tlas
from ptrt_tpu_torch.geometry.mesh import Mesh
from ptrt_tpu_torch.render import traverse
from test_torch_shading import torch_one_thread  # noqa: F401
from test_torch_tables import ref_np

CPU = torch.device("cpu")
SIZES = (1, 8, 9, 194, 512, 2048)
# the tree's levels fill (4, 16) or overflow by one (5, 17) at these too,
# and 513 on is past one closest window (the kernel's deep stack)
TREE_SIZES = (1, 2, 4, 5, 8, 9, 16, 17, 194, 512, 513, 2048, 8192)
RAYS_LARGE = 384  # rays a set past 512 instances is tested with
SOURCE = Path(__file__).resolve().parents[1] / "ptrt_tpu_torch/csrc/traverse.cu"


def _boxes(n: int, seed: int):
    """``n`` world boxes: centres in a 10-unit cube, half sizes 0.05-1.2,
    every third one (from 8 up) collapsed to 1e-6 at y = -100, and two
    exact duplicates where there is room."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-5.0, 5.0, (n, 3)).astype(np.float32)
    e = rng.uniform(0.05, 1.2, (n, 3)).astype(np.float32)
    lo, hi = c - e, c + e
    if n >= 8:
        hidden = np.arange(0, n, 3)
        lo[hidden, 1] = np.float32(-100.0)
        hi[hidden, 1] = np.float32(-100.0) + np.float32(1e-6)
        for a in (0, 2):
            hi[hidden, a] = lo[hidden, a] + np.float32(1e-6)
    if n >= 4:
        lo[n - 1], hi[n - 1] = lo[n // 2], hi[n // 2]
    return lo, hi


def _rays(lo: np.ndarray, hi: np.ndarray, seed: int, n: int = 1024):
    """Seeded rays at the boxes: random ones; axis-parallel ones (two
    direction components exactly 0, signed); origins on a box's face; a
    bound of 1e30, a finite one, a dead one (-1 or 0), or (set by
    ``_bound_at_entry``) exactly a box's entry distance."""
    rng = np.random.default_rng(seed)
    m = lo.shape[0]
    o = rng.uniform(-7.0, 7.0, (n, 3)).astype(np.float32)
    aim = 0.5 * (lo + hi)[rng.integers(0, m, n)]
    d = aim + rng.normal(0.0, 0.7, (n, 3)).astype(np.float32) - o
    q = n // 4
    for j in range(q):  # axis-parallel, +0 and -0 zeros
        a = j % 3
        d[j] = 0.0
        d[j, a] = 1.0 if j % 2 else -1.0
        if j % 4 < 2:
            d[j, (a + 1) % 3] = -0.0
        o[j, (a + 1) % 3] = aim[j, (a + 1) % 3]
        o[j, (a + 2) % 3] = aim[j, (a + 2) % 3]
    for j in range(q, 2 * q):  # on a face of a box
        k = rng.integers(0, m)
        a = j % 3
        o[j] = rng.uniform(lo[k], hi[k]).astype(np.float32)
        o[j, a] = (lo if j % 2 else hi)[k, a]
    d /= np.linalg.norm(d, axis=1, keepdims=True).clip(1e-12)
    d = d.astype(np.float32)
    t = rng.choice(np.array([1e30, 7.5, -1.0, 0.0, 3.0], np.float32), n,
                   p=[0.5, 0.2, 0.05, 0.05, 0.2])
    return o, d, t.astype(np.float32)


def _vec(a: np.ndarray) -> Vec3:
    return Vec3(*[torch.from_numpy(np.ascontiguousarray(a[:, k]))
                  for k in range(3)])


def _flat(lo, hi, o: Vec3, inv: Vec3, t: torch.Tensor) -> torch.Tensor:
    """The flat test of every box, live lanes only: (R, I) bool."""
    lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
    cols = [traverse.slab(lo_t[k], hi_t[k], o, inv, t)
            for k in range(lo.shape[0])]
    return torch.stack(cols, 1) & (t > 0.0)[:, None]


def _bound_at_entry(lo, hi, o: Vec3, inv: Vec3, t: torch.Tensor, seed):
    """Set every eighth ray's bound to exactly its entry distance into a box
    it passes, as the flat test computes it (the inclusive edge)."""
    rng = np.random.default_rng(seed)
    lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
    t = t.clone()
    big = torch.full_like(t, 1e30)
    for i in range(0, t.shape[0], 8):
        k = int(rng.integers(0, lo.shape[0]))
        te = torch.zeros(1)
        for a, (oc, ic) in enumerate(((o.x, inv.x), (o.y, inv.y),
                                      (o.z, inv.z))):
            t0 = (lo_t[k, a] - oc[i:i + 1]) * ic[i:i + 1]
            t1 = (hi_t[k, a] - oc[i:i + 1]) * ic[i:i + 1]
            te = torch.maximum(te, torch.minimum(t0, t1))
        if bool(traverse.slab(lo_t[k], hi_t[k], o, inv, big)[i]) and te > 0:
            t[i] = te[0]
    return t


@pytest.mark.parametrize("n", TREE_SIZES)
def test_tree_structure(n):
    lo, hi = _boxes(n, seed=n)
    tree = tlas.build_tlas(lo, hi)
    counts = tlas.tlas_levels(n)
    assert tree.shape == (sum(counts), tlas.TLAS_WIDTH, tlas.TLAS_ROW)
    assert tree.dtype == np.float32 and counts[-1] == 1
    valid = tree[..., 7] != 0.0
    assert set(np.unique(tree[..., 7])) <= {0.0, 1.0}
    ref = tree[..., 3].astype(np.int64)
    assert np.array_equal(tree[..., 3], ref.astype(np.float32))  # exact
    first_leaf = sum(counts[1:])
    leaves = tree[first_leaf:]
    ids = -1 - ref[first_leaf:][valid[first_leaf:]]
    assert np.array_equal(np.sort(ids), np.arange(n))  # each exactly once
    lv = leaves[valid[first_leaf:]]
    assert np.array_equal(lv[:, 0:3], lo[ids]) and np.array_equal(
        lv[:, 4:7], hi[ids])  # an instance's own box, verbatim
    inner = ref[:first_leaf][valid[:first_leaf]]
    assert np.array_equal(np.sort(inner), np.arange(1, sum(counts)))
    for node in range(first_leaf):
        for s in np.flatnonzero(valid[node]):
            child = tree[int(ref[node, s])]
            kids = child[valid[int(ref[node, s])]]
            both = np.concatenate([kids[:, 0:3], kids[:, 4:7]])
            assert np.array_equal(tree[node, s, 0:3], np.min(both, 0))
            assert np.array_equal(tree[node, s, 4:7], np.max(both, 0))
    # the children of a level's node j are the next level's j*w .. j*w+w-1
    for node in range(first_leaf):
        kids = ref[node][valid[node]]
        assert np.array_equal(kids, np.arange(kids[0], kids[0] + kids.size))
    assert tlas.tlas_stack_bound(n) <= _kernel_stack(n)


def _kernel_constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    return int(m.group(1))


def _kernel_stack(n: int) -> int:
    """The shallowest descent stack the kernel may give a set of ``n``
    instances: up to one closest window (``kWindow`` ids) the shallow one,
    past it the deep one."""
    name = "kTlasStack" if n <= _kernel_constant("kWindow") else \
        "kTlasStackDeep"
    return _kernel_constant(name)


def test_kernel_limits_hold_every_tree():
    """The kernel reads nodes as wide as ``build_tlas`` makes them, and its
    descent stacks hold every tree it may be given: the shallow one every
    set of up to ``kWindow`` instances, the deep one every set up to
    ``kMaxInstances``, the 2^24 ids the tree's exact float ``-1 - k``
    encodes (the bound grows with the set, so the largest set is the
    deepest; 34 entries).  The wrapper's cap is the tables' float-index
    cap."""
    most = _kernel_constant("kMaxInstances")
    window = _kernel_constant("kWindow")
    assert most == scene_geom.MAX_TABLE_INDEX == 1 << 24
    exact = lambda k: int(np.float32(-1 - k)) == -1 - k  # instance k's ref
    assert exact(most - 1) and not exact(most)
    assert _kernel_constant("kTlasWidth") == tlas.TLAS_WIDTH
    assert max(tlas.tlas_stack_bound(n) for n in range(1, window + 1)
               ) <= _kernel_constant("kTlasStack")
    sizes = [window + 1, 2048, 8192, 1 << 20, most - 1, most]
    bounds = [tlas.tlas_stack_bound(n) for n in sizes]
    assert bounds == sorted(bounds) and bounds[2] == 19
    assert bounds[-1] == _kernel_constant("kTlasStackDeep") == 34
    assert all(tlas.tlas_stack_bound(n) <= _kernel_stack(n)
               for n in range(window + 1, 20000, 97))


def _ref_words(lo, hi, o, d, t):
    """The reference's candidate bits (``_inst_hit_words``, live = t > 0)
    of the I instances as an (R, I) bool array.  The words' pad slots are
    left out: they name no instance, and their boxes (lo 1, hi -1) pass as
    the box [-1, 1]^3 under the test's symmetric min / max."""
    iset = SimpleNamespace(count=lo.shape[0], bb_min=jnp.asarray(lo),
                           bb_max=jnp.asarray(hi))
    ov = RefVec3(*[jnp.asarray(o[:, k]) for k in range(3)])
    dv = RefVec3(*[jnp.asarray(d[:, k]) for k in range(3)])
    tj = jnp.asarray(t)
    words = ref_traverse._inst_hit_words(iset, ov, ref_traverse._safe_inv(dv),
                                         tj, tj > 0.0)
    b = ref_traverse._INST_WORD_BITS
    bits = np.stack([(np.asarray(w)[:, None] >> np.arange(b)) & 1
                     for w in words], 1).reshape(t.shape[0], -1) != 0
    return bits[:, :lo.shape[0]]


@pytest.mark.parametrize("n", SIZES)
def test_candidates_equal_flat_test_and_reference(n):
    lo, hi = _boxes(n, seed=100 + n)
    o_np, d_np, t_np = _rays(lo, hi, seed=200 + n,
                             n=1024 if n <= 512 else RAYS_LARGE)
    o, d = _vec(o_np), _vec(d_np)
    inv = traverse.safe_inv(d)
    t = _bound_at_entry(lo, hi, o, inv, torch.from_numpy(t_np), 300 + n)
    flat = _flat(lo, hi, o, inv, t)
    assert flat.any(1).float().mean() > 0.3  # the rays meet boxes
    tree = torch.from_numpy(tlas.build_tlas(lo, hi))
    cand, tests = tlas.tlas_candidates(tree, n, o, inv, t)
    assert torch.equal(cand, flat)
    live = t > 0.0
    assert bool((tests[~live] == 0).all())
    root = int((tree[0, :, 7] != 0.0).sum())  # every live ray's
    assert bool((tests[live] >= root).all())
    if n >= 194:  # the tree tests fewer boxes than the flat loop
        assert float(tests[live].float().mean()) < 0.5 * n
    assert np.array_equal(_ref_words(lo, hi, o_np, d_np, t.numpy()),
                          flat.numpy())


def test_entry_distance_bound_is_inclusive():
    """A bound exactly at a box's entry distance passes (te <= tx), in the
    tree as in the flat test; one ulp below it does not."""
    lo = np.array([[1.0, -1.0, -1.0], [5.0, -1.0, -1.0]], np.float32)
    hi = np.array([[2.0, 1.0, 1.0], [6.0, 1.0, 1.0]], np.float32)
    o = _vec(np.zeros((2, 3), np.float32))
    d = _vec(np.array([[1.0, 0.0, 0.0]] * 2, np.float32))
    inv = traverse.safe_inv(d)
    te = (torch.tensor(1.0) - o.x[0]) * inv.x[0]
    t = torch.stack([te, torch.nextafter(te, torch.tensor(0.0))])
    tree = torch.from_numpy(tlas.build_tlas(lo, hi))
    cand, _ = tlas.tlas_candidates(tree, 2, o, inv, t)
    assert cand.tolist() == [[True, False], [False, False]]
    assert torch.equal(cand, _flat(lo, hi, o, inv, t))


def _tie_world(ref: bool):
    """A static floor far below, then two identical cubes (same transform),
    both dynamic: instances 0 and 1, mesh ids 1 and 2."""
    cls = RefMesh if ref else Mesh
    meshes = [cls.plane_xz(-20.0, 4.0)]
    for _ in range(2):
        c = cls.cube()
        c.transform.set_position(0.3, 0.2, 4.0)
        c.transform.set_rotation(0.2, 0.5, 0.1)
        c.is_dynamic = True
        meshes.append(c)
    if ref:
        return ref_sg.assemble_world(meshes)
    return scene_geom.assemble_world(meshes, None, CPU)


def test_identical_instances_lower_id_wins():
    rng = np.random.default_rng(17)
    n = 64
    o_np = np.zeros((n, 3), np.float32)
    d_np = (np.array([0.3, 0.2, 4.0], np.float32)
            + rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32))
    d_np /= np.linalg.norm(d_np, axis=1, keepdims=True)
    d_np = d_np.astype(np.float32)
    port = _tie_world(False)
    t0 = torch.full((n,), traverse.T_MAX)
    rec = traverse.closest_hit(port, _vec(o_np), _vec(d_np), t0)
    hit = rec.slot >= 0
    assert float(hit.float().mean()) > 0.5
    assert bool((rec.inst[hit] == 0).all()) and bool((rec.mesh[hit] == 1)
                                                     .all())
    # the kernel's order through the tree: the candidate words hold both
    # instances, and the lower one is visited first
    iset = port.iset
    cand, _ = tlas.tlas_candidates(iset.tlas, 2, _vec(o_np),
                                   traverse.safe_inv(_vec(d_np)), t0)
    assert bool(cand[hit].all())
    ref = _tie_world(True)
    rv = lambda a: RefVec3(*[jnp.asarray(a[:, k]) for k in range(3)])
    want = jax.jit(lambda oo, dd: ref_traverse.intersect_closest(ref, oo, dd))(
        rv(o_np), rv(d_np))
    assert np.array_equal(np.asarray(want.mesh_index), rec.mesh.numpy())
    np.testing.assert_allclose(np.asarray(want.t)[hit.numpy()],
                               rec.t[hit].numpy(), rtol=1e-5)


def test_sets_carry_their_tree():
    """``merge_instances``, a transform update and ``from_reference`` each
    carry the tree of their own boxes, on the device of their tables."""
    world = _tie_world(False)
    meshes = [Mesh.cube() for _ in range(11)]
    rng = np.random.default_rng(3)
    insts = []
    for i, m in enumerate(meshes):
        m.transform.set_position(*rng.uniform(-4, 4, 3))
        insts.append(scene_geom.assemble_instance(m, i, None, CPU))
    iset = scene_geom.merge_instances(tuple(insts))
    tree = lambda s: tlas.build_tlas(s.bb_min.numpy(), s.bb_max.numpy())
    assert np.array_equal(iset.tlas.numpy(), tree(iset))
    assert iset.tlas.shape == (tlas.tlas_node_count(11), tlas.TLAS_WIDTH,
                               tlas.TLAS_ROW)
    meshes[4].transform.set_position(9.0, 9.0, 9.0)
    insts[4] = scene_geom.update_instance_transform(insts[4], meshes[4])
    moved = scene_geom.update_instance_set_transforms(iset, tuple(insts))
    assert np.array_equal(moved.tlas.numpy(), tree(moved))
    assert not np.array_equal(moved.tlas.numpy(), iset.tlas.numpy())
    src = ref_np(_tie_world(True))
    got = tables.from_reference(device=CPU, geometry=src)["geometry"]
    assert np.array_equal(got.iset.tlas.numpy(), tree(world.iset))
    bad = dataclasses_replace(got.iset, tlas=got.iset.tlas[:, :2].contiguous())
    o = _vec(np.zeros((4, 3), np.float32))
    d = _vec(np.tile(np.float32([0.0, 0.0, 1.0]), (4, 1)))
    rec = traverse.closest_hit(got.static, o, d, torch.full((4,), 1e30))
    with pytest.raises(ValueError, match="tlas"):
        traverse.instances_closest(bad, o, d, rec)


def dataclasses_replace(obj, **kw):
    import dataclasses

    return dataclasses.replace(obj, **kw)
