"""K1/K2 plain versions against the JAX reference's BVH walks.

On the CPU the port's ``closest_hit`` / ``any_hit`` run their plain
versions (chunked brute force).  They are held to the reference's own BVH
walks (``intersect_closest`` / ``intersect_any``) over a few-thousand-
triangle scene, on random rays and camera rays with some dead lanes
(``t_max = -1``).  Bounds: hit flag and mesh index exactly equal and t to
rtol=1e-4 on hits — the bound the reference holds its own BVH walk to
against brute force (tests/test_geometry.py) — and the any-hit flag exactly
equal.  u, v are not compared: at pre-split seams coplanar triangles tie
and either walk may pick either.

The CUDA walks rely on the node rows' per-octant child orders (columns
52:60) and are measured by counting walks whose plain version is the walk
itself, one ray at a time: both are checked here, with the live-lane entry
``closest_hit_live``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ptrt_tpu.app.bench_scene import build_bench_scene as ref_bench_scene
from ptrt_tpu.core.vec import Vec3 as RefVec3
from ptrt_tpu.render import traverse as ref_traverse

from ptrt_tpu_torch import tables
from ptrt_tpu_torch.app.bench_scene import build_bench_scene
from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.render import traverse
from ptrt_tpu_torch.tools.walks import wavefronts
from test_torch_shading import torch_one_thread  # noqa: F401

CPU = torch.device("cpu")


def ref_np(obj):
    if isinstance(obj, RefVec3):
        return tuple(np.asarray(c) for c in (obj.x, obj.y, obj.z))
    if dataclasses.is_dataclass(obj):
        return {f.name: ref_np(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, (int, tuple)):
        return obj
    return np.asarray(obj)


@pytest.fixture(scope="module")
def scene():
    sc = ref_bench_scene(64, 48, target_tris=2000)
    sc._ensure_device_state()
    port = tables.from_reference(device=CPU, geometry=ref_np(sc._geom))
    return sc, port["geometry"]


def _random_rays(n, seed):
    r = np.random.default_rng(seed)
    o = (r.uniform(-5, 5, (n, 3)) + [0, 0.5, 6]).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _camera_rays(sc):
    s, t = np.meshgrid((np.arange(64) + 0.5) / 64, (np.arange(48) + 0.5) / 48)
    cam = sc.camera
    ray = cam.get_ray_simple(jnp.asarray(s, jnp.float32),
                             jnp.asarray(t, jnp.float32))
    o = np.stack([np.broadcast_to(np.asarray(c), s.shape).ravel()
                  for c in (ray.origin.x, ray.origin.y, ray.origin.z)], 1)
    d = np.stack([np.asarray(c).ravel()
                  for c in (ray.direction.x, ray.direction.y,
                            ray.direction.z)], 1)
    return o.astype(np.float32), d.astype(np.float32)


def _rays(sc, kind):
    o, d = _random_rays(3072, 11) if kind == "random" else _camera_rays(sc)
    n = o.shape[0]
    t_max = np.full(n, 1e30, np.float32)
    t_max[::7] = -1.0  # dead lanes
    return o, d, t_max


def _ref_vec(a):
    return RefVec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]),
                   jnp.asarray(a[:, 2]))


def _vec(a):
    return Vec3(*[torch.from_numpy(np.ascontiguousarray(a[:, k]))
                  for k in range(3)])


@pytest.mark.parametrize("kind", ["random", "camera"])
def test_closest_hit_plain_matches_reference_walk(scene, kind):
    sc, geom = scene
    o, d, t_max = _rays(sc, kind)
    ref = jax.jit(lambda g, oo, dd, tt: ref_traverse.intersect_closest(
        g, oo, dd, tt))(sc._geom, _ref_vec(o), _ref_vec(d),
                        jnp.asarray(t_max))
    t, u, v, slot, mesh = traverse.closest_hit(geom, _vec(o), _vec(d),
                                               torch.from_numpy(t_max))
    hit = slot.numpy() >= 0
    ref_hit = np.asarray(ref.hit)
    assert np.array_equal(hit, ref_hit)
    assert hit.mean() > 0.2
    assert not hit[::7].any()  # dead lanes miss
    assert np.array_equal(mesh.numpy(), np.asarray(ref.mesh_index))
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=1e-4)
    # misses keep their t_max, as the reference's state does
    assert np.array_equal(t.numpy()[~hit], t_max[~hit])


@pytest.mark.parametrize("kind", ["random", "camera"])
def test_intersect_closest_hit_record(scene, kind):
    """The Hit contract: point, face-forwarded normal, front_face."""
    sc, geom = scene
    o, d, t_max = _rays(sc, kind)
    ref = jax.jit(lambda g, oo, dd, tt: ref_traverse.intersect_closest(
        g, oo, dd, tt))(sc._geom, _ref_vec(o), _ref_vec(d),
                        jnp.asarray(t_max))
    h = traverse.intersect_closest(geom, _vec(o), _vec(d),
                                   torch.from_numpy(t_max))
    m = np.asarray(ref.hit)
    assert np.array_equal(h.hit.numpy(), m)
    assert np.array_equal(h.front_face.numpy()[m], np.asarray(ref.front_face)[m])
    for a, b in ((h.normal, ref.normal), (h.point, ref.point)):
        for ca, cb in zip((a.x, a.y, a.z), (b.x, b.y, b.z)):
            np.testing.assert_allclose(ca.numpy()[m], np.asarray(cb)[m],
                                       rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["random", "camera"])
def test_any_hit_plain_matches_reference_walk(scene, kind):
    sc, geom = scene
    o, d, _ = _rays(sc, kind)
    r = np.random.default_rng(12)
    t_max = r.uniform(0.5, 12.0, o.shape[0]).astype(np.float32)
    t_max[::7] = -1.0
    ref = jax.jit(lambda g, oo, dd, tt: ref_traverse.intersect_any(
        g, oo, dd, tt))(sc._geom, _ref_vec(o), _ref_vec(d),
                        jnp.asarray(t_max))
    got = traverse.any_hit(geom, _vec(o), _vec(d), torch.from_numpy(t_max))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert 0.05 < got.numpy().mean() < 0.95
    assert not got.numpy()[::7].any()


def test_any_hit_skips_transmissive_occluders(scene):
    """Rays from below straight up through the glass sphere (transmission
    0.98) are not shadowed by it; opaque spheres do shadow."""
    sc, geom = scene
    opq = geom.tri_shadow_opaque.numpy()
    mid = geom.tri_mesh_id.numpy()
    assert not opq[mid == 2].any() and opq[mid == 0].all()
    # column under sphere 0 (Gold, opaque) and sphere 2 (Glass)
    xs = {0: (0 - 1.5) * 2.2, 2: (2 - 1.5) * 2.2}
    o = np.array([[xs[0], -0.99, 4.0], [xs[2], -0.99, 4.0]], np.float32)
    d = np.array([[0, 1, 0], [0, 1, 0]], np.float32)
    got = traverse.any_hit(geom, _vec(o), _vec(d),
                           torch.tensor([5.0, 5.0]))
    assert got.tolist() == [True, False]


@pytest.mark.parametrize("kind", ["random", "camera"])
def test_closest_hit_live_matches_t_max_plane(scene, kind):
    """The alive-plane entry answers as closest_hit does with the plane
    torch.where(alive, 1e30, -1), and so as the reference's walk."""
    sc, geom = scene
    o, d, t_max = _rays(sc, kind)
    alive = torch.from_numpy(t_max > 0)
    got = traverse.closest_hit_live(geom, _vec(o), _vec(d), alive)
    want = traverse.closest_hit(geom, _vec(o), _vec(d),
                                torch.where(alive, 1e30, -1.0))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    ref = jax.jit(lambda g, oo, dd, tt: ref_traverse.intersect_closest(
        g, oo, dd, tt))(sc._geom, _ref_vec(o), _ref_vec(d),
                        jnp.asarray(t_max))
    hit = got.slot.numpy() >= 0
    assert np.array_equal(hit, np.asarray(ref.hit)) and hit.mean() > 0.2
    assert np.array_equal(got.mesh.numpy(), np.asarray(ref.mesh_index))
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=1e-4)
    assert (got.t.numpy()[~alive.numpy()] == -1.0).all()


@pytest.mark.parametrize("n", [0, 37])
def test_any_hit_returns_bool(scene, n):
    _, geom = scene
    o, d = _random_rays(n, 5)
    got = traverse.any_hit(geom, _vec(o), _vec(d),
                           torch.full((n,), 8.0, dtype=torch.float32))
    assert got.dtype == torch.bool and got.shape == (n,)


def _popcount(m):
    return np.array([bin(int(x)).count("1") for x in m])


@pytest.mark.parametrize("target_tris", [2000, 60_000])
def test_node_order_words_are_permutations(target_tris):
    """For every node row and octant, column 52 + o decodes by value to a
    permutation of 0..7 whose first leaf_count + int_count entries are the
    used slots — what K1's near-first descent relies on."""
    sc = build_bench_scene(32, 24, target_tris=target_tris, device="cpu")
    sc._ensure_device_state()
    rows = sc._geom.node_rows.numpy()
    meta = rows[:, 48:60].astype(np.int64)
    assert np.array_equal(meta, rows[:, 48:60])  # exact small ints
    lmask, imask = meta[:, 2], meta[:, 3]
    used = _popcount(lmask) + _popcount(imask)
    # the layout contract: leaves in slots [0, lc), internals after them
    assert np.array_equal(lmask, (1 << _popcount(lmask)) - 1)
    assert np.array_equal(lmask | imask, (1 << used) - 1)
    assert (lmask & imask == 0).all() and (used >= 1).all()
    for o in range(8):
        word = meta[:, 4 + o]
        assert ((word >= 0) & (word < 1 << 24)).all()
        slots = (word[:, None] >> (3 * np.arange(8))[None, :]) & 7
        assert (np.sort(slots, axis=1) == np.arange(8)).all()
        first = np.arange(8)[None, :] < used[:, None]
        assert (np.where(first, slots, -1).max(1) == used - 1).all()
        rest = np.where(first, 8, slots).min(1)
        assert (rest[used < 8] == used[used < 8]).all()


@pytest.mark.parametrize("kind", ["random", "camera"])
@pytest.mark.parametrize("walk", traverse.WALKS)
def test_walk_counts_plain_matches_brute_force(scene, kind, walk):
    """The counting walk's plain version (the kernel's walk, one ray at a
    time) finds the brute force's hits, in either child order."""
    sc, geom = scene
    o, d, t_max = _rays(sc, kind)
    t = torch.from_numpy(t_max)
    if walk == "any":
        t = torch.from_numpy(np.where(
            t_max > 0, np.random.default_rng(3).uniform(0.5, 12.0, t.shape),
            -1.0).astype(np.float32))
    got = traverse.walk_counts(geom, _vec(o), _vec(d), t, walk)
    live = int((t > 0).sum())
    assert live <= got.nodes and got.tris > 0
    if walk == "any":
        want = traverse.any_hit(geom, _vec(o), _vec(d), t)
        assert got.answer.dtype == torch.bool
        assert torch.equal(got.answer, want)
        return
    want = traverse.closest_hit(geom, _vec(o), _vec(d), t)
    assert torch.equal(got.answer.slot >= 0, want.slot >= 0)
    assert torch.equal(got.answer.mesh, want.mesh)
    hit = want.slot >= 0
    np.testing.assert_allclose(got.answer.t[hit].numpy(),
                               want.t[hit].numpy(), rtol=1e-4)
    assert torch.equal(got.answer.t[~hit], want.t[~hit])


def test_near_first_visits_fewer_nodes():
    """On camera rays of a 60k-triangle bench scene, near-first descent
    visits fewer nodes and tests fewer triangles than slot order, and
    finds the same hits."""
    sc = build_bench_scene(40, 30, target_tris=60_000, device="cpu")
    _, o, d, t = wavefronts(sc)[0]
    near = traverse.walk_counts(sc._geom, o, d, t, "closest")
    slot = traverse.walk_counts(sc._geom, o, d, t, "closest_slot_order")
    assert near.nodes < slot.nodes and near.tris < slot.tris
    assert torch.equal(near.answer.mesh, slot.answer.mesh)
    np.testing.assert_allclose(near.answer.t.numpy(), slot.answer.t.numpy(),
                               rtol=1e-6)
