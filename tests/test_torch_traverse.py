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
from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.render import traverse
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
