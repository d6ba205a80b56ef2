"""Dynamic geometry: ptrt_tpu_torch's two-level world against the JAX
reference.

* ``assemble_world`` of a floor and 64 dynamic cubes (the reference's
  ``tests/test_geometry.py`` batched-instance scene): the static tables,
  the merged set's tables, roots, matrix rows and world boxes bit for bit.
* ``intersect_closest`` / ``intersect_any`` on that world (K1 / K2 then K4;
  on the CPU their plain versions) against the reference's jitted walks:
  hit and mesh ids equal, t to rtol 1e-5, normals to atol 1e-5, any-hit
  flags equal; and against the same transforms baked into a static world
  (hit, mesh and any-hit flags equal, t to the reference's own rtol 1e-3).
* The ``Scene`` counters of the reference's incremental-update tests
  (``test_incremental_build_counters``, ``test_scene_refill_uses_device_
  refit``, ``test_scene_refill_uses_device_lbvh``) through ``Scene(...,
  device="cpu")``, and a refill followed by a re-merge (a second dynamic
  mesh added): the traced answers equal a fresh build's.
* One 48x32 frame of a scene with moving instances and a refilled surface
  through the reference's ``Scene`` and the port's, the same PCG state:
  object ids equal, the image within 1 LSB on at least 99% of pixels.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ptrt_tpu.core.vec import Vec3 as RefVec3
from ptrt_tpu.geometry import scene_geom as ref_sg
from ptrt_tpu.geometry.mesh import Mesh as RefMesh
from ptrt_tpu.geometry.transform import Transform3D as RefTransform3D
from ptrt_tpu.render import traverse as ref_traverse
from ptrt_tpu.scene.materials import Material as RefMaterial
from ptrt_tpu.scene.materials import Materials as RefMaterials
from ptrt_tpu.scene import pt_scene as ref_pt_scene
from ptrt_tpu.scene.pt_scene import Scene as RefScene

from ptrt_tpu_torch import tables
from ptrt_tpu_torch.app.bench_scene import heightfield_to_triangles
from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.geometry import scene_geom
from ptrt_tpu_torch.geometry.mesh import Mesh
from ptrt_tpu_torch.geometry.transform import Transform3D
from ptrt_tpu_torch.render import traverse
from ptrt_tpu_torch.scene.materials import Material, Materials
from ptrt_tpu_torch.scene.pt_scene import Scene
from test_torch_shading import torch_one_thread  # noqa: F401
from test_torch_tables import ref_np

CPU = torch.device("cpu")


def _world(ref: bool, dynamic: bool):
    """A floor and 64 cubes at seeded transforms (the reference's
    ``test_many_instances_match_baked``), dynamic or baked."""
    mesh, tr = (RefMesh, RefTransform3D) if ref else (Mesh, Transform3D)
    meshes = [mesh.plane_xz(-1.0, 12.0)]
    rng = np.random.default_rng(7)
    for _ in range(64):
        c = mesh.cube()
        c.transform = tr(position=tuple(rng.uniform(-6, 6, 3) + [0, 0, 6]),
                         rotation=tuple(rng.uniform(0, 3, 3)),
                         scale=(0.5, 0.5, 0.5))
        c.is_dynamic = dynamic
        meshes.append(c)
    if ref:
        return ref_sg.assemble_world(meshes)
    return scene_geom.assemble_world(meshes, None, CPU)


@pytest.fixture(scope="module")
def worlds():
    return {"ref": _world(True, True), "port": _world(False, True),
            "baked": _world(False, False)}


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _same_geom(r: dict, p: dict):
    for k in ("node_rows", "tri_rows", "v0", "e1", "e2", "tri_mesh_id",
              "tri_shadow_opaque", "stack_depth"):
        if isinstance(r[k], tuple):
            for a, b in zip(r[k], p[k]):
                _same(a, b)
        elif isinstance(r[k], int):
            assert r[k] == p[k], k
        else:
            _same(r[k], p[k])


def test_assemble_world_tables_match_reference(worlds):
    r, p = ref_np(worlds["ref"]), tables.to_numpy(worlds["port"])
    _same_geom(r["static"], p["static"])
    assert worlds["port"].iset.count == 64
    ri, pi = ref_np(worlds["ref"].iset), tables.to_numpy(worlds["port"].iset)
    _same_geom(ri["geom"], pi["geom"])
    for k in ("roots", "mats", "bb_min", "bb_max"):
        _same(ri[k], pi[k])
    # hidden slots (scale 1e-6) hold ~1e6 in their inverse rows: the same
    # float64 inverse rounded once
    hidden = Mesh.cube()
    hidden.transform.set_position(2.0, -100.0, 4.0).set_scale(1e-6)
    rh = RefMesh.cube()
    rh.transform.set_position(2.0, -100.0, 4.0).set_scale(1e-6)
    for a, b in zip(ref_sg.instance_transform_rows(rh),
                    scene_geom.instance_transform_rows(hidden)):
        _same(a, b)
    assert np.abs(scene_geom.instance_transform_rows(hidden)[0]).max() > 1e5


def _rays(seed: int, n: int = 512):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * 0.3 + [0, 1, -2]).astype(np.float32)
    d = (rng.normal(size=(n, 3)) + [0, -0.2, 2]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _vec(a):
    return Vec3(*[torch.from_numpy(np.ascontiguousarray(a[:, k]))
                  for k in range(3)])


def _ref_vec(a):
    return RefVec3(*[jnp.asarray(a[:, k]) for k in range(3)])


@pytest.fixture(scope="module")
def ref_answers(worlds):
    o, d = _rays(3)
    tm = np.full(o.shape[0], 12.0, np.float32)
    g = worlds["ref"]
    hit = jax.jit(lambda oo, dd: ref_traverse.intersect_closest(g, oo, dd))(
        _ref_vec(o), _ref_vec(d))
    occl = jax.jit(lambda oo, dd, t: ref_traverse.intersect_any(
        g, oo, dd, t))(_ref_vec(o), _ref_vec(d), jnp.asarray(tm))
    return o, d, tm, hit, np.asarray(occl)


def test_world_closest_matches_reference(worlds, ref_answers):
    o, d, _, ref, _ = ref_answers
    got = traverse.intersect_closest(worlds["port"], _vec(o), _vec(d))
    hit = got.hit.numpy()
    assert np.array_equal(hit, np.asarray(ref.hit))
    assert np.array_equal(got.mesh_index.numpy(), np.asarray(ref.mesh_index))
    # the instances are hit, and not only they
    mesh = got.mesh_index.numpy()
    assert (mesh[hit] > 0).mean() > 0.1 and (mesh[hit] == 0).any()
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=1e-5)
    for c in "xyz":
        np.testing.assert_allclose(getattr(got.normal, c).numpy()[hit],
                                   np.asarray(getattr(ref.normal, c))[hit],
                                   atol=1e-5)
    assert np.array_equal(got.front_face.numpy()[hit],
                          np.asarray(ref.front_face)[hit])


def test_world_any_matches_reference(worlds, ref_answers):
    o, d, tm, _, ref_occl = ref_answers
    got = traverse.intersect_any(worlds["port"], _vec(o), _vec(d),
                                 torch.from_numpy(tm))
    assert np.array_equal(got.numpy(), ref_occl)
    assert 0.05 < ref_occl.mean() < 0.95


def test_world_matches_baked_world(worlds):
    o, d = _rays(5)
    hw = traverse.intersect_closest(worlds["port"], _vec(o), _vec(d))
    hs = traverse.intersect_closest(worlds["baked"], _vec(o), _vec(d))
    assert torch.equal(hw.hit, hs.hit)
    assert torch.equal(hw.mesh_index, hs.mesh_index)
    m = hs.hit
    torch.testing.assert_close(hw.t[m], hs.t[m], rtol=1e-3, atol=1e-4)
    tm = torch.full((o.shape[0],), 12.0)
    assert torch.equal(traverse.intersect_any(worlds["port"], _vec(o),
                                              _vec(d), tm),
                       traverse.intersect_any(worlds["baked"], _vec(o),
                                              _vec(d), tm))


def test_instance_record_and_dead_lanes(worlds):
    """K4's record: ``inst`` names the instance of each instance hit (its
    mesh id less the floor's one), -1 elsewhere; a lane with t_max <= 0
    stays a miss, and nothing else moves for it."""
    o, d = _rays(9, 256)
    t = torch.full((256,), traverse.T_MAX)
    t[::5] = -1.0
    rec = traverse.closest_hit(worlds["port"], _vec(o), _vec(d), t)
    inst = rec.inst
    assert inst is not None and inst.dtype == torch.int32
    is_i = inst >= 0
    assert is_i.any() and (rec.slot[~is_i] >= 0).any()
    assert torch.equal(rec.mesh[is_i], inst[is_i] + 1)
    dead = t < 0
    assert (rec.slot[dead] == -1).all() and (inst[dead] == -1).all()
    assert (rec.t[dead] == -1.0).all()
    flat = traverse.closest_hit(worlds["port"].static, _vec(o), _vec(d), t)
    assert flat.inst is None


# -- the Scene's incremental updates -------------------------------------------


def test_incremental_build_counters():
    """Transform edits rebuild no BVH; a vertex refill of another triangle
    count rebuilds only that mesh's (the reference's
    ``test_incremental_build_counters``)."""
    sc = Scene(32, 32, device="cpu")
    sc.add_plane_xz(-1.0, 5.0)
    cube = sc.add_cube()
    cube.is_dynamic = True
    seen = []

    def step():
        sc._ensure_device_state()
        seen.append((sc.stats_world_builds, sc.stats_blas_builds,
                     sc.stats_tlas_updates))

    step()
    cube.transform.set_position(2.0, 0.5, 0.0)
    sc.commit_object_changes()
    step()
    cube.set_triangles(np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]]],
                                np.float32))
    sc.commit_object_changes()
    step()
    sc.meshes[0].transform.set_position(0.0, -2.0, 0.0)
    sc.commit_object_changes()
    step()
    sc.commit_object_changes()
    step()
    assert seen == [(1, 1, 0), (1, 1, 1), (1, 2, 1), (2, 2, 1), (2, 2, 1)]


def _trace(sc, o, d):
    return traverse.intersect_closest(sc._geom, _vec(o), _vec(d))


def _probe(seed, n=8, origin=(0.3, 0.2, -3.0)):
    rng = np.random.default_rng(seed)
    o = np.array([origin] * n, np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[:, 2] = np.abs(dirs[:, 2]) + 1.0
    return o, dirs / np.linalg.norm(dirs, axis=1, keepdims=True)


def _fresh(tris, lbvh=False, plane_y=-1.0, half=5.0):
    sc = Scene(32, 32, device="cpu")
    sc.add_plane_xz(plane_y, half)
    m = sc.add_mesh(Mesh.from_triangles(tris))
    m.is_dynamic = True
    sc._ensure_device_state()
    return sc


def test_scene_refill_uses_device_refit():
    """A fixed-topology refill refits on the device (no host build) and
    traces like a fresh build; a topology change rebuilds."""
    sc = Scene(32, 32, device="cpu")
    sc.add_plane_xz(-1.0, 5.0)
    tris0 = np.asarray([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                        [[0, 0, 1], [1, 0, 1], [0, 1, 1]]], np.float32)
    surf = sc.add_mesh(Mesh.from_triangles(tris0))
    surf.is_dynamic = True
    sc._ensure_device_state()
    assert (sc.stats_blas_builds, sc.stats_device_refits) == (1, 0)
    tris1 = tris0 + np.float32(0.25)
    surf.set_triangles(tris1)
    sc.commit_object_changes()
    sc._ensure_device_state()
    assert (sc.stats_blas_builds, sc.stats_device_refits) == (1, 1)
    o, d = _probe(1)
    h1, h2 = _trace(sc, o, d), _trace(_fresh(tris1), o, d)
    assert torch.equal(h1.hit, h2.hit) and h1.hit.any()
    torch.testing.assert_close(h1.t[h1.hit], h2.t[h1.hit], rtol=1e-5,
                               atol=0.0)
    surf.set_triangles(np.concatenate([tris1, tris1 + 1.0]))
    sc.commit_object_changes()
    sc._ensure_device_state()
    assert (sc.stats_blas_builds, sc.stats_device_refits) == (2, 1)


def _soup(rng, n, span=1.5, size=0.15):
    c = rng.uniform(-span, span, (n, 3)).astype(np.float32)
    b = c + rng.uniform(-size, size, (n, 3)).astype(np.float32)
    d = c + rng.uniform(-size, size, (n, 3)).astype(np.float32)
    return np.stack([c, b, d], axis=1)


def test_scene_refill_uses_device_lbvh():
    """A device_lbvh mesh's re-shapes are Morton-sorted device builds, no
    host build, and trace like a fresh build of the last shape."""
    rng = np.random.default_rng(7)
    sc = Scene(32, 32, device="cpu")
    sc.add_plane_xz(-3.0, 8.0)
    surf = sc.add_mesh(Mesh.from_triangles(_soup(rng, 64)))
    surf.is_dynamic = True
    surf.device_lbvh = True
    sc._ensure_device_state()
    assert sc.stats_blas_builds == 1
    for _ in range(3):
        tris = _soup(rng, 64)
        surf.set_triangles(tris)
        sc.commit_object_changes()
        sc._ensure_device_state()
    assert (sc.stats_blas_builds, sc.stats_device_lbvh_builds,
            sc.stats_device_refits) == (1, 3, 3)
    o, d = _probe(2, 64, (0.1, 0.2, -6.0))
    fresh = _fresh(tris, plane_y=-3.0, half=8.0)
    h1, h2 = _trace(sc, o, d), _trace(fresh, o, d)
    assert torch.equal(h1.hit, h2.hit) and h1.hit.any()
    torch.testing.assert_close(h1.t[h1.hit], h2.t[h1.hit], rtol=1e-5,
                               atol=0.0)


def test_refill_then_remerge_keeps_the_refill():
    """A refit lives in the merged set only; adding a second dynamic mesh
    merges the set again from each instance's current tables, so the
    refilled surface (and a Morton-refilled one) trace as fresh builds."""
    rng = np.random.default_rng(3)
    sc = Scene(32, 32, device="cpu")
    sc.add_plane_xz(-3.0, 8.0)
    surf = sc.add_mesh(Mesh.from_triangles(_soup(rng, 48)))
    surf.is_dynamic = True
    blob = sc.add_mesh(Mesh.from_triangles(_soup(rng, 40)))
    blob.is_dynamic = blob.device_lbvh = True
    sc._ensure_device_state()
    tris_s, tris_b = _soup(rng, 48), _soup(rng, 40)
    surf.set_triangles(tris_s)
    blob.set_triangles(tris_b)
    sc.commit_object_changes()
    sc._ensure_device_state()
    assert (sc.stats_blas_builds, sc.stats_device_refits) == (2, 2)
    extra = sc.add_cube()
    extra.is_dynamic = True
    extra.transform.set_position(0.0, 0.0, 2.5)
    sc._ensure_device_state()
    assert (sc.stats_blas_builds, sc.stats_device_refits) == (3, 2)

    fresh = Scene(32, 32, device="cpu")
    fresh.add_plane_xz(-3.0, 8.0)
    for tris in (tris_s, tris_b):
        fresh.add_mesh(Mesh.from_triangles(tris)).is_dynamic = True
    m = fresh.add_cube()
    m.is_dynamic = True
    m.transform.set_position(0.0, 0.0, 2.5)
    fresh._ensure_device_state()
    o, d = _probe(4, 96, (0.1, 0.2, -6.0))
    h1, h2 = _trace(sc, o, d), _trace(fresh, o, d)
    assert torch.equal(h1.hit, h2.hit)
    assert torch.equal(h1.mesh_index, h2.mesh_index)
    assert set(h1.mesh_index[h1.hit].tolist()) >= {1, 2, 3}
    torch.testing.assert_close(h1.t[h1.hit], h2.t[h1.hit], rtol=1e-5,
                               atol=0.0)
    # the refilled meshes' own tables were brought up to date at the merge
    assert not any(e["stale"] for e in sc._instance_cache.values())


def test_material_edit_marks_only_materials():
    """``set_material`` marks the materials dirty, not the geometry, as the
    reference does: the shadow-opaque bit baked into the static world
    follows only at its next rebuild (here: the floor moved)."""
    sc = Scene(16, 16, device="cpu")
    sc.add_plane_xz(-1.0, 5.0)
    cube = sc.add_cube()
    sc._ensure_device_state()
    opaque = sc._geom.tri_shadow_opaque.clone()
    sc.set_material(cube, Materials.Glass())
    assert sc._mat_dirty and not sc._geom_dirty
    sc._ensure_device_state()
    assert sc.stats_world_builds == 1
    assert torch.equal(sc._geom.tri_shadow_opaque, opaque)
    sc.commit_object_changes()
    sc._ensure_device_state()
    assert torch.equal(sc._geom.tri_shadow_opaque, opaque)
    sc.meshes[0].transform.set_position(0.0, -0.5, 0.0)
    sc.commit_object_changes()
    sc._ensure_device_state()
    assert sc.stats_world_builds == 2
    assert int(sc._geom.tri_shadow_opaque.sum()) == 2  # the floor's only


# -- a frame ------------------------------------------------------------------

W, H = 48, 32


def _frame_scene(ref: bool):
    """A floor, a static sphere, two dynamic cubes and a dynamic 6x6
    heightfield (148 triangles: the reference intersects by brute force);
    returns the scene and its (cube, cube, surface)."""
    sc = RefScene(W, H) if ref else Scene(W, H, device="cpu")
    mat, mats = (RefMaterial, RefMaterials) if ref else (Material, Materials)
    sc.add_plane_xz(-1.0, 10.0, mat.make((0.8, 0.8, 0.8), 0.7))
    sc.add_sphere(6, mats.Chrome()).transform.set_position(-1.0, -0.4, 4.5)
    cubes = []
    for k, m in enumerate((mats.PlasticRed(), mats.Gold())):
        c = sc.add_cube(m)
        c.is_dynamic = True
        c.transform.set_position(0.4 + 0.9 * k, -0.5, 3.8 + 0.6 * k)
        cubes.append(c)
    surf = sc.add_triangles(_surface(0), mats.PlasticBlue())
    surf.is_dynamic = True
    surf.transform.set_position(-0.4, -0.9, 3.0)
    sc.add_point_light((1.5, 3.0, 2.0), (1.0, 0.95, 0.9), 6.0, radius=0.2)
    sc.set_camera((0.0, 0.8, 0.0), (0.0, -0.3, 4.5), fov=60)
    sc.perf.enable_denoiser = sc.perf.enable_bloom = False
    sc.perf.enable_motion_vectors = False
    sc.perf.samples_per_pixel, sc.perf.max_bounce_depth = 1, 3
    return sc, (*cubes, surf)


def _surface(frame: int) -> np.ndarray:
    xs = np.linspace(-1.0, 1.0, 6)
    h = 0.15 * np.sin(3.0 * xs[None, :] + 2.0 * xs[:, None] + 0.7 * frame)
    return heightfield_to_triangles(h.astype(np.float32), 2.0)


def _animate(parts, frame: int) -> None:
    a, b, surf = parts
    a.transform.set_position(0.4 + 0.1 * frame, -0.5, 3.8)
    a.transform.set_rotation(0.0, 0.3 * frame, 0.0)
    b.transform.set_scale(1.0, 1.0 + 0.2 * frame, 1.0)
    surf.set_triangles(_surface(frame))


def _ref_object_ids(sc, rng_state, frame_idx):
    """The reference's bounce-0 object ids of a frame: its trace program
    (the frame program keeps its G-buffer inside)."""
    rh, rw = sc.render_size
    fn = ref_pt_scene._trace_only(rw, rh, sc.perf.samples_per_pixel,
                                  sc.perf.max_bounce_depth, len(sc.lights),
                                  sc._use_brute(), False)
    _, bufs = fn(sc._geom, sc._mat_table, sc._light_table, sc._sky(),
                 sc.camera, rng_state, jnp.int32(frame_idx), sc._blue_noise)
    return np.asarray(bufs.object_id)


def test_dynamic_frame_matches_reference():
    images, scenes = {}, {}
    for ref in (True, False):
        sc, parts = _frame_scene(ref)
        sc.render_frame()
        _animate(parts, 1)
        sc.commit_object_changes()
        if ref:
            sc._ensure_device_state()
            before = (sc._rng_state, sc.frame_count)
        images[ref] = sc.render_frame()
        scenes[ref] = sc
    ref_sc, port = scenes[True], scenes[False]
    assert ref_sc._use_brute()
    assert (port.stats_blas_builds, port.stats_tlas_updates,
            port.stats_device_refits) == (3, 2, 1)
    assert np.array_equal(np.asarray(ref_sc._rng_state),
                          port._rng_state.numpy())
    ids = port.last_frame.object_id.numpy()
    assert np.isin(ids, [2, 3, 4]).mean() > 0.1  # the dynamic meshes
    assert np.array_equal(ids, _ref_object_ids(ref_sc, *before))
    lsb = (np.abs(images[True].astype(int) - images[False].astype(int))
           .max(-1) <= 1).mean()
    assert lsb >= 0.99, lsb
    assert images[False].std() > 1.0
