"""The rest of the PT ``Scene`` API against the JAX reference, on the CPU:
OBJ meshes (``load_obj``, ``Mesh(path)``, ``Mesh()``, ``add_mesh(path)``
on both scenes), the debug-geometry generators, ``render_wireframe``
(within 1 LSB), ``trace_single_ray`` (hit, mesh and front face equal; t and
normal within 1e-5), ``warmup`` (the next frame bit-identical to an
unwarmed scene's), the render-state checkpoint (the next frame
bit-identical after a round trip, in the reference's ``.npz`` keys) and
``PerformanceSettings.fast_bvh_updates``.

The scenes stay below 192 triangles, so the reference intersects them by
brute force and its jitted wireframe and ray programs compile in seconds.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptrt_tpu.geometry.mesh import Mesh as RefMesh
from ptrt_tpu.geometry.mesh import load_obj as ref_load_obj
from ptrt_tpu.render.denoiser import init_denoiser_state as ref_init_den
from ptrt_tpu.scene.camera import Camera as RefCamera
from ptrt_tpu.scene.materials import Material as RefMaterial
from ptrt_tpu.scene.pt_scene import PerformanceSettings as RefPerf
from ptrt_tpu.scene.pt_scene import Scene as RefScene
from ptrt_tpu.scene.pt_scene import _accum_init as ref_accum_init
from ptrt_tpu.scene.rt_scene import RTScene as RefRTScene
from ptrt_tpu.utils import checkpoint as ref_ckpt
from ptrt_tpu.utils import visualization as ref_vis

from ptrt_tpu_torch.geometry.mesh import Mesh, load_obj
from ptrt_tpu_torch.scene.camera import Camera
from ptrt_tpu_torch.scene.materials import Material
from ptrt_tpu_torch.scene.pt_scene import PerformanceSettings, Scene
from ptrt_tpu_torch.scene.rt_scene import RTScene
from ptrt_tpu_torch.utils import checkpoint, visualization
from test_torch_shading import torch_one_thread  # noqa: F401

OBJS = {
    # quads and a pentagon (fan triangulation), comments, blank lines
    "quads": "# a box\n\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
             "v 1 0 1\nv 1 1 1\nv 0 1 1\nf 1 2 3 4\nf 5 6 7 8\n"
             "f 1 2 6 5\nf 1 4 8 7 5\n",
    # negative (relative) indices
    "negative": "v 0 0 0\nv 2 0 0\nv 0 2 0\nf -3 -2 -1\nv 0 0 3\n"
                "f -4 -2 -1\n",
    # v/vt/vn suffixes, texture and normal records ignored
    "attributes": "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 0\n"
                  "vn 0 0 1\nf 1/1/1 2/2/1 3//1\nf 1//1 3/1 4\n",
    # lines that do not parse are skipped
    "bad lines": "v 0 0 0\nv 1 0 0\nv x 1 0\nv 0 1 0\nv 1 1\nf 1 2 3\n"
                 "f 1 2 q\nf a/b 2\no name\ng group\nusemtl m\n",
}


def _write(tmp_path, name, text):
    path = tmp_path / f"{name.replace(' ', '_')}.obj"
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("name", sorted(OBJS))
def test_load_obj_and_mesh_from_path(tmp_path, name):
    path = _write(tmp_path, name, OBJS[name])
    for recenter in (True, False):
        v, f = load_obj(path, recenter)
        rv, rf = ref_load_obj(path, recenter)
        assert v.dtype == rv.dtype and f.dtype == rf.dtype
        assert np.array_equal(v, rv) and np.array_equal(f, rf)
    m, rm = Mesh(path), RefMesh(path)
    assert np.array_equal(m.vertices, rm.vertices)
    assert np.array_equal(m.faces, rm.faces)


def test_load_obj_without_geometry_raises(tmp_path):
    for text in ("", "# nothing\n", "v 0 0 0\nv 1 0 0\n", "f 1 2 3\n"):
        path = _write(tmp_path, "empty", text)
        with pytest.raises(ValueError, match="no valid geometry"):
            load_obj(path)
        with pytest.raises(ValueError):
            Mesh(path)


def test_default_mesh_is_the_unit_cube():
    m, rm = Mesh(), RefMesh()
    assert np.array_equal(m.vertices, rm.vertices)
    assert np.array_equal(m.faces, rm.faces)
    assert np.array_equal(Mesh.cube().faces, rm.faces)
    # the port's own constructor form keeps working
    v = np.zeros((3, 3), np.float32)
    assert Mesh(v, [[0, 1, 2]]).num_triangles == 1
    with pytest.raises(TypeError):
        Mesh(v)


def test_add_mesh_from_path_on_both_scenes(tmp_path):
    path = _write(tmp_path, "quads", OBJS["quads"])
    for port, ref in ((Scene(16, 12, device="cpu"), RefScene(16, 12)),
                      (RTScene(16, 12, device="cpu"), RefRTScene(16, 12))):
        m = port.add_mesh(path, Material.make((0.5, 0.5, 0.5)))
        rm = ref.add_mesh(path, RefMaterial.make((0.5, 0.5, 0.5)))
        assert isinstance(m, Mesh) and m is port.meshes[-1]
        assert np.array_equal(m.vertices, rm.vertices)
        assert np.array_equal(m.faces, rm.faces)


def _cameras():
    args = ((0.5, 1.0, -2.0), (0.0, 0.2, 4.0), (0, 1, 0), 55.0, 1.5)
    return Camera.make(*args, device="cpu"), RefCamera.make(*args)


@pytest.mark.parametrize("gen", ["cylinder", "cone", "arrow", "line",
                                 "frustum", "image plane", "debug ray"])
def test_visualization_generators(gen):
    cam, ref_cam = _cameras()
    calls = {
        "cylinder": lambda v, c: v.generate_cylinder(0.3, 2.0, 12),
        "cone": lambda v, c: v.generate_cone(0.4, 1.0, 6),
        "arrow": lambda v, c: np.concatenate([
            v.generate_arrow((0.1, 0.2, 0.3), (0.3, 0.5, -1.0), 2.0, 0.03,
                             lod) for lod in (0, 1, 2, 7)]
            + [v.generate_arrow((0, 0, 0), (0, 1, 0), 1.0)]),
        "line": lambda v, c: np.concatenate([
            v.generate_line((0, 0, 0), (1, 2, 3), 0.02),
            v.generate_line((1, 1, 1), (1, 3, 1))]),
        "frustum": lambda v, c: v.generate_frustum_wireframe(
            c, 1.5, 4.0, 0.02, **({"fov": 55.0} if v is visualization
                                  else {})),
        "image plane": lambda v, c: np.concatenate([
            v.generate_image_plane(2.0, 1.0, 3.0),
            v.generate_image_plane(1.6, 0.9, 2.5, c)]),
        "debug ray": lambda v, c: v.debug_ray_mesh(
            (0.0, 1.0, 0.0), (1.0, -0.5, 2.0), 3.0, 0.02).triangle_arrays(),
    }
    got, want = calls[gen](visualization, cam), calls[gen](ref_vis, ref_cam)
    for g, w in zip(np.broadcast_arrays(got), np.broadcast_arrays(want)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_frustum_reads_the_fov_back_from_the_projection():
    cam, ref_cam = _cameras()
    got = visualization.generate_frustum_wireframe(cam, 1.5)
    want = ref_vis.generate_frustum_wireframe(ref_cam, 1.5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _small_scene(cls, mat, **kw):
    """A floor, a sphere, a cube and an emissive cube: 98 triangles."""
    sc = cls(40, 30, **kw)
    sc.add_plane_xz(-1.0, 8.0, mat.make((0.8, 0.8, 0.8), 0.6))
    sc.add_sphere(6, mat.make((0.7, 0.2, 0.2), 0.4)).transform \
        .set_position(0.0, -0.4, 4.0)
    sc.add_cube(mat.make((0.2, 0.3, 0.8), 0.3)).transform \
        .set_position(1.2, -0.5, 5.0)
    lamp = sc.add_cube(mat.make((1.0, 1.0, 1.0), 0.0).replace(
        emission=(4.0, 3.0, 2.0)))
    lamp.transform.set_position(-1.3, 0.2, 5.5).set_scale(0.6)
    sc.add_point_light((2, 3, 1), (1, 1, 1), 3.0)
    sc.set_camera((0, 0.5, 0), (0, 0, 4), fov=60)
    return sc


def test_render_wireframe():
    sc = _small_scene(Scene, Material, device="cpu")
    ref = _small_scene(RefScene, RefMaterial)
    for thickness in (0.05, 0.12):
        got = sc.render_wireframe(thickness)
        want = ref.render_wireframe(thickness)
        assert got.shape == want.shape == (30, 40, 3)
        diff = np.abs(got.astype(int) - want.astype(int))
        assert diff.max() <= 1, diff.max()
        assert len(np.unique(got.reshape(-1, 3), axis=0)) > 3


def test_trace_single_ray():
    sc = _small_scene(Scene, Material, device="cpu")
    ref = _small_scene(RefScene, RefMaterial)
    # no ray passes through a vertex, where the triangles around it tie
    # (the camera's axis meets the sphere's pole)
    rays = [((0, 0.5, 0), (0.03, -0.1, 1)), ((0, 0.5, 0), (0.2, -0.2, 1)),
            ((0, 0.5, 0), (-0.3, -0.05, 1)), ((0, 0.5, 0), (0, 1, 0.2)),
            ((3, 2, 5), (-1, -0.8, 0.1)), ((0, -5, 4), (0, 1, 0))]
    hits = 0
    for o, d in rays:
        got, want = sc.trace_single_ray(o, d), ref.trace_single_ray(o, d)
        assert bool(got.hit) == bool(want.hit)
        assert int(got.mesh_index) == int(want.mesh_index)
        if not got.hit:
            continue
        hits += 1
        assert bool(got.front_face) == bool(want.front_face)
        np.testing.assert_allclose(float(got.t), float(want.t), rtol=1e-5,
                                   atol=1e-5)
        for c in "xyz":
            np.testing.assert_allclose(float(getattr(got.normal, c)),
                                       float(getattr(want.normal, c)),
                                       atol=1e-5)
    assert hits >= 4


def _pt_scene(denoise: bool):
    sc = _small_scene(Scene, Material, device="cpu")
    sc.perf.enable_denoiser = denoise
    sc.perf.enable_bloom = denoise
    sc.perf.samples_per_pixel = 1
    sc.perf.max_bounce_depth = 2
    sc.perf.progressive_accumulation = not denoise
    return sc


@pytest.mark.parametrize("block", [True, False])
def test_warmup_keeps_the_next_frame(block):
    cold = _pt_scene(denoise=True)
    warm = _pt_scene(denoise=True)
    t = warm.warmup(block=block)
    if not block:
        assert t is not None
        t.join()
    else:
        assert t is None
    assert warm.frame_count == 0 and warm._rng_state is None
    assert warm._denoiser_state is None and warm.last_frame is None
    for _ in range(2):
        assert np.array_equal(warm.render_frame(), cold.render_frame())


@pytest.mark.parametrize("denoise", [True, False])
def test_checkpoint_round_trip(tmp_path, denoise):
    path = str(tmp_path / "state.npz")
    a = _pt_scene(denoise)
    for _ in range(3):
        a.render_frame()
    checkpoint.save_render_state(a, path)
    nxt_a = a.render_frame()
    b = _pt_scene(denoise)
    b._ensure_device_state()
    checkpoint.load_render_state(b, path)
    assert np.array_equal(b.render_frame(), nxt_a)
    # the reference's layout: its keys, shapes and dtypes for the same state
    rh, rw = a.render_size
    like = types.SimpleNamespace(
        frame_count=3, prev_view_proj=jnp.zeros((4, 4)),
        _rng_state=jnp.zeros((rh, rw), jnp.uint32),
        _denoiser_state=ref_init_den(rh, rw) if denoise else None,
        _accum_state=None if denoise else ref_accum_init(rh, rw),
        _accum_cam_sig=None if denoise else np.zeros((4, 4), np.float32))
    want = ref_ckpt._flatten_state(like)
    got = dict(np.load(path))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].shape == np.shape(v), k
        if k not in ("frame_count", "den_count", "acc_count"):
            assert got[k].dtype == np.asarray(v).dtype, k


def test_fast_bvh_updates_setting():
    assert PerformanceSettings().fast_bvh_updates is True
    assert RefPerf().fast_bvh_updates is True
    assert {f.name for f in dataclasses.fields(RefPerf)} <= {
        f.name for f in dataclasses.fields(PerformanceSettings)}


def test_rt_scene_from_obj_renders(tmp_path):
    """``RTScene.add_mesh(path)`` into a frame: the loaded box is hit."""
    path = _write(tmp_path, "quads", OBJS["quads"])
    sc = RTScene(24, 16, device="cpu")
    m = sc.add_mesh(path, Material.make((0.9, 0.2, 0.2), 0.3))
    m.move_to(0.0, 0.0, -3.0)
    sc.add_point_light((2, 3, 1), (1, 1, 1), 3.0)
    sc.render_frame()
    assert bool((sc.last_frame.k1.mesh == 0).any())
