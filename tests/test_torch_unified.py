"""The unified scene layer: ptrt_tpu_torch against the JAX reference.

The port's counterpart of ``tests/test_scene_layers.py`` (``TestAnimation``,
``TestUnifiedBuild``): the same ``UnifiedScene`` description, made by each
package's ``scene/unified.py``, built by each package's builders into a PT
``Scene`` and an ``RTScene``, gives byte-identical scene tables (geometry,
the instance set of the dynamic meshes, materials, lights, the sky with an
HDRI's sampling tables; the camera within rtol 1e-6): every mesh kind (an
OBJ file, a cube, an XZ plane, a sphere, a triangle soup), every light kind
(point, directional, spot, area), a gradient and an HDRI sky, a library
material and a preset.  After handle edits (a dynamic mesh moved, a static
one re-baked, a soup re-filled, a material and a light changed, an object
spawned) and ``update_pt_scene`` / ``update_rt_scene`` the tables are still
equal.  Easing curves and keyframe tracks give equal values.  A 32x24 frame
of each backend, on a static description of 130 triangles (the reference
intersects by brute force), is held at ``test_torch_slice.py``'s bound for
the PT image (within 1 LSB on 99% of pixels) and ``test_torch_rt.py``'s
for the RT frame (the same).
"""

import numpy as np
import pytest
import torch

import jax
from ptrt_tpu.scene import materials as ref_materials
from ptrt_tpu.scene import unified as ref_unified

from ptrt_tpu_torch import tables
from ptrt_tpu_torch.scene import materials, unified
from ptrt_tpu_torch.utils.hdr import save_hdr
from test_torch_shading import torch_one_thread  # noqa: F401
from test_torch_slice import ref_np

FRAME_AGREE = 0.99  # share of pixels within 1 LSB (test_torch_rt.py's)
PKG = {"ref": (ref_unified, ref_materials), "port": (unified, materials)}
OBJ = """v -0.5 0 -0.5
v 0.5 0 -0.5
v 0.5 0 0.5
v -0.5 0 0.5
v 0 0.8 0
f 1 2 5
f 2 3 5
f 3 4 5
f 4 1 5
f 1 3 2
f 1 4 3
"""


def _soup(shift=0.0):
    r = np.random.default_rng(3)
    return (r.uniform(-1, 1, (4, 3, 3)) + [1.5 + shift, 0.3, 5.0]).astype(
        np.float32)


def describe(side: str, paths: dict, w=32, h=24, dynamic=True, hdri=False):
    """The test's UnifiedScene through package ``side``'s layer."""
    u, m = PKG[side]
    s = u.UnifiedScene(w, h)
    s.set_camera((0.0, 1.2, -1.0), (0.0, 0.2, 5.0), (0, 1, 0), 55.0)
    s.add_library_material("floor", m.Material.make((0.6, 0.6, 0.55), 0.8))
    s.add_plane_xz(-0.5, 8.0).use_library_material("floor").set_name("floor")
    s.add_cube(m.Materials.PlasticRed()).set_position((-1.2, 0.0, 4.5)) \
        .set_rotation_degrees((0, 30, 10)).set_scale((0.8, 1.0, 0.6)) \
        .set_name("cube")
    s.add_sphere(6, m.Materials.Glass()).set_position((0.4, 0.1, 5.5)) \
        .set_scale(1.2).set_name("ball")
    s.add_mesh_from_obj(paths["obj"], m.Materials.Gold()) \
        .set_position((1.0, -0.5, 3.5)).set_name("pyramid")
    s.add_triangles(_soup(), m.Materials.Chrome()).set_name("soup")
    if dynamic:
        s.add_cube(m.Materials.Copper()).set_dynamic(True) \
            .set_position((-0.3, 1.0, 6.0)).set_scale(0.5).set_name("mover")
    s.add_point_light((1.5, 2.5, 3.0), (1.0, 0.9, 0.8), 6.0, 30.0, 0.2)
    s.add_directional_light((-0.3, -1.0, 0.4), (0.9, 0.95, 1.0), 1.2)
    s.add_spot_light((-2.0, 3.0, 2.0), (0.4, -1.0, 0.5), (1, 1, 1), 8.0)
    s.add_area_light((0.0, 2.8, 5.0), (0.0, -1.0, 0.1), (1.0, 1.0, 0.9), 1.0,
                     0.6, 4.0).set_name("panel")
    if hdri:
        s.set_hdri(paths["hdr"], 1.5, 0.7)
    else:
        s.set_sky_gradient((0.5, 0.6, 0.9), (0.9, 0.9, 1.0))
    s.set_ambient_light((0.05, 0.04, 0.03))
    s.set_path_tracer_params(1, 2)
    return s


def edit(side: str, s) -> None:
    """Handle edits after the build: every kind of dirty mark."""
    u, m = PKG[side]
    s.find_object("mover").set_position((0.3, 1.2, 6.2)).rotate_degrees(
        (0, 20, 0))
    s.find_object("cube").translate((0.2, 0.1, 0.0))
    s.find_object("soup").set_triangles(_soup(0.4))
    s.find_object("ball").set_material(m.Materials.Diamond())
    s.find_light("panel").set_intensity(2.5).set_color((0.8, 0.9, 1.0))
    s.instantiate_object(u.UnifiedMeshDesc.Cube(m.Materials.Jade()),
                         "spawned").set_position((2.0, 0.0, 7.0))


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("unified")
    obj = d / "pyramid.obj"
    obj.write_text(OBJ)
    r = np.random.default_rng(11)
    env = (r.random((16, 32, 3)) * 2.0).astype(np.float32)
    env[4, 20] = 300.0  # a sun texel
    hdr = d / "sky.hdr"
    save_hdr(str(hdr), env)
    return {"obj": str(obj), "hdr": str(hdr)}


def _same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def _same_tree(r, p, what=""):
    if isinstance(r, dict):
        for k in r:
            if k.startswith("_") or k not in p:
                continue
            _same_tree(r[k], p[k], f"{what}.{k}")
    elif isinstance(r, tuple):
        assert len(r) == len(p), what
        for j, (a, b) in enumerate(zip(r, p)):
            _same_tree(a, b, f"{what}[{j}]")
    elif r is None or isinstance(r, (int, float, bool)):
        assert r == p, what
    else:
        _same(r, p, what)


GEOM_KEYS = ("node_rows", "tri_rows", "v0", "e1", "e2", "tri_mesh_id",
             "tri_shadow_opaque", "stack_depth")


def _same_geom(r: dict, p: dict):
    if "static" in r:  # a world: the static part and the instance set
        assert "static" in p
        _same_geom(r["static"], p["static"])
        ri, pi = r["iset"], p["iset"]
        _same_geom(ri["geom"], pi["geom"])
        for k in ("roots", "mats", "bb_min", "bb_max"):
            _same_tree(ri[k], pi[k], k)
        return
    for k in GEOM_KEYS:
        _same_tree(r[k], p[k], k)


def _same_camera(r, p):
    rc, pc = ref_np(r), tables.to_numpy(p)
    for key in ("origin", "lower_left_corner", "horizontal", "vertical", "u",
                "v", "w"):
        np.testing.assert_allclose(np.stack(pc[key]), np.stack(rc[key]),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pc["lens_radius"], rc["lens_radius"],
                               rtol=1e-6)
    np.testing.assert_allclose(pc["fov"], rc["fov"], rtol=0)


def same_pt(ref, port):
    ref._ensure_device_state()
    port._ensure_device_state()
    assert len(ref.meshes) == len(port.meshes)
    _same_geom(ref_np(ref._geom), tables.to_numpy(port._geom))
    _same(ref._mat_table.packed, port._mat_table.packed.numpy(), "mats")
    _same(ref._light_table.packed, port._light_table.packed.numpy(), "lts")
    rs, ps = ref_np(ref._sky()), tables.to_numpy(port.sky())
    for key in ("top", "bottom", "use_sky"):
        _same_tree(rs[key], ps[key], key)
    assert (rs.get("env") is None) == (ps.get("env") is None)
    if rs.get("env") is not None:  # the HDRI and its sampling tables
        env_keys = [k for k in rs if k.startswith("env")]
        assert len(env_keys) >= 4, env_keys
        for key in env_keys:
            _same_tree(rs[key], ps[key], key)
    _same_camera(ref.camera, port.camera)
    assert (ref.perf.samples_per_pixel, ref.perf.max_bounce_depth) == (
        port.perf.samples_per_pixel, port.perf.max_bounce_depth)


def same_rt(ref, port):
    ref._ensure()
    port._ensure()
    _same_geom(ref_np(ref._geom), tables.to_numpy(port._geom))
    _same(ref._mat_table.packed, port._mat_table.packed.numpy(), "mats")
    _same(ref._light_table.packed, port._light_table.packed.numpy(), "lts")
    _same_camera(ref.camera, port.camera)
    for key in ("ambient_light", "sky_color_top", "sky_color_bottom",
                "use_sky"):
        assert getattr(ref, key) == getattr(port, key), key
    assert ref._has_glass() == port._has_glass()


def build(kind: str, side: str, s):
    u = PKG[side][0]
    b = u.UnifiedSceneBuilder
    fn = getattr(b, f"build_{kind}_scene")
    return fn(s) if side == "ref" else fn(s, device="cpu")


@pytest.mark.parametrize("hdri", [False, True])
def test_pt_tables_equal_and_after_edits(paths, hdri):
    descs = {k: describe(k, paths, hdri=hdri) for k in PKG}
    scenes = {k: build("pt", k, d) for k, d in descs.items()}
    assert scenes["port"]._geom is None  # nothing built before a frame
    same_pt(scenes["ref"], scenes["port"])
    assert isinstance(scenes["port"].meshes[-1].is_dynamic, bool)
    assert scenes["port"].meshes[-1].is_dynamic
    for k, d in descs.items():
        edit(k, d)
        assert d.materials_dirty and d.lights_dirty and d.has_dirty_meshes()
        PKG[k][0].UnifiedSceneBuilder.update_pt_scene(scenes[k], d)
        assert not d.has_dirty_meshes() and not d.lights_dirty
    assert scenes["port"].frame_count == 0
    assert len(scenes["port"].meshes) == len(descs["port"].meshes)
    same_pt(scenes["ref"], scenes["port"])


def test_rt_tables_equal_and_after_edits(paths):
    descs = {k: describe(k, paths) for k in PKG}
    scenes = {k: build("rt", k, d) for k, d in descs.items()}
    same_rt(scenes["ref"], scenes["port"])
    for k, d in descs.items():
        edit(k, d)
        PKG[k][0].UnifiedSceneBuilder.update_rt_scene(scenes[k], d)
        d.camera.orbit((0.0, 0.0, 5.0), 6.0, 0.3, 0.2)
        PKG[k][0].UnifiedSceneBuilder.update_rt_camera(scenes[k], d)
    assert scenes["port"]._dirty
    same_rt(scenes["ref"], scenes["port"])


@pytest.mark.parametrize("preset", ["CornellBox", "GlassDemo",
                                    "DynamicObjectsDemo", "MetalDemo"])
def test_preset_tables_equal(preset):
    descs = {k: getattr(PKG[k][0].UnifiedScenePresets, preset)(40, 30)
             for k in PKG}
    assert descs["ref"].mesh_count == descs["port"].mesh_count
    same_pt(build("pt", "ref", descs["ref"]),
            build("pt", "port", descs["port"]))
    if preset == "GlassDemo":
        rt = build("rt", "port", descs["port"])
        assert rt._has_glass()
        same_rt(build("rt", "ref", descs["ref"]), rt)
    if preset == "DynamicObjectsDemo":
        for k, d in descs.items():
            d.update_animations(3.1)
            PKG[k][0].UnifiedSceneBuilder.update_pt_camera(
                build("pt", k, d), d)
        ref_t = descs["ref"].meshes[-1].transform
        port_t = descs["port"].meshes[-1].transform
        assert ref_t.position == port_t.position


def test_easing_and_keyframes_equal():
    ts = np.linspace(-0.25, 1.25, 61)
    for e_ref, e_port in zip(ref_unified.EaseType, unified.EaseType):
        assert e_ref.name == e_port.name
        for t in ts:
            assert ref_unified.apply_easing(float(t), e_ref) == \
                unified.apply_easing(float(t), e_port), (e_ref, t)
    anims = {}
    for k, (u, _) in PKG.items():
        a = u.TransformAnimation()
        (a.add_position_key(0.0, (0, 0, 0))
          .add_position_key(1.5, (4, 1, -2), u.EaseType.EaseInOut)
          .add_position_key(3.0, (1, 2, 3), u.EaseType.Bounce)
          .add_rotation_key(0.0, (0, 0, 0))
          .add_rotation_key(2.0, (0.5, 1.0, 0.0), u.EaseType.EaseOut)
          .add_scale_key(1.0, (1, 1, 1))
          .add_scale_key(2.5, (2, 0.5, 1), u.EaseType.Elastic)
          .set_looping(True))
        anims[k] = a
    for t in np.linspace(-1.0, 7.0, 97):
        r, p = anims["ref"].evaluate(float(t)), anims["port"].evaluate(
            float(t))
        assert (r.position, r.rotation, r.scale) == (
            p.position, p.rotation, p.scale), t
    u = unified.UnifiedScene(16, 16)
    u.add_cube().set_name("c")
    u.clear_dirty_flags()
    u.add_animation("c", anims["port"])
    u.update_animations(0.75)
    assert u.has_dirty_meshes()
    assert u.meshes[0].transform.position == anims["port"].evaluate(
        0.75).position


def _within(img, ref):
    diff = np.abs(img.astype(int) - ref.astype(int)).max(-1)
    return float((diff <= 1).mean())


def test_pt_frame_against_reference(paths):
    descs = {k: describe(k, paths, dynamic=False) for k in PKG}
    scenes = {k: build("pt", k, d) for k, d in descs.items()}
    for sc in scenes.values():
        sc.perf.enable_denoiser = False
        sc.perf.enable_bloom = False
        sc.perf.enable_motion_vectors = False
    scenes["ref"]._ensure_device_state()
    assert scenes["ref"]._use_brute()
    ref = scenes["ref"].render_frame()
    img = scenes["port"].render_frame()
    assert img.shape == ref.shape == (24, 32, 3) and img.dtype == np.uint8
    assert img.std() > 2.0
    assert _within(img, ref) >= FRAME_AGREE


def test_rt_frame_against_reference(paths):
    descs = {k: describe(k, paths, dynamic=False) for k in PKG}
    scenes = {k: build("rt", k, d) for k, d in descs.items()}
    assert scenes["ref"]._use_brute() and scenes["port"]._has_glass()
    with jax.disable_jit():  # brute force: a quick eager frame
        ref = scenes["ref"].render_frame()
    img = scenes["port"].render_frame()
    assert img.shape == ref.shape == (24, 32, 3)
    assert img.std() > 2.0
    assert _within(img, ref) >= FRAME_AGREE
