"""ptrt_tpu_torch host tables against the JAX reference.

Both packages build the same scene through their own host code (numpy
copies + the same native BVH builder source and flags), so the packed
tables must be byte-identical; ``tables.from_reference`` must carry the
reference's state across unchanged and round-trip through ``to_numpy``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ptrt_tpu.app.bench_scene import build_bench_scene as ref_bench_scene
from ptrt_tpu.core.vec import Vec3 as RefVec3
from ptrt_tpu.scene.materials import Material as RefMaterial
from ptrt_tpu.scene.materials import Materials as RefMaterials
from ptrt_tpu.scene.pt_scene import Scene as RefScene

from ptrt_tpu_torch import tables
from ptrt_tpu_torch.app.bench_scene import build_bench_scene
from ptrt_tpu_torch.core.bluenoise import blue_noise_table
from ptrt_tpu_torch.scene.materials import Material, Materials
from ptrt_tpu_torch.scene.pt_scene import Scene
from test_torch_shading import torch_one_thread  # noqa: F401

CPU = torch.device("cpu")


def ref_np(obj):
    """Flatten a reference object to numpy: dataclasses as field dicts,
    Vec3 as an (x, y, z) triple."""
    if isinstance(obj, RefVec3):
        return tuple(np.asarray(c) for c in (obj.x, obj.y, obj.z))
    if dataclasses.is_dataclass(obj):
        return {f.name: ref_np(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if obj is None or isinstance(obj, (int, tuple)):
        return obj
    return np.asarray(obj)


def _small_scenes(ref: bool):
    sc = RefScene(48, 32) if ref else Scene(48, 32, device="cpu")
    mat, mats = ((RefMaterial, RefMaterials) if ref
                 else (Material, Materials))
    sc.add_plane_xz(-1.0, 10.0, mat.make((0.8, 0.8, 0.8), 0.7))
    sc.add_sphere(12, mats.Glass()).transform.set_position(0, -0.5, 4)
    cube = sc.add_cube(mats.Gold())
    cube.transform.set_position(1.5, 0.2, 5).set_rotation(0.3, 0.7, 0.0)
    sc.add_point_light((2, 4, 2), (1, 1, 1), 3.0, radius=0.2)
    sc.add_spot_light((0, 5, 4), (0, -1, 0), (1, 0.9, 0.8), 4.0,
                      inner_cone=0.3, outer_cone=0.6)
    sc.set_sky_gradient((0.4, 0.5, 0.7), (0.1, 0.1, 0.1))
    sc.set_camera((0, 0.5, 0), (0, 0, 4), fov=55)
    return sc


SCENES = {
    "primitives": _small_scenes,
    "bench_2k": lambda ref: (ref_bench_scene(64, 48, target_tris=2000) if ref
                             else build_bench_scene(64, 48, target_tris=2000,
                                                    device="cpu")),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def pair(request):
    ref = SCENES[request.param](True)
    ref._ensure_device_state()
    port = SCENES[request.param](False)
    port._ensure_device_state()
    return ref, port


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("field", ["node_rows", "tri_rows", "v0", "e1", "e2",
                                   "tri_mesh_id", "tri_shadow_opaque",
                                   "stack_depth"])
def test_geometry_tables_byte_identical(pair, field):
    ref, port = pair
    a = ref_np(ref._geom)[field]
    b = tables.to_numpy(port._geom)[field]
    if isinstance(a, tuple):
        for ca, cb in zip(a, b):
            _same(ca, cb)
    elif isinstance(a, int):
        assert a == b
    else:
        _same(a, b)


def test_material_light_sky_tables_byte_identical(pair):
    ref, port = pair
    _same(ref._mat_table.packed, port._mat_table.packed.numpy())
    _same(ref._light_table.packed, port._light_table.packed.numpy())
    rs, ps = ref_np(ref._sky()), tables.to_numpy(port.sky())
    for key in ("top", "bottom"):
        for ca, cb in zip(rs[key], ps[key]):
            _same(ca, cb)
    _same(rs["use_sky"], ps["use_sky"])


def test_camera_matches(pair):
    ref, port = pair
    rc, pc = ref_np(ref.camera), tables.to_numpy(port.camera)
    for key in ("origin", "lower_left_corner", "horizontal", "vertical", "u",
                "v", "w"):
        np.testing.assert_allclose(np.stack(pc[key]), np.stack(rc[key]),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pc["lens_radius"], rc["lens_radius"],
                               rtol=1e-6)


def test_rng_state_and_blue_noise_identical(pair):
    ref, port = pair
    _same(np.asarray(ref._rng_state),
          port._rng_state.numpy().astype(np.uint32))
    assert int(port._rng_state.max()) < 2 ** 32
    _same(np.asarray(ref._blue_noise), blue_noise_table(CPU).numpy())


def test_from_reference_round_trip(pair):
    ref, _ = pair
    state = dict(geometry=ref_np(ref._geom), materials=ref_np(ref._mat_table),
                 lights=ref_np(ref._light_table), sky=ref_np(ref._sky()),
                 camera=ref_np(ref.camera),
                 rng_state=np.asarray(ref._rng_state),
                 blue_noise=np.asarray(ref._blue_noise))
    port = tables.from_reference(device=CPU, **state)
    back = {k: tables.to_numpy(v) for k, v in port.items()}
    for key, src in state["geometry"].items():
        if key.startswith("_"):
            continue
        got = back["geometry"][key]
        if isinstance(src, tuple):
            for ca, cb in zip(src, got):
                _same(ca, cb)
        elif isinstance(src, int):
            assert src == got
        else:
            _same(src, got)
    _same(state["materials"]["packed"], back["materials"]["packed"])
    _same(state["lights"]["packed"], back["lights"]["packed"])
    for key in ("top", "bottom"):
        for ca, cb in zip(state["sky"][key], back["sky"][key]):
            _same(ca, cb)
    for key in ("origin", "lower_left_corner", "horizontal", "vertical", "u",
                "v", "w"):
        for ca, cb in zip(state["camera"][key], back["camera"][key]):
            _same(ca, cb)
    _same(state["rng_state"], back["rng_state"].astype(np.uint32))
    _same(state["blue_noise"], back["blue_noise"])


def test_from_reference_rejects_hdri():
    """An HDRI sky is carried across now (the name is from when it was
    refused): the map, its rotation, the alias rows, the pdf and (SH, SW),
    byte for byte, and back through ``to_numpy``."""
    from ptrt_tpu.render.sky import SkyConfig as RefSky

    env = np.random.default_rng(4).uniform(0, 3, (4, 8, 3)).astype(
        np.float32)
    ref = ref_np(RefSky.hdri(env, 0.5))
    sky = tables.from_reference(device=CPU, sky=ref)["sky"]
    assert sky.has_env_sampling and sky.env_sample_hw == (4, 8)
    back = tables.to_numpy(sky)
    for key in ("env", "env_alias", "env_pdf", "env_rotation", "use_sky"):
        _same(ref[key], back[key])
    assert back["env_sample_hw"] == ref["env_sample_hw"]


def test_camera_view_projection_matches(pair):
    """The port's own view, projection and inverse view-projection (motion
    vectors reproject through them) against the reference's, and carried
    across unchanged by ``from_reference``."""
    ref, port = pair
    rc, pc = ref_np(ref.camera), tables.to_numpy(port.camera)
    for key in ("view", "proj", "inv_view_proj"):
        np.testing.assert_allclose(pc[key], rc[key], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.camera.get_view_proj().numpy(),
                               np.asarray(ref.camera.get_view_proj()),
                               rtol=1e-5, atol=1e-6)
    back = tables.to_numpy(tables.from_reference(device=CPU,
                                                 camera=rc)["camera"])
    for key in ("view", "proj", "inv_view_proj"):
        _same(rc[key], back[key])


def test_from_reference_denoiser_state():
    from ptrt_tpu.render import denoiser as ref_den

    g = np.random.default_rng(9)
    h, w = 6, 10
    z = ref_den.init_denoiser_state(h, w)
    rnd3 = lambda: RefVec3(*[g.normal(size=(h, w)).astype(np.float32)
                             for _ in range(3)])
    hist = lambda: ref_den.ChannelHistory(
        mean=rnd3(), m2=rnd3(),
        length=g.integers(1, 30, (h, w)).astype(np.float32))
    ref_state = dataclasses.replace(
        z, diffuse=hist(), specular=hist(), normal=rnd3(),
        object_id=g.integers(-1, 9, (h, w)).astype(np.int32),
        first_frame=np.asarray(False))
    src = ref_np(ref_state)
    port = tables.from_reference(device=CPU,
                                 denoiser_state=src)["denoiser_state"]
    assert isinstance(port.diffuse.length, torch.Tensor)
    assert port.depth.dtype == torch.float32
    assert port.object_id.dtype == torch.int32
    assert not bool(port.first_frame)
    back = tables.to_numpy(port)
    for ch in ("diffuse", "specular"):
        for key in ("mean", "m2"):
            for ca, cb in zip(src[ch][key], back[ch][key]):
                _same(ca, cb)
        _same(src[ch]["length"], back[ch]["length"])
    for ca, cb in zip(src["normal"], back["normal"]):
        _same(ca, cb)
    for key in ("depth", "object_id", "first_frame"):
        _same(src[key], back[key])


def test_world_geometry_and_refit_plan_round_trip():
    """A two-level world (the static world's tables and the instance set's
    tables, roots, matrix rows and boxes) and a refit plan placed at
    offsets cross unchanged; the carried world traces as the port's own."""
    from ptrt_tpu.geometry import refit as ref_refit
    from ptrt_tpu.geometry import scene_geom as ref_sg
    from ptrt_tpu.geometry.mesh import Mesh as RefMesh

    from ptrt_tpu_torch.core.vec import Vec3
    from ptrt_tpu_torch.geometry.scene_geom import WorldGeometry
    from ptrt_tpu_torch.render import traverse

    meshes = [RefMesh.plane_xz(-1.0, 6.0), RefMesh.cube(),
              RefMesh.sphere(6)]
    for k, m in enumerate(meshes[1:]):
        m.is_dynamic = True
        m.transform.set_position(0.5 * k, -0.3, 3.0 + k).set_rotation(
            0.2, 0.4 * k, 0.0)
    world = ref_sg.assemble_world(meshes)
    src = ref_np(world)
    got = tables.from_reference(device=CPU, geometry=src)["geometry"]
    assert isinstance(got, WorldGeometry) and got.iset.count == 2
    back = tables.to_numpy(got)
    for part, a, b in (("static", src["static"], back["static"]),
                       ("iset", src["iset"]["geom"], back["iset"]["geom"])):
        for key in ("node_rows", "tri_rows", "v0", "e1", "e2", "tri_mesh_id",
                    "tri_shadow_opaque"):
            if isinstance(a[key], tuple):
                for ca, cb in zip(a[key], b[key]):
                    _same(ca, cb)
            else:
                _same(a[key], b[key])
        assert a["stack_depth"] == b["stack_depth"], part
    for key in ("roots", "mats", "bb_min", "bb_max"):
        _same(src["iset"][key], back["iset"][key])
    rng = np.random.default_rng(1)
    o = Vec3(*[torch.from_numpy(rng.normal(size=64).astype(np.float32) * 0.3)
               for _ in range(3)])
    d = Vec3(torch.full((64,), 0.05), torch.full((64,), -0.25),
             torch.ones(64)).normalized()
    hit = traverse.intersect_closest(got, o, d)
    assert set(hit.mesh_index.tolist()) >= {0, 1}  # floor and instance

    plan = ref_refit.build_refit_plan(world.instances[1].geom, node_off=3,
                                      blk_off=4, slot_off=32)
    carried = tables.from_reference(device=CPU,
                                    refit_plan=ref_np(plan))["refit_plan"]
    back = tables.to_numpy(carried)
    for f in dataclasses.fields(plan):
        a, b = getattr(plan, f.name), back[f.name]
        if f.name == "levels":
            assert len(a) == len(b)
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            assert np.array_equal(a, b), f.name
