"""Multi-device pixel tiles (``ptrt_tpu_torch/parallel``) on eight CPU
devices, against the reference's ``ptrt_tpu/parallel/sharding.py`` (whose
eight virtual CPU devices ``tests/conftest.py`` provides).

Mirrors ``tests/test_pipeline.py``'s ``TestSharding`` and the half of
``TestMultichipCollectives`` that means something for the port (tiles equal
the whole frame, the trace runs tile by tile); the XLA all-gather counts
have no torch counterpart.

* ``make_pixel_mesh``'s (dy, dx) for 1-8 devices equal the reference's.
* ``shard_pixels`` then ``gather_pixels`` gives every plane back exactly;
  rank < 2 leaves and ``replicate`` copy nothing onto the device that holds
  them.
* A bench-scene frame in the "balanced" preset (split trace, motion
  vectors, SVGF, bloom, tonemap) with its trace over the 2x4 mesh equals
  the unmeshed frame bit for bit, twice in a row (the PCG state and the
  SVGF history carried), ``rays_traced`` equal.
* One meshed trace against the reference's ``shard_mapped_trace`` of
  ``trace_frame`` on the same tables and state, at ``test_torch_slice.py``'s
  bounds (the PCG state after the frame and object ids exact, depth and
  normal within rtol 1e-5, rays within 0.5%, energy within 1% a channel,
  at least 97% of pixels within 1e-3 relative).  The trace only: the
  reference's balanced post program takes minutes to compile on the CPU.
* ``dryrun_multichip(8, device="cpu")`` runs; a size that does not divide
  the mesh raises.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ptrt_tpu.parallel import sharding as ref_sharding
from ptrt_tpu.render import pipeline as ref_pipeline
from ptrt_tpu.scene.materials import Material as RefMaterial
from ptrt_tpu.scene.materials import Materials as RefMaterials
from ptrt_tpu.scene.pt_scene import Scene as RefScene

from ptrt_tpu_torch import tables
from ptrt_tpu_torch.app.bench_scene import build_bench_scene
from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.parallel import dryrun, sharding
from ptrt_tpu_torch.render import pipeline
from test_torch_shading import torch_one_thread  # noqa: F401
from test_torch_slice import ref_np

CPU8 = ["cpu"] * 8


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shapes_match_reference(n):
    mesh = sharding.make_pixel_mesh(n, devices=CPU8)
    assert mesh.shape == ref_sharding.make_pixel_mesh(n).devices.shape
    assert mesh.size == n and mesh.first_device == torch.device("cpu")
    assert all(s is None for row in mesh.streams for s in row)


def test_mesh_without_a_card_or_device_list_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device list"):
        sharding.make_pixel_mesh(4)


def test_shard_gather_round_trip():
    mesh = sharding.make_pixel_mesh(8, devices=CPU8)
    r = np.random.default_rng(0)
    plane = torch.from_numpy(r.random((16, 32)).astype(np.float32))
    rgb = torch.from_numpy(r.integers(0, 255, (16, 32, 3)).astype(np.uint8))
    scalar = torch.tensor(7, dtype=torch.int64)
    tree = {"v": Vec3(plane, plane * 2, plane + 1), "rgb": rgb,
            "n": scalar, "name": "kept"}
    sh = sharding.shard_pixels(mesh, tree)
    tile = sh["rgb"].parts[1][2]
    assert tuple(tile.shape) == (8, 8, 3)
    assert torch.equal(tile, rgb[8:16, 16:24])
    assert sh["n"].replicated and sh["n"].parts[1][3] is scalar
    back = sharding.gather_pixels(mesh, sh)
    assert torch.equal(back["rgb"], rgb) and back["name"] == "kept"
    for a, b in zip((back["v"].x, back["v"].y, back["v"].z),
                    (plane, plane * 2, plane + 1)):
        assert torch.equal(a, b)
    assert back["n"] is scalar
    rep = sharding.replicate(mesh, tree)
    assert rep["rgb"].replicated and rep["rgb"].parts[0][1] is rgb
    with pytest.raises(ValueError, match="divide"):
        sharding.shard_pixels(mesh, torch.zeros((15, 32)))


def _balanced(w, h):
    sc = build_bench_scene(w, h, target_tris=1_500, device="cpu")
    sc.set_performance_preset("balanced")
    return sc


def test_meshed_frame_equals_the_unmeshed_frame():
    """SVGF, bloom and the tonemap over a meshed trace: bit for bit the
    unmeshed frame, two frames with the camera moved between them."""
    mesh = sharding.make_pixel_mesh(8, devices=CPU8)
    plain, meshed = _balanced(48, 16), _balanced(48, 16)
    for k in range(2):
        for sc in (plain, meshed):
            sc.set_camera((0.3 * k, 1.2, -1.5), (0.0, 0.0, 6.0), fov=60)
        a = plain.render_frame()
        b = meshed.render_frame(mesh=mesh)
        assert np.array_equal(a, b), k
        assert torch.equal(plain._rng_state, meshed._rng_state)
        assert int(plain.last_frame.rays_traced) == int(
            meshed.last_frame.rays_traced)
        for name in ("diffuse", "specular", "depth", "object_id"):
            x, y = getattr(plain.last_frame, name), getattr(
                meshed.last_frame, name)
            for p, q in ((x.x, y.x), (x.z, y.z)) if isinstance(x, Vec3) \
                    else ((x, y),):
                assert torch.equal(p, q), name
        assert torch.equal(plain._denoiser_state.depth,
                           meshed._denoiser_state.depth)
    assert a.std() > 1.0


def test_a_mesh_on_another_device_is_refused():
    sc = _balanced(16, 8)
    mesh = sharding.make_pixel_mesh(2, devices=["meta", "cpu"])
    with pytest.raises(ValueError, match="first device"):
        sc.render_frame(mesh=mesh)


# -- against the reference's shard_mapped_trace ------------------------------

W, H = 48, 32


@pytest.fixture(scope="module")
def scene():
    """test_torch_tile.py's 136-triangle scene (the reference intersects
    by brute force) and the port's copy of its tables."""
    sc = RefScene(W, H)
    sc.add_plane_xz(-1.0, 10.0, RefMaterial.make((0.8, 0.8, 0.8), 0.7))
    sc.add_sphere(6, RefMaterials.Chrome()).transform.set_position(
        -0.9, -0.3, 4.0)
    sc.add_sphere(5, RefMaterials.PlasticRed()).transform.set_position(
        0.2, -0.5, 5.2)
    sc.add_cube(RefMaterials.Glass()).transform.set_position(1.0, -0.5, 3.8)
    sc.add_spot_light((-1.5, 3.0, 2.0), (0.4, -1.0, 0.6), (1, 1, 1), 6.0)
    sc.add_point_light((1.5, 2.0, 3.0), (0.9, 0.8, 1.0), 3.0, radius=0.2)
    sc.set_camera((0.0, 0.6, 0.0), (0.0, -0.2, 4.5), fov=60)
    sc._ensure_device_state()
    assert sc._use_brute()
    port = tables.from_reference(
        device="cpu", geometry=ref_np(sc._geom),
        materials=ref_np(sc._mat_table), lights=ref_np(sc._light_table),
        sky=ref_np(sc._sky()), camera=ref_np(sc.camera),
        rng_state=np.asarray(sc._rng_state),
        blue_noise=np.asarray(sc._blue_noise))
    return sc, port


def _v(v):
    return np.stack([np.asarray(c) for c in (v.x, v.y, v.z)])


def test_meshed_trace_matches_the_reference(scene):
    sc, port = scene
    n_lights = len(sc.lights)
    ref_mesh = ref_sharding.make_pixel_mesh(8)
    dy, dx = ref_mesh.devices.shape

    def ref_tile(rng_state, bn, geom, mats, lights, sky, camera, frame_idx,
                 tile):
        return ref_pipeline.trace_frame(
            geom, mats, lights, n_lights, sky, camera, rng_state, frame_idx,
            W // dx, H // dy, 1, 2, split=False, use_brute=True,
            blue_noise_tbl=bn, tile=tile)

    ref_fn = jax.jit(ref_sharding.shard_mapped_trace(ref_mesh, H, W,
                                                     ref_tile))
    ref_state, ref = ref_fn(ref_sharding.shard_pixels(ref_mesh,
                                                      sc._rng_state),
                            sc._blue_noise, sc._geom, sc._mat_table,
                            sc._light_table, sc._sky(), sc.camera,
                            jnp.int32(0))

    mesh = sharding.make_pixel_mesh(8, devices=CPU8)
    assert mesh.shape == (dy, dx)

    def port_tile(rng_state, geom, mats, lights, sky, camera, bn, tile):
        return pipeline.trace_frame(
            geom, mats, lights, n_lights, sky, camera, rng_state, 0,
            rng_state.shape[1], rng_state.shape[0], 1, 2, bn, tile=tile)

    state, bufs = sharding.shard_mapped_trace(mesh, H, W, port_tile)(
        port["rng_state"], port["geometry"], port["materials"],
        port["lights"], port["sky"], port["camera"], port["blue_noise"])
    assert isinstance(bufs.color.x, sharding.Sharded)
    state = sharding.gather_pixels(mesh, state)
    got = sharding.gather_pixels(mesh, bufs)

    assert np.array_equal(np.asarray(ref_state),
                          state.numpy().astype(np.uint32))
    oid = got.object_id.numpy()
    assert np.array_equal(oid, np.asarray(ref.object_id))
    assert len(np.unique(oid)) >= 3
    hit = oid >= 0
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(ref.depth),
                               rtol=1e-5)
    np.testing.assert_allclose(_v(got.normal)[:, hit], _v(ref.normal)[:, hit],
                               rtol=1e-5, atol=1e-6)
    r, g = float(ref.rays_traced), int(got.rays_traced)
    assert abs(g - r) <= 0.005 * r, (g, r)
    rc, gc = _v(ref.color), _v(got.color)
    assert np.isfinite(gc).all()
    np.testing.assert_allclose(gc.sum(axis=(1, 2)), rc.sum(axis=(1, 2)),
                               rtol=0.01)
    close = np.isclose(gc, rc, rtol=1e-3, atol=1e-6).all(axis=0)
    assert close.mean() >= 0.97, close.mean()

    # the tiles put together are the port's own whole frame, bit for bit
    whole_state, whole = pipeline.trace_frame(
        port["geometry"], port["materials"], port["lights"], n_lights,
        port["sky"], port["camera"], port["rng_state"], 0, W, H, 1, 2,
        port["blue_noise"])
    assert torch.equal(whole_state, state)
    assert int(whole.rays_traced) == int(got.rays_traced)
    for a, b in ((whole.color, got.color), (whole.normal, got.normal)):
        for p, q in zip((a.x, a.y, a.z), (b.x, b.y, b.z)):
            assert torch.equal(p.view(torch.int32), q.view(torch.int32))

    with pytest.raises(ValueError, match="divide"):
        sharding.shard_mapped_trace(mesh, H, W + 2, port_tile)


def test_dryrun_multichip_on_cpu(capsys):
    img = dryrun.dryrun_multichip(8, device="cpu")
    assert img.shape == (16, 64, 3) and img.std() > 1.0
    assert "dryrun_multichip ok: mesh 2x4, frame (16, 64, 3)" in \
        capsys.readouterr().out
