"""Whole frames lit by an HDRI: ptrt_tpu_torch against the JAX reference.

A 64x48 scene (a floor, a chrome and a plastic sphere, a glass cube; 136
triangles, so the reference intersects by brute force and the port walks
its BVH) under a seeded 32x64 HDRI with a sun, rotated 0.7 rad, with a
directional and an area light, 2 spp, depth 3.  The port's ``trace_frame``
runs on the reference's tables carried across by ``tables.from_reference``
(the HDRI's map, rotation, alias rows and pdf among them) and is held to
the reference's jitted ``trace_frame``: unsplit and split, the same scene
without lights (env NEE alone), and with the sky turned off (env NEE sees
black; the program of the unsplit frame again).

Bounds, those of ``test_torch_slice.py``: the PCG state after the frame
exact; object ids exact; rays traced within 0.5%; frame energy within 1% a
channel; at least 97% of pixels within 1e-3 relative; the uint8 image
(both through the port's plain K6) within 1 LSB on at least 99% of pixels.
Measured: the PCG states and ids equal; rays 17,299 against 17,305 (13,631
against 13,635 without lights); energy within 3.0e-5 (1.7e-6 without
lights, exactly 0 apart from the lights' with the sky off); 99.90% of
pixels within 1e-3 (99.80% without lights); the image within 1 LSB on
99.97%.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ptrt_tpu.render import pipeline as ref_pipeline
from ptrt_tpu.scene.materials import Material as RefMaterial
from ptrt_tpu.scene.materials import Materials as RefMaterials
from ptrt_tpu.scene.pt_scene import Scene as RefScene

from ptrt_tpu_torch import tables
from ptrt_tpu_torch.app.hdri import synthetic_env
from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.render import pipeline
from test_torch_shading import torch_one_thread  # noqa: F401
from test_torch_slice import ref_np

W, H, SPP, DEPTH = 64, 48, 2, 3
CPU = torch.device("cpu")
# a modest sun for a 32x64 map: its few texels still hold most of the
# map's power, and the frame does not saturate
ENV = synthetic_env(32, 64, seed=7, sun_uv=(0.62, 0.28), sun_radiance=40.0)


def build(scene, material, materials, lights=True, env=ENV):
    """The test scene through either package's ``Scene`` API (``env``
    None: the gradient sky)."""
    sc = scene
    sc.add_plane_xz(-1.0, 10.0, material.make((0.8, 0.8, 0.8), 0.7))
    sc.add_sphere(6, materials.Chrome()).transform.set_position(-0.9, -0.3,
                                                                4.0)
    sc.add_sphere(5, materials.PlasticRed()).transform.set_position(
        0.2, -0.5, 5.2)
    sc.add_cube(materials.Glass()).transform.set_position(1.0, -0.5, 3.8)
    if lights:
        sc.add_directional_light((0.3, -1.0, 0.4), (1.0, 0.95, 0.9), 1.5)
        sc.add_area_light((-0.5, 2.5, 4.0), (0.1, -1.0, 0.0), 1.2, 0.8,
                          (1.0, 1.0, 0.9), 5.0)
    if env is not None:
        sc.set_environment_map(env, rotation=0.7)
    sc.set_camera((0.0, 0.6, 0.0), (0.0, -0.2, 4.5), fov=60)
    return sc


def ref_scene(lights=True):
    sc = build(RefScene(W, H), RefMaterial, RefMaterials, lights)
    sc._ensure_device_state()
    assert sc._use_brute() and sc._sky().has_env_sampling
    return sc


_programs = {}


def _ref_trace(sc, split):
    """The reference's trace_frame, jitted once per (lights, split)."""
    key = (len(sc.lights), split)
    if key not in _programs:
        _programs[key] = jax.jit(
            lambda g, m, l, s, c, st, bn: ref_pipeline.trace_frame(
                g, m, l, key[0], s, c, st, jnp.int32(0), W, H, SPP, DEPTH,
                split=split, use_brute=True, blue_noise_tbl=bn))
    return _programs[key](sc._geom, sc._mat_table, sc._light_table,
                          sc._sky(), sc.camera, sc._rng_state,
                          sc._blue_noise)


def traced(sc, split):
    """(reference FrameBuffers and state, the port's) of one frame on the
    reference's tables."""
    ref_state, ref_bufs = _ref_trace(sc, split)
    port = tables.from_reference(
        device=CPU, geometry=ref_np(sc._geom),
        materials=ref_np(sc._mat_table), lights=ref_np(sc._light_table),
        sky=ref_np(sc._sky()), camera=ref_np(sc.camera),
        rng_state=np.asarray(sc._rng_state),
        blue_noise=np.asarray(sc._blue_noise))
    assert port["sky"].has_env_sampling == sc._sky().has_env_sampling
    state, bufs = pipeline.trace_frame(
        port["geometry"], port["materials"], port["lights"], len(sc.lights),
        port["sky"], port["camera"], port["rng_state"], 0, W, H, SPP, DEPTH,
        port["blue_noise"], split=split)
    return ref_bufs, np.asarray(ref_state), bufs, state.numpy()


def _v(v):
    if isinstance(v, Vec3):
        return np.stack([c.numpy() for c in (v.x, v.y, v.z)])
    return np.stack([np.asarray(c) for c in (v.x, v.y, v.z)])


def hold(ref, ref_state, got, state, lit=True):
    """test_torch_slice.py's bounds; returns the measured values."""
    assert np.array_equal(ref_state, state.astype(np.uint32))
    assert np.array_equal(got.object_id.numpy(), np.asarray(ref.object_id))
    r, g = float(ref.rays_traced), int(got.rays_traced)
    assert abs(g - r) <= 0.005 * r, (g, r)
    rc, gc = _v(ref.color), _v(got.color)
    assert np.isfinite(gc).all()
    e_r, e_g = rc.sum(axis=(1, 2)), gc.sum(axis=(1, 2))
    if lit:
        np.testing.assert_allclose(e_g, e_r, rtol=0.01)
    else:
        assert e_r.max() == 0.0 and e_g.max() == 0.0
    close = np.isclose(gc, rc, rtol=1e-3, atol=1e-6).all(axis=0)
    assert close.mean() >= 0.97, close.mean()
    img = pipeline.tonemap_rgb8_plain(got.color, 1.0).numpy()
    ref_img = pipeline.tonemap_rgb8_plain(
        Vec3(*[torch.from_numpy(np.asarray(c)) for c in (
            ref.color.x, ref.color.y, ref.color.z)]), 1.0).numpy()
    lsb = (np.abs(img.astype(int) - ref_img.astype(int)).max(-1) <= 1).mean()
    assert lsb >= 0.99, lsb
    if lit:
        assert img.std() > 5.0
    return dict(rays=(g, r), close=close.mean(), lsb=lsb)


@pytest.fixture(scope="module")
def lit_scene():
    return ref_scene()


@pytest.mark.parametrize("split", [False, True], ids=["plain", "split"])
def test_hdri_frame_matches_reference(lit_scene, split):
    ref, ref_state, got, state = traced(lit_scene, split)
    hold(ref, ref_state, got, state)
    if split:
        for name in ("diffuse", "specular", "emission"):
            np.testing.assert_allclose(
                _v(getattr(got, name)).sum(axis=(1, 2)),
                _v(getattr(ref, name)).sum(axis=(1, 2)), rtol=0.01,
                atol=1e-3)
    # env NEE casts a second shadow ray a NEE lane: more rays than the
    # frame's camera rays and one shadow ray each
    assert int(got.rays_traced) > W * H * SPP * 2


def test_hdri_only_frame_matches_reference():
    """No lights: the env sample is the only NEE, and its walk runs."""
    ref, ref_state, got, state = traced(ref_scene(lights=False), False)
    hold(ref, ref_state, got, state)


def test_env_with_sky_disabled_matches_reference(lit_scene):
    """The sky off under an HDRI: env NEE still samples, shadow-tests and
    counts its rays, and adds black; only the lights light the frame."""
    lit_scene.set_sky_enabled(False)
    try:
        ref, ref_state, got, state = traced(lit_scene, False)
    finally:
        lit_scene.set_sky_enabled(True)
    hold(ref, ref_state, got, state)
