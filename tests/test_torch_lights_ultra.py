"""Directional and area lights, and the chunked-spp ("ultra") frame:
ptrt_tpu_torch against the JAX reference.

* ``Light.directional`` / ``Light.area`` and the ``Scene`` methods that add
  them give the reference's packed table rows.
* A frame lit by one directional and one area light under the gradient sky
  (``test_torch_env_frame.py``'s 64x48 scene without its HDRI, 2 spp, depth
  3): the port's ``trace_frame`` on the reference's tables against the
  reference's, and the port's own ``Scene.render_frame`` against the
  reference's, under ``test_torch_slice.py``'s bounds.
* The chunked frame, on the port alone: a 32-spp frame's colour equals
  ``c0 * float32(0.5) + c1 * float32(0.5)`` of two 16-spp ``trace_frame``
  calls at ``frame_count`` and ``frame_count + 16``, bit for bit; its
  G-buffer is chunk 0's, its rays the chunks' sum, and the PCG stream
  advanced once a chunk.
* The "ultra" preset (depth 32, roulette from bounce 8, bloom on,
  progressive average) at 32x24 with 32 spp on the HDRI scene, through
  both packages' ``Scene.render_frame``: one reference trace program (16
  spp, run for both chunks) and one post program.  The image within 1 LSB
  on at least 99% of pixels, the PCG state after the frame identical.
  Measured: within 1 LSB on 99.74% of pixels, exact on 94.5%, at most 2
  LSB apart (image mean 241).  Over 32 bounces an ulp of difference more
  often flips a roulette or lobe choice: at depth 32, 16 spp, 96.9% of the
  HDR pixels agree within 1e-3 with the HDRI and 96.6% without it (99.9%
  at depth 3), energy within 0.14%.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ptrt_tpu.scene.lights import Light as RefLight
from ptrt_tpu.scene.lights import LightTable as RefLightTable
from ptrt_tpu.scene.materials import Material as RefMaterial
from ptrt_tpu.scene.materials import Materials as RefMaterials
from ptrt_tpu.scene.pt_scene import Scene as RefScene

from ptrt_tpu_torch.render import pipeline
from ptrt_tpu_torch.scene.lights import Light, LightTable
from ptrt_tpu_torch.scene.materials import Material, Materials
from ptrt_tpu_torch.scene.pt_scene import Scene, spp_chunks
from test_torch_env_frame import H, W, _v, build, hold, traced
from test_torch_shading import torch_one_thread  # noqa: F401

CPU = torch.device("cpu")


def _post_off(sc):
    sc.perf.enable_denoiser = sc.perf.enable_bloom = False
    sc.perf.enable_motion_vectors = False
    sc.perf.samples_per_pixel, sc.perf.max_bounce_depth = 2, 3
    return sc


# -- the light factories ------------------------------------------------------


@pytest.mark.parametrize("kind", ["directional", "area"])
def test_light_rows_match_reference(kind):
    args = {"directional": [((0.3, -1.0, 0.4), (1.0, 0.95, 0.9), 2.0),
                            ((0.0, -2.0, 0.0),), ((1e-14, 0.0, 0.0),)],
            "area": [((-2.0, 5.0, 6.0), (0.2, -1.0, 0.0), 1.5, 0.8,
                      (1.0, 1.0, 0.9), 8.0, 30.0),
                     ((0.0, 3.0, 0.0), (0.0, -1.0, 0.0))]}[kind]
    ours = [getattr(Light, kind)(*a) for a in args]
    refs = [getattr(RefLight, kind)(*a) for a in args]
    for a, b in zip(ours, refs):
        assert int(a.type) == int(b.type)
        for f in dataclasses.fields(Light):
            if f.name != "type":
                assert np.array_equal(np.asarray(getattr(a, f.name)),
                                      np.asarray(getattr(b, f.name))), f.name
    assert np.array_equal(LightTable.from_lights(ours, CPU).packed.numpy(),
                          np.asarray(RefLightTable.from_lights(refs).packed))


def test_scene_light_methods_match_reference():
    ref, sc = RefScene(8, 6), Scene(8, 6, device="cpu")
    for s in (ref, sc):
        s.add_directional_light((0.3, -1.0, 0.4), (1.0, 0.95, 0.9), 2.0)
        s.add_area_light((-0.5, 2.5, 4.0), (0.1, -1.0, 0.0), 1.2, 0.8,
                         (1.0, 1.0, 0.9), 5.0)
        s.add_point_light((0, 2, 1), (0.8, 0.8, 0.8), 5.0, range=20.0)
    sc.render_frame()
    assert sc.frame_count == 1
    sc.add_directional_light((0.0, -1.0, 0.0))
    assert sc.frame_count == 0  # an edit restarts the accumulation
    ref.add_directional_light((0.0, -1.0, 0.0))
    ref._ensure_device_state()
    sc._ensure_device_state()
    assert np.array_equal(sc._light_table.packed.numpy(),
                          np.asarray(ref._light_table.packed))


def test_scene_settings_match_reference():
    ref, sc = RefScene(8, 6), Scene(8, 6, device="cpu")
    for depth in (0, 1, 7, 16, 40):
        ref.set_max_bounce_depth(depth)
        sc.set_max_bounce_depth(depth)
        assert sc.perf.max_bounce_depth == ref.perf.max_bounce_depth
    sc.render_frame()
    sc.set_sky_enabled(False)
    assert not sc.use_sky and sc.frame_count == 0
    assert float(sc.sky().use_sky) == 0.0


# -- a frame lit by the two lights --------------------------------------------


@pytest.fixture(scope="module")
def lights_ref():
    sc = _post_off(build(RefScene(W, H), RefMaterial, RefMaterials,
                         env=None))
    sc._ensure_device_state()
    assert sc._use_brute() and not sc._sky().has_env_sampling
    return sc


def test_lights_frame_matches_reference(lights_ref):
    ref, ref_state, got, state = traced(lights_ref, False)
    hold(ref, ref_state, got, state)


def test_lights_render_frame_matches_reference(lights_ref):
    ref_img = lights_ref.render_frame()
    sc = _post_off(build(Scene(W, H, device="cpu"), Material, Materials,
                         env=None))
    img = sc.render_frame()
    assert img.shape == (H, W, 3) and img.std() > 5.0
    diff = np.abs(img.astype(int) - ref_img.astype(int)).max(-1)
    assert (diff <= 1).mean() >= 0.99, (diff <= 1).mean()
    assert np.array_equal(sc._rng_state.numpy().astype(np.uint32),
                          np.asarray(lights_ref._rng_state))


# -- the chunked frame ---------------------------------------------------------


def test_spp_chunks():
    assert spp_chunks(128) == [16] * 8
    assert spp_chunks(17) == [16, 1] and spp_chunks(32) == [16, 16]
    assert spp_chunks(40) == [16, 16, 8]


def test_chunked_frame_is_two_weighted_halves():
    """A 32-spp frame is chunk 0 multiplied and chunk 1 added, each by
    float32(16 / 32), their G-buffer chunk 0's and their rays summed; each
    chunk runs at its own frame index and advances the stream once."""
    sc = _post_off(build(Scene(16, 12, device="cpu"), Material, Materials))
    sc.perf.samples_per_pixel = 32
    sc.frame_count = 5
    sc._ensure_device_state()
    st0 = sc._rng_state.clone()
    sc.render_frame()
    got = sc.last_frame

    sky = sc.sky()
    args = (sc._geom, sc._mat_table, sc._light_table, len(sc.lights), sky,
            sc.camera)
    st1, c0 = pipeline.trace_frame(*args, st0, 5, 16, 12, 16, 3,
                                   sc._blue_noise, rr_start=1)
    st2, c1 = pipeline.trace_frame(*args, st1, 21, 16, 12, 16, 3,
                                   sc._blue_noise, rr_start=1)
    w = float(np.float32(0.5))
    want = c0.color * w + c1.color * w
    assert np.array_equal(_v(got.color), _v(want))
    assert torch.equal(sc._rng_state, st2)
    for name in ("normal", "depth", "object_id", "roughness",
                 "transmission"):
        a, b = getattr(got, name), getattr(c0, name)
        assert np.array_equal(_v(a) if name == "normal" else a.numpy(),
                              _v(b) if name == "normal" else b.numpy()), name
    assert int(got.rays_traced) == int(c0.rays_traced) + int(c1.rays_traced)
    assert got.diffuse is None  # unsplit: the denoiser is off
    # the progressive average shows the frame itself after a restart
    assert sc._accum is not None and float(sc._accum[1]) == 1.0


def test_ultra_frame_matches_reference(monkeypatch):
    # the reference's deep-loop knob: its bounce loop's body as one bounce,
    # not eight (the same bounces, each guarded by the depth; measured 13 s
    # to compile the trace on this CPU where eight took 326 s)
    monkeypatch.setenv("PTRT_CHUNK", "1")
    ref = build(RefScene(32, 24), RefMaterial, RefMaterials)
    sc = build(Scene(32, 24, device="cpu"), Material, Materials)
    for s in (ref, sc):
        s.set_performance_preset("ultra")
        s.perf.samples_per_pixel = 32
    assert sc.perf.max_bounce_depth == 32 and sc.perf.enable_bloom
    assert not sc.perf.enable_denoiser
    ref_img = ref.render_frame()
    img = sc.render_frame()
    assert img.shape == (24, 32, 3) and 10.0 < img.mean() < 245.0
    diff = np.abs(img.astype(int) - ref_img.astype(int)).max(-1)
    assert (diff <= 1).mean() >= 0.99, (diff <= 1).mean()
    assert np.array_equal(sc._rng_state.numpy().astype(np.uint32),
                          np.asarray(ref._rng_state))
    assert sc.frame_count == ref.frame_count == 1
