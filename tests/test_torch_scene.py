"""The port's ``Scene`` around the post stack: settings and presets, the
order of the post half of the frame, the progressive average and its
gating, and SVGF history across camera moves.

Presets, ``set_resolution_scale`` and ``render_size`` are compared with
the reference's ``Scene`` field by field.  The frame-order tests rebuild
the expected image from the frame's own buffers with the port's stage
functions and require the displayed image to be identical, bit for bit:

- with the denoiser on, the displayed frame is the post stack applied to
  this frame's trace, with no progressive average stacked on it (the
  reference accumulates only when ``progressive_accumulation and not
  enable_denoiser``);
- with the denoiser off, the average restarts when the view-projection's
  values change, however the camera was replaced, and goes on across an
  equal-valued camera; it is taken before bloom and the upscale.

Small scenes (32x24, ~500 triangles); this file runs in ~20 s on one CPU
core.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from ptrt_tpu.scene.pt_scene import Scene as RefScene

from ptrt_tpu_torch import graphs
from ptrt_tpu_torch.app.bench_scene import build_bench_scene
from ptrt_tpu_torch.render import pipeline
from ptrt_tpu_torch.render.bloom import apply_bloom
from ptrt_tpu_torch.render.denoiser import (SKY_DEPTH_THRESHOLD,
                                            denoise_frame)
from ptrt_tpu_torch.render.motion import motion_vectors
from ptrt_tpu_torch.scene.camera import Camera
from ptrt_tpu_torch.scene.pt_scene import (SPP_DISPATCH_MAX,
                                           PerformanceSettings, Scene,
                                           spp_chunks)
from test_torch_shading import torch_one_thread  # noqa: F401

W, H = 32, 24
CPU = torch.device("cpu")


def _small(preset: str = "balanced") -> Scene:
    sc = build_bench_scene(W, H, target_tris=500, device="cpu")
    sc.set_performance_preset(preset)
    sc.perf.samples_per_pixel = 1
    return sc


def _orbit(sc: Scene, deg: float) -> None:
    a = math.radians(deg)
    sc.set_camera((7.5 * math.sin(a), 1.2, 6.0 - 7.5 * math.cos(a)),
                  (0.0, 0.0, 6.0), fov=60)


# -- settings -----------------------------------------------------------------


@pytest.mark.parametrize("preset", ["ultra", "quality", "balanced",
                                    "performance", "fast"])
def test_presets_match_reference(preset):
    ref, sc = RefScene(40, 30), Scene(40, 30, device="cpu")
    ref.set_performance_preset(preset)
    sc.set_performance_preset(preset)
    for f in dataclasses.fields(PerformanceSettings):
        assert getattr(sc.perf, f.name) == getattr(ref.perf, f.name), f.name
    assert sc.render_size == ref.render_size


def test_defaults_match_reference():
    ref = RefScene(40, 30)
    for f in dataclasses.fields(PerformanceSettings):
        assert getattr(Scene(40, 30, device="cpu").perf, f.name) == getattr(
            ref.perf, f.name), f.name


@pytest.mark.parametrize("scale", [0.1, 0.35, 0.75, 1.0, 2.0])
def test_set_resolution_scale(scale):
    ref, sc = RefScene(37, 23), Scene(37, 23, device="cpu")
    ref.set_resolution_scale(scale)
    sc.set_resolution_scale(scale)
    assert sc.perf.resolution_scale == ref.perf.resolution_scale
    assert sc.render_size == ref.render_size


def test_only_high_spp_is_unported():
    """No setting is unported any more (the name is from when frames above
    16 spp raised): such a frame is traced in chunks of at most 16 spp and
    posted once, as the reference's chunked frame."""
    assert not hasattr(PerformanceSettings, "check_ported")
    assert SPP_DISPATCH_MAX == 16
    assert spp_chunks(17) == [16, 1] and spp_chunks(128) == [16] * 8
    sc = Scene(8, 6, device="cpu")
    sc.perf.samples_per_pixel, sc.perf.max_bounce_depth = 17, 1
    sc.add_sphere(6).transform.set_position(0, 0, 4)
    sc.set_camera((0, 0, 0), (0, 0, 4))
    img = sc.render_frame()
    assert img.shape == (6, 8, 3) and sc.frame_count == 1


# -- the post half of the frame -----------------------------------------------


@pytest.mark.parametrize("preset,size", [("performance", (18, 24)),
                                         ("fast", (8, 11))])
def test_scaled_presets_trace_small_and_upscale(preset, size):
    sc = _small(preset)
    for k in range(2):
        _orbit(sc, k)
        img = sc.render_frame()
    assert img.shape == (H, W, 3) and img.dtype == np.uint8
    assert tuple(sc.last_frame.depth.shape) == size == sc.render_size
    assert img.std() > 2.0
    if sc.perf.enable_denoiser:
        assert tuple(sc._denoiser_state.depth.shape) == size


def test_denoised_frame_is_not_accumulated():
    """Two frames under one camera with the denoiser on: the second
    displays the post stack of the second trace alone."""
    sc = _small("balanced")
    assert sc.perf.progressive_accumulation and sc.perf.enable_denoiser
    sc.render_frame()
    # copies: the next frame advances the frame program's buffers in place
    state = graphs.clone_tree(sc._denoiser_state)
    prev_vp = sc.prev_view_proj.clone()
    img = sc.render_frame_device()
    bufs = sc.last_frame
    mv = motion_vectors(bufs.depth, sc.camera, prev_vp, W, H)
    color, _ = denoise_frame(bufs, mv, state)
    assert torch.equal(img, pipeline.tonemap_rgb8(apply_bloom(color), 1.0))
    assert sc._accum is None


def _progressive(bloom: bool, scale: float = 1.0) -> Scene:
    sc = _small("balanced")
    sc.perf.enable_denoiser = False
    sc.perf.enable_bloom = bloom
    sc.perf.resolution_scale = scale
    return sc


def test_accumulation_follows_view_proj_values():
    sc = _progressive(bloom=False)
    sc.render_frame()
    c1 = sc.last_frame.color
    # an equal-valued camera put in place without set_camera: the average
    # goes on
    sc.camera = dataclasses.replace(sc.camera)
    img2 = sc.render_frame_device()
    c2 = sc.last_frame.color
    assert sc._accum[1] == 2
    assert torch.equal(img2, pipeline.tonemap_rgb8((c1 + c2) * 0.5, 1.0))
    # a moved camera put in place without set_camera: it restarts
    sc.camera = Camera.make((0.3, 1.2, -1.5), (0.0, 0.0, 6.0), vfov=60,
                            aspect_ratio=W / H, focus_dist=7.5, device=CPU)
    img3 = sc.render_frame_device()
    assert sc._accum[1] == 1
    assert torch.equal(img3, pipeline.tonemap_rgb8(sc.last_frame.color, 1.0))


def test_accumulation_averages_a_still_camera_and_restarts_on_a_move():
    """Three frames under one camera show the running average of the three
    traces, at the values of a host-side sum times ``1.0 / count``; a moved
    camera's frame starts over."""
    sc = _progressive(bloom=False)
    sc.perf.max_bounce_depth = 1
    colors = []
    for _ in range(3):
        img = sc.render_frame_device()
        colors.append(sc.last_frame.color)
    total = colors[0] + colors[1] + colors[2]
    assert torch.equal(img, pipeline.tonemap_rgb8(total * (1.0 / 3), 1.0))
    assert sc._accum[1].dtype == torch.float32 and float(sc._accum[1]) == 3
    sc.camera = Camera.make((0.3, 1.2, -1.5), (0.0, 0.0, 6.0), vfov=60,
                            aspect_ratio=W / H, focus_dist=7.5, device=CPU)
    img = sc.render_frame_device()
    assert float(sc._accum[1]) == 1
    assert torch.equal(img, pipeline.tonemap_rgb8(sc.last_frame.color, 1.0))


def test_accumulation_copies_nothing_to_the_host(monkeypatch):
    """The progressive average compares the view-projections and selects
    the sum and its count on the device: no tensor is read back (on the
    card that would wait for the frame)."""
    sc = _progressive(bloom=False)
    sc.perf.max_bounce_depth = 1
    sc.render_frame()
    color = sc.last_frame.color

    def refuse(*a, **k):
        raise AssertionError("a tensor was read back to the host")

    for name in ("cpu", "numpy", "item", "tolist", "__bool__", "__float__",
                 "__int__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    sc._accumulate(color, H, W)
    sc._accumulate(color, H, W)
    monkeypatch.undo()
    assert float(sc._accum[1]) == 3


def test_accumulation_comes_before_bloom_and_upscale():
    sc = _progressive(bloom=True, scale=0.5)
    sc.render_frame()
    c1 = sc.last_frame.color
    img = sc.render_frame_device()
    c2 = sc.last_frame.color
    assert tuple(c2.x.shape) == (H // 2, W // 2)
    want = pipeline.upscale_bilinear(apply_bloom((c1 + c2) * 0.5), H, W)
    assert torch.equal(img, pipeline.tonemap_rgb8(want, 1.0))


# -- SVGF history -------------------------------------------------------------


def test_history_survives_camera_moves():
    sc = _small("balanced")
    for k in range(4):
        _orbit(sc, 0.5 * k)
        sc.render_frame()
    assert sc.frame_count == 1  # set_camera restarts the jitter sequence
    st = sc._denoiser_state
    assert not bool(st.first_frame)
    surface = sc.last_frame.depth < SKY_DEPTH_THRESHOLD
    assert float((st.diffuse.length[surface] > 2).float().mean()) > 0.3


def test_reset_accumulation_keeps_history_reset_denoiser_history_drops():
    sc = _small("balanced")
    sc.render_frame()
    sc.render_frame()
    st = sc._denoiser_state
    sc.reset_accumulation()
    assert sc._denoiser_state is st and sc.frame_count == 0
    sc.reset_denoiser_history()
    assert sc._denoiser_state is None
    sc.render_frame()
    # a fresh history: every pixel starts over at length 1
    assert bool((sc._denoiser_state.diffuse.length == 1.0).all())


def test_denoiser_state_follows_render_size():
    sc = _small("balanced")
    sc.render_frame()
    assert tuple(sc._denoiser_state.depth.shape) == (H, W)
    sc.set_resolution_scale(0.5)
    img = sc.render_frame()
    assert img.shape == (H, W, 3)
    assert tuple(sc._denoiser_state.depth.shape) == (H // 2, W // 2)
