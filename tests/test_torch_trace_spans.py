"""The port's tracing (``ptrt_tpu_torch/utils/logging.py``: ``tracing``,
``span``, ``gpu_frame``) on the CPU.

* Off (the default): ``span`` and ``gpu_frame`` return the one shared
  no-op object, read no clock, and a scene's frames record nothing.
* On: an orbiting ``Scene.set_camera`` and ``render_frame_device`` record
  exactly the spans of the frame loop, in order and nested as the code
  runs them (``camera.make``, which stages the camera's host inputs and
  does no device work; ``frame.select``, then ``program.refresh``,
  ``program.stage``, ``program.replay``, in which the program makes the
  camera); the set-up's ``geometry.bvh8_build`` once; no
  ``program.capture`` (nothing is captured on the CPU) and no span inside
  a program's body; no GPU frames on the CPU.
* The frames (RGB8, PCG state, denoiser history) are bit for bit the same
  with tracing on and off.
* ``Camera.make`` (``set_position`` and ``look_at`` too) records
  ``camera.stage`` and then ``camera.math`` inside ``camera.make``.
* One ``gpu_frame`` a frame holds every program run of it: the frame
  program's, or above 16 spp the chunk programs' and the post program's
  (a stand-in context in its place, as the CPU records no events).
* The buffers stay bounded; ``tracing(True)`` starts them empty;
  ``profiler_trace`` shows each span as a range of its name.
* ``graphs.Program.stats`` holds ``pool_bytes`` alone.
~15 s.
"""

import contextlib
import time

import pytest
import torch

from ptrt_tpu_torch import graphs
from ptrt_tpu_torch.scene import pt_scene
from ptrt_tpu_torch.scene.camera import Camera
from ptrt_tpu_torch.scene.materials import Material, Materials
from ptrt_tpu_torch.scene.pt_scene import Scene
from ptrt_tpu_torch.utils import logging as plog
from test_torch_shading import torch_one_thread  # noqa: F401

W, H = 24, 16
FRAMES = 3
CAMERA = ("camera.make",)
# Camera.make's (set_position and look_at call it)
CAMERA_MAKE = ("camera.make", "camera.stage", "camera.math")
FRAME = ("frame.select", "program.refresh", "program.stage",
         "program.replay")


@pytest.fixture(autouse=True)
def tracing_off():
    plog.tracing(False)
    yield
    plog.tracing(False)


def _scene(preset: str) -> Scene:
    sc = Scene(W, H, device="cpu")
    sc.add_plane_xz(-1.0, 10.0, Material.make((0.8, 0.8, 0.8), 0.7))
    sc.add_sphere(8, Materials.PlasticRed()).transform.set_position(
        0.0, -0.5, 4.0)
    sc.add_point_light((2.0, 4.0, 2.0), (1.0, 1.0, 1.0), 6.0, radius=0.2)
    sc.set_performance_preset(preset)
    sc.perf.resolution_scale = 1.0
    sc.perf.samples_per_pixel = 1
    return sc


def _orbit(sc: Scene, frames: int = FRAMES) -> list:
    """``frames`` frames, the camera moved before each as a game moves
    it; the RGB8s and the state each leaves, as copies."""
    out = []
    for k in range(frames):
        sc.set_camera((0.3 * k, 0.5, 0.0), (0.0, 0.0, 4.0), fov=60)
        sc.frame_count = 7 + k
        rgb8 = sc.render_frame_device()
        out.append(graphs.clone_tree((rgb8, sc._rng_state,
                                      sc._denoiser_state)))
    return out


def _by_start(spans: list) -> list:
    return sorted(spans, key=lambda s: s[1])


def _within(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_off_is_the_shared_no_op(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock while tracing is off")

    monkeypatch.setattr(plog.time, "perf_counter", no_clock)
    assert plog.span("camera.make") is plog.NO_SPAN
    assert plog.span("frame.select") is plog.NO_SPAN
    assert plog.gpu_frame(torch.device("cpu")) is plog.NO_SPAN
    with plog.span("camera.make") as s:
        assert s is plog.NO_SPAN
    assert plog.spans() == [] and plog.gpu_frames() == []


@pytest.mark.parametrize("preset", ["fast", "balanced"])
def test_off_scene_records_nothing(preset):
    _orbit(_scene(preset), 2)
    assert plog.spans() == [] and plog.gpu_frames() == []


@pytest.mark.parametrize("preset", ["fast", "balanced"])
def test_on_records_the_frame_loop_spans(preset):
    sc = _scene(preset)
    plog.tracing(True)
    _orbit(sc)
    spans = _by_start(plog.spans())
    names = [n for n, _, _ in spans]
    # the set-up's one BVH build inside the first frame, then the loop
    assert names.count("geometry.bvh8_build") == 1
    assert "program.capture" not in names and "frame.clone" not in names
    loop = [s for s in spans if s[0] != "geometry.bvh8_build"]
    assert [n for n, _, _ in loop] == list(CAMERA + FRAME) * FRAMES
    for k in range(FRAMES):
        make, select, refresh, hv, replay = loop[5 * k:5 * k + 5]
        assert make[2] <= select[1]
        assert select[2] <= refresh[1] <= refresh[2] <= hv[1]
        assert hv[2] <= replay[1]
        # nothing opens inside the program's body (a replay on the card)
        assert not [s for s in spans if s is not replay
                    and _within(s, replay)]
    assert plog.gpu_frames() == []  # event pairs are for the card


@pytest.mark.parametrize("make", [
    lambda cam: Camera.make((0.3, 0.5, 0.0), (0.0, 0.0, 4.0), device="cpu"),
    lambda cam: cam.set_position((0.1, 0.4, -0.2)),
    lambda cam: cam.look_at((0.5, 0.0, 3.0))],
    ids=["make", "set_position", "look_at"])
def test_camera_make_records_stage_then_math_within_make(make):
    cam = Camera.make((0.0, 0.5, 0.0), (0.0, 0.0, 4.0), device="cpu")
    plog.tracing(True)
    make(cam)
    outer, stage, math = _by_start(plog.spans())
    assert [n for n, _, _ in (outer, stage, math)] == list(CAMERA_MAKE)
    assert _within(stage, outer) and _within(math, outer)
    assert stage[2] <= math[1]


@pytest.mark.parametrize("preset", ["fast", "balanced"])
def test_frames_equal_with_tracing_on_and_off(preset):
    off = _orbit(_scene(preset))
    plog.tracing(True)
    on = _orbit(_scene(preset))
    assert plog.spans()
    for a, b in zip(off, on):
        for x, y in zip(graphs.tree_leaves(a), graphs.tree_leaves(b)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("spp, runs", [(1, 1), (32, 3)])
def test_one_gpu_frame_holds_the_frame_programs(monkeypatch, spp, runs):
    """1 spp: the frame program; 32 spp: two 16-spp chunk programs and
    the post program, all inside the frame's one GPU frame."""
    frames = []

    @contextlib.contextmanager
    def stand_in(device):
        t0 = time.perf_counter()
        yield
        frames.append(("gpu_frame", t0, time.perf_counter()))

    monkeypatch.setattr(pt_scene, "gpu_frame", stand_in)
    sc = _scene("fast")
    sc.perf.samples_per_pixel, sc.perf.max_bounce_depth = spp, 1
    plog.tracing(True)
    _orbit(sc)
    assert len(frames) == FRAMES
    spans = plog.spans()
    selects = _by_start(s for s in spans if s[0] == "frame.select")
    for frame, select in zip(frames, selects):
        assert select[2] <= frame[1]
        inside = [n for n, b, e in spans if _within((n, b, e), frame)]
        assert inside.count("program.replay") == runs
        assert inside.count("program.refresh") == runs
    program = [s for s in spans if s[0].startswith("program.")]
    assert all(sum(_within(s, f) for f in frames) == 1 for s in program)


@pytest.mark.parametrize("kind", ["spans", "frames"])
def test_buffers_stay_bounded(monkeypatch, kind):
    """Past the bound the oldest entries go (frames: as the card's event
    pairs would be kept, with stand-in events)."""
    plog.tracing(True)
    if kind == "spans":
        bound = plog.SPANS_KEPT
        for k in range(bound + 5):
            with plog.span(f"s{k}"):
                pass
        got = plog.spans()
        assert len(got) == bound and got[0][0] == "s5"
    else:
        bound = plog.FRAMES_KEPT
        ev = type("Ev", (), {"elapsed_time": lambda a, b: 1.5})

        for k in range(bound + 5):
            plog._frames.append((float(k), k + 0.5, (ev(), ev())))
        got = plog.gpu_frames()
        assert len(got) == bound and got[0] == (5.0, 5.5, 1.5)


def test_tracing_on_starts_empty_and_off_keeps_the_record():
    plog.tracing(True)
    with plog.span("a"):
        pass
    plog.tracing(True)  # on again: the record is kept
    with plog.span("b"):
        pass
    plog.tracing(False)
    with plog.span("c"):
        pass
    assert [n for n, _, _ in plog.spans()] == ["a", "b"]
    plog.tracing(True)  # off to on: a new record
    assert plog.spans() == []


def test_span_times_on_the_perf_counter_clock():
    plog.tracing(True)
    t0 = time.perf_counter()
    with plog.span("outer"):
        with plog.span("inner"):
            time.sleep(0.002)
    t1 = time.perf_counter()
    inner, outer = plog.spans()  # in the order they ended
    assert (inner[0], outer[0]) == ("inner", "outer")
    assert t0 <= outer[1] <= inner[1] and inner[2] <= outer[2] <= t1
    assert inner[2] - inner[1] >= 0.002


@pytest.mark.parametrize("on", [False, True])
def test_profiler_trace_shows_spans_as_ranges(tmp_path, on):
    plog.tracing(on)
    with plog.profiler_trace(str(tmp_path)) as prof:
        with plog.span("frame.select"):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert ("frame.select" in names) == on
    assert not plog._profiling
    with plog.span("camera.make"):  # no profiler: no range
        pass
    assert (tmp_path / "trace.json").exists()


def test_program_stats_hold_the_pool_alone():
    sc = _scene("fast")
    plog.tracing(True)
    _orbit(sc, 1)
    (prog,) = sc._programs.values()
    assert prog.stats == {"pool_bytes": 0}  # nothing captured on the CPU
