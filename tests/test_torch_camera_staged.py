"""The camera made from its host inputs (``scene/camera.py``
``camera_inputs``, ``camera_make``) and the frame programs that make it in
their graphs (``Scene.set_camera``, ``Scene._with_camera``) on the CPU.

* ``camera_inputs`` rounds as ``Camera.make`` rounds its host numbers, and
  ``camera_make`` (on the CPU its plain version) gives ``Camera.make``'s
  camera bit for bit, from host numbers and from 0-d tensors.
* ``set_camera`` keeps the inputs and makes no camera; ``Scene.camera``
  makes it at the first read and keeps it until the next ``set_camera``.
* An orbit through ``set_camera`` renders through its program bit for
  bit what the eager body renders (fast, balanced, chunked), the program
  reading no camera tensor and staging the 15 inputs with its values.
* ``Scene._with_camera`` adds the camera to a program's key, reads and
  values by its form.
* A camera set by ``set_camera`` and one assigned, in turns, render as
  the eager body and make two programs, not one a frame; the wireframe and
  the trace-only program take both forms too.
* ``logging.camera_frames`` counts each frame once by its camera's form,
  while tracing is on.
~20 s.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ptrt_tpu_torch import bench, graphs
from ptrt_tpu_torch.render import pipeline
from ptrt_tpu_torch.scene.camera import (CAMERA_INPUTS, Camera,
                                         camera_inputs, camera_make)
from ptrt_tpu_torch.scene.materials import Material, Materials
from ptrt_tpu_torch.scene.pt_scene import Scene
from ptrt_tpu_torch.utils import logging as plog
from test_torch_shading import torch_one_thread  # noqa: F401

W, H = 24, 16
CPU = torch.device("cpu")
CAMERAS = [
    ((0.3, 1.2, -1.5), (0.0, 0.0, 6.0), (0.0, 1.0, 0.0), 60.0, 16 / 9, 0.0,
     7.5),
    ((2.0, -1.0, 3.0), (-1.0, 0.5, 9.0), (0.3, 0.9, -0.2), 10.0, 1.0, 0.25,
     3.0),
    ((0.1, 0.2, 0.3), (0.1004, 0.1995, 0.3007), (0.0, 0.0, 1.0), 120.0, 2.5,
     0.0, 0.001),
]


@pytest.fixture(autouse=True)
def tracing_off():
    plog.tracing(False)
    yield
    # off, the buffers emptied: a later test of this process reads them
    plog.tracing(True)
    plog.tracing(False)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a, b) -> bool:
    la, lb = graphs.tree_leaves(a), graphs.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(_bits(x), _bits(y)) for x, y in zip(la, lb))


def _scene(preset: str = "fast") -> Scene:
    sc = Scene(W, H, device="cpu")
    sc.add_plane_xz(-1.0, 10.0, Material.make((0.8, 0.8, 0.8), 0.7))
    sc.add_sphere(8, Materials.PlasticRed()).transform.set_position(
        0.0, -0.5, 4.0)
    sc.add_point_light((2.0, 4.0, 2.0), (1.0, 1.0, 1.0), 6.0, radius=0.2)
    sc.set_performance_preset(preset)
    sc.perf.resolution_scale = 1.0
    return sc


def _chunked() -> Scene:
    sc = _scene("fast")
    sc.perf.samples_per_pixel, sc.perf.max_bounce_depth = 32, 1
    return sc


def _orbit_args(k: int) -> tuple:
    a = np.deg2rad(7.0 * k)
    return ((4.0 * np.sin(a), 0.5, 4.0 - 4.0 * np.cos(a)), (0.0, 0.0, 4.0))


def _set(sc: Scene, k: int) -> None:
    sc.set_camera(*_orbit_args(k), fov=60)


def _assign(sc: Scene, k: int) -> None:
    """The camera ``set_camera`` would make, assigned as a Camera."""
    lookfrom, lookat = _orbit_args(k)
    focus = float(np.linalg.norm(np.subtract(lookat, lookfrom)))
    sc.camera = Camera.make(lookfrom, lookat, (0, 1, 0), 60.0, W / H, 0.0,
                            focus, device=CPU)
    sc.reset_accumulation()


def _eager(sc: Scene) -> torch.Tensor:
    sc._ensure_device_state()
    img = sc.render_world(sc._geom, sc.camera, sc.frame_count,
                          sc.prev_view_proj,
                          bool(sc.perf.progressive_accumulation))
    sc.frame_count += 1
    sc.prev_view_proj = sc.camera.get_view_proj()
    return img


def _state(sc: Scene) -> tuple:
    return (sc._rng_state, sc._denoiser_state, sc._accum,
            sc._accum_view_proj, sc.prev_view_proj)


def _lockstep(make, move, frames: int) -> Scene:
    """Frames through the programs and through the eager body, ``move(sc,
    k)`` before frame k on both, compared bit for bit; returns the program
    scene."""
    prog, eager = make(), make()
    for k in range(frames):
        move(prog, k)
        move(eager, k)
        a, b = prog.render_frame_device(), _eager(eager)
        assert torch.equal(a, b), k
        assert _same(_state(prog), _state(eager)), k
        assert _same(prog.last_frame, eager.last_frame), k
    return prog


@pytest.mark.parametrize("args", CAMERAS)
def test_camera_inputs_round_as_camera_make(args):
    got = camera_inputs(*args)
    assert len(got) == CAMERA_INPUTS and all(type(v) is float for v in got)
    lf, la, up, *rest = args
    want = torch.tensor([*lf, *la, *up, rest[0], rest[1], rest[3], rest[2],
                         0.1, 1000.0], dtype=torch.float32)
    assert torch.equal(torch.tensor(got, dtype=torch.float32), want)
    assert got == tuple(want.tolist())


def test_camera_inputs_take_vec3s():
    from ptrt_tpu_torch.core.vec import Vec3

    lf, la, up, *rest = CAMERAS[1]
    assert camera_inputs(Vec3(*lf), Vec3(*la), Vec3(*up), *rest) == \
        camera_inputs(*CAMERAS[1])


@pytest.mark.parametrize("args", CAMERAS)
@pytest.mark.parametrize("staged", [False, True])
def test_camera_make_equals_camera_make_eager(args, staged):
    inputs = camera_inputs(*args)
    if staged:  # a program's staged values
        inputs = [torch.tensor(v, dtype=torch.float32) for v in inputs]
    got = camera_make(inputs, CPU)
    want = Camera.make(*args, device=CPU)
    assert _same(got, want)
    assert _same(camera_make(camera_inputs(*args), CPU), got)


@pytest.mark.parametrize("assigned", [False, True], ids=["set", "assigned"])
def test_with_camera_adds_the_camera_by_its_form(assigned):
    sc = _scene()
    _set(sc, 2)
    if assigned:
        _assign(sc, 2)
    table = object()
    reads = {"mats": table}
    key, got, first, values = sc._with_camera(("frame", 1), reads, (0, 0),
                                              (7, 1))
    assert list(reads) == ["mats"]  # the caller's dict is kept
    if assigned:
        assert key == ("frame", 1, graphs.signature(sc.camera))
        assert list(got) == ["mats", "camera"]
        assert got["mats"] is table and got["camera"] is sc.camera
        assert (first, values) == ((0, 0, ()), (7, 1, ()))
    else:
        assert key == ("frame", 1) and got is reads
        assert (first, values) == ((0, 0, sc._camera_inputs),
                                   (7, 1, sc._camera_inputs))
        assert len(sc._camera_inputs) == CAMERA_INPUTS
        assert sc._camera is None  # no camera made to take it


def test_camera_make_refuses():
    with pytest.raises(ValueError, match="15"):
        camera_make(camera_inputs(*CAMERAS[0])[:14], CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            camera_make(camera_inputs(*CAMERAS[0]), "cuda")


def test_set_camera_keeps_inputs_and_reads_make_once():
    sc = _scene()
    _set(sc, 3)
    assert sc._camera is None
    lookfrom, lookat = _orbit_args(3)
    focus = float(np.linalg.norm(np.subtract(lookat, lookfrom)))
    assert sc._camera_inputs == camera_inputs(lookfrom, lookat, (0, 1, 0),
                                              60, W / H, 0.0, focus)
    first = sc.camera
    assert sc.camera is first  # kept until the next set_camera
    assert _same(first, Camera.make(lookfrom, lookat, (0, 1, 0), 60.0, W / H,
                                    0.0, focus, device=CPU))
    _set(sc, 4)
    assert sc._camera is None and sc.camera is not first
    mine = dataclasses.replace(first)
    sc.camera = mine
    assert sc.camera is mine and sc._camera_inputs is None
    # the scene's first camera takes the staged path too
    fresh = Scene(W, H, device="cpu")
    assert fresh._camera_inputs == camera_inputs(
        (0.0, 0.0, 0.0), (0.0, 3.5, 5.0), aspect_ratio=W / H)
    assert _same(fresh.prev_view_proj, fresh.camera.get_view_proj())


@pytest.mark.parametrize("make", [lambda: _scene("fast"),
                                  lambda: _scene("balanced"), _chunked],
                         ids=["fast", "balanced", "chunked"])
def test_orbit_program_equals_eager_body(make):
    sc = _lockstep(make, _set, 4)
    assert sc._programs.made == (2 if sc.perf.samples_per_pixel > 16 else 1)
    for key, prog in sc._programs.items():
        assert len(key) == (3 if key[0] == "chunk" else 2), key
        assert "camera" not in prog.reads
        staged = prog._staged[2]
        assert len(staged) == CAMERA_INPUTS
        assert all(torch.is_tensor(v) and v.dim() == 0 for v in staged)


@pytest.mark.parametrize("preset", ["fast", "balanced"])
def test_set_and_assigned_cameras_in_turns(preset):
    def move(sc, k):
        (_set if k % 2 == 0 else _assign)(sc, k)

    sc = _lockstep(lambda: _scene(preset), move, 8)
    assert sc._programs.made == 2
    keys = sorted(sc._programs, key=len)
    assert keys[0][0] == keys[1][0] == "frame"
    assert len(keys[0]) == 2 and keys[1][2] == graphs.signature(sc.camera)


def test_same_numbers_either_way_render_alike():
    """An orbit set by ``set_camera`` and the same orbit assigned as
    ``Camera.make``'s cameras render the same frames."""
    made, copied = _scene("balanced"), _scene("balanced")
    for k in range(3):
        _set(made, k)
        _assign(copied, k)
        assert torch.equal(made.render_frame_device(),
                           copied.render_frame_device()), k
        assert _same(_state(made), _state(copied)), k


def test_camera_frames_count_each_frame_by_its_camera():
    sc = _scene("fast")
    _set(sc, 0)
    sc.render_frame_device()
    assert plog.camera_frames() == {"made": 0, "copied": 0}  # tracing off
    plog.tracing(True)
    for k in range(3):
        _set(sc, k)
        sc.render_frame_device()
    assert plog.camera_frames() == {"made": 3, "copied": 0}
    _assign(sc, 3)
    sc.render_frame_device()
    sc.render_frame_device()  # the same Camera again
    assert plog.camera_frames() == {"made": 3, "copied": 2}
    sc.render_wireframe()  # not a frame
    assert plog.camera_frames() == {"made": 3, "copied": 2}
    plog.tracing(False)
    plog.tracing(True)  # a new record
    assert plog.camera_frames() == {"made": 0, "copied": 0}
    ch = _chunked()
    ch.render_frame_device()  # two chunk programs and a post program
    assert plog.camera_frames() == {"made": 1, "copied": 0}


def test_wireframe_takes_either_camera():
    a, b = _scene(), _scene()
    _set(a, 2)
    _assign(b, 2)
    assert np.array_equal(a.render_wireframe(), b.render_wireframe())
    _assign(a, 2)
    assert np.array_equal(a.render_wireframe(), b.render_wireframe())
    assert sorted(len(k) for k in a._programs) == [3, 4]


@pytest.mark.parametrize("move", [_set, _assign], ids=["set", "assigned"])
def test_trace_only_program_takes_either_camera(move):
    sc = _scene()
    bench.configure(sc, 1, 2)
    sc._ensure_device_state()
    state = sc._rng_state.clone()
    for i in range(3):
        move(sc, i)
        got = bench.trace_only(sc, i, 1, 2)
        state, want = pipeline.trace_frame(
            sc._geom, sc._mat_table, sc._light_table, len(sc.lights),
            sc.sky(), sc.camera, state, i, W, H, 1, 2, sc._blue_noise)
        assert _same(got, want) and torch.equal(sc._rng_state, state)
    assert sc._programs.made == 1
