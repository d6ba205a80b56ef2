"""On the card: the camera made by the hand-written ``camera_make``
(``ptrt_tpu_torch/csrc/camera.cu``) against ``Camera.make``'s torch ops
(run there with ``python -m pytest benchmark/tests -q -m card``).

* Every leaf but ``inv_view_proj`` is bit for bit ``Camera.make``'s on the
  card, and ``inv_view_proj`` within 1e-6 of the matrix's largest value of
  the exact (float64) inverse of the same ``proj @ view`` (torch's float32
  ``linalg.inv_ex`` of it, ``Camera.make``'s, lies up to ~1e-4 from that
  on such cameras, so it is no yardstick at 1e-6): on the balanced orbit's
  720 cameras (0.5 degrees a frame) and on 1,000 seeded random cameras
  (fov 10-120 degrees, aperture 0 and above, vup off the y axis, lookfrom
  within 1e-3 of lookat for one in ten), their inputs given as host
  numbers and as 0-d tensors on the card.
* The kernel's leaves are views of one buffer at ``camera._LAYOUT``'s
  offsets; a device named "cuda" without its index is the current card.
* A captured launch, replayed 50 times with new staged inputs each time,
  gives each time the camera of those inputs.
* A balanced orbit of 16 frames through ``render_frame_device`` with the
  camera set by ``set_camera`` (made in the frame's graph) gives the RGB8,
  denoiser history, ``prev_view_proj`` and ``rays_traced`` of the same
  frames with the camera handed in as a ``Camera`` (copied into the
  program's buffers) bit for bit; the first counts 16 frames made and
  none copied, the second the reverse, and neither makes a program after
  its first frame."""

import math

import numpy as np
import pytest

from benchmark import cells, scenes, traffic

SEED = 2718281828
ORBIT = "bench_scene.balanced_orbit"
VIEWS = 720  # the orbit's whole turn at 0.5 degrees a frame
RANDOM = 1000


@pytest.fixture
def plog():
    from ptrt_tpu_torch.utils import logging

    logging.tracing(False)
    yield logging
    # off, the buffers emptied: a later test of this process reads them
    logging.tracing(True)
    logging.tracing(False)


def _set_camera_args(lookfrom, lookat, fov, aspect, vup=(0.0, 1.0, 0.0),
                     aperture=0.0, focus_dist=None):
    """``Camera.make``'s arguments as ``Scene.set_camera`` gives them."""
    if focus_dist is None:
        focus_dist = float(np.linalg.norm(np.asarray(lookat, np.float64)
                                          - np.asarray(lookfrom, np.float64)))
    return (lookfrom, lookat, vup, fov, aspect, aperture, focus_dist)


def _orbit_args() -> list:
    cell = cells.load(ORBIT)
    draws = traffic.draws(cell.traffic, SEED)
    aspect = cell.config["width"] / cell.config["height"]
    out = []
    for n in range(VIEWS):
        lookfrom, lookat, fov = traffic.camera_at(cell.traffic, draws, n)
        out.append(_set_camera_args(lookfrom, lookat, fov, aspect))
    return out


def _random_args() -> list:
    rng = np.random.default_rng(SEED)
    out = []
    for k in range(RANDOM):
        lookat = rng.uniform(-20.0, 20.0, 3)
        if k % 10 == 0:
            lookfrom = lookat + rng.uniform(-1e-3, 1e-3, 3)
        else:
            lookfrom = rng.uniform(-20.0, 20.0, 3)
        vup = rng.normal(size=3)
        vup = vup / np.linalg.norm(vup)
        aperture = 0.0 if k % 2 else float(rng.uniform(0.001, 0.5))
        focus = None if k % 3 else float(rng.uniform(0.1, 50.0))
        out.append(_set_camera_args(
            tuple(float(c) for c in lookfrom), tuple(float(c) for c in lookat),
            float(rng.uniform(10.0, 120.0)), float(rng.uniform(0.5, 3.0)),
            tuple(float(c) for c in vup), aperture, focus))
    return out


def _leaves(cam) -> dict:
    from ptrt_tpu_torch import graphs

    return {f.name: graphs.tree_leaves(getattr(cam, f.name))
            for f in type(cam).__dataclass_fields__.values()}


def _inverse_close(got, cam) -> bool:
    """``got`` within 1e-6 of the largest value of the exact inverse of
    ``cam``'s ``proj @ view`` (the kernel's product is cuBLAS's bits)."""
    import torch

    exact = torch.linalg.inv((cam.proj @ cam.view).double())
    tol = 1e-6 * exact.abs().max()
    return bool(((got.double() - exact).abs() <= tol).all())


def _check(got, want, what):
    """Every leaf of ``got`` bit for bit ``want``'s, ``inv_view_proj``
    within the tolerance of the exact inverse."""
    import torch

    bits = lambda t: t.view(torch.int32)
    g, w = _leaves(got), _leaves(want)
    for name in w:
        if name == "inv_view_proj":
            assert _inverse_close(g[name][0], want), (what, g[name],
                                                      w[name])
            continue
        for a, b in zip(g[name], w[name]):
            assert torch.equal(bits(a), bits(b)), (what, name, a, b)


def _compare(args_list, card):
    import torch
    from ptrt_tpu_torch.scene.camera import (Camera, camera_inputs,
                                             camera_make)

    for k, args in enumerate(args_list):
        want = Camera.make(*args, device=card)
        inputs = camera_inputs(*args)
        _check(camera_make(inputs, card), want, (k, "host"))
        staged = [torch.tensor(v, dtype=torch.float32, device=card)
                  for v in inputs]
        _check(camera_make(staged, card), want, (k, "staged"))
    torch.cuda.synchronize()


@pytest.mark.card
def test_camera_make_equals_eager_on_the_orbit(card):
    _compare(_orbit_args(), card)


@pytest.mark.card
def test_camera_make_equals_eager_on_random_cameras(card):
    _compare(_random_args(), card)


@pytest.mark.card
def test_camera_make_leaves_view_one_buffer(card):
    """The kernel writes every leaf into one buffer, at the offsets of
    ``camera._LAYOUT``: the matrices 256 bytes apart, no two leaves
    overlapping."""
    import torch
    from ptrt_tpu_torch import graphs
    from ptrt_tpu_torch.scene import camera as cam_mod

    cam = cam_mod.camera_make(cam_mod.camera_inputs(*_orbit_args()[1]), card)
    base = cam.view.untyped_storage().data_ptr()
    spans = []
    for name, off, n in cam_mod._LAYOUT:
        v = getattr(cam, name)
        first = v.x if n == 3 else v
        assert first.untyped_storage().data_ptr() == base, name
        assert first.data_ptr() - base == 4 * off, name
        if n == 16:
            assert v.shape == (4, 4) and v.is_contiguous() and off % 64 == 0
        spans.append((off, off + n))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] == cam_mod._BUFFER
    leaves = graphs.tree_leaves(cam)
    assert len(leaves) == 29  # seven vectors, three matrices, five numbers
    assert all(t.dtype == torch.float32 for t in leaves)


@pytest.mark.card
def test_camera_make_on_the_card_named_without_index(card):
    """A scene made on "cuda" (the demo's) makes its camera on the current
    card, from host numbers and from tensors staged there."""
    import torch
    from ptrt_tpu_torch.scene.camera import camera_inputs, camera_make

    inputs = camera_inputs(*_orbit_args()[3])
    want = camera_make(inputs, card)
    staged = [torch.tensor(v, dtype=torch.float32, device=card)
              for v in inputs]
    for got in (camera_make(inputs, "cuda"), camera_make(staged, "cuda")):
        _check(got, want, "cuda")
        assert got.view.device == want.view.device


@pytest.mark.card
def test_camera_make_replayed_with_new_inputs(card):
    import torch
    from ptrt_tpu_torch import graphs
    from ptrt_tpu_torch.scene.camera import (Camera, camera_inputs,
                                             camera_make)

    views = _random_args()[:51]
    prog = graphs.Program(
        lambda reads, st, values: (camera_make(values, card), None), {},
        None, camera_inputs(*views[0]), card)
    assert prog.graph is not None and prog.launches["camera_make"] == 1
    for k, args in enumerate(views[1:]):
        got = graphs.clone_tree(prog.run({}, None, camera_inputs(*args)))
        _check(got, Camera.make(*args, device=card), k)
    torch.cuda.synchronize()


def _orbit_frames(card, made: bool, frames: int = 16) -> list:
    """``frames`` orbit frames of the cell, the camera set by
    ``set_camera`` (``made``) or handed in as ``Camera.make``'s camera of
    the same numbers; each frame's outputs, as copies."""
    from ptrt_tpu_torch import graphs
    from ptrt_tpu_torch.scene.camera import Camera

    cell = cells.load(ORBIT)
    draws = traffic.draws(cell.traffic, SEED)
    sc = scenes.get(cell.config["scene"]).build_program(
        cell.config, draws.scene_seed, card)
    traffic.apply_preset(sc, cell.traffic)
    out = []
    for n in range(frames):
        lookfrom, lookat, fov = traffic.camera_at(cell.traffic, draws, n)
        if made:
            sc.set_camera(lookfrom, lookat, fov=fov)
        else:
            sc.camera = Camera.make(*_set_camera_args(
                lookfrom, lookat, fov, sc.width / sc.height), device=card)
            sc.reset_accumulation()
        sc.frame_count = draws.first_index + n
        rgb8 = sc.render_frame_device()
        out.append(graphs.clone_tree((
            rgb8, sc._denoiser_state, sc.prev_view_proj,
            sc.last_frame.rays_traced)))
    assert sc._programs.made == 1
    return out


@pytest.mark.card
def test_orbit_made_in_the_graph_equals_copied_in(card, plog):
    import torch
    from ptrt_tpu_torch import graphs

    plog.tracing(True)
    made = _orbit_frames(card, True)
    assert plog.camera_frames() == {"made": 16, "copied": 0}
    plog.tracing(False)
    plog.tracing(True)
    copied = _orbit_frames(card, False)
    assert plog.camera_frames() == {"made": 0, "copied": 16}
    torch.cuda.synchronize()
    bits = lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t
    for k, (a, b) in enumerate(zip(made, copied)):
        la, lb = graphs.tree_leaves(a), graphs.tree_leaves(b)
        assert len(la) == len(lb) > 4
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and torch.equal(bits(x), bits(y)), k
    assert math.isfinite(float(made[-1][2].sum()))
