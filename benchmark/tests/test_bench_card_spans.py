"""On the card: the port's spans and GPU frame timer against the device
trace (run there with ``python -m pytest benchmark/tests -q -m card``).

* A program span around ``torch.cuda.synchronize()`` after a ~1 ms kernel,
  mapped onto the profiler's clock by the median offset between the
  harness spans it recorded both ways (``perf_counter`` and a profiler
  range), starts before the kernel and ends after it, within 50 us.
* The GPU frame (the event pair around a frame's program runs) of a
  trace_4spp frame, at the scene's fixed camera, is within 3% of the
  profiled stretch's device ms a frame.
* ``program.capture`` runs once, at a balanced orbit's first frame, and
  never in the orbit after it; ``Programs.made`` does not move there.
* Orbit frames are bit for bit the same with tracing on and off."""

import statistics

import pytest

from benchmark import cells, scenes, trace, traffic, window

SEED = 2718281828
SMALL = {"width": 320, "height": 180, "target_tris": 20000}


@pytest.fixture
def plog():
    from ptrt_tpu_torch.utils import logging

    logging.tracing(False)
    yield logging
    logging.tracing(False)


def _scene(name: str, device, overrides=None):
    cell = cells.load(name, overrides)
    draws = traffic.draws(cell.traffic, SEED)
    sc = scenes.get(cell.config["scene"]).build_program(
        cell.config, draws.scene_seed, device)
    traffic.apply_preset(sc, cell.traffic)
    return sc, cell, draws


def _orbit_frame(sc, cell, draws, n: int):
    lookfrom, lookat, fov = traffic.camera_at(cell.traffic, draws, n)
    sc.set_camera(lookfrom, lookat, fov=fov)
    sc.frame_count = draws.first_index + n
    return sc.render_frame_device()


@pytest.mark.card
def test_program_span_maps_onto_the_device_trace(card, plog):
    import torch

    spans = window.Spans()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    plog.tracing(True)

    def step(i):
        spans.profiling = True
        try:
            with spans.span("frame.enqueue"):
                torch.cuda._sleep(2_000_000)  # ~1 ms at 2 GHz
                with plog.span("program.replay"):
                    torch.cuda.synchronize()
        finally:
            spans.profiling = False

    prof = trace.profiled(step, 5, {"frame.enqueue"})
    # each harness span on both clocks: profiler us less perf_counter us
    assert len(prof.spans) == len(spans.spans) == 5
    both = zip(sorted(prof.spans, key=lambda p: p[1]), spans.spans)
    off = statistics.median(p[1] - 1e6 * h[1] for p, h in both)
    sleeps = sorted((s, s + us) for _, s, us in prof.ops if us > 500.0)
    waits = [(1e6 * s + off, 1e6 * e + off) for n, s, e in plog.spans()
             if n == "program.replay"]
    assert len(sleeps) == len(waits) == 5
    for (ks, ke), (s, e) in zip(sleeps, waits):
        assert s <= ks + 50.0 and e >= ke - 50.0, (ks, ke, s, e)
        assert e - ke < 1000.0


@pytest.mark.card
def test_gpu_frame_is_the_device_time_of_a_trace_frame(card, plog):
    import torch

    sc, _, _ = _scene("bench_scene.trace_4spp", card)
    plog.tracing(True)
    for _ in range(3):  # the capture, then replays
        sc.render_frame_device()
    torch.cuda.synchronize()
    before = len(plog.gpu_frames())
    frames = 8
    prof = trace.profiled(lambda i: sc.render_frame_device(), frames, set())
    gpu = [ms for _, _, ms in plog.gpu_frames()[before:]]
    assert len(gpu) == frames
    # no RGB8 copy to the host here: every operation is the frame's
    device_ms = sum(us for n, _, us in prof.ops
                    if not n.startswith("Memcpy DtoH")) / 1e3 / frames
    assert statistics.median(gpu) == pytest.approx(device_ms, rel=0.03)


@pytest.mark.card
def test_capture_once_and_none_in_an_orbit(card, plog):
    import torch

    sc, cell, draws = _scene("bench_scene.balanced_orbit", card)
    plog.tracing(True)
    _orbit_frame(sc, cell, draws, 0)
    torch.cuda.synchronize()
    first = [n for n, _, _ in plog.spans()]
    assert first.count("program.capture") == 1
    made, seen = sc._programs.made, len(first)
    frames = 40
    for n in range(1, frames + 1):
        _orbit_frame(sc, cell, draws, n)
    torch.cuda.synchronize()
    later = [n for n, _, _ in plog.spans()[seen:]]
    assert "program.capture" not in later
    assert sc._programs.made == made
    for name in ("camera.make", "camera.stage", "camera.math",
                 "frame.select", "program.refresh", "program.stage",
                 "program.replay", "frame.clone"):
        assert later.count(name) == frames, name
    gpu = plog.gpu_frames()
    assert len(gpu) == frames + 1 and all(ms > 0.0 for _, _, ms in gpu)


@pytest.mark.card
def test_frames_equal_with_tracing_on_and_off_on_the_card(card, plog):
    import torch
    from ptrt_tpu_torch import graphs

    out = []
    for on in (False, True):
        plog.tracing(on)
        sc, cell, draws = _scene("bench_scene.balanced_orbit", card, SMALL)
        frames = [_orbit_frame(sc, cell, draws, n) for n in range(4)]
        out.append(graphs.tree_leaves(graphs.clone_tree(
            (frames, sc._rng_state, sc._denoiser_state))))
    torch.cuda.synchronize()
    assert len(out[0]) == len(out[1]) > 6
    assert all(torch.equal(x, y) for x, y in zip(*out))
