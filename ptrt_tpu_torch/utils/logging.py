"""Structured logging and frame statistics.

Counterpart of ``ptrt_tpu/utils/logging.py``: a leveled structured logger
(``PTRT_LOG_LEVEL``, ``PTRT_LOG_JSON=1`` for one JSON object a line, both to
standard error), a ``FrameStats`` accumulator of frame times and rays a
second (host clock: the caller ends each frame after the work it times is
done, on the card after ``torch.cuda.synchronize()``), and a
``torch.profiler`` trace context in place of the reference's
``jax.profiler`` one.

Beyond the reference: spans of the frame loop's host work and a GPU frame
timer, both off until ``tracing(True)``.  ``span(name)`` times a stretch
of host code on ``time.perf_counter`` (inside ``profiler_trace`` it is
also a ``torch.profiler`` range of its name); ``gpu_frame(device)`` puts a
pair of timing CUDA events around a frame's program runs on the card,
read back by ``gpu_frames()`` once the caller has synchronized;
``camera_frame(how)`` counts the frames by how their programs took the
camera, read by ``camera_frames()``.  No span opens inside a captured
body: a replay runs no Python, so one there would time the capture alone.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass, field

from ptrt_tpu_torch.build import REPO_ROOT

_LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}
_level = _LEVELS.get(os.environ.get("PTRT_LOG_LEVEL", "info"), 20)
_json_mode = os.environ.get("PTRT_LOG_JSON", "") == "1"

# where profiler_trace writes by default: a git-ignored directory of the
# checkout
PROFILE_DIR = os.path.join(REPO_ROOT, "build", "profile")


def log(level: str, event: str, **fields) -> None:
    if _LEVELS.get(level, 20) < _level:
        return
    if _json_mode:
        rec = {"ts": round(time.time(), 3), "level": level, "event": event}
        rec.update(fields)
        print(json.dumps(rec), file=sys.stderr)
    else:
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        print(f"[ptrt:{level}] {event} {kv}", file=sys.stderr)


def debug(event: str, **fields) -> None:
    log("debug", event, **fields)


def info(event: str, **fields) -> None:
    log("info", event, **fields)


def warn(event: str, **fields) -> None:
    log("warn", event, **fields)


def error(event: str, **fields) -> None:
    log("error", event, **fields)


@dataclass
class FrameStats:
    """Rolling per-frame statistics (frame time, rays/s, accumulation)."""

    window: int = 60
    frames: int = 0
    total_rays: float = 0.0
    _times: list = field(default_factory=list)
    _rays: list = field(default_factory=list)
    _t_last: float = 0.0

    def begin_frame(self) -> None:
        self._t_last = time.perf_counter()

    def end_frame(self, rays_traced: float = 0.0) -> None:
        dt = time.perf_counter() - self._t_last
        self._times.append(dt)
        self._rays.append(rays_traced)
        if len(self._times) > self.window:
            self._times.pop(0)
            self._rays.pop(0)
        self.frames += 1
        self.total_rays += rays_traced

    @property
    def fps(self) -> float:
        if not self._times:
            return 0.0
        return len(self._times) / max(sum(self._times), 1e-9)

    @property
    def mrays_per_sec(self) -> float:
        if not self._times:
            return 0.0
        return sum(self._rays) / max(sum(self._times), 1e-9) / 1e6

    @property
    def frame_ms(self) -> float:
        if not self._times:
            return 0.0
        return 1000.0 * sum(self._times) / len(self._times)

    def summary(self) -> dict:
        return {
            "frames": self.frames,
            "fps": round(self.fps, 2),
            "frame_ms": round(self.frame_ms, 2),
            "mrays_per_sec": round(self.mrays_per_sec, 2),
            "total_rays": self.total_rays,
        }


# -- tracing ---------------------------------------------------------------
# the buffers are bounded: a game left running with tracing on keeps the
# newest spans and frames
SPANS_KEPT = 1 << 16
FRAMES_KEPT = 1 << 14

_tracing = False
_profiling = False  # inside profiler_trace
_spans = collections.deque(maxlen=SPANS_KEPT)  # (name, start s, end s)
_frames = collections.deque(maxlen=FRAMES_KEPT)  # (start s, end s, events)
_cameras = collections.Counter()  # frames by how they took their camera


def tracing(on: bool) -> None:
    """Turn the recording of spans, GPU frames and camera counts on
    (emptying them) or off; it is off until this is called."""
    global _tracing
    if on and not _tracing:
        _spans.clear()
        _frames.clear()
        _cameras.clear()
    _tracing = bool(on)


class _NoSpan:
    """What ``span`` and ``gpu_frame`` return while tracing is off: one
    shared object that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "start", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = None
        if _profiling:
            import torch

            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _spans.append((self.name, self.start, time.perf_counter()))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A context that records (``name``, start, end) on
    ``time.perf_counter`` while tracing is on; ``NO_SPAN`` while off."""
    return _Span(name) if _tracing else NO_SPAN


def spans() -> list:
    """The recorded spans, (name, start s, end s), in the order they
    ended (an inner span before the one around it)."""
    return list(_spans)


class _GpuFrame:
    __slots__ = ("stream", "events", "t0")

    def __init__(self, device):
        import torch

        self.stream = torch.cuda.current_stream(device)
        self.events = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))

    def __enter__(self):
        self.events[0].record(self.stream)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.events[1].record(self.stream)
        _frames.append((self.t0, time.perf_counter(), self.events))
        return False


def gpu_frame(device):
    """A context around the program runs of one frame (the frame
    program's, or the chunk programs' and the post program's): while
    tracing is on and ``device`` is a card, a timing CUDA event is recorded
    on its current stream at each end and the pair kept with the frame's
    host time; ``NO_SPAN`` otherwise.  Nothing is read back here."""
    if not _tracing or device.type != "cuda":
        return NO_SPAN
    return _GpuFrame(device)


def gpu_frames() -> list:
    """(host start s, host end s, device ms between the pair's events) of
    each recorded frame, oldest first: a game's "GPU frame ms" beside
    its CPU frame time.  Call after synchronizing the card (an event not
    yet reached raises)."""
    return [(t0, t1, a.elapsed_time(b)) for t0, t1, (a, b) in _frames]


def camera_frame(how: str) -> None:
    """Count one frame of ``Scene.render_frame_device``'s programs, while
    tracing is on, by how they took its camera: "made" (in their graphs,
    from the host inputs of ``set_camera`` they staged) or "copied" (a
    Camera of tensors read from their buffers, the leaves that changed
    copied in)."""
    if _tracing:
        _cameras[how] += 1


def camera_frames() -> dict:
    """The frames counted by ``camera_frame`` since tracing was turned on:
    {"made": n, "copied": n}."""
    return {how: _cameras[how] for how in ("made", "copied")}


@contextlib.contextmanager
def profiler_trace(logdir: str = PROFILE_DIR):
    """A ``torch.profiler`` scope over the host and, where there is one, the
    card; on exit it writes a Chrome trace (``trace.json``, open it in
    Perfetto or chrome://tracing) under ``logdir``.  Yields the profiler
    (``key_averages()`` for sums by kernel).  While tracing is on, each
    span inside it is also a range of its name in the trace."""
    global _profiling
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        _profiling = True
        try:
            yield prof
        finally:
            _profiling = False
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
