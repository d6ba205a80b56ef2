"""Structured logging and frame statistics.

Counterpart of ``ptrt_tpu/utils/logging.py``: a leveled structured logger
(``PTRT_LOG_LEVEL``, ``PTRT_LOG_JSON=1`` for one JSON object a line, both to
standard error), a ``FrameStats`` accumulator of frame times and rays a
second (host clock: the caller ends each frame after the work it times is
done, on the card after ``torch.cuda.synchronize()``), and a
``torch.profiler`` trace context in place of the reference's
``jax.profiler`` one.
"""

from __future__ import annotations

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


@contextlib.contextmanager
def profiler_trace(logdir: str = PROFILE_DIR):
    """A ``torch.profiler`` scope over the host and, where there is one, the
    card; on exit it writes a Chrome trace (``trace.json``, open it in
    Perfetto or chrome://tracing) under ``logdir``.  Yields the profiler
    (``key_averages()`` for sums by kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
