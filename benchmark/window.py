"""The window's arithmetic and the harness's spans.

A frame is presented when the host has waited for its RGB8 copy.  The
window opens at the first present of the measured loop and takes every
frame presented until ``seconds`` have passed since (the present that
crosses the mark included).  ``frame_ms`` is the window's length over
the frames presented in it; ``frame_ms_p95`` the 95th percentile of the
present-to-present intervals (numpy's linear interpolation)."""

from __future__ import annotations

import time
from contextlib import contextmanager

import numpy as np


def frame_ms(presents: list) -> float:
    """The window's milliseconds a frame: ``presents[0]`` opens it, each
    later present is a frame of it."""
    if len(presents) < 2:
        raise ValueError("a window needs two presents or more")
    return 1e3 * (presents[-1] - presents[0]) / (len(presents) - 1)


def frame_ms_p95(presents: list, frames: list | None = None,
                 skip=range(0)) -> float:
    """The 95th percentile of the present-to-present intervals, ms.
    ``frames`` gives the frame each present shows; an interval that ends
    at a frame in ``skip`` is left out."""
    if len(presents) < 2:
        raise ValueError("a window needs two presents or more")
    ms = 1e3 * np.diff(np.asarray(presents))
    if frames is not None:
        ms = ms[np.asarray([f not in skip for f in frames[1:]], dtype=bool)]
    return float(np.percentile(ms, 95))


class Spans:
    """The harness's host spans: (name, start s, end s) on the
    ``time.perf_counter`` clock.  While ``profiling`` is set, each span is
    also a torch.profiler range of its name."""

    def __init__(self):
        self.spans = []
        self.profiling = False

    @contextmanager
    def span(self, name: str):
        rf = None
        if self.profiling:
            import torch

            rf = torch.profiler.record_function(name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))
            if rf is not None:
                rf.__exit__(None, None, None)

    def seconds(self, name: str) -> list:
        return [e - s for n, s, e in self.spans if n == name]
