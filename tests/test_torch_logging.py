"""``ptrt_tpu_torch/utils/logging.py`` against the reference's module.

The log lines (text and JSON) and ``FrameStats`` (its window, rates and
summary, under one scripted clock given to both modules) must equal the
reference's; ``profiler_trace`` must write a Chrome trace of the ops run
inside it.
"""

import json
import os

import pytest
import torch

from ptrt_tpu.utils import logging as ref_logging

from ptrt_tpu_torch.utils import logging as plog
from test_torch_shading import torch_one_thread  # noqa: F401


@pytest.mark.parametrize("json_mode", [False, True], ids=["text", "json"])
@pytest.mark.parametrize("level", ["debug", "info", "warn", "error"])
def test_log_lines_match_reference(capsys, monkeypatch, json_mode, level):
    for mod in (plog, ref_logging):
        monkeypatch.setattr(mod, "_json_mode", json_mode)
        monkeypatch.setattr(mod, "_level", 10)
        monkeypatch.setattr(mod.time, "time", lambda: 1234.56789)
    lines = []
    for mod in (plog, ref_logging):
        getattr(mod, level)("frame", ms=12.5, rays=1024, scene="bench")
        mod.log(level, "bare")
        lines.append(capsys.readouterr().err)
    assert lines[0] == lines[1] and lines[0].count("\n") == 2
    if json_mode:
        rec = json.loads(lines[0].splitlines()[0])
        assert rec == {"ts": 1234.568, "level": level, "event": "frame",
                       "ms": 12.5, "rays": 1024, "scene": "bench"}


def test_log_level_filters_like_reference(capsys, monkeypatch):
    out = []
    for mod in (plog, ref_logging):
        monkeypatch.setattr(mod, "_level", 30)
        mod.info("hidden")
        mod.warn("shown", k=1)
        out.append(capsys.readouterr().err)
    assert out[0] == out[1] == "[ptrt:warn] shown k=1\n"


def test_frame_stats_match_reference(monkeypatch):
    """Both accumulators under the same scripted clock: 70 frames (past
    the 60-frame window), rays varying, every property after each."""
    ticks = iter([0.5 * k + 0.001 * (k % 7) ** 2 for k in range(1000)])
    now = {"t": 0.0}
    for mod in (plog, ref_logging):
        monkeypatch.setattr(mod.time, "perf_counter", lambda: now["t"])
    ours, ref = plog.FrameStats(), ref_logging.FrameStats()
    assert ours.summary() == ref.summary() and ours.fps == 0.0
    for k in range(70):
        now["t"] = next(ticks)
        for s in (ours, ref):
            s.begin_frame()
        now["t"] += 0.016 + 0.001 * k
        for s in (ours, ref):
            s.end_frame(rays_traced=1e6 * (k % 5 + 1))
        assert (ours.fps, ours.frame_ms, ours.mrays_per_sec) == (
            ref.fps, ref.frame_ms, ref.mrays_per_sec)
        assert ours.summary() == ref.summary()
    assert ours.frames == 70 and len(ours._times) == ours.window == 60


def test_profiler_trace_writes_a_trace(tmp_path):
    logdir = str(tmp_path / "prof")
    with plog.profiler_trace(logdir) as prof:
        x = torch.ones(64, 64)
        (x @ x).sum()
    path = os.path.join(logdir, "trace.json")
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any("mm" in str(n) for n in names), sorted(map(str, names))[:20]
    assert any("mm" in e.key for e in prof.key_averages())
