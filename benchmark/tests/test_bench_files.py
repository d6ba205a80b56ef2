"""BENCHMARK.json and every file it names parse and fit together."""

import importlib
import json
import os
import re

import pytest

from benchmark import cells, metrics, trace

ROOT = cells.ROOT
HERE = cells.HERE
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}$")


def spec():
    return cells.spec()


def test_top_level_keys():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["benchmark"]
    assert 1 <= s["run_seconds"] <= 51
    assert os.path.getsize(cells.SPEC) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names(kind):
    names = [e["name"] for e in spec()[kind]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_every_config_parses_and_is_used():
    s = spec()
    used = {w["config"] for w in s["workloads"]}
    for c in s["configs"]:
        assert c["name"] in used
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"]
        assert c["file"].startswith("benchmark/")
        importlib.import_module(f"benchmark.scenes.{conf['scene']}")
        for key in ("width", "height", "target_tris"):
            assert isinstance(conf[key], int)
        # every key changed from the source is a key of the file, and the
        # file says in place of what
        for key in c["reduced"]:
            assert key in conf, key
            assert any(a.startswith(key + ":") for a in conf["assumed"]), key


@pytest.mark.parametrize("name", [w["name"] for w in cells.spec()["workloads"]])
def test_every_workload_loads(name):
    cell = cells.load(name)
    assert cell.chips == 1
    t = cell.traffic
    for key in ("preset", "camera", "frame_index_start_below", "warm_frames",
                "profiled_frames", "check"):
        assert key in t, key
    assert t["check"]["frame_after"] < t["check"]["frame_before"]
    assert set(cell.limits["limits"]) >= {"trace_bad_pct", "gbuf_bad_pct",
                                          "rays_err_pct", "rgb8_diff_pct"}
    if t["preset"]["enable_denoiser"]:
        assert {"history_err", "history_restarted"} <= set(
            cell.limits["limits"])


def test_every_metric_has_a_reader_and_a_unit():
    s = spec()
    for m in s["end_to_end"] + s["per_layer"]:
        assert callable(metrics.reader(m["name"]).read)
        assert UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in s["end_to_end"])


def test_every_per_layer_metric_moves_what_its_cells_report():
    s = spec()
    e2e = {m["name"]: m for m in s["end_to_end"]}
    for m in s["per_layer"]:
        target = e2e[m["moves"]]
        for w in m.get("workloads", [x["name"] for x in s["workloads"]]):
            assert "workloads" not in target or w in target["workloads"]


def test_every_layer_file_parses():
    maps = trace.layer_maps()
    metrics = {m["metric"] for m in maps}
    assert metrics == {"walk_ms", "shade_ms", "post_ms", "glue_ms"}
    assert sum(1 for m in maps if m.get("rest")) == 1
    per_layer = {m["name"] for m in spec()["per_layer"]}
    assert metrics <= per_layer
