"""The benchmark's cells, found by name: ``BENCHMARK.json`` at the root of
the checkout names each cell's configuration and traffic mix; the
configuration's file is the one ``BENCHMARK.json`` gives, the traffic mix
is ``traffic/<traffic>.json`` and the cell's limits on the numbers that
decide ``correct`` are ``limits/<cell>.json``."""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SPEC = os.path.join(ROOT, "BENCHMARK.json")


def spec() -> dict:
    with open(SPEC) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of ``workloads`` with what it names loaded."""

    name: str
    chips: int
    config: dict  # the configuration's file
    traffic: dict  # traffic/<traffic>.json
    limits: dict  # limits/<cell>.json
    end_to_end: list  # the end-to-end metrics this cell reports
    per_layer: list  # the per-layer metrics this cell reports


def _reported(metrics: list, cell: str) -> list:
    return [m for m in metrics if "workloads" not in m
            or cell in m["workloads"]]


def load(name: str, overrides: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; ``overrides`` replaces keys
    of its configuration (the CPU tests shrink the frame so)."""
    s = spec()
    work = {w["name"]: w for w in s["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in s["configs"]}[w["config"]]
    config = _json(ROOT, conf["file"])
    config.update(overrides or {})
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=_json(HERE, "traffic", w["traffic"] + ".json"),
                limits=_json(HERE, "limits", name + ".json"),
                end_to_end=_reported(s["end_to_end"], name),
                per_layer=_reported(s["per_layer"], name))
