"""A traced run's device trace, reduced: torch.profiler over a stretch of
the window's frames gives every device operation with its full name,
start and length; ``layers/*.json`` map names to the layers' buckets.

``Profile`` holds the operations of the stretch, the harness's spans the
profiler recorded on the host, the device's busy time (the union of the
operations' intervals) and the stretch's length (first operation's start
to the last one's end), the device time a frame of each bucket, the names
no layer file maps, and the breakdown the result line carries: the
operations with the most device time and the longest idle gaps by the
harness span the host was in when each began."""

from __future__ import annotations

import glob
import json
import os
import re
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))


def base_name(name: str) -> str:
    """A device operation's name without its return type, namespace noise,
    template arguments and parameters: ``void shade_scatter_kernel<1,
    true>(ShadeArgs)`` -> ``shade_scatter_kernel``."""
    n = name.replace("(anonymous namespace)::", "")
    if n.startswith("void "):
        n = n[5:]
    n = re.split(r"[<(]", n, maxsplit=1)[0]
    return n.strip()


def layer_maps() -> list:
    """Every ``layers/*.json``: {"metric", "layer", "kernels" (regular
    expressions over ``base_name``), optional "rest": this bucket takes
    the names no file maps}."""
    out = []
    for path in sorted(glob.glob(os.path.join(HERE, "layers", "*.json"))):
        with open(path) as f:
            m = json.load(f)
        m["patterns"] = [re.compile(p) for p in m["kernels"]]
        out.append(m)
    return out


def bucket_of(name: str, maps: list) -> tuple:
    """(the metric of the one layer file whose patterns match ``name``, or
    of the "rest" file where none does; whether a file matched).  Raises
    where two files match."""
    b = base_name(name)
    hits = [m["metric"] for m in maps
            if any(p.fullmatch(b) for p in m["patterns"])]
    if len(hits) > 1:
        raise ValueError(f"{name!r} is in the layers {hits}")
    if hits:
        return hits[0], True
    rest = [m["metric"] for m in maps if m.get("rest")]
    return rest[0], False


def union_us(intervals: list) -> tuple:
    """(busy us, idle gaps as (start, length) us) of [(start, end)]."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s - cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


@dataclass
class Profile:
    frames: int
    ops: list  # (name, start us, length us)
    spans: list  # (name, start us, end us) of the harness on the host
    busy_us: float = 0.0
    window_us: float = 0.0
    buckets_ms: dict = field(default_factory=dict)  # metric -> ms a frame
    unmapped: list = field(default_factory=list)
    launches: int = 0
    top: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    def reduce(self, maps: list) -> "Profile":
        total = {m["metric"]: 0.0 for m in maps}
        by_name = {}
        unmapped = set()
        for name, _, us in self.ops:
            metric, mapped = bucket_of(name, maps)
            total[metric] += us
            by_name[name] = by_name.get(name, 0.0) + us
            if not mapped:
                unmapped.add(name)
        self.buckets_ms = {k: v / 1e3 / self.frames for k, v in total.items()}
        self.unmapped = sorted(unmapped)
        self.launches = sum(1 for name, _, _ in self.ops
                            if not name.startswith(("Memcpy", "Memset")))
        self.top = [[n, us / 1e6] for n, us in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]]
        iv = [(s, s + us) for _, s, us in self.ops]
        self.busy_us, gaps = union_us(iv)
        self.window_us = (max(e for _, e in iv) - min(s for s, _ in iv)
                          if iv else 0.0)
        named = []
        for start, length in sorted(gaps, key=lambda g: -g[1])[:10]:
            # the innermost harness span the host was in as the gap began
            inside = [(e - s, n) for n, s, e in self.spans if s <= start < e]
            named.append([min(inside)[1] if inside else "outside a span",
                          length / 1e6])
        self.idle_gaps = named
        return self


def profiled(step, frames: int, span_names: set) -> Profile:
    """Run ``step(i)`` for ``i`` in ``range(frames)`` under torch.profiler
    (the card synchronised before and after) and collect its device
    operations and the host ranges named in ``span_names``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(frames):
            step(i)
        torch.cuda.synchronize()
    ops, spans = [], []
    for e in prof.events():
        tr = e.time_range
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            if e.name in span_names:
                continue  # the device-side copy of a host range
            ops.append((e.name, float(tr.start), float(tr.elapsed_us())))
        elif e.name in span_names:
            spans.append((e.name, float(tr.start), float(tr.end)))
    return Profile(frames=frames, ops=ops, spans=spans)
