"""The post kernels' share of their byte bound: the bytes they must move
(``bounds/post.json``: each input plane read once, each output plane
written once, at the cell's frame size) over the HBM peak
(``peaks.json``), against their device time in the profiled stretch, %.
None where a post kernel has no formula."""

import json
import os

from benchmark.trace import base_name, bucket_of, layer_maps

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(name):
    with open(os.path.join(HERE, name)) as f:
        return json.load(f)


def read(run):
    p = run.profile
    if p is None:
        return None
    maps = layer_maps()
    formulas = _json("bounds/post.json")["kernels"]
    peak = _json("peaks.json")["hbm_bytes_per_s"]
    rh, rw = run.render_size
    h, w = run.size
    bloom = bool(run.cell.traffic["preset"].get("enable_bloom"))
    px = {"per_render_px": rh * rw, "per_display_px": h * w,
          "per_bloom_px": (rh // 2) * ((rw + 1) // 2) if bloom else 0}
    nbytes = us = 0.0
    for name, _, t in p.ops:
        if bucket_of(name, maps)[0] != "post_ms":
            continue
        f = formulas.get(base_name(name))
        if f is None:
            return None
        nbytes += sum(f.get(k, 0) * n for k, n in px.items())
        us += t
    if not us:
        return None
    return 100.0 * (nbytes / peak) / (us / 1e6)
