"""The four device buckets cover every device operation once, and their sum
is the device time; the idle share and gaps of a synthetic trace."""

import json
import os

import pytest

from benchmark import trace

NAMES = os.path.join(os.path.dirname(__file__), "kernel_names.json")


def names():
    with open(NAMES) as f:
        return json.load(f)


def test_recorded_names_land_in_one_bucket_each():
    maps = trace.layer_maps()
    seen = {}
    for n in names():
        metric, mapped = trace.bucket_of(n, maps)
        assert mapped, f"no layer file maps {n!r}"
        seen[n] = metric
    by = lambda m: {n for n, v in seen.items() if v == m}
    assert {trace.base_name(n) for n in by("walk_ms")} == {
        "closest_hit_kernel", "any_hit_kernel"}
    assert {trace.base_name(n) for n in by("shade_ms")} == {
        "shade_nee_kernel", "shade_nee_kernel_hdri", "shade_scatter_kernel"}
    assert {trace.base_name(n) for n in by("post_ms")} == {
        "motion_vectors_kernel", "bloom_chain_kernel", "tonemap_rgb8_kernel",
        "svgf_atrous_kernel", "svgf_firefly_kernel", "svgf_temporal_kernel",
        "svgf_variance_kernel"}


def test_base_names():
    assert trace.base_name("void (anonymous namespace)::shade_scatter_kernel"
                           "<4, true>(ShadeArgs)") == "shade_scatter_kernel"
    assert trace.base_name("(anonymous namespace)::any_hit_kernel("
                           "(anonymous namespace)::WalkArgs)") == \
        "any_hit_kernel"
    assert trace.base_name("Memcpy DtoH (Device -> Pinned)") == \
        "Memcpy DtoH"


def test_buckets_sum_to_the_device_time():
    ops, t = [], 0.0
    for k, n in enumerate(names() + ["some_new_kernel(int)"]):
        ops.append((n, t, 1.0 + k % 7))
        t += 3.0 + k % 7
    p = trace.Profile(frames=2, ops=ops, spans=[]).reduce(trace.layer_maps())
    total_ms = sum(us for _, _, us in ops) / 1e3 / 2
    assert sum(p.buckets_ms.values()) == pytest.approx(total_ms)
    assert p.unmapped == ["some_new_kernel(int)"]
    assert p.launches == sum(1 for n, _, _ in ops
                             if not n.startswith(("Memcpy", "Memset")))


def test_idle_share_and_gaps():
    ops = [("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 20.0, 5.0),
           ("d", 40.0, 10.0)]
    spans = [("frame.enqueue", 14.0, 24.0), ("camera.update", 24.0, 45.0)]
    p = trace.Profile(frames=1, ops=ops, spans=spans).reduce(
        trace.layer_maps())
    assert p.window_us == 50.0
    assert p.busy_us == 30.0
    assert p.idle_gaps == [["camera.update", 15e-6],
                           ["frame.enqueue", 5e-6]]
