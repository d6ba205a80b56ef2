"""The frozen post byte formulas at 1080p give the bounds of the kernel
table (PERF.md section 6: bytes over 3.35 TB/s)."""

import json
import os

import pytest

HERE = os.path.dirname(os.path.dirname(__file__))
PX, BLOOM_PX = 1920 * 1080, 540 * 960


def bound_ms(kernel, render=PX, display=PX, bloom=0):
    with open(os.path.join(HERE, "bounds", "post.json")) as f:
        f_ = json.load(f)["kernels"][kernel]
    with open(os.path.join(HERE, "peaks.json")) as f:
        peak = json.load(f)["hbm_bytes_per_s"]
    n = (f_.get("per_render_px", 0) * render
         + f_.get("per_display_px", 0) * display
         + f_.get("per_bloom_px", 0) * bloom)
    return 1e3 * n / peak


@pytest.mark.parametrize("kernel, kw, want", [
    ("svgf_atrous_kernel", {}, 0.0322),
    ("svgf_temporal_kernel", {}, 0.1164),
    ("svgf_variance_kernel", {}, 0.0520),
    ("svgf_firefly_kernel", {}, 0.0396),
    ("motion_vectors_kernel", {}, 0.0074),
    ("tonemap_rgb8_kernel", {}, 0.0093),
    ("tonemap_rgb8_kernel", {"bloom": BLOOM_PX}, 0.0111),
    ("bloom_chain_kernel", {"bloom": BLOOM_PX}, 0.0093),
    ("upscale_bilinear_kernel", {"render": 1440 * 810}, 0.0116),
    ("progressive_average_kernel", {}, 0.0297),
])
def test_bounds_at_1080p(kernel, kw, want):
    assert round(bound_ms(kernel, **kw), 4) == want
