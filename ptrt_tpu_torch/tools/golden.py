"""The golden-image corpus's eight recipes, rendered by the port.

A copy in port terms of ``tools/make_golden.py``'s ``golden_scenes`` (that
tool renders the corpus with the JAX package): three ``UnifiedScenePresets``
averaged over two frames, two PT demo scenes, the RT Cornell box and two
"balanced" runs through the whole frame (split trace, SVGF, bloom,
tonemap).  ``tests/golden/<name>.npz`` holds each reference render at
320x180; the port's must reach ``MIN_PSNR`` against it.  The reference's
presets and demo scenes render with the camera-NEE fix off (reference
content, reference semantics), as the corpus was made.

``tests/test_torch_golden.py`` runs them on the CPU; ``chip_smoke.py``
renders all eight on the card.
"""

from __future__ import annotations

import os

import numpy as np

from ptrt_tpu_torch.build import REPO_ROOT

GOLDEN_DIR = os.path.join(REPO_ROOT, "tests", "golden")
GOLDEN_W, GOLDEN_H = 320, 180
MIN_PSNR = 35.0  # tests/test_golden.py's bound
CASES = ("metal_demo", "glass_demo", "material_showcase", "pt_lit_test",
         "pt_material_matrix", "rt_cornell_box", "denoised_cornell",
         "denoised_metal")


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """tests/test_golden.py's PSNR of two RGB8 images (99 when equal)."""
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return 99.0
    return 10.0 * np.log10(255.0 ** 2 / mse)


def load_golden(name: str) -> np.ndarray:
    return np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))["img"]


def golden_scenes(w: int, h: int, device="cuda") -> dict:
    """{name: a function rendering the case as (h, w, 3) uint8 numpy}."""
    from ptrt_tpu_torch.app.demo_scenes import build_scene_by_id
    from ptrt_tpu_torch.app.rt_demo_scenes import create_cornell_box
    from ptrt_tpu_torch.scene.unified import (UnifiedSceneBuilder,
                                              UnifiedScenePresets)

    def pt_preset(preset_fn, frames=2, depth=4):
        def run():
            sc = UnifiedSceneBuilder.build_pt_scene(preset_fn(w, h), device)
            sc.perf.enable_denoiser = False
            sc.perf.enable_bloom = False
            sc.perf.max_bounce_depth = depth
            sc.perf.samples_per_pixel = 1
            sc.perf.resolution_scale = 1.0
            sc.perf.camera_nee_fix = False
            return sc.render_average(frames)
        return run

    def pt_demo(sid, frames=2):
        def run():
            sc, _ = build_scene_by_id(sid, w, h, device)
            sc.set_performance_preset("fast")
            sc.perf.resolution_scale = 1.0
            sc.perf.max_bounce_depth = 3
            sc.perf.camera_nee_fix = False
            return sc.render_average(frames)
        return run

    def rt_cornell():
        return create_cornell_box(w, h, device).render_frame()

    def denoised(preset_fn):
        def run():
            sc = UnifiedSceneBuilder.build_pt_scene(preset_fn(w, h), device)
            sc.set_performance_preset("balanced")
            sc.perf.resolution_scale = 1.0
            sc.perf.camera_nee_fix = False
            img = None
            for _ in range(3):
                img = sc.render_frame()
            return img
        return run

    return {
        "metal_demo": pt_preset(UnifiedScenePresets.MetalDemo),
        "glass_demo": pt_preset(UnifiedScenePresets.GlassDemo),
        "material_showcase": pt_preset(UnifiedScenePresets.MaterialShowcase),
        "pt_lit_test": pt_demo(0),
        "pt_material_matrix": pt_demo(10),
        "rt_cornell_box": rt_cornell,
        "denoised_cornell": denoised(UnifiedScenePresets.CornellBox),
        "denoised_metal": denoised(UnifiedScenePresets.MetalDemo),
    }
