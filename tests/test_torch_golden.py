"""The port against the reference's golden-image corpus.

``tests/golden/<name>.npz`` holds the reference's 320x180 render of each of
``tools/make_golden.py``'s eight recipes; ``ptrt_tpu_torch/tools/golden.py``
is the port's copy of those recipes (that tool imports JAX).  Each render
must reach ``tests/test_golden.py``'s 35 dB PSNR against its golden.

Tier-1 runs the four cases that render in under ~10 s on the CPU
(``material_showcase``, ``pt_lit_test``, ``pt_material_matrix``,
``rt_cornell_box``).  The other four (``metal_demo`` and ``glass_demo``
through the plain torch walk: their glass and metal keep many rays alive
for every bounce; the two "balanced" runs: three full frames each) take
minutes on the CPU and are marked ``slow``; ``chip_smoke.py`` renders all
eight on the card.
"""

import numpy as np
import pytest

from ptrt_tpu_torch.tools import golden
from test_torch_shading import torch_one_thread  # noqa: F401

SLOW = ("metal_demo", "glass_demo", "denoised_cornell", "denoised_metal")


@pytest.fixture(scope="module")
def scenes():
    return golden.golden_scenes(golden.GOLDEN_W, golden.GOLDEN_H, "cpu")


@pytest.mark.parametrize("name", [
    pytest.param(n, marks=pytest.mark.slow) if n in SLOW else n
    for n in golden.CASES])
def test_golden(scenes, name):
    want = golden.load_golden(name)
    img = np.asarray(scenes[name]())
    assert img.shape == want.shape and img.dtype == np.uint8
    db = golden.psnr(img, want)
    assert db >= golden.MIN_PSNR, f"{name}: PSNR {db:.1f} dB vs golden"


def test_the_cases_are_the_reference_corpus():
    """The same eight names as tests/test_golden.py, each with its file."""
    import test_golden

    assert tuple(test_golden._CASES) == golden.CASES
    for name in golden.CASES:
        assert golden.load_golden(name).shape == (golden.GOLDEN_H,
                                                  golden.GOLDEN_W, 3)
    assert golden.psnr(np.zeros((2, 2, 3), np.uint8),
                       np.zeros((2, 2, 3), np.uint8)) == 99.0
