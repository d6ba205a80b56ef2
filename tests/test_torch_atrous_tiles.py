"""What the ``svgf_atrous`` wrapper computes in Python before it launches:
the tile of a step, the grid that cuts the image into blocks and the
shared memory a block asks for (``denoiser.atrous_launch``); and the tap
count behind the kernel's bound (``tools/stages.atrous_taps``)."""

import numpy as np
import pytest

from ptrt_tpu_torch.render import denoiser as den
from ptrt_tpu_torch.tools import stages

SIZES = [(1080, 1920), (810, 1440), (23, 37), (1, 1)]


@pytest.mark.parametrize("step", [1, 2, 3, 4, 5, 8, 16])
@pytest.mark.parametrize("h,w", SIZES)
def test_every_pixel_has_one_block(h, w, step):
    launch = den.atrous_launch(h, w, step)
    assert launch.shared_bytes <= den.MAX_SHARED_BYTES == 232_448
    assert launch.shared_bytes == ((launch.tile_h + 4)
                                   * (launch.tile_w + 4 * step)
                                   * den.ATROUS_CELL_BYTES)
    assert (launch.tile_w, launch.tile_h) == den.ATROUS_TILES.get(
        step, den.ATROUS_OTHER_TILE)
    assert 1 <= launch.grid_x and 1 <= launch.grid_y <= 65535
    owners = np.zeros((h, w), np.int32)
    for by in range(launch.grid_y):
        for bx in range(launch.grid_x):
            rows, cols = launch.block_pixels(bx, by, h, w)
            assert len(rows) <= launch.tile_h and len(cols) <= launch.tile_w
            if len(rows) and len(cols):
                # the block's rows lie `step` apart, its columns side by side
                assert all(b - a == step for a, b in zip(rows, rows[1:]))
                owners[np.ix_(list(rows), list(cols))] += 1
    assert (owners == 1).all()


@pytest.mark.parametrize("step", [0, -1])
def test_bad_step_raises(step):
    with pytest.raises(ValueError):
        den.atrous_launch(8, 8, step)


def test_step_too_wide_for_shared_memory_raises():
    tw, th = den.ATROUS_OTHER_TILE
    most = (den.MAX_SHARED_BYTES // (den.ATROUS_CELL_BYTES * (th + 4)) - tw) // 4
    assert den.atrous_launch(64, 64, most).shared_bytes <= den.MAX_SHARED_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        den.atrous_launch(64, 64, most + 1)


@pytest.mark.parametrize("h,w,step", [(1, 1, 1), (5, 7, 1), (9, 4, 2),
                                      (23, 37, 4), (23, 37, 16), (40, 33, 8)])
def test_atrous_taps_is_the_brute_force_count(h, w, step):
    count = sum(1 for y in range(h) for x in range(w)
                for dy in range(-2, 3) for dx in range(-2, 3)
                if 0 <= y - dy * step < h and 0 <= x - dx * step < w)
    assert stages.atrous_taps(h, w, step) == count
