"""What the ``shade_scatter`` and ``svgf_temporal`` wrappers and their
measurements compute in Python: how ``shade_scatter`` cuts a wavefront
into blocks and what a block stages (``shade.scatter_launch``), the warps a
wavefront's live lanes fill (``tools/stages.live_warps``), the planes a
temporal launch must move (``stages.temporal_bound``), K6's bound beside
its SASS issue time (``stages.tonemap_bound``), and the fact the
temporal kernel builds on: the nearest pixel of its fallback is one of its
four bilinear corners."""

import numpy as np
import pytest
import torch

from ptrt_tpu_torch.render import denoiser as den
from ptrt_tpu_torch.render import shade
from ptrt_tpu_torch.scene.materials import Material, MaterialTable
from ptrt_tpu_torch.tools import stages


def _table(rows: int) -> MaterialTable:
    return MaterialTable.from_materials(
        [Material.make((0.5, 0.5, 0.5)) for _ in range(rows)], "cpu")


@pytest.mark.parametrize("bounce", [0, 1, 3])
@pytest.mark.parametrize("n", [1, 255, 1024, 2_073_600, 16_421])
def test_scatter_blocks_take_every_lane_once(n, bounce):
    launch = shade.scatter_launch(n, _table(17), bounce)
    lanes = 1 if bounce == 0 else shade.SCATTER_LANES
    assert launch.threads == shade.SCATTER_THREADS
    assert launch.chunk == launch.threads * lanes
    taken = np.zeros(n, np.int32)
    for b in range(launch.blocks):
        r = launch.block_lanes(b, n)
        assert 0 < len(r) <= launch.chunk
        taken[r.start:r.stop] += 1
    assert (taken == 1).all()


def test_scatter_stages_the_table_only_when_it_fits():
    small, big = _table(17), _table(400)
    assert shade.scatter_launch(8, small, 1).staged_bytes == (
        small.packed.numel() * 4)
    # the 400-row table of chip_smoke.py's ragged random lanes: read from
    # global memory
    assert big.packed.numel() * 4 > shade.MAX_STAGED_BYTES
    assert shade.scatter_launch(8, big, 1).staged_bytes == 0


@pytest.mark.parametrize("n,chunk,share", [(4096, 1024, 0.1), (2000, 512, 0.6),
                                           (77, 1024, 0.03)])
def test_live_warps_is_the_brute_force_count(n, chunk, share):
    alive = torch.from_numpy(np.random.default_rng(n).random(n) < share)
    a = alive.numpy()
    direct = sum(a[k:k + 32].any() for k in range(0, n, 32))
    packed = sum(-(-int(a[k:k + chunk].sum()) // 32)
                 for k in range(0, n, chunk))
    assert stages.live_warps(alive, chunk) == (direct, packed)


def test_temporal_bound_counts_each_plane_once():
    px = 1080 * 1920
    one = stages.temporal_bound(1080, 1920, [False])
    pair = stages.temporal_bound(1080, 1920, [False, True])
    assert one["bound_by"] == pair["bound_by"] == "bytes"
    # a channel alone: 22 planes read, 7 written; the pair shares 12 of
    # them and the specular channel reads its cap
    assert one["bound_ms"] == pytest.approx(29 * 4 * px / stages.HBM_BYTES_PER_S
                                            * 1e3)
    assert pair["bound_ms"] == pytest.approx(
        (29 + 17 + 1) * 4 * px / stages.HBM_BYTES_PER_S * 1e3)


@pytest.mark.parametrize("bloom", [False, True])
def test_k6_bound_is_its_bytes_not_its_own_sass(bloom):
    """K6's bound is its bytes (its float operations take less); the issue
    time of the kernel's own SASS is reported beside it and never raises
    it, however many instructions the kernel runs."""
    px, mip0 = 1080 * 1920, 540 * 960
    plain = stages.tonemap_bound(1080, 1920, bloom)
    nbytes = 15 * px + (12 * mip0 if bloom else 0)
    assert plain["bound_by"] == "bytes"
    assert plain["bound_ms"] == pytest.approx(
        nbytes / stages.HBM_BYTES_PER_S * 1e3)
    for n in (100, 878, 5000):
        got = stages.tonemap_bound(1080, 1920, bloom, n)
        assert {k: got[k] for k in plain} == plain
        warps = -(-1920 // stages.TONEMAP_PIXELS // 32) * 1080
        assert got["sass_issue_ms"] == pytest.approx(
            warps * n / stages.WARP_ISSUE_PER_S * 1e3)
    names = {"_Z19tonemap_rgb8_kernelILb0ELb0EEEv11TonemapArgs": 10,
             "_Z19tonemap_rgb8_kernelILb1ELb0EEEv11TonemapArgs": 11,
             "_Z19tonemap_rgb8_kernelILb0ELb1EEEv11TonemapArgs": 12,
             "_Z19tonemap_rgb8_kernelILb1ELb1EEEv11TonemapArgs": 13}
    assert stages.tonemap_sass({fn: {"sass": {"body": n}}
                                for fn, n in names.items()}) == {False: 12,
                                                                 True: 13}


def test_nearest_pixel_is_a_bilinear_corner():
    """``clip(floor(p))`` is ``clip(floor(p - 0.5))`` or
    ``clip(floor(p - 0.5) + 1)`` in float32, for any reprojected coordinate
    the motion vectors can give (svgf.cu reads the fallback's and the
    rejection's pixel from the corners it loaded)."""
    r = np.random.default_rng(3)
    n = 64
    p = np.concatenate([
        r.uniform(-3, n + 3, 20_000), np.arange(-4, n + 4, 0.5),
        np.nextafter(np.arange(-4, n + 4, 0.5), np.inf),
        np.nextafter(np.arange(-4, n + 4, 0.5), -np.inf),
        [1e-30, -1e-30, 2.0 ** 23, 2.0 ** 23 + 1, 2.0 ** 24 + 2, 3e38,
         -3e38, np.inf, -np.inf, np.nan]]).astype(np.float32)
    p = torch.from_numpy(p)
    f = p - 0.5
    x0 = torch.floor(f)
    c0, c1 = den._clip_index(x0, n), den._clip_index(x0 + 1.0, n)
    near = den._clip_index(torch.floor(p), n)
    assert bool(((near == c0) | (near == c1)).all())
