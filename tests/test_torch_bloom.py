"""The bloom chain and the K6 tonemap with its composite, on the CPU.

On the card the bloom is one launch (``bloom_chain``) and K6 adds the
chain's mip 0 to the image itself; here every entry runs its plain version,
which must be the reference's operations in the same order:

- the plain chain and ``apply_bloom`` are bit-identical, and within rtol
  1e-5 (atol 1e-6) of ``ptrt_tpu.render.bloom.apply_bloom``, as
  ``test_torch_post.test_apply_bloom`` holds it;
- the upsample coordinates, computed once a size on the CPU, equal what
  the inline formula gives (the one ``render/bloom.py`` used before the
  tables), and so does the upsample;
- ``tonemap_rgb8_plain(hdr, s, bloom=m)`` is bit-identical to
  ``tonemap_rgb8_plain(hdr + up(m), s)`` and matches the reference's
  ``tonemap_to_rgb8(apply_bloom(.))`` as
  ``test_torch_kernels_cpu.test_tonemap_plain_matches_reference`` does;
- a CPU ``Scene`` with bloom on renders, at scale 1.0 (K6 composites) and
  0.5 (the chain composites, then the upscale), the bytes of the unfused
  composition;
- the chain's launch plan (mip shapes, tiles, grid, the regions a mip-0
  tile's upsample-add reads) and the encode table K6 reads.

The reference runs jitted, one program a size; this file runs in ~15 s
on one CPU core.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ptrt_tpu.core.vec import Vec3 as RefVec3
from ptrt_tpu.render import bloom as ref_bloom
from ptrt_tpu.render.pipeline import tonemap_to_rgb8 as ref_tonemap

from ptrt_tpu_torch.app.bench_scene import build_bench_scene
from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.render import bloom, pipeline
from test_torch_shading import torch_one_thread  # noqa: F401

SIZES = [(5, 7), (33, 60), (67, 45), (48, 64), (3, 7), (2, 3), (1, 1)]
# the reference, jitted: one XLA program a size compiles in ~1-2 s, where
# eager calls compile each of its ~150 operations
_ref_apply_bloom = jax.jit(lambda a: ref_bloom.apply_bloom(RefVec3(*a)))
_ref_bloom_rgb8 = jax.jit(lambda a: ref_tonemap(
    ref_bloom.apply_bloom(RefVec3(*a)), 1))


def _hdr(h, w, seed):
    r = np.random.default_rng(seed)
    a = r.lognormal(-1.0, 1.2, (3, h, w)).astype(np.float32)
    a[:, h // 3, w // 4] = 40.0  # a hot spot
    return a


def _pv(a):
    return Vec3(*[torch.from_numpy(np.ascontiguousarray(c)) for c in a])


def _np(v):
    return np.stack([c.numpy() for c in (v.x, v.y, v.z)])


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip((a.x, a.y, a.z),
                                                 (b.x, b.y, b.z)))


def _ref_mips(h, w):
    """The reference's loop: the mips ``apply_bloom`` makes of (h, w)."""
    out, ch, cw, cur = [], h, w, np.zeros((h, w), np.float32)
    for _ in range(ref_bloom.BLOOM_MIP_LEVELS):
        if ch // 2 == 0 or cw // 2 == 0:
            break
        cur = cur[0:2 * (ch // 2):2, ::2]
        out.append(cur.shape)
        ch, cw = ch // 2, cw // 2
    return out


@pytest.mark.parametrize("shape", SIZES)
def test_plain_chain_is_apply_bloom_and_the_reference(shape):
    a = _hdr(*shape, 5)
    hdr = _pv(a)
    mips, top, out = bloom.bloom_chain(hdr, composite=True)
    assert [tuple(m.x.shape) for m in mips] == bloom.mip_shapes(*shape) \
        == _ref_mips(*shape)
    got = bloom.apply_bloom(hdr)
    assert _equal(got, out) and _equal(got, bloom.apply_bloom_plain(hdr))
    pm, pt, po = bloom.bloom_chain_plain(hdr, composite=True)
    assert len(pm) == len(mips) and all(map(_equal, pm, mips))
    assert (pt is top is None or _equal(pt, top)) and _equal(po, out)
    ref = _ref_apply_bloom(tuple(jnp.asarray(c) for c in a))
    want = np.stack([np.asarray(c) for c in (ref.x, ref.y, ref.z)])
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-6)
    if not mips:
        assert top is None and bloom.bloom_mips(hdr) is None
        return
    assert _equal(bloom.bloom_mips(hdr), top)
    # the chain: mip 0 after the upsample-add, then the composite
    assert _equal(out, hdr + bloom.upsample_bilinear(top, *shape))
    assert not np.allclose(_np(got), a)  # the glow is there


def _inline_coords(in_n, out_n):
    """The coordinates as ``_upsample_bilinear`` computed them inline."""
    u = (torch.arange(out_n) + 0.5) / out_n * in_n - 0.5
    x0f = torch.floor(u)
    return (x0f.clamp(0, in_n - 1).long(), (x0f + 1).clamp(0, in_n - 1).long(),
            u - x0f)


@pytest.mark.parametrize("in_n,out_n", [(1, 2), (2, 5), (16, 33), (67, 135),
                                        (30, 60), (540, 1080), (960, 1920)])
def test_upsample_coords_are_the_inline_ones(in_n, out_n):
    for got, want in zip(bloom.upsample_coords(in_n, out_n),
                         _inline_coords(in_n, out_n)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    table = bloom.axis_table(in_n, out_n, "cpu")
    i0, i1, frac = bloom.upsample_coords(in_n, out_n)
    assert table.dtype == torch.int32 and table.shape == (3, out_n)
    assert torch.equal(table[0].long(), i0) and torch.equal(
        table[1].long(), i1)
    assert torch.equal(table[2].view(torch.float32), frac)
    # and the upsample itself, against the inline version of it
    img = _pv(_hdr(in_n, 3, 6))
    x0, x1, uf = _inline_coords(3, 3)
    y0, y1, vf = _inline_coords(in_n, out_n)
    a = img.x
    r0, r1 = a.index_select(0, y0), a.index_select(0, y1)
    top = r0.index_select(1, x0) + (r0.index_select(1, x1)
                                    - r0.index_select(1, x0)) * uf[None, :]
    bot = r1.index_select(1, x0) + (r1.index_select(1, x1)
                                    - r1.index_select(1, x0)) * uf[None, :]
    want = top + (bot - top) * vf[:, None]
    assert torch.equal(bloom.upsample_bilinear(img, out_n, 3).x, want)


@pytest.mark.parametrize("shape", [(48, 64), (33, 60), (5, 7)])
def test_tonemap_with_bloom_is_the_composite(shape):
    a = _hdr(*shape, 7)
    hdr = _pv(a)
    m = bloom.bloom_mips(hdr)
    up = bloom.upsample_bilinear(m, *shape)
    got = pipeline.tonemap_rgb8(hdr, 0.7, bloom=m)
    assert torch.equal(got, pipeline.tonemap_rgb8_plain(hdr, 0.7, bloom=m))
    assert torch.equal(got, pipeline.tonemap_rgb8_plain(hdr + up, 0.7))
    assert torch.equal(got, pipeline.tonemap_rgb8(bloom.apply_bloom(hdr),
                                                  0.7))


def test_tonemap_with_bloom_matches_reference():
    a = _hdr(135, 240, 8)
    a[:, :4] = 0.0  # black rows
    a[:, 4:8] *= 1e4  # blown out
    ref = np.asarray(_ref_bloom_rgb8(tuple(jnp.asarray(c) for c in a)))
    hdr = _pv(a)
    got = pipeline.tonemap_rgb8(hdr, 1.0, bloom=bloom.bloom_mips(hdr)).numpy()
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1
    assert (diff.max(-1) == 0).mean() >= 0.999


def test_tonemap_refuses_a_bad_bloom():
    hdr = _pv(_hdr(8, 10, 9))
    m = bloom.bloom_mips(hdr)
    with pytest.raises(TypeError):
        pipeline.tonemap_rgb8(hdr, 1.0, bloom=m.map(lambda c: c.double()))
    with pytest.raises(ValueError):
        pipeline.tonemap_rgb8(hdr, 1.0, bloom=Vec3(m.x, m.y, m.z[:, :1]))


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_scene_renders_the_unfused_composition(scale):
    """Bloom on, denoiser off: at scale 1.0 K6 composites the chain's mip
    0, at 0.5 the chain writes the composite before the upscale; both give
    the bytes of bloom, upscale and tonemap one after another."""
    w, h = 32, 24
    sc = build_bench_scene(w, h, target_tris=500, device="cpu")
    sc.set_performance_preset("balanced")
    sc.perf.samples_per_pixel, sc.perf.max_bounce_depth = 1, 1
    sc.perf.enable_denoiser = False
    sc.perf.resolution_scale = scale
    img = sc.render_frame_device()
    want = bloom.apply_bloom(sc.last_frame.color)
    if scale != 1.0:
        want = pipeline.upscale_bilinear(want, h, w)
    assert torch.equal(img, pipeline.tonemap_rgb8(want, 1.0))


# -- the launch plan ----------------------------------------------------------


@pytest.mark.parametrize("h,w", [(1080, 1920), (810, 1440), (33, 60),
                                 (23, 37), (2, 3)])
def test_every_output_has_one_block(h, w):
    """Each phase's tiles cover its output once; the grid is what the
    busiest phase can use, and no more than the card holds at once."""
    shapes = bloom.mip_shapes(h, w)
    for resident, sms in ((4, 132), (1, 2)):
        launch = bloom.chain_launch(h, w, True, resident, sms)
        busiest = max(b for _, _, b in launch.phases)
        assert launch.grid == min(busiest, resident * sms)
        assert [p[0] for p in launch.phases][:len(shapes)] == [
            f"down {k}" for k in range(len(shapes))]
    for oh, ow in shapes:
        owners = np.zeros((oh, ow), np.int32)
        for i in range(bloom.tiles(oh, ow)):
            rows, cols = bloom.tile_pixels(i, oh, ow)
            owners[np.ix_(list(rows), list(cols))] += 1
        assert (owners == 1).all()


@pytest.mark.parametrize("h,w", [(1080, 1920), (2160, 3840), (810, 1440),
                                 (67, 45), (23, 37), (5, 7)])
def test_upsample_regions_hold_every_tap(h, w):
    """The region of each level that a mip-0 tile reads holds every tap of
    the finer level's region, and fits the kernel's shared memory."""
    shapes = bloom.mip_shapes(h, w)
    rows, cols = bloom.pyramid_regions(h, w)
    for axis, table, tile, most in ((0, rows, bloom.UP_TILE_H,
                                     bloom.REGION_H),
                                    (1, cols, bloom.UP_TILE_W,
                                     bloom.REGION_W)):
        sizes = [s[axis] for s in shapes]
        assert table.shape == (-(-sizes[0] // tile), len(shapes) - 1, 2)
        for j in range(table.shape[0]):
            lo, hi = j * tile, min((j + 1) * tile, sizes[0]) - 1
            for k in range(len(shapes) - 1):
                i0, i1, _ = bloom.upsample_coords(sizes[k + 1], sizes[k])
                first, last = (int(v) for v in table[j, k])
                taps = torch.cat([i0[lo:hi + 1], i1[lo:hi + 1]])
                assert first == int(taps.min()) and last == int(taps.max())
                assert last - first + 1 <= most
                lo, hi = first, last


# -- K6's encode table --------------------------------------------------------


def test_encode_table_is_the_plain_encode():
    """The table's bytes equal the plain encode at every threshold and one
    float either side, and on 10^6 random floats of [0, 1] (random values
    and random bit patterns)."""
    lut = pipeline.encode_lut("cpu")
    t = pipeline.encode_thresholds("cpu")
    assert lut.shape == ((0x3F800000 >> pipeline.LUT_SHIFT) + 1,)
    bits = t[1:].view(torch.int32)
    assert bool((bits[1:] >= bits[:-1]).all())
    for d in (-1, 0, 1):
        v = (bits + d).view(torch.float32).clamp(0.0, 1.0)
        assert torch.equal(pipeline.encode_lut_plain(v, lut),
                           pipeline.encode_plain(v))
    g = torch.Generator().manual_seed(0)
    for v in (torch.rand(500_000, generator=g),
              torch.randint(0, 0x3F800001, (500_000,), generator=g,
                            dtype=torch.int32).view(torch.float32)):
        assert torch.equal(pipeline.encode_lut_plain(v, lut),
                           pipeline.encode_plain(v))
    ends = torch.tensor([0.0, -0.0, 1.0, 0.0031308, 1e-30])
    assert torch.equal(pipeline.encode_lut_plain(ends, lut),
                       pipeline.encode_plain(ends))
