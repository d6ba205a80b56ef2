"""Bloom: soft-knee bright pass, blurred mip chain, upsample-add —
counterpart of ``ptrt_tpu/render/bloom.py``.

A frozen copy of ``ptrt_tpu_torch/render/bloom.py``'s plain version
(``bloom_chain_plain``: the bright pass, the blurred mips, the upsample-add
back to mip 0), which the benchmark's reference runs on every device.  The
bilinear upsample's coordinates come from ``upsample_coords``, computed
once a size on the CPU in float32, as the port computes them.
"""

from __future__ import annotations

import functools

import torch

from benchmark.reference.vec import Vec3

BLOOM_MIP_LEVELS = 6
_W = (0.227027, 0.316216, 0.070270)


def bright_pass(c: Vec3, threshold: float = 1.5, knee: float = 0.5) -> Vec3:
    soft_t = c.max_component() - threshold + knee
    return c * torch.clamp(soft_t / (2.0 * knee) + 0.5, 0.0, 1.0)


def _blur_h(img: Vec3) -> Vec3:
    """5-tap horizontal Gaussian with edge clamp."""

    def chan(a):
        out = a * _W[0]
        for i in (1, 2):
            left = torch.cat([a[:, :1].expand(-1, i), a[:, :-i]], dim=1)
            right = torch.cat([a[:, i:], a[:, -1:].expand(-1, i)], dim=1)
            out = out + (left + right) * _W[i]
        return out

    return img.map(chan)


def _downsample_v(img: Vec3) -> Vec3:
    """Vertical 5-tap Gaussian fused with 2x decimation: rows 2y of
    h // 2, columns ``[:, ::2]``."""
    h = img.x.shape[0]

    def chan(a):
        ys = torch.arange(h // 2, device=a.device) * 2
        out = None
        for j in range(-2, 3):
            term = a.index_select(0, (ys + j).clamp(0, h - 1)) * _W[abs(j)]
            out = term if out is None else out + term
        return out[:, ::2].contiguous()

    return img.map(chan)


def blur_down_plain(img: Vec3) -> Vec3:
    """One mip step: (h, w) -> (h // 2, ceil(w / 2))."""
    return _downsample_v(_blur_h(img))


# -- the chain's shapes and upsample coordinates ------------------------------


def mip_shapes(h: int, w: int) -> list:
    """The (height, width) of each mip of an (h, w) image: up to
    ``BLOOM_MIP_LEVELS``, stopping as the reference does when ``ch // 2``
    or ``cw // 2`` is 0, with ``cw`` halved by floor; a mip itself is
    (h // 2, ceil(w / 2)) of the one before."""
    shapes = []
    ch, cw, ah, aw = h, w, h, w
    for _ in range(BLOOM_MIP_LEVELS):
        if ch // 2 == 0 or cw // 2 == 0:
            break
        ah, aw = ah // 2, (aw + 1) // 2
        shapes.append((ah, aw))
        ch, cw = ch // 2, cw // 2
    return shapes


@functools.lru_cache(maxsize=None)
def upsample_coords(in_n: int, out_n: int):
    """One axis of the bilinear upsample from ``in_n`` to ``out_n``
    samples, on the CPU in float32: (first tap, second tap) clamped into
    the input (int64) and the fraction (float32)."""
    u = (torch.arange(out_n) + 0.5) / out_n * in_n - 0.5
    i0f = torch.floor(u)
    frac = u - i0f
    i1 = (i0f + 1).clamp(0, in_n - 1).long()
    i0 = i0f.clamp(0, in_n - 1).long()
    return i0, i1, frac


_on_device: dict = {}


def _coords(in_n: int, out_n: int, dev):
    """``upsample_coords`` on ``dev``, copied there once."""
    key = ("coords", str(dev), in_n, out_n)
    if key not in _on_device:
        _on_device[key] = tuple(t.to(dev) for t in upsample_coords(in_n,
                                                                   out_n))
    return _on_device[key]


def upsample_bilinear(img: Vec3, out_h: int, out_w: int) -> Vec3:
    """Bilinear upsample with clipped taps, the bloom chain's footprint."""
    in_h, in_w = img.x.shape
    dev = img.x.device
    x0, x1, uf = _coords(in_w, out_w, dev)
    y0, y1, vf = _coords(in_h, out_h, dev)

    def chan(a):
        r0, r1 = a.index_select(0, y0), a.index_select(0, y1)
        a00, a10 = r0.index_select(1, x0), r0.index_select(1, x1)
        a01, a11 = r1.index_select(1, x0), r1.index_select(1, x1)
        top = a00 + (a10 - a00) * uf[None, :]
        bot = a01 + (a11 - a01) * uf[None, :]
        return top + (bot - top) * vf[:, None]

    return img.map(chan)


# -- the chain ----------------------------------------------------------------


def bloom_chain_plain(hdr: Vec3, threshold: float = 1.5, knee: float = 0.5,
                      composite: bool = False):
    """Plain version of ``bloom_chain`` (on any device): the reference's
    operations in the same order, with the same results."""
    h, w = hdr.x.shape
    if not mip_shapes(h, w):
        return [], None, (hdr if composite else None)
    cur = bright_pass(hdr, threshold, knee)
    mips = []
    for _ in mip_shapes(h, w):
        cur = blur_down_plain(cur)
        mips.append(cur)
    top = mips[-1]
    for i in range(len(mips) - 2, -1, -1):
        th, tw = mips[i].x.shape
        top = mips[i] + upsample_bilinear(top, th, tw)
    out = hdr + upsample_bilinear(top, h, w) if composite else None
    return mips, top, out


def bloom_mips(hdr: Vec3, threshold: float = 1.5,
               knee: float = 0.5) -> Vec3 | None:
    """Mip 0 after the upsample-add chain, for the tonemap's composite;
    None where the image has no mip."""
    return bloom_chain_plain(hdr, threshold, knee)[1]


