"""Bloom: soft-knee bright pass, blurred mip chain, upsample-add —
counterpart of ``ptrt_tpu/render/bloom.py``.

Each mip step (5-tap horizontal Gaussian with edge clamp, then the
vertical 5-tap Gaussian fused with the 2x decimation) is ``blur_down``,
which launches the hand-written ``bloom_blur_down`` kernel
(``csrc/bloom.cu``) for CUDA tensors and runs ``blur_down_plain`` for CPU
tensors.  The bright pass and the bilinear upsample-add are plain torch.
"""

from __future__ import annotations

import torch

from ptrt_tpu_torch import kernels
from ptrt_tpu_torch.core.vec import Vec3

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
    """Plain version of ``bloom_blur_down``."""
    return _downsample_v(_blur_h(img))


def blur_down(img: Vec3) -> Vec3:
    """One mip step (``bloom_blur_down``): (h, w) -> (h // 2, ceil(w / 2))."""
    dev = img.x.device
    kernels.require_supported(dev)
    for name, c in (("img.x", img.x), ("img.y", img.y), ("img.z", img.z)):
        kernels.check_tensor(name, c, torch.float32, 2, dev)
        if c.shape != img.x.shape:
            raise ValueError(f"{name}: shape {tuple(c.shape)} != "
                             f"{tuple(img.x.shape)}")
    if dev.type == "cpu":
        return blur_down_plain(img)
    h, w = img.x.shape
    out = torch.empty((3, h // 2, (w + 1) // 2), dtype=torch.float32,
                      device=dev)
    rc = kernels.get_lib().ptrt_bloom_blur_down(
        img.x.data_ptr(), img.y.data_ptr(), img.z.data_ptr(), h, w,
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        kernels.stream_ptr(dev))
    kernels.launches["bloom_blur_down"] += 1
    kernels.check(rc, "bloom_blur_down")
    return Vec3(out[0], out[1], out[2])


def _upsample_bilinear(img: Vec3, out_h: int, out_w: int) -> Vec3:
    """Bilinear upsample with clipped taps, the bloom chain's footprint."""
    in_h, in_w = img.x.shape
    dev = img.x.device
    u = (torch.arange(out_w, device=dev) + 0.5) / out_w * in_w - 0.5
    v = (torch.arange(out_h, device=dev) + 0.5) / out_h * in_h - 0.5
    x0f, y0f = torch.floor(u), torch.floor(v)
    uf, vf = u - x0f, v - y0f
    x1 = (x0f + 1).clamp(0, in_w - 1).long()
    y1 = (y0f + 1).clamp(0, in_h - 1).long()
    x0 = x0f.clamp(0, in_w - 1).long()
    y0 = y0f.clamp(0, in_h - 1).long()

    def chan(a):
        r0, r1 = a.index_select(0, y0), a.index_select(0, y1)
        a00, a10 = r0.index_select(1, x0), r0.index_select(1, x1)
        a01, a11 = r1.index_select(1, x0), r1.index_select(1, x1)
        top = a00 + (a10 - a00) * uf[None, :]
        bot = a01 + (a11 - a01) * uf[None, :]
        return top + (bot - top) * vf[:, None]

    return img.map(chan)


def apply_bloom(hdr: Vec3, threshold: float = 1.5, knee: float = 0.5) -> Vec3:
    """The full bloom: bright pass, up to six mips, upsample-add from the
    coarsest mip back onto the image."""
    h, w = hdr.x.shape
    cur = bright_pass(hdr, threshold, knee)
    mips = []
    ch, cw = h, w
    for _ in range(BLOOM_MIP_LEVELS):
        nh, nw = ch // 2, cw // 2
        if nh == 0 or nw == 0:
            break
        cur = blur_down(cur)
        mips.append(cur)
        ch, cw = nh, nw
    if not mips:
        return hdr
    for i in range(len(mips) - 2, -1, -1):
        th, tw = mips[i].x.shape
        mips[i] = mips[i] + _upsample_bilinear(mips[i + 1], th, tw)
    return hdr + _upsample_bilinear(mips[0], h, w)
