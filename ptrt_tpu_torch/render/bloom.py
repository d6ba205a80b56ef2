"""Bloom: soft-knee bright pass, blurred mip chain, upsample-add —
counterpart of ``ptrt_tpu/render/bloom.py``.

On the card the chain is one hand-written cooperative launch,
``bloom_chain`` (``csrc/bloom.cu``): the bright pass folded into mip 0,
mips 1-5, and the upsample-add back to mip 0.  ``bloom_mips`` returns that
mip 0 for the K6 tonemap, which adds ``up(mip 0)`` to the image itself
(``pipeline.tonemap_rgb8``); ``apply_bloom`` has the chain write
``hdr + up(mip 0)`` too (the path with an upscale after the bloom).  For
CPU tensors every entry runs its plain version, ``bloom_chain_plain``: the
reference's operations in the same order.

The bilinear upsample's coordinates come from ``upsample_coords``, computed
once a size on the CPU in float32: on the card torch may divide by a scalar
as a multiply by its reciprocal, so coordinates computed there could round
otherwise.  The plain version and the kernels read the same tables, so the
kernels, the plain version on the card and the plain version on the CPU
agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ptrt_tpu_torch import kernels
from ptrt_tpu_torch.core.vec import Vec3

BLOOM_MIP_LEVELS = 6
_W = (0.227027, 0.316216, 0.070270)
# csrc/bloom.cu: threads a block, and the outputs (a thread each) of a mip
# step's tile
THREADS, TILE_W, TILE_H = 256, 32, 8
# csrc/bloom.cu: the upsample-add's tile of mip 0, and the largest region
# of a level that such a tile reads
UP_TILE_W, UP_TILE_H = 64, 16
REGION_H, REGION_W = 12, 40


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


def _check_planes(name: str, v: Vec3, dev) -> None:
    for i, c in enumerate((v.x, v.y, v.z)):
        cname = f"{name}.{'xyz'[i]}"
        kernels.check_tensor(cname, c, torch.float32, 2, dev)
        if c.shape != v.x.shape:
            raise ValueError(f"{cname}: shape {tuple(c.shape)} != "
                             f"{tuple(v.x.shape)}")


def _empty3(shape, dev) -> Vec3:
    buf = torch.empty((3, *shape), dtype=torch.float32, device=dev)
    return Vec3(buf[0], buf[1], buf[2])


def _ptrs(v: Vec3) -> list:
    return [v.x.data_ptr(), v.y.data_ptr(), v.z.data_ptr()]


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


def axis_table(in_n: int, out_n: int, dev) -> torch.Tensor:
    """``upsample_coords`` as the kernels read them: int32 (3, out_n), the
    two taps and the fraction's bits, on ``dev`` (copied there once)."""
    key = ("table", str(dev), in_n, out_n)
    if key not in _on_device:
        i0, i1, frac = upsample_coords(in_n, out_n)
        _on_device[key] = torch.stack(
            [i0.int(), i1.int(), frac.view(torch.int32)]).to(dev)
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


class ChainLaunch(NamedTuple):
    """The chain launch's phases, each with the blocks it could keep busy
    (tiles of a mip step or of mip 0's upsample-add, pixel blocks of the
    composite), and its grid."""

    phases: tuple  # (name, shape of its output, blocks)
    grid: int


def tiles(oh: int, ow: int) -> int:
    """The 32x8-output tiles of an (oh, ow) mip step (one block each)."""
    return -(-ow // TILE_W) * -(-oh // TILE_H)


def tile_pixels(i: int, oh: int, ow: int):
    """Rows and columns of the outputs tile ``i`` of an (oh, ow) mip
    writes (``csrc/bloom.cu`` ``down_level``, ``up_tile``)."""
    tiles_x = -(-ow // TILE_W)
    ty, tx = divmod(i, tiles_x)
    return (range(ty * TILE_H, min((ty + 1) * TILE_H, oh)),
            range(tx * TILE_W, min((tx + 1) * TILE_W, ow)))


def chain_launch(h: int, w: int, composite: bool, resident: int,
                 sms: int) -> ChainLaunch:
    """The phases ``bloom_chain`` runs for an (h, w) image and its grid:
    as many blocks as the busiest phase can use, never more than the card
    holds at once (``resident`` blocks a SM on ``sms`` SMs: the cooperative
    launch refuses more)."""
    shapes = mip_shapes(h, w)
    phases = [(f"down {k}", s, tiles(*s)) for k, s in enumerate(shapes)]
    if len(shapes) > 1:
        mh, mw = shapes[0]
        phases.append(("upsample-add", shapes[0],
                       -(-mh // UP_TILE_H) * -(-mw // UP_TILE_W)))
    if composite:
        phases.append(("composite", (h, w), -(-h * w // THREADS)))
    busiest = max((b for _, _, b in phases), default=0)
    return ChainLaunch(tuple(phases), min(busiest, sms * resident))


@functools.lru_cache(maxsize=None)
def pyramid_regions(h: int, w: int):
    """For each tile row (column) of mip 0, the first and last row (column)
    of each level 1.. that the tile's upsample-add reads, int32 on the CPU
    ([tiles, levels - 1, 2]); raises where a region exceeds the kernel's
    (REGION_H x REGION_W)."""
    shapes = mip_shapes(h, w)
    out = []
    for axis, tile, most in ((0, UP_TILE_H, REGION_H),
                             (1, UP_TILE_W, REGION_W)):
        sizes = [s[axis] for s in shapes]
        rows = []
        for lo in range(0, sizes[0], tile):
            hi = min(lo + tile, sizes[0]) - 1
            row = []
            for k in range(len(shapes) - 1):
                i0, i1, _ = upsample_coords(sizes[k + 1], sizes[k])
                lo, hi = int(i0[lo]), int(i1[hi])
                if hi - lo + 1 > most:
                    raise RuntimeError(
                        f"bloom of {h}x{w}: level {k + 1}'s region spans "
                        f"{hi - lo + 1} > {most} along axis {axis}")
                row.append((lo, hi))
            rows.append(row)
        out.append(torch.tensor(rows, dtype=torch.int32).reshape(
            len(rows), len(shapes) - 1, 2))
    return tuple(out)


class _Axis(kernels.Args):
    _fields_ = [("table", ctypes.c_void_p), ("n", ctypes.c_int)]


_P3 = ctypes.c_void_p * 3


class ChainArgs(kernels.Args):
    """``struct BloomChainArgs`` of ``csrc/bloom.cu``."""

    _fields_ = [
        ("hdr", _P3), ("h", ctypes.c_int), ("w", ctypes.c_int),
        ("threshold", ctypes.c_float), ("knee", ctypes.c_float),
        ("knee2", ctypes.c_float), ("levels", ctypes.c_int),
        ("mip", _P3 * BLOOM_MIP_LEVELS),
        ("mh", ctypes.c_int * BLOOM_MIP_LEVELS),
        ("mw", ctypes.c_int * BLOOM_MIP_LEVELS),
        ("ux", _Axis * BLOOM_MIP_LEVELS), ("uy", _Axis * BLOOM_MIP_LEVELS),
        ("cx", _Axis), ("cy", _Axis), ("tile_rows", ctypes.c_void_p),
        ("tile_cols", ctypes.c_void_p), ("top", _P3), ("out", _P3),
        ("grid", ctypes.c_int),
    ]


@functools.lru_cache(maxsize=None)
def chain_info(device_index: int) -> dict:
    """The chain kernel's registers, local bytes a thread, static shared
    bytes and resident blocks a SM, and the card's SMs; raises if the
    kernel's block, tiles or regions are not this module's."""
    vals = [ctypes.c_int() for _ in range(5)]
    layout = (ctypes.c_int * 7)()
    with torch.cuda.device(device_index):
        rc = kernels.get_lib().ptrt_bloom_chain_info(
            *[ctypes.byref(v) for v in vals], layout)
    kernels.check(rc, "bloom_chain info")
    mine = (THREADS, TILE_W, TILE_H, UP_TILE_W, UP_TILE_H, REGION_H,
            REGION_W)
    if tuple(layout) != mine:
        raise RuntimeError(f"csrc/bloom.cu's block, tiles and regions "
                           f"{tuple(layout)} are not render/bloom.py's "
                           f"{mine}")
    return dict(zip(("registers", "local_bytes", "shared_bytes",
                     "blocks_per_sm", "sms"), (v.value for v in vals)),
                threads=THREADS)


def _axis(table: torch.Tensor) -> _Axis:
    return _Axis(table.data_ptr(), table.shape[1])


def _regions(h: int, w: int, dev):
    key = ("regions", str(dev), h, w)
    if key not in _on_device:
        _on_device[key] = tuple(t.to(dev) for t in pyramid_regions(h, w))
    return _on_device[key]


def _chain_cuda(hdr: Vec3, threshold: float, knee: float, composite: bool):
    dev = hdr.x.device
    h, w = hdr.x.shape
    shapes = mip_shapes(h, w)
    sizes = [3 * mh * mw for mh, mw in shapes]
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    mips, at = [], 0
    for (mh, mw), n in zip(shapes, sizes):
        planes = buf[at:at + n].view(3, mh, mw)
        mips.append(Vec3(planes[0], planes[1], planes[2]))
        at += n
    top = _empty3(shapes[0], dev) if len(shapes) > 1 else mips[0]
    out = _empty3((h, w), dev) if composite else None
    info = chain_info(dev.index if dev.index is not None
                      else torch.cuda.current_device())
    a = ChainArgs()
    a.hdr = _P3(*_ptrs(hdr))
    a.h, a.w, a.levels = h, w, len(shapes)
    a.threshold, a.knee, a.knee2 = threshold, knee, 2.0 * knee
    for k, ((mh, mw), m) in enumerate(zip(shapes, mips)):
        a.mip[k] = _P3(*_ptrs(m))
        a.mh[k], a.mw[k] = mh, mw
        if k + 1 < len(shapes):
            ch, cw = shapes[k + 1]
            a.ux[k] = _axis(axis_table(cw, mw, dev))
            a.uy[k] = _axis(axis_table(ch, mh, dev))
    if len(shapes) > 1:
        rows, cols = _regions(h, w, dev)
        a.tile_rows, a.tile_cols = rows.data_ptr(), cols.data_ptr()
    a.top = _P3(*_ptrs(top))
    if composite:
        a.cx = _axis(axis_table(shapes[0][1], w, dev))
        a.cy = _axis(axis_table(shapes[0][0], h, dev))
        a.out = _P3(*_ptrs(out))
    a.grid = chain_launch(h, w, composite, info["blocks_per_sm"],
                          info["sms"]).grid
    rc = kernels.get_lib().ptrt_bloom_chain(ctypes.addressof(a),
                                            kernels.stream_ptr(dev))
    kernels.launches["bloom_chain"] += 1
    kernels.check(rc, "bloom_chain")
    return mips, top, out


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


def bloom_chain(hdr: Vec3, threshold: float = 1.5, knee: float = 0.5,
                composite: bool = False):
    """The whole chain: (the blurred mips, finest first; mip 0 after the
    upsample-add chain; with ``composite``, ``hdr + up(that mip 0)``, else
    None).  An image with no mip gives ``([], None, hdr or None)``.  CUDA
    tensors take the kernel (one launch); CPU tensors the plain version."""
    dev = hdr.x.device
    kernels.require_supported(dev)
    _check_planes("hdr", hdr, dev)
    if not mip_shapes(*hdr.x.shape):
        return [], None, (hdr if composite else None)
    if dev.type == "cpu":
        return bloom_chain_plain(hdr, threshold, knee, composite)
    return _chain_cuda(hdr, threshold, knee, composite)


def bloom_mips(hdr: Vec3, threshold: float = 1.5,
               knee: float = 0.5) -> Vec3 | None:
    """Mip 0 after the upsample-add chain, for ``pipeline.tonemap_rgb8``'s
    composite; None where the image has no mip."""
    return bloom_chain(hdr, threshold, knee)[1]


def apply_bloom(hdr: Vec3, threshold: float = 1.5, knee: float = 0.5) -> Vec3:
    """The full bloom: bright pass, up to six mips, upsample-add from the
    coarsest mip back onto the image."""
    return bloom_chain(hdr, threshold, knee, composite=True)[2]


def apply_bloom_plain(hdr: Vec3, threshold: float = 1.5,
                      knee: float = 0.5) -> Vec3:
    """Plain version of ``apply_bloom`` (on any device)."""
    return bloom_chain_plain(hdr, threshold, knee, composite=True)[2]
