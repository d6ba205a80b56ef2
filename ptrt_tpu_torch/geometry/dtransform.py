"""Instance transforms on the device for fused game frames, and K11.

Counterpart of ``ptrt_tpu/geometry/dtransform.py``.  A fused game frame
(``games/fused.py``) moves its instances from the game state on the device,
so the instance rows are computed there from TRS arrays instead of from the
host ``Transform3D`` (``geometry/transform.py``).  The conventions are
``Transform3D``'s: rotation = Rz·Ry·Rx, world = T·R·S, inverse =
S⁻¹·Rᵀ·T⁻¹, normal matrix = R·S⁻¹.  Every function works over a leading
instance axis (I, ...) with the reference's products in the reference's
order, each rounded on its own.

``instances_update`` is K11: the set's whole per-frame update — the rows
(``instance_mats``), the world boxes (``instance_world_aabbs``) and the
instance tree over those boxes (``tlas.build_tlas``) — written in place
into buffers the caller allocated once, so their addresses never change.
On CUDA tensors it launches ``csrc/instances.cu``; on CPU tensors it runs
``instances_update_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from ptrt_tpu_torch import kernels
from ptrt_tpu_torch.core.vec import Vec3, sdiv
from ptrt_tpu_torch.geometry.tlas import (TLAS_ROW, TLAS_WIDTH,
                                          build_tlas_plain, level_layout,
                                          tlas_node_count)

# the grid path's blocks (csrc/instances.cu kGridThreads): its scratch holds
# six float64 bounds a block
_GRID_THREADS = 256


def rot_xyz(rx, ry, rz) -> torch.Tensor:
    """(..., 3, 3) rotation Rz @ Ry @ Rx, elementwise over leading dims."""
    cx, sx = torch.cos(rx), torch.sin(rx)
    cy, sy = torch.cos(ry), torch.sin(ry)
    cz, sz = torch.cos(rz), torch.sin(rz)
    r00 = cz * cy
    r01 = cz * sy * sx - sz * cx
    r02 = cz * sy * cx + sz * sx
    r10 = sz * cy
    r11 = sz * sy * sx + cz * cx
    r12 = sz * sy * cx - cz * sx
    r20 = -sy
    r21 = cy * sx
    r22 = cy * cx
    return torch.stack([
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ], dim=-2)


def _dot3(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) summed left to right: (m0 p0 + m1 p1) + m2
    p2."""
    return (m[..., 0] * p[..., None, 0] + m[..., 1] * p[..., None, 1]
            + m[..., 2] * p[..., None, 2])


def inv_scale(scale: torch.Tensor) -> torch.Tensor:
    """1 / max(|s|, 1e-12) * sign(s), a zero scale counting as +: a
    collapsed instance (a 1e-6 or 0 scale) keeps finite rows."""
    mag = sdiv(1.0, torch.clamp_min(torch.abs(scale), 1e-12))
    return mag * torch.sign(torch.where(scale == 0.0, 1.0, scale))


def instance_mats(pos: torch.Tensor, rot: torch.Tensor,
                  scale: torch.Tensor) -> torch.Tensor:
    """(I, 3) TRS arrays -> (I, 24) ``InstanceSet.mats`` rows: columns 0:12
    the world->local affine (S⁻¹Rᵀ | -S⁻¹Rᵀt), 12:21 the local->world
    normal matrix R·S⁻¹, the rest zero."""
    r = rot_xyz(rot[..., 0], rot[..., 1], rot[..., 2])  # (I, 3, 3)
    inv_s = inv_scale(scale)
    inv3 = r.transpose(-1, -2) * inv_s[..., :, None]  # r[j, i] * inv_s[i]
    inv_t = -_dot3(inv3, pos)
    nrm = r * inv_s[..., None, :]  # R · S⁻¹
    n = pos.shape[0]
    out = torch.zeros((n, 24), dtype=torch.float32, device=pos.device)
    out[:, 0:12] = torch.cat([inv3, inv_t[..., :, None]], dim=-1).reshape(
        n, 12)
    out[:, 12:21] = nrm.reshape(n, 9)
    return out


def instance_world_aabbs(pos, rot, scale, local_lo, local_hi):
    """The local boxes (I, 3) carried by TRS to world (I, 3) lo / hi: the
    eight corners, each R·S·p + t, their min and max (NaN-propagating, in
    corner order)."""
    r = rot_xyz(rot[..., 0], rot[..., 1], rot[..., 2])
    m = r * scale[..., None, :]  # the world linear part R·S
    lo = hi = None
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                p = torch.stack([
                    (local_hi if cx else local_lo)[..., 0],
                    (local_hi if cy else local_lo)[..., 1],
                    (local_hi if cz else local_lo)[..., 2]], dim=-1)
                w = _dot3(m, p) + pos
                lo = w if lo is None else torch.minimum(lo, w)
                hi = w if hi is None else torch.maximum(hi, w)
    return lo, hi


def apply_world(pos, rot, scale, p: Vec3) -> Vec3:
    """World-transform points by one instance's TRS (3,) tensors."""
    r = rot_xyz(rot[0], rot[1], rot[2])
    x = p.x * scale[0]
    y = p.y * scale[1]
    z = p.z * scale[2]
    return Vec3(
        r[0, 0] * x + r[0, 1] * y + r[0, 2] * z + pos[0],
        r[1, 0] * x + r[1, 1] * y + r[1, 2] * z + pos[1],
        r[2, 0] * x + r[2, 1] * y + r[2, 2] * z + pos[2])


def instances_update_plain(pos, rot, scale, local_lo, local_hi) -> tuple:
    """Plain version of K11: (mats (I, 24), bb_min, bb_max (I, 3), tlas
    (nodes, TLAS_WIDTH, TLAS_ROW)) — ``instance_mats``,
    ``instance_world_aabbs`` and ``tlas.build_tlas_plain`` of those boxes,
    on the tensors' device."""
    mats = instance_mats(pos, rot, scale)
    lo, hi = instance_world_aabbs(pos, rot, scale, local_lo, local_hi)
    return mats, lo, hi, build_tlas_plain(lo, hi)


def one_block_max() -> int:
    """The most instances K11's one-block kernel takes; a larger set runs
    the grid path (rows and codes over the card, ``torch.sort``, a launch a
    tree level)."""
    return kernels.get_lib().ptrt_instances_update_max()


def _check(pos, rot, scale, local_lo, local_hi, mats, bb_min, bb_max, tlas):
    dev = pos.device
    kernels.require_supported(dev)
    n = int(pos.shape[0]) if pos.dim() == 2 else -1
    if n < 1:
        raise ValueError(f"pos: expected (I, 3) with I >= 1, got "
                         f"{tuple(pos.shape)}")
    for name, t, shape in (
            ("pos", pos, (n, 3)), ("rot", rot, (n, 3)),
            ("scale", scale, (n, 3)), ("local_lo", local_lo, (n, 3)),
            ("local_hi", local_hi, (n, 3)), ("mats", mats, (n, 24)),
            ("bb_min", bb_min, (n, 3)), ("bb_max", bb_max, (n, 3)),
            ("tlas", tlas, (tlas_node_count(n), TLAS_WIDTH, TLAS_ROW))):
        kernels.check_tensor(name, t, torch.float32, len(shape), dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
    if tlas.data_ptr() % 16:
        raise ValueError("tlas: K4 reads it 16 bytes at a time; it must be "
                         "16-byte aligned")
    return dev, n


def instances_update(pos: torch.Tensor, rot: torch.Tensor,
                     scale: torch.Tensor, local_lo: torch.Tensor,
                     local_hi: torch.Tensor, mats: torch.Tensor,
                     bb_min: torch.Tensor, bb_max: torch.Tensor,
                     tlas: torch.Tensor) -> None:
    """K11: write the rows, the world boxes and the instance tree of I
    instances in place.

    Inputs (I, 3) float32: ``pos``, ``rot`` (Euler XYZ), ``scale`` and the
    instances' local boxes ``local_lo`` / ``local_hi``.  Outputs, written
    in place: ``mats`` (I, 24), ``bb_min`` / ``bb_max`` (I, 3) and
    ``tlas`` (``tlas_node_count(I)``, ``TLAS_WIDTH``, ``TLAS_ROW``), the
    tree ``tlas.build_tlas`` builds over the boxes written.  On the card a
    set of at most ``one_block_max()`` instances takes one launch; a
    larger one the grid path."""
    dev, n = _check(pos, rot, scale, local_lo, local_hi, mats, bb_min,
                    bb_max, tlas)
    if dev.type == "cpu":
        for buf, val in zip((mats, bb_min, bb_max, tlas),
                            instances_update_plain(pos, rot, scale, local_lo,
                                                   local_hi)):
            buf.copy_(val)
        return
    lib = kernels.get_lib()
    counts, offs = level_layout(n)
    levels = len(counts)
    c_counts = (ctypes.c_int * levels)(*counts)
    c_offs = (ctypes.c_int * levels)(*offs)
    ins = [t.data_ptr() for t in (pos, rot, scale, local_lo, local_hi)]
    outs = [t.data_ptr() for t in (mats, bb_min, bb_max)]
    stream = kernels.stream_ptr(dev)
    if n <= lib.ptrt_instances_update_max():
        rc = lib.ptrt_instances_update(*ins, n, *outs, tlas.data_ptr(),
                                       levels, c_counts, c_offs, stream)
        kernels.launches["instances_update"] += 1
        kernels.check(rc, "instances_update")
        return
    blocks = -(-n // _GRID_THREADS)
    partial = torch.empty((blocks, 6), dtype=torch.float64, device=dev)
    codes = torch.empty(n, dtype=torch.int32, device=dev)
    rc = lib.ptrt_instances_codes(*ins, n, *outs, partial.data_ptr(),
                                  codes.data_ptr(), stream)
    kernels.launches["instances_rows"] += 1
    kernels.launches["instances_codes"] += 1
    kernels.check(rc, "instances_codes")
    order = torch.sort(codes, stable=True).indices
    rc = lib.ptrt_instances_levels(bb_min.data_ptr(), bb_max.data_ptr(), n,
                                   order.data_ptr(), tlas.data_ptr(), levels,
                                   c_counts, c_offs, stream)
    kernels.launches["instances_level"] += levels
    kernels.check(rc, "instances_levels")
