"""The instance tree (TLAS): a small tree over the instances' world boxes
that K4 descends instead of testing every box — built on the host
(``build_tlas``, numpy) where a scene edits its instances, and on the device
(``build_tlas_plain``, torch; K11 ``geometry/dtransform.instances_update``
on the card) where a fused game frame moves them.

The reference tests every ray against every instance box
(``ptrt_tpu/render/traverse.py:_inst_hit_words``: instances are tens, a
broadcast beats a tree on a TPU).  On the card each ray is one thread, and
a tree turns ~200 box tests a ray into a few tens.  It is an acceleration
structure only: the candidate set it yields is exactly the flat test's.

Layout (``build_tlas``): the instances sorted by the Morton code of their
box centres, grouped ``TLAS_WIDTH`` (w) at a time into leaf nodes, and the
nodes of each level grouped w at a time into the level above, up to one
root.  Nodes are stored root first, level by level (leaves last); the
children of a level's node ``j`` are the next level down's nodes
``j * w .. j * w + w - 1``.  A node is w child rows of 8 float32:
``lo.x lo.y lo.z ref hi.x hi.y hi.z valid`` with ``ref`` the child node's
index, or ``-1 - id`` for instance ``id`` (a float VALUE,
exact below 2^24), and ``valid`` 1 for a child, 0 for an empty slot.

Why the set is exact: a leaf child's box is the instance's ``bb_min`` /
``bb_max`` verbatim, tested with the flat test's arithmetic
(``(b - o) * inv``, min/max, entry from 0, exit from the bound, ``te <=
tx``); an inner child's box is the exact float32 min over its children's
lo and hi, and max likewise, and both roundings are monotone in ``b``, so
an inner box passes whenever one of its children passes.
"""

from __future__ import annotations

import numpy as np
import torch

from ptrt_tpu_torch.core.vec import sdiv

# children a node, csrc/traverse.cu's kTlasWidth: on the dynamic scene's
# 1080p wavefronts 4 tests fewer boxes a ray than 8 and measured faster
TLAS_WIDTH = 4
TLAS_ROW = 8  # floats a child row
_RAY_CHUNK = 65536  # rays a pass of the plain descent


def tlas_levels(n_inst: int) -> list:
    """Node counts of each level, the leaves' first, up to the root's 1."""
    if n_inst < 1:
        raise ValueError("an instance tree needs at least one instance")
    counts, m = [], n_inst
    while True:
        m = -(-m // TLAS_WIDTH)
        counts.append(m)
        if m == 1:
            return counts


def tlas_stack_bound(n_inst: int) -> int:
    """The most node indices a depth-first descent holds at once: each
    level whose children are nodes pushes at most ``TLAS_WIDTH`` and pops
    one."""
    return (TLAS_WIDTH - 1) * (len(tlas_levels(n_inst)) - 1) + 1


def _level_offsets(counts: list) -> list:
    """First node index of each level (leaves first) in root-first order."""
    return [sum(counts[k + 1:]) for k in range(len(counts))]


def _spread10(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint32) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def morton_order(bb_min: np.ndarray, bb_max: np.ndarray) -> np.ndarray:
    """The instances sorted by the 30-bit Morton code of their box centres
    over the centres' bounds (stable: ties keep id order); a non-finite
    centre counts as the bounds' low corner."""
    c = 0.5 * (bb_min.astype(np.float64) + bb_max.astype(np.float64))
    fin = np.isfinite(c)
    lo = np.where(fin, c, np.inf).min(axis=0)
    hi = np.where(fin, c, -np.inf).max(axis=0)
    wide = hi > lo
    lo = np.where(wide, lo, 0.0)
    scale = np.where(wide, 1023.0 / np.where(wide, hi - lo, 1.0), 0.0)
    q = np.where(fin, (np.where(fin, c, 0.0) - lo) * scale, 0.0)
    q = np.clip(q, 0.0, 1023.0).astype(np.uint32)
    code = (_spread10(q[:, 0]) << 2) | (_spread10(q[:, 1]) << 1) | \
        _spread10(q[:, 2])
    return np.argsort(code, kind="stable")


def build_tlas(bb_min, bb_max) -> np.ndarray:
    """The tree over instance boxes ``bb_min`` / ``bb_max`` (I, 3) as a
    (nodes, TLAS_WIDTH, 8) float32 array (layout in the module's
    docstring)."""
    width = TLAS_WIDTH
    lo = np.asarray(bb_min, np.float32).reshape(-1, 3)
    hi = np.asarray(bb_max, np.float32).reshape(-1, 3)
    n = lo.shape[0]
    counts = tlas_levels(n)
    offs = _level_offsets(counts)
    out = np.zeros((sum(counts), width, TLAS_ROW), np.float32)
    order = morton_order(lo, hi)
    c_lo, c_hi = lo[order], hi[order]
    c_ref = (-1 - order).astype(np.float32)
    for level, c in enumerate(counts):
        m = c_lo.shape[0]
        pad = c * width - m
        node = out[offs[level]:offs[level] + c].reshape(c * width, TLAS_ROW)
        node[:m, 0:3], node[:m, 3] = c_lo, c_ref
        node[:m, 4:7], node[:m, 7] = c_hi, 1.0
        # the boxes of this level's nodes: min / max over every bound of
        # their children (an inverted child box too), empty slots neutral
        grow = lambda a, fill: np.concatenate(
            [a, np.full((pad, 3), fill, np.float32)]).reshape(c, width, 3)
        b_lo = np.fmin(c_lo, c_hi)
        b_hi = np.fmax(c_lo, c_hi)
        c_lo = np.fmin.reduce(grow(b_lo, np.inf), axis=1)
        c_hi = np.fmax.reduce(grow(b_hi, -np.inf), axis=1)
        c_ref = (offs[level] + np.arange(c)).astype(np.float32)
    return out


def tlas_node_count(n_inst: int) -> int:
    return sum(tlas_levels(n_inst))


def level_layout(n_inst: int) -> tuple:
    """(node counts of each level, leaves first; first node index of each
    level in the root-first layout)."""
    counts = tlas_levels(n_inst)
    return counts, _level_offsets(counts)


# numpy's fmin / fmax, signed zeros included: the second operand where the
# two compare equal, the other where one is a NaN (torch.fmin keeps the
# first on a tie)
def _np_fmin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where((a < b) | torch.isnan(b), a, b)


def _np_fmax(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where((a > b) | torch.isnan(b), a, b)


def _spread10_t(v: torch.Tensor) -> torch.Tensor:
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def _morton_order_tensor(bb_min: torch.Tensor,
                       bb_max: torch.Tensor) -> torch.Tensor:
    """``morton_order`` on tensors, on their device: the same float64
    arithmetic, the same codes, the same stable order (int64 ids)."""
    c = 0.5 * (bb_min.double() + bb_max.double())
    fin = torch.isfinite(c)
    inf = float("inf")
    lo = torch.where(fin, c, inf).amin(dim=0)
    hi = torch.where(fin, c, -inf).amax(dim=0)
    wide = hi > lo
    lo = torch.where(wide, lo, 0.0)
    span = torch.where(wide, hi - lo, 1.0)
    scale = torch.where(wide, sdiv(1023.0, span), 0.0)
    q = torch.where(fin, (torch.where(fin, c, 0.0) - lo) * scale, 0.0)
    q = torch.clamp(q, 0.0, 1023.0).to(torch.int64)
    code = ((_spread10_t(q[:, 0]) << 2) | (_spread10_t(q[:, 1]) << 1)
            | _spread10_t(q[:, 2]))
    return torch.sort(code, stable=True).indices


def _fold(rows: torch.Tensor, op) -> torch.Tensor:
    """``op.reduce`` over axis 1 of (c, width, 3), left to right."""
    acc = rows[:, 0]
    for k in range(1, rows.shape[1]):
        acc = op(acc, rows[:, k])
    return acc


def build_tlas_plain(bb_min: torch.Tensor,
                     bb_max: torch.Tensor) -> torch.Tensor:
    """``build_tlas`` on tensors, on their device, with no numpy round
    trip: the same tree, bit for bit (the plain version of K11's tree,
    ``geometry/dtransform.instances_update``)."""
    width = TLAS_WIDTH
    lo = bb_min.reshape(-1, 3).to(torch.float32)
    hi = bb_max.reshape(-1, 3).to(torch.float32)
    dev = lo.device
    counts, offs = level_layout(lo.shape[0])
    out = torch.zeros((sum(counts), width, TLAS_ROW), dtype=torch.float32,
                      device=dev)
    order = _morton_order_tensor(lo, hi)
    c_lo, c_hi = lo[order], hi[order]
    c_ref = (-1 - order).to(torch.float32)
    inf = float("inf")
    for level, c in enumerate(counts):
        m = c_lo.shape[0]
        pad = c * width - m
        node = out[offs[level]:offs[level] + c].view(c * width, TLAS_ROW)
        node[:m, 0:3], node[:m, 3] = c_lo, c_ref
        node[:m, 4:7], node[:m, 7] = c_hi, 1.0
        grow = lambda a, fill: torch.cat(
            [a, torch.full((pad, 3), fill, dtype=torch.float32,
                           device=dev)]).reshape(c, width, 3)
        b_lo = _np_fmin(c_lo, c_hi)
        b_hi = _np_fmax(c_lo, c_hi)
        c_lo = _fold(grow(b_lo, inf), _np_fmin)
        c_hi = _fold(grow(b_hi, -inf), _np_fmax)
        c_ref = (offs[level] + torch.arange(c, device=dev)).to(torch.float32)
    return out


def _slab(lo, hi, ox, oy, oz, ix, iy, iz, t_bound):
    """Boxes (..., 3) against rays (R, 1, 1) within (0, t_bound]: the flat
    test's arithmetic (``render/traverse.slab``)."""
    te = torch.zeros_like(t_bound)
    tx = t_bound
    for a, (oc, ic) in enumerate(((ox, ix), (oy, iy), (oz, iz))):
        t0 = (lo[..., a] - oc) * ic
        t1 = (hi[..., a] - oc) * ic
        te = torch.maximum(te, torch.minimum(t0, t1))
        tx = torch.minimum(tx, torch.maximum(t0, t1))
    return te <= tx


def tlas_candidates(tlas: torch.Tensor, n_inst: int, o, inv, t_bound,
                    candidates: bool = True):
    """Plain descent of the tree: for each ray (flat (R,) origin ``o``,
    inverse direction ``inv``, bound ``t_bound``; a ray with ``t_bound <=
    0`` tests nothing), the instances whose box it enters, as the kernel
    finds them.  Returns (candidates (R, I) bool or None, box tests (R,)
    int32: the valid children of every node the ray reaches)."""
    counts = tlas_levels(n_inst)
    offs = _level_offsets(counts)
    dev = t_bound.device
    r = t_bound.shape[0]
    cand = (torch.zeros((r, n_inst), dtype=torch.bool, device=dev)
            if candidates else None)
    tests = torch.zeros(r, dtype=torch.int32, device=dev)
    lo, hi = tlas[..., 0:3], tlas[..., 4:7]
    valid = tlas[..., 7] != 0.0
    ids = (-1 - tlas[offs[0]:offs[0] + counts[0], :, 3].to(torch.int64)
           ).reshape(-1)[:n_inst]
    for r0 in range(0, r, _RAY_CHUNK):
        rs = slice(r0, min(r, r0 + _RAY_CHUNK))
        ray = [c[rs, None, None] for c in (o.x, o.y, o.z, inv.x, inv.y,
                                           inv.z)]
        tb = t_bound[rs, None, None]
        reach = (tb[:, :, 0] > 0.0)  # the root, (R, 1)
        for level in reversed(range(len(counts))):
            sl = slice(offs[level], offs[level] + counts[level])
            at = reach[:, :, None] & valid[None, sl]
            tests[rs] += at.sum((1, 2), dtype=torch.int32)
            ok = (at & _slab(lo[None, sl], hi[None, sl], *ray, tb)).reshape(
                at.shape[0], -1)
            if level:
                reach = ok[:, :counts[level - 1]]
            elif candidates:
                cand[rs, ids] = ok[:, :n_inst]
    return cand, tests
