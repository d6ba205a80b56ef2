"""8-wide BVH construction (host) and node-row packing — counterpart of
``ptrt_tpu/geometry/bvh8.py``.

Layout contract (shared with the native builder and the CUDA walk,
``csrc/traverse.cu``):
  * leaf children of a node occupy slots ``[0, leaf_count)``; tri-table
    row of leaf slot s = ``leaf_base + s``;
  * internal children occupy slots ``[leaf_count, leaf_count+int_count)``;
    node id of internal slot s = ``(child_base - leaf_count) + s``.

Node rows are 64 floats: ``[0:8]=bmin_x [8:16]=bmin_y [16:24]=bmin_z
[24:32]=bmax_x [32:40]=bmax_y [40:48]=bmax_z [48]=float(child_base -
leaf_count) [49]=float(leaf_base) [50]=float(leaf_mask) [51]=float(int_mask)
[52:60]=per-octant child visit orders [60:64]=pad``.  Metadata ints are exact
small-float VALUES (< 2^24), not bit patterns: readers convert by value.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ptrt_tpu_torch.geometry.bvh import LEAF_SIZE
from ptrt_tpu_torch.native import get_lib, native_build_bvh8
from ptrt_tpu_torch.utils.logging import span

NODE_ROW_WIDTH = 64


@dataclass
class FlatBVH8:
    """Host-side wide BVH.  ``order`` (n_blocks * leaf_size,): original
    triangle index per reordered slot, -1 for padding."""

    slot_bmin: np.ndarray  # (N, 8, 3)
    slot_bmax: np.ndarray  # (N, 8, 3)
    child_base: np.ndarray  # (N,) int32
    leaf_base: np.ndarray  # (N,) int32
    leaf_count: np.ndarray  # (N,) int32
    int_count: np.ndarray  # (N,) int32
    order: np.ndarray  # (n_blocks*leaf_size,) int64
    max_depth: int

    @property
    def num_nodes(self) -> int:
        return int(self.child_base.shape[0])


def build_bvh8(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
               leaf_size: int = LEAF_SIZE) -> FlatBVH8:
    """Binned-SAH binary build collapsed to branching factor 8 (native).
    The span ``geometry.bvh8_build`` times the build, not the builder's
    compile at its first use."""
    get_lib()
    with span("geometry.bvh8_build"):
        tmin = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
        tmax = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
        cent = ((tmin + tmax) * 0.5).astype(np.float32)
        return FlatBVH8(*native_build_bvh8(tmin, tmax, cent, leaf_size))


def pack_node_rows(b: FlatBVH8) -> np.ndarray:
    """Pack the wide BVH into (N, 64) node rows (layout above).  Cols
    ``52+o`` (o = ray octant, bit a set when d[a] < 0) hold eight 3-bit slot
    ids packed into an exact float, sorted by child-centroid projection
    along the octant direction."""
    n = b.num_nodes
    rows = np.zeros((n, NODE_ROW_WIDTH), np.float32)
    for a in range(3):
        rows[:, a * 8:(a + 1) * 8] = b.slot_bmin[:, :, a]
        rows[:, 24 + a * 8:24 + (a + 1) * 8] = b.slot_bmax[:, :, a]
    cba = (b.child_base - b.leaf_count).astype(np.int32)
    lmask = ((1 << b.leaf_count.astype(np.int64)) - 1).astype(np.int32)
    fullm = ((1 << (b.leaf_count + b.int_count).astype(np.int64)) - 1)
    imask = (fullm.astype(np.int32)) ^ lmask
    rows[:, 48] = cba.astype(np.float32)
    rows[:, 49] = b.leaf_base.astype(np.float32)
    rows[:, 50] = lmask.astype(np.float32)
    rows[:, 51] = imask.astype(np.float32)

    cent = (b.slot_bmin + b.slot_bmax) * 0.5  # (N, 8, 3)
    used = (np.arange(8)[None, :]
            < (b.leaf_count + b.int_count)[:, None])  # (N, 8)
    for octant in range(8):
        sign = np.array([1.0 if (octant >> a) & 1 == 0 else -1.0
                         for a in range(3)], np.float32)
        proj = (cent * sign).sum(axis=2)
        proj = np.where(used, proj, np.inf)  # empty slots sort last
        order = np.argsort(proj, axis=1, kind="stable").astype(np.int64)
        packed = np.zeros(n, np.int64)
        for k in range(8):
            packed |= order[:, k] << (3 * k)
        rows[:, 52 + octant] = packed.astype(np.float32)
    return rows
