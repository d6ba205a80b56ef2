"""BVH leaf constants and leaf-order helpers (counterpart of
``ptrt_tpu/geometry/bvh.py``).  Leaves are padded to a fixed block of
``LEAF_SIZE`` triangles; padding slots carry degenerate triangles."""

from __future__ import annotations

import numpy as np

LEAF_SIZE = 8


def reorder_padded(arr: np.ndarray, order: np.ndarray, fill=0.0) -> np.ndarray:
    """Gather ``arr`` rows into BVH leaf-block order; padding slots (-1) get
    ``fill``."""
    out_shape = (order.shape[0],) + arr.shape[1:]
    out = np.full(out_shape, fill, arr.dtype)
    valid = order >= 0
    out[valid] = arr[order[valid]]
    return out
