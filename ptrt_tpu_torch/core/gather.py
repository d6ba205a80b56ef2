"""Row gather: ``out[r, :] = table[idx[r], :]``.

``row_gather`` launches the hand-written ``csrc/gather.cu`` kernel for CUDA
tensors and runs ``row_gather_plain`` (``index_select``) for CPU tensors.
It is the port of the repo's Pallas row-gather probes (``tools/``) and the
engine's per-lane table fetch (``MaterialTable.gather``).

Tables are float32 or bfloat16 and copied bit for bit.  An index outside
``[0, N)`` is clamped into it, by the kernel and the plain version alike.
``field_major=True`` returns the transpose, ``(W, R)``, contiguous: one
plane per table column.
"""

from __future__ import annotations

import torch

from ptrt_tpu_torch import kernels

DTYPES = (torch.float32, torch.bfloat16)


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor,
                     field_major: bool = False) -> torch.Tensor:
    """Plain version of ``row_gather``."""
    rows = table.index_select(0, idx.clamp(0, table.shape[0] - 1))
    return rows.t().contiguous() if field_major else rows


def row_gather(table: torch.Tensor, idx: torch.Tensor,
               field_major: bool = False) -> torch.Tensor:
    """Gather rows of a contiguous (N, W) table by a 1-D int32/int64
    index: (R, W), or (W, R) with ``field_major``."""
    dev = table.device
    kernels.require_supported(dev)
    if table.dtype not in DTYPES:
        raise TypeError(f"table: expected one of {DTYPES}, got {table.dtype}")
    kernels.check_tensor("table", table, table.dtype, 2, dev)
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx: expected int32 or int64, got {idx.dtype}")
    kernels.check_tensor("idx", idx, idx.dtype, 1, dev)
    n, w = table.shape
    if n == 0 or w == 0:
        raise ValueError(f"table: empty shape {tuple(table.shape)}")
    if dev.type == "cpu":
        return row_gather_plain(table, idx, field_major)
    if n >= 2 ** 31:
        raise ValueError(f"table: {n} rows do not fit an int32 index")
    idx32 = (idx if idx.dtype == torch.int32
             else idx.clamp(0, n - 1).to(torch.int32))
    r = idx.shape[0]
    out = torch.empty((w, r) if field_major else (r, w), dtype=table.dtype,
                      device=dev)
    rc = kernels.get_lib().ptrt_row_gather(
        table.data_ptr(), n, w, table.element_size(), idx32.data_ptr(), r,
        out.data_ptr(), int(field_major), kernels.stream_ptr(dev))
    kernels.launches["row_gather"] += 1
    kernels.check(rc, "row_gather")
    return out
