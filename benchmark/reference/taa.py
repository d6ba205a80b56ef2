"""Temporal anti-aliasing sub-pixel jitter (counterpart of
``ptrt_tpu/core/taa.py``): the 16-entry Halton(2,3) table, runtime Halton
and the R2 (plastic-constant) sequence, centered to [-0.5, 0.5] pixel
units.  Of a Python int each returns the float32 values as Python floats
(no device work: a frame's jitter enters it as host numbers); of an
integer tensor, float32 tensors on its device (the table made once a
device, ``halton_table``)."""

from __future__ import annotations

import numpy as np
import torch

TAA_SEQUENCE_LENGTH = 16

_HALTON_16 = (
    (0.500000, 0.333333), (0.250000, 0.666667), (0.750000, 0.111111),
    (0.125000, 0.444444), (0.625000, 0.777778), (0.375000, 0.222222),
    (0.875000, 0.555556), (0.062500, 0.888889), (0.562500, 0.037037),
    (0.312500, 0.370370), (0.812500, 0.703704), (0.187500, 0.148148),
    (0.687500, 0.481481), (0.437500, 0.814815), (0.937500, 0.259259),
    (0.062500, 0.592593),
)


_tables: dict = {}


def halton_table(device) -> torch.Tensor:
    """The (16, 2) float32 table on ``device``, made once a device: a
    frame captured into a CUDA graph may copy nothing from the host."""
    key = str(torch.device(device))
    if key not in _tables:
        _tables[key] = torch.tensor(_HALTON_16, dtype=torch.float32,
                                    device=device)
    return _tables[key]


def taa_jitter(frame_index):
    """Centered sub-pixel jitter for an integer frame index: of a Python
    int, the float32 values as Python floats (no device work); of an
    integer tensor, tensors on its device, the same float32 values (the
    table lookup an ``index_select``: indexing with a 0-d device tensor
    would read it back to the host)."""
    if isinstance(frame_index, int):
        h = (np.asarray(_HALTON_16[frame_index % TAA_SEQUENCE_LENGTH],
                        np.float32) - np.float32(0.5))
        return float(h[0]), float(h[1])
    idx = torch.remainder(frame_index.to(torch.int64), TAA_SEQUENCE_LENGTH)
    h = halton_table(frame_index.device).index_select(
        0, idx.reshape(-1)).reshape(*idx.shape, 2)
    return h[..., 0] - 0.5, h[..., 1] - 0.5


def taa_jitter_ndc(frame_index, width: int, height: int):
    """Jitter scaled to NDC."""
    jx, jy = taa_jitter(frame_index)
    if isinstance(frame_index, int):
        return (float(np.float32(jx) / np.float32(width)),
                float(np.float32(jy) / np.float32(height)))
    return jx / float(width), jy / float(height)


def _halton_np(i: np.ndarray, base: int) -> np.ndarray:
    """The radical inverse in float32, 32 digits, the reference's sums in
    its order; ``i`` int32 (floor division and remainder as numpy's)."""
    result = np.zeros(i.shape, np.float32)
    f = np.float32(1.0 / base)
    for _ in range(32):
        result = result + f * (i % base).astype(np.float32)
        i = i // base
        f = f / np.float32(base)
    return result


def halton(index, base: int):
    """Runtime Halton radical inverse (32 digits)."""
    if isinstance(index, int):
        return float(_halton_np(np.asarray(index, np.int32), base))
    i = index.to(torch.int32)
    result = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    f = torch.tensor(1.0 / base, dtype=torch.float32)
    for _ in range(32):
        result = result + f * torch.remainder(i, base).to(torch.float32)
        i = torch.div(i, base, rounding_mode="floor")
        f = f / base
    return result


def taa_jitter_extended(frame_index):
    """Halton(2, 3) jitter past the 16-entry table."""
    x = halton(frame_index + 1, 2)
    y = halton(frame_index + 1, 3)
    if isinstance(frame_index, int):
        return (float(np.float32(x) - np.float32(0.5)),
                float(np.float32(y) - np.float32(0.5)))
    return x - 0.5, y - 0.5


def r2_jitter(frame_index):
    """R2 plastic-constant sequence."""
    g = 1.32471795724
    a1 = np.float32(1.0 / g)
    a2 = np.float32(1.0 / (g * g))
    if isinstance(frame_index, int):
        f = np.float32(frame_index)
        x = np.mod(np.float32(0.5) + a1 * f, np.float32(1.0))
        y = np.mod(np.float32(0.5) + a2 * f, np.float32(1.0))
        return float(x - np.float32(0.5)), float(y - np.float32(0.5))
    f = frame_index.to(torch.float32)
    x = torch.remainder(0.5 + float(a1) * f, 1.0)
    y = torch.remainder(0.5 + float(a2) * f, 1.0)
    return x - 0.5, y - 0.5
