"""Temporal anti-aliasing sub-pixel jitter (counterpart of
``ptrt_tpu/core/taa.py``): the 16-entry Halton(2,3) table, centered to
[-0.5, 0.5] pixel units."""

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


def taa_jitter(frame_index):
    """Centered sub-pixel jitter for an integer frame index: of a Python
    int, the float32 values as Python floats (no device work); of an
    integer tensor, tensors."""
    if isinstance(frame_index, int):
        h = (np.asarray(_HALTON_16[frame_index % TAA_SEQUENCE_LENGTH],
                        np.float32) - np.float32(0.5))
        return float(h[0]), float(h[1])
    table = torch.tensor(_HALTON_16, dtype=torch.float32,
                         device=frame_index.device)
    h = table[torch.remainder(frame_index.to(torch.int64),
                              TAA_SEQUENCE_LENGTH)]
    return h[..., 0] - 0.5, h[..., 1] - 0.5
