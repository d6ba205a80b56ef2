"""Blue-noise sample table + per-frame golden-ratio scrambling.

Counterpart of ``ptrt_tpu/core/bluenoise.py``.  The 64x64x2 table,
``_bluenoise_64.npy`` beside this file, is the port's own copy of the
reference's committed artifact; the fetch hashes the frame index with the
same 32-bit mixer.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ptrt_tpu_torch.core.rng import mul32

BLUE_NOISE_SIZE = 64

TABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_bluenoise_64.npy")


def blue_noise_table(device) -> torch.Tensor:
    """The (64, 64, 2) float32 table on ``device``."""
    return torch.from_numpy(np.load(TABLE_PATH).astype(np.float32)).to(device)


def next_blue_noise(table: torch.Tensor, x, y, frame: int):
    """Blue-noise pair for pixel (x, y) at ``frame`` with the golden-ratio
    hash Cranley-Patterson rotation.  x, y: integer tensors; frame: a
    Python int, hashed on the host.  Returns (u, v) float32."""
    bx = x.to(torch.int64) & (BLUE_NOISE_SIZE - 1)
    by = y.to(torch.int64) & (BLUE_NOISE_SIZE - 1)
    val = table[by, bx]
    val_x, val_y = val[..., 0], val[..., 1]

    h = mul32(frame & 0xFFFFFFFF, 0x9E3779B9)
    h = h ^ (h >> 15)
    h = mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    # a 24-bit integer over 2^24: exact in float32
    shift_x = float(h & 0xFFFFFF) / 16777216.0
    h = mul32(h, 0x85EBCA6B)
    shift_y = float(h & 0xFFFFFF) / 16777216.0

    u = val_x + shift_x
    v = val_y + shift_y
    u = torch.where(u >= 1.0, u - 1.0, u)
    v = torch.where(v >= 1.0, v - 1.0, v)
    return u, v
