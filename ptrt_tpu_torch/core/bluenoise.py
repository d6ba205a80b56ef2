"""Blue-noise sample table + per-frame golden-ratio scrambling.

Counterpart of ``ptrt_tpu/core/bluenoise.py``.  The 64x64x2 table,
``_bluenoise_64.npy`` beside this file, is the port's own copy of the
reference's committed artifact, which ``generate_blue_noise_2d`` (a copy
of the reference's numpy generator) reproduces bit for bit; the fetch
hashes the frame index with the same 32-bit mixer.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ptrt_tpu_torch.core.rng import mul32

BLUE_NOISE_SIZE = 64
BLUE_NOISE_CHANNELS = 2

TABLE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_bluenoise_64.npy")


def generate_blue_noise_2d(size: int = BLUE_NOISE_SIZE,
                           relaxation_iterations: int = 25) -> np.ndarray:
    """Jittered-stratified points relaxed by toroidal repulsion, vectorized
    over the N^2 pair grid in chunks: (size, size, 2) float32 in [0, 1).
    ~20 s of host time at the default size, so the table is stored."""
    rng = np.random.default_rng(12345)
    cell = 1.0 / size
    ys, xs = np.mgrid[0:size, 0:size]
    px = (xs.ravel() + rng.random(size * size)) * cell
    py = (ys.ravel() + rng.random(size * size)) * cell
    pts = np.stack([px, py], axis=1).astype(np.float32)

    step = np.float32(1e-4)
    min_d2 = np.float32(1e-4)
    n = pts.shape[0]
    block = 512
    idx = np.arange(n)
    for _ in range(relaxation_iterations):
        f = np.empty_like(pts)
        for start in range(0, n, block):
            sl = slice(start, min(start + block, n))
            d = pts[sl, None, :] - pts[None, :, :]  # (b, n, 2)
            d -= np.rint(d)  # toroidal wrap to [-0.5, 0.5]
            d2 = d[..., 0] ** 2 + d[..., 1] ** 2
            d2[idx[sl] - start, idx[sl]] = np.inf  # exclude self
            d2 = np.maximum(d2, min_d2)
            inv = 1.0 / d2
            f[sl, 0] = (d[..., 0] * inv).sum(axis=1)
            f[sl, 1] = (d[..., 1] * inv).sum(axis=1)
        mag = np.sqrt((f * f).sum(axis=1))
        ok = mag > 1e-6
        f[ok] /= mag[ok, None]
        f[~ok] = 0.0
        pts = np.mod(pts + f * step, 1.0)
    return pts.astype(np.float32).reshape(size, size, 2)


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
