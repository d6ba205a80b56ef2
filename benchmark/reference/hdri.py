"""A synthetic equirect HDRI made from a seed, so scenes and checks need no
downloaded map: a sky-to-ground gradient, low-frequency noise, and a sun
disk of a few texels at about 1e4 radiance (the dynamic range that makes
env NEE worth its table)."""

from __future__ import annotations

import numpy as np


def synthetic_env(h: int, w: int, seed: int = 0, sun_uv=(0.3, 0.3),
                  sun_radiance: float = 1e4) -> np.ndarray:
    """(h, w, 3) float32 linear HDR: rows top (v = 0, +y) to bottom."""
    r = np.random.default_rng(seed)
    v = ((np.arange(h, dtype=np.float64) + 0.5) / h)[:, None]
    u = ((np.arange(w, dtype=np.float64) + 0.5) / w)[None, :]
    sky = np.array([0.35, 0.55, 1.0])
    ground = np.array([0.25, 0.2, 0.15])
    horizon = np.clip((v - 0.5) * 8.0 + 0.5, 0.0, 1.0)[..., None]
    img = sky * (1.0 - horizon) + ground * horizon
    # low-frequency noise: a few random waves in u (whole turns, so the map
    # wraps) and v
    noise = np.zeros((h, w))
    for _ in range(6):
        fu, fv = r.integers(1, 5), r.uniform(0.5, 4.0)
        noise += r.uniform(0.05, 0.15) * np.sin(
            2 * np.pi * (fu * u + r.uniform()) + fv * np.pi * v
            + r.uniform(0, 2 * np.pi))
    img = img * (1.0 + noise[..., None]) * r.uniform(0.8, 1.2, 3)
    # the sun: a disk of radius ~1.5 texels (at least), warm white
    su, sv = sun_uv
    rad = max(1.5 / w, 1.5 / h)
    du = np.minimum(np.abs(u - su), 1.0 - np.abs(u - su))
    disk = (du ** 2 + (v - sv) ** 2) <= rad ** 2
    img[disk] = sun_radiance * np.array([1.0, 0.95, 0.85])
    return np.maximum(img, 0.0).astype(np.float32)
