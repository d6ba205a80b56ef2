"""Tonemapping and color-space conversion.

Counterpart of ``ptrt_tpu/core/color.py``: the fitted-matrix ACES, the exact
sRGB OETF and 8-bit quantization, term for term, are the plain versions of
the fused tonemap kernel (``csrc/tonemap.cu``); Reinhard, Uncharted2 and the
sRGB approximations are the reference's other curves, in plain torch.
"""

from __future__ import annotations

import torch

from ptrt_tpu_torch.core.vec import Vec3, clamp01, fmax

# ACES input/output matrices, row-major.
ACES_IN = (
    (0.59719, 0.35458, 0.04823),
    (0.07600, 0.90834, 0.01566),
    (0.02840, 0.13383, 0.83777),
)
ACES_OUT = (
    (1.60475, -0.53108, -0.07367),
    (-0.10208, 1.10813, -0.00605),
    (-0.00327, -0.07276, 1.07602),
)


def _mul3(m, v: Vec3) -> Vec3:
    return Vec3(
        m[0][0] * v.x + m[0][1] * v.y + m[0][2] * v.z,
        m[1][0] * v.x + m[1][1] * v.y + m[1][2] * v.z,
        m[2][0] * v.x + m[2][1] * v.y + m[2][2] * v.z,
    )


def reinhard_tonemap(c: Vec3) -> Vec3:
    """color / (color + 1)."""
    return c / (c + 1.0)


def aces_tonemap(c: Vec3) -> Vec3:
    """Fitted ACES."""
    ac = _mul3(ACES_IN, c)
    a = ac * (ac + 0.0245786) - 0.000090537
    b = ac * (ac * 0.983729 + 0.4329510) + 0.238081
    ac = clamp01(a / b)
    return clamp01(_mul3(ACES_OUT, ac))


def _uncharted2_partial(x: Vec3) -> Vec3:
    A, B, C, D, E, F = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return (x * (x * A + C * B) + D * E) / (x * (x * A + B) + D * F) - E / F


def uncharted2_tonemap(c: Vec3, exposure: float = 2.0) -> Vec3:
    """Uncharted2 filmic curve, white point 11.2."""
    curr = _uncharted2_partial(c * exposure)
    white = _uncharted2_partial(Vec3.full(11.2))
    return curr * (Vec3.full(1.0) / white)


def linear_to_srgb(c: Vec3) -> Vec3:
    """pow(1/2.2) approximation."""
    return c.map(lambda v: fmax(v, 0.0) ** (1.0 / 2.2))


def srgb_to_linear(c: Vec3) -> Vec3:
    return c.pow(2.2)


def linear_to_srgb_fast(c: Vec3) -> Vec3:
    """sqrt approximation."""
    return c.map(lambda v: torch.sqrt(fmax(v, 0.0)))


def srgb_oetf(c: Vec3) -> Vec3:
    """Exact sRGB transfer function: 12.92x below 0.0031308, else
    1.055 x^(1/2.4) - 0.055."""

    def chan(v):
        v = fmax(v, 0.0)
        return torch.where(v <= 0.0031308, 12.92 * v,
                           1.055 * torch.pow(v, 1.0 / 2.4) - 0.055)

    return c.map(chan)


def to_rgb8(c: Vec3) -> torch.Tensor:
    """Quantize a tonemapped [0,1] Vec3 image to HxWx3 uint8."""
    arr = torch.stack([c.x, c.y, c.z], dim=-1)
    return torch.clamp(arr * 255.0 + 0.5, 0, 255).to(torch.uint8)
