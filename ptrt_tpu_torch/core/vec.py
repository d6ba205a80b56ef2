"""SoA 3-vector math on torch tensors.

Counterpart of ``ptrt_tpu/core/vec.py``: a ``Vec3`` holds three component
tensors of one broadcast shape, so every vector op is a plain elementwise
torch op over the whole ray batch.  Components may be tensors or Python
scalars; free functions mirror the reference's names.
"""

from __future__ import annotations

import math as _math
from dataclasses import dataclass
from typing import Any

import torch


def fmax(a, b):
    """``jnp.maximum`` for a tensor against a tensor or Python scalar."""
    if isinstance(b, torch.Tensor) and isinstance(a, torch.Tensor):
        return torch.maximum(a, b)
    if isinstance(a, torch.Tensor):
        return torch.clamp_min(a, b)
    return torch.clamp_min(b, a)


def fmin(a, b):
    """``jnp.minimum`` for a tensor against a tensor or Python scalar."""
    if isinstance(b, torch.Tensor) and isinstance(a, torch.Tensor):
        return torch.minimum(a, b)
    if isinstance(a, torch.Tensor):
        return torch.clamp_max(a, b)
    return torch.clamp_max(b, a)


def sdiv(s: float, t: torch.Tensor) -> torch.Tensor:
    """Python scalar over a tensor, correctly rounded.  ``s / t`` on a
    tensor computes ``t.reciprocal() * s``, which rounds twice.  The
    numerator is a 0-d CPU tensor, which torch passes to a CUDA kernel as a
    scalar (no host-to-device copy)."""
    return torch.div(torch.tensor(s, dtype=t.dtype), t)


@dataclass(frozen=True)
class Vec3:
    x: Any
    y: Any
    z: Any

    # -- constructors -------------------------------------------------------
    @staticmethod
    def full(v) -> "Vec3":
        return Vec3(v, v, v)

    @staticmethod
    def zeros(shape, device) -> "Vec3":
        z = torch.zeros(shape, dtype=torch.float32, device=device)
        return Vec3(z, z, z)

    @staticmethod
    def ones(shape, device) -> "Vec3":
        o = torch.ones(shape, dtype=torch.float32, device=device)
        return Vec3(o, o, o)

    # -- shape helpers ------------------------------------------------------
    @property
    def shape(self):
        return torch.broadcast_shapes(*(torch.as_tensor(c).shape
                                        for c in (self.x, self.y, self.z)))

    def map(self, f) -> "Vec3":
        return Vec3(f(self.x), f(self.y), f(self.z))

    def broadcast_to(self, shape) -> "Vec3":
        return self.map(lambda c: c.expand(shape))

    # -- arithmetic ---------------------------------------------------------
    @staticmethod
    def _coerce(other) -> "Vec3":
        return other if isinstance(other, Vec3) else Vec3(other, other, other)

    def __add__(self, o):
        o = self._coerce(o)
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    __radd__ = __add__

    def __sub__(self, o):
        o = self._coerce(o)
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __rsub__(self, o):
        o = self._coerce(o)
        return Vec3(o.x - self.x, o.y - self.y, o.z - self.z)

    def __mul__(self, o):
        o = self._coerce(o)
        return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)

    __rmul__ = __mul__

    def __truediv__(self, o):
        o = self._coerce(o)
        return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # -- geometry -----------------------------------------------------------
    def dot(self, o: "Vec3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_squared(self):
        return self.dot(self)

    def normalized(self, eps: float = 0.0) -> "Vec3":
        return self * torch.rsqrt(self.length_squared() + eps)

    # -- elementwise helpers ------------------------------------------------
    def exp(self) -> "Vec3":
        return self.map(torch.exp)

    def sqrt(self) -> "Vec3":
        return self.map(torch.sqrt)

    def max_component(self):
        return fmax(self.x, fmax(self.y, self.z))

    def luminance(self):
        """Rec.709 luminance."""
        return 0.2126 * self.x + 0.7152 * self.y + 0.0722 * self.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return a.cross(b)


def normalize(a: Vec3, eps: float = 0.0) -> Vec3:
    return a.normalized(eps)


def lerp(a, b, t):
    """a + (b - a) * t for Vec3 or scalar operands."""
    if isinstance(a, Vec3) or isinstance(b, Vec3):
        a = a if isinstance(a, Vec3) else Vec3.full(a)
        b = b if isinstance(b, Vec3) else Vec3.full(b)
    return a + (b - a) * t


def clamp01(v):
    if isinstance(v, Vec3):
        return v.map(lambda c: torch.clamp(c, 0.0, 1.0))
    return torch.clamp(v, 0.0, 1.0)


def vmin(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(fmin(a.x, b.x), fmin(a.y, b.y), fmin(a.z, b.z))


def vmax(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(fmax(a.x, b.x), fmax(a.y, b.y), fmax(a.z, b.z))


def where(cond, a, b) -> Vec3:
    """Per-lane select between two Vec3 (or scalar) operands."""
    a = a if isinstance(a, Vec3) else Vec3.full(a)
    b = b if isinstance(b, Vec3) else Vec3.full(b)
    return Vec3(torch.where(cond, a.x, b.x), torch.where(cond, a.y, b.y),
                torch.where(cond, a.z, b.z))


def reflect(i: Vec3, n: Vec3) -> Vec3:
    """I - 2*dot(I,N)*N."""
    return i - n * (2.0 * i.dot(n))


def clamp_vector_soft(v: Vec3, max_lum) -> Vec3:
    """Luminance-preserving soft clamp."""
    lum = v.luminance()
    scale = torch.where((lum > max_lum) & (lum > 0.0),
                        sdiv(max_lum, fmax(lum, 1e-30)), 1.0)
    return v * scale


PI = _math.pi
TWO_PI = 2.0 * _math.pi
