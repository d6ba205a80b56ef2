"""SoA 3-vector math on torch tensors.

Counterpart of ``ptrt_tpu/core/vec.py``: a ``Vec3`` holds three component
tensors of one broadcast shape, so every vector op is a plain elementwise
torch op over the whole ray batch.  Components may be tensors or Python
scalars; free functions mirror the reference's names.
"""

from __future__ import annotations

import math as _math
from dataclasses import dataclass
from typing import Any, Union

import torch

Scalar = Union[float, int, torch.Tensor]


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

    @staticmethod
    def from_array(a, device=None) -> "Vec3":
        """From an array or tensor whose last axis is 3 (host interop)."""
        a = torch.as_tensor(a, device=device)
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    def to_array(self) -> torch.Tensor:
        """The components stacked into a trailing axis of 3."""
        x, y, z = torch.broadcast_tensors(*(torch.as_tensor(c) for c in (
            self.x, self.y, self.z)))
        return torch.stack([x, y, z], dim=-1)

    # -- shape helpers ------------------------------------------------------
    @property
    def shape(self):
        return torch.broadcast_shapes(*(torch.as_tensor(c).shape
                                        for c in (self.x, self.y, self.z)))

    @property
    def dtype(self):
        a, b, c = (torch.as_tensor(v).dtype for v in (self.x, self.y,
                                                      self.z))
        return torch.promote_types(torch.promote_types(a, b), c)

    def astype(self, dtype) -> "Vec3":
        return self.map(lambda c: torch.as_tensor(c).to(dtype))

    def map(self, f) -> "Vec3":
        return Vec3(f(self.x), f(self.y), f(self.z))

    def reshape(self, *shape) -> "Vec3":
        return self.map(lambda c: torch.reshape(c, shape))

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

    def length(self):
        return torch.sqrt(self.length_squared())

    def normalized(self, eps: float = 0.0) -> "Vec3":
        return self * torch.rsqrt(self.length_squared() + eps)

    # -- elementwise helpers ------------------------------------------------
    def abs(self) -> "Vec3":
        return self.map(torch.abs)

    def exp(self) -> "Vec3":
        return self.map(torch.exp)

    def log(self) -> "Vec3":
        return self.map(torch.log)

    def sqrt(self) -> "Vec3":
        return self.map(torch.sqrt)

    def pow(self, p) -> "Vec3":
        return Vec3(self.x**p, self.y**p, self.z**p)

    def min_component(self):
        return fmin(self.x, fmin(self.y, self.z))

    def max_component(self):
        return fmax(self.x, fmax(self.y, self.z))

    def sum(self):
        return self.x + self.y + self.z

    def luminance(self):
        """Rec.709 luminance."""
        return 0.2126 * self.x + 0.7152 * self.y + 0.0722 * self.z


def vec3(x: Scalar, y: Scalar = None, z: Scalar = None) -> Vec3:
    """``vec3(v)`` broadcasts, ``vec3(x, y, z)``."""
    if y is None:
        return Vec3.full(x)
    return Vec3(x, y, z)


def dot(a: Vec3, b: Vec3):
    return a.dot(b)


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


def clamp(v, lo, hi):
    if isinstance(v, Vec3):
        return v.map(lambda c: torch.clamp(c, lo, hi))
    return torch.clamp(v, lo, hi)


def clamp01(v):
    return clamp(v, 0.0, 1.0)


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


def refract(i: Vec3, n: Vec3, eta):
    """Snell refraction: (T, ok mask)."""
    ndoti = n.dot(i)
    k = 1.0 - eta * eta * (1.0 - ndoti * ndoti)
    ok = k >= 0.0
    t = i * eta - n * (eta * ndoti + torch.sqrt(fmax(k, 0.0)))
    return t, ok


def face_forward(n: Vec3, i: Vec3) -> Vec3:
    """N flipped to face against I."""
    return where(n.dot(i) < 0.0, n, -n)


def clamp_vector_soft(v: Vec3, max_lum) -> Vec3:
    """Luminance-preserving soft clamp."""
    lum = v.luminance()
    scale = torch.where((lum > max_lum) & (lum > 0.0),
                        sdiv(max_lum, fmax(lum, 1e-30)), 1.0)
    return v * scale


def clamp_vector(v: Vec3, max_len) -> Vec3:
    """Euclidean-length hard clamp."""
    len_sq = v.length_squared()
    scale = torch.where(len_sq > max_len * max_len,
                        max_len * torch.rsqrt(fmax(len_sq, 1e-30)), 1.0)
    return v * scale


PI = _math.pi
TWO_PI = 2.0 * _math.pi
INV_PI = 1.0 / _math.pi
