"""PCG random stream and importance-sampling routines.

Counterpart of ``ptrt_tpu/core/rng.py``.  The state is an explicit per-lane
tensor threaded functionally: every draw returns ``(new_state, sample)``.
The reference's bits are the algorithm here, so the stream is reproduced
bit for bit.  torch on the CPU lacks ``uint32`` add and shift, so the state
is an ``int64`` tensor holding values in [0, 2^32) and every multiply and
add is masked back to 32 bits (a wrapped int64 product keeps its low 32
bits, so the mask is exact).
"""

from __future__ import annotations

import torch

from benchmark.reference.vec import TWO_PI, Vec3, cross, fmax, fmin, where

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9


def as_u32(x, device=None) -> torch.Tensor:
    """An integer tensor (or Python int) as int64 values in [0, 2^32)."""
    return torch.as_tensor(x, device=device).to(torch.int64) & MASK32


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2^32`` for ``a`` in [0, 2^32) without int64 overflow:
    the constant is split into 16-bit halves."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


# -- PCG core ---------------------------------------------------------------


def seed(x, y, frame) -> torch.Tensor:
    """Hash pixel coords + frame into an initial state, then advance twice
    to decorrelate."""
    x = as_u32(x)
    y = as_u32(y, x.device)
    f = as_u32(frame, x.device)
    state = (((x * 1973) & MASK32) ^ ((y * 9277) & MASK32)
             ^ ((f * 26699) & MASK32) ^ GOLDEN)
    state, _ = uniform(state)
    state, _ = uniform(state)
    return state


def fold(state: torch.Tensor, salt) -> torch.Tensor:
    """Decorrelated sub-stream: golden-ratio salt mix + one PCG advance.
    ``salt``: a Python int, mixed on the host."""
    s = state ^ mul32(salt & MASK32, GOLDEN)
    s, _ = uniform(s)
    return s


def uniform(state: torch.Tensor):
    """One PCG step -> float32 in [0, 1)."""
    state = (state * 747796405 + 2891336453) & MASK32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    word = (word >> 22) ^ word
    return state, word.to(torch.float32) * 2.3283064365386963e-10


def uniform2(state: torch.Tensor):
    state, u1 = uniform(state)
    state, u2 = uniform(state)
    return state, u1, u2


# -- orthonormal basis ------------------------------------------------------


def ortho_normal_basis(n: Vec3):
    """Frisvad-style tangent frame; degenerate normals take the canonical
    frame by a select."""
    len2 = n.dot(n)
    nn = n * torch.rsqrt(fmax(len2, 1e-30))
    s = torch.where(nn.z >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + nn.z)
    b = nn.x * nn.y * a
    t = Vec3(1.0 + s * nn.x * nn.x * a, s * b, -s * nn.x)
    bt = cross(nn, t)
    degenerate = len2 < 1e-20
    t = where(degenerate, Vec3(1.0, 0.0, 0.0), t)
    bt = where(degenerate, Vec3(0.0, 1.0, 0.0), bt)
    return t, bt


def hemisphere_to_world(sample: Vec3, n: Vec3) -> Vec3:
    t, b = ortho_normal_basis(n)
    return t * sample.x + b * sample.y + n * sample.z


# -- direction sampling -----------------------------------------------------


def sample_cosine_hemisphere(state):
    """Cosine-weighted local hemisphere sample (two draws)."""
    state, u1, u2 = uniform2(state)
    return state, cosine_hemisphere_from(u1, u2)


def sample_unit_sphere(state):
    """Uniform sphere direction (two draws)."""
    state, u1, u2 = uniform2(state)
    z = 1.0 - 2.0 * u1
    r = torch.sqrt(fmax(1.0 - z * z, 0.0))
    phi = TWO_PI * u2
    return state, Vec3(r * torch.cos(phi), r * torch.sin(phi), z)


def importance_sample_ggx(state, n: Vec3, roughness):
    """GGX half-vector importance sample in the frame of N (two draws)."""
    state, u1, u2 = uniform2(state)
    return state, ggx_half_vector_from(u1, u2, n, roughness)


def cone_direction_from(u1, u2, cone_dir: Vec3, cos_theta_max) -> Vec3:
    cos_theta = 1.0 - u1 * (1.0 - cos_theta_max)
    sin_theta = torch.sqrt(fmax(1.0 - cos_theta * cos_theta, 0.0))
    phi = TWO_PI * u2
    local = Vec3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
                 cos_theta)
    t, b = ortho_normal_basis(cone_dir)
    return t * local.x + b * local.y + cone_dir * local.z


def sample_cone_direction(state, cone_dir: Vec3, cos_theta_max):
    """Uniform direction in a cone around ``cone_dir`` (soft shadows)."""
    state, u1, u2 = uniform2(state)
    return state, cone_direction_from(u1, u2, cone_dir, cos_theta_max)


def cosine_hemisphere_from(u1, u2) -> Vec3:
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    return Vec3(r * torch.cos(phi), r * torch.sin(phi),
                torch.sqrt(fmax(1.0 - u1, 0.0)))


def ggx_half_vector_from(u1, u2, n: Vec3, roughness) -> Vec3:
    a = roughness * roughness
    a2 = a * a
    u2c = fmin(u2, 0.9999999)
    phi = TWO_PI * u1
    cos_theta = torch.sqrt((1.0 - u2c) / (1.0 + (a2 - 1.0) * u2c))
    sin_theta = torch.sqrt(fmax(1.0 - cos_theta * cos_theta, 0.0))
    h = Vec3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
             cos_theta)
    return hemisphere_to_world(h, n)


def sample_unit_disk(state):
    """Polar-mapped unit-disk sample for depth of field."""
    state, u1, u2 = uniform2(state)
    r = torch.sqrt(u1)
    phi = TWO_PI * u2
    return state, Vec3(r * torch.cos(phi), r * torch.sin(phi),
                       torch.zeros_like(r))
