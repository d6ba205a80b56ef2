"""4x4 matrix helpers for the camera and motion vectors — counterpart of
``ptrt_tpu/core/mat.py`` (``look_at``, ``perspective``, ``inverse``,
``project_point``).

The same convention as the reference: float32 ``(4, 4)`` tensors acting on
column vectors (``p' = M @ p``), translation in ``M[:3, 3]``.
"""

from __future__ import annotations

import torch

from ptrt_tpu_torch.core.vec import Vec3, sdiv


def look_at(eye: Vec3, target: Vec3, up: Vec3) -> torch.Tensor:
    """GL-style view matrix from 0-d float32 components."""
    f = (target - eye).normalized()
    s = f.cross(up).normalized()
    u = s.cross(f)
    ex, ey, ez = eye.x, eye.y, eye.z
    zero, one = torch.zeros_like(ex), torch.ones_like(ex)
    return torch.stack([
        torch.stack([s.x, s.y, s.z, -(s.x * ex + s.y * ey + s.z * ez)]),
        torch.stack([u.x, u.y, u.z, -(u.x * ex + u.y * ey + u.z * ez)]),
        torch.stack([-f.x, -f.y, -f.z, (f.x * ex + f.y * ey + f.z * ez)]),
        torch.stack([zero, zero, zero, one]),
    ]).to(torch.float32)


def perspective(fov_y_rad: torch.Tensor, aspect: torch.Tensor, z_near: float,
                z_far: float) -> torch.Tensor:
    """GL-style perspective projection; ``fov_y_rad`` and ``aspect`` are 0-d
    float32 tensors, the clip planes Python floats (as in ``Camera.make``)."""
    f = sdiv(1.0, torch.tan(fov_y_rad / 2.0))
    a = (z_far + z_near) / (z_near - z_far)
    b = (2.0 * z_far * z_near) / (z_near - z_far)
    m = torch.zeros((4, 4), dtype=torch.float32, device=f.device)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = a
    m[2, 3] = b
    m[3, 2] = -1.0
    return m


def inverse(m: torch.Tensor) -> torch.Tensor:
    """LU inverse in float32, as ``jnp.linalg.inv``."""
    return torch.linalg.inv(m)


def project_point(m: torch.Tensor, p: Vec3):
    """Full projective transform with the perspective divide, ``1/w``
    guarded at 1e-12.  Returns (Vec3 ndc, w)."""
    x = m[0, 0] * p.x + m[0, 1] * p.y + m[0, 2] * p.z + m[0, 3]
    y = m[1, 0] * p.x + m[1, 1] * p.y + m[1, 2] * p.z + m[1, 3]
    z = m[2, 0] * p.x + m[2, 1] * p.y + m[2, 2] * p.z + m[2, 3]
    w = m[3, 0] * p.x + m[3, 1] * p.y + m[3, 2] * p.z + m[3, 3]
    inv_w = sdiv(1.0, torch.where(torch.abs(w) < 1e-12, 1e-12, w))
    return Vec3(x * inv_w, y * inv_w, z * inv_w), w

