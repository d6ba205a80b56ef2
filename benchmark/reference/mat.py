"""4x4 matrix helpers — counterpart of ``ptrt_tpu/core/mat.py``: the
camera's and the motion vectors' (``look_at``, ``perspective``, ``inverse``,
``project_point``) and the TRS machinery (``translate``, ``scale``, the
rotations, ``trs``, the point / direction / normal transforms).

The same convention as the reference: float32 ``(4, 4)`` tensors acting on
column vectors (``p' = M @ p``), translation in ``M[:3, 3]``, composed right
to left (``world = T @ R @ S``).  A scalar argument is a Python number or a
0-d tensor; the result lies on ``device`` (the default: the argument's
device, else the CPU).
"""

from __future__ import annotations

import torch

from benchmark.reference.vec import Vec3, sdiv


def _f32(v, device=None) -> torch.Tensor:
    """A 0-d (or batched) float32 tensor of ``v``."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=torch.float32, device=device or v.device)
    return torch.tensor(v, dtype=torch.float32, device=device)


def _device(*vals):
    for v in vals:
        if isinstance(v, torch.Tensor):
            return v.device
    return None


def _unpack3(v):
    if isinstance(v, Vec3):
        return v.x, v.y, v.z
    return v[0], v[1], v[2]


def identity(device=None) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device)


def translate(t, device=None) -> torch.Tensor:
    """``t``: a Vec3 or three numbers."""
    tx, ty, tz = _unpack3(t)
    dev = device or _device(tx, ty, tz)
    m = identity(dev)
    m[0, 3], m[1, 3], m[2, 3] = (_f32(c, dev) for c in (tx, ty, tz))
    return m


def scale(s, device=None) -> torch.Tensor:
    """``s``: a Vec3, three numbers or one number for all axes."""
    if isinstance(s, (int, float)):
        s = (s, s, s)
    sx, sy, sz = _unpack3(s)
    dev = device or _device(sx, sy, sz)
    return torch.diag(torch.stack([_f32(sx, dev), _f32(sy, dev),
                                   _f32(sz, dev),
                                   torch.ones((), device=dev)]))


def _rotation(a, cells, device=None) -> torch.Tensor:
    """A rotation about one axis: ``cells`` lists (row, col, which) with
    ``which`` in "c", "s", "-s"; the rest of the identity's 3x3 stays."""
    a = _f32(a, device)
    c, s = torch.cos(a), torch.sin(a)
    m = identity(a.device)
    for r, col, which in cells:
        m[r, col] = {"c": c, "s": s, "-s": -s}[which]
    return m


def rotation_x(a, device=None) -> torch.Tensor:
    return _rotation(a, ((1, 1, "c"), (1, 2, "-s"), (2, 1, "s"),
                         (2, 2, "c")), device)


def rotation_y(a, device=None) -> torch.Tensor:
    return _rotation(a, ((0, 0, "c"), (0, 2, "s"), (2, 0, "-s"),
                         (2, 2, "c")), device)


def rotation_z(a, device=None) -> torch.Tensor:
    return _rotation(a, ((0, 0, "c"), (0, 1, "-s"), (1, 0, "s"),
                         (1, 1, "c")), device)


def rotation_euler_xyz(rx, ry, rz, device=None) -> torch.Tensor:
    """R = Rz @ Ry @ Rx: X applied first, then Y, then Z."""
    dev = device or _device(rx, ry, rz)
    return (rotation_z(rz, dev) @ rotation_y(ry, dev)) @ rotation_x(rx, dev)


def rotation_axis_angle(axis: Vec3, angle, device=None) -> torch.Tensor:
    """Rodrigues' rotation about ``axis`` (normalised here)."""
    dev = device or _device(axis.x, axis.y, axis.z, angle)
    ax = Vec3(*[_f32(c, dev) for c in (axis.x, axis.y, axis.z)]).normalized()
    x, y, z = ax.x, ax.y, ax.z
    a = _f32(angle, dev)
    c, s = torch.cos(a), torch.sin(a)
    C = 1.0 - c
    r = torch.stack([
        torch.stack([c + x * x * C, x * y * C - z * s, x * z * C + y * s]),
        torch.stack([y * x * C + z * s, c + y * y * C, y * z * C - x * s]),
        torch.stack([z * x * C - y * s, z * y * C + x * s, c + z * z * C]),
    ])
    m = identity(dev)
    m[:3, :3] = r
    return m


def trs(translation: Vec3, rotation_euler: Vec3, scl: Vec3,
        device=None) -> torch.Tensor:
    """world = T @ Rz Ry Rx @ S."""
    dev = device or _device(*_unpack3(translation), *_unpack3(rotation_euler),
                            *_unpack3(scl))
    return (translate(translation, dev)
            @ rotation_euler_xyz(*_unpack3(rotation_euler), device=dev)
            ) @ scale(scl, dev)


def inverse_rigid_trs(m: torch.Tensor) -> torch.Tensor:
    """The inverse of a T @ R @ S matrix (as the reference: an LU
    inverse)."""
    return torch.linalg.inv(m)


def transform_point(m: torch.Tensor, p: Vec3) -> Vec3:
    """(M @ [p, 1]).xyz, the divide skipped (an affine M)."""
    x = m[0, 0] * p.x + m[0, 1] * p.y + m[0, 2] * p.z + m[0, 3]
    y = m[1, 0] * p.x + m[1, 1] * p.y + m[1, 2] * p.z + m[1, 3]
    z = m[2, 0] * p.x + m[2, 1] * p.y + m[2, 2] * p.z + m[2, 3]
    return Vec3(x, y, z)


def transform_dir(m: torch.Tensor, d: Vec3) -> Vec3:
    """The rotation and scale part only."""
    x = m[0, 0] * d.x + m[0, 1] * d.y + m[0, 2] * d.z
    y = m[1, 0] * d.x + m[1, 1] * d.y + m[1, 2] * d.z
    z = m[2, 0] * d.x + m[2, 1] * d.y + m[2, 2] * d.z
    return Vec3(x, y, z)


def transform_normal(normal_matrix: torch.Tensor, n: Vec3) -> Vec3:
    """By the inverse transpose, normalised."""
    return transform_dir(normal_matrix, n).normalized(1e-30)


def normal_matrix(world: torch.Tensor) -> torch.Tensor:
    """The inverse transpose of the upper 3x3, embedded in a 4x4."""
    inv = torch.linalg.inv(world)
    out = identity(world.device)
    out[:3, :3] = inv[:3, :3].T
    return out


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
    # fill_, not an item assignment: a Python number assigned to a CUDA
    # element is copied from the host and waits for the card
    m[2, 2].fill_(a)
    m[2, 3].fill_(b)
    m[3, 2].fill_(-1.0)
    return m


def inverse(m: torch.Tensor) -> torch.Tensor:
    """LU inverse in float32, as ``jnp.linalg.inv`` (which returns what the
    LU gives for a singular matrix, so nothing is checked: no read of the
    card)."""
    return torch.linalg.inv_ex(m)[0]


def project_point(m: torch.Tensor, p: Vec3):
    """Full projective transform with the perspective divide, ``1/w``
    guarded at 1e-12.  Returns (Vec3 ndc, w)."""
    x = m[0, 0] * p.x + m[0, 1] * p.y + m[0, 2] * p.z + m[0, 3]
    y = m[1, 0] * p.x + m[1, 1] * p.y + m[1, 2] * p.z + m[1, 3]
    z = m[2, 0] * p.x + m[2, 1] * p.y + m[2, 2] * p.z + m[2, 3]
    w = m[3, 0] * p.x + m[3, 1] * p.y + m[3, 2] * p.z + m[3, 3]
    inv_w = sdiv(1.0, torch.where(torch.abs(w) < 1e-12, 1e-12, w))
    return Vec3(x * inv_w, y * inv_w, z * inv_w), w

