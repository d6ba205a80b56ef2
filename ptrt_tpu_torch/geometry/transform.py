"""TRS transforms and AABBs (host, numpy) — a copy of the parts of
``ptrt_tpu/geometry/transform.py`` that scene assembly and instances need.

``Transform3D`` keeps translation / Euler rotation (radians) / scale and
derives the world, inverse and normal matrices (column vectors); the
inverse and normal matrices are computed in float64 from the float32 world
matrix and rounded once, as the reference does, so the instance rows are
bit-equal."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _rot_xyz(rx, ry, rz) -> np.ndarray:
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


@dataclass
class Transform3D:
    position: tuple = (0.0, 0.0, 0.0)
    rotation: tuple = (0.0, 0.0, 0.0)  # Euler XYZ, radians
    scale: tuple = (1.0, 1.0, 1.0)

    def set_position(self, x, y, z) -> "Transform3D":
        self.position = (float(x), float(y), float(z))
        return self

    def set_rotation(self, rx, ry, rz) -> "Transform3D":
        self.rotation = (float(rx), float(ry), float(rz))
        return self

    def set_scale(self, sx, sy=None, sz=None) -> "Transform3D":
        if sy is None:
            sy = sz = sx
        self.scale = (float(sx), float(sy), float(sz))
        return self

    def translate(self, dx, dy, dz) -> "Transform3D":
        p = self.position
        self.position = (p[0] + dx, p[1] + dy, p[2] + dz)
        return self

    def rotate(self, drx, dry, drz) -> "Transform3D":
        r = self.rotation
        self.rotation = (r[0] + drx, r[1] + dry, r[2] + drz)
        return self

    def is_identity(self) -> bool:
        return (self.position == (0.0, 0.0, 0.0)
                and self.rotation == (0.0, 0.0, 0.0)
                and self.scale == (1.0, 1.0, 1.0))

    def world_matrix(self) -> np.ndarray:
        m = np.eye(4, dtype=np.float64)
        r = _rot_xyz(*self.rotation)
        m[:3, :3] = r * np.asarray(self.scale)[None, :]
        m[:3, 3] = self.position
        return m.astype(np.float32)

    def inverse_matrix(self) -> np.ndarray:
        return np.linalg.inv(self.world_matrix().astype(np.float64)).astype(
            np.float32)

    def normal_matrix(self) -> np.ndarray:
        """The inverse transpose of the world matrix's 3x3 part (4x4)."""
        w = self.world_matrix().astype(np.float64)
        n = np.eye(4)
        n[:3, :3] = np.linalg.inv(w[:3, :3]).T
        return n.astype(np.float32)

    def copy(self) -> "Transform3D":
        return Transform3D(self.position, self.rotation, self.scale)


def lerp_transform(a: Transform3D, b: Transform3D, t: float) -> Transform3D:
    """Componentwise TRS lerp (``transform.cuh:497-511``)."""
    l = lambda x, y: tuple(x[i] + (y[i] - x[i]) * t for i in range(3))
    return Transform3D(l(a.position, b.position), l(a.rotation, b.rotation),
                       l(a.scale, b.scale))


def orbit_around(center, radius, angle, height=0.0) -> tuple:
    """Orbit animation helper (``transform.cuh:513-524``)."""
    return (center[0] + radius * np.cos(angle), center[1] + height,
            center[2] + radius * np.sin(angle))


def oscillate(base, axis, amplitude, phase) -> tuple:
    """Oscillation helper (``transform.cuh:526-539``)."""
    off = amplitude * np.sin(phase)
    a = np.asarray(axis, np.float64)
    a = a / max(np.linalg.norm(a), 1e-12)
    return tuple(np.asarray(base) + a * off)


@dataclass
class AABB:
    lo: np.ndarray
    hi: np.ndarray

    @staticmethod
    def empty() -> "AABB":
        return AABB(np.full(3, np.inf), np.full(3, -np.inf))

    @staticmethod
    def of_points(pts: np.ndarray) -> "AABB":
        return AABB(pts.min(axis=0), pts.max(axis=0))

    def union(self, other: "AABB") -> "AABB":
        return AABB(np.minimum(self.lo, other.lo),
                    np.maximum(self.hi, other.hi))

    def transformed(self, m: np.ndarray) -> "AABB":
        """The box of the 8 transformed corners."""
        corners = np.array(
            [[x, y, z] for x in (self.lo[0], self.hi[0])
             for y in (self.lo[1], self.hi[1])
             for z in (self.lo[2], self.hi[2])])
        w = (m[:3, :3] @ corners.T).T + m[:3, 3]
        return AABB(w.min(axis=0), w.max(axis=0))
