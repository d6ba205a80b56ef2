"""TRS transforms (host, numpy) — a copy of the parts of
``ptrt_tpu/geometry/transform.py`` that static scene assembly needs.

``Transform3D`` keeps translation / Euler rotation (radians) / scale and
derives the world matrix (column vectors)."""

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

    def world_matrix(self) -> np.ndarray:
        m = np.eye(4, dtype=np.float64)
        r = _rot_xyz(*self.rotation)
        m[:3, :3] = r * np.asarray(self.scale)[None, :]
        m[:3, 3] = self.position
        return m.astype(np.float32)
