"""Triangle meshes (host, numpy) — a copy of the primitive factories of
``ptrt_tpu/geometry/mesh.py`` that the bench scene uses: the unit cube, the
two-triangle XZ plane and the lat-long sphere.  The OBJ loader and the other
primitives are not ported yet.

Device upload happens at scene-assembly time (``geometry/scene_geom.py``).
"""

from __future__ import annotations

import numpy as np

from ptrt_tpu_torch.core.vec import PI, TWO_PI
from ptrt_tpu_torch.geometry.transform import Transform3D


class Mesh:
    def __init__(self, vertices: np.ndarray, faces: np.ndarray):
        self.transform = Transform3D()
        self.vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
        self.faces = np.asarray(faces, np.int32).reshape(-1, 3)

    # -- factories -----------------------------------------------------------
    @staticmethod
    def from_triangles(tris: np.ndarray) -> "Mesh":
        """tris: (N, 3, 3) — three vertices per triangle."""
        tris = np.asarray(tris, np.float32).reshape(-1, 3, 3)
        n = tris.shape[0]
        return Mesh(tris.reshape(-1, 3),
                    np.arange(n * 3, dtype=np.int32).reshape(n, 3))

    @staticmethod
    def cube() -> "Mesh":
        return Mesh(
            np.array([[-0.5, -0.5, -0.5], [0.5, -0.5, -0.5], [0.5, 0.5, -0.5],
                      [-0.5, 0.5, -0.5], [-0.5, -0.5, 0.5], [0.5, -0.5, 0.5],
                      [0.5, 0.5, 0.5], [-0.5, 0.5, 0.5]], np.float32),
            np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5],
                      [0, 5, 4], [3, 7, 6], [3, 6, 2], [0, 4, 7], [0, 7, 3],
                      [1, 2, 6], [1, 6, 5]], np.int32))

    @staticmethod
    def plane_xz(plane_y: float, half_size: float) -> "Mesh":
        """Two-triangle ground plane."""
        A = (-half_size, plane_y, -half_size)
        B = (half_size, plane_y, -half_size)
        C = (half_size, plane_y, half_size)
        D = (-half_size, plane_y, half_size)
        return Mesh.from_triangles(np.array([[A, C, B], [A, D, C]]))

    @staticmethod
    def sphere(segments: int = 32, radius: float = 0.5) -> "Mesh":
        """Lat-long sphere, wound so cross(e1, e2) points outward."""
        rings = sectors = segments
        r = np.arange(rings + 1)
        s = np.arange(sectors + 1)
        phi = PI * r / rings
        theta = TWO_PI * s / sectors
        y = np.cos(phi) * radius
        ring_r = np.sin(phi) * radius
        x = ring_r[:, None] * np.cos(theta)[None, :]
        z = ring_r[:, None] * np.sin(theta)[None, :]
        verts = np.stack(
            [x, np.broadcast_to(y[:, None], x.shape), z], axis=-1
        ).reshape(-1, 3)
        rr, ss = np.meshgrid(np.arange(rings), np.arange(sectors),
                             indexing="ij")
        curr = rr * (sectors + 1) + ss
        nxt = curr + sectors + 1
        f1 = np.stack([curr, curr + 1, nxt], axis=-1)
        f2 = np.stack([curr + 1, nxt + 1, nxt], axis=-1)
        faces = np.concatenate([f1.reshape(-1, 3), f2.reshape(-1, 3)], axis=0)
        return Mesh(verts, faces)

    # -- queries -------------------------------------------------------------
    @property
    def num_triangles(self) -> int:
        return int(self.faces.shape[0])

    def world_vertices(self) -> np.ndarray:
        m = self.transform.world_matrix()
        return (self.vertices @ m[:3, :3].T + m[:3, 3]).astype(np.float32)

    def triangle_arrays(self):
        """World-space (v0, v1, v2) arrays of shape (T, 3)."""
        v = self.world_vertices()
        f = self.faces
        return v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
