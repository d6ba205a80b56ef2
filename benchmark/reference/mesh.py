"""Triangle meshes (host, numpy) — a copy of ``ptrt_tpu/geometry/mesh.py``:
the OBJ loader (``load_obj``, the reference's parser semantics), the
primitive factories (unit cube, XZ plane, lat-long sphere, checkerboard),
the vertex-baking edits, ``set_triangles`` (the per-frame refill hook), the
AABBs and the dynamic-mesh flags.

A mesh flagged ``is_dynamic`` keeps a local-space BVH of its own and is
walked as an instance (``geometry/scene_geom.py``): a transform edit
updates its matrix rows only, a refill of the same triangle count refits
its BVH on the device (``geometry/refit.py``), or with ``device_lbvh``
Morton-sorts and refits it (``geometry/lbvh.py``).  Device upload happens
at scene-assembly time.
"""

from __future__ import annotations

import os

import numpy as np

from benchmark.reference.vec import PI, TWO_PI
from benchmark.reference.transform import AABB, Transform3D, _rot_xyz


# the unit cube (the reference's default mesh)
_CUBE_VERTS = np.array(
    [[-0.5, -0.5, -0.5], [0.5, -0.5, -0.5], [0.5, 0.5, -0.5],
     [-0.5, 0.5, -0.5], [-0.5, -0.5, 0.5], [0.5, -0.5, 0.5],
     [0.5, 0.5, 0.5], [-0.5, 0.5, 0.5]], np.float32)
_CUBE_FACES = np.array(
    [[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
     [3, 7, 6], [3, 6, 2], [0, 4, 7], [0, 7, 3], [1, 2, 6], [1, 6, 5]],
    np.int32)


class Mesh:
    # True: a dynamic mesh's refills of the same triangle count are
    # Morton-sorted into its fixed slots on the device before the refit
    device_lbvh = False

    def __init__(self, vertices=None, faces: np.ndarray | None = None):
        """``Mesh(vertices, faces)``; ``Mesh(path)`` loads an OBJ file
        (``load_obj``, recentred on its centroid); ``Mesh()`` is the unit
        cube, as the reference's constructor forms."""
        self.transform = Transform3D()
        self.is_dynamic = False
        self.verts_dirty = True  # a vertex change: the mesh's BVH is stale
        if vertices is None:
            vertices, faces = _CUBE_VERTS, _CUBE_FACES
        elif isinstance(vertices, (str, os.PathLike)):
            if faces is not None:
                raise TypeError("Mesh(path) takes no faces")
            vertices, faces = load_obj(vertices, recenter=True)
        elif faces is None:
            raise TypeError("Mesh(vertices, faces) needs the faces")
        self.vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
        self.faces = np.asarray(faces, np.int32).reshape(-1, 3)

    # -- factories -----------------------------------------------------------
    @staticmethod
    def from_arrays(vertices: np.ndarray, faces: np.ndarray) -> "Mesh":
        return Mesh(vertices, faces)

    @staticmethod
    def from_triangles(tris: np.ndarray) -> "Mesh":
        """tris: (N, 3, 3) — three vertices per triangle."""
        tris = np.asarray(tris, np.float32).reshape(-1, 3, 3)
        n = tris.shape[0]
        return Mesh(tris.reshape(-1, 3),
                    np.arange(n * 3, dtype=np.int32).reshape(n, 3))

    @staticmethod
    def cube() -> "Mesh":
        return Mesh()

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

    @staticmethod
    def checkerboard_plane_xz(plane_y: float, tiles_per_side: int,
                              tile_size: float):
        """Returns (white_mesh, black_mesh)."""
        N = tiles_per_side
        start = -N * tile_size
        white, black = [], []
        for iz in range(2 * N):
            for ix in range(2 * N):
                x0 = start + ix * tile_size
                x1 = x0 + tile_size
                z0 = start + iz * tile_size
                z1 = z0 + tile_size
                A = (x0, plane_y, z0)
                B = (x1, plane_y, z0)
                C = (x1, plane_y, z1)
                D = (x0, plane_y, z1)
                bucket = white if ((ix + iz) & 1) == 0 else black
                bucket.append([A, C, B])
                bucket.append([A, D, C])
        return (Mesh.from_triangles(np.array(white)),
                Mesh.from_triangles(np.array(black)))

    # -- vertex-baking edits -------------------------------------------------
    def scale_verts(self, s) -> "Mesh":
        self.vertices = self.vertices * np.float32(s)
        self.verts_dirty = True
        return self

    def translate_verts(self, dx, dy, dz) -> "Mesh":
        self.vertices = self.vertices + np.array([dx, dy, dz], np.float32)
        self.verts_dirty = True
        return self

    def move_to(self, x, y, z) -> "Mesh":
        centroid = self.vertices.mean(axis=0)
        self.vertices = (self.vertices - centroid
                         + np.array([x, y, z], np.float32))
        self.verts_dirty = True
        return self

    def rotate_self_euler_xyz(self, rx, ry, rz) -> "Mesh":
        r = _rot_xyz(rx, ry, rz).astype(np.float32)
        centroid = self.vertices.mean(axis=0)
        self.vertices = (self.vertices - centroid) @ r.T + centroid
        self.verts_dirty = True
        return self

    def set_triangles(self, tris: np.ndarray) -> "Mesh":
        """Replace the geometry wholesale: the per-frame procedural-geometry
        hook (a fluid surface)."""
        tris = np.asarray(tris, np.float32).reshape(-1, 3, 3)
        self.vertices = tris.reshape(-1, 3)
        self.faces = np.arange(len(tris) * 3, dtype=np.int32).reshape(-1, 3)
        self.verts_dirty = True
        return self

    # -- queries -------------------------------------------------------------
    @property
    def num_triangles(self) -> int:
        return int(self.faces.shape[0])

    def local_aabb(self) -> AABB:
        return AABB.of_points(self.vertices)

    def world_aabb(self) -> AABB:
        return self.local_aabb().transformed(self.transform.world_matrix())

    def world_vertices(self) -> np.ndarray:
        m = self.transform.world_matrix()
        return (self.vertices @ m[:3, :3].T + m[:3, 3]).astype(np.float32)

    def triangle_arrays(self, world: bool = True):
        """(v0, v1, v2) arrays of shape (T, 3), in world space or the
        mesh's own."""
        v = self.world_vertices() if world else self.vertices
        f = self.faces
        return v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]


def load_obj(path, recenter: bool = True):
    """Read an OBJ file as (vertices (V, 3) float32, faces (F, 3) int32)
    with the reference's semantics: only ``v`` and ``f`` records, polygons
    fan-triangulated, 1-based and negative (relative) indices, ``v/vt/vn``
    suffixes ignored, records that do not parse skipped, the vertices
    recentred on their centroid.  Raises ``ValueError`` when the file holds
    no vertex or no face."""
    verts: list = []
    faces: list = []
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            if not line or line[0] == "#":
                continue
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v" and len(parts) >= 4:
                try:
                    verts.append((float(parts[1]), float(parts[2]),
                                  float(parts[3])))
                except ValueError:
                    continue
            elif parts[0] == "f":
                idx = []
                for tok in parts[1:]:
                    head = tok.split("/")[0]
                    if not head:
                        continue
                    try:
                        i = int(head)
                    except ValueError:
                        continue
                    idx.append(len(verts) + i if i < 0 else i - 1)
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
    if not verts or not faces:
        raise ValueError(f"Mesh: no valid geometry in {path}")
    v = np.asarray(verts, np.float32)
    f = np.asarray(faces, np.int32)
    if recenter:
        v = v - v.mean(axis=0, dtype=np.float64).astype(np.float32)
    return v, f
