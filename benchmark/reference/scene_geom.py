"""The reference's triangle table: every mesh's world-space triangles in
mesh order, with the long ones bisected as the port's geometry bisects
them (``_presplit_tris`` and ``PRESPLIT_FRAC`` are a frozen copy of
``ptrt_tpu_torch/geometry/scene_geom.py``'s), and no acceleration
structure: the reference's walks test every triangle a ray's chunk box
admits (``traverse.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference.vec import Vec3


@dataclass(frozen=True)
class Triangles:
    """The triangles as (M,) planes: a vertex, the two edges from it, the
    mesh (material) id and whether the triangle occludes shadow rays."""

    v0: Vec3
    e1: Vec3
    e2: Vec3
    mesh_id: torch.Tensor  # int32
    shadow_opaque: torch.Tensor  # bool

    @property
    def count(self) -> int:
        return int(self.mesh_id.shape[0])


# Any triangle whose longest edge exceeds PRESPLIT_FRAC x the scene's AABB
# diagonal (and 16x the median longest edge) is bisected at that edge's
# midpoint until it is not: giant ground-plane triangles would otherwise
# hang huge leaf boxes across the whole tree.  The split is exact
# (coplanar children cover the same surface).
PRESPLIT_FRAC = 0.125


def _presplit_tris(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                   mid: np.ndarray, frac: float):
    """Longest-edge bisection.  Returns (v0, v1, v2, mid)."""
    if frac <= 0.0 or v0.shape[0] == 0:
        return v0, v1, v2, mid
    allv = np.concatenate([v0, v1, v2])
    diag = float(np.linalg.norm(allv.max(0) - allv.min(0)))
    if not np.isfinite(diag) or diag <= 0.0:
        return v0, v1, v2, mid
    e0 = np.stack([((v1 - v0) ** 2).sum(1), ((v2 - v1) ** 2).sum(1),
                   ((v0 - v2) ** 2).sum(1)], axis=1).max(1)
    med = float(np.sqrt(np.median(e0)))
    thr2 = max(frac * diag, 16.0 * med) ** 2
    # each round halves the longest edge of every oversized triangle
    for _ in range(32):
        e = np.stack([
            ((v1 - v0) ** 2).sum(1),
            ((v2 - v1) ** 2).sum(1),
            ((v0 - v2) ** 2).sum(1)], axis=1)
        k = e.argmax(1)
        big = e[np.arange(e.shape[0]), k] > thr2
        if not big.any():
            break
        bs = np.where(big)[0]
        a, b, c, m_, kb = v0[bs], v1[bs], v2[bs], mid[bs], k[bs]
        # rotate so the longest edge is (a, b) — winding preserved
        a2 = np.where((kb == 1)[:, None], b, np.where((kb == 2)[:, None], c, a))
        b2 = np.where((kb == 1)[:, None], c, np.where((kb == 2)[:, None], a, b))
        c2 = np.where((kb == 1)[:, None], a, np.where((kb == 2)[:, None], b, c))
        mp = 0.5 * (a2 + b2)
        keep = ~big
        v0 = np.concatenate([v0[keep], a2, mp])
        v1 = np.concatenate([v1[keep], mp, b2])
        v2 = np.concatenate([v2[keep], c2, c2])
        mid = np.concatenate([mid[keep], m_, m_])
    return (np.ascontiguousarray(v0, np.float32),
            np.ascontiguousarray(v1, np.float32),
            np.ascontiguousarray(v2, np.float32),
            np.ascontiguousarray(mid, np.int32))


def triangles(meshes, material_transmission, device) -> Triangles:
    """The world-space triangles of ``meshes`` (mesh ``i``'s id ``i``) on
    ``device``; a triangle whose material's transmission exceeds 0.5 lets
    shadow rays through."""
    v0s, v1s, v2s, mids = [], [], [], []
    for i, m in enumerate(meshes):
        a, b, c = m.triangle_arrays(world=True)
        v0s.append(a)
        v1s.append(b)
        v2s.append(c)
        mids.append(np.full(a.shape[0], i, np.int32))
    v0, v1, v2, mid = (np.concatenate(x) for x in (v0s, v1s, v2s, mids))
    v0, v1, v2, mid = _presplit_tris(v0, v1, v2, mid, PRESPLIT_FRAC)
    trans = np.asarray(material_transmission, np.float32)
    opaque = trans[mid] <= 0.5
    e1 = v1 - v0
    e2 = v2 - v0
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    dvec = lambda a: Vec3(dev(a[:, 0]), dev(a[:, 1]), dev(a[:, 2]))
    return Triangles(dvec(v0), dvec(e1), dvec(e2), dev(mid), dev(opaque))
