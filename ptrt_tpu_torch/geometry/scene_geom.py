"""Device scene geometry: packed world-space triangles + 8-wide BVH.

Counterpart of ``ptrt_tpu/geometry/scene_geom.py`` for a flat scene (all
meshes static): every mesh's triangles are transformed to world space on
the host, oversized triangles are pre-split, one 8-wide BVH is built, and
the packed tables become device tensors.  Instances, refit and the device
LBVH are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.geometry.bvh import LEAF_SIZE, reorder_padded
from ptrt_tpu_torch.geometry.bvh8 import build_bvh8, pack_node_rows
from ptrt_tpu_torch.geometry.mesh import Mesh


@dataclass(frozen=True)
class SceneGeometry:
    """Device tables of one assembled scene.

    * ``node_rows`` (N, 64) f32: 8-wide BVH nodes (layout in bvh8.py);
    * ``tri_rows`` (B, LEAF_SIZE*10) f32: one leaf per row, field-major
      ``[v0x*L v0y*L v0z*L e1x*L .. e2z*L packed_id*L]`` with
      ``packed_id = float((mesh_id << 1) | shadow_opaque)``;
    * SoA views of the same triangles in leaf-block order (padded, length
      M = B*LEAF_SIZE) for the brute-force plain walks and for hit
      reconstruction.
    """

    node_rows: torch.Tensor  # (N, 64) f32
    tri_rows: torch.Tensor  # (B, LEAF_SIZE*10) f32
    v0: Vec3
    e1: Vec3
    e2: Vec3
    tri_mesh_id: torch.Tensor  # int32, -1 for padding
    tri_shadow_opaque: torch.Tensor  # bool: occludes shadow rays
    stack_depth: int = 16  # wide-tree depth bound (walk stack size)

    @property
    def num_nodes(self) -> int:
        return int(self.node_rows.shape[0])

    @property
    def num_tri_slots(self) -> int:
        return int(self.tri_mesh_id.shape[0])

    @property
    def device(self) -> torch.device:
        return self.node_rows.device


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


def assemble_geometry(meshes: list[Mesh],
                      material_transmission: list[float] | None,
                      device, leaf_size: int = LEAF_SIZE) -> SceneGeometry:
    """Build packed geometry + BVH from host meshes onto ``device``.

    ``material_transmission[i]`` is mesh ``i``'s material transmission;
    occluders with transmission > 0.5 are skipped by shadow rays."""
    v0s, v1s, v2s, mids = [], [], [], []
    for i, m in enumerate(meshes):
        a, b, c = m.triangle_arrays()
        v0s.append(a)
        v1s.append(b)
        v2s.append(c)
        mids.append(np.full(a.shape[0], i, np.int32))
    if v0s:
        v0 = np.concatenate(v0s)
        v1 = np.concatenate(v1s)
        v2 = np.concatenate(v2s)
        mid = np.concatenate(mids)
    else:
        v0 = v1 = v2 = np.zeros((0, 3), np.float32)
        mid = np.zeros((0,), np.int32)

    v0, v1, v2, mid = _presplit_tris(v0, v1, v2, mid, PRESPLIT_FRAC)
    bvh = build_bvh8(v0, v1, v2, leaf_size)

    pv0 = reorder_padded(v0, bvh.order)
    pv1 = reorder_padded(v1, bvh.order)
    pv2 = reorder_padded(v2, bvh.order)
    pmid = reorder_padded(mid, bvh.order, fill=-1)

    if not material_transmission:
        opaque = pmid >= 0
    else:
        trans = np.asarray(material_transmission, np.float32)
        opaque = np.where(pmid >= 0, trans[np.maximum(pmid, 0)] <= 0.5, False)

    e1 = pv1 - pv0
    e2 = pv2 - pv0

    n_blocks = max(1, pmid.shape[0] // leaf_size)
    packed_id = ((pmid.astype(np.int32) << 1)
                 | opaque.astype(np.int32)).astype(np.float32)
    fields = [pv0[:, 0], pv0[:, 1], pv0[:, 2],
              e1[:, 0], e1[:, 1], e1[:, 2],
              e2[:, 0], e2[:, 1], e2[:, 2],
              packed_id]
    tri_rows = np.concatenate(
        [np.asarray(f, np.float32).reshape(n_blocks, leaf_size)
         for f in fields], axis=1)

    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    dvec = lambda a: Vec3(dev(a[:, 0]), dev(a[:, 1]), dev(a[:, 2]))
    return SceneGeometry(
        node_rows=dev(pack_node_rows(bvh)),
        tri_rows=dev(tri_rows),
        v0=dvec(pv0),
        e1=dvec(e1),
        e2=dvec(e2),
        tri_mesh_id=dev(pmid.astype(np.int32)),
        tri_shadow_opaque=dev(opaque),
        stack_depth=int(bvh.max_depth) + 2,
    )
