"""Device scene geometry: packed triangles + 8-wide BVHs, flat or two-level.

Counterpart of ``ptrt_tpu/geometry/scene_geom.py``.  ``assemble_geometry``
transforms meshes to world space on the host (or keeps them in their own
space, for an instance), pre-splits oversized triangles (world only),
builds one 8-wide BVH and packs the tables as device tensors.

The two-level world (``assemble_world``): the static meshes are baked into
one world-space BVH; each dynamic mesh keeps a local-space BVH and its
transform rows (world->local affine, normal matrix, world AABB).  The
dynamic meshes' tables are concatenated into one ``InstanceSet`` whose
child-base and leaf-base columns are offset at the merge, so one walk
serves every instance from its own root (K4, ``render/traverse.py``); a
small tree over the instances' world boxes (``geometry/tlas.py``) finds
the instances a ray enters.  A transform edit replaces the set's small
matrix, AABB and tree tables only (``update_instance_set_transforms``); a
refill refits the set's tables in place on the device
(``geometry/refit.py``).  The per-instance transform
rows stay numpy on the host; the set's tables live on the scene's device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.geometry.bvh import LEAF_SIZE, reorder_padded
from ptrt_tpu_torch.geometry.bvh8 import build_bvh8, pack_node_rows
from ptrt_tpu_torch.geometry.mesh import Mesh
from ptrt_tpu_torch.geometry.tlas import build_tlas


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
    def num_tri_blocks(self) -> int:
        return int(self.tri_rows.shape[0])

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
                      device, leaf_size: int = LEAF_SIZE,
                      mesh_ids: list[int] | None = None,
                      world: bool = True,
                      presplit: bool | None = None) -> SceneGeometry:
    """Build packed geometry + BVH from host meshes onto ``device``.

    ``material_transmission[i]`` is the transmission of the material of
    emitted mesh id ``i`` (see ``mesh_ids``); occluders with transmission >
    0.5 are skipped by shadow rays.  ``mesh_ids`` overrides the id baked
    into each mesh's triangles (default: enumeration order), so an
    instance's BVH keeps the scene's global mesh index.  ``world=False``
    keeps the vertices in the mesh's own space (an instance).
    ``presplit`` (default: ``world``) bisects oversized triangles; an
    instance BVH never does, since its refit plan maps leaf slots back to
    the mesh's own triangle order.

    The build-time leaf order (original triangle per slot, -1 for a pad)
    is kept on the returned geometry as ``_host_order`` (host only) where
    no triangle was split: ``refit.build_refit_plan`` reads it."""
    if presplit is None:
        presplit = world
    v0s, v1s, v2s, mids = [], [], [], []
    for i, m in enumerate(meshes):
        a, b, c = m.triangle_arrays(world=world)
        v0s.append(a)
        v1s.append(b)
        v2s.append(c)
        gid = i if mesh_ids is None else mesh_ids[i]
        mids.append(np.full(a.shape[0], gid, np.int32))
    if v0s:
        v0 = np.concatenate(v0s)
        v1 = np.concatenate(v1s)
        v2 = np.concatenate(v2s)
        mid = np.concatenate(mids)
    else:
        v0 = v1 = v2 = np.zeros((0, 3), np.float32)
        mid = np.zeros((0,), np.int32)

    n_orig = v0.shape[0]
    if presplit:
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
    out = SceneGeometry(
        node_rows=dev(pack_node_rows(bvh)),
        tri_rows=dev(tri_rows),
        v0=dvec(pv0),
        e1=dvec(e1),
        e2=dvec(e2),
        tri_mesh_id=dev(pmid.astype(np.int32)),
        tri_shadow_opaque=dev(opaque),
        stack_depth=int(bvh.max_depth) + 2,
    )
    if v0.shape[0] == n_orig:
        object.__setattr__(out, "_host_order", np.asarray(bvh.order))
    return out


# -- two-level world: static BVH + dynamic instances -------------------------


@dataclass(frozen=True)
class Instance:
    """One dynamic mesh: its local-space BVH tables and its transform rows
    (host numpy: the set's tables are built from them)."""

    geom: SceneGeometry
    inv_rows: np.ndarray  # (3, 4) world->local affine
    nrm_rows: np.ndarray  # (3, 3) local->world normal matrix
    bb_min: np.ndarray  # (3,) world AABB
    bb_max: np.ndarray  # (3,)


@dataclass(frozen=True)
class InstanceSet:
    """Every dynamic instance merged for one walk (K4).

    ``geom``: the instances' tables concatenated, child-base and leaf-base
    columns offset (roots are not row 0: ``roots``).  ``mats`` (I, 24):
    columns 0:12 the world->local affine (3x4), 12:21 the local->world
    normal matrix (3x3), the rest zero.  ``bb_min`` / ``bb_max`` (I, 3):
    the instances' world AABBs.  ``tlas`` (nodes, width, 8): the tree over
    those boxes (``tlas.build_tlas``), rebuilt with them."""

    geom: SceneGeometry
    roots: torch.Tensor  # (I,) int32 node row of each instance's root
    mats: torch.Tensor  # (I, 24) f32
    bb_min: torch.Tensor  # (I, 3) f32
    bb_max: torch.Tensor  # (I, 3) f32
    tlas: torch.Tensor  # (nodes, width, 8) f32

    @property
    def count(self) -> int:
        return int(self.roots.shape[0])


def _patch_offsets(node_rows: torch.Tensor, node_off: int,
                   blk_off: int) -> torch.Tensor:
    """Add table offsets to the float-encoded child-base and leaf-base
    columns (48, 49) of a block of node rows; exact while the totals stay
    below 2^24."""
    out = node_rows.clone()
    out[:, 48] += np.float32(node_off)
    out[:, 49] += np.float32(blk_off)
    return out


# the merged tables' ints ride float32 values: exact below this
MAX_TABLE_INDEX = 1 << 24


def merge_instances(instances: tuple) -> InstanceSet | None:
    """Concatenate the instances' tables into one set (once a change of the
    set; transform edits go through ``update_instance_set_transforms``).
    Raises where a node or block index would reach 2^24."""
    if not instances:
        return None
    node_rows, roots = [], []
    node_off = blk_off = 0
    depth = 2
    for inst in instances:
        g = inst.geom
        roots.append(node_off)
        node_rows.append(_patch_offsets(g.node_rows, node_off, blk_off))
        node_off += g.num_nodes
        blk_off += g.num_tri_blocks
        depth = max(depth, g.stack_depth)
    if max(node_off, blk_off) >= MAX_TABLE_INDEX:
        raise ValueError(f"an instance set of {node_off} nodes and {blk_off} "
                         "blocks: its float-encoded indices reach 2^24")
    gs = [inst.geom for inst in instances]
    cat = lambda get: torch.cat([get(g) for g in gs])
    cat3 = lambda get: Vec3(*[cat(lambda g, k=k: getattr(get(g), k))
                              for k in "xyz"])
    dev = gs[0].device
    geom = SceneGeometry(
        node_rows=torch.cat(node_rows), tri_rows=cat(lambda g: g.tri_rows),
        v0=cat3(lambda g: g.v0), e1=cat3(lambda g: g.e1),
        e2=cat3(lambda g: g.e2), tri_mesh_id=cat(lambda g: g.tri_mesh_id),
        tri_shadow_opaque=cat(lambda g: g.tri_shadow_opaque),
        stack_depth=depth)
    return InstanceSet(geom=geom, roots=torch.tensor(roots, dtype=torch.int32,
                                                     device=dev),
                       **_instance_transform_tables(instances, dev))


def split_instance(set_geom: SceneGeometry, plan,
                   own: SceneGeometry) -> SceneGeometry:
    """One instance's tables read back from a merged set (``plan`` placed
    at its offsets there), its offsets taken out again: what a re-merge
    starts from once the set's copy was refit on the device and the
    instance's own ``own`` was not.  Keeps ``own``'s depth bound and
    build-time leaf order."""
    n0, b0, s0 = plan.node_off, plan.blk_off, plan.slot_off
    nodes = _patch_offsets(set_geom.node_rows[n0:n0 + plan.num_nodes],
                           -n0, -b0)
    sl = slice(s0, s0 + plan.num_slots)
    cut = lambda v: Vec3(v.x[sl].clone(), v.y[sl].clone(), v.z[sl].clone())
    out = SceneGeometry(
        node_rows=nodes,
        tri_rows=set_geom.tri_rows[b0:b0 + plan.num_blocks].clone(),
        v0=cut(set_geom.v0), e1=cut(set_geom.e1), e2=cut(set_geom.e2),
        tri_mesh_id=set_geom.tri_mesh_id[sl].clone(),
        tri_shadow_opaque=set_geom.tri_shadow_opaque[sl].clone(),
        stack_depth=own.stack_depth)
    order = getattr(own, "_host_order", None)
    if order is not None:
        object.__setattr__(out, "_host_order", order)
    return out


def _instance_transform_tables(instances: tuple, device) -> dict:
    """The set's ``mats``, ``bb_min``, ``bb_max`` and ``tlas`` (the tree
    built here, on the host, from the boxes), in one copy to the device."""
    I = len(instances)
    tab = np.zeros((I, 30), np.float32)  # mats (24), bb_min (3), bb_max (3)
    for i, inst in enumerate(instances):
        tab[i, 0:12] = np.asarray(inst.inv_rows, np.float32).reshape(12)
        tab[i, 12:21] = np.asarray(inst.nrm_rows, np.float32).reshape(9)
        tab[i, 24:27] = np.asarray(inst.bb_min, np.float32)
        tab[i, 27:30] = np.asarray(inst.bb_max, np.float32)
    tree = build_tlas(tab[:, 24:27], tab[:, 27:30])
    # the tree first: a view at the buffer's start, 16-byte aligned
    t = torch.from_numpy(np.concatenate([tree.reshape(-1), tab.reshape(-1)])
                         ).to(device)
    tab_t = t[tree.size:].view(I, 30)
    return dict(mats=tab_t[:, 0:24].contiguous(),
                bb_min=tab_t[:, 24:27].contiguous(),
                bb_max=tab_t[:, 27:30].contiguous(),
                tlas=t[:tree.size].view(tree.shape))


def update_instance_set_transforms(iset: InstanceSet,
                                   instances: tuple) -> InstanceSet:
    """Matrix, AABB and tree tables only; the merged BVH tables
    untouched."""
    return dataclasses.replace(
        iset, **_instance_transform_tables(instances, iset.geom.device))


@dataclass(frozen=True)
class WorldGeometry:
    """The static world BVH and the dynamic instances: the walks run K1/K2
    on ``static``, then K4 on ``iset``.  ``instances`` (each one's own
    tables and transform rows) is what a re-merge starts from."""

    static: SceneGeometry
    instances: tuple
    iset: InstanceSet | None = None

    @property
    def device(self) -> torch.device:
        return self.static.device


def instance_transform_rows(mesh: Mesh):
    """(inv_rows, nrm_rows, bb_min, bb_max) of a mesh's current transform:
    all a transform edit recomputes (host numpy)."""
    inv = np.asarray(mesh.transform.inverse_matrix(), np.float32)[:3, :4]
    nrm = np.asarray(mesh.transform.normal_matrix(), np.float32)[:3, :3]
    bb = mesh.world_aabb()
    return (inv, nrm, np.asarray(bb.lo, np.float32),
            np.asarray(bb.hi, np.float32))


def assemble_instance(mesh: Mesh, global_id: int,
                      material_transmission: list[float] | None, device,
                      leaf_size: int = LEAF_SIZE) -> Instance:
    """The local-space BVH of one dynamic mesh, its global id baked in."""
    geom = assemble_geometry([mesh], material_transmission, device,
                             leaf_size, mesh_ids=[global_id], world=False)
    return Instance(geom, *instance_transform_rows(mesh))


def update_instance_transform(inst: Instance, mesh: Mesh) -> Instance:
    """Transform rows only; the instance's BVH untouched."""
    return Instance(inst.geom, *instance_transform_rows(mesh))


def assemble_world(meshes: list[Mesh],
                   material_transmission: list[float] | None, device,
                   leaf_size: int = LEAF_SIZE) -> WorldGeometry:
    """The full two-level assembly: the static meshes baked into one world
    BVH, one local BVH for each dynamic mesh, merged into one set."""
    static, static_ids = [], []
    for i, m in enumerate(meshes):
        if not m.is_dynamic:
            static.append(m)
            static_ids.append(i)
    sg = assemble_geometry(static, material_transmission, device, leaf_size,
                           mesh_ids=static_ids)
    instances = tuple(
        assemble_instance(m, i, material_transmission, device, leaf_size)
        for i, m in enumerate(meshes) if m.is_dynamic)
    return WorldGeometry(static=sg, instances=instances,
                         iset=merge_instances(instances))
