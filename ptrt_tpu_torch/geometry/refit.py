"""The device refit of a fixed-topology refill (K5 ``refit``).

Counterpart of ``ptrt_tpu/geometry/refit.py``.  A dynamic mesh refilled
with the same number of triangles (a fluid surface, any per-frame
``set_triangles``) keeps its tree: the shape, the leaf assignment and the
visit orders stay valid, and only the triangle rows and the boxes change.
The plan is decoded once on the host from the packed node rows; each refill
then runs on the device:

1. the new vertices scattered into leaf-slot order (the plan's map, or the
   Morton-sorted map of ``geometry/lbvh.py``), the triangle rows and the
   v0 / e1 / e2 mirrors rebuilt (the packed ids stay);
2. each leaf block's box (pads excluded);
3. the node slot boxes bottom-up, deepest level first; empty slots stay
   (0, -1).

``refit_apply`` writes the tables in place, at the plan's offsets (a merged
``InstanceSet`` or a standalone geometry): on CUDA tensors through the
kernel of ``csrc/refit.cu`` (bottom-up by arrival counters, a node worked
by the child that arrives last), on CPU tensors through
``refit_apply_plain``, the reference's code transcribed.  Min and
max are exact, so both give the reference's tables bit for bit.  Either
also writes the root node's box where asked (``root``), which a fused
frame takes as the instance's local box.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from ptrt_tpu_torch import kernels
from ptrt_tpu_torch.geometry.bvh import LEAF_SIZE
from ptrt_tpu_torch.geometry.scene_geom import MAX_TABLE_INDEX, SceneGeometry

BIG = 3.0e30  # a pad's or an unused slot's box bound before the reduction
# the refit kernel's top: the levels of depth <= 2 (csrc/refit.cu
# kTopLevels), which the last block to finish works, for a plan of at most
# TOP_MAX_SLOTS slots (a grid of 1,024 blocks); past it the arrivals climb
# to the root (on an H100 a 1M-triangle mesh's 4,600 blocks counting
# themselves done measured 0.087 ms against 0.080, PERF.md)
TOP_LEVELS = 3
TOP_MAX_SLOTS = 1 << 18


@dataclass(frozen=True)
class RefitPlan:
    """The tree of one mesh's BVH (host), local to its own tables;
    ``node_off`` / ``blk_off`` / ``slot_off`` place it in a merged set (0
    for a standalone geometry).  ``_dev`` caches the device copies of the
    offset-free arrays (shared by ``dataclasses.replace`` copies)."""

    slot_tri: np.ndarray  # (M,) int32 original triangle a slot, -1 pad
    levels: tuple  # node ids a depth, deepest first (np int32)
    cba: np.ndarray  # (N,) int32 child_base - leaf_count (column 48)
    lb: np.ndarray  # (N,) int32 leaf_base (column 49)
    lmask: np.ndarray  # (N,) int32 (column 50)
    imask: np.ndarray  # (N,) int32 (column 51)
    node_off: int = 0
    blk_off: int = 0
    slot_off: int = 0
    _dev: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def num_nodes(self) -> int:
        return int(self.cba.shape[0])

    @property
    def num_blocks(self) -> int:
        return int(self.slot_tri.shape[0]) // LEAF_SIZE

    @property
    def num_slots(self) -> int:
        return int(self.slot_tri.shape[0])

    def placed(self, node_off: int, blk_off: int,
               slot_off: int) -> "RefitPlan":
        """The plan at other offsets (its device arrays shared)."""
        return dataclasses.replace(self, node_off=node_off, blk_off=blk_off,
                                   slot_off=slot_off)

    def arrival(self) -> dict:
        """The tree seen from below, decoded once (node ids local to the
        plan, as ``cba`` / ``lb``): ``parent`` (N,) the node whose internal
        slot holds each node, -1 for the root; ``blk_node`` / ``blk_slot``
        (B,) the node and slot whose leaf slot holds each leaf block, -1
        for a block no slot holds; ``used`` (N,) the used slots of each
        node; ``empty`` the nodes without one.  Raises where a block or a
        node is held by two slots, or a slot points outside the plan."""
        if "arrival" not in self._dev:
            n, b = self.num_nodes, self.num_blocks
            parent = np.full(n, -1, np.int32)
            blk_node = np.full(b, -1, np.int32)
            blk_slot = np.full(b, -1, np.int32)
            used = np.zeros(n, np.int32)
            held_nodes = np.zeros(n, np.int64)
            held_blocks = np.zeros(b, np.int64)
            for s in range(8):
                leaf = ((self.lmask >> s) & 1) == 1
                inner = ~leaf & (((self.imask >> s) & 1) == 1)
                x = np.nonzero(leaf)[0]
                blk = self.lb[x].astype(np.int64) + s
                y = np.nonzero(inner)[0]
                child = self.cba[y].astype(np.int64) + s
                if ((blk < 0) | (blk >= b)).any() or (
                        (child < 1) | (child >= n)).any():
                    raise ValueError("a slot points outside the plan")
                blk_node[blk], blk_slot[blk] = x, s
                parent[child] = y
                np.add.at(held_blocks, blk, 1)
                np.add.at(held_nodes, child, 1)
                used += leaf | inner
            if (held_blocks > 1).any() or (held_nodes > 1).any():
                raise ValueError("a block or a node held by two slots")
            self._dev["arrival"] = dict(
                parent=parent, blk_node=blk_node, blk_slot=blk_slot,
                used=used, empty=np.nonzero(used == 0)[0].astype(np.int32))
        return self._dev["arrival"]

    def climb(self) -> dict:
        """What the refit kernel climbs (``arrival`` cut at the top, the
        nodes of depth <= 2, which the last block to finish works; decoded
        once; no top past ``TOP_MAX_SLOTS`` slots): ``parent`` and
        ``blk_node`` with -1 where the parent is a top node, ``empty`` the
        nodes without a used slot below the top;
        ``top_ids`` the top nodes, deepest level first, ``top_starts``
        their levels' starts, and ``top_src`` (T, 8) where each top slot's
        box is: kind << 30 | index, kind 0 unused, 1 the leaf block index,
        2 the node below the top, 3 the top node's place in ``top_ids``."""
        if "climb" not in self._dev:
            up = self.arrival()
            top_levels = (self.levels[-TOP_LEVELS:]
                          if self.num_slots <= TOP_MAX_SLOTS else ())
            ids = np.concatenate((np.zeros(0, np.int32),) + tuple(
                top_levels)).astype(np.int32)
            place = np.full(self.num_nodes, -1, np.int64)
            place[ids] = np.arange(ids.size)
            src = np.zeros((ids.size, 8), np.uint32)
            for s in range(8):
                leaf = ((self.lmask[ids] >> s) & 1) == 1
                inner = ~leaf & (((self.imask[ids] >> s) & 1) == 1)
                blk = self.lb[ids].astype(np.int64) + s
                child = self.cba[ids].astype(np.int64) + s
                kid = np.clip(child, 0, self.num_nodes - 1)
                top_kid = inner & (place[kid] >= 0)
                src[leaf, s] = (1 << 30) | blk[leaf]
                src[inner & ~top_kid, s] = (2 << 30) | child[inner & ~top_kid]
                src[top_kid, s] = (3 << 30) | place[kid][top_kid]
            cut = lambda a: np.where((a >= 0) & (place[np.maximum(a, 0)]
                                                 >= 0), -1, a)
            self._dev["climb"] = dict(
                parent=cut(up["parent"]).astype(np.int32),
                blk_node=cut(up["blk_node"]).astype(np.int32),
                empty=up["empty"][place[up["empty"]] < 0],
                top_ids=ids, top_src=src.view(np.int32),
                top_starts=np.cumsum([0] + [len(x) for x in top_levels]))
        return self._dev["climb"]

    def device_arrays(self, device) -> dict:
        """On ``device``, made once (int32 unless said): ``slot_tri``,
        ``rank`` (the k-th non-pad slot's k, -1 for a pad); ``parent``,
        ``blk_node``, ``empty``, ``top_ids`` and ``top_src`` (``climb``),
        ``used`` (``arrival``), ``counter`` (N + 1,) zeros (each node's
        arrivals, then the blocks done: the kernel's counters, zero again
        after each refit); ``scratch`` (B + N, 6) float32 (the block and
        node boxes).  A plan and the
        copies ``placed`` makes of it share these, so they are refitted on
        one stream at a time."""
        key = str(torch.device(device))
        if key not in self._dev:
            nonpad = self.slot_tri >= 0
            rank = np.where(nonpad, np.cumsum(nonpad) - 1, -1)
            t = lambda a: torch.from_numpy(
                np.ascontiguousarray(a, np.int32)).to(device)
            climb = self.climb()
            self._dev[key] = dict(
                slot_tri=t(self.slot_tri), rank=t(rank), used=t(self.arrival()["used"]),
                **{k: t(climb[k]) for k in ("parent", "blk_node", "empty",
                                            "top_ids", "top_src")},
                counter=torch.zeros(self.num_nodes + 1, dtype=torch.int32,
                                    device=device),
                scratch=torch.empty((self.num_blocks + self.num_nodes, 6),
                                    dtype=torch.float32, device=device))
        return self._dev[key]


def build_refit_plan(geom: SceneGeometry, order: np.ndarray | None = None,
                     node_off: int = 0, blk_off: int = 0,
                     slot_off: int = 0) -> RefitPlan:
    """Decode the packed node rows of a standalone geometry back into its
    tree (host, once).  ``order``: the original triangle of each padded
    leaf slot (-1 for a pad), by default the ``_host_order`` that
    ``assemble_geometry`` keeps on a geometry it did not pre-split."""
    rows = geom.node_rows.detach().cpu().numpy()
    meta = rows[:, 48:52].astype(np.int32)
    cba, lb, lmask, imask = (meta[:, 0].copy(), meta[:, 1].copy(),
                             meta[:, 2].copy(), meta[:, 3].copy())
    n = rows.shape[0]
    # depth of each node, breadth first; internal slot s of x is cba[x] + s
    depth = np.full(n, -1, np.int32)
    depth[0] = 0
    frontier = [0]
    while frontier:
        nxt = []
        for x in frontier:
            m, s = int(imask[x]), 0
            while m:
                if m & 1:
                    c = cba[x] + s
                    if depth[c] < 0:
                        depth[c] = depth[x] + 1
                        nxt.append(c)
                m >>= 1
                s += 1
        frontier = nxt
    if (depth < 0).any():
        raise ValueError(f"{int((depth < 0).sum())} nodes no root reaches")
    max_d = int(depth.max(initial=0))
    levels = tuple(np.nonzero(depth == dd)[0].astype(np.int32)
                   for dd in range(max_d, -1, -1))
    if order is None:
        order = getattr(geom, "_host_order", None)
        if order is None:
            raise ValueError(
                "build_refit_plan needs the build-time leaf order; pass "
                "order= or use a geometry fresh from assemble_geometry")
    return RefitPlan(slot_tri=np.asarray(order, np.int64).astype(np.int32),
                     levels=levels, cba=cba, lb=lb, lmask=lmask, imask=imask,
                     node_off=node_off, blk_off=blk_off, slot_off=slot_off)


def _check_refit(geom: SceneGeometry, plan: RefitPlan, v0, v1, v2) -> None:
    """Raise unless the tables hold the plan at its offsets and the
    vertices are what the kernels take."""
    dev = geom.device
    kernels.require_supported(dev)
    for name, v in (("v0", v0), ("v1", v1), ("v2", v2)):
        kernels.check_tensor(name, v, torch.float32, 2, dev)
        if v.shape != v0.shape or v.shape[1] != 3:
            raise ValueError(f"{name}: shape {tuple(v.shape)}, need (T, 3) "
                             "like v0")
    kernels.check_tensor("node_rows", geom.node_rows, torch.float32, 2, dev)
    kernels.check_tensor("tri_rows", geom.tri_rows, torch.float32, 2, dev)
    if (plan.node_off + plan.num_nodes > geom.num_nodes
            or plan.blk_off + plan.num_blocks > geom.num_tri_blocks
            or plan.slot_off + plan.num_slots > geom.num_tri_slots):
        raise ValueError("the plan does not fit the geometry's tables")
    if max(geom.num_nodes, geom.num_tri_blocks) >= MAX_TABLE_INDEX:
        raise ValueError("tables past 2^24 rows: their float-encoded "
                         "indices are not exact")


def _check_root(root, dev) -> None:
    if root is None:
        return
    if len(root) != 2:
        raise ValueError("root: (lo, hi)")
    for name, t in zip(("root lo", "root hi"), root):
        kernels.check_tensor(name, t, torch.float32, 1, dev)
        if t.shape[0] != 3:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, need (3,)")


def refit_apply(geom: SceneGeometry, plan: RefitPlan, v0: torch.Tensor,
                v1: torch.Tensor, v2: torch.Tensor,
                slot_map: tuple | None = None,
                root: tuple | None = None) -> SceneGeometry:
    """Refit one mesh's BVH inside ``geom`` from new vertices, in place.

    ``v0`` / ``v1`` / ``v2``: (T, 3) float32 triangle vertices in the
    mesh's original triangle order, on the geometry's device.
    ``slot_map``: None (the plan's own slot->triangle map) or ``(rank,
    order)``, the Morton refill of ``lbvh.lbvh_update``: the k-th non-pad
    slot takes triangle ``order[k]`` (pads stay pads).  ``root``: None or
    ``(lo, hi)``, (3,) float32 tensors that receive the root node's box
    (``refit_root_aabb``'s values).  Returns ``geom``, whose tables now
    hold the refit."""
    _check_refit(geom, plan, v0, v1, v2)
    _check_root(root, geom.device)
    if geom.device.type == "cpu":
        return refit_apply_plain(geom, plan, v0, v1, v2, slot_map, root)
    dev = geom.device
    arrays = plan.device_arrays(dev)
    rank = order = None
    if slot_map is not None:
        rank, order = slot_map
        kernels.check_tensor("rank", rank, torch.int32, 1, dev)
        kernels.check_tensor("order", order, torch.int32, 1, dev)
        if rank.shape[0] != plan.num_slots or order.shape[0] != v0.shape[0]:
            raise ValueError("slot_map: a rank a slot and an order entry a "
                             "triangle")
    climb = plan.climb()
    starts = np.ascontiguousarray(climb["top_starts"], np.int32)
    g = geom
    so = plan.slot_off
    mirror = lambda v: [c.data_ptr() + 4 * so for c in (v.x, v.y, v.z)]
    for name, v in (("v0", g.v0), ("e1", g.e1), ("e2", g.e2)):
        for k, c in zip("xyz", (v.x, v.y, v.z)):
            kernels.check_tensor(f"geom.{name}.{k}", c, torch.float32, 1,
                                 dev)
    rc = kernels.get_lib().ptrt_refit(
        v0.data_ptr(), v1.data_ptr(), v2.data_ptr(), int(v0.shape[0]),
        arrays["slot_tri"].data_ptr() if order is None else 0,
        0 if order is None else rank.data_ptr(),
        0 if order is None else order.data_ptr(), plan.num_slots,
        g.tri_rows.data_ptr() + 4 * plan.blk_off * 10 * LEAF_SIZE,
        *mirror(g.v0), *mirror(g.e1), *mirror(g.e2), g.node_rows.data_ptr(),
        plan.node_off, plan.blk_off, plan.num_nodes,
        *(arrays[k].data_ptr() for k in (
            "parent", "blk_node", "used", "empty")),
        int(arrays["empty"].shape[0]), arrays["counter"].data_ptr(),
        arrays["top_ids"].data_ptr(), arrays["top_src"].data_ptr(),
        int(climb["top_ids"].size), starts.ctypes.data,
        len(climb["top_starts"]) - 1,
        arrays["counter"].data_ptr() + 4 * plan.num_nodes,
        arrays["scratch"].data_ptr(),
        *((0, 0) if root is None else (root[0].data_ptr(),
                                       root[1].data_ptr())),
        kernels.stream_ptr(dev))
    kernels.launches["refit"] += 1
    kernels.check(rc, "refit")
    return geom


def refit_info() -> dict:
    """Registers, local-memory bytes a thread, threads a block, resident
    blocks a SM and shared bytes a block of the refit kernel (measurement
    only; needs the card)."""
    vals = [ctypes.c_int() for _ in range(5)]
    rc = kernels.get_lib().ptrt_refit_info(*[ctypes.byref(v) for v in vals])
    kernels.check(rc, "refit info")
    return dict(zip(("registers", "local_bytes", "threads", "blocks_per_sm",
                     "shared_bytes"), (v.value for v in vals)))


def refit_apply_plain(geom: SceneGeometry, plan: RefitPlan, v0, v1, v2,
                      slot_map: tuple | None = None,
                      root: tuple | None = None) -> SceneGeometry:
    """Plain version of ``refit_apply``: the reference's ``refit_apply``
    transcribed (level by level, deepest first), written in place; the
    root node's box into ``root`` where given."""
    dev = geom.device
    if slot_map is None:
        st = torch.from_numpy(plan.slot_tri).to(dev).long()
    else:
        rank, order = slot_map
        st = torch.where(rank >= 0, order.long()[rank.long().clamp_min(0)],
                         -1)
    pad = st < 0
    idx = st.clamp_min(0)
    B, N = plan.num_blocks, plan.num_nodes
    take = lambda v: torch.where(pad[:, None], 0.0, v[idx])
    pv0, pv1, pv2 = take(v0), take(v1), take(v2)
    e1 = pv1 - pv0
    e2 = pv2 - pv0

    # the triangle rows' first nine fields (field-major); the ids stay
    rows = geom.tri_rows[plan.blk_off:plan.blk_off + B].view(
        B, 10, LEAF_SIZE)
    for f, a in enumerate((pv0, e1, e2)):
        for k in range(3):
            rows[:, 3 * f + k] = a[:, k].reshape(B, LEAF_SIZE)
    so, M = plan.slot_off, plan.num_slots
    for mirror, a in ((geom.v0, pv0), (geom.e1, e1), (geom.e2, e2)):
        for k, c in enumerate((mirror.x, mirror.y, mirror.z)):
            c[so:so + M] = a[:, k]

    # leaf block boxes, pads excluded
    tmin = torch.minimum(torch.minimum(pv0, pv1), pv2)
    tmax = torch.maximum(torch.maximum(pv0, pv1), pv2)
    tmin = torch.where(pad[:, None], BIG, tmin)
    tmax = torch.where(pad[:, None], -BIG, tmax)
    blk_min = tmin.reshape(B, LEAF_SIZE, 3).amin(dim=1)
    blk_max = tmax.reshape(B, LEAF_SIZE, 3).amax(dim=1)

    # node slot boxes, deepest level first
    slot_min = torch.zeros((N, 8, 3), dtype=torch.float32, device=dev)
    slot_max = torch.full((N, 8, 3), -1.0, dtype=torch.float32, device=dev)
    node_min = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    node_max = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    slots = np.arange(8, dtype=np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    for ids in plan.levels:
        if ids.size == 0:
            continue
        is_leaf = (plan.lmask[ids][:, None] >> slots[None, :]) & 1
        is_int = (plan.imask[ids][:, None] >> slots[None, :]) & 1
        used = t((is_leaf | is_int).astype(bool))[..., None]
        leaf = t(is_leaf == 1)[..., None]
        lblk = t(np.clip(plan.lb[ids][:, None] + slots[None, :], 0,
                         B - 1).astype(np.int64))
        cnod = t(np.clip(plan.cba[ids][:, None] + slots[None, :], 0,
                         N - 1).astype(np.int64))
        smin = torch.where(leaf, blk_min[lblk], node_min[cnod])
        smax = torch.where(leaf, blk_max[lblk], node_max[cnod])
        smin = torch.where(used, smin, BIG)
        smax = torch.where(used, smax, -BIG)
        jidx = t(ids.astype(np.int64))
        slot_min[jidx] = torch.where(used, smin, 0.0)
        slot_max[jidx] = torch.where(used, smax, -1.0)
        node_min[jidx] = smin.amin(dim=1)
        node_max[jidx] = smax.amax(dim=1)

    bounds = torch.cat([slot_min[:, :, 0], slot_min[:, :, 1],
                        slot_min[:, :, 2], slot_max[:, :, 0],
                        slot_max[:, :, 1], slot_max[:, :, 2]], dim=1)
    geom.node_rows[plan.node_off:plan.node_off + N, 0:48] = bounds
    if root is not None:
        root[0].copy_(node_min[0])
        root[1].copy_(node_max[0])
    return geom


def refit_root_aabb(geom: SceneGeometry, plan: RefitPlan) -> tuple:
    """(lo, hi) (3,) tensors of a refitted mesh: the union of its root
    row's used slot boxes, read on the device (the used-slot mask from the
    plan's host arrays, its device copy made once a plan).  A fused frame
    refreshes the instance's local box with it."""
    dev = geom.device
    key = ("root_used", str(dev))
    if key not in plan._dev:
        mask = ((int(plan.lmask[0]) | int(plan.imask[0])) >> np.arange(8)) & 1
        plan._dev[key] = torch.from_numpy(mask == 1).to(dev)
    used = plan._dev[key]
    row = geom.node_rows[plan.node_off]
    lo = torch.where(used, row[0:24].view(3, 8), BIG).amin(dim=1)
    hi = torch.where(used, row[24:48].view(3, 8), -BIG).amax(dim=1)
    return lo, hi
