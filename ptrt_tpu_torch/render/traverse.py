"""Ray/scene intersection: the K1 (closest-hit), K2 (any-hit) and K4
(instance) wrappers.

Counterpart of ``ptrt_tpu/render/traverse.py`` on a flat ``SceneGeometry``
or a two-level ``WorldGeometry``.  ``closest_hit``, ``closest_hit_live``
and ``any_hit`` launch the hand-written 8-wide BVH walks of
``csrc/traverse.cu`` for CUDA tensors and run their plain versions — a
chunked brute-force Möller–Trumbore over the SoA triangle views, after
``traverse._brute_closest_state`` / ``_brute_any_state`` — for CPU
tensors.  There is no fallback between the two.  On a ``WorldGeometry``
they walk the static world (K1 / K2), then the instances
(``instances_closest`` / ``instances_any``, K4) over the same rays, which
update the record in place; the plain K4 is the reference's
``_merge_instance_closest`` with the brute runner, instance by instance.
``walk_counts`` (measurement only) runs a walk with a tally of the nodes
it visits and the triangles it tests; its plain version is the kernel's
walk itself, one ray at a time on the host.

``intersect_closest`` / ``intersect_any`` keep the reference's entry-point
contract (``Hit``, dead lanes with ``t_max <= 0`` return misses), with the
hit normal reconstructed from the winning triangle slot in torch (an
instance hit's through its instance's normal matrix).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import NamedTuple

import numpy as np
import torch

from ptrt_tpu_torch import kernels
from ptrt_tpu_torch.core.vec import Vec3, cross, where
from ptrt_tpu_torch.geometry.bvh import LEAF_SIZE
from ptrt_tpu_torch.geometry.scene_geom import (MAX_TABLE_INDEX, InstanceSet,
                                                SceneGeometry, WorldGeometry)
from ptrt_tpu_torch.geometry.tlas import TLAS_ROW, TLAS_WIDTH, tlas_node_count

T_MIN = 1e-4
T_MAX = 1e30
MT_EPS = 1e-9
BARY_EPS = 1e-6

# plain-version tile: rays x triangle slots per elementwise pass
_RAY_CHUNK = 4096
_TRI_CHUNK = 2048
# the counting walks: K1 near-first (the main path's), K1 in slot order,
# K2 (the C entry's ``walk`` argument is the index)
WALKS = ("closest", "closest_slot_order", "any")
_ORDER_COL = 52  # first per-octant child-order column of a node row


@dataclass(frozen=True)
class Hit:
    hit: torch.Tensor  # bool
    t: torch.Tensor
    point: Vec3
    normal: Vec3  # face-forwarded geometric normal
    front_face: torch.Tensor  # bool
    mesh_index: torch.Tensor  # int32 object/material id, -1 on a miss
    u: torch.Tensor
    v: torch.Tensor


class _K1Planes(NamedTuple):
    t: torch.Tensor  # float32, t_max on a miss
    u: torch.Tensor
    v: torch.Tensor
    slot: torch.Tensor  # int32 triangle slot, -1 on a miss
    mesh: torch.Tensor  # int32 mesh id, -1 on a miss


class Closest(_K1Planes):
    """K1's answer for flat rays, with K4's on a ``WorldGeometry``.

    ``inst`` (int32, None without instances): the instance of the hit, -1
    where the static pass or nothing won; where it is >= 0, ``slot``
    indexes the instance set's tables.  It rides as an attribute, so a
    record unpacks and iterates as K1's five planes; ``_replace`` keeps
    it (or sets it: ``_replace(inst=...)``)."""

    inst = None

    def _replace(self, **kw) -> "Closest":
        inst = kw.pop("inst", self.inst)
        out = super()._replace(**kw)
        out.inst = inst
        return out


def static_of(geom) -> SceneGeometry:
    return geom.static if isinstance(geom, WorldGeometry) else geom


def iset_of(geom) -> InstanceSet | None:
    return geom.iset if isinstance(geom, WorldGeometry) else None


def mt_test(v0: Vec3, e1: Vec3, e2: Vec3, o: Vec3, d: Vec3, t_min, t_max):
    """Two-sided Möller–Trumbore with precomputed edges and an inclusive
    barycentric epsilon (``traverse._mt_test``)."""
    h = cross(d, e2)
    a = e1.dot(h)
    valid = torch.abs(a) > MT_EPS
    f = 1.0 / torch.where(valid, a, 1.0)
    s = o - v0
    u = f * s.dot(h)
    q = cross(s, e1)
    v = f * d.dot(q)
    t = f * e2.dot(q)
    ok = (valid & (u >= -BARY_EPS) & (u <= 1.0 + BARY_EPS)
          & (v >= -BARY_EPS) & (u + v <= 1.0 + BARY_EPS)
          & (t > t_min) & (t < t_max))
    return ok, t, u, v


def _check_rays(geom: SceneGeometry, o: Vec3, d: Vec3, plane: torch.Tensor,
                name: str = "t_max", dtype: torch.dtype = torch.float32):
    """Raise unless the rays and their per-ray ``plane`` (t_max, or the
    alive flags) are what the walks take.  Returns the ray count."""
    dev = geom.device
    kernels.require_supported(dev)
    kernels.check_tensor(name, plane, dtype, 1, dev)
    n = plane.shape[0]
    for cname, c in (("o.x", o.x), ("o.y", o.y), ("o.z", o.z), ("d.x", d.x),
                     ("d.y", d.y), ("d.z", d.z)):
        kernels.check_tensor(cname, c, torch.float32, 1, dev)
        if c.shape[0] != n:
            raise ValueError(f"{cname}: length {c.shape[0]} != {name}'s {n}")
    kernels.check_tensor("node_rows", geom.node_rows, torch.float32, 2, dev)
    kernels.check_tensor("tri_rows", geom.tri_rows, torch.float32, 2, dev)
    if geom.node_rows.shape[1] != 64:
        raise ValueError("node_rows must be (N, 64)")
    if geom.tri_rows.shape[1] != 10 * LEAF_SIZE:
        raise ValueError(f"tri_rows must be (B, {10 * LEAF_SIZE})")
    return n


def _ray_args(geom: SceneGeometry, o: Vec3, d: Vec3, t_max):
    """The C entries' leading arguments (tables, rays, t_max or 0, and for
    K1 the alive plane or 0 follows)."""
    lib = kernels.get_lib()
    if geom.stack_depth > lib.ptrt_max_stack():
        raise ValueError(f"BVH depth bound {geom.stack_depth} exceeds the "
                         f"walk's stack of {lib.ptrt_max_stack()}")
    for name, rows in (("node_rows", geom.node_rows),
                       ("tri_rows", geom.tri_rows)):
        if rows.data_ptr() % 16:  # read as float4
            raise ValueError(f"{name} must be 16-byte aligned")
    return [geom.node_rows.data_ptr(), geom.num_nodes,
            geom.tri_rows.data_ptr(), int(geom.tri_rows.shape[0]),
            o.x.data_ptr(), o.y.data_ptr(), o.z.data_ptr(),
            d.x.data_ptr(), d.y.data_ptr(), d.z.data_ptr(),
            0 if t_max is None else t_max.data_ptr()]


def _counter(dev: torch.device) -> torch.Tensor:
    """A walk's ray counter: 4 bytes of its own for each launch (the C entry
    zeroes it on the stream), so walks on different streams, or a captured
    graph beside eager work, never take each other's rays.  The caching
    allocator orders its reuse by stream and launches nothing."""
    return torch.empty(1, dtype=torch.int32, device=dev)


# -- K1 ----------------------------------------------------------------------


def closest_hit(geom, o: Vec3, d: Vec3, t_max: torch.Tensor, count=None,
                count_scale: int = 1):
    """Nearest hit per ray.  Rays are flat (R,) float32 SoA tensors.

    Returns ``Closest(t, u, v, slot, mesh, inst)``: float32 t (``t_max`` on
    a miss), u, v, int32 triangle slot into the SoA views and int32 mesh
    id, both -1 on a miss; on a ``WorldGeometry`` the instance (K4).

    ``count``: a (1,) int32 tensor on the rays' device; then R is only the
    rays' room and the walk takes the first ``count_scale * count[0]`` of
    them, the count read on the card (``counted``); the records past them
    are unspecified.  A ``SceneGeometry`` only."""
    static = static_of(geom)
    n = _check_rays(static, o, d, t_max)
    if count is not None:
        _check_count(geom, count, count_scale)
    if static.device.type == "cpu":
        if count is None:
            rec = closest_hit_plain(static, o, d, t_max)
        else:
            m = counted(n, count, count_scale)
            first = closest_hit_plain(static, o.map(lambda c: c[:m]),
                                      d.map(lambda c: c[:m]), t_max[:m])
            rec = _miss_record(t_max)
            for p, q in zip(rec, first):
                p[:m] = q
    else:
        rec = _closest_kernel(static, o, d, t_max, None, n, count,
                              count_scale)
    return _with_instances(geom, o, d, rec)


def counted(n: int, count: torch.Tensor, count_scale: int) -> int:
    """How many of ``n`` rays a device count names, read to the host: the
    plain versions' count on the CPU (the kernels read it on the card)."""
    return min(n, count_scale * max(int(count[0]), 0))


def _check_count(geom, count: torch.Tensor, count_scale: int) -> None:
    if iset_of(geom) is not None:
        raise ValueError("a device count walks a SceneGeometry, not "
                         "instances")
    kernels.check_tensor("count", count, torch.int32, 1,
                         static_of(geom).device)
    if count.shape[0] < 1 or int(count_scale) < 1:
        raise ValueError("count: need (1,) int32 and a scale of 1 or more")


def _miss_record(t_max: torch.Tensor) -> "Closest":
    """K1's answer of a miss on every ray."""
    n = t_max.shape[0]
    return Closest(t_max.clone(), torch.zeros_like(t_max),
                   torch.zeros_like(t_max),
                   torch.full((n,), -1, dtype=torch.int32,
                              device=t_max.device),
                   torch.full((n,), -1, dtype=torch.int32,
                              device=t_max.device))


def closest_hit_live(geom, o: Vec3, d: Vec3, alive: torch.Tensor):
    """``closest_hit`` of the lanes flagged in ``alive`` (bool): a live lane
    walks with t_max = ``T_MAX``, a dead one returns a miss at t = -1 — the
    answer of ``closest_hit(geom, o, d, torch.where(alive, T_MAX, -1.0))``
    without building that plane."""
    static = static_of(geom)
    n = _check_rays(static, o, d, alive, "alive", torch.bool)
    if static.device.type == "cpu":
        rec = closest_hit_plain(static, o, d,
                                torch.where(alive, T_MAX, -1.0))
    else:
        rec = _closest_kernel(static, o, d, None, alive, n)
    return _with_instances(geom, o, d, rec)


def _with_instances(geom, o: Vec3, d: Vec3, rec: "Closest") -> "Closest":
    iset = iset_of(geom)
    return rec if iset is None else instances_closest(iset, o, d, rec)


def _closest_kernel(geom, o, d, t_max, alive, n, count=None,
                    count_scale: int = 1) -> Closest:
    dev = geom.device
    out = torch.empty((5, n), dtype=torch.float32, device=dev)
    t, u, v = out[0], out[1], out[2]
    slot, mesh = out[3].view(torch.int32), out[4].view(torch.int32)
    args = _ray_args(geom, o, d, t_max)
    counter = _counter(dev)
    planes = (t.data_ptr(), u.data_ptr(), v.data_ptr(), slot.data_ptr(),
              mesh.data_ptr(), counter.data_ptr(), kernels.stream_ptr(dev))
    lib = kernels.get_lib()
    if count is None:
        rc = lib.ptrt_closest_hit(
            *args, 0 if alive is None else alive.data_ptr(), n, *planes)
    else:
        rc = lib.ptrt_closest_hit_counted(*args, n, count.data_ptr(),
                                          int(count_scale), *planes)
    kernels.launches["closest_hit"] += 1
    kernels.check(rc, "closest_hit")
    return Closest(t, u, v, slot, mesh)


def _live_rays(t_max: torch.Tensor):
    """The indices of the rays that can hit anything (t_max > T_MIN), or
    None when they all can: the plain walks skip the others, whose answer
    is a miss whatever the triangles."""
    live = t_max > T_MIN
    if bool(live.all()):
        return None
    return live.nonzero()[:, 0]


def closest_hit_plain(geom: SceneGeometry, o: Vec3, d: Vec3,
                      t_max: torch.Tensor, slots: tuple | None = None):
    """Plain version of K1: all-pairs Möller–Trumbore over triangle chunks
    (earlier chunk, then lower slot, wins a tie).  ``slots`` = (start,
    stop) limits it to those triangle slots (one instance of a set)."""
    n = t_max.shape[0]
    live = _live_rays(t_max)
    if live is not None:  # a ray with t_max <= T_MIN hits nothing
        rec = closest_hit_plain(geom, o.map(lambda c: c[live]),
                                d.map(lambda c: c[live]), t_max[live], slots)
        out = _miss_record(t_max)
        for p, q in zip(out, rec):
            p[live] = q
        return out
    lo, m = (0, geom.num_tri_slots) if slots is None else slots
    best_t = t_max.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=t_max.device)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    for r0 in range(0, n, _RAY_CHUNK):
        rs = slice(r0, min(n, r0 + _RAY_CHUNK))
        oe = o.map(lambda c: c[rs, None])
        de = d.map(lambda c: c[rs, None])
        for c0 in range(lo, m, _TRI_CHUNK):
            cs = slice(c0, min(m, c0 + _TRI_CHUNK))
            tri = lambda v: v.map(lambda c: c[None, cs])
            ok, t, uu, vv = mt_test(tri(geom.v0), tri(geom.e1), tri(geom.e2),
                                    oe, de, T_MIN, best_t[rs, None])
            ok = ok & (geom.tri_mesh_id[None, cs] >= 0)
            t = torch.where(ok, t, torch.inf)
            j = torch.argmin(t, dim=1, keepdim=True)
            tbest = torch.gather(t, 1, j)[:, 0]
            found = torch.isfinite(tbest)
            best_tri[rs] = torch.where(found, j[:, 0] + c0, best_tri[rs])
            best_u[rs] = torch.where(found, torch.gather(uu, 1, j)[:, 0],
                                     best_u[rs])
            best_v[rs] = torch.where(found, torch.gather(vv, 1, j)[:, 0],
                                     best_v[rs])
            best_t[rs] = torch.where(found, tbest, best_t[rs])
    found = best_tri >= 0
    mesh = torch.where(found, geom.tri_mesh_id[best_tri.clamp_min(0)], -1)
    return Closest(best_t, torch.where(found, best_u, 0.0),
                   torch.where(found, best_v, 0.0), best_tri.to(torch.int32),
                   mesh.to(torch.int32))


# -- K2 ----------------------------------------------------------------------


def any_hit(geom, o: Vec3, d: Vec3, t_max: torch.Tensor, count=None,
            count_scale: int = 1) -> torch.Tensor:
    """Occluded-or-not per ray up to ``t_max`` (bool); triangles whose
    shadow-opaque bit is clear (transmissive materials) never occlude.
    ``count`` and ``count_scale`` as ``closest_hit``'s."""
    static = static_of(geom)
    n = _check_rays(static, o, d, t_max)
    if count is not None:
        _check_count(geom, count, count_scale)
    if static.device.type == "cpu":
        if count is None:
            hit = any_hit_plain(static, o, d, t_max)
        else:
            m = counted(n, count, count_scale)
            hit = torch.zeros(n, dtype=torch.bool)
            hit[:m] = any_hit_plain(static, o.map(lambda c: c[:m]),
                                    d.map(lambda c: c[:m]), t_max[:m])
    else:
        hit = torch.empty(n, dtype=torch.bool, device=static.device)
        args = _ray_args(static, o, d, t_max)
        counter = _counter(static.device)
        tail = (hit.data_ptr(), counter.data_ptr(),
                kernels.stream_ptr(static.device))
        lib = kernels.get_lib()
        if count is None:
            rc = lib.ptrt_any_hit(*args, n, *tail)
        else:
            rc = lib.ptrt_any_hit_counted(*args, n, count.data_ptr(),
                                          int(count_scale), *tail)
        kernels.launches["any_hit"] += 1
        kernels.check(rc, "any_hit")
    iset = iset_of(geom)
    return hit if iset is None else instances_any(iset, o, d, t_max, hit)


def any_hit_plain(geom: SceneGeometry, o: Vec3, d: Vec3,
                  t_max: torch.Tensor,
                  slots: tuple | None = None) -> torch.Tensor:
    """Plain version of K2: all-pairs Möller–Trumbore over triangle chunks
    (``slots`` as in ``closest_hit_plain``)."""
    n = t_max.shape[0]
    hit = torch.zeros(n, dtype=torch.bool, device=t_max.device)
    live = _live_rays(t_max)
    if live is not None:  # a ray with t_max <= T_MIN is never occluded
        hit[live] = any_hit_plain(geom, o.map(lambda c: c[live]),
                                  d.map(lambda c: c[live]), t_max[live],
                                  slots)
        return hit
    lo, m = (0, geom.num_tri_slots) if slots is None else slots
    for r0 in range(0, n, _RAY_CHUNK):
        rs = slice(r0, min(n, r0 + _RAY_CHUNK))
        oe = o.map(lambda c: c[rs, None])
        de = d.map(lambda c: c[rs, None])
        for c0 in range(lo, m, _TRI_CHUNK):
            cs = slice(c0, min(m, c0 + _TRI_CHUNK))
            tri = lambda v: v.map(lambda c: c[None, cs])
            ok, _, _, _ = mt_test(tri(geom.v0), tri(geom.e1), tri(geom.e2),
                                  oe, de, T_MIN, t_max[rs, None])
            ok = ok & geom.tri_shadow_opaque[None, cs]
            hit[rs] |= ok.any(dim=1)
    return hit


# -- K4 ----------------------------------------------------------------------


def safe_inv(d: Vec3) -> Vec3:
    """The signed-epsilon inverse direction (``traverse._safe_inv``)."""
    inv = lambda c: 1.0 / (c + torch.where(c >= 0.0, 1.0, -1.0) * 1e-12)
    return Vec3(inv(d.x), inv(d.y), inv(d.z))


def mat_affine(m: torch.Tensor, p: Vec3) -> Vec3:
    """World->local points through instance rows ``m`` (..., 24), columns
    0:12 (``traverse._mat_affine``: each product and sum rounded)."""
    return Vec3(m[..., 0] * p.x + m[..., 1] * p.y + m[..., 2] * p.z
                + m[..., 3],
                m[..., 4] * p.x + m[..., 5] * p.y + m[..., 6] * p.z
                + m[..., 7],
                m[..., 8] * p.x + m[..., 9] * p.y + m[..., 10] * p.z
                + m[..., 11])


def mat_linear(m: torch.Tensor, v: Vec3) -> Vec3:
    """World->local directions, not renormalised: t is shared between the
    frames."""
    return Vec3(m[..., 0] * v.x + m[..., 1] * v.y + m[..., 2] * v.z,
                m[..., 4] * v.x + m[..., 5] * v.y + m[..., 6] * v.z,
                m[..., 8] * v.x + m[..., 9] * v.y + m[..., 10] * v.z)


def mat_normal(m: torch.Tensor, v: Vec3) -> Vec3:
    """Local->world normals through columns 12:21 (the inverse
    transpose)."""
    return Vec3(m[..., 12] * v.x + m[..., 13] * v.y + m[..., 14] * v.z,
                m[..., 15] * v.x + m[..., 16] * v.y + m[..., 17] * v.z,
                m[..., 18] * v.x + m[..., 19] * v.y + m[..., 20] * v.z)


def slab(lo: torch.Tensor, hi: torch.Tensor, o: Vec3, inv: Vec3,
         t_max: torch.Tensor) -> torch.Tensor:
    """One world box (3,) against the rays within (0, t_max]
    (``traverse._slab1``)."""
    t_enter = torch.zeros_like(t_max)
    t_exit = t_max
    for a, (oc, ic) in enumerate(((o.x, inv.x), (o.y, inv.y),
                                  (o.z, inv.z))):
        t0 = (lo[a] - oc) * ic
        t1 = (hi[a] - oc) * ic
        t_enter = torch.maximum(t_enter, torch.minimum(t0, t1))
        t_exit = torch.minimum(t_exit, torch.maximum(t0, t1))
    return t_enter <= t_exit


def instance_slots(iset: InstanceSet) -> list:
    """(start, stop) of each instance's triangle slots in the set's tables:
    the blocks its nodes' leaf slots reference (read on the host)."""
    rows = iset.geom.node_rows.detach().cpu().numpy()
    roots = iset.roots.cpu().tolist() + [rows.shape[0]]
    out = []
    for k in range(iset.count):
        meta = rows[roots[k]:roots[k + 1], 49:51].astype(np.int64)
        blocks = [lb + s for lb, lmask in meta for s in range(8)
                  if (lmask >> s) & 1]
        lo = min(blocks, default=0)
        out.append((lo * LEAF_SIZE, (max(blocks, default=lo - 1) + 1)
                    * LEAF_SIZE))
    return out


def _check_iset(iset: InstanceSet, dev) -> None:
    kernels.check_tensor("iset.mats", iset.mats, torch.float32, 2, dev)
    kernels.check_tensor("iset.bb_min", iset.bb_min, torch.float32, 2, dev)
    kernels.check_tensor("iset.bb_max", iset.bb_max, torch.float32, 2, dev)
    kernels.check_tensor("iset.roots", iset.roots, torch.int32, 1, dev)
    kernels.check_tensor("iset.tlas", iset.tlas, torch.float32, 3, dev)
    n_inst = iset.count
    if (iset.mats.shape != (n_inst, 24) or iset.bb_min.shape != (n_inst, 3)
            or iset.bb_max.shape != (n_inst, 3)):
        raise ValueError("the instance tables need (I, 24), (I, 3), (I, 3) "
                         f"rows for {n_inst} roots")
    if iset.tlas.shape != (tlas_node_count(n_inst), TLAS_WIDTH, TLAS_ROW):
        raise ValueError(f"iset.tlas {tuple(iset.tlas.shape)} is not a tree "
                         f"over {n_inst} instances (tlas.build_tlas)")
    if max(iset.geom.num_nodes, iset.geom.num_tri_blocks) >= MAX_TABLE_INDEX:
        raise ValueError("an instance set past 2^24 rows: its float-encoded "
                         "indices are not exact")


def _iset_args(iset: InstanceSet, lib) -> list:
    """The C entries' instance arguments: matrix rows, the tree, its node
    count, the roots, the instance count."""
    n_inst = iset.count
    if n_inst > lib.ptrt_max_instances():
        raise ValueError(f"{n_inst} instances: K4 takes at most "
                         f"{lib.ptrt_max_instances()} (the instance tree "
                         "holds instance k as the exact float -1 - k)")
    for name, t in (("iset.mats", iset.mats), ("iset.tlas", iset.tlas)):
        if t.data_ptr() % 16:  # read as float4
            raise ValueError(f"{name} must be 16-byte aligned")
    return [iset.mats.data_ptr(), iset.tlas.data_ptr(),
            int(iset.tlas.shape[0]), iset.roots.data_ptr(), n_inst]


def instances_closest(iset: InstanceSet, o: Vec3, d: Vec3,
                      rec: Closest) -> Closest:
    """K4 closest: after the static pass ``rec`` (K1's answer for the same
    flat rays), every instance whose world box a ray enters within
    ``rec.t`` (lowest id first) walks the ray in its frame bounded by the
    current t; a strictly nearer hit replaces the record.  Updates ``rec``'s
    planes in place and returns them with the ``inst`` plane.  The kernel
    finds those instances through ``iset.tlas``."""
    geom = iset.geom
    n = _check_rays(geom, o, d, rec.t)
    dev = geom.device
    for name, p, dt in (("u", rec.u, torch.float32),
                        ("v", rec.v, torch.float32),
                        ("slot", rec.slot, torch.int32),
                        ("mesh", rec.mesh, torch.int32)):
        kernels.check_tensor(f"rec.{name}", p, dt, 1, dev)
        if p.shape[0] != n:
            raise ValueError(f"rec.{name}: length {p.shape[0]} != {n}")
    _check_iset(iset, dev)
    if dev.type == "cpu":
        return instances_closest_plain(iset, o, d, rec)
    lib = kernels.get_lib()
    inst = torch.empty(n, dtype=torch.int32, device=dev)
    counter = _counter(dev)
    rc = lib.ptrt_instances_closest(
        *_ray_args(geom, o, d, None)[:-1], n, rec.t.data_ptr(),
        rec.u.data_ptr(), rec.v.data_ptr(), rec.slot.data_ptr(),
        rec.mesh.data_ptr(), inst.data_ptr(), *_iset_args(iset, lib),
        counter.data_ptr(), kernels.stream_ptr(dev))
    kernels.launches["instances_closest"] += 1
    kernels.check(rc, "instances_closest")
    return rec._replace(inst=inst)


def instances_closest_plain(iset: InstanceSet, o: Vec3, d: Vec3,
                            rec: Closest) -> Closest:
    """Plain version of ``instances_closest``: instance by instance in id
    order, the rays whose box test passes against the static pass's t
    moved into the instance's frame and brute-forced over its triangles
    bounded by the current t (``traverse._merge_instance_closest`` with the
    brute runner)."""
    t_boxes = rec.t.clone()
    t, u, v, slot, mesh = (p.clone() for p in rec[:5])
    inst = torch.full_like(slot, -1)
    inv = safe_inv(d)
    for k, slots in enumerate(instance_slots(iset)):
        live = slab(iset.bb_min[k], iset.bb_max[k], o, inv, t_boxes)
        live &= t > 0.0
        idx = live.nonzero()[:, 0]
        if idx.numel() == 0:
            continue
        m = iset.mats[k]
        pick = lambda vv: vv.map(lambda c: c[idx])
        r = closest_hit_plain(iset.geom, mat_affine(m, pick(o)),
                              mat_linear(m, pick(d)), t[idx], slots)
        found = r.slot >= 0
        at = idx[found]
        t[at], u[at], v[at] = r.t[found], r.u[found], r.v[found]
        slot[at], mesh[at] = r.slot[found], r.mesh[found]
        inst[at] = k
    for p, new in zip(rec[:5], (t, u, v, slot, mesh)):
        p.copy_(new)
    return rec._replace(inst=inst)


def instances_any(iset: InstanceSet, o: Vec3, d: Vec3, t_max: torch.Tensor,
                  hit: torch.Tensor) -> torch.Tensor:
    """K4 any: after K2 gave ``hit`` for the same shadow rays, each lane not
    yet occluded with ``t_max > 0`` walks the instances whose world box it
    enters, in its frame, up to its first opaque occluder.  ORs into
    ``hit`` in place and returns it."""
    geom = iset.geom
    n = _check_rays(geom, o, d, t_max)
    dev = geom.device
    kernels.check_tensor("hit", hit, torch.bool, 1, dev)
    if hit.shape[0] != n:
        raise ValueError(f"hit: length {hit.shape[0]} != {n}")
    _check_iset(iset, dev)
    if dev.type == "cpu":
        return instances_any_plain(iset, o, d, t_max, hit)
    lib = kernels.get_lib()
    counter = _counter(dev)
    rc = lib.ptrt_instances_any(
        *_ray_args(geom, o, d, t_max), n, hit.data_ptr(),
        *_iset_args(iset, lib), counter.data_ptr(), kernels.stream_ptr(dev))
    kernels.launches["instances_any"] += 1
    kernels.check(rc, "instances_any")
    return hit


def instances_any_plain(iset: InstanceSet, o: Vec3, d: Vec3,
                        t_max: torch.Tensor,
                        hit: torch.Tensor) -> torch.Tensor:
    """Plain version of ``instances_any``: instance by instance, the live
    rays in its box brute-forced over its triangles."""
    inv = safe_inv(d)
    for k, slots in enumerate(instance_slots(iset)):
        live = slab(iset.bb_min[k], iset.bb_max[k], o, inv, t_max)
        live &= ~hit & (t_max > 0.0)
        idx = live.nonzero()[:, 0]
        if idx.numel() == 0:
            continue
        m = iset.mats[k]
        pick = lambda vv: vv.map(lambda c: c[idx])
        hit[idx] |= any_hit_plain(iset.geom, mat_affine(m, pick(o)),
                                  mat_linear(m, pick(d)), t_max[idx], slots)
    return hit


def instances_info(iset: InstanceSet) -> dict:
    """{kernel: registers, local-memory bytes a thread, resident blocks a
    SM, whether the set is staged} of the K4 kernels that ``iset`` takes
    (measurement only; needs the card)."""
    import ctypes

    lib = kernels.get_lib()
    out = {}
    for k, name in enumerate(("instances_closest", "instances_any")):
        regs, local, per_sm, staged = (ctypes.c_int() for _ in range(4))
        kernels.check(lib.ptrt_instances_info(
            k, iset.count, int(iset.tlas.shape[0]), ctypes.byref(regs),
            ctypes.byref(local), ctypes.byref(per_sm), ctypes.byref(staged)),
            name)
        out[name] = {"registers": regs.value, "local_bytes": local.value,
                     "blocks_per_sm": per_sm.value,
                     "staged": bool(staged.value)}
    return out


# -- the walks with a tally (measurement only) -------------------------------


class WalkCount(NamedTuple):
    """A counting walk's answer (``Closest`` for K1, the bool plane for
    K2) and the nodes it visited and triangles it tested over all rays."""

    answer: object
    nodes: int
    tris: int


def walk_counts(geom: SceneGeometry, o: Vec3, d: Vec3, t_max: torch.Tensor,
                walk: str) -> WalkCount:
    """Run one of ``WALKS`` with a tally: the main path's K1 ("closest",
    near-first), K1 in slot order ("closest_slot_order") or K2 ("any").
    The answer is the walk's own."""
    kind = WALKS.index(walk)
    n = _check_rays(geom, o, d, t_max)
    if geom.device.type == "cpu":
        return walk_counts_plain(geom, o, d, t_max, walk)
    dev = geom.device
    out = torch.empty((5, n), dtype=torch.float32, device=dev)
    t, u, v = out[0], out[1], out[2]
    slot, mesh = out[3].view(torch.int32), out[4].view(torch.int32)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    counts = torch.empty(2, dtype=torch.int64, device=dev)
    counter = _counter(dev)
    rc = kernels.get_lib().ptrt_walk_counts(
        kind, *_ray_args(geom, o, d, t_max), n, t.data_ptr(), u.data_ptr(),
        v.data_ptr(), slot.data_ptr(), mesh.data_ptr(), hit.data_ptr(),
        counter.data_ptr(), counts.data_ptr(), kernels.stream_ptr(dev))
    kernels.launches["walk_counts"] += 1
    kernels.check(rc, "walk_counts")
    nodes, tris = counts.tolist()
    return WalkCount(hit if walk == "any" else Closest(t, u, v, slot, mesh),
                     nodes, tris)


def _to_rank(m: int, order: int) -> int:
    """Slot-space bitmask -> rank space: bit k is bit ``order[k]`` of m."""
    return sum(((m >> ((order >> (3 * k)) & 7)) & 1) << k for k in range(8))


def walk_counts_plain(geom: SceneGeometry, o: Vec3, d: Vec3,
                      t_max: torch.Tensor, walk: str) -> WalkCount:
    """Plain version of ``walk_counts``: the kernel's walk itself, one ray
    at a time in float32 on the host (the triangles of a leaf through
    ``mt_test``) — the same nodes in the same order
    (near-first by the ray octant's order word in columns 52:60, or slot
    order), a node's hit leaves tested before it descends, t shrinking as
    hits come in — so its tallies are the kernel's."""
    kind = WALKS.index(walk)
    ordered, any_hit = kind == 0, kind == 2
    f32 = lambda c: c.detach().cpu().numpy().astype(np.float32)
    rows = f32(geom.node_rows)
    lo, hi = rows[:, 0:24].reshape(-1, 3, 8), rows[:, 24:48].reshape(-1, 3, 8)
    meta = rows[:, 48:_ORDER_COL + 8].astype(np.int64)  # decoded by value
    leaf = geom.tri_rows.detach().cpu().float().reshape(-1, 10, LEAF_SIZE)
    packed = leaf[:, 9].numpy().astype(np.int64)
    used = (packed >> 1) >= 0
    if any_hit:
        used &= (packed & 1) == 1
    n_nodes, n_blocks = rows.shape[0], leaf.shape[0]
    org = np.stack([f32(c) for c in (o.x, o.y, o.z)], 1)
    dirs = np.stack([f32(c) for c in (d.x, d.y, d.z)], 1)
    t_out = f32(t_max).copy()
    n = t_out.shape[0]
    u_out, v_out = np.zeros(n, np.float32), np.zeros(n, np.float32)
    slot_out, mesh_out = np.full(n, -1, np.int32), np.full(n, -1, np.int32)
    hit_out = np.zeros(n, bool)
    bits = 1 << np.arange(8)
    nodes = tris = 0
    for i in range(n):
        t = t_out[i]
        if not t > 0.0:
            continue
        ro, rd = org[i], dirs[i]
        ray_o, ray_d = Vec3(*torch.from_numpy(ro)), Vec3(*torch.from_numpy(rd))
        inv = np.float32(1.0) / (rd + np.where(rd >= 0.0, np.float32(1e-12),
                                               np.float32(-1e-12)))
        octant = int(rd[0] < 0) | int(rd[1] < 0) << 1 | int(rd[2] < 0) << 2
        base, mask, order, stack = 0, 1, 0, []
        done = False
        while not done:
            rank = (mask & -mask).bit_length() - 1
            mask &= mask - 1
            node = base + ((order >> (3 * rank)) & 7 if ordered else rank)
            if 0 <= node < n_nodes:
                nodes += 1
                cba, lb, lmask, imask = (int(x) for x in meta[node, :4])
                row_order = int(meta[node, 4 + octant]) if ordered else 0
                t0 = (lo[node] - ro[:, None]) * inv[:, None]
                t1 = (hi[node] - ro[:, None]) * inv[:, None]
                te = np.fmax(np.float32(0.0),
                             np.fmax.reduce(np.fmin(t0, t1), axis=0))
                tx = np.fmin(t, np.fmin.reduce(np.fmax(t0, t1), axis=0))
                hitm = int(bits[te <= tx].sum()) & (lmask | imask)
                leaves = hitm & lmask
                while leaves and not done:
                    blk = lb + (leaves & -leaves).bit_length() - 1
                    leaves &= leaves - 1
                    if not 0 <= blk < n_blocks:
                        continue
                    f = leaf[blk]
                    ok, tt, uu, vv = (x.numpy() for x in mt_test(
                        Vec3(*f[0:3]), Vec3(*f[3:6]), Vec3(*f[6:9]), ray_o,
                        ray_d, T_MIN, torch.inf))
                    for j in np.flatnonzero(used[blk]):
                        tris += 1
                        if not (ok[j] and tt[j] < t):
                            continue
                        if any_hit:
                            hit_out[i] = done = True
                            break
                        t = tt[j]
                        u_out[i], v_out[i] = uu[j], vv[j]
                        slot_out[i] = blk * LEAF_SIZE + j
                        mesh_out[i] = packed[blk, j] >> 1
                ints = hitm & imask
                if ints and not done:
                    if mask:
                        stack.append((base, mask, order))
                    base, order = cba, row_order
                    mask = _to_rank(ints, row_order) if ordered else ints
            if mask == 0 and not done:
                if not stack:
                    break
                base, mask, order = stack.pop()
        t_out[i] = t
    dev = t_max.device
    if any_hit:
        return WalkCount(torch.from_numpy(hit_out).to(dev), nodes, tris)
    tt = lambda a: torch.from_numpy(a).to(dev)
    return WalkCount(Closest(tt(t_out), tt(u_out), tt(v_out), tt(slot_out),
                             tt(mesh_out)), nodes, tris)


# -- entry points ------------------------------------------------------------


def _flat(o: Vec3, d: Vec3, t_max):
    shape = torch.broadcast_shapes(o.shape, d.shape, torch.as_tensor(
        t_max).shape)
    flat = lambda c: c.expand(shape).reshape(-1).contiguous()
    t = torch.as_tensor(t_max, dtype=torch.float32, device=d.x.device)
    return shape, o.map(flat), d.map(flat), flat(t)


def hit_record(geom, o: Vec3, d: Vec3, k1: Closest) -> Hit:
    """The ``Hit`` of flat rays from K1's (and K4's) answer: the
    face-forwarded geometric normal of the winning triangle slot (an
    instance hit's through its instance's normal matrix), the hit point,
    the front-face flag."""
    t, u, v, slot, mesh = k1
    inst = k1.inst
    found = slot >= 0
    static = static_of(geom)
    if inst is None:
        idx = slot.clamp_min(0).to(torch.int64)
        take = lambda vv: vv.map(lambda c: c[idx])
        nrm = cross(take(static.e1), take(static.e2))
    else:
        iset = iset_of(geom)
        is_i = inst >= 0
        idx_s = torch.where(is_i, 0, slot).clamp_min(0).to(torch.int64)
        idx_i = torch.where(is_i, slot, 0).clamp_min(0).to(torch.int64)
        take = lambda vv, idx: vv.map(lambda c: c[idx])
        nrm_s = cross(take(static.e1, idx_s), take(static.e2, idx_s))
        nrm_i = mat_normal(iset.mats[inst.clamp_min(0).to(torch.int64)],
                           cross(take(iset.geom.e1, idx_i),
                                 take(iset.geom.e2, idx_i)))
        nrm = where(is_i, nrm_i, nrm_s)
    nrm = where(found, nrm, 0.0)
    n = nrm.normalized(1e-30)
    front = d.dot(n) < 0.0
    n = where(front, n, -n)
    return Hit(hit=found, t=t, point=o + d * t, normal=n, front_face=front,
               mesh_index=mesh, u=u, v=v)


def intersect_closest(geom, o: Vec3, d: Vec3, t_max=T_MAX) -> Hit:
    """Closest hit over a wavefront of any shape (K1, then K4 on a
    ``WorldGeometry``)."""
    shape, of, df, tf = _flat(o, d, t_max)
    h = hit_record(geom, of, df, closest_hit(geom, of, df, tf))
    rs = lambda a: a.map(rs) if isinstance(a, Vec3) else a.reshape(shape)
    return Hit(**{f.name: rs(getattr(h, f.name)) for f in fields(Hit)})


def intersect_any(geom, o: Vec3, d: Vec3, t_max) -> torch.Tensor:
    """Shadow any-hit over a wavefront of any shape (K2, then K4 on a
    ``WorldGeometry``)."""
    shape, of, df, tf = _flat(o, d, t_max)
    return any_hit(geom, of, df, tf).reshape(shape)
