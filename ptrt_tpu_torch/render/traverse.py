"""Ray/scene intersection: the K1 (closest-hit) and K2 (any-hit) wrappers.

Counterpart of ``ptrt_tpu/render/traverse.py`` on a flat ``SceneGeometry``.
``closest_hit`` and ``any_hit`` launch the hand-written 8-wide BVH walks of
``csrc/traverse.cu`` for CUDA tensors and run their plain versions — a
chunked brute-force Möller–Trumbore over the SoA triangle views, after
``traverse._brute_closest_state`` / ``_brute_any_state`` — for CPU tensors.
There is no fallback between the two.

``intersect_closest`` / ``intersect_any`` keep the reference's entry-point
contract (``Hit``, dead lanes with ``t_max <= 0`` return misses), with the
hit normal reconstructed from the winning triangle slot in torch.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import NamedTuple

import torch

from ptrt_tpu_torch import kernels
from ptrt_tpu_torch.core.vec import Vec3, cross, where
from ptrt_tpu_torch.geometry.bvh import LEAF_SIZE
from ptrt_tpu_torch.geometry.scene_geom import SceneGeometry

T_MIN = 1e-4
T_MAX = 1e30
MT_EPS = 1e-9
BARY_EPS = 1e-6

# plain-version tile: rays x triangle slots per elementwise pass
_RAY_CHUNK = 4096
_TRI_CHUNK = 2048


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


class Closest(NamedTuple):
    """K1's answer for flat rays."""

    t: torch.Tensor  # float32, t_max on a miss
    u: torch.Tensor
    v: torch.Tensor
    slot: torch.Tensor  # int32 triangle slot, -1 on a miss
    mesh: torch.Tensor  # int32 mesh id, -1 on a miss


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


def _check_rays(geom: SceneGeometry, o: Vec3, d: Vec3, t_max: torch.Tensor):
    dev = geom.device
    kernels.require_supported(dev)
    kernels.check_tensor("t_max", t_max, torch.float32, 1, dev)
    n = t_max.shape[0]
    for name, c in (("o.x", o.x), ("o.y", o.y), ("o.z", o.z), ("d.x", d.x),
                    ("d.y", d.y), ("d.z", d.z)):
        kernels.check_tensor(name, c, torch.float32, 1, dev)
        if c.shape[0] != n:
            raise ValueError(f"{name}: length {c.shape[0]} != t_max's {n}")
    kernels.check_tensor("node_rows", geom.node_rows, torch.float32, 2, dev)
    kernels.check_tensor("tri_rows", geom.tri_rows, torch.float32, 2, dev)
    if geom.node_rows.shape[1] != 64:
        raise ValueError("node_rows must be (N, 64)")
    if geom.tri_rows.shape[1] != 10 * LEAF_SIZE:
        raise ValueError(f"tri_rows must be (B, {10 * LEAF_SIZE})")
    return n


def _ray_args(geom: SceneGeometry, o: Vec3, d: Vec3, t_max: torch.Tensor):
    lib = kernels.get_lib()
    if geom.stack_depth > lib.ptrt_max_stack():
        raise ValueError(f"BVH depth bound {geom.stack_depth} exceeds the "
                         f"walk's stack of {lib.ptrt_max_stack()}")
    return [geom.node_rows.data_ptr(), geom.num_nodes,
            geom.tri_rows.data_ptr(), int(geom.tri_rows.shape[0]),
            o.x.data_ptr(), o.y.data_ptr(), o.z.data_ptr(),
            d.x.data_ptr(), d.y.data_ptr(), d.z.data_ptr(),
            t_max.data_ptr(), int(t_max.shape[0])]


# -- K1 ----------------------------------------------------------------------


def closest_hit(geom: SceneGeometry, o: Vec3, d: Vec3, t_max: torch.Tensor):
    """Nearest hit per ray.  Rays are flat (R,) float32 SoA tensors.

    Returns ``Closest(t, u, v, slot, mesh)``: float32 t (``t_max`` on a
    miss), u, v, int32 triangle slot into the SoA views and int32 mesh id,
    both -1 on a miss."""
    n = _check_rays(geom, o, d, t_max)
    if geom.device.type == "cpu":
        return closest_hit_plain(geom, o, d, t_max)
    dev = geom.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    mesh = torch.empty_like(slot)
    lib = kernels.get_lib()
    rc = lib.ptrt_closest_hit(
        *_ray_args(geom, o, d, t_max), t.data_ptr(), u.data_ptr(),
        v.data_ptr(), slot.data_ptr(), mesh.data_ptr(),
        kernels.stream_ptr(dev))
    kernels.launches["closest_hit"] += 1
    kernels.check(rc, "closest_hit")
    return Closest(t, u, v, slot, mesh)


def closest_hit_plain(geom: SceneGeometry, o: Vec3, d: Vec3,
                      t_max: torch.Tensor):
    """Plain version of K1: all-pairs Möller–Trumbore over triangle chunks
    (earlier chunk, then lower slot, wins a tie)."""
    n = t_max.shape[0]
    m = geom.num_tri_slots
    best_t = t_max.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=t_max.device)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    for r0 in range(0, n, _RAY_CHUNK):
        rs = slice(r0, min(n, r0 + _RAY_CHUNK))
        oe = o.map(lambda c: c[rs, None])
        de = d.map(lambda c: c[rs, None])
        for c0 in range(0, m, _TRI_CHUNK):
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


def any_hit(geom: SceneGeometry, o: Vec3, d: Vec3,
            t_max: torch.Tensor) -> torch.Tensor:
    """Occluded-or-not per ray up to ``t_max`` (bool); triangles whose
    shadow-opaque bit is clear (transmissive materials) never occlude."""
    n = _check_rays(geom, o, d, t_max)
    if geom.device.type == "cpu":
        return any_hit_plain(geom, o, d, t_max)
    hit = torch.empty(n, dtype=torch.uint8, device=geom.device)
    lib = kernels.get_lib()
    rc = lib.ptrt_any_hit(*_ray_args(geom, o, d, t_max), hit.data_ptr(),
                          kernels.stream_ptr(geom.device))
    kernels.launches["any_hit"] += 1
    kernels.check(rc, "any_hit")
    return hit.bool()


def any_hit_plain(geom: SceneGeometry, o: Vec3, d: Vec3,
                  t_max: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: all-pairs Möller–Trumbore over triangle chunks."""
    n = t_max.shape[0]
    m = geom.num_tri_slots
    hit = torch.zeros(n, dtype=torch.bool, device=t_max.device)
    for r0 in range(0, n, _RAY_CHUNK):
        rs = slice(r0, min(n, r0 + _RAY_CHUNK))
        oe = o.map(lambda c: c[rs, None])
        de = d.map(lambda c: c[rs, None])
        for c0 in range(0, m, _TRI_CHUNK):
            cs = slice(c0, min(m, c0 + _TRI_CHUNK))
            tri = lambda v: v.map(lambda c: c[None, cs])
            ok, _, _, _ = mt_test(tri(geom.v0), tri(geom.e1), tri(geom.e2),
                                  oe, de, T_MIN, t_max[rs, None])
            ok = ok & geom.tri_shadow_opaque[None, cs]
            hit[rs] |= ok.any(dim=1)
    return hit


# -- entry points ------------------------------------------------------------


def _flat(o: Vec3, d: Vec3, t_max):
    shape = torch.broadcast_shapes(o.shape, d.shape, torch.as_tensor(
        t_max).shape)
    flat = lambda c: c.expand(shape).reshape(-1).contiguous()
    t = torch.as_tensor(t_max, dtype=torch.float32, device=d.x.device)
    return shape, o.map(flat), d.map(flat), flat(t)


def hit_record(geom: SceneGeometry, o: Vec3, d: Vec3, k1: Closest) -> Hit:
    """The ``Hit`` of flat rays from K1's answer: the face-forwarded
    geometric normal of the winning triangle slot, the hit point, the
    front-face flag."""
    t, u, v, slot, mesh = k1
    found = slot >= 0
    idx = slot.clamp_min(0).to(torch.int64)
    take = lambda vv: vv.map(lambda c: c[idx])
    nrm = where(found, cross(take(geom.e1), take(geom.e2)), 0.0)
    n = nrm.normalized(1e-30)
    front = d.dot(n) < 0.0
    n = where(front, n, -n)
    return Hit(hit=found, t=t, point=o + d * t, normal=n, front_face=front,
               mesh_index=mesh, u=u, v=v)


def intersect_closest(geom: SceneGeometry, o: Vec3, d: Vec3,
                      t_max=T_MAX) -> Hit:
    """Closest hit over a wavefront of any shape (K1)."""
    shape, of, df, tf = _flat(o, d, t_max)
    h = hit_record(geom, of, df, closest_hit(geom, of, df, tf))
    rs = lambda a: a.map(rs) if isinstance(a, Vec3) else a.reshape(shape)
    return Hit(**{f.name: rs(getattr(h, f.name)) for f in fields(Hit)})


def intersect_any(geom: SceneGeometry, o: Vec3, d: Vec3,
                  t_max) -> torch.Tensor:
    """Shadow any-hit over a wavefront of any shape (K2)."""
    shape, of, df, tf = _flat(o, d, t_max)
    return any_hit(geom, of, df, tf).reshape(shape)
