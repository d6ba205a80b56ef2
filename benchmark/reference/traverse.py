"""The reference's visibility test: closest-hit and any-hit walks over the
reference's own triangle table (``scene_geom.Triangles``), with no BVH.

The triangles are cut into chunks of ``CHUNK`` in mesh order; a ray tests
the triangles of each chunk whose box (padded) its slab test admits within
its ``t_max``, by the port's two-sided Möller–Trumbore (``mt_test``, a
frozen copy of ``ptrt_tpu_torch/render/traverse.py``'s), a block of (ray,
chunk) pairs at a time.  The box test
only skips triangles a ray cannot hit, so the answer is the all-pairs one:
the closest ``t`` in ``(T_MIN, t_max)``, a tie going to the lower index.
``hit_record`` is the port's record of a static hit (``Hit``: the
face-forwarded geometric normal, the hit point, the front flag)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from benchmark.reference.scene_geom import Triangles
from benchmark.reference.vec import Vec3, cross, where

T_MIN = 1e-4
T_MAX = 1e30
MT_EPS = 1e-9
BARY_EPS = 1e-6
CHUNK = 1024
# rays a block of the chunk-box tests, and (ray, chunk) pairs a block of
# triangle tests
RAY_BLOCK = 8192
PAIR_BLOCK = 4096
# a chunk box is widened by this share of the scene's extent on each side
BOX_PAD = 1e-4


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
    t: torch.Tensor  # float32, t_max on a miss
    u: torch.Tensor
    v: torch.Tensor
    slot: torch.Tensor  # int64 triangle index, -1 on a miss
    mesh: torch.Tensor  # int32 mesh id, -1 on a miss


def mt_test(v0: Vec3, e1: Vec3, e2: Vec3, o: Vec3, d: Vec3, t_min, t_max):
    """Two-sided Möller–Trumbore with precomputed edges and an inclusive
    barycentric epsilon."""
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


class Chunks(NamedTuple):
    """The chunk boxes of a triangle table: (C, 3) lower and upper
    corners."""

    lo: torch.Tensor
    hi: torch.Tensor


def chunk_boxes(tris: Triangles) -> Chunks:
    m = tris.count
    corners = []
    for a in (tris.v0, tris.v0 + tris.e1, tris.v0 + tris.e2):
        corners.append(torch.stack([a.x, a.y, a.z], 1))
    pts = torch.stack(corners, 1)  # (M, 3, 3)
    pad_n = (-m) % CHUNK
    lo_t = pts.amin(1)
    hi_t = pts.amax(1)
    if pad_n:
        lo_t = torch.cat([lo_t, lo_t[-1:].expand(pad_n, 3)])
        hi_t = torch.cat([hi_t, hi_t[-1:].expand(pad_n, 3)])
    lo = lo_t.view(-1, CHUNK, 3).amin(1)
    hi = hi_t.view(-1, CHUNK, 3).amax(1)
    pad = BOX_PAD * float((hi.amax(0) - lo.amin(0)).max()) + 1e-6
    return Chunks(lo - pad, hi + pad)


def _pairs(chunks: Chunks, o: Vec3, d: Vec3, t_max: torch.Tensor):
    """(ray, chunk) index pairs, ray-major: every chunk box that a live
    ray's segment [0, t_max] enters (slab test; a ray parallel to a slab
    gets an infinite inverse, whose products with a zero distance (NaN)
    never exclude a chunk).  Rays go in blocks of ``RAY_BLOCK``."""
    rays, chs = [], []
    live = t_max > T_MIN
    for r0 in range(0, t_max.shape[0], RAY_BLOCK):
        rs = slice(r0, r0 + RAY_BLOCK)
        og = torch.stack([o.x[rs], o.y[rs], o.z[rs]], 1)[:, None, :]
        inv = 1.0 / torch.stack([d.x[rs], d.y[rs], d.z[rs]], 1)[:, None, :]
        t0 = (chunks.lo[None] - og) * inv
        t1 = (chunks.hi[None] - og) * inv
        near = torch.nan_to_num(torch.minimum(t0, t1), nan=-torch.inf)
        far = torch.nan_to_num(torch.maximum(t0, t1), nan=torch.inf)
        near, far = near.amax(2), far.amin(2)
        cand = ((near <= far) & (far >= 0.0)
                & (near <= t_max[rs, None]) & live[rs, None])
        r, c = cand.nonzero(as_tuple=True)
        rays.append(r + r0)
        chs.append(c)
    return torch.cat(rays), torch.cat(chs)


def _tested(tris: Triangles, chunks: Chunks, o: Vec3, d: Vec3,
            t_max: torch.Tensor, r, c):
    """Möller–Trumbore of pair rays ``r`` against every triangle of pair
    chunks ``c``: (ok, t, u, v), each (pairs, CHUNK), and the triangles'
    indices (pairs, CHUNK); the padding past the last triangle never
    passes."""
    idx = c[:, None] * CHUNK + torch.arange(CHUNK, device=c.device)[None]
    pad = idx >= tris.count
    idx = idx.clamp_max(tris.count - 1)
    tri = lambda v: v.map(lambda a: a[idx])
    ok, t, u, v = mt_test(tri(tris.v0), tri(tris.e1), tri(tris.e2),
                          o.map(lambda a: a[r, None]),
                          d.map(lambda a: a[r, None]), T_MIN,
                          t_max[r, None])
    return ok & ~pad, t, u, v, idx


def closest_hit(tris: Triangles, chunks: Chunks, o: Vec3, d: Vec3,
                t_max: torch.Tensor) -> Closest:
    """The closest hit of each flat ray with ``t_max > T_MIN``; the others
    and the rays that hit nothing keep ``t_max`` and slot -1."""
    n = t_max.shape[0]
    dev = t_max.device
    best_t = t_max.clone()
    best_tri = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros_like(best_t)
    best_v = torch.zeros_like(best_t)
    pr, pc = _pairs(chunks, o, d, t_max)
    for p0 in range(0, pr.shape[0], PAIR_BLOCK):
        r, c = pr[p0:p0 + PAIR_BLOCK], pc[p0:p0 + PAIR_BLOCK]
        ok, t, u, v, idx = _tested(tris, chunks, o, d, t_max, r, c)
        t = torch.where(ok, t, torch.inf)
        # each pair's nearest triangle (the lower index on a tie) ...
        j = torch.argmin(t, dim=1, keepdim=True)
        pt = torch.gather(t, 1, j)[:, 0]
        pi = torch.gather(idx, 1, j)[:, 0]
        found = torch.isfinite(pt)
        r, pt, pi = r[found], pt[found], pi[found]
        pu = torch.gather(u, 1, j)[:, 0][found]
        pv = torch.gather(v, 1, j)[:, 0][found]
        # ... against the ray's best so far: the nearer, the lower index on
        # a tie (pairs are ray-major, so one ray's pairs can share a block)
        key_t = torch.full((n,), torch.inf, device=dev)
        key_t.scatter_reduce_(0, r, pt, "amin")
        win = pt == key_t[r]
        key_i = torch.full((n,), torch.iinfo(torch.int64).max,
                           dtype=torch.int64, device=dev)
        key_i.scatter_reduce_(0, r[win], pi[win], "amin")
        win = win & (pi == key_i[r])
        r, pt, pi, pu, pv = r[win], pt[win], pi[win], pu[win], pv[win]
        better = (pt < best_t[r]) | ((pt == best_t[r]) & (best_tri[r] >= 0)
                                     & (pi < best_tri[r]))
        r, pt, pi, pu, pv = (a[better] for a in (r, pt, pi, pu, pv))
        best_t[r], best_tri[r], best_u[r], best_v[r] = pt, pi, pu, pv
    found = best_tri >= 0
    mesh = torch.where(found, tris.mesh_id[best_tri.clamp_min(0)], -1)
    return Closest(best_t, torch.where(found, best_u, 0.0),
                   torch.where(found, best_v, 0.0), best_tri,
                   mesh.to(torch.int32))


def closest_hit_live(tris: Triangles, chunks: Chunks, o: Vec3, d: Vec3,
                     alive: torch.Tensor) -> Closest:
    """``closest_hit`` of the lanes flagged in ``alive``: a live lane walks
    with t_max = ``T_MAX``, a dead one returns a miss at t = -1."""
    t_max = torch.where(alive, T_MAX, -1.0).to(torch.float32)
    return closest_hit(tris, chunks, o, d, t_max)


def any_hit(tris: Triangles, chunks: Chunks, o: Vec3, d: Vec3,
            t_max: torch.Tensor) -> torch.Tensor:
    """Whether an opaque triangle lies in ``(T_MIN, t_max)`` along each
    flat ray (never for ``t_max <= T_MIN``)."""
    hit = torch.zeros(t_max.shape[0], dtype=torch.bool, device=t_max.device)
    pr, pc = _pairs(chunks, o, d, t_max)
    for p0 in range(0, pr.shape[0], PAIR_BLOCK):
        r, c = pr[p0:p0 + PAIR_BLOCK], pc[p0:p0 + PAIR_BLOCK]
        ok, _, _, _, idx = _tested(tris, chunks, o, d, t_max, r, c)
        ok = ok & tris.shadow_opaque[idx]
        hit[r[ok.any(dim=1)]] = True
    return hit


def hit_record(tris: Triangles, o: Vec3, d: Vec3, k1: Closest) -> Hit:
    """The ``Hit`` of flat rays from their closest hit: the face-forwarded
    geometric normal of the winning triangle, the hit point, the front-face
    flag."""
    t, u, v, slot, mesh = k1
    found = slot >= 0
    idx = slot.clamp_min(0)
    take = lambda vv: vv.map(lambda c: c[idx])
    nrm = cross(take(tris.e1), take(tris.e2))
    nrm = where(found, nrm, 0.0)
    n = nrm.normalized(1e-30)
    front = d.dot(n) < 0.0
    n = where(front, n, -n)
    return Hit(hit=found, t=t, point=o + d * t, normal=n, front_face=front,
               mesh_index=mesh, u=u, v=v)
