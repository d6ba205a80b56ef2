"""The Morton-sorted device refill of a dynamic mesh (K5 ``morton_sort`` and
``morton_codes``).

Counterpart of ``ptrt_tpu/geometry/lbvh.py``.  The host BVH build
allocates leaf blocks depth first, so each subtree owns a contiguous run of
blocks; a refill that sorts the new triangles by the Morton code of their
centroids and fills the fixed slots in that order keeps the leaf boxes
tight under any re-shape of the same triangle count, with no host build:

1. ``morton_order``: each triangle's centroid (the middle of its box), the
   centroids' bounds, 30-bit Morton codes, and the triangles sorted by code
   (stable: ties by index, as the reference's ``jax.lax.sort``).  On CUDA
   tensors a mesh of up to the kernel's limit (``ptrt_morton_sort_max``,
   16,384 triangles) takes one launch of ``csrc/refit.cu``'s
   ``morton_sort``, which returns the order itself; a
   larger one the grid-wide ``morton_codes`` kernel, then
   ``torch.sort(codes, stable=True)`` (the reference sorts with
   ``jax.lax.sort`` outside any kernel).  On CPU tensors the plain version,
   ``morton_codes_plain`` and the same ``torch.sort``;
2. ``refit.refit_apply`` with the slot map ``(rank, order)``: the k-th
   non-pad slot takes the k-th sorted triangle (``lbvh_slot_map``'s
   gather folds into the refit's slot pass), then the bottom-up boxes.

Closest hits do not depend on the tree, so a trace after ``lbvh_update``
equals one through a host rebuild wherever no two triangles tie in t.
"""

from __future__ import annotations

import torch

from ptrt_tpu_torch import kernels
from ptrt_tpu_torch.geometry.refit import RefitPlan, refit_apply
from ptrt_tpu_torch.geometry.scene_geom import SceneGeometry

MBITS = 10  # bits an axis: 30-bit codes
_CODE_BLOCKS = 1024  # the most blocks a morton_codes launch takes


def _centroids(v0, v1, v2) -> torch.Tensor:
    return (torch.minimum(torch.minimum(v0, v1), v2)
            + torch.maximum(torch.maximum(v0, v1), v2)) * 0.5


def morton_codes_plain(v0: torch.Tensor, v1: torch.Tensor,
                       v2: torch.Tensor) -> torch.Tensor:
    """Plain version of ``morton_codes``: the reference's ``morton_order``
    up to its sort (``morton_codes`` on the centroids within their own
    bounds)."""
    cent = _centroids(v0, v1, v2)
    lo = cent.amin(dim=0)
    hi = cent.amax(dim=0)
    n = (1 << MBITS) - 1
    span = torch.clamp_min(hi - lo, 1e-12)
    q = []
    for a in range(3):
        f = (cent[:, a] - lo[a]) / span[a]
        q.append(torch.clamp((f * n).to(torch.int32), 0, n))
    code = torch.zeros_like(q[0])
    for b in range(MBITS):
        code = (code
                | (((q[0] >> b) & 1) << (3 * b))
                | (((q[1] >> b) & 1) << (3 * b + 1))
                | (((q[2] >> b) & 1) << (3 * b + 2)))
    return code


def _stable_order(codes: torch.Tensor) -> torch.Tensor:
    return torch.sort(codes, stable=True).indices.to(torch.int32)


def morton_order_plain(v0: torch.Tensor, v1: torch.Tensor,
                       v2: torch.Tensor) -> torch.Tensor:
    """Plain version of ``morton_order``: ``morton_codes_plain``, then a
    stable sort."""
    return _stable_order(morton_codes_plain(v0, v1, v2))


def _check(v0, v1, v2) -> torch.device:
    dev = v0.device
    kernels.require_supported(dev)
    for name, v in (("v0", v0), ("v1", v1), ("v2", v2)):
        kernels.check_tensor(name, v, torch.float32, 2, dev)
        if v.shape != v0.shape or v.shape[1] != 3:
            raise ValueError(f"{name}: shape {tuple(v.shape)}, need (T, 3) "
                             "like v0")
    return dev


def morton_codes(v0: torch.Tensor, v1: torch.Tensor,
                 v2: torch.Tensor) -> torch.Tensor:
    """(T,) int32 Morton codes of the triangles' centroids quantized inside
    the centroids' bounds; ``v0`` / ``v1`` / ``v2`` are (T, 3) float32."""
    dev = _check(v0, v1, v2)
    if dev.type == "cpu":
        return morton_codes_plain(v0, v1, v2)
    codes = torch.empty(v0.shape[0], dtype=torch.int32, device=dev)
    scratch = torch.empty((_CODE_BLOCKS, 6), dtype=torch.float32,
                          device=dev)
    rc = kernels.get_lib().ptrt_morton_codes(
        v0.data_ptr(), v1.data_ptr(), v2.data_ptr(), int(v0.shape[0]),
        codes.data_ptr(), scratch.data_ptr(), _CODE_BLOCKS,
        kernels.stream_ptr(dev))
    kernels.launches["morton_codes"] += 1
    kernels.check(rc, "morton_codes")
    return codes


def morton_sort(v0: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor,
                with_codes: bool = False) -> tuple:
    """(order, codes or None): ``morton_order`` and, with ``with_codes``,
    ``morton_codes`` of a mesh of at most the kernel's limit (16,384
    triangles) in one launch on CUDA tensors; the plain versions on CPU
    tensors."""
    dev = _check(v0, v1, v2)
    if dev.type == "cpu":
        codes = morton_codes_plain(v0, v1, v2)
        return _stable_order(codes), codes if with_codes else None
    lib = kernels.get_lib()
    n = int(v0.shape[0])
    if n > lib.ptrt_morton_sort_max():
        raise ValueError(f"morton_sort: {n} triangles, the kernel sorts at "
                         f"most {lib.ptrt_morton_sort_max()}")
    order = torch.empty(n, dtype=torch.int32, device=dev)
    codes = (torch.empty(n, dtype=torch.int32, device=dev) if with_codes
             else None)
    rc = lib.ptrt_morton_sort(
        v0.data_ptr(), v1.data_ptr(), v2.data_ptr(), n, order.data_ptr(),
        0 if codes is None else codes.data_ptr(), kernels.stream_ptr(dev))
    kernels.launches["morton_sort"] += 1
    kernels.check(rc, "morton_sort")
    return order, codes


def morton_order(v0: torch.Tensor, v1: torch.Tensor,
                 v2: torch.Tensor) -> torch.Tensor:
    """(T,) int32: the triangles sorted by Morton code (ties by index)."""
    dev = _check(v0, v1, v2)
    if dev.type == "cpu":
        return morton_order_plain(v0, v1, v2)
    if v0.shape[0] <= kernels.get_lib().ptrt_morton_sort_max():
        return morton_sort(v0, v1, v2)[0]
    return _stable_order(morton_codes(v0, v1, v2))


def lbvh_slot_map(plan: RefitPlan, order: torch.Tensor) -> torch.Tensor:
    """(M,) int32 slot->triangle map that fills the plan's fixed slots in
    ``order``: the k-th non-pad slot takes ``order[k]``, pads stay -1 (what
    ``refit_apply``'s ``slot_map=(rank, order)`` computes in its slot
    pass)."""
    rank = plan.device_arrays(order.device)["rank"]
    return torch.where(rank >= 0, order[rank.long().clamp_min(0)], -1).to(
        torch.int32)


def lbvh_update(geom: SceneGeometry, plan: RefitPlan, v0: torch.Tensor,
                v1: torch.Tensor, v2: torch.Tensor,
                root: tuple | None = None) -> SceneGeometry:
    """Morton sort, sorted refill and bottom-up refit of one mesh's BVH
    inside ``geom``, in place (``refit_apply``'s contract plus the sort;
    ``root`` as there)."""
    order = morton_order(v0, v1, v2)
    rank = plan.device_arrays(geom.device)["rank"]
    return refit_apply(geom, plan, v0, v1, v2, slot_map=(rank, order),
                       root=root)
