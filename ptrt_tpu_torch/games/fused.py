"""Fused game frames: the game's step, the scene update and the frame, with
no host work a frame beyond the inputs and fetching the image.

Counterpart of ``ptrt_tpu/games/fused.py``, where the step, the instance
update and the frame are one jitted XLA program.  Here they are eager
torch and hand-written kernels, and nothing in a frame goes through the
host: a game supplies

  * ``step_fn(state, inputs) -> state``
  * ``derive_fn(state) -> DerivedScene``

on device tensors, and ``FusedRunner`` keeps the scene's static world, the
merged instance set's tables (a copy: refits write it in place) and its
refit plans, then each frame steps the game, refits each refilled mesh on
the device (K5 ``refit_apply``, or ``lbvh_update`` where the mesh has
``device_lbvh``) and refreshes its local box (``refit_root_aabb``), writes
the instance rows, world boxes and instance tree with K11
(``dtransform.instances_update``) into buffers allocated once (their
addresses never change, the grid path's scratch included), and renders
that world with the scene's frame body (``Scene.render_world``).  No
``UnifiedScene`` handle, no ``Scene._rebuild_geometry``, no host tree build
and no host read of the game state, boxes or tables inside a frame.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.geometry.dtransform import (instances_scratch,
                                                instances_update,
                                                one_block_max)
from ptrt_tpu_torch.geometry.lbvh import lbvh_update
from ptrt_tpu_torch.geometry.refit import refit_apply, refit_root_aabb
from ptrt_tpu_torch.geometry.scene_geom import InstanceSet, WorldGeometry
from ptrt_tpu_torch.geometry.tlas import TLAS_ROW, TLAS_WIDTH, tlas_node_count


@dataclass
class DerivedScene:
    """What a game's ``derive_fn`` returns: each dynamic instance's TRS (the
    scene's dynamic-mesh order) as (I, 3) float32 device tensors, and
    optional per-frame extras."""

    pos: torch.Tensor  # (I, 3)
    rot: torch.Tensor  # (I, 3) Euler XYZ, Transform3D's convention
    scale: torch.Tensor  # (I, 3)
    camera: object = None  # a Camera for this frame, else the scene's
    refits: dict = None  # {instance index: (v0, v1, v2)}, (T, 3) each


def _copy_geometry(g):
    """A copy of the merged set's tables on their device: the refits write
    the copy, and the scene's own tables stay as its host state says."""
    copy = lambda v: v.map(torch.clone) if isinstance(v, Vec3) else v.clone()
    return dataclasses.replace(g, **{
        f.name: copy(getattr(g, f.name))
        for f in dataclasses.fields(g) if f.name != "stack_depth"})


class FusedRunner:
    """Step and render a prepared ``Scene`` frame after frame.

    The scene holds its dynamic meshes (``is_dynamic``) in the order
    ``derive_fn`` emits.  The static tables (the world BVH, materials,
    lights, sky, blue noise) are the scene's; per-frame state is the game
    state, the RNG state, the denoiser history and the previous
    view-projection, all on the device."""

    def __init__(self, scene, step_fn: Callable, derive_fn: Callable):
        scene._ensure_device_state()
        geom = scene._geom
        if not isinstance(geom, WorldGeometry) or geom.iset is None:
            raise ValueError("FusedRunner needs a scene with dynamic "
                             "instances (WorldGeometry + InstanceSet)")
        self.scene = scene
        self.step_fn = step_fn
        self.derive_fn = derive_fn
        dev = scene.device
        iset = geom.iset
        self._geom = _copy_geometry(iset.geom)
        self._plans = scene._iset_cache["plans"]
        self._dyn = [m for m in scene.meshes if m.is_dynamic]
        lo = np.stack([m.local_aabb().lo for m in self._dyn]).astype(
            np.float32)
        hi = np.stack([m.local_aabb().hi for m in self._dyn]).astype(
            np.float32)
        self._local_lo = torch.from_numpy(lo).to(dev)
        self._local_hi = torch.from_numpy(hi).to(dev)
        # the local boxes a frame with refits reads (its meshes' rows
        # refreshed), and K11's outputs: allocated once
        self._llo = self._local_lo.clone()
        self._lhi = self._local_hi.clone()
        n = iset.count
        f32 = dict(dtype=torch.float32, device=dev)
        self._iset = InstanceSet(
            geom=self._geom, roots=iset.roots,
            mats=torch.zeros((n, 24), **f32),
            bb_min=torch.zeros((n, 3), **f32),
            bb_max=torch.zeros((n, 3), **f32),
            tlas=torch.zeros((tlas_node_count(n), TLAS_WIDTH, TLAS_ROW),
                             **f32))
        # a set past the one-block kernel's takes the grid path on the card,
        # whose working buffers are allocated once here too
        self._scratch = (instances_scratch(n, dev)
                         if dev.type == "cuda" and n > one_block_max()
                         else None)
        # always the instance walks: the world carries its instances only
        # in the merged set
        self._world = WorldGeometry(static=geom.static, instances=(),
                                    iset=self._iset)

    @property
    def world(self) -> WorldGeometry:
        """The world the frames render (its set's tables at fixed
        addresses)."""
        return self._world

    def frame(self, state, inputs, frame_index: int, prev_view_proj):
        """One fused frame: (state, rgb8 (H, W, 3) uint8 on the device, the
        frame's camera)."""
        sc = self.scene
        state = self.step_fn(state, inputs)
        drv = self.derive_fn(state)
        llo, lhi = self._local_lo, self._local_hi
        if drv.refits:
            llo, lhi = self._llo, self._lhi
            llo.copy_(self._local_lo)
            lhi.copy_(self._local_hi)
            for idx, (v0, v1, v2) in sorted(drv.refits.items()):
                plan = self._plans[idx]
                # meshes flagged device_lbvh take the Morton-sorted refill
                apply = lbvh_update if self._dyn[idx].device_lbvh \
                    else refit_apply
                apply(self._geom, plan, v0, v1, v2)
                rlo, rhi = refit_root_aabb(self._geom, plan)
                llo[idx] = rlo
                lhi[idx] = rhi
        s = self._iset
        instances_update(drv.pos, drv.rot, drv.scale, llo, lhi, s.mats,
                         s.bb_min, s.bb_max, s.tlas, self._scratch)
        cam = drv.camera if drv.camera is not None else sc.camera
        rgb8 = sc.render_world(self._world, cam, frame_index,
                               prev_view_proj)
        return state, rgb8, cam

    def _sync(self) -> None:
        if self.scene.device.type == "cuda":
            torch.cuda.synchronize(self.scene.device)

    def run(self, state, inputs_fn: Callable, n_frames: int,
            present: Callable | None = None):
        """One warm-up frame, then ``n_frames`` timed ones; returns (state,
        frames a second, the last RGB8 as numpy).  ``inputs_fn(i)`` gives
        frame i's inputs (the one host job of the loop); ``present`` gets
        each timed frame as numpy (the loop's only read of the device, and
        only when given)."""
        sc = self.scene
        state, rgb8, cam = self.frame(state, inputs_fn(0), sc.frame_count,
                                      sc.prev_view_proj)
        prev_vp = cam.get_view_proj()
        self._sync()
        t0 = time.perf_counter()
        for i in range(1, n_frames + 1):
            state, rgb8, cam = self.frame(state, inputs_fn(i),
                                          sc.frame_count + i, prev_vp)
            prev_vp = cam.get_view_proj()
            if present is not None:
                present(rgb8.cpu().numpy())
        self._sync()
        fps = n_frames / (time.perf_counter() - t0)
        sc.frame_count += n_frames + 1
        return state, fps, rgb8.cpu().numpy()
