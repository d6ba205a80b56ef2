"""Fused game frames: the game's step, the scene update and the frame, with
no host work a frame beyond the inputs and fetching the image.

Counterpart of ``ptrt_tpu/games/fused.py``, where the step, the instance
update and the frame are one jitted XLA program.  Here the frame is
hand-written kernels and torch ops, and on the card it is one program
too: ``FusedRunner.run`` captures the frame once into a CUDA graph
(``graphs.py``) and replays it each frame.  A game supplies

  * ``step_fn(state, inputs) -> state``
  * ``derive_fn(state) -> DerivedScene``

on device tensors (``inputs``: the host's values for the frame, staged on
the device by the runner), and ``FusedRunner`` keeps the scene's static
world, the merged instance set's tables (a copy: refits write it in
place) and its refit plans, then each frame steps the game, refits each
refilled mesh on the device (K5 ``refit_apply``, or ``lbvh_update`` where
the mesh has ``device_lbvh``), which also writes its root box as the
instance's local box (the values of ``refit_root_aabb``), writes the instance rows, world boxes and instance
tree with K11 (``dtransform.instances_update``) into buffers allocated
once (their addresses never change, the grid path's scratch included),
and renders that world with the scene's frame body
(``Scene.render_world``).  No ``UnifiedScene`` handle, no
``Scene._rebuild_geometry``, no host tree build and no host read of the
game state, boxes or tables inside a frame.

The captured frame is a ``graphs.Program``, the scenes' frame programs'
tool, and reads what changes from frame to frame from its buffers on the
card: the game state, the PCG state, the denoiser history and the
previous view-projection (the graph writes each frame's values back into
them), the camera (copied in before a replay when the scene's camera is
another object than the one last copied), and the frame index with the
game's inputs (one non-blocking copy from pinned memory,
``graphs.HostValues``).  It is
bit for bit the eager frame (``frame``), which stays the CPU path and the
body that is captured.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ptrt_tpu_torch import graphs
from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.geometry.dtransform import (instances_scratch,
                                                instances_update,
                                                one_block_max)
from ptrt_tpu_torch.geometry.lbvh import lbvh_update
from ptrt_tpu_torch.geometry.refit import refit_apply
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
        # the eager frames' staged inputs, and the captured frame
        self._values = graphs.HostValues(dev)
        self._prog = None

    @property
    def world(self) -> WorldGeometry:
        """The world the frames render (its set's tables at fixed
        addresses)."""
        return self._world

    @property
    def state(self):
        """The captured graph's game state (the program's buffers: each
        replay writes the frame's state back into them), or None."""
        return None if self._prog is None else self._prog.state["state"]

    def _body(self, state, inputs, frame_index, prev_view_proj, camera):
        """The frame on device inputs: (state, rgb8, the frame's camera).
        ``camera``: used where the game derives none."""
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
                # the refit writes its root box as the local box
                apply(self._geom, plan, v0, v1, v2,
                      root=(llo[idx], lhi[idx]))
        s = self._iset
        instances_update(drv.pos, drv.rot, drv.scale, llo, lhi, s.mats,
                         s.bb_min, s.bb_max, s.tlas, self._scratch)
        cam = drv.camera if drv.camera is not None else camera
        rgb8 = sc.render_world(self._world, cam, frame_index,
                               prev_view_proj)
        return state, rgb8, cam

    def frame(self, state, inputs, frame_index: int, prev_view_proj):
        """One eager fused frame: (state, rgb8 (H, W, 3) uint8 on the
        device, the frame's camera).  ``inputs``: the host's values for the
        frame (nested tuples of Python numbers and 0-d CPU tensors), which
        the step reads staged on the device; ``frame_index`` a Python
        int."""
        return self._body(state, self._values.stage(inputs), frame_index,
                          prev_view_proj, self.scene.camera)

    def capture(self, state, inputs, prev_view_proj) -> None:
        """Capture one frame into a CUDA graph (the card only; raises if the
        capture fails), as a ``graphs.Program``: its buffers start from
        ``state``, the scene's PCG state and denoiser history,
        ``prev_view_proj`` and the scene's camera; ``inputs`` gives the
        structure every frame's inputs keep.  The frame is warmed up once
        on a side stream first, with nothing written back.  Afterwards the
        scene's PCG state and denoiser history are the program's buffers,
        which each ``replay`` advances.  The graph's memory pool is its
        own."""
        sc = self.scene
        if sc.device.type != "cuda":
            raise ValueError("a CUDA graph needs the scene on a CUDA device")
        self._prog = None

        def body(reads, st, values):
            index, staged = values
            sc._rng_state, sc._denoiser_state = st["rng"], st["den"]
            new, rgb8, cam = self._body(st["state"], staged, index,
                                        st["prev_vp"], reads["camera"])
            return rgb8, {"state": new, "rng": sc._rng_state,
                          "den": sc._denoiser_state,
                          "prev_vp": cam.get_view_proj()}

        rng, den = sc._rng_state, sc._denoiser_state
        try:
            prog = graphs.Program(
                body, {"camera": sc.camera},
                {"state": state, "rng": rng, "den": den,
                 "prev_vp": prev_view_proj}, (0, inputs), sc.device)
        except BaseException:
            sc._rng_state, sc._denoiser_state = rng, den
            raise
        sc._rng_state = prog.state["rng"]
        sc._denoiser_state = prog.state["den"]
        self._prog = prog

    @property
    def program(self) -> graphs.Program | None:
        """The captured frame (``capture``), or None."""
        return self._prog

    def replay(self, inputs, frame_index: int) -> torch.Tensor:
        """One frame of the captured graph: the scene's camera copied into
        the program's when it is another object than the one last copied,
        ``inputs`` and ``frame_index`` staged, one ``replay()``.  Returns
        the graph's RGB8 output (overwritten by the next replay); the game
        state is ``state``, the PCG state and denoiser history the
        program's (the scene's are not read)."""
        if self._prog is None:
            raise RuntimeError("no captured frame: call capture first")
        return self._prog.run({"camera": self.scene.camera}, None,
                              (frame_index, inputs))

    def release(self):
        """Drop the captured graph (and its memory pool); returns its game
        state.  The scene keeps the program's PCG state and denoiser
        history, which live outside the pool."""
        st = self._prog.state["state"]
        self._prog = None
        return st

    def _sync(self) -> None:
        if self.scene.device.type == "cuda":
            torch.cuda.synchronize(self.scene.device)

    def run(self, state, inputs_fn: Callable, n_frames: int,
            present: Callable | None = None):
        """One warm-up frame, then ``n_frames`` timed ones; returns (state,
        frames a second, the last RGB8 as numpy).  ``inputs_fn(i)`` gives
        frame i's inputs (the one host job of the loop); ``present`` gets
        each timed frame as numpy (the loop's only read of the device, and
        only when given).  On the card the warm-up frame is eager, then the
        frame is captured (``capture``) and each timed frame is one
        ``replay``; the graph is released at the end.  On the CPU every
        frame is ``frame``."""
        sc = self.scene
        inputs = inputs_fn(0)
        state, rgb8, cam = self.frame(state, inputs, sc.frame_count,
                                      sc.prev_view_proj)
        prev_vp = cam.get_view_proj()
        cuda = sc.device.type == "cuda"
        if cuda:
            self.capture(state, inputs, prev_vp)
        self._sync()
        t0 = time.perf_counter()
        for i in range(1, n_frames + 1):
            if cuda:
                rgb8 = self.replay(inputs_fn(i), sc.frame_count + i)
            else:
                state, rgb8, cam = self.frame(state, inputs_fn(i),
                                              sc.frame_count + i, prev_vp)
                prev_vp = cam.get_view_proj()
            if present is not None:
                present(rgb8.cpu().numpy())
        self._sync()
        fps = n_frames / (time.perf_counter() - t0)
        img = rgb8.cpu().numpy()
        if cuda:
            state = self.release()
        sc.frame_count += n_frames + 1
        return state, fps, img
