"""Render-state checkpoint and resume — counterpart of
``ptrt_tpu/utils/checkpoint.py``, in its ``.npz`` layout and keys.

A PT ``Scene``'s progressive and temporal state goes into one ``.npz``:
``frame_count``, ``prev_view_proj``, ``rng_state`` (uint32, as the
reference keeps it), the denoiser history as ``den_0`` ... with
``den_count`` (its leaves in the reference's order: each channel's mean,
second moment and length, then the normal, depth, object ids and the
first-frame flag), and the progressive average as ``acc_0`` ... ``acc_3``
(the radiance sum's planes and the frame count as int32) with
``acc_count`` and ``acc_cam_sig`` (the view-projection it was taken
under).  Loading restores the tensors onto the scene's device, so the next
frame continues exactly where the saved session left off.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.render.denoiser import init_denoiser_state


def _leaves(obj) -> list:
    """A state's tensors in the reference's pytree order."""
    if isinstance(obj, Vec3):
        return [obj.x, obj.y, obj.z]
    if dataclasses.is_dataclass(obj):
        return [leaf for f in dataclasses.fields(obj)
                for leaf in _leaves(getattr(obj, f.name))]
    return [obj]


def _unflatten(template, leaves: list):
    """``template``'s structure filled with ``leaves`` in order."""
    if isinstance(template, Vec3):
        return Vec3(leaves.pop(0), leaves.pop(0), leaves.pop(0))
    if dataclasses.is_dataclass(template):
        return type(template)(**{
            f.name: _unflatten(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)})
    return leaves.pop(0)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _flatten_state(scene) -> dict:
    out = {"frame_count": np.asarray(scene.frame_count),
           "prev_view_proj": _np(scene.prev_view_proj)}
    if scene._rng_state is not None:
        out["rng_state"] = _np(scene._rng_state).astype(np.uint32)
    if scene._denoiser_state is not None:
        leaves = _leaves(scene._denoiser_state)
        for i, leaf in enumerate(leaves):
            out[f"den_{i}"] = _np(leaf)
        out["den_count"] = np.asarray(len(leaves))
    if scene._accum is not None:
        total, count = scene._accum
        leaves = [_np(c) for c in (total.x, total.y, total.z)]
        leaves.append(np.asarray(_np(count), np.int32))
        for i, leaf in enumerate(leaves):
            out[f"acc_{i}"] = leaf
        out["acc_count"] = np.asarray(len(leaves))
        if scene._accum_view_proj is not None:
            out["acc_cam_sig"] = _np(scene._accum_view_proj)
    return out


def save_render_state(scene, path: str) -> None:
    """Persist a PT Scene's progressive and temporal state."""
    np.savez_compressed(path, **_flatten_state(scene))


def load_render_state(scene, path: str) -> None:
    """Restore state saved by ``save_render_state`` into a scene of the same
    resolution and configuration, on the scene's device."""
    dev = scene.device
    data = np.load(path)
    to = lambda a: torch.from_numpy(np.array(a)).to(dev)
    scene.frame_count = int(data["frame_count"])
    scene.prev_view_proj = to(data["prev_view_proj"])
    if "rng_state" in data:
        scene._rng_state = to(data["rng_state"].astype(np.int64))
    if "den_count" in data:
        rh, rw = scene.render_size
        template = init_denoiser_state(rh, rw, "cpu")
        leaves = [to(data[f"den_{i}"]) for i in range(int(data["den_count"]))]
        scene._denoiser_state = _unflatten(template, leaves)
    if "acc_count" in data:
        x, y, z, count = (data[f"acc_{i}"]
                          for i in range(int(data["acc_count"])))
        scene._accum = (Vec3(to(x), to(y), to(z)),
                        to(np.asarray(count, np.float32)))
        if "acc_cam_sig" in data:
            scene._accum_view_proj = to(data["acc_cam_sig"])
