"""Carry the reference's scene state across into the port's tensors.

``from_reference`` takes the JAX package's device state as plain numpy —
each object as a mapping of its field names to arrays, a ``Vec3`` as an
``(x, y, z)`` triple — and returns the port's objects, byte for byte, on a
given device.  ``to_numpy`` turns a port object back into the same form,
so a conversion can be round-tripped.  Neither imports the JAX package:
the caller flattens the reference's objects.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.geometry.refit import RefitPlan
from ptrt_tpu_torch.geometry.scene_geom import (InstanceSet, SceneGeometry,
                                                WorldGeometry)
from ptrt_tpu_torch.geometry.tlas import build_tlas
from ptrt_tpu_torch.render.denoiser import ChannelHistory, DenoiserState
from ptrt_tpu_torch.render.sky import SkyConfig
from ptrt_tpu_torch.scene.camera import Camera
from ptrt_tpu_torch.scene.lights import LightTable
from ptrt_tpu_torch.scene.materials import MaterialTable


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy; keeps 0-d arrays 0-d
    if a.dtype == np.uint32:
        # PCG state: the port carries it as int64 in [0, 2^32)
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device)


def _build(cls, fields: dict, device):
    kw = {}
    for f in dataclasses.fields(cls):
        val = fields[f.name]
        if isinstance(val, tuple):  # a flattened Vec3
            kw[f.name] = Vec3(*[_tensor(c, device) for c in val])
        elif isinstance(val, ChannelHistory):  # already converted
            kw[f.name] = val
        elif isinstance(val, int):  # static metadata (stack_depth)
            kw[f.name] = val
        else:
            kw[f.name] = _tensor(val, device)
    return cls(**kw)


def _sky(fields: dict, device) -> SkyConfig:
    """A ``SkyConfig`` from the reference's fields: the gradient's, and for
    an HDRI the map, its rotation, the alias rows, the pdf and (SH, SW)."""
    v3 = lambda k: Vec3(*[_tensor(c, device) for c in fields[k]])
    kw = dict(top=v3("top"), bottom=v3("bottom"),
              use_sky=_tensor(fields["use_sky"], device))
    if fields.get("env") is not None:
        if fields.get("env_alias") is None:
            raise ValueError("an HDRI sky without sampling tables: the port "
                             "always samples the map (env NEE); build it "
                             "with SkyConfig.hdri(..., "
                             "importance_sampling=True)")
        kw.update(env=_tensor(fields["env"], device),
                  env_rotation=_tensor(np.float32(fields["env_rotation"]),
                                       device),
                  env_alias=_tensor(fields["env_alias"], device),
                  env_pdf=_tensor(fields["env_pdf"], device),
                  env_sample_hw=tuple(int(v) for v in
                                      fields["env_sample_hw"]))
    return SkyConfig(**kw)


def _geometry(fields: dict, device):
    """A ``SceneGeometry``, or a ``WorldGeometry`` from fields holding
    ``static`` and ``iset`` (the set's ``geom``, ``roots``, ``mats``,
    ``bb_min``, ``bb_max``; the instance tree is built here from the
    boxes; the per-instance tuple is not carried: the port's world starts
    with none)."""
    if "static" not in fields:
        return _build(SceneGeometry, fields, device)
    iset = fields.get("iset")
    if iset is not None:
        iset = InstanceSet(
            geom=_build(SceneGeometry, iset["geom"], device),
            tlas=_tensor(build_tlas(iset["bb_min"], iset["bb_max"]), device),
            **{k: _tensor(iset[k], device)
               for k in ("roots", "mats", "bb_min", "bb_max")})
    return WorldGeometry(static=_build(SceneGeometry, fields["static"],
                                       device), instances=(), iset=iset)


def _refit_plan(fields: dict) -> RefitPlan:
    """A ``RefitPlan`` (host arrays, as the reference keeps them)."""
    a = lambda k: np.array(fields[k], np.int32)
    return RefitPlan(slot_tri=a("slot_tri"), levels=tuple(
        np.array(x, np.int32) for x in fields["levels"]), cba=a("cba"),
        lb=a("lb"), lmask=a("lmask"), imask=a("imask"),
        **{k: int(fields[k]) for k in ("node_off", "blk_off", "slot_off")})


def _game_state(cls, fields: dict, device):
    """A game's state NamedTuple (``GameState``, ``FluidState``,
    ``EconomyState``, ``FusedTycoonState``) from its fields as arrays,
    each keeping its dtype (0-d stays 0-d)."""
    missing = set(cls._fields) - set(fields)
    if missing:
        raise ValueError(f"{cls.__name__}: fields {sorted(missing)} missing")
    return cls(**{k: _tensor(fields[k], device) for k in cls._fields})


def from_reference(*, device, geometry=None, materials=None, lights=None,
                   sky=None, camera=None, rng_state=None, blue_noise=None,
                   denoiser_state=None, refit_plan=None,
                   game_state=None) -> dict:
    """Convert the reference's state (flattened to numpy) to the port's.

    ``geometry``: ``SceneGeometry`` fields, or a ``WorldGeometry``'s
    (``static`` and ``iset`` as field dicts); ``refit_plan``: a
    ``RefitPlan``'s fields; ``materials`` / ``lights``: the tables' fields
    (only ``packed`` is used); ``sky``: a ``SkyConfig``'s fields (gradient
    or HDRI, with its sampling tables); ``camera``: ``Camera`` fields (the
    reference's aspect and clip planes are dropped: the port keeps them in
    the matrices); ``rng_state``: the (H, W) uint32 PCG state; ``blue_noise``:
    the (64, 64, 2) table; ``denoiser_state``: ``DenoiserState`` fields,
    its two ``ChannelHistory`` entries as field dicts of their own;
    ``game_state``: ``(cls, fields)``, one of the games' state NamedTuples
    and the reference state's fields as arrays.
    Returns a dict with the converted entries under the same names."""
    out = {}
    if geometry is not None:
        out["geometry"] = _geometry(geometry, device)
    if refit_plan is not None:
        out["refit_plan"] = _refit_plan(refit_plan)
    if materials is not None:
        out["materials"] = MaterialTable(_tensor(materials["packed"], device))
    if lights is not None:
        out["lights"] = LightTable(_tensor(lights["packed"], device))
    if sky is not None:
        out["sky"] = _sky(sky, device)
    if camera is not None:
        out["camera"] = _build(Camera, camera, device)
    if rng_state is not None:
        out["rng_state"] = _tensor(rng_state, device)
    if blue_noise is not None:
        out["blue_noise"] = _tensor(blue_noise, device)
    if game_state is not None:
        out["game_state"] = _game_state(*game_state, device)
    if denoiser_state is not None:
        fields = dict(denoiser_state)
        for ch in ("diffuse", "specular"):
            fields[ch] = _build(ChannelHistory, fields[ch], device)
        out["denoiser_state"] = _build(DenoiserState, fields, device)
    return out


def to_numpy(obj):
    """A port object back to numpy: dataclasses and game-state NamedTuples
    as field dicts, ``Vec3`` as an (x, y, z) triple of arrays, tensors as
    arrays (a ``RefitPlan`` without its device cache)."""
    if isinstance(obj, Vec3):
        return tuple(to_numpy(c) for c in (obj.x, obj.y, obj.z))
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj):
        return {f.name: to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj) if f.name != "_dev"}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # a game state
        return {k: to_numpy(getattr(obj, k)) for k in obj._fields}
    if isinstance(obj, tuple):
        return tuple(to_numpy(x) for x in obj)
    return obj
