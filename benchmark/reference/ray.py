"""Ray batch — counterpart of ``ptrt_tpu/render/ray.py``: origins,
directions and the per-ray ``spec`` flag for a whole wavefront."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from benchmark.reference.vec import Vec3


@dataclass(frozen=True)
class RayBatch:
    origin: Vec3
    direction: Vec3
    spec: torch.Tensor  # bool per lane

    def at(self, t) -> Vec3:
        return self.origin + self.direction * t

    @staticmethod
    def make(origin: Vec3, direction: Vec3, spec=None) -> "RayBatch":
        """A batch whose ``spec`` defaults to False on every lane (on the
        direction's device)."""
        if spec is None:
            shape = torch.broadcast_shapes(
                torch.as_tensor(direction.x).shape,
                torch.as_tensor(origin.x).shape)
            dev = next((c.device for c in (direction.x, origin.x)
                        if isinstance(c, torch.Tensor)), None)
            spec = torch.zeros(shape, dtype=torch.bool, device=dev)
        return RayBatch(origin, direction, spec)

    def replace(self, **kw) -> "RayBatch":
        return dataclasses.replace(self, **kw)
