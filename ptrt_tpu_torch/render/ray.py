"""Ray batch — counterpart of ``ptrt_tpu/render/ray.py``: origins,
directions and the per-ray ``spec`` flag for a whole wavefront."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ptrt_tpu_torch.core.vec import Vec3


@dataclass(frozen=True)
class RayBatch:
    origin: Vec3
    direction: Vec3
    spec: torch.Tensor  # bool per lane
