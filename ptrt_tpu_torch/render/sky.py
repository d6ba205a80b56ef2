"""Sky radiance for escaping rays — counterpart of ``ptrt_tpu/render/sky.py``
for the vertical gradient sky.  HDRI environments and their importance
sampling are not ported yet."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ptrt_tpu_torch.core.vec import Vec3, lerp


@dataclass(frozen=True)
class SkyConfig:
    top: Vec3  # components: 0-d float32 tensors
    bottom: Vec3
    use_sky: torch.Tensor  # 0-d float 0/1 multiplier

    @staticmethod
    def gradient(top=(0.5, 0.7, 1.0), bottom=(1.0, 1.0, 1.0),
                 use_sky: bool = True, *, device) -> "SkyConfig":
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return SkyConfig(top=Vec3(*[f32(c) for c in top]),
                         bottom=Vec3(*[f32(c) for c in bottom]),
                         use_sky=f32(1.0 if use_sky else 0.0))


def sample_sky(dir: Vec3, sky: SkyConfig) -> Vec3:
    """Radiance for rays escaping to the environment."""
    t = 0.5 * (dir.y + 1.0)
    return lerp(sky.bottom, sky.top, t) * sky.use_sky
