"""Light records and the packed device light table — counterpart of
``ptrt_tpu/scene/lights.py``: point, directional, spot and rect area lights
(sampled by ``render/nee.py`` and ``csrc/shade.cu``)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from enum import IntEnum
from typing import Tuple

import numpy as np
import torch

Color = Tuple[float, float, float]


class LightType(IntEnum):
    POINT = 0
    DIRECTIONAL = 1
    SPOT = 2
    AREA = 3


@dataclass
class Light:
    type: LightType = LightType.POINT
    position: Color = (0.0, 10.0, 0.0)
    direction: Color = (0.0, -1.0, 0.0)
    color: Color = (1.0, 1.0, 1.0)
    intensity: float = 1.0
    range: float = 100.0
    inner_cone: float = 0.5
    outer_cone: float = 0.7
    radius: float = 0.0  # > 0: soft shadows via cone sampling
    width: float = 0.0
    height: float = 0.0

    @staticmethod
    def point(position, color=(1.0, 1.0, 1.0), intensity=1.0, range=100.0,
              radius=0.0) -> "Light":
        return Light(LightType.POINT, tuple(position), (0, -1, 0),
                     tuple(color), intensity, range, radius=radius)

    @staticmethod
    def directional(direction, color=(1.0, 1.0, 1.0),
                    intensity=1.0) -> "Light":
        """Light arriving along ``direction`` (normalised)."""
        d = np.asarray(direction, np.float64)
        d = d / max(np.linalg.norm(d), 1e-12)
        return Light(LightType.DIRECTIONAL, (0, 0, 0), tuple(d), tuple(color),
                     intensity)

    @staticmethod
    def area(position, direction, width=1.0, height=1.0,
             color=(1.0, 1.0, 1.0), intensity=1.0, range=100.0) -> "Light":
        """A rect of ``width`` x ``height`` centred at ``position``,
        emitting along ``direction`` (single-sided).  Its U/V axes are the
        orthonormal basis the sampler derives from ``direction``
        (``core/rng.ortho_normal_basis``); the radius is set to
        ``0.5 * sqrt(width * height)`` as the reference sets it (the area
        branch of the sampler replaces the cone sample it drives)."""
        d = np.asarray(direction, np.float64)
        d = d / max(np.linalg.norm(d), 1e-12)
        lt = Light.point(position, color, intensity, range,
                         radius=0.5 * float(np.sqrt(width * height)))
        return dataclasses.replace(lt, type=LightType.AREA,
                                   direction=tuple(d),
                                   width=float(width), height=float(height))

    @staticmethod
    def spot(position, direction, color=(1.0, 1.0, 1.0), intensity=1.0,
             range=100.0, inner_cone=0.5, outer_cone=0.7,
             radius=0.0) -> "Light":
        """Cone angles in RADIANS, stored as cosines."""
        d = np.asarray(direction, np.float64)
        d = d / max(np.linalg.norm(d), 1e-12)
        return Light(LightType.SPOT, tuple(position), tuple(d), tuple(color),
                     intensity, range, inner_cone=float(np.cos(inner_cone)),
                     outer_cone=float(np.cos(outer_cone)), radius=radius)


@dataclass(frozen=True)
class LightTable:
    # (L, 16): [type pos(3) dir(3) color(3) intensity range inner outer
    #           radius width height pad] — one row gather per NEE sample
    packed: torch.Tensor

    @property
    def count(self) -> int:
        """Rows, the dummy row of an empty scene included."""
        return int(self.packed.shape[0])

    @staticmethod
    def from_lights(lights: list[Light], device) -> "LightTable":
        if not lights:
            # one dummy row so shapes stay static; the count is separate
            lights = [Light(intensity=0.0, color=(0, 0, 0))]
        arr3 = lambda name: np.array([getattr(l, name) for l in lights],
                                     np.float32)
        arr1 = lambda name: arr3(name)[:, None]
        types = np.array([int(l.type) for l in lights], np.int32)
        packed = np.concatenate(
            [types.astype(np.float32)[:, None], arr3("position"),
             arr3("direction"), arr3("color"), arr1("intensity"),
             arr1("range"), arr1("inner_cone"), arr1("outer_cone"),
             arr1("radius"), arr1("width"), arr1("height"),
             np.zeros((len(lights), 1), np.float32)], axis=1)
        return LightTable(torch.from_numpy(packed).to(device))
