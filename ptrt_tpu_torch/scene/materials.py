"""17-parameter PBR materials — counterpart of ``ptrt_tpu/scene/materials.py``.

Host side: the ``Material`` record with the reference's defaults and the
named presets the bench scene uses.  Device side: ``MaterialTable``, one
packed (M, 32) row per material, fetched per ray by id in one row gather
(``core/gather.row_gather``, field-major, so each field is a contiguous
plane) by the plain shading; the K3 kernels read the rows themselves.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ptrt_tpu_torch.core.gather import row_gather
from ptrt_tpu_torch.core.vec import Vec3

Color = Tuple[float, float, float]


def _lerp3(a: Color, b: Color, t: float) -> Color:
    return tuple(a[i] + (b[i] - a[i]) * t for i in range(3))


@dataclass
class Material:
    albedo: Color = (0.8, 0.8, 0.8)
    specular: Color = (0.04, 0.04, 0.04)
    metallic: float = 0.0
    roughness: float = 0.5
    emission: Color = (0.0, 0.0, 0.0)
    ior: float = 1.5
    transmission: float = 0.0
    transmission_roughness: float = 0.0
    clearcoat: float = 0.0
    clearcoat_roughness: float = 0.03
    subsurface_color: Color = (1.0, 1.0, 1.0)
    subsurface_radius: float = 0.0
    anisotropy: float = 0.0
    sheen: float = 0.0
    sheen_tint: Color = (0.5, 0.5, 0.5)
    iridescence: float = 0.0
    iridescence_thickness: float = 550.0
    name: str = ""

    @staticmethod
    def make(albedo: Color, roughness: float = 0.5, metallic: float = 0.0,
             **kw) -> "Material":
        """(albedo, rough, metal) with derived specular and
        transmission_roughness."""
        m = Material(albedo=tuple(albedo), roughness=roughness,
                     metallic=metallic, **kw)
        m.specular = _lerp3((0.04, 0.04, 0.04), m.albedo, metallic)
        m.transmission_roughness = max(m.transmission_roughness, roughness)
        return m

    def replace(self, **kw) -> "Material":
        return dataclasses.replace(self, **kw)


# packed row layout: [albedo(3) specular(3) emission(3) subsurface_color(3)
#                     sheen_tint(3) metallic roughness ior transmission
#                     transmission_roughness clearcoat clearcoat_roughness
#                     subsurface_radius anisotropy sheen iridescence
#                     iridescence_thickness pad(5)]
FIELDS_V3 = ("albedo", "specular", "emission", "subsurface_color", "sheen_tint")
FIELDS_F = (
    "metallic", "roughness", "ior", "transmission", "transmission_roughness",
    "clearcoat", "clearcoat_roughness", "subsurface_radius", "anisotropy",
    "sheen", "iridescence", "iridescence_thickness",
)
PACKED_WIDTH = 32


@dataclass(frozen=True)
class MaterialLanes:
    """Per-ray material properties."""

    albedo: Vec3
    specular: Vec3
    emission: Vec3
    subsurface_color: Vec3
    sheen_tint: Vec3
    metallic: torch.Tensor
    roughness: torch.Tensor
    ior: torch.Tensor
    transmission: torch.Tensor
    transmission_roughness: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_roughness: torch.Tensor
    subsurface_radius: torch.Tensor
    anisotropy: torch.Tensor
    sheen: torch.Tensor
    iridescence: torch.Tensor
    iridescence_thickness: torch.Tensor


@dataclass(frozen=True)
class MaterialTable:
    packed: torch.Tensor  # (M, 32) f32

    @staticmethod
    def from_materials(mats: list[Material], device) -> "MaterialTable":
        if not mats:
            mats = [Material()]
        cols = [np.array([getattr(m, name) for m in mats], np.float32)
                for name in FIELDS_V3]
        cols += [np.array([getattr(m, name) for m in mats],
                          np.float32)[:, None] for name in FIELDS_F]
        packed = np.concatenate(cols, axis=1)
        pad = np.zeros((packed.shape[0], PACKED_WIDTH - packed.shape[1]),
                       np.float32)
        packed = np.concatenate([packed, pad], axis=1)
        return MaterialTable(torch.from_numpy(packed).to(device))

    def gather(self, mat_id: torch.Tensor) -> MaterialLanes:
        """Per-ray material lanes by id, as one row gather."""
        shape = mat_id.shape
        planes = row_gather(self.packed, mat_id.reshape(-1), field_major=True)
        col = lambda i: planes[i].view(shape)
        c3 = lambda i: Vec3(col(i), col(i + 1), col(i + 2))
        c1 = {name: col(15 + k) for k, name in enumerate(FIELDS_F)}
        return MaterialLanes(
            **{name: c3(3 * k) for k, name in enumerate(FIELDS_V3)}, **c1)


class Materials:
    """The named presets ``app/bench_scene.py`` uses."""

    @staticmethod
    def Gold():
        return Material.make((1.0, 0.766, 0.336), 0.1, 1.0, name="Gold").replace(
            specular=(1.0, 0.782, 0.344))

    @staticmethod
    def Silver():
        return Material.make((0.972, 0.960, 0.915), 0.05, 1.0, name="Silver").replace(
            specular=(0.972, 0.960, 0.915))

    @staticmethod
    def Copper():
        return Material.make((0.955, 0.637, 0.538), 0.15, 1.0, name="Copper").replace(
            specular=(0.955, 0.637, 0.538))

    @staticmethod
    def Iron():
        return Material.make((0.560, 0.570, 0.580), 0.4, 1.0, name="Iron").replace(
            specular=(0.560, 0.570, 0.580))

    @staticmethod
    def Chrome():
        return Material.make((0.549, 0.556, 0.554), 0.02, 1.0, name="Chrome").replace(
            specular=(0.549, 0.556, 0.554))

    @staticmethod
    def Glass():
        m = Material.make((1.0, 1.0, 1.0), 0.02, 0.0, name="Glass")
        return m.replace(transmission=0.98, ior=1.5, specular=(0.04, 0.04, 0.04))

    @staticmethod
    def FrostedGlass():
        return Materials.Glass().replace(
            roughness=0.3, transmission_roughness=0.5, name="FrostedGlass")

    @staticmethod
    def PlasticRed():
        return Material.make((0.8, 0.1, 0.1), 0.2, 0.0, name="PlasticRed").replace(
            specular=(0.04, 0.04, 0.04))

    @staticmethod
    def PlasticBlue():
        return Material.make((0.1, 0.2, 0.8), 0.2, 0.0, name="PlasticBlue").replace(
            specular=(0.04, 0.04, 0.04))

    @staticmethod
    def PlasticGreen():
        return Material.make((0.1, 0.7, 0.2), 0.2, 0.0, name="PlasticGreen").replace(
            specular=(0.04, 0.04, 0.04))

    @staticmethod
    def RubberBlack():
        return Material.make((0.05, 0.05, 0.05), 0.8, 0.0, name="RubberBlack").replace(
            specular=(0.03, 0.03, 0.03))

    @staticmethod
    def CarPaint(base_color: Color):
        m = Material.make(tuple(base_color), 0.2, 0.3, name="CarPaint")
        return m.replace(clearcoat=1.0, clearcoat_roughness=0.03,
                         specular=(0.05, 0.05, 0.05))

    @staticmethod
    def Jade():
        m = Material.make((0.2, 0.6, 0.4), 0.1, 0.0, name="Jade")
        return m.replace(subsurface_color=(0.3, 0.8, 0.5), subsurface_radius=0.3,
                         specular=(0.05, 0.05, 0.05))

    @staticmethod
    def EmissiveLamp(color: Color, intensity: float = 5.0):
        m = Material.make((1.0, 1.0, 1.0), 0.0, 0.0, name="EmissiveLamp")
        return m.replace(emission=tuple(c * intensity for c in color))

    @staticmethod
    def MarbleCarrara(polished: bool = False):
        base_rough = 0.15 if polished else 0.35
        coat_amt = 0.70 if polished else 0.15
        coat_rough = 0.05 if polished else 0.20
        m = Material.make((0.93, 0.94, 0.96), base_rough, 0.0, name="MarbleCarrara")
        return m.replace(ior=1.49, clearcoat=coat_amt, clearcoat_roughness=coat_rough,
                         subsurface_color=(0.98, 0.98, 0.96), subsurface_radius=1.0)

    @staticmethod
    def WoodOak():
        return Material.make((0.6, 0.4, 0.2), 0.5, 0.0, name="WoodOak").replace(
            specular=(0.04, 0.04, 0.04))

    @staticmethod
    def Water():
        m = Material.make((0.8, 0.95, 1.0), 0.01, 0.0, name="Water")
        return m.replace(transmission=0.9, ior=1.33,
                         specular=(0.02, 0.02, 0.02))
