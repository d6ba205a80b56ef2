"""17-parameter PBR materials — counterpart of ``ptrt_tpu/scene/materials.py``.

Host side: the ``Material`` record with the reference's defaults and the
reference's named presets.  Device side: ``MaterialTable``, one
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

    SIMPLE_MATERIAL_THRESHOLD = 0.01

    def is_simple(self) -> torch.Tensor:
        """No transmission, coat, iridescence or metal (each below 0.01)."""
        t = self.SIMPLE_MATERIAL_THRESHOLD
        return ((self.transmission < t) & (self.clearcoat < t)
                & (self.iridescence < t) & (self.metallic < t))

    def is_emissive(self) -> torch.Tensor:
        e = self.emission
        return (e.x > 0.0) | (e.y > 0.0) | (e.z > 0.0)

    def emission_luminance(self) -> torch.Tensor:
        return self.emission.luminance()


@dataclass(frozen=True)
class MaterialTable:
    packed: torch.Tensor  # (M, 32) f32

    @property
    def count(self) -> int:
        return int(self.packed.shape[0])

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


def phong_shininess_to_roughness(n: float) -> float:
    """``material_lib.cuh:132-135``."""
    alpha = float(np.sqrt(2.0 / (max(n, 1.0) + 2.0)))
    return float(np.clip(max(alpha, 0.02), 0.0, 1.0))


def ior_to_f0(ior: float) -> float:
    """``material_lib.cuh:142-145``."""
    a = (ior - 1.0) / (ior + 1.0)
    return a * a


class Materials:
    """The reference's named material presets (``ptrt_tpu/scene/materials.py``
    ``Materials``), copied: the bench scene's and the RT demo scenes'."""

    @staticmethod
    def Gold():
        return Material.make((1.0, 0.766, 0.336), 0.1, 1.0, name="Gold").replace(
            specular=(1.0, 0.782, 0.344))

    @staticmethod
    def PlainClay():
        return Material.make((0.5, 0.5, 0.5), 1.0, 0.0, name="PlainClay")

    @staticmethod
    def Silver():
        return Material.make((0.972, 0.960, 0.915), 0.05, 1.0, name="Silver").replace(
            specular=(0.972, 0.960, 0.915))

    @staticmethod
    def Copper():
        return Material.make((0.955, 0.637, 0.538), 0.15, 1.0, name="Copper").replace(
            specular=(0.955, 0.637, 0.538))

    @staticmethod
    def BrushedAluminum():
        m = Material.make((0.913, 0.921, 0.925), 0.3, 1.0, name="BrushedAluminum")
        return m.replace(anisotropy=0.8)

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
    def Diamond():
        m = Material.make((1.0, 1.0, 1.0), 0.0, 0.0, name="Diamond")
        return m.replace(transmission=0.95, ior=2.42, specular=(0.17, 0.17, 0.17))

    @staticmethod
    def Water():
        m = Material.make((0.8, 0.95, 1.0), 0.01, 0.0, name="Water")
        return m.replace(transmission=0.9, ior=1.33, specular=(0.02, 0.02, 0.02))

    @staticmethod
    def Ice():
        m = Material.make((0.9, 0.95, 1.0), 0.1, 0.0, name="Ice")
        return m.replace(transmission=0.7, ior=1.31,
                         subsurface_color=(0.8, 0.9, 1.0), subsurface_radius=0.3)

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
    def PearlescentPaint(base_color: Color):
        return Materials.CarPaint(base_color).replace(
            iridescence=0.8, iridescence_thickness=400.0, name="PearlescentPaint")

    @staticmethod
    def Skin():
        m = Material.make((0.95, 0.75, 0.67), 0.4, 0.0, name="Skin")
        return m.replace(subsurface_color=(1.0, 0.4, 0.3), subsurface_radius=0.5,
                         specular=(0.028, 0.028, 0.028))

    @staticmethod
    def Wax():
        m = Material.make((0.95, 0.93, 0.88), 0.3, 0.0, name="Wax")
        return m.replace(subsurface_color=(1.0, 0.9, 0.7), subsurface_radius=0.8,
                         specular=(0.03, 0.03, 0.03))

    @staticmethod
    def Jade():
        m = Material.make((0.2, 0.6, 0.4), 0.1, 0.0, name="Jade")
        return m.replace(subsurface_color=(0.3, 0.8, 0.5), subsurface_radius=0.3,
                         specular=(0.05, 0.05, 0.05))

    @staticmethod
    def Velvet(color: Color):
        m = Material.make(tuple(color), 0.8, 0.0, name="Velvet")
        return m.replace(sheen=1.0, sheen_tint=tuple(c * 1.2 for c in color),
                         specular=(0.02, 0.02, 0.02))

    @staticmethod
    def Silk(color: Color):
        m = Material.make(tuple(color), 0.2, 0.0, name="Silk")
        return m.replace(sheen=0.6, sheen_tint=(1.0, 1.0, 1.0), anisotropy=0.5,
                         specular=(0.04, 0.04, 0.04))

    @staticmethod
    def Cotton(color: Color):
        return Material.make(tuple(color), 0.9, 0.0, name="Cotton").replace(
            specular=(0.02, 0.02, 0.02))

    @staticmethod
    def SoapBubble():
        m = Material.make((1.0, 1.0, 1.0), 0.0, 0.0, name="SoapBubble")
        return m.replace(transmission=0.95, ior=1.33, iridescence=1.0,
                         iridescence_thickness=380.0, specular=(0.04, 0.04, 0.04))

    @staticmethod
    def OilSlick():
        m = Material.make((0.01, 0.01, 0.01), 0.0, 0.95, name="OilSlick")
        return m.replace(iridescence=1.0, iridescence_thickness=450.0)

    @staticmethod
    def EmissiveLamp(color: Color, intensity: float = 5.0):
        m = Material.make((1.0, 1.0, 1.0), 0.0, 0.0, name="EmissiveLamp")
        return m.replace(emission=tuple(c * intensity for c in color))

    @staticmethod
    def NeonLight(color: Color):
        m = Material.make(tuple(c * 0.1 for c in color), 0.0, 0.0, name="NeonLight")
        return m.replace(emission=tuple(c * 1.5 for c in color))

    @staticmethod
    def MarbleCarrara(polished: bool = False):
        base_rough = 0.15 if polished else 0.35
        coat_amt = 0.70 if polished else 0.15
        coat_rough = 0.05 if polished else 0.20
        m = Material.make((0.93, 0.94, 0.96), base_rough, 0.0, name="MarbleCarrara")
        return m.replace(ior=1.49, clearcoat=coat_amt, clearcoat_roughness=coat_rough,
                         subsurface_color=(0.98, 0.98, 0.96), subsurface_radius=1.0)

    @staticmethod
    def MarbleNero(polished: bool = True):
        base_rough = 0.12 if polished else 0.28
        coat_amt = 0.85 if polished else 0.20
        coat_rough = 0.04 if polished else 0.18
        m = Material.make((0.04, 0.045, 0.05), base_rough, 0.0, name="MarbleNero")
        return m.replace(ior=1.49, clearcoat=coat_amt, clearcoat_roughness=coat_rough,
                         subsurface_color=(0.15, 0.15, 0.16), subsurface_radius=0.6)

    @staticmethod
    def MarbleVerde(polished: bool = True):
        base_rough = 0.14 if polished else 0.30
        coat_amt = 0.75 if polished else 0.18
        coat_rough = 0.05 if polished else 0.19
        m = Material.make((0.10, 0.18, 0.14), base_rough, 0.0, name="MarbleVerde")
        return m.replace(ior=1.49, clearcoat=coat_amt, clearcoat_roughness=coat_rough,
                         subsurface_color=(0.12, 0.20, 0.16), subsurface_radius=0.8)

    @staticmethod
    def Concrete():
        return Material.make((0.5, 0.5, 0.5), 0.9, 0.0, name="Concrete").replace(
            specular=(0.02, 0.02, 0.02))

    @staticmethod
    def WoodOak():
        return Material.make((0.6, 0.4, 0.2), 0.5, 0.0, name="WoodOak").replace(
            specular=(0.04, 0.04, 0.04))

    @staticmethod
    def WoodCherry():
        m = Material.make((0.5, 0.2, 0.1), 0.4, 0.0, name="WoodCherry")
        return m.replace(clearcoat=0.3, clearcoat_roughness=0.1)

    @staticmethod
    def WoodWalnut():
        return Material.make((0.3, 0.2, 0.15), 0.45, 0.0, name="WoodWalnut").replace(
            specular=(0.04, 0.04, 0.04))
