"""PT demo-scene material factories — a copy of
``ptrt_tpu/app/materials_pt.py``.

The reference's PT app layer ships its own ``Materials`` struct with values
different from the unified library (``pathtracer/app_utils.cuh:60-191``);
demo scenes 0-10 use these.  Kept verbatim for golden-image parity.
"""

from __future__ import annotations

from ptrt_tpu_torch.scene.materials import Material, ior_to_f0


class PTMaterials:
    # METALS
    @staticmethod
    def Silver():
        return Material.make((0.97, 0.96, 0.91), 0.05, 1.0)

    @staticmethod
    def BrushedAluminum():
        return Material.make((0.91, 0.92, 0.92), 0.3, 1.0)

    @staticmethod
    def Gold():
        return Material.make((1.00, 0.78, 0.34), 0.1, 1.0)

    @staticmethod
    def Copper():
        return Material.make((0.95, 0.64, 0.54), 0.2, 1.0)

    @staticmethod
    def Titanium():
        return Material.make((0.542, 0.497, 0.449), 0.15, 1.0)

    # DIELECTRICS / GLASS
    @staticmethod
    def Glass():
        f0 = ior_to_f0(1.5)
        return Material.make((1.0, 1.0, 1.0), 0.0).replace(
            transmission=1.0, ior=1.5, specular=(f0, f0, f0))

    @staticmethod
    def FrostedGlass():
        return PTMaterials.Glass().replace(roughness=0.2)

    @staticmethod
    def Water():
        return PTMaterials.Glass().replace(ior=1.33)

    @staticmethod
    def Diamond():
        f0 = ior_to_f0(2.417)
        return PTMaterials.Glass().replace(ior=2.417, specular=(f0, f0, f0))

    # IRIDESCENCE & THIN FILMS
    @staticmethod
    def SoapBubble():
        return Material.make((1.0, 1.0, 1.0), 0.0).replace(
            transmission=0.95, ior=1.01, iridescence=1.0,
            iridescence_thickness=400.0)

    @staticmethod
    def OilSlick():
        return Material.make((0.1, 0.1, 0.1), 0.4, 0.8).replace(
            iridescence=1.0, iridescence_thickness=600.0)

    # FABRICS (SHEEN)
    @staticmethod
    def VelvetRed():
        return Material.make((0.4, 0.01, 0.05), 0.8).replace(
            sheen=1.0, sheen_tint=(1.0, 0.5, 0.5))

    @staticmethod
    def SatinBlue():
        return Material.make((0.1, 0.1, 0.6), 0.3).replace(
            sheen=0.8, anisotropy=0.6)

    # CLEARCOAT
    @staticmethod
    def CarPaintMidnight():
        return Material.make((0.02, 0.02, 0.15), 0.5).replace(
            metallic=0.4, clearcoat=1.0, clearcoat_roughness=0.01)

    @staticmethod
    def LacqueredWood():
        return Material.make((0.2, 0.1, 0.02), 0.6).replace(
            clearcoat=1.0, clearcoat_roughness=0.05)

    # PLASTICS / RUBBERS
    @staticmethod
    def PlasticRed():
        return Material.make((0.8, 0.1, 0.1), 0.3)

    @staticmethod
    def RubberBlack():
        return Material.make((0.05, 0.05, 0.05), 0.8)

    # SUBSURFACE
    @staticmethod
    def Wax():
        return Material.make((0.9, 0.8, 0.5), 0.3).replace(transmission=0.2)

    @staticmethod
    def Jade():
        return Material.make((0.1, 0.6, 0.3), 0.4).replace(
            subsurface_radius=1.0, subsurface_color=(0.1, 0.8, 0.4))

    # CUSTOM / ARTISTIC
    @staticmethod
    def PearlescentPaint(color):
        return Material.make(tuple(color), 0.4, 0.8).replace(iridescence=0.5)

    @staticmethod
    def GlowingNeon(color):
        return Material.make((0.0, 0.0, 0.0)).replace(
            emission=tuple(c * 10.0 for c in color))

    # MARBLES
    @staticmethod
    def MarbleCarrara():
        return Material.make((0.95, 0.95, 0.95), 0.1, 0.5)

    @staticmethod
    def MarbleVerde():
        return Material.make((0.1, 0.4, 0.2), 0.1, 0.6)

    @staticmethod
    def MarbleNero():
        return Material.make((0.05, 0.05, 0.05), 0.1, 0.7)
