"""RT backend demo scenes — a copy of ``ptrt_tpu/app/rt_demo_scenes.py``:
the five named creators and ``build_scene_by_id`` (the OBJ showcase scenes
selected by id, with procedural stand-ins where the models are absent from
``MODELS_DIR``).  Every creator takes the scene's device (the card by
default; ``device="cpu"`` for the plain versions).
"""

from __future__ import annotations

import math
import os

import numpy as np

from ptrt_tpu_torch.geometry.mesh import Mesh
from ptrt_tpu_torch.scene.materials import Material, Materials
from ptrt_tpu_torch.scene.rt_scene import RTScene

# the OBJ models of the showcase scenes: <repo>/models unless PTRT_MODELS_DIR
MODELS_DIR = os.environ.get(
    "PTRT_MODELS_DIR", os.path.join(os.path.dirname(__file__), "..", "..",
                                    "models"))

TWO_PI = 2.0 * math.pi
PI_OVER_TWO = math.pi / 2.0


def _scaled_cube(scene: RTScene, mat: Material, scale, pos,
                 rot=None) -> Mesh:
    cube = scene.add_cube(mat)
    if isinstance(scale, (int, float)):
        scale = (scale, scale, scale)
    cube.vertices = (cube.vertices * np.asarray(scale, np.float32)).astype(
        np.float32)
    cube.move_to(*pos)
    if rot is not None:
        cube.rotate_self_euler_xyz(*rot)
    return cube


def _load_model(scene: RTScene, rel_path: str, material: Material) -> Mesh:
    path = os.path.join(MODELS_DIR, os.path.basename(rel_path))
    if os.path.exists(path):
        return scene.add_mesh(path, material)
    stand_in = Mesh.sphere(32)
    stand_in.scale_verts(100.0)
    return scene.add_mesh(stand_in, material)


def create_cornell_box(width=800, height=800, device="cuda") -> RTScene:
    """``DemoScenes::createCornellBox`` (``RTapp_utils.cuh:251-313``)."""
    sc = RTScene(width, height, device)
    white = Material.make((0.73, 0.73, 0.73), 0.6).replace(
        specular=(0.04, 0.04, 0.04))
    red = Material.make((0.65, 0.05, 0.05), 0.6).replace(
        specular=(0.04, 0.04, 0.04))
    green = Material.make((0.12, 0.45, 0.15), 0.6).replace(
        specular=(0.04, 0.04, 0.04))
    light_mat = Material.make((0.0, 0.0, 0.0), 0.0).replace(
        emission=(15.0, 15.0, 15.0))
    box_mat = Material.make((0.9, 0.9, 0.9), 0.2).replace(
        specular=(0.04, 0.04, 0.04))

    _scaled_cube(sc, white, (10, 10, 0.1), (0, 0, -10))
    _scaled_cube(sc, red, (0.1, 10, 10), (-5, 0, -5))
    _scaled_cube(sc, green, (0.1, 10, 10), (5, 0, -5))
    _scaled_cube(sc, white, (10, 0.1, 10), (0, -5, -5))
    _scaled_cube(sc, white, (10, 0.1, 10), (0, 5, -5))
    _scaled_cube(sc, light_mat, (2, 0.1, 2), (0, 4.9, -5))
    _scaled_cube(sc, box_mat, (1.5, 3.0, 1.5), (-1.5, -3.5, -6), (0, 0.3, 0))
    _scaled_cube(sc, box_mat, (1.5, 1.5, 1.5), (1.5, -4.25, -4), (0, -0.4, 0))

    sc.add_point_light((0, 4.5, -5), (1.0, 0.9, 0.8), 3.0, 20.0)
    sc.set_ambient_light((0.02, 0.02, 0.02))
    sc.set_camera((0, 0, 5), (0, 0, -5), (0, 1, 0), 40.0)
    sc.use_sky = False
    return sc


def create_material_showcase1(width=1200, height=800, device="cuda") -> RTScene:
    """``createMaterialShowcase1`` (``RTapp_utils.cuh:315-351``):
    metallic x roughness grid."""
    sc = RTScene(width, height, device)
    rows, cols, spacing = 3, 5, 2.5
    for i in range(rows):
        for j in range(cols):
            metallic = j / (cols - 1)
            roughness = i / (rows - 1)
            mat = Material.make((0.8, 0.3, 0.2), roughness, metallic).replace(
                specular=(0.04, 0.04, 0.04))
            x = (j - cols / 2.0) * spacing
            y = (i - rows / 2.0) * spacing
            _scaled_cube(sc, mat, 0.8, (x, y, -10))
    sc.add_point_light((10, 10, 0), (1.0, 0.95, 0.9), 3.0, 50.0)
    sc.add_point_light((-10, 5, 5), (0.4, 0.4, 0.5), 2.0, 40.0)
    sc.add_point_light((0, 15, -15), (0.8, 0.8, 1.0), 1.5, 40.0)
    sc.set_ambient_light((0.03, 0.03, 0.03))
    sc.set_camera((0, 0, 5), (0, 0, -10), (0, 1, 0), 45.0)
    sc.add_plane_xz(-10.0, 50.0, Material.make((0.8, 0.8, 0.8), 0.4).replace(
        specular=(0.04, 0.04, 0.04)))
    return sc


def create_light_show(width=1024, height=768, device="cuda") -> RTScene:
    """``createLightShow`` (``RTapp_utils.cuh:353-399``)."""
    sc = RTScene(width, height, device)
    _scaled_cube(sc, Materials.Water(), 2.0, (0, 0, -10))
    n, radius = 12, 6.0
    for i in range(n):
        angle = TWO_PI * i / n
        hue = i / n
        color = (0.5 + 0.5 * math.cos(TWO_PI * hue),
                 0.5 + 0.5 * math.cos(TWO_PI * hue + TWO_PI / 3),
                 0.5 + 0.5 * math.cos(TWO_PI * hue + 2 * TWO_PI / 3))
        mat = Material.make(color, 0.25, 0.8 if i % 2 else 0.2).replace(
            specular=(0.04, 0.04, 0.04))
        _scaled_cube(sc, mat, 0.7,
                     (radius * math.cos(angle), 2.0 * math.sin(angle * 2),
                      -10 + radius * math.sin(angle)),
                     (angle, angle * 0.5, 0))
    sc.add_point_light((5, 3, -5), (1.0, 0.2, 0.2), 3.0, 30.0)
    sc.add_point_light((-5, 3, -5), (0.2, 1.0, 0.2), 3.0, 30.0)
    sc.add_point_light((0, -3, -5), (0.2, 0.2, 1.0), 3.0, 30.0)
    sc.add_point_light((0, 8, -10), (1.0, 1.0, 1.0), 2.0, 40.0)
    sc.add_spot_light((0, 10, 0), (0, -1, -0.5), (1.0, 0.9, 0.7), 4.0, 0.2,
                      0.4, 30.0)
    sc.set_ambient_light((0.01, 0.01, 0.01))
    sc.set_camera((8, 5, 8), (0, 0, -10), (0, 1, 0), 50.0)
    sc.add_plane_xz(-5.0, 50.0, Material.make((0.8, 0.8, 0.8), 0.4).replace(
        specular=(0.04, 0.04, 0.04)))
    return sc


def create_architectural(width=1280, height=720, device="cuda") -> RTScene:
    """``createArchitectural`` (``RTapp_utils.cuh:401-449``)."""
    sc = RTScene(width, height, device)
    concrete = Material.make((0.7, 0.7, 0.65), 0.6).replace(
        specular=(0.04, 0.04, 0.04))
    glass = Material.make((0.98, 0.98, 0.98), 0.02).replace(
        specular=(0.04, 0.04, 0.04), transmission=0.98, ior=1.5)
    wood = Material.make((0.55, 0.35, 0.2), 0.45).replace(
        specular=(0.04, 0.04, 0.04))
    for i in range(5):
        _scaled_cube(sc, concrete, (0.5, 8.0, 0.5), (-8.0 + i * 4.0, 0, -15))
    for i in range(4):
        _scaled_cube(sc, glass, (3.8, 6.0, 0.1), (-6.0 + i * 4.0, 0, -14.5))
    _scaled_cube(sc, wood, (20, 0.2, 20), (0, -4, -15))
    _scaled_cube(sc, concrete, (20, 0.5, 20), (0, 4, -15))
    sc.add_directional_light((-0.3, -0.6, -0.5), (1.0, 0.95, 0.8), 1.5)
    for i in range(3):
        sc.add_point_light((-4.0 + i * 4.0, 3, -12.0), (1.0, 0.9, 0.7), 0.8,
                           15.0)
    sc.set_ambient_light((0.15, 0.15, 0.2))
    sc.set_camera((10, 2, 0), (0, 0, -15), (0, 1, 0), 60.0)
    sc.add_plane_xz(-10.0, 50.0, Material.make((0.8, 0.8, 0.8), 0.4).replace(
        specular=(0.04, 0.04, 0.04)))
    return sc


def create_material_showcase(width=1024, height=768, device="cuda") -> RTScene:
    """``createMaterialShowcase`` (``RTapp_utils.cuh:451-550``): 20 named
    materials on a 5-wide grid."""
    sc = RTScene(width, height, device)
    spacing = 2.5
    start_x = -(5 - 1) * spacing / 2.0
    start_z = -10.0
    grid = [
        Materials.Gold(), Materials.Silver(), Materials.Copper(),
        Materials.BrushedAluminum(), Materials.OilSlick(),
        Materials.Glass(), Materials.FrostedGlass(), Materials.Diamond(),
        Materials.SoapBubble(), Materials.Water(),
        Materials.CarPaint((0.8, 0.1, 0.1)),
        Materials.PearlescentPaint((0.9, 0.9, 1.0)), Materials.Skin(),
        Materials.Jade(), Materials.Wax(),
        Materials.Velvet((0.5, 0.1, 0.6)), Materials.Silk((0.1, 0.3, 0.8)),
        Materials.PlasticRed(), Materials.RubberBlack(),
        Materials.NeonLight((0.3, 0.8, 1.0)),
    ]
    for idx, mat in enumerate(grid):
        r, c = divmod(idx, 5)
        _scaled_cube(sc, mat, 0.8,
                     (start_x + c * spacing, 0, start_z - r * spacing))
    sc.add_point_light((0, 8, -8), (1, 1, 1), 3.0, 50.0)
    sc.add_point_light((-8, 4, -4), (1.0, 0.9, 0.8), 2.0, 30.0)
    sc.add_point_light((8, 4, -12), (0.8, 0.9, 1.0), 2.0, 30.0)
    sc.set_ambient_light((0.03, 0.03, 0.03))
    floor = Material.make((0.9, 0.9, 0.9), 0.05).replace(
        specular=(0.04, 0.04, 0.04), clearcoat=0.5, clearcoat_roughness=0.1)
    sc.add_plane_xz(-1.5, 50.0, floor)
    sc.set_camera((0, 6, 5), (0, -0.5, -10), (0, 1, 0), 45.0)
    sc.set_sky_gradient((0.05, 0.05, 0.08), (0.02, 0.02, 0.03))
    return sc


def _base_showcase_scene(width, height, device) -> RTScene:
    """``createBaseShowcaseScene`` (``RTapp_utils.cuh:556-571``)."""
    sc = RTScene(width, height, device)
    sc.set_camera((0, 2.0, 6.0), (0, 1.0, 0), (0, 1, 0), 60.0)
    sc.add_spot_light((0, 6, 6), (0, -1, -1), (1, 1, 1), 8.0, 0.4, 0.8, 50.0)
    sc.set_ambient_light((0.08, 0.08, 0.08))
    sc.add_plane_xz(-0.05, 50.0,
                    Material.make((0.8, 0.8, 0.8)).replace(
                        specular=(0.1, 0.1, 0.1)))
    return sc


def build_scene_by_id(scene_id: int, width: int, height: int,
                      device="cuda"):
    """``buildSceneById`` (``RTapp_utils.cuh:573-738``).  OBJ showcase
    scenes 1-7 with graceful stand-ins; named demo creators for 0 and
    out-of-range ids fall back to scene 1."""
    if scene_id == 0:
        return create_cornell_box(width, height, device), "Cornell Box"
    if scene_id == 4:
        return create_material_showcase1(width, height, device), "Material Grid"
    if scene_id == 5:
        return create_light_show(width, height, device), "Light Show"
    if scene_id == 6:
        return create_architectural(width, height, device), "Architectural"
    if scene_id == 7:
        return create_material_showcase(width, height, device), "Material Showcase"

    if scene_id == 2:
        sc = _base_showcase_scene(width, height, device)
        m1 = _load_model(sc, "abraham-lincoln-mills-life-mask-150k.obj",
                         Materials.MarbleNero())
        m1.scale_verts(0.01).move_to(-1.2, 0.0, 0.0)
        m2 = _load_model(sc, "andrew-jackson-zinc-sculpture-150k.obj",
                         Materials.MarbleNero())
        m2.scale_verts(0.01).move_to(1.2, 0.0, 0.0)
        return sc, "Presidents Showcase"
    if scene_id == 3:
        sc = _base_showcase_scene(width, height, device)
        m1 = _load_model(sc, "cosmic-buddha-laser-scan-150k.obj",
                         Materials.Gold())
        m1.scale_verts(0.001).move_to(-1.2, 0.0, 0.0) \
            .rotate_self_euler_xyz(-PI_OVER_TWO, 0, 0)
        m2 = _load_model(
            sc, "george-washington-greenough-statue-(1840)-150k.obj",
            Materials.MarbleNero())
        m2.scale_verts(0.001).move_to(1.2, 0.0, 0.0)
        return sc, "Statues Showcase"

    # default / 1: Character Showcase (RTapp_utils.cuh:585-618)
    sc = RTScene(width, height, device)
    g1 = _load_model(sc, "ugly.obj", Materials.Glass())
    g1.scale_verts(10.5 / 100.0).move_to(-3.0, 0.0, 0.0)
    g2 = _load_model(sc, "halfway.obj", Materials.MarbleNero())
    g2.scale_verts(10.5 / 100.0).move_to(0.0, 0.0, 0.0)
    g3 = _load_model(sc, "full.obj", Materials.MarbleVerde())
    g3.scale_verts(10.5 / 100.0).move_to(3.0, 0.0, 0.0)
    sc.add_spot_light((0, 4, 2), (0, -1, -0.5), (1, 1, 1), 5.0, 0.1, 0.3,
                      1.75)
    sc.add_point_light((0, 4.5, 2), (0.5, 0.5, 1.0), 1.0, 1.0)
    sc.add_spot_light((0, 5, -4), (0, -0.6, -1.0), (1, 1, 1), 6.0, 0.2, 0.8,
                      2.0)
    sc.set_ambient_light((0.08, 0.08, 0.08))
    sc.set_camera((0, 3, 0), (0, 3.5, 5), (0, 1, 0), 60.0)
    sc.add_plane_xz(-3.0, 50.0, Material.make((0.8, 0.8, 0.8)).replace(
        specular=(0.1, 0.1, 0.1)))
    return sc, "Character Showcase"
