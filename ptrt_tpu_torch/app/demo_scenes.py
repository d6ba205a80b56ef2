"""PT demo scenes 0-10 — a copy of ``ptrt_tpu/app/demo_scenes.py``
(``buildSceneById``, ``app_utils.cuh:429-805``).  Every creator takes the
scene's device (the card by default; ``device="cpu"`` for the plain
versions).

The reference loads Smithsonian OBJ scans from a ``models/`` directory that
is not vendored in its repo.  Each scene here uses the same lights, camera,
materials and placement; when the OBJ file exists (drop reference models into
``models/`` at the repo root or set PTRT_MODELS_DIR) it is loaded, otherwise
a procedural stand-in (a high-res sphere of the same bounding size) keeps the
scene renderable so lighting/material behavior is still exercised.
"""

from __future__ import annotations

import os

import numpy as np

from ptrt_tpu_torch.app.materials_pt import PTMaterials as Materials
from ptrt_tpu_torch.geometry.mesh import Mesh
from ptrt_tpu_torch.scene.materials import Material
from ptrt_tpu_torch.scene.pt_scene import Scene

# the OBJ models of the showcase scenes: <repo>/models unless PTRT_MODELS_DIR
MODELS_DIR = os.environ.get(
    "PTRT_MODELS_DIR", os.path.join(os.path.dirname(__file__), "..", "..",
                                    "models"))


def _load_model(scene: Scene, rel_path: str, material: Material) -> Mesh:
    """addMesh with graceful stand-in when the OBJ isn't vendored."""
    path = os.path.join(MODELS_DIR, os.path.basename(rel_path))
    if os.path.exists(path):
        return scene.add_mesh(path, material)
    stand_in = Mesh.sphere(48)
    stand_in.scale_verts(100.0)  # statue-scale, like the 150k scans
    return scene.add_mesh(stand_in, material)


def create_lit_test_scene(w: int, h: int, device="cuda") -> Scene:
    """``Scenes::createLitTestScene`` (``app_utils.cuh:196-207``)."""
    scene = Scene(w, h, device=device)
    scene.add_plane_xz(-1.0, 50.0, Material.make((0.8, 0.8, 0.8), 0.5))
    cube = scene.add_cube(Materials.Silver())
    cube.move_to(0, 0.5, 3)
    scene.add_spot_light((-3, 5, 2), (1, -1, 1), (1, 1, 1), 5.0)
    scene.add_point_light((2, 3, 1), (0.8, 0.8, 1.0), 2.0)
    scene.set_camera((0, 1.5, -2), (0, 0.5, 3), (0, 1, 0), 60.0)
    return scene


def build_scene_by_id(scene_id: int, width: int, height: int,
                      device="cuda"):
    """Returns (Scene on ``device``, scene_name)."""
    floor_mat = Material.make((0.8, 0.8, 0.8), 0.7)
    lookfrom = (0, 0, 0)
    lookat = (0, 3.5, 5)
    focus = float(np.linalg.norm(np.subtract(lookat, lookfrom)))

    if scene_id == 0:
        return create_lit_test_scene(width, height, device), "Lit Test Scene"

    sc = Scene(width, height, device=device)

    if scene_id == 1:
        name = "Presidents"
        sc.set_sky_gradient((0.1, 0.1, 0.1), (0.0, 0.0, 0.0))
        lincoln = _load_model(sc, "abraham-lincoln-mills-life-mask-150k.obj",
                              Materials.Copper())
        lincoln.scale_verts(0.8 / 50.0).move_to(-2, 0, 4) \
            .rotate_self_euler_xyz(0, 0.5, 0)
        washington = _load_model(
            sc, "george-washington-greenough-statue-(1840)-150k.obj",
            Materials.MarbleCarrara())
        washington.scale_verts(0.6 / 500.0).move_to(2, -1, 4) \
            .rotate_self_euler_xyz(0, -0.5, 0)
        sc.add_spot_light((-3, 5, 2), (0.5, -1, 0.5), (1, 1, 1), 5.0, 0.1,
                          0.3, 1.75, 0.2)
        sc.add_point_light((3, 4, 2), (0.5, 0.5, 1.0), 1.0, 1.0, 0.2)
        sc.set_camera(lookfrom, lookat, (0, 1, 0), 60.0, 0.0001, focus)
        sc.add_plane_xz(-3.0, 50.0, floor_mat)
    elif scene_id == 2:
        name = "Statues"
        sc.set_sky_gradient((0.6, 0.7, 0.9), (0.9, 0.95, 1.0))
        jackson = _load_model(sc, "andrew-jackson-zinc-sculpture-150k.obj",
                              Materials.Jade())
        jackson.scale_verts(0.7 / 50.0).move_to(0, 0, 4.5) \
            .rotate_self_euler_xyz(0, 0.3, 0)
        sc.add_spot_light((0, 7, 5), (0, -1, 0), (1, 1, 1), 4.0, 0.1, 0.4,
                          2.0, 0.3)
        sc.add_point_light((0, 4, 0), (1.0, 0.7, 0.3), 0.5, 1.0, 0.1)
        sc.set_camera(lookfrom, lookat, (0, 1, 0), 60.0, 0.0001, focus)
        sc.add_plane_xz(-3.0, 50.0, floor_mat)
    elif scene_id == 3:
        name = "X3D Components"
        shell = _load_model(sc, "x3d-cm-exterior-shell-90k-uvs.obj",
                            Materials.FrostedGlass())
        shell.scale_verts(0.5 / 50.0).move_to(-2, 0, 4) \
            .rotate_self_euler_xyz(0, 0.3, 0)
        top = _load_model(sc, "x3d-cm-exterior-top-160k-uvs.obj",
                          Materials.Titanium())
        top.scale_verts(0.5 / 50.0).move_to(2, 0, 4) \
            .rotate_self_euler_xyz(0, 0.3, 0)
        sc.add_point_light((-4, 5, 2), (1, 1, 1), 2.0, 1.0, 0.5)
        sc.add_point_light((3, 4, 1), (0.5, 0.5, 0.5), 1.0, 1.0, 0.5)
        sc.add_point_light((0, 4, 8), (0.7, 0.7, 0.7), 1.5, 1.0, 0.5)
        sc.set_camera(lookfrom, lookat, (0, 1, 0), 60.0, 0.0001, focus)
        sc.add_plane_xz(-3.0, 50.0, floor_mat)
    elif scene_id == 4:
        name = "Abstract Pair"
        full = _load_model(sc, "full.obj", Materials.CarPaintMidnight())
        full.scale_verts(0.5 * 30.0 / 100.0).move_to(-2.5, 0, 4) \
            .rotate_self_euler_xyz(0, 0.5, 0)
        buddha = _load_model(sc, "cosmic-buddha-laser-scan-150k.obj",
                             Materials.RubberBlack())
        buddha.scale_verts(0.7 / 100.0).move_to(2, -1, 4) \
            .rotate_self_euler_xyz(0, -0.5, 0)
        sc.add_spot_light((0, 4, 2), (0, -1, -0.5), (1, 1, 1), 5.0, 0.1, 0.3,
                          1.75, 0.2)
        sc.add_point_light((0, 4.5, 2), (0.5, 0.5, 1.0), 1.0, 1.0, 0.2)
        sc.set_camera(lookfrom, lookat, (0, 1, 0), 60.0, 0.0001, focus)
        sc.add_plane_xz(-3.0, 50.0, floor_mat)
    elif scene_id == 5:
        name = "Vase"
        vase = _load_model(sc, "vase.obj", Materials.Wax())
        vase.scale_verts(0.7 / 100.0).move_to(0, 0, 4) \
            .rotate_self_euler_xyz(0, 0.3, 0)
        sc.add_point_light((-2, 4, 2), (0.8, 0.8, 0.8), 1.5, 1.0, 0.3)
        sc.add_spot_light((0, 4, 8), (0, -0.1, -1), (1, 1, 1), 6.0, 0.05, 0.2,
                          2.0, 0.3)
        sc.set_camera(lookfrom, lookat, (0, 1, 0), 60.0, 0.0001, focus)
        sc.add_plane_xz(-3.0, 50.0, floor_mat)
    elif scene_id == 6:
        name = "USNM Object"
        usnm = _load_model(sc, "usnm_346-01-100k.obj",
                           Materials.PearlescentPaint((0.8, 0.2, 0.5)))
        usnm.scale_verts(0.6 / 50.0).move_to(0, 0, 4) \
            .rotate_self_euler_xyz(0, 0.3, 0)
        sc.add_spot_light((0, 4, 2), (0, -1, -0.5), (1, 1, 1), 5.0, 0.1, 0.3,
                          1.75, 0.2)
        sc.add_point_light((0, 4.5, 2), (0.5, 0.5, 1.0), 1.0, 1.0, 0.2)
        sc.set_camera(lookfrom, lookat, (0, 1, 0), 60.0, 0.0001, focus)
        sc.add_plane_xz(-3.0, 50.0, floor_mat)
    elif scene_id == 7:
        name = "Custom Scene (lowteiradam)"
        guy = _load_model(sc, "subhumanchoppedahhdude.obj",
                          Materials.VelvetRed())
        guy.scale_verts(0.6 / 100.0).move_to(0, 0, 4) \
            .rotate_self_euler_xyz(0, 0.3, 0)
        sc.add_spot_light((0, 4, 2), (0, -1, -0.5), (1, 1, 1), 5.0, 0.1, 0.3,
                          1.75, 0.2)
        sc.add_point_light((0, 4.5, 2), (0.5, 0.5, 1.0), 1.0, 1.0, 0.2)
        sc.set_camera(lookfrom, lookat, (0, 1, 0), 60.0, 0.0001, focus)
        sc.add_plane_xz(-3.0, 50.0, floor_mat.replace(
            specular=(0.1, 0.1, 0.1)))
    elif scene_id == 8:
        name = "Ultimate Model Showcase"
        floor_y = 2.0 - 10.0 / 2.0
        rot = (0, 0.3, 0)
        back = [
            ("abraham-lincoln-mills-life-mask-150k.obj", Materials.Copper(),
             0.8 / 50.0, (-8, floor_y + 3.0, -12)),
            ("george-washington-greenough-statue-(1840)-150k.obj",
             Materials.MarbleCarrara(), 0.6 / 500.0, (-4, floor_y + 2.0, -12)),
            ("andrew-jackson-zinc-sculpture-150k.obj", Materials.Jade(),
             0.7 / 50.0, (0, floor_y + 3.0, -12)),
            ("x3d-cm-exterior-shell-90k-uvs.obj", Materials.SoapBubble(),
             0.5 / 50.0, (4, floor_y + 3.0, -12)),
            ("x3d-cm-exterior-top-160k-uvs.obj", Materials.Titanium(),
             0.5 / 50.0, (8, floor_y + 3.0, -12)),
            ("full.obj", Materials.CarPaintMidnight(), 0.5 * 30.0 / 100.0,
             (-8, floor_y + 3.0, -8)),
            ("cosmic-buddha-laser-scan-150k.obj", Materials.Gold(),
             0.7 / 100.0, (-4, floor_y + 2.0, -8)),
            ("vase.obj", Materials.Wax(), 0.7 / 100.0, (0, floor_y + 3.0, -8)),
            ("usnm_346-01-100k.obj", Materials.VelvetRed(), 0.6 / 50.0,
             (4, floor_y + 3.0, -8)),
            ("lowteiradamlookindude.obj", Materials.Glass(), 0.6 / 100.0,
             (8, floor_y + 3.0, -8)),
        ]
        for path, mat, scale, pos in back:
            m = _load_model(sc, path, mat)
            m.scale_verts(scale).move_to(*pos).rotate_self_euler_xyz(*rot)
        sc.set_sky_gradient((0.5, 0.5, 0.5), (0.5, 0.5, 0.5))
        for x, inten in [(0, 15.0), (-6, 12.0), (6, 12.0)]:
            sc.add_spot_light((x, 6.5, -10), (0, -1, 0), (1, 1, 1), inten,
                              0.1, 0.8, 2.0, 0.1)
        sc.add_point_light((0, 2, 4), (0.8, 0.8, 0.8), 5.0, 20.0, 0.1)
        sc.add_point_light((-8, 1, 4), (0.5, 0.5, 0.5), 3.0, 20.0, 0.1)
        sc.add_point_light((8, 1, 4), (0.5, 0.5, 0.5), 3.0, 20.0, 0.1)
        cam_pos, cam_at = (0, 2, 5), (0, 0, -10)
        sc.set_camera(cam_pos, cam_at, (0, 1, 0), 50.0, 0.0,
                      float(np.linalg.norm(np.subtract(cam_at, cam_pos))))
    elif scene_id == 9:
        name = "Custom Scene1 (Cornell Gems)"
        for path, mat, pos, ry in [
            ("ugly.obj", Materials.OilSlick(), (-2.5, -2, -10), 0.5),
            ("halfway.obj", Materials.SatinBlue(), (0, -2, -10), -0.2),
            ("full.obj", Materials.Diamond(), (2.5, -2, -10), -0.5),
        ]:
            gem = _load_model(sc, path, mat)
            gem.scale_verts(20.0 / 100.0).move_to(*pos) \
                .rotate_self_euler_xyz(0, ry, 0)
        wall_mat = Materials.Silver().replace(roughness=0.5)
        for scale, pos in [((6, 6, 0.1), (0, 2, -13)),
                           ((0.1, 6, 6), (-5, 2, -7)),
                           ((0.1, 6, 6), (5, 2, -7)),
                           ((6, 0.1, 6), (0, -2, -7)),
                           ((6, 0.1, 6), (0, 8, -7))]:
            wall = sc.add_cube(wall_mat)
            wall.vertices = (wall.vertices
                             * np.asarray(scale, np.float32)).astype(np.float32)
            wall.move_to(*pos)
        sc.add_point_light((3, 0, -10), (0.5, 0.5, 1.0), 1.0, 2.0, 0.3)
        sc.add_point_light((1, 1, -9), (0.5, 0.5, 1.0), 1.0, 1.75, 0.3)
        sc.add_point_light((4, 1, -9), (0.5, 0.5, 1.0), 1.0, 2.0, 0.3)
        sc.add_point_light((0, 7.5, -7), (1.0, 0.9, 0.8), 15.0, 10.0, 0.5)
        sc.set_camera((0, 0, 0), (0, 0, -10), (0, 1, 0), 60.0, 0.0001, 10.0)
        sc.set_sky_gradient((0.05, 0.05, 0.08), (0.02, 0.02, 0.03))
    elif scene_id == 10:
        name = "Material Matrix (Cubes)"
        sc.add_plane_xz(-1.0, 50.0, Material.make((0.2, 0.2, 0.2), 0.8))
        rows = cols = 4
        spacing = 2.0
        start_x = -((cols - 1) * spacing) / 2.0
        start_z = -((rows - 1) * spacing) / 2.0 - 5.0
        palette = [
            Materials.Silver(), Materials.Gold(), Materials.Copper(),
            Materials.Titanium(), Materials.CarPaintMidnight(),
            Materials.PlasticRed(), Materials.RubberBlack(),
            Materials.LacqueredWood(), Materials.Glass(),
            Materials.FrostedGlass(), Materials.SoapBubble(),
            Materials.OilSlick(), Materials.VelvetRed(), Materials.SatinBlue(),
            Materials.Jade(), Materials.GlowingNeon((0.2, 1.0, 0.2)),
        ]
        for r in range(rows):
            for c in range(cols):
                cube = sc.add_cube(palette[r * cols + c])
                x = start_x + c * spacing
                z = start_z + r * spacing
                cube.scale_verts(0.7).move_to(x, -1.0 + 0.7, z) \
                    .rotate_self_euler_xyz(0, 0.7, 0)
        sc.add_spot_light((0, 8, -5), (0, -1, 0), (1, 1, 1), 10.0, 0.1, 0.5,
                          2.0, 0.1)
        sc.add_point_light((-5, 2, -2), (1.0, 0.8, 0.8), 2.0, 10.0, 0.2)
        sc.add_point_light((5, 2, -2), (0.8, 0.8, 1.0), 2.0, 10.0, 0.2)
        sc.set_camera((0, 6, 4), (0, 0, -5), (0, 1, 0), 50.0)
        sc.set_sky_gradient((0.1, 0.1, 0.1), (0.02, 0.02, 0.02))
    else:
        return create_lit_test_scene(width, height, device), "Lit Test Scene"

    return sc, name
