"""The bench scene and its HDRI twin, described for the reference: a
frozen copy of ``ptrt_tpu_torch/app/bench_scene.py``'s ``build_bench_scene``
and ``build_hdri_scene`` (a 4x4 grid of lat-long spheres and cubes with 16
materials over a ground plane, two spot lights and two point lights, a
gradient sky; the HDRI twin adds a directional and an area light under a
seeded equirect map), building the reference's ``scene.Scene``."""

from __future__ import annotations

import numpy as np

from benchmark.reference.hdri import synthetic_env
from benchmark.reference.mesh import Mesh
from benchmark.reference.materials import Material, Materials
from benchmark.reference.scene import Scene

SKY = ((0.35, 0.45, 0.65), (0.05, 0.05, 0.08))
# (position, direction, colour, intensity) of the two spot lights (cones
# 0.44 and 0.70 rad) and (position, colour, intensity) of the two point
# lights (range 20)
SPOTS = (((0, 6.5, 6), (0, -1, 0), (1.0, 0.95, 0.9), 6.0),
         ((-6, 6.5, 8), (0.3, -1, 0), (0.9, 0.9, 1.0), 4.0))
POINTS = (((0, 2, 1), (0.8, 0.8, 0.8), 5.0), ((6, 1, 8), (0.5, 0.5, 0.5), 3.0))
CAMERA = ((0, 1.2, -1.5), (0, 0, 6), 60)


def build_bench_scene(width: int, height: int,
                      target_tris: int = 1_000_000, device="cuda") -> Scene:
    """The bench scene on ``device`` (the card by default)."""
    sc = Scene(width, height, device=device)
    sc.set_sky_gradient(*SKY)
    _bench_geometry(sc, target_tris)
    for pos, direction, color, intensity in SPOTS:
        sc.add_spot_light(pos, direction, color, intensity, inner_cone=0.44,
                          outer_cone=0.70, radius=0.2)
    for pos, color, intensity in POINTS:
        sc.add_point_light(pos, color, intensity, range=20.0, radius=0.1)
    lookfrom, lookat, fov = CAMERA
    sc.set_camera(lookfrom, lookat, fov=fov)
    return sc


def _bench_geometry(sc, target_tris: int) -> None:
    """The 4x4 grid of spheres and cubes and the floor."""

    grid = 4  # 4x4 objects + floor
    # (gx + gz) % 3 == 2 cells are 12-tri cubes; the rest are lat-long
    # spheres (2*seg^2 tris each) that carry the triangle budget
    n_spheres = sum(1 for gz in range(grid) for gx in range(grid)
                    if (gx + gz) % 3 != 2)
    per_sphere = max(200, target_tris // max(n_spheres, 1))
    seg = max(8, int(np.ceil(np.sqrt(per_sphere / 2.0))))

    mats = [
        Materials.Gold(), Materials.PlasticRed(), Materials.Glass(),
        Materials.Chrome(), Materials.CarPaint((0.8, 0.1, 0.1)),
        Materials.Copper(), Materials.PlasticBlue(), Materials.FrostedGlass(),
        Materials.Silver(), Materials.Jade(), Materials.PlasticGreen(),
        Materials.EmissiveLamp((1.0, 0.8, 0.6), 4.0), Materials.Iron(),
        Materials.MarbleCarrara(), Materials.RubberBlack(), Materials.WoodOak(),
    ]
    rng = np.random.default_rng(42)
    k = 0
    for gz in range(grid):
        for gx in range(grid):
            x = (gx - (grid - 1) / 2.0) * 2.2
            z = 4.0 + gz * 2.2
            if (gx + gz) % 3 == 2:
                m = sc.add_cube(mats[k % len(mats)])
                m.transform.set_position(x, -0.5, z).set_scale(1.2)
                m.transform.set_rotation(0.0, float(rng.uniform(0, 3.1)), 0.0)
            else:
                m = sc.add_sphere(seg, mats[k % len(mats)])
                m.transform.set_position(x, -0.4, z)
            k += 1

    sc.add_plane_xz(-1.0, 60.0, Material.make((0.8, 0.8, 0.8), 0.7))


# the "hdri" configuration's map: a common "4k HDRI" size, 100 MB as float32
HDRI_HW = (2048, 4096)
HDRI_ROTATION = 0.7


def build_hdri_scene(width: int, height: int, target_tris: int = 1_000_000,
                     device="cuda", env_hw=HDRI_HW, seed: int = 0) -> Scene:
    """The bench scene lit by a seeded (H, W) equirect map (``synthetic_env``:
    a gradient, low-frequency noise, a sun of a few texels at ~1e4) at
    rotation ``HDRI_ROTATION``, with one directional and one area light
    besides its two spot and two point lights."""
    sc = build_bench_scene(width, height, target_tris, device)
    sc.add_directional_light((0.4, -1.0, 0.3), (1.0, 0.96, 0.9), 1.5)
    sc.add_area_light((3.0, 4.0, 7.0), (-0.3, -1.0, 0.1), 2.0, 1.0,
                      (1.0, 0.9, 0.8), 6.0)
    sc.set_environment_map(synthetic_env(*env_hw, seed=seed), HDRI_ROTATION)
    return sc
