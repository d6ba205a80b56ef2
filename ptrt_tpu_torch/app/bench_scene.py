"""Canonical benchmark scene builder — a copy of
``ptrt_tpu/app/bench_scene.py``: a 4x4 grid of lat-long spheres and cubes
with 16 materials over a ground plane, two spot lights and two point
lights, and a gradient sky.  Triangle count is controlled by
``target_tris``.  ``build_hdri_scene`` lights the same scene with an HDRI
and adds a directional and an area light (the port's "hdri"
configuration); ``build_dynamic_scene`` adds the moving geometry of the
reference's games (the port's "dynamic" configuration);
``build_rt_bench_scene`` is the same scene in the one-bounce RT backend's
``RTScene`` (the port's "rt" configuration)."""

from __future__ import annotations

import numpy as np

from ptrt_tpu_torch.app.hdri import synthetic_env
from ptrt_tpu_torch.geometry.mesh import Mesh
from ptrt_tpu_torch.scene.materials import Material, Materials
from ptrt_tpu_torch.scene.pt_scene import Scene
from ptrt_tpu_torch.scene.rt_scene import RTScene

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


def build_rt_bench_scene(width: int, height: int,
                         target_tris: int = 1_000_000,
                         device="cuda") -> RTScene:
    """The bench scene's meshes, materials, lights, sky and camera in an
    ``RTScene`` on ``device`` (the card by default): the one-bounce
    backend's configuration of it (the lights' soft-shadow radii, which the
    RT shading does not read, dropped)."""
    sc = RTScene(width, height, device=device)
    sc.set_sky_gradient(*SKY)
    _bench_geometry(sc, target_tris)
    for pos, direction, color, intensity in SPOTS:
        sc.add_spot_light(pos, direction, color, intensity, inner_cone=0.44,
                          outer_cone=0.70)
    for pos, color, intensity in POINTS:
        sc.add_point_light(pos, color, intensity, range=20.0)
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


# -- the "dynamic" configuration ------------------------------------------------
# tycoon's building slots (ptrt_tpu/games/tycoon.py GRID, CELL,
# BUILDING_TYPES: heights and materials), type-major as build_fused_scene
# allocates them, on the bench floor behind the bench grid
GRID, CELL = 8, 2.0
BUILDING_HEIGHTS = (0.8, 1.4, 3.0)
BUILDING_MATERIALS = (Materials.WoodOak, Materials.PlasticRed,
                      Materials.Chrome)
TYCOON_CENTER = (0.0, -1.0, 19.0)
# the water pool: an N x N heightfield (fluid.heightfield_to_triangles's
# layout), left of the bench grid, refilled every frame
POOL_N, POOL_EXTENT, POOL_CENTER = 256, 4.0, (-3.6, -0.95, 2.6)
# the Morton-sorted refill: a 64-segment sphere, right of the bench grid
BLOB_SEGMENTS, BLOB_SCALE, BLOB_CENTER = 64, 1.6, (3.4, 0.0, 2.8)


def heightfield_to_triangles(height: np.ndarray, extent: float = 4.0,
                             base_y: float = 0.0) -> np.ndarray:
    """(N, N) heights -> (2 (N-1)^2, 3, 3) triangles, the layout of the
    reference's ``games/fluid.heightfield_to_triangles`` (up-facing)."""
    n = height.shape[0]
    xs = np.linspace(-extent / 2, extent / 2, n, dtype=np.float32)
    px = np.broadcast_to(xs[None, :], (n, n))
    pz = np.broadcast_to(xs[:, None], (n, n))
    p = np.stack([px, base_y + height.astype(np.float32), pz], axis=-1)
    a, b, c, d = p[:-1, :-1], p[:-1, 1:], p[1:, 1:], p[1:, :-1]
    t1 = np.stack([a, c, b], axis=-2)
    t2 = np.stack([a, d, c], axis=-2)
    return np.concatenate([t1.reshape(-1, 3, 3), t2.reshape(-1, 3, 3)])


class DynamicAnimation:
    """The dynamic configuration's per-frame edits (``Scene.animate``):
    all 192 building transforms (the pop-up of the reference's
    ``tycoon.derive_fused_scene``, hidden slots collapsed to 1e-6 at
    y = -100, every slot turning a little each frame so that every
    transform changes), the pool's heights (a seeded sum of moving sine
    waves) refilled with ``set_triangles``, and the sphere's vertices
    displaced (seeded), each frame then committed."""

    def __init__(self, sc: Scene, slots, pool: Mesh, blob: Mesh, seed: int):
        rng = np.random.default_rng(seed)
        self.sc, self.slots, self.pool, self.blob = sc, slots, pool, blob
        # a third of the cells show one building type, each cell its phase
        self.grid = np.where(rng.random(GRID * GRID) < 1 / 3,
                             rng.integers(0, len(BUILDING_HEIGHTS),
                                          GRID * GRID), -1)
        self.phase = rng.random(GRID * GRID)
        self.waves = (rng.uniform(0.01, 0.04, 4), rng.uniform(2, 9, (4, 2)),
                      rng.uniform(1, 4, 4), rng.uniform(0, 6.3, 4))
        self.blob_verts = blob.vertices.copy()
        self.blob_faces = blob.faces.copy()
        self.blob_k = rng.uniform(3.0, 7.0, (3, 3)).astype(np.float32)

    def pool_triangles(self, frame: int) -> np.ndarray:
        amp, k, w, ph = self.waves
        xs = np.linspace(-POOL_EXTENT / 2, POOL_EXTENT / 2, POOL_N)
        x, z = np.meshgrid(xs, xs, indexing="xy")
        t = 0.05 * frame
        h = sum(amp[i] * np.sin(k[i, 0] * x + k[i, 1] * z + w[i] * t
                                + ph[i]) for i in range(4))
        return heightfield_to_triangles(h.astype(np.float32), POOL_EXTENT)

    def blob_triangles(self, frame: int) -> np.ndarray:
        v = self.blob_verts
        t = np.float32(0.1 * frame)
        bump = 1.0 + 0.08 * np.sin(v @ self.blob_k + t).sum(axis=1) / 3.0
        return (v * bump[:, None].astype(np.float32))[self.blob_faces]

    def __call__(self, frame: int) -> None:
        cx, fy, cz = TYCOON_CENTER
        yaw = 0.01 * frame
        pop = (self.phase + 0.05 * frame) % 1.0
        for (t, c), m in self.slots.items():
            gx, gz = c % GRID, c // GRID
            x = cx + (gx - (GRID - 1) / 2.0) * CELL
            z = cz + (gz - (GRID - 1) / 2.0) * CELL
            tr = m.transform.set_rotation(0.0, yaw, 0.0)
            if self.grid[c] == t:
                h = BUILDING_HEIGHTS[t] * (0.2 + 0.8 * pop[c])
                tr.set_position(x, fy + 0.5 * h, z).set_scale(1.4, h, 1.4)
            else:
                tr.set_position(x, -100.0, z).set_scale(1e-6)
        self.pool.set_triangles(self.pool_triangles(frame))
        self.blob.set_triangles(self.blob_triangles(frame))
        self.sc.commit_object_changes()


def build_dynamic_scene(width: int, height: int,
                        target_tris: int = 1_000_000, device="cuda",
                        seed: int = 0) -> Scene:
    """The bench scene under the "balanced" preset with the reference
    games' moving geometry, all dynamic meshes: tycoon's 192 building
    slots (8 x 8 cells x 3 types, transform edits), a 256 x 256 water
    heightfield (130,050 triangles, refilled: a device refit) and a
    64-segment sphere (8,192 triangles, ``device_lbvh``: a Morton-sorted
    device refill).  ``sc.animate(frame)`` applies frame ``frame``'s edits;
    frame 0's are applied here."""
    sc = build_bench_scene(width, height, target_tris, device)
    sc.set_performance_preset("balanced")
    slots = {}
    for t, mat in enumerate(BUILDING_MATERIALS):
        for c in range(GRID * GRID):
            m = sc.add_cube(mat())
            m.is_dynamic = True
            slots[(t, c)] = m
    pool = sc.add_mesh(Mesh.from_triangles(
        heightfield_to_triangles(np.zeros((POOL_N, POOL_N), np.float32),
                                 POOL_EXTENT)), Materials.Water())
    pool.is_dynamic = True
    pool.transform.set_position(*POOL_CENTER)
    blob = sc.add_sphere(BLOB_SEGMENTS, Materials.Copper())
    blob.is_dynamic = True
    blob.device_lbvh = True
    blob.transform.set_position(*BLOB_CENTER).set_scale(BLOB_SCALE)
    sc.animate = DynamicAnimation(sc, slots, pool, blob, seed)
    sc.animate(0)
    return sc
