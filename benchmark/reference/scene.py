"""The reference's scene: what ``ptrt_tpu_torch``'s ``Scene`` is given
(meshes and their materials, lights, the sky, the camera), kept as a
description, with the tables the reference traces made from it on demand:
the triangle table (``scene_geom.triangles``) and its chunk boxes, the
material and light tables, the sky (an HDRI's alias tables built here
from the map), the camera and the blue-noise table.  The method names are
the port's, so the frozen scene functions (``bench_scene.py``) drive it as
they drive the port's ``Scene``."""

from __future__ import annotations

import numpy as np

from benchmark.reference import traverse
from benchmark.reference.bluenoise import blue_noise_table
from benchmark.reference.camera import Camera
from benchmark.reference.lights import Light, LightTable
from benchmark.reference.materials import Material, MaterialTable
from benchmark.reference.mesh import Mesh
from benchmark.reference.scene_geom import triangles
from benchmark.reference.sky import SkyConfig


class Scene:
    def __init__(self, width: int, height: int, device="cuda"):
        self.width, self.height = int(width), int(height)
        self.device = device
        self.meshes, self.mesh_materials, self.lights = [], [], []
        self.sky_color_top = (0.5, 0.7, 1.0)
        self.sky_color_bottom = (1.0, 1.0, 1.0)
        self.use_sky = True
        self.env_map = None
        self.env_rotation = 0.0
        self.camera_args = None

    # -- the description, as the port's Scene takes it -------------------------
    def add_mesh(self, mesh: Mesh, material: Material | None = None) -> Mesh:
        self.meshes.append(mesh)
        self.mesh_materials.append(material or Material())
        return mesh

    def add_plane_xz(self, plane_y: float, half_size: float,
                     material: Material | None = None) -> Mesh:
        return self.add_mesh(Mesh.plane_xz(plane_y, half_size),
                             material or Material.make((0.8, 0.8, 0.8)))

    def add_sphere(self, segments: int = 32,
                   material: Material | None = None) -> Mesh:
        return self.add_mesh(Mesh.sphere(segments),
                             material or Material.make((1.0, 0.0, 0.0)))

    def add_cube(self, material: Material | None = None) -> Mesh:
        return self.add_mesh(Mesh.cube(),
                             material or Material.make((1.0, 0.0, 0.0)))

    def add_point_light(self, position, color=(1, 1, 1), intensity=1.0,
                        range=100.0, radius=0.0) -> None:
        self.lights.append(Light.point(position, color, intensity, range,
                                       radius))

    def add_area_light(self, position, direction, width=1.0, height=1.0,
                       color=(1, 1, 1), intensity=1.0, range=100.0) -> None:
        self.lights.append(Light.area(position, direction, width, height,
                                      color, intensity, range))

    def add_directional_light(self, direction, color=(1, 1, 1),
                              intensity=1.0) -> None:
        self.lights.append(Light.directional(direction, color, intensity))

    def add_spot_light(self, position, direction, color=(1, 1, 1),
                       intensity=1.0, inner_cone=0.5, outer_cone=0.7,
                       range=100.0, radius=0.0) -> None:
        self.lights.append(Light.spot(position, direction, color, intensity,
                                      range, inner_cone, outer_cone, radius))

    def set_sky_gradient(self, top, bottom) -> None:
        self.sky_color_top, self.sky_color_bottom = tuple(top), tuple(bottom)
        self.use_sky = True

    def set_environment_map(self, env, rotation: float = 0.0) -> None:
        self.env_map = np.asarray(env, np.float32)
        self.env_rotation = float(rotation)

    def set_camera(self, lookfrom, lookat, vup=(0, 1, 0), fov=60.0) -> None:
        self.camera_args = (tuple(lookfrom), tuple(lookat), tuple(vup),
                            float(fov))

    # -- the tables ------------------------------------------------------------
    def camera(self, device, lookfrom=None, lookat=None, fov=None) -> Camera:
        """The pinhole camera (``set_camera``'s, or the one given), as the
        port's ``Scene.set_camera`` makes it: focused on the look-at
        point."""
        lf, la, vup, fv = self.camera_args
        lf = lf if lookfrom is None else tuple(lookfrom)
        la = la if lookat is None else tuple(lookat)
        fv = fv if fov is None else float(fov)
        focus = float(np.linalg.norm(np.asarray(la, np.float64)
                                     - np.asarray(lf, np.float64)))
        return Camera.make(lf, la, vup, fv, self.width / self.height, 0.0,
                           focus, device=device)

    def tables(self, device) -> dict:
        """What a trace reads, on ``device``: {"tris", "chunks", "mats",
        "lights", "n_lights", "sky", "bn"}."""
        tris = triangles(self.meshes,
                         [m.transmission for m in self.mesh_materials],
                         device)
        if self.env_map is None:
            sky = SkyConfig.gradient(self.sky_color_top,
                                     self.sky_color_bottom, self.use_sky,
                                     device=device)
        else:
            sky = SkyConfig.hdri(self.env_map, self.env_rotation,
                                 use_sky=self.use_sky, device=device)
        return {"tris": tris, "chunks": traverse.chunk_boxes(tris),
                "mats": MaterialTable.from_materials(self.mesh_materials,
                                                     device),
                "lights": LightTable.from_lights(self.lights, device),
                "n_lights": len(self.lights), "sky": sky,
                "bn": blue_noise_table(device)}
