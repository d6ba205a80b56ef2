"""RT Scene — the fast one-bounce ray-tracer backend (counterpart of
``ptrt_tpu/scene/rt_scene.py``).

Meshes, materials, lights, camera, ambient light and a sky gradient on the
host; ``upload_to_gpu`` assembles the device geometry (one static BVH) and
packs the tables; the frame is the reference's: pinhole camera rays over
the pixel grid, the closest walk (K1), the one-bounce PBR shade with its
shadow rays (K10 and K2, ``render/rt_shading.rt_frame``), the glass branch
where the scene has glass, sky on a miss, Reinhard, gamma 2.2 and RGB8.
``render_frame_device`` runs it as a program kept per configuration (the
reference's ``_rt_frame_program``): on the card captured into a CUDA graph
at its first frame and replayed after, its glass pass sized by the glass
count on the card; ``render_eager`` runs the same body eagerly.

The reference intersects scenes of 192 triangles or fewer by brute force;
the port walks its BVH at every size, as its PT ``Scene`` does.  The scene
renders on the card by default; ``device="cpu"`` runs the plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from ptrt_tpu_torch import graphs
from ptrt_tpu_torch.geometry.mesh import Mesh
from ptrt_tpu_torch.geometry.scene_geom import assemble_geometry
from ptrt_tpu_torch.render import rt_shading
from ptrt_tpu_torch.scene.camera import Camera, pixel_grid
from ptrt_tpu_torch.scene.lights import Light, LightTable
from ptrt_tpu_torch.scene.materials import Material, MaterialTable
from ptrt_tpu_torch.utils.imageio import save_ppm


class RTScene:
    def __init__(self, width: int, height: int, device="cuda"):
        self.width = int(width)
        self.height = int(height)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("RTScene: no CUDA device here; pass "
                               "device=\"cpu\" to render on the CPU")
        self.meshes: list[Mesh] = []
        self.mesh_materials: list[Material] = []
        self.lights: list[Light] = []
        self.camera = Camera.make((0.0, 0.0, 0.0), (0.0, 0.0, -1.0),
                                  aspect_ratio=width / height,
                                  device=self.device)
        self.ambient_light = (0.03, 0.03, 0.03)
        self.sky_color_top = (0.5, 0.7, 1.0)
        self.sky_color_bottom = (1.0, 1.0, 1.0)
        self.use_sky = True
        self._geom = None
        self._mat_table = None
        self._light_table = None
        self._dirty = True
        # the last frame's records (rt_shading.RTFrame; on the card its
        # glass pass at its room, which ``last_frame`` cuts to G, and the
        # program's, which the next frame overwrites)
        self.frame_records: rt_shading.RTFrame | None = None
        # the frame programs by configuration (of the current world's
        # shapes), and the lighting parameters by value
        self._programs = graphs.Programs()
        self._params = None

    # -- scene building (the PT scene's factory surface) ---------------------
    def add_mesh(self, mesh_or_path, material: Material | None = None) -> Mesh:
        """A ``Mesh``, or the path of an OBJ file to load."""
        mesh = (mesh_or_path if isinstance(mesh_or_path, Mesh)
                else Mesh(mesh_or_path))
        self.meshes.append(mesh)
        self.mesh_materials.append(material or Material())
        self._dirty = True
        return mesh

    def add_triangles(self, tris, material: Material | None = None) -> Mesh:
        return self.add_mesh(Mesh.from_triangles(np.asarray(tris)), material)

    def add_plane_xz(self, plane_y, half_size,
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

    def add_checkerboard_plane_xz(self, plane_y, tiles_per_side, tile_size,
                                  white_mat: Material, black_mat: Material):
        w, b = Mesh.checkerboard_plane_xz(plane_y, tiles_per_side, tile_size)
        self.add_mesh(w, white_mat)
        self.add_mesh(b, black_mat)

    def add_point_light(self, position, color=(1, 1, 1), intensity=1.0,
                        range=100.0) -> Light:
        lt = Light.point(position, color, intensity, range)
        self.lights.append(lt)
        self._dirty = True
        return lt

    def add_directional_light(self, direction, color=(1, 1, 1),
                              intensity=1.0) -> Light:
        lt = Light.directional(direction, color, intensity)
        self.lights.append(lt)
        self._dirty = True
        return lt

    def add_spot_light(self, position, direction, color=(1, 1, 1),
                       intensity=1.0, inner_cone=0.5,
                       outer_cone=0.7, range=100.0) -> Light:
        """Cone angles in radians."""
        lt = Light.spot(position, direction, color, intensity, range,
                        inner_cone, outer_cone)
        self.lights.append(lt)
        self._dirty = True
        return lt

    def set_camera(self, lookfrom, lookat, vup=(0, 1, 0), fov=60.0,
                   aperture=0.0, focus_dist=None) -> None:
        if focus_dist is None:
            focus_dist = float(np.linalg.norm(np.asarray(lookat, np.float64)
                                              - np.asarray(lookfrom,
                                                           np.float64)))
        self.camera = Camera.make(lookfrom, lookat, vup, fov,
                                  self.width / self.height, aperture,
                                  focus_dist, device=self.device)

    def set_ambient_light(self, color) -> None:
        self.ambient_light = tuple(color)

    def set_sky_gradient(self, top, bottom) -> None:
        self.sky_color_top = tuple(top)
        self.sky_color_bottom = tuple(bottom)
        self.use_sky = True

    # -- device assembly -----------------------------------------------------
    def upload_to_gpu(self) -> None:
        """Assemble the geometry and pack the tables on the scene's device.
        The RT shadow rays skip every mesh with any transmission above 0:
        each such mesh maps to transmission 1.0 (others 0.0) before the
        geometry's shadow-opaque threshold (transmission <= 0.5)."""
        self._geom = assemble_geometry(
            self.meshes, [1.0 if m.transmission > 0.0 else 0.0
                          for m in self.mesh_materials], self.device)
        self._mat_table = MaterialTable.from_materials(self.mesh_materials,
                                                       self.device)
        self._light_table = LightTable.from_lights(self.lights, self.device)
        self._dirty = False

    def _ensure(self) -> None:
        if self._dirty or self._geom is None:
            self.upload_to_gpu()

    def _has_glass(self) -> bool:
        return any(m.transmission > 0.0 and m.metallic < 0.1
                   for m in self.mesh_materials)

    # -- rendering -----------------------------------------------------------
    def params(self) -> torch.Tensor:
        """The lighting parameters the K10 stages take (ambient, sky top,
        sky bottom, use_sky), on the scene's device: made again only when
        they changed (a frame copies nothing to the card otherwise)."""
        key = (tuple(self.ambient_light), tuple(self.sky_color_top),
               tuple(self.sky_color_bottom), bool(self.use_sky))
        if self._params is None or self._params[0] != key:
            self._params = (key, rt_shading.rt_params(
                *key[:3], key[3], self.device))
        return self._params[1]

    def camera_rays(self):
        """The pinhole rays of the pixel grid (bottom row first), flat."""
        return pinhole_rays(self.camera, self.width, self.height)

    @property
    def last_frame(self) -> rt_shading.RTFrame | None:
        """The last frame's records (``rt_shading.RTFrame``) with the glass
        pass cut to its G lanes (``rt_shading.compact``: G is read from the
        card when they are asked for, never by the frame); on the card the
        program's, which the next frame overwrites."""
        if self.frame_records is None:
            return None
        return rt_shading.compact(self.frame_records)

    def render_eager(self) -> rt_shading.RTFrame:
        """The frame body run eagerly (``rt_shading.rt_frame``) on the
        scene as it stands, the glass pass sized by G read to the host: its
        RTFrame (the records compact).  Sets nothing."""
        self._ensure()
        o, d = self.camera_rays()
        return rt_shading.rt_frame(
            self._geom, self._mat_table, self._light_table, len(self.lights),
            self.params(), o, d, self.height, self.width, self._has_glass())

    def render_frame_device(self) -> torch.Tensor:
        """One frame -> (H, W, 3) uint8 tensor on the scene's device, its
        own (the next frame does not overwrite it).  The frame is a
        program kept per (width, height, light count, glass) and the shapes
        it reads: on the card the first frame of a configuration captures
        ``rt_frame(device_count=True)`` into a CUDA graph and every later
        frame is one replay, with no read of the card; on the CPU the
        program calls the body.  ``frame_records``: its RTFrame."""
        self._ensure()
        has_glass = self._has_glass()
        reads = {"geom": self._geom, "mats": self._mat_table,
                 "lights": self._light_table, "params": self.params(),
                 "camera": self.camera}
        key = (self.width, self.height, len(self.lights), has_glass)
        prog = self._programs.program(
            key, graphs.signature(reads), lambda: graphs.Program(
                _frame_body(self.width, self.height, len(self.lights),
                            has_glass), reads, {}, None, self.device))
        self.frame_records = prog.run(reads, {}, None)
        rgb8 = self.frame_records.rgb8
        return rgb8 if prog.graph is None else rgb8.clone()

    def render_frame(self) -> np.ndarray:
        return self.render_frame_device().cpu().numpy()

    def render(self, out_path: str | None = None) -> np.ndarray:
        """``render_frame``, also written to ``out_path`` as a PPM."""
        img = self.render_frame()
        if out_path:
            save_ppm(out_path, img)
        return img

    def save_as_ppm(self, path: str, img: np.ndarray | None = None) -> None:
        """Write ``img`` (a new frame if None) as an ASCII PPM."""
        if img is None:
            img = self.render_frame()
        save_ppm(path, img)


def pinhole_rays(camera, width: int, height: int):
    """The pinhole rays of ``camera`` through a width x height pixel grid
    (bottom row first), flat."""
    s, t = pixel_grid(width, height, camera.origin.x.device)
    ray = camera.get_ray_simple(s, t)
    flat = lambda c: c.reshape(-1).contiguous()
    return ray.origin.map(flat), ray.direction.map(flat)


def _frame_body(width: int, height: int, n_lights: int, has_glass: bool):
    """The RT frame program's body: the camera's rays, then ``rt_frame``
    with the glass count on the card; returns (RTFrame, no state)."""
    def body(reads, st, values):
        o, d = pinhole_rays(reads["camera"], width, height)
        return rt_shading.rt_frame(
            reads["geom"], reads["mats"], reads["lights"], n_lights,
            reads["params"], o, d, height, width, has_glass,
            device_count=True), {}
    return body
