"""PT Scene — the path-tracer orchestrator (counterpart of
``ptrt_tpu/scene/pt_scene.py``).

Owns meshes, materials, lights, camera and sky on the host, assembles the
device tables on first render (all meshes static: one flat BVH), and runs
the frame: trace (``render/pipeline.trace_frame``), then the progressive
running average, then the tonemap (K6).  The post stack is not ported yet:
the settings that would need it raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ptrt_tpu_torch.core import rng as prng
from ptrt_tpu_torch.core.bluenoise import blue_noise_table
from ptrt_tpu_torch.geometry.mesh import Mesh
from ptrt_tpu_torch.geometry.scene_geom import assemble_geometry
from ptrt_tpu_torch.render import pipeline as pl
from ptrt_tpu_torch.render.sky import SkyConfig
from ptrt_tpu_torch.scene.camera import Camera
from ptrt_tpu_torch.scene.lights import Light, LightTable
from ptrt_tpu_torch.scene.materials import Material, MaterialTable

# the reference splits frames above this many spp into several dispatches
SPP_DISPATCH_MAX = 16


@dataclass
class PerformanceSettings:
    enable_denoiser: bool = True
    enable_bloom: bool = True
    enable_motion_vectors: bool = True
    max_bounce_depth: int = 4
    samples_per_pixel: int = 1
    resolution_scale: float = 1.0
    enable_russian_roulette: bool = True
    russian_roulette_start_bounce: int = 1
    # True: bounce-0 hits receive analytic NEE (the reference's fix of its
    # camera-ray spec flag)
    camera_nee_fix: bool = True

    def check_ported(self) -> None:
        """Raise for settings whose code is not ported yet."""
        todo = []
        if self.enable_denoiser:
            todo.append("enable_denoiser (ROADMAP A6: SVGF)")
        if self.enable_bloom:
            todo.append("enable_bloom (ROADMAP A6: bloom)")
        if self.enable_motion_vectors:
            todo.append("enable_motion_vectors (ROADMAP A6: motion vectors)")
        if self.resolution_scale != 1.0:
            todo.append("resolution_scale != 1 (ROADMAP A5: upscale)")
        if self.samples_per_pixel > SPP_DISPATCH_MAX:
            todo.append(f"samples_per_pixel > {SPP_DISPATCH_MAX} (ROADMAP A6: "
                        "chunked-spp post program)")
        if todo:
            raise NotImplementedError(
                "not ported yet: " + "; ".join(todo))


class Scene:
    def __init__(self, width: int, height: int, device="cpu"):
        self.width = int(width)
        self.height = int(height)
        self.device = torch.device(device)
        self.meshes: list[Mesh] = []
        self.mesh_materials: list[Material] = []
        self.lights: list[Light] = []
        self.sky_color_top = (0.5, 0.7, 1.0)
        self.sky_color_bottom = (1.0, 1.0, 1.0)
        self.use_sky = True
        self.perf = PerformanceSettings()
        self.frame_count = 0
        self.camera = Camera.make((0.0, 0.0, 0.0), (0.0, 3.5, 5.0),
                                  aspect_ratio=width / height,
                                  device=self.device)
        self._geom = None
        self._mat_table = None
        self._light_table = None
        self._dirty = True
        self._rng_state = None
        self._blue_noise = blue_noise_table(self.device)
        # progressive accumulation: (radiance sum, frame count, camera)
        self._accum = None
        # the FrameBuffers of the last rendered frame
        self.last_frame: pl.FrameBuffers | None = None

    # -- scene edits ---------------------------------------------------------
    def add_mesh(self, mesh: Mesh, material: Material | None = None) -> Mesh:
        self.meshes.append(mesh)
        self.mesh_materials.append(material or Material())
        self._edited()
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
                        range=100.0, radius=0.0) -> Light:
        lt = Light.point(position, color, intensity, range, radius)
        self.lights.append(lt)
        self._edited()
        return lt

    def add_spot_light(self, position, direction, color=(1, 1, 1),
                       intensity=1.0, inner_cone=0.5, outer_cone=0.7,
                       range=100.0, radius=0.0) -> Light:
        """Cone angles in radians."""
        lt = Light.spot(position, direction, color, intensity, range,
                        inner_cone, outer_cone, radius)
        self.lights.append(lt)
        self._edited()
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
        self.reset_accumulation()

    def set_sky_gradient(self, top, bottom) -> None:
        self.sky_color_top = tuple(top)
        self.sky_color_bottom = tuple(bottom)
        self.use_sky = True
        self.reset_accumulation()

    def reset_accumulation(self) -> None:
        """Restart the progressive average and the jitter frame counter."""
        self.frame_count = 0
        self._accum = None

    def _edited(self) -> None:
        self._dirty = True
        self.reset_accumulation()

    # -- device state --------------------------------------------------------
    def _ensure_device_state(self) -> None:
        if self._dirty or self._geom is None:
            trans = [m.transmission for m in self.mesh_materials]
            self._geom = assemble_geometry(self.meshes, trans, self.device)
            self._mat_table = MaterialTable.from_materials(
                self.mesh_materials, self.device)
            self._light_table = LightTable.from_lights(self.lights,
                                                       self.device)
            self._dirty = False
        if self._rng_state is None:
            ys, xs = torch.meshgrid(
                torch.arange(self.height, device=self.device),
                torch.arange(self.width, device=self.device), indexing="ij")
            self._rng_state = prng.seed(xs, ys, 0)

    def sky(self) -> SkyConfig:
        return SkyConfig.gradient(self.sky_color_top, self.sky_color_bottom,
                                  self.use_sky, device=self.device)

    # -- rendering -----------------------------------------------------------
    def render_frame_device(self) -> torch.Tensor:
        """One frame -> (H, W, 3) uint8 tensor on the scene's device."""
        self.perf.check_ported()
        self._ensure_device_state()
        self._rng_state, bufs = pl.trace_frame(
            self._geom, self._mat_table, self._light_table, len(self.lights),
            self.sky(), self.camera, self._rng_state, self.frame_count,
            self.width, self.height, int(self.perf.samples_per_pixel),
            int(self.perf.max_bounce_depth), self._blue_noise,
            rr_enabled=bool(self.perf.enable_russian_roulette),
            rr_start=int(self.perf.russian_roulette_start_bounce),
            camera_nee=bool(self.perf.camera_nee_fix))
        self.last_frame = bufs
        # progressive accumulation: display the running average of the
        # frames since the last edit; it restarts when the camera changes
        if self._accum is None or self._accum[2] is not self.camera:
            self._accum = (bufs.color, 1, self.camera)
        else:
            acc_sum, n, cam = self._accum
            self._accum = (acc_sum + bufs.color, n + 1, cam)
        img = pl.tonemap_rgb8(self._accum[0], 1.0 / self._accum[1])
        self.frame_count += 1
        return img

    def render_frame(self) -> np.ndarray:
        """One interactive frame -> (H, W, 3) uint8 on the host."""
        return self.render_frame_device().cpu().numpy()
