"""PT Scene — the path-tracer orchestrator (counterpart of
``ptrt_tpu/scene/pt_scene.py``).

Owns meshes, materials, lights, camera and sky on the host, assembles the
device tables on first render (all meshes static: one flat BVH), and runs
the frame in the reference's order: trace at the render size
(``render/pipeline.trace_frame``, split into the denoiser's channels when
the denoiser is on), the progressive running average (only with the
denoiser off), motion vectors, SVGF, bloom, the bilinear upscale to the
display size, and the tonemap (K6).  Frames above 16 spp (the reference's
chunked post program) raise ``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ptrt_tpu_torch.core import rng as prng
from ptrt_tpu_torch.core.bluenoise import blue_noise_table
from ptrt_tpu_torch.core.vec import where
from ptrt_tpu_torch.geometry.mesh import Mesh
from ptrt_tpu_torch.geometry.scene_geom import assemble_geometry
from ptrt_tpu_torch.render import pipeline as pl
from ptrt_tpu_torch.render.bloom import apply_bloom, bloom_mips
from ptrt_tpu_torch.render.denoiser import (DEFAULT_SETTINGS, denoise_frame,
                                            init_denoiser_state)
from ptrt_tpu_torch.render.motion import motion_vectors
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
    # with the denoiser OFF, display the running average of the frames since
    # the last edit or camera move; with it on, temporal history converges
    progressive_accumulation: bool = True

    def check_ported(self) -> None:
        """Raise for settings whose code is not ported yet."""
        if self.samples_per_pixel > SPP_DISPATCH_MAX:
            raise NotImplementedError(
                f"not ported yet: samples_per_pixel > {SPP_DISPATCH_MAX} "
                "(ROADMAP A6: chunked-spp post program)")


class Scene:
    def __init__(self, width: int, height: int, device="cuda"):
        """A scene rendered on ``device``: the card by default; pass
        ``device="cpu"`` for the plain torch versions of the kernels."""
        self.width = int(width)
        self.height = int(height)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Scene: no CUDA device here; pass "
                               "device=\"cpu\" to render on the CPU")
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
        # SVGF history; survives camera moves and reset_accumulation
        self._denoiser_state = None
        # SVGF tunables: None = render/denoiser.DEFAULT_SETTINGS (frozen;
        # replace it with dataclasses.replace)
        self.denoiser_settings = None
        # progressive accumulation: (radiance sum, frame count as a 0-d
        # float32 tensor), and the view-projection it was accumulated under
        self._accum = None
        self._accum_view_proj = None
        self.prev_view_proj = self.camera.get_view_proj()
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

    # -- settings ------------------------------------------------------------
    def set_performance_preset(self, preset: str) -> None:
        """The reference's five presets: "ultra", "quality", "balanced",
        "performance", "fast"."""
        p = self.perf
        if preset == "ultra":
            p.enable_denoiser, p.enable_bloom = False, True
            p.enable_motion_vectors = True
            p.samples_per_pixel, p.max_bounce_depth = 128, 32
            p.resolution_scale, p.russian_roulette_start_bounce = 1.0, 8
        elif preset == "quality":
            p.enable_denoiser, p.enable_bloom = True, True
            p.enable_motion_vectors = True
            p.max_bounce_depth, p.resolution_scale = 6, 1.0
            p.russian_roulette_start_bounce = 2
        elif preset == "balanced":
            p.enable_denoiser, p.enable_bloom = True, True
            p.enable_motion_vectors = True
            p.max_bounce_depth, p.resolution_scale = 4, 1.0
            p.russian_roulette_start_bounce = 1
        elif preset == "performance":
            p.enable_denoiser, p.enable_bloom = True, False
            p.enable_motion_vectors = True
            p.max_bounce_depth, p.resolution_scale = 3, 0.75
            p.russian_roulette_start_bounce = 1
        elif preset == "fast":
            p.enable_denoiser, p.enable_bloom = False, False
            p.enable_motion_vectors = False
            p.max_bounce_depth, p.resolution_scale = 2, 0.35
            p.russian_roulette_start_bounce = 1

    def set_resolution_scale(self, scale: float) -> None:
        self.perf.resolution_scale = float(np.clip(scale, 0.25, 1.0))

    @property
    def render_size(self) -> tuple:
        """(height, width) the frame is traced and denoised at."""
        s = self.perf.resolution_scale
        return (max(1, int(self.height * s)), max(1, int(self.width * s)))

    def reset_accumulation(self) -> None:
        """Restart the progressive average and the jitter frame counter.
        SVGF history is NOT cleared: it is motion-compensated and exists
        for the moving camera; ``reset_denoiser_history`` clears it."""
        self.frame_count = 0
        self._accum = None

    def reset_denoiser_history(self) -> None:
        """Drop SVGF temporal history (a hard cut: teleport, scene load)."""
        self._denoiser_state = None

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
        rh, rw = self.render_size
        if self._rng_state is None or tuple(self._rng_state.shape) != (rh,
                                                                       rw):
            ys, xs = torch.meshgrid(torch.arange(rh, device=self.device),
                                    torch.arange(rw, device=self.device),
                                    indexing="ij")
            self._rng_state = prng.seed(xs, ys, 0)

    def sky(self) -> SkyConfig:
        return SkyConfig.gradient(self.sky_color_top, self.sky_color_bottom,
                                  self.use_sky, device=self.device)

    # -- rendering -----------------------------------------------------------
    def render_frame_device(self) -> torch.Tensor:
        """One frame -> (H, W, 3) uint8 tensor on the scene's device."""
        p = self.perf
        p.check_ported()
        self._ensure_device_state()
        rh, rw = self.render_size
        denoise = bool(p.enable_denoiser)
        if denoise and (self._denoiser_state is None
                        or tuple(self._denoiser_state.depth.shape)
                        != (rh, rw)):
            self._denoiser_state = init_denoiser_state(rh, rw, self.device)
        self._rng_state, bufs = pl.trace_frame(
            self._geom, self._mat_table, self._light_table, len(self.lights),
            self.sky(), self.camera, self._rng_state, self.frame_count, rw,
            rh, int(p.samples_per_pixel), int(p.max_bounce_depth),
            self._blue_noise, split=denoise,
            rr_enabled=bool(p.enable_russian_roulette),
            rr_start=int(p.russian_roulette_start_bounce),
            camera_nee=bool(p.camera_nee_fix))
        self.last_frame = bufs

        current = bufs.color
        if bool(p.progressive_accumulation) and not denoise:
            current = self._accumulate(current, rh, rw)
        if denoise:
            if p.enable_motion_vectors:
                mv = motion_vectors(bufs.depth, self.camera,
                                    self.prev_view_proj, rw, rh)
            else:  # static-camera reprojection
                zero = torch.zeros((rh, rw), dtype=torch.float32,
                                   device=self.device)
                mv = (zero, zero)
            current, self._denoiser_state = denoise_frame(
                bufs, mv, self._denoiser_state, self.camera, self.frame_count,
                settings=self.denoiser_settings or DEFAULT_SETTINGS)
        # at full size K6 adds the bloom's mip 0 itself; before an upscale
        # the chain writes the composite
        bloom = None
        full_size = (rh, rw) == (self.height, self.width)
        if p.enable_bloom and full_size:
            bloom = bloom_mips(current)
        elif p.enable_bloom:
            current = apply_bloom(current)
        if not full_size:
            current = pl.upscale_bilinear(current, self.height, self.width)
        img = pl.tonemap_rgb8(current, 1.0, bloom=bloom)
        self.frame_count += 1
        self.prev_view_proj = self.camera.get_view_proj()
        return img

    def _accumulate(self, color, rh: int, rw: int):
        """Add the frame to the progressive sum and return the running
        average.  The sum restarts when the view-projection's VALUES change
        (the camera moved, whichever way it was set) or the render size
        changed.  The values are compared on the device and the sum and its
        count selected there, as the reference does inside its program: no
        copy to the host, so the frame never waits for the card here."""
        view_proj = self.camera.get_view_proj()
        if (self._accum is None or self._accum_view_proj is None
                or tuple(self._accum[0].x.shape) != (rh, rw)):
            self._accum = (color, torch.ones((), dtype=torch.float32,
                                             device=color.x.device))
        else:
            same = (view_proj == self._accum_view_proj).all()
            total, count = self._accum
            self._accum = (where(same, total + color, color),
                           torch.where(same, count + 1.0, 1.0))
        self._accum_view_proj = view_proj
        return self._accum[0] * self._accum[1].reciprocal()

    def render_frame(self) -> np.ndarray:
        """One interactive frame -> (H, W, 3) uint8 on the host."""
        return self.render_frame_device().cpu().numpy()
