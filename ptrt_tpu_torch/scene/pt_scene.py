"""PT Scene — the path-tracer orchestrator (counterpart of
``ptrt_tpu/scene/pt_scene.py``).

Owns meshes, materials, lights, camera and sky (a gradient or an HDRI) on
the host, keeps the device tables up to date incrementally (the static
meshes baked into one world BVH, rebuilt only when a static mesh changes;
each dynamic mesh walked as an instance: a transform edit updates its
matrix rows, a refill of the same triangle count refits its tables on the
device, K5), with separate dirty flags for geometry, materials and
lights, and runs the frame in the reference's order: trace at the
render size (``render/pipeline.trace_frame``, split into the denoiser's
channels when the denoiser is on), the progressive running average (only
with the denoiser off; ``accumulate``, K13 ``progressive_average`` on the
card), motion vectors, SVGF, bloom, the bilinear upscale to the display
size (K12), and the tonemap (K6).  A frame above ``SPP_DISPATCH_MAX``
samples (the "ultra" preset's 128) is traced in chunks of at most that
many, as the reference dispatches it, and posted once.
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ptrt_tpu_torch import graphs, kernels
from ptrt_tpu_torch.core import rng as prng
from ptrt_tpu_torch.core.bluenoise import blue_noise_table
from ptrt_tpu_torch.core.vec import Vec3, fmax, lerp, where
from ptrt_tpu_torch.geometry import scene_geom
from ptrt_tpu_torch.geometry.lbvh import lbvh_update
from ptrt_tpu_torch.geometry.mesh import Mesh
from ptrt_tpu_torch.geometry.refit import build_refit_plan, refit_apply
from ptrt_tpu_torch.geometry.scene_geom import assemble_geometry
from ptrt_tpu_torch.parallel import sharding
from ptrt_tpu_torch.render import pipeline as pl
from ptrt_tpu_torch.render import traverse
from ptrt_tpu_torch.render.bloom import apply_bloom, bloom_mips
from ptrt_tpu_torch.render.denoiser import (DEFAULT_SETTINGS, denoise_frame,
                                            init_denoiser_state)
from ptrt_tpu_torch.render.motion import motion_vectors
from ptrt_tpu_torch.render.sky import SkyConfig
from ptrt_tpu_torch.scene.camera import (Camera, camera_inputs, camera_make,
                                         pixel_grid)
from ptrt_tpu_torch.scene.lights import Light, LightTable
from ptrt_tpu_torch.scene.materials import Material, MaterialTable
from ptrt_tpu_torch.utils.imageio import save_ppm
from ptrt_tpu_torch.utils.logging import camera_frame, gpu_frame, span


def _merged_refit_plans(entries) -> tuple:
    """Each instance's refit plan placed at its offsets in the merged set
    (made once a merge, used at every refill)."""
    plans = []
    node_off = blk_off = slot_off = 0
    for e in entries:
        g = e["inst"].geom
        plans.append(e["plan"].placed(node_off, blk_off, slot_off))
        node_off += g.num_nodes
        blk_off += g.num_tri_blocks
        slot_off += g.num_tri_slots
    return tuple(plans)


# A frame above this many spp is traced in chunks of at most this many, as
# the reference dispatches it.  The chunks define the frame's samples: each
# runs at frame index frame_count + the samples before it (its TAA and
# blue-noise jitter) and advances the per-pixel PCG stream once.
SPP_DISPATCH_MAX = 16


def spp_chunks(spp: int) -> list:
    """The samples of each trace of a frame of ``spp`` samples."""
    return ([SPP_DISPATCH_MAX] * (spp // SPP_DISPATCH_MAX)
            + ([spp % SPP_DISPATCH_MAX] if spp % SPP_DISPATCH_MAX else []))


class FrameConfig(NamedTuple):
    """A frame's static configuration: what its programs are kept by,
    besides the shapes of what they read (the reference's
    ``_frame_program`` key, without ``use_brute``: the port walks its BVH
    at every size)."""

    render_size: tuple  # (rh, rw): traced and denoised
    size: tuple  # (height, width): displayed
    spp: int
    depth: int
    denoise: bool
    bloom: bool
    motion_vectors: bool
    n_lights: int
    rr_enabled: bool
    rr_start: int
    camera_nee: bool
    progressive: bool  # the progressive average (only with the denoiser off)
    den_settings: object


def _trace_frame(cfg: FrameConfig, geom, mats, lights, sky, camera, bn,
                 rng_state, frame_index, samples: int, tile=None):
    """``pipeline.trace_frame`` of ``samples`` spp under ``cfg``, split into
    the denoiser's channels when it is on: (PCG state, FrameBuffers)."""
    return pl.trace_frame(
        geom, mats, lights, cfg.n_lights, sky, camera, rng_state,
        frame_index, rng_state.shape[1], rng_state.shape[0], samples,
        cfg.depth, bn, split=cfg.denoise, rr_enabled=cfg.rr_enabled,
        rr_start=cfg.rr_start, camera_nee=cfg.camera_nee, tile=tile)


_CHANNELS = ("color", "diffuse", "specular", "emission")


def _add_chunk(acc, bufs, chunk: int, spp: int, first=None):
    """A chunk's trace added to its frame's (the reference's
    ``_init_accum`` / ``_accum_bufs``): the colour channels weighted by
    float32(chunk / spp), chunk 0 multiplied (``acc`` None) and each later
    one added in order, the G-buffer chunk 0's and the rays summed.
    ``first``: a 0-d bool tensor that selects chunk 0's terms on the device
    (a chunk program's, ``acc`` then its buffers)."""
    w = float(np.float32(chunk / spp))
    start = bufs._replace(**{k: None if getattr(bufs, k) is None
                             else getattr(bufs, k) * w for k in _CHANNELS})
    if acc is None:
        return start
    added = acc._replace(
        rays_traced=acc.rays_traced + bufs.rays_traced,
        **{k: None if getattr(acc, k) is None
           else getattr(acc, k) + getattr(bufs, k) * w for k in _CHANNELS})
    if first is None:
        return added
    pick = lambda a, b: (None if a is None else where(first, a, b)
                         if isinstance(a, Vec3) else torch.where(first, a, b))
    return pl.FrameBuffers(*[pick(a, b) for a, b in zip(start, added)])


def accumulate_plain(color: Vec3, view_proj: torch.Tensor, accum,
                     keep=None):
    """Plain version of K13 ``progressive_average`` (``accumulate``)."""
    if accum is None:
        total = color
        count = torch.ones((), dtype=torch.float32, device=color.x.device)
    else:
        total, count, vp = accum
        same = (view_proj == vp).all()
        if keep is not None:
            same = same & (keep != 0)
        total = where(same, total + color, color)
        count = torch.where(same, count + 1.0, 1.0)
    return total * count.reciprocal(), (total, count, view_proj)


_P3 = ctypes.c_void_p * 3


class ProgressiveArgs(kernels.Args):
    """``struct ProgressiveArgs`` of ``csrc/frame.cu``."""

    _fields_ = [
        ("color", _P3), ("total", _P3), ("count", ctypes.c_void_p),
        ("view_proj", ctypes.c_void_p), ("vp", ctypes.c_void_p),
        ("keep", ctypes.c_void_p), ("keep_bytes", ctypes.c_int),
        ("avg", _P3), ("total_out", _P3), ("count_out", ctypes.c_void_p),
        ("n", ctypes.c_longlong),
    ]


def accumulate(color: Vec3, view_proj: torch.Tensor, accum, keep=None):
    """The progressive running average: (average, (sum, count,
    view-projection)).  ``accum``: the sum, its count (a 0-d float32
    tensor) and the view-projection they were taken under, or None to
    restart.  The sum goes on where ``view_proj`` has the same VALUES and
    restarts with this frame where they differ, compared and selected on
    the device (no value read back).  ``keep``: a 0-d integer tensor, 0 to
    restart (a program's restart, with ``accum`` its buffers).  On the card
    K13 ``progressive_average``, one launch; the average and the new sum
    are the planes of one (6, H, W) tensor, the count a 0-d tensor of its
    own."""
    dev = color.x.device
    kernels.require_supported(dev)
    if dev.type == "cpu":
        return accumulate_plain(color, view_proj, accum, keep)
    shape = tuple(color.x.shape)
    planes = [("color", color)] + ([] if accum is None
                                   else [("sum", accum[0])])
    for what, v in planes:
        for k, c in zip("xyz", (v.x, v.y, v.z)):
            kernels.check_tensor(f"{what}.{k}", c, torch.float32, 2, dev)
            if tuple(c.shape) != shape:
                raise ValueError(f"{what}.{k}: shape {tuple(c.shape)} != "
                                 f"{shape}")
    matrices = [("view_proj", view_proj)] + ([] if accum is None
                                             else [("accum's", accum[2])])
    for what, m in matrices:
        kernels.check_tensor(what, m, torch.float32, 2, dev)
        if tuple(m.shape) != (4, 4):
            raise ValueError(f"{what}: shape {tuple(m.shape)}, expected "
                             "(4, 4)")
    a = ProgressiveArgs()
    a.color = _P3(color.x.data_ptr(), color.y.data_ptr(), color.z.data_ptr())
    if accum is not None:
        total, count, vp = accum
        kernels.check_tensor("count", count, torch.float32, 0, dev)
        a.total = _P3(total.x.data_ptr(), total.y.data_ptr(),
                      total.z.data_ptr())
        a.count, a.vp = count.data_ptr(), vp.data_ptr()
        if keep is not None:
            if keep.dtype not in (torch.int32, torch.int64):
                raise TypeError(f"keep: {keep.dtype}, expected int32 or "
                                "int64")
            kernels.check_tensor("keep", keep, keep.dtype, 0, dev)
            a.keep, a.keep_bytes = keep.data_ptr(), keep.element_size()
    a.view_proj = view_proj.data_ptr()
    out = torch.empty((6, *shape), dtype=torch.float32, device=dev)
    count_out = torch.empty((), dtype=torch.float32, device=dev)
    a.avg = _P3(*[out[k].data_ptr() for k in range(3)])
    a.total_out = _P3(*[out[3 + k].data_ptr() for k in range(3)])
    a.count_out, a.n = count_out.data_ptr(), color.x.numel()
    rc = kernels.get_lib().ptrt_progressive_average(ctypes.addressof(a),
                                                    kernels.stream_ptr(dev))
    kernels.launches["progressive_average"] += 1
    kernels.check(rc, "progressive_average")
    return Vec3(out[0], out[1], out[2]), (Vec3(out[3], out[4], out[5]),
                                          count_out, view_proj)


def _post_frame(cfg: FrameConfig, bufs, camera, frame_index, prev_view_proj,
                den, accum, keep=None):
    """The frame after its trace (the reference's ``_post_program``, and
    the end of its ``_frame_fn``): the progressive average
    (``accumulate``, with ``cfg.progressive``), motion vectors against
    ``prev_view_proj``, SVGF, bloom, the upscale and the tonemap.  Returns
    (rgb8, the denoiser history, the progressive (sum, count,
    view-projection))."""
    rh, rw = cfg.render_size
    current = bufs.color
    if cfg.progressive:
        current, accum = accumulate(current, camera.get_view_proj(), accum,
                                    keep)
    if cfg.denoise:
        if cfg.motion_vectors:
            mv = motion_vectors(bufs.depth, camera, prev_view_proj, rw, rh)
        else:  # static-camera reprojection
            zero = torch.zeros((rh, rw), dtype=torch.float32,
                               device=bufs.depth.device)
            mv = (zero, zero)
        current, den = denoise_frame(bufs, mv, den, camera, frame_index,
                                     settings=cfg.den_settings)
    # at full size K6 adds the bloom's mip 0 itself; before an upscale the
    # chain writes the composite
    bloom = None
    full_size = cfg.render_size == cfg.size
    if cfg.bloom and full_size:
        bloom = bloom_mips(current)
    elif cfg.bloom:
        current = apply_bloom(current)
    if not full_size:
        current = pl.upscale_bilinear(current, *cfg.size)
    return pl.tonemap_rgb8(current, 1.0, bloom=bloom), den, accum


def _zero_accum(cfg: FrameConfig, device) -> tuple:
    """The progressive average's buffers before its first frame."""
    f32 = dict(dtype=torch.float32, device=device)
    return (Vec3.zeros(cfg.render_size, device), torch.zeros((), **f32),
            torch.zeros((4, 4), **f32))


def _zero_buffers(cfg: FrameConfig, device) -> pl.FrameBuffers:
    """A frame's FrameBuffers of zeros (a chunk program's buffers before its
    first chunk)."""
    z = lambda dt=torch.float32: torch.zeros(cfg.render_size, dtype=dt,
                                             device=device)
    v3 = lambda: Vec3(z(), z(), z())
    split = v3 if cfg.denoise else (lambda: None)
    return pl.FrameBuffers(
        color=v3(), diffuse=split(), specular=split(), emission=split(),
        normal=v3(), depth=z(), object_id=z(torch.int32), roughness=z(),
        transmission=z(),
        rays_traced=torch.zeros((), dtype=torch.int64, device=device))


def program_world(reads: dict):
    """The world a program's ``reads`` hold (``Scene._frame_reads``)."""
    if reads["iset"] is None:
        return reads["static"]
    return scene_geom.WorldGeometry(
        static=reads["static"], instances=(),
        iset=dataclasses.replace(reads["iset"], geom=reads["set_geom"]))


def frame_camera(reads: dict, camera_values):
    """A program's camera, in its body: made from the 15 inputs among its
    staged values where it has them (``camera_make``, run first), else the
    Camera of tensors among its reads (``Scene._with_camera``)."""
    if camera_values:
        return camera_make(camera_values, camera_values[0].device)
    return reads["camera"]


def _frame_body(cfg: FrameConfig):
    """The frame program's body (the reference's ``_frame_fn``): the camera,
    the trace and the post stack; returns ((rgb8, FrameBuffers), the new
    state)."""
    def body(reads, st, values):
        index, keep, cam_in = values
        cam = frame_camera(reads, cam_in)
        rng, bufs = _trace_frame(cfg, program_world(reads), reads["mats"],
                                 reads["lights"], reads["sky"], cam,
                                 reads["bn"], st["rng"], index, cfg.spp)
        rgb8, den, accum = _post_frame(cfg, bufs, cam, index, st["prev_vp"],
                                       st["den"], st["accum"], keep)
        return (rgb8, bufs), {"rng": rng, "den": den, "accum": accum,
                              "prev_vp": cam.get_view_proj()}
    return body


def _chunk_body(cfg: FrameConfig, chunk: int):
    """A chunk program's body (the reference's ``_trace_split`` and its
    ``_init_accum`` / ``_accum_bufs``): ``chunk`` samples traced at the
    staged index and added to the frame's buffers (chunk 0, staged
    ``first``, starts them)."""
    def body(reads, st, values):
        index, first, cam_in = values
        cam = frame_camera(reads, cam_in)
        rng, bufs = _trace_frame(cfg, program_world(reads), reads["mats"],
                                 reads["lights"], reads["sky"], cam,
                                 reads["bn"], st["rng"], index, chunk)
        return None, {"rng": rng, "acc": _add_chunk(st["acc"], bufs, chunk,
                                                    cfg.spp, first != 0)}
    return body


def _post_body(cfg: FrameConfig):
    """The post program's body (the reference's ``_post_program``) on the
    chunk programs' buffers."""
    def body(reads, st, values):
        index, keep, cam_in = values
        cam = frame_camera(reads, cam_in)
        rgb8, den, accum = _post_frame(cfg, reads["acc"], cam, index,
                                       st["prev_vp"], st["den"],
                                       st["accum"], keep)
        return rgb8, {"den": den, "accum": accum,
                      "prev_vp": cam.get_view_proj()}
    return body


def _wire_body(width: int, height: int, device):
    """The wireframe program's body (the reference's
    ``_wireframe_program``): the camera's pinhole rays through K1, and K4
    on a world with instances; a hit within the staged thickness of an edge
    shows its material's emission if that is on, else white; everything
    else the gradient sky (staged top, bottom and switch).  Reinhard, gamma
    1/2.2, ``*255.99`` truncated, rows flipped: ((H, W, 3) uint8, None)."""
    def body(reads, st, values):
        thickness, top, bottom, use_sky, cam_in = values
        cam = frame_camera(reads, cam_in)
        s, t = pixel_grid(width, height, device)
        ray = cam.get_ray_simple(s, t)
        hit = traverse.intersect_closest(program_world(reads), ray.origin,
                                         ray.direction)
        w_bary = 1.0 - hit.u - hit.v
        edge = hit.hit & ((hit.u < thickness) | (hit.v < thickness)
                          | (w_bary < thickness))
        lanes = reads["mats"].gather(fmax(hit.mesh_index, 0))
        emissive = lanes.emission.x > 0.0
        edge_color = where(emissive, lanes.emission, Vec3.full(1.0))
        tsky = 0.5 * (ray.direction.y + 1.0)
        sky = lerp(Vec3(*bottom), Vec3(*top), tsky) * use_sky
        color = where(edge, edge_color, sky)
        color = color / (color + 1.0)
        g = 1.0 / 2.2
        arr = torch.stack([torch.pow(fmax(c, 0.0), g)
                           for c in (color.x, color.y, color.z)], dim=-1)
        img = torch.clamp(arr * 255.99, 0, 255).to(torch.uint8).flip(0)
        return img, None
    return body


@dataclass
class PerformanceSettings:
    enable_denoiser: bool = True
    enable_bloom: bool = True
    enable_motion_vectors: bool = True
    max_bounce_depth: int = 4
    samples_per_pixel: int = 1
    resolution_scale: float = 1.0
    # the reference's flag (kept for its API; nothing reads it: dynamic
    # meshes always take the incremental updates)
    fast_bvh_updates: bool = True
    enable_russian_roulette: bool = True
    russian_roulette_start_bounce: int = 1
    # True: bounce-0 hits receive analytic NEE (the reference's fix of its
    # camera-ray spec flag)
    camera_nee_fix: bool = True
    # with the denoiser OFF, display the running average of the frames since
    # the last edit or camera move; with it on, temporal history converges
    progressive_accumulation: bool = True


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
        self.env_map = None  # (H, W, 3) float32 numpy HDR
        self.env_rotation = 0.0
        # [env map, (rotation, use_sky), SkyConfig]: the sampling tables are
        # built once a map (the map held and compared by identity); for a
        # gradient [(top, bottom, use_sky), None, SkyConfig]
        self._sky_cache = None
        self.perf = PerformanceSettings()
        self.frame_count = 0
        # the camera: after set_camera its 15 host inputs (the programs make
        # it from them in their graphs; a read makes it once), else the
        # Camera assigned (copied into the programs' buffers)
        self._camera = None
        self._camera_inputs = camera_inputs((0.0, 0.0, 0.0), (0.0, 3.5, 5.0),
                                            aspect_ratio=width / height)
        self._geom = None
        self._geom_dirty = True
        self._mat_table = None
        self._mat_dirty = True
        self._light_table = None
        self._light_dirty = True
        # the incremental tables: the static world and its signature; by
        # id(mesh), a dynamic mesh's instance, transform bytes, build
        # generation, index, triangle count, local refit plan and whether
        # its own tables lag the merged set's; the merged set and its plans
        self._static_cache = None
        self._instance_cache = {}
        self._iset_cache = None
        self._inst_gen = 0
        self.stats_world_builds = 0  # static world BVH builds
        self.stats_blas_builds = 0  # instance BVH builds (host)
        self.stats_tlas_updates = 0  # transform-only instance updates
        self.stats_device_refits = 0  # refills refit on the device
        self.stats_device_lbvh_builds = 0  # Morton-sorted device refills
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
        # the FrameBuffers of the last rendered frame: on the card (and for
        # a chunked frame) a program's buffers, which the next frame
        # overwrites: clone what must outlive it
        self.last_frame: pl.FrameBuffers | None = None
        # the frame programs by configuration (render_frame_device), of the
        # current world's shapes
        self._programs = graphs.Programs()

    # -- scene edits ---------------------------------------------------------
    def add_mesh(self, mesh_or_path, material: Material | None = None) -> Mesh:
        """A ``Mesh``, or the path of an OBJ file to load."""
        mesh = (mesh_or_path if isinstance(mesh_or_path, Mesh)
                else Mesh(mesh_or_path))
        self.meshes.append(mesh)
        self.mesh_materials.append(material or Material())
        self._mark_geom_dirty()
        self._mat_dirty = True
        return mesh

    def add_triangles(self, tris, material: Material | None = None) -> Mesh:
        """A mesh of (N, 3, 3) triangles (three vertices each)."""
        return self.add_mesh(Mesh.from_triangles(np.asarray(tris)), material)

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

    def add_checkerboard_plane_xz(self, plane_y, tiles_per_side, tile_size,
                                  white_mat: Material, black_mat: Material):
        w, b = Mesh.checkerboard_plane_xz(plane_y, tiles_per_side, tile_size)
        self.add_mesh(w, white_mat)
        self.add_mesh(b, black_mat)

    def remove_mesh(self, mesh: Mesh) -> None:
        i = self.meshes.index(mesh)
        del self.meshes[i]
        del self.mesh_materials[i]
        self._mark_geom_dirty()
        self._mat_dirty = True

    def set_material(self, mesh: Mesh, material: Material) -> None:
        """Marks only the materials dirty, as the reference does: the
        shadow-opaque bit (transmission > 0.5) baked into the geometry
        follows at the next geometry rebuild."""
        i = self.meshes.index(mesh)
        self.mesh_materials[i] = material
        self._mat_dirty = True
        self.reset_accumulation()

    def add_point_light(self, position, color=(1, 1, 1), intensity=1.0,
                        range=100.0, radius=0.0) -> Light:
        lt = Light.point(position, color, intensity, range, radius)
        self.lights.append(lt)
        self.commit_light_changes()
        return lt

    def add_area_light(self, position, direction, width=1.0, height=1.0,
                       color=(1, 1, 1), intensity=1.0,
                       range=100.0) -> Light:
        """A rect area light emitting along ``direction`` (single-sided)."""
        lt = Light.area(position, direction, width, height, color, intensity,
                        range)
        self.lights.append(lt)
        self.commit_light_changes()
        return lt

    def add_directional_light(self, direction, color=(1, 1, 1),
                              intensity=1.0) -> Light:
        lt = Light.directional(direction, color, intensity)
        self.lights.append(lt)
        self.commit_light_changes()
        return lt

    def add_spot_light(self, position, direction, color=(1, 1, 1),
                       intensity=1.0, inner_cone=0.5, outer_cone=0.7,
                       range=100.0, radius=0.0) -> Light:
        """Cone angles in radians."""
        lt = Light.spot(position, direction, color, intensity, range,
                        inner_cone, outer_cone, radius)
        self.lights.append(lt)
        self.commit_light_changes()
        return lt

    @property
    def camera(self) -> Camera:
        """The scene's camera.  After ``set_camera`` it is made from its host
        inputs at the first read (``camera_make``: on the card one launch)
        and kept until the next; the frame programs do not read it then,
        but make it in their graphs."""
        if self._camera is None:
            self._camera = camera_make(self._camera_inputs, self.device)
        return self._camera

    @camera.setter
    def camera(self, cam: Camera) -> None:
        """A Camera of tensors on the scene's device, which the programs
        copy into their buffers (those leaves that changed)."""
        self._camera, self._camera_inputs = cam, None

    def set_camera(self, lookfrom, lookat, vup=(0, 1, 0), fov=60.0,
                   aperture=0.0, focus_dist=None) -> None:
        """Aim the camera: ``Camera.make``'s camera of these numbers, kept as
        its 15 host inputs, rounded to float32 (``camera_inputs``); no
        device work (the span ``camera.make``)."""
        with span("camera.make"):
            if focus_dist is None:
                focus_dist = float(np.linalg.norm(
                    np.asarray(lookat, np.float64)
                    - np.asarray(lookfrom, np.float64)))
            self._camera_inputs = camera_inputs(
                lookfrom, lookat, vup, fov, self.width / self.height,
                aperture, focus_dist)
            self._camera = None
            self.reset_accumulation()

    def set_sky_gradient(self, top, bottom) -> None:
        self.sky_color_top = tuple(top)
        self.sky_color_bottom = tuple(bottom)
        self.use_sky = True
        self.reset_accumulation()

    def set_sky_enabled(self, enabled: bool) -> None:
        """Sky radiance on or off (an HDRI's env NEE still runs, and sees
        black)."""
        self.use_sky = enabled
        self.reset_accumulation()

    def set_environment_map(self, env, rotation: float = 0.0) -> None:
        """Light the scene with an (H, W, 3) linear HDR equirect map
        (``utils/hdr.load_hdr`` reads a Radiance .hdr file), turned
        ``rotation`` radians about +y; it replaces the gradient sky."""
        self.env_map = np.asarray(env, np.float32)
        self.env_rotation = float(rotation)
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

    def set_max_bounce_depth(self, depth: int) -> None:
        self.perf.max_bounce_depth = int(np.clip(depth, 1, 16))

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

    # -- dirty tracking ------------------------------------------------------
    def _mark_geom_dirty(self) -> None:
        self._geom_dirty = True
        self.reset_accumulation()

    def commit_object_changes(self) -> None:
        """Take meshes' transform and vertex edits at the next frame."""
        self._mark_geom_dirty()

    def commit_material_changes(self) -> None:
        self._mat_dirty = True
        self.reset_accumulation()

    def commit_light_changes(self) -> None:
        self._light_dirty = True
        self.reset_accumulation()

    # -- device state --------------------------------------------------------
    def _ensure_device_state(self) -> None:
        if self._geom_dirty or self._geom is None:
            self._rebuild_geometry()
            self._geom_dirty = False
        if self._mat_dirty or self._mat_table is None:
            self._mat_table = MaterialTable.from_materials(
                self.mesh_materials, self.device)
            self._mat_dirty = False
        if self._light_dirty or self._light_table is None:
            self._light_table = LightTable.from_lights(self.lights,
                                                       self.device)
            self._light_dirty = False
        self._ensure_rng_state()

    def _ensure_rng_state(self) -> None:
        """The per-pixel PCG state, seeded anew when the render size
        changed."""
        rh, rw = self.render_size
        if self._rng_state is None or tuple(self._rng_state.shape) != (rh,
                                                                       rw):
            ys, xs = torch.meshgrid(torch.arange(rh, device=self.device),
                                    torch.arange(rw, device=self.device),
                                    indexing="ij")
            self._rng_state = prng.seed(xs, ys, 0)

    def _rebuild_geometry(self) -> None:
        """The two-level incremental update (the reference's
        ``_rebuild_geometry``): the static meshes share one world BVH,
        rebuilt only when a static mesh's vertices, transform or index
        change; each dynamic mesh keeps a local BVH, built on the host only
        when it is new or its triangle count changes.  A transform edit
        replaces its matrix rows; a refill of the same count refits the
        merged set's tables in place on the device (K5: ``refit_apply``,
        or ``lbvh_update`` with ``device_lbvh``).  The set is merged again
        only when an instance is built or the set changes; an instance
        refit since the last merge takes its tables from the old set."""
        trans = [m.transmission for m in self.mesh_materials]
        static = [(i, m) for i, m in enumerate(self.meshes)
                  if not m.is_dynamic]
        # a mesh's index is its baked material id: a removal moves it
        sig = tuple((i, id(m), m.transform.world_matrix().tobytes())
                    for i, m in static)
        if (self._static_cache is None or self._static_cache[1] != sig
                or any(m.verts_dirty for _, m in static)):
            sg = assemble_geometry([m for _, m in static], trans, self.device,
                                   mesh_ids=[i for i, _ in static])
            self._static_cache = (sg, sig)
            self.stats_world_builds += 1
            for _, m in static:
                m.verts_dirty = False

        new_cache, instances, entries, refits = {}, [], [], []
        for i, m in enumerate(self.meshes):
            if not m.is_dynamic:
                continue
            tbytes = m.transform.world_matrix().tobytes()
            entry = self._instance_cache.get(id(m))
            if entry is not None and entry["gid"] != i:
                entry = None  # its baked mesh id moved
            if (entry is not None and m.verts_dirty
                    and entry["tris"] == m.num_triangles):
                # a fixed-topology refill: refit on the device below
                entry = dict(entry, tb=tbytes, inst=scene_geom.
                             update_instance_transform(entry["inst"], m))
                refits.append((len(instances), m))
                self.stats_device_refits += 1
                self.stats_device_lbvh_builds += int(m.device_lbvh)
                m.verts_dirty = False
            elif entry is None or m.verts_dirty:
                inst = scene_geom.assemble_instance(m, i, trans, self.device)
                self._inst_gen += 1
                entry = dict(inst=inst, tb=tbytes, gen=self._inst_gen,
                             gid=i, tris=m.num_triangles,
                             plan=build_refit_plan(inst.geom), stale=False)
                self.stats_blas_builds += 1
                m.verts_dirty = False
            elif entry["tb"] != tbytes:
                entry = dict(entry, tb=tbytes, inst=scene_geom.
                             update_instance_transform(entry["inst"], m))
                self.stats_tlas_updates += 1
            new_cache[id(m)] = entry
            instances.append(entry["inst"])
            entries.append(entry)
        self._instance_cache = new_cache

        if not instances:
            self._iset_cache = None
            self._geom = self._static_cache[0]
            return
        gens = tuple(e["gen"] for e in entries)
        cache = self._iset_cache
        if cache is not None and cache["gens"] == gens:
            iset = scene_geom.update_instance_set_transforms(
                cache["iset"], tuple(instances))
            plans = cache["plans"]
        else:
            if cache is not None:
                # instances refit since the last merge: their current
                # tables live only in the old set
                old = {g: k for k, g in enumerate(cache["gens"])}
                for e in entries:
                    if e["stale"] and e["gen"] in old:
                        k = old[e["gen"]]
                        g = scene_geom.split_instance(
                            cache["iset"].geom, cache["plans"][k],
                            e["inst"].geom)
                        e["inst"] = dataclasses.replace(e["inst"], geom=g)
                        e["stale"] = False
                instances = [e["inst"] for e in entries]
            iset = scene_geom.merge_instances(tuple(instances))
            plans = _merged_refit_plans(entries)
        for pos, m in refits:
            verts = torch.from_numpy(np.stack(m.triangle_arrays(
                world=False))).to(self.device)
            apply = lbvh_update if m.device_lbvh else refit_apply
            apply(iset.geom, plans[pos], verts[0], verts[1], verts[2])
            entries[pos]["stale"] = True
        self._iset_cache = dict(gens=gens, iset=iset, plans=plans)
        self._geom = scene_geom.WorldGeometry(
            static=self._static_cache[0], instances=tuple(instances),
            iset=iset)

    def sky(self) -> SkyConfig:
        """The sky's device tables, made again only when the sky changed
        (a gradient's colours and switch; an HDRI map by identity, then its
        rotation and switch)."""
        if self.env_map is None:
            key = (self.sky_color_top, self.sky_color_bottom,
                   bool(self.use_sky))
            cached = self._sky_cache
            if cached is None or cached[1] is not None or cached[0] != key:
                self._sky_cache = [key, None, SkyConfig.gradient(
                    self.sky_color_top, self.sky_color_bottom, self.use_sky,
                    device=self.device)]
            return self._sky_cache[2]
        key = (self.env_rotation, bool(self.use_sky))
        cached = self._sky_cache
        if cached is None or cached[0] is not self.env_map:
            # the map to the device and its sampling tables, once a map
            sky = SkyConfig.hdri(self.env_map, self.env_rotation,
                                 use_sky=bool(self.use_sky),
                                 device=self.device)
            self._sky_cache = [self.env_map, key, sky]
        elif cached[1] != key:
            f32 = lambda v: torch.tensor(v, dtype=torch.float32,
                                         device=self.device)
            cached[2] = dataclasses.replace(
                cached[2], env_rotation=f32(self.env_rotation),
                use_sky=f32(1.0 if self.use_sky else 0.0))
            cached[1] = key
        return self._sky_cache[2]

    # -- rendering -----------------------------------------------------------
    def _config(self, progressive: bool) -> FrameConfig:
        """The frame's static configuration (a program's key)."""
        p = self.perf
        denoise = bool(p.enable_denoiser)
        return FrameConfig(
            render_size=self.render_size, size=(self.height, self.width),
            spp=int(p.samples_per_pixel), depth=int(p.max_bounce_depth),
            denoise=denoise, bloom=bool(p.enable_bloom),
            motion_vectors=bool(p.enable_motion_vectors),
            n_lights=len(self.lights),
            rr_enabled=bool(p.enable_russian_roulette),
            rr_start=int(p.russian_roulette_start_bounce),
            camera_nee=bool(p.camera_nee_fix),
            progressive=bool(progressive) and not denoise,
            den_settings=self.denoiser_settings or DEFAULT_SETTINGS)

    def _ensure_denoiser_state(self, cfg: FrameConfig) -> None:
        """The SVGF history, made when the denoiser is on and there is none
        of the render size (before a program is made, as the reference
        makes it before its first frame program)."""
        if cfg.denoise and (self._denoiser_state is None
                            or tuple(self._denoiser_state.depth.shape)
                            != cfg.render_size):
            self._denoiser_state = init_denoiser_state(*cfg.render_size,
                                                       self.device)

    def _trace(self, geom, camera, frame_index, cfg: FrameConfig,
               mesh=None) -> pl.FrameBuffers:
        """The frame's trace of ``geom`` from ``camera``, eagerly: one
        ``trace_frame`` up to ``SPP_DISPATCH_MAX`` spp, else one a chunk
        (``spp_chunks``, ``_add_chunk``).  With ``mesh`` (a
        ``parallel.sharding.PixelMesh``) each trace runs tile by tile, a
        tile a device and stream, and is put together on the scene's
        device: the same pixels bit for bit."""
        rh, rw = cfg.render_size
        tables = (geom, self._mat_table, self._light_table, self.sky(),
                  camera, self._blue_noise)

        def trace(samples: int, offset: int) -> pl.FrameBuffers:
            if mesh is None:
                self._rng_state, bufs = _trace_frame(
                    cfg, *tables, self._rng_state, frame_index + offset,
                    samples)
                return bufs
            fn = sharding.shard_mapped_trace(
                mesh, rh, rw, lambda st, *a, tile: _trace_frame(
                    cfg, *a, st, frame_index + offset, samples, tile=tile))
            state, bufs = fn(self._rng_state, *tables)
            self._rng_state = sharding.gather_pixels(mesh, state)
            return sharding.gather_pixels(mesh, bufs)

        if cfg.spp <= SPP_DISPATCH_MAX:
            return trace(cfg.spp, 0)
        acc, off = None, 0
        for c in spp_chunks(cfg.spp):
            acc = _add_chunk(acc, trace(c, off), c, cfg.spp)
            off += c
        return acc

    def render_frame_device(self, mesh=None) -> torch.Tensor:
        """One frame -> (H, W, 3) uint8 tensor on the scene's device, its
        own (the next frame does not overwrite it).  The frame runs as a
        program kept per configuration (``Scene._programs``; the
        reference's ``_frame_program``, and above ``SPP_DISPATCH_MAX`` spp
        its chunk and post programs): on the card the first frame of a
        configuration warms its body up and captures it into a CUDA graph,
        and every later frame is one replay; on the CPU the program calls
        the body.  With ``mesh`` the frame runs eagerly over that pixel
        mesh (``render_world``)."""
        self._ensure_device_state()
        if mesh is not None:
            img = self.render_world(self._geom, self.camera,
                                    self.frame_count, self.prev_view_proj,
                                    bool(self.perf.progressive_accumulation),
                                    mesh=mesh)
            self.prev_view_proj = self.camera.get_view_proj()
        else:
            img = self._program_frame()
        self.frame_count += 1
        return img

    def render_world(self, geom, camera, frame_index, prev_view_proj,
                     progressive: bool = False, mesh=None) -> torch.Tensor:
        """The frame body (the reference's ``_frame_fn``), run eagerly: one
        frame of a given world ``geom`` (a ``SceneGeometry`` or
        ``WorldGeometry`` on the scene's device) seen by ``camera`` ->
        (H, W, 3) uint8 on the device: the trace at frame index
        ``frame_index`` (a Python int, or a 0-d integer tensor on the
        scene's device, the same bits: a frame captured into a CUDA graph
        reads it there), the progressive average (with ``progressive`` and
        the denoiser off), motion vectors against ``prev_view_proj``, SVGF,
        bloom, the upscale and the tonemap.  It advances the RNG state and
        the denoiser history and sets ``last_frame``; it leaves the frame
        count, ``prev_view_proj`` and the scene's own geometry as they are
        (the caller's), and rebuilds no table: the materials, lights and
        sky must be current (``_ensure_device_state``).  ``mesh``: a pixel
        mesh (``parallel.sharding.make_pixel_mesh``, its first device the
        scene's) that the trace runs over, a tile a device and stream, as
        the reference's ``_frame_fn(mesh=)``; the post stack stays whole on
        the scene's device, and the frame is the unmeshed one bit for
        bit."""
        if mesh is not None and mesh.first_device != self.device:
            raise ValueError(f"the mesh's first device {mesh.first_device} "
                             f"is not the scene's {self.device}")
        self._ensure_rng_state()
        cfg = self._config(progressive)
        self._ensure_denoiser_state(cfg)
        bufs = self._trace(geom, camera, frame_index, cfg, mesh)
        self.last_frame = bufs
        accum = (self._accum_now(cfg.render_size) if cfg.progressive
                 else None)
        rgb8, den, accum = _post_frame(cfg, bufs, camera, frame_index,
                                       prev_view_proj, self._denoiser_state,
                                       accum)
        if cfg.denoise:
            self._denoiser_state = den
        if cfg.progressive:
            self._accum, self._accum_view_proj = accum[:2], accum[2]
        return rgb8

    def _accum_now(self, render_size: tuple):
        """(sum, count, view-projection) the next frame's average adds to,
        or None where it restarts (after ``reset_accumulation``, or at
        another render size)."""
        if (self._accum is None or self._accum_view_proj is None
                or tuple(self._accum[0].x.shape) != render_size):
            return None
        return (*self._accum, self._accum_view_proj)

    def _accumulate(self, color, rh: int, rw: int, camera=None):
        """Add the frame to the progressive sum and return the running
        average (``accumulate``).  The sum restarts when the
        view-projection's VALUES change (the camera moved, whichever way it
        was set) or the render size changed.  ``camera``: the frame's (by
        default the scene's)."""
        view_proj = (camera or self.camera).get_view_proj()
        avg, accum = accumulate(color, view_proj, self._accum_now((rh, rw)))
        self._accum, self._accum_view_proj = accum[:2], accum[2]
        return avg

    # -- the programs --------------------------------------------------------
    def _frame_reads(self) -> dict:
        """What a frame program reads, grouped: the static world, the merged
        instance set's tables (``set_geom``: K5's refits write them in
        place) and its other tables, the materials, lights, sky and blue
        noise (the camera: ``_with_camera``)."""
        g = self._geom
        iset = traverse.iset_of(g)
        return {"static": traverse.static_of(g),
                "iset": (None if iset is None
                         else dataclasses.replace(iset, geom=None)),
                "set_geom": None if iset is None else iset.geom,
                "mats": self._mat_table, "lights": self._light_table,
                "sky": self.sky(), "bn": self._blue_noise}

    def _with_camera(self, key: tuple, reads: dict, *values) -> tuple:
        """A program's key, reads and host values (tuples, one per run of
        its) with the camera added as the program takes it, by the
        camera's form: (key, reads, *values).  After ``set_camera`` each
        value ends in the 15 host inputs, which the body makes the camera
        from in its graph (``frame_camera``); after a Camera was assigned
        it is the read "camera" (copied into the program's buffers), each
        value ends in (), and the key in the Camera's ``signature``.  A
        program is kept per form, so a switch between the two makes no
        program again."""
        if self._camera_inputs is not None:
            cam_in = self._camera_inputs
        else:
            cam_in = ()
            key += (graphs.signature(self._camera),)
            reads = dict(reads, camera=self._camera)
        return (key, reads, *(v + (cam_in,) for v in values))

    def _program(self, key: tuple, world: tuple, make) -> graphs.Program:
        """The program of ``key`` on a world of signature ``world`` (of
        ``_frame_reads``), made by ``make()`` at its first frame
        (``graphs.Programs``: those of a world whose shapes changed are
        dropped)."""
        return self._programs.program(key, world, make)

    def _program_frame(self) -> torch.Tensor:
        """One frame through the programs of its configuration: the frame
        program, or the chunk programs and the post program above
        ``SPP_DISPATCH_MAX`` spp.  Afterwards the scene's PCG state,
        denoiser history, progressive average and ``prev_view_proj`` are
        the programs' buffers, and ``last_frame`` their FrameBuffers.
        Spans: ``frame.select`` (the configuration, the reads, their
        signature and the frame program's lookup, so its capture at its
        first frame; the chunk and post programs are looked up, and made,
        after it), the programs' own, ``frame.clone`` (the RGB8's copy).
        One ``gpu_frame`` holds every program run of the frame; the frame is
        counted by its camera's form (``logging.camera_frame``)."""
        with span("frame.select"):
            cfg = self._config(bool(self.perf.progressive_accumulation))
            self._ensure_denoiser_state(cfg)
            world_reads = self._frame_reads()
            world = graphs.signature(world_reads)
            accum = (self._accum_now(cfg.render_size) if cfg.progressive
                     else None)
            keep = int(accum is not None)
            key, reads, first, values = self._with_camera(
                ("frame", cfg), world_reads, (0, 0), (self.frame_count, keep))
            state = {"den": self._denoiser_state if cfg.denoise else None,
                     "accum": accum, "prev_vp": self.prev_view_proj}
            # the buffers a new program starts from: the progressive
            # average's exist before its first frame (a restart selects
            # this frame)
            init = dict(state, accum=(_zero_accum(cfg, self.device)
                                      if cfg.progressive else None))
            prog = None if cfg.spp > SPP_DISPATCH_MAX else self._program(
                key, world, lambda: graphs.Program(
                    _frame_body(cfg), reads, dict(init, rng=self._rng_state),
                    first, self.device, edited=("set_geom",)))
        with gpu_frame(self.device):
            if prog is not None:
                rgb8, bufs = prog.run(reads,
                                      dict(state, rng=self._rng_state),
                                      values)
                self._rng_state = prog.state["rng"]
            else:
                bufs = None
                off = 0
                for k, c in enumerate(spp_chunks(cfg.spp)):
                    key, reads, first, values = self._with_camera(
                        ("chunk", cfg, c), world_reads, (0, 0),
                        (self.frame_count + off, int(k == 0)))
                    prog = self._program(key, world, lambda: graphs.Program(
                        _chunk_body(cfg, c), reads,
                        {"rng": self._rng_state,
                         "acc": _zero_buffers(cfg, self.device)},
                        first, self.device, edited=("set_geom",)))
                    prog.run(reads, {"rng": self._rng_state, "acc": bufs},
                             values)
                    self._rng_state = prog.state["rng"]
                    bufs = prog.state["acc"]
                    off += c
                # the chunk programs write their buffers in place
                key, reads, first, values = self._with_camera(
                    ("post", cfg), {"acc": bufs}, (0, 0),
                    (self.frame_count, keep))
                prog = self._program(key, world, lambda: graphs.Program(
                    _post_body(cfg), reads, init, first, self.device,
                    edited=("acc",)))
                rgb8 = prog.run(reads, state, values)
        camera_frame("copied" if "camera" in reads else "made")
        st = prog.state
        if cfg.denoise:
            self._denoiser_state = st["den"]
        if cfg.progressive:
            self._accum = st["accum"][:2]
            self._accum_view_proj = st["accum"][2]
        self.prev_view_proj = st["prev_vp"]
        self.last_frame = bufs
        if prog.graph is None:
            return rgb8
        with span("frame.clone"):
            return rgb8.clone()

    def warmup(self, block: bool = True):
        """Render one throwaway frame of the current configuration (on the
        card this builds the kernels at their first use and makes and
        captures its programs) and restore every piece of progressive
        state, as copies: the frame count, the RNG state, the denoiser
        history, the progressive average and the view-projection it was
        taken under, ``prev_view_proj`` and ``last_frame``.  The next frame
        copies them into the programs' buffers and is bit-identical to an
        unwarmed scene's.  ``block=False`` renders on a background thread
        and returns it (join it before rendering)."""
        def go():
            saved = graphs.clone_tree((
                self._rng_state, self._denoiser_state, self._accum,
                self._accum_view_proj, self.prev_view_proj, self.last_frame))
            count = self.frame_count
            try:
                self.render_frame_device()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            finally:
                self.frame_count = count
                (self._rng_state, self._denoiser_state, self._accum,
                 self._accum_view_proj, self.prev_view_proj,
                 self.last_frame) = saved

        if block:
            go()
            return None
        import threading

        t = threading.Thread(target=go, daemon=True)
        t.start()
        return t

    def _wire_inputs(self, thickness: float) -> tuple:
        """The wireframe program's key and its body's inputs, the camera
        taken as ``_with_camera`` gives it: (the key; its reads, of
        ``_frame_reads``; the signature of ``_frame_reads``, the world its
        program is kept under, so that a wireframe keeps the frame
        programs; its host values: the thickness, the sky's top and bottom
        colours and its switch, the camera's inputs)."""
        self._ensure_device_state()
        reads = self._frame_reads()
        world = graphs.signature(reads)
        key, reads, values = self._with_camera(
            ("wire", self.width, self.height),
            {k: reads[k] for k in ("static", "iset", "set_geom", "mats")},
            (float(thickness), tuple(float(c) for c in self.sky_color_top),
             tuple(float(c) for c in self.sky_color_bottom),
             1.0 if self.use_sky else 0.0))
        return key, reads, world, values

    def _wireframe_device(self, thickness: float) -> torch.Tensor:
        """The wireframe through its program: on the card the program's
        output, which its next run overwrites."""
        key, reads, world, values = self._wire_inputs(thickness)
        prog = self._program(
            key, world,
            lambda: graphs.Program(_wire_body(self.width, self.height,
                                              self.device),
                                   reads, None, values, self.device,
                                   edited=("set_geom",)))
        return prog.run(reads, None, values)

    def render_wireframe(self, thickness: float = 0.05) -> np.ndarray:
        """The barycentric-edge wireframe of the camera's pinhole rays
        (``_wire_body``: K1, and K4 on a world with instances) -> (H, W, 3)
        uint8 on the host.  It runs as a program kept in
        ``Scene._programs`` under ``("wire", width, height)`` (the
        reference's ``_wireframe_program``; an assigned Camera's signature
        after them, ``_with_camera``), beside the frame programs of the
        same world: on the card its first call captures a CUDA graph and
        every later call is one replay; on the CPU the program calls the
        body.  A thickness, sky or camera change is a new
        value or read, not a new program; a resize is a new key.  With a
        viewer's six frame programs one world holds seven, within
        ``graphs.PROGRAMS_KEPT``."""
        return self._wireframe_device(thickness).cpu().numpy()

    def trace_single_ray(self, origin, direction) -> traverse.Hit:
        """One ray (the direction normalised on the host) through K1, and
        K4 on a world with instances, for picking and gameplay raycasts:
        the ``Hit`` with each field a numpy scalar (``point`` and
        ``normal`` Vec3s of them)."""
        self._ensure_device_state()
        f32 = lambda v: torch.tensor([float(v)], dtype=torch.float32,
                                     device=self.device)
        dn = np.asarray(direction, np.float64)
        dn = dn / max(np.linalg.norm(dn), 1e-12)
        hit = traverse.intersect_closest(
            self._geom, Vec3(*[f32(c) for c in origin]),
            Vec3(*[f32(c) for c in dn]))
        first = lambda a: (a.map(first) if isinstance(a, Vec3)
                           else a.cpu().numpy()[0])
        return traverse.Hit(**{f.name: first(getattr(hit, f.name))
                               for f in dataclasses.fields(hit)})

    def render_frame(self, mesh=None) -> np.ndarray:
        """One interactive frame -> (H, W, 3) uint8 on the host (``mesh``:
        as ``render_world``'s)."""
        return self.render_frame_device(mesh).cpu().numpy()

    def render(self, out_path: str | None = None) -> np.ndarray:
        """``render_frame``, also written to ``out_path`` as a PPM."""
        img = self.render_frame()
        if out_path:
            save_ppm(out_path, img)
        return img

    def render_average(self, frames: int) -> np.ndarray:
        """The mean of ``frames`` independent traces (unsplit, roulette from
        bounce 2, no post stack), tonemapped: a ground-truth helper."""
        self._ensure_device_state()
        rh, rw = self.render_size
        acc = None
        for _ in range(frames):
            self._ensure_device_state()
            self._rng_state, bufs = pl.trace_frame(
                self._geom, self._mat_table, self._light_table,
                len(self.lights), self.sky(), self.camera, self._rng_state,
                self.frame_count, rw, rh, int(self.perf.samples_per_pixel),
                int(self.perf.max_bounce_depth), self._blue_noise,
                camera_nee=bool(self.perf.camera_nee_fix))
            self.frame_count += 1
            acc = bufs.color if acc is None else acc + bufs.color
        hdr = acc * (1.0 / float(frames))
        if (rh, rw) != (self.height, self.width):
            hdr = pl.upscale_bilinear(hdr, self.height, self.width)
        return pl.tonemap_to_rgb8(hdr).cpu().numpy()

    def save_as_ppm(self, path: str, img: np.ndarray | None = None) -> None:
        """Write ``img`` (a new frame if None) as an ASCII PPM."""
        if img is None:
            img = self.render_frame()
        save_ppm(path, img)
