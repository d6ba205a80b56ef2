"""Unified scene layer: renderer-agnostic scene description + builders.

Counterpart of ``ptrt_tpu/scene/unified.py`` (itself a rebuild of
``common/PTRTtransfer.cuh``): ``UnifiedTransform``, ``UnifiedLight``
factories, ``UnifiedCameraConfig`` (+orbit), ``UnifiedMeshDesc`` (ObjFile /
Cube / PlaneXZ / Sphere / Triangles), ``UnifiedSkyConfig``,
``ObjectHandle`` / ``LightHandle`` fluent edits with dirty-marking,
``Keyframe``/``EaseType`` animation, the ``UnifiedScene`` store, and
builders into either backend of this package (``build_pt_scene`` /
``update_pt_scene`` into ``Scene``, ``build_rt_scene`` /
``update_rt_scene`` into ``RTScene``).  The description is host data
only; the same ``UnifiedScene`` built by either package gives the same
scene tables.

The builders take the scene's ``device``: the card by default, ``"cpu"``
for the plain torch versions of the kernels.  Area lights keep their
rectangle (sampled with a solid-angle pdf and MIS by the PT backend).

The material preset library lives in scene/materials.py (UnifiedMaterial and
the backend Material are the same 17 fields; this module aliases it).
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from enum import Enum, IntEnum
from typing import Dict, List, Optional

import numpy as np

from ptrt_tpu_torch.geometry.mesh import Mesh
from ptrt_tpu_torch.geometry.transform import Transform3D
from ptrt_tpu_torch.scene.lights import Light, LightType
from ptrt_tpu_torch.scene.materials import Material, Materials
from ptrt_tpu_torch.scene.pt_scene import Scene as PTScene
from ptrt_tpu_torch.scene.rt_scene import RTScene

UnifiedMaterial = Material  # identical field set (PTRTtransfer.cuh:242-265)
_DEG = math.pi / 180.0


@dataclass
class UnifiedTransform:
    """``PTRTtransfer.cuh:29-132`` — TRS with Euler radians."""

    position: tuple = (0.0, 0.0, 0.0)
    rotation: tuple = (0.0, 0.0, 0.0)
    scale: tuple = (1.0, 1.0, 1.0)

    def set_position(self, x, y=None, z=None):
        self.position = tuple(x) if y is None else (x, y, z)
        return self

    def set_rotation(self, x, y=None, z=None):
        self.rotation = tuple(x) if y is None else (x, y, z)
        return self

    def set_rotation_degrees(self, x, y=None, z=None):
        r = tuple(x) if y is None else (x, y, z)
        self.rotation = tuple(c * _DEG for c in r)
        return self

    def set_scale(self, s, sy=None, sz=None):
        if sy is None:
            if isinstance(s, (tuple, list)):
                self.scale = tuple(s)
            else:
                self.scale = (s, s, s)
        else:
            self.scale = (s, sy, sz)
        return self

    def translate(self, dx, dy, dz):
        p = self.position
        self.position = (p[0] + dx, p[1] + dy, p[2] + dz)
        return self

    def rotate(self, dx, dy, dz):
        r = self.rotation
        self.rotation = (r[0] + dx, r[1] + dy, r[2] + dz)
        return self

    def rotate_degrees(self, dx, dy, dz):
        return self.rotate(dx * _DEG, dy * _DEG, dz * _DEG)

    def is_identity(self) -> bool:
        eps = 1e-6
        return (all(abs(c) < eps for c in self.position)
                and all(abs(c) < eps for c in self.rotation)
                and all(abs(c - 1.0) < eps for c in self.scale))

    @staticmethod
    def lerp(a: "UnifiedTransform", b: "UnifiedTransform",
             t: float) -> "UnifiedTransform":
        mix = lambda u, v: tuple(u[i] + (v[i] - u[i]) * t for i in range(3))
        return UnifiedTransform(mix(a.position, b.position),
                                mix(a.rotation, b.rotation),
                                mix(a.scale, b.scale))

    def copy(self) -> "UnifiedTransform":
        return UnifiedTransform(self.position, self.rotation, self.scale)


class UnifiedLightType(IntEnum):
    Point = 0
    Directional = 1
    Spot = 2
    Area = 3


@dataclass
class UnifiedLight:
    """``PTRTtransfer.cuh:134-240``.  Spot cones are raw cosines here, like
    the reference's unified layer (the backend Scene APIs take degrees)."""

    type: UnifiedLightType = UnifiedLightType.Point
    position: tuple = (0.0, 10.0, 0.0)
    direction: tuple = (0.0, -1.0, 0.0)
    color: tuple = (1.0, 1.0, 1.0)
    intensity: float = 1.0
    range: float = 100.0
    inner_cone: float = 0.5
    outer_cone: float = 0.7
    radius: float = 0.0
    area_u: tuple = (1.0, 0.0, 0.0)
    area_v: tuple = (0.0, 0.0, 1.0)
    area_width: float = 1.0
    area_height: float = 1.0
    animated: bool = False
    name: str = ""

    @staticmethod
    def Point(pos, col, intensity=1.0, range=100.0, radius=0.0):
        return UnifiedLight(UnifiedLightType.Point, tuple(pos),
                            color=tuple(col), intensity=intensity,
                            range=range, radius=radius)

    @staticmethod
    def Directional(dir, col, intensity=1.0):
        d = _norm(dir)
        return UnifiedLight(UnifiedLightType.Directional, direction=d,
                            color=tuple(col), intensity=intensity)

    @staticmethod
    def Spot(pos, dir, col, intensity=1.0, inner_cone=0.5, outer_cone=0.7,
             range=100.0, radius=0.0):
        return UnifiedLight(UnifiedLightType.Spot, tuple(pos), _norm(dir),
                            tuple(col), intensity, range, inner_cone,
                            outer_cone, radius)

    @staticmethod
    def Area(pos, dir, col, width, height, intensity=1.0):
        d = _norm(dir)
        up = (0, 1, 0) if abs(d[1]) < 0.999 else (1, 0, 0)
        au = _norm(np.cross(up, d))
        av = _norm(np.cross(d, au))
        return UnifiedLight(
            UnifiedLightType.Area, tuple(pos), d, tuple(col), intensity,
            area_u=tuple(np.asarray(au) * width),
            area_v=tuple(np.asarray(av) * height),
            area_width=width, area_height=height)

    # fluent edits
    def move_to(self, pos):
        self.position = tuple(pos)
        return self

    def set_direction(self, dir):
        self.direction = _norm(dir)
        return self

    def set_color(self, col):
        self.color = tuple(col)
        return self

    def set_intensity(self, i):
        self.intensity = float(i)
        return self


def _norm(v) -> tuple:
    a = np.asarray(v, np.float64)
    return tuple(a / max(np.linalg.norm(a), 1e-12))


@dataclass
class UnifiedCameraConfig:
    """``PTRTtransfer.cuh:645-702``."""

    lookfrom: tuple = (0.0, 0.0, 0.0)
    lookat: tuple = (0.0, 0.0, -1.0)
    vup: tuple = (0.0, 1.0, 0.0)
    vfov: float = 60.0
    aperture: float = 0.003125
    focus_dist: float = 1.0
    near_clip: float = 0.1
    far_clip: float = 1000.0

    def set_position(self, pos):
        self.lookfrom = tuple(pos)
        return self

    def set_target(self, target):
        self.lookat = tuple(target)
        return self

    def set_fov(self, fov):
        self.vfov = float(fov)
        return self

    def set_dof(self, aperture, focus_dist):
        self.aperture = float(aperture)
        self.focus_dist = float(focus_dist)
        return self

    def orbit(self, center, distance, azimuth, elevation):
        ca, sa = math.cos(azimuth), math.sin(azimuth)
        ce, se = math.cos(elevation), math.sin(elevation)
        self.lookfrom = (center[0] + distance * ce * ca,
                         center[1] + distance * se,
                         center[2] + distance * ce * sa)
        self.lookat = tuple(center)
        return self


class MeshType(Enum):
    ObjFile = "obj"
    Cube = "cube"
    PlaneXZ = "plane_xz"
    PlaneXY = "plane_xy"
    PlaneYZ = "plane_yz"
    Sphere = "sphere"
    Triangles = "triangles"


@dataclass
class UnifiedMeshDesc:
    """``PTRTtransfer.cuh:704-839``."""

    type: MeshType = MeshType.Cube
    obj_path: str = ""
    triangle_verts: Optional[np.ndarray] = None  # (N*3, 3) world-space
    plane_y: float = 0.0
    plane_half_size: float = 50.0
    sphere_segments: int = 32
    material: Material = field(default_factory=Material)
    material_ref: str = ""
    transform: UnifiedTransform = field(default_factory=UnifiedTransform)
    name: str = ""
    is_dynamic: bool = False
    casts_shadows: bool = True
    receives_shadows: bool = True

    @staticmethod
    def FromOBJ(path, mat: Material | None = None):
        return UnifiedMeshDesc(MeshType.ObjFile, obj_path=path,
                               material=mat or Material())

    @staticmethod
    def Cube(mat: Material | None = None):
        return UnifiedMeshDesc(MeshType.Cube, material=mat or Material())

    @staticmethod
    def PlaneXZ(y, half_size, mat: Material | None = None):
        return UnifiedMeshDesc(MeshType.PlaneXZ, plane_y=y,
                               plane_half_size=half_size,
                               material=mat or Material())

    @staticmethod
    def Sphere(segments=32, mat: Material | None = None):
        return UnifiedMeshDesc(MeshType.Sphere, sphere_segments=segments,
                               material=mat or Material())

    @staticmethod
    def Triangles(tris, mat: Material | None = None):
        """Per-frame procedural geometry hook (fluid surfaces —
        ``PTRTtransfer.cuh:2250-2270``)."""
        d = UnifiedMeshDesc(MeshType.Triangles, material=mat or Material())
        d.triangle_verts = np.asarray(tris, np.float32).reshape(-1, 3)
        d.is_dynamic = True
        return d

    # fluent
    def set_position(self, pos):
        self.transform.set_position(pos)
        return self

    def set_rotation(self, rot):
        self.transform.set_rotation(rot)
        return self

    def set_rotation_degrees(self, deg):
        self.transform.set_rotation_degrees(deg)
        return self

    def set_scale(self, s):
        self.transform.set_scale(s)
        return self

    def set_transform(self, t: UnifiedTransform):
        self.transform = t
        return self

    def set_name(self, n):
        self.name = n
        return self

    def set_dynamic(self, dynamic=True):
        self.is_dynamic = dynamic
        return self

    def set_material(self, mat: Material):
        self.material = mat
        return self


@dataclass
class UnifiedSkyConfig:
    """``PTRTtransfer.cuh:841-848``."""

    enabled: bool = True
    top_color: tuple = (0.6, 0.7, 1.0)
    bottom_color: tuple = (1.0, 1.0, 1.0)
    hdri_path: str = ""
    hdri_intensity: float = 1.0
    hdri_rotation: float = 0.0


class ObjectHandle:
    """``PTRTtransfer.cuh:852-884, 1392-1520`` — index+scene handle with
    fluent edits that mark the mesh dirty."""

    def __init__(self, index: int = -1, scene: "UnifiedScene" = None):
        self.index = index
        self.scene = scene

    def is_valid(self) -> bool:
        return self.scene is not None and self.index >= 0

    def _mesh(self) -> UnifiedMeshDesc:
        return self.scene.meshes[self.index]

    def _dirty(self):
        self.scene.mark_mesh_dirty(self.index)
        return self

    def set_position(self, pos):
        self._mesh().transform.set_position(pos)
        return self._dirty()

    def set_rotation(self, rot):
        self._mesh().transform.set_rotation(rot)
        return self._dirty()

    def set_rotation_degrees(self, deg):
        self._mesh().transform.set_rotation_degrees(deg)
        return self._dirty()

    def set_scale(self, s):
        self._mesh().transform.set_scale(s)
        return self._dirty()

    def translate(self, delta):
        self._mesh().transform.translate(*delta)
        return self._dirty()

    def rotate(self, delta_rad):
        self._mesh().transform.rotate(*delta_rad)
        return self._dirty()

    def rotate_degrees(self, delta_deg):
        self._mesh().transform.rotate_degrees(*delta_deg)
        return self._dirty()

    def get_transform(self) -> UnifiedTransform:
        return self._mesh().transform.copy()

    def get_position(self) -> tuple:
        return self._mesh().transform.position

    def set_material(self, mat: Material):
        self._mesh().material = mat
        self.scene.materials_dirty = True
        return self

    def use_library_material(self, name: str):
        self._mesh().material_ref = name
        mat = self.scene.get_library_material(name)
        if mat is not None:
            self._mesh().material = mat
        self.scene.materials_dirty = True
        return self

    def set_name(self, name: str):
        self._mesh().name = name
        return self

    def set_dynamic(self, dynamic: bool):
        self._mesh().is_dynamic = dynamic
        return self

    def set_triangles(self, tris):
        """Replace procedural geometry (Triangles-type meshes)."""
        self._mesh().triangle_verts = np.asarray(
            tris, np.float32).reshape(-1, 3)
        return self._dirty()


class LightHandle:
    """``PTRTtransfer.cuh:886-912, 1524-1583``."""

    def __init__(self, index: int = -1, scene: "UnifiedScene" = None):
        self.index = index
        self.scene = scene

    def is_valid(self) -> bool:
        return self.scene is not None and self.index >= 0

    def _light(self) -> UnifiedLight:
        return self.scene.lights[self.index]

    def _dirty(self):
        self.scene.lights_dirty = True
        return self

    def set_position(self, pos):
        self._light().move_to(pos)
        return self._dirty()

    def set_direction(self, dir):
        self._light().set_direction(dir)
        return self._dirty()

    def set_color(self, col):
        self._light().set_color(col)
        return self._dirty()

    def set_intensity(self, i):
        self._light().set_intensity(i)
        return self._dirty()

    def set_name(self, name):
        self._light().name = name
        return self

    def get_position(self):
        return self._light().position


# -- keyframe animation (PTRTtransfer.cuh:914-1054) --------------------------


class EaseType(Enum):
    Linear = "linear"
    EaseIn = "ease_in"
    EaseOut = "ease_out"
    EaseInOut = "ease_in_out"
    Bounce = "bounce"
    Elastic = "elastic"


def apply_easing(t: float, ease: EaseType) -> float:
    """``applyEasing`` (``PTRTtransfer.cuh:931-966``)."""
    if ease == EaseType.Linear:
        return t
    if ease == EaseType.EaseIn:
        return t * t
    if ease == EaseType.EaseOut:
        return t * (2.0 - t)
    if ease == EaseType.EaseInOut:
        return 2.0 * t * t if t < 0.5 else -1.0 + (4.0 - 2.0 * t) * t
    if ease == EaseType.Bounce:
        if t < 1.0 / 2.75:
            return 7.5625 * t * t
        if t < 2.0 / 2.75:
            t -= 1.5 / 2.75
            return 7.5625 * t * t + 0.75
        if t < 2.5 / 2.75:
            t -= 2.25 / 2.75
            return 7.5625 * t * t + 0.9375
        t -= 2.625 / 2.75
        return 7.5625 * t * t + 0.984375
    if ease == EaseType.Elastic:
        if t == 0.0 or t == 1.0:
            return t
        p = 0.3
        s = p / 4.0
        return (math.pow(2.0, -10.0 * t)
                * math.sin((t - s) * (2.0 * math.pi) / p) + 1.0)
    return t


@dataclass
class Keyframe:
    time: float
    value: tuple
    ease: EaseType = EaseType.Linear


class TransformAnimation:
    """``TransformAnimation`` (``PTRTtransfer.cuh:968-1054``)."""

    def __init__(self):
        self.position_keys: List[Keyframe] = []
        self.rotation_keys: List[Keyframe] = []
        self.scale_keys: List[Keyframe] = []
        self.looping = False
        self.duration = 0.0

    def add_position_key(self, time, pos, ease=EaseType.Linear):
        self.position_keys.append(Keyframe(time, tuple(pos), ease))
        self.duration = max(self.duration, time)
        return self

    def add_rotation_key(self, time, rot, ease=EaseType.Linear):
        self.rotation_keys.append(Keyframe(time, tuple(rot), ease))
        self.duration = max(self.duration, time)
        return self

    def add_scale_key(self, time, scl, ease=EaseType.Linear):
        if isinstance(scl, (int, float)):
            scl = (scl, scl, scl)
        self.scale_keys.append(Keyframe(time, tuple(scl), ease))
        self.duration = max(self.duration, time)
        return self

    def set_looping(self, loop: bool):
        self.looping = loop
        return self

    def evaluate(self, time: float) -> UnifiedTransform:
        if self.looping and self.duration > 0.0:
            time = math.fmod(time, self.duration)
        result = UnifiedTransform()
        if self.position_keys:
            result.position = self._interp(self.position_keys, time)
        if self.rotation_keys:
            result.rotation = self._interp(self.rotation_keys, time)
        if self.scale_keys:
            result.scale = self._interp(self.scale_keys, time)
        return result

    @staticmethod
    def _interp(keys: List[Keyframe], time: float) -> tuple:
        if not keys:
            return (0.0, 0.0, 0.0)
        if len(keys) == 1 or time <= keys[0].time:
            return keys[0].value
        if time >= keys[-1].time:
            return keys[-1].value
        i = 0
        while i < len(keys) - 1 and time >= keys[i + 1].time:
            i += 1
        k0, k1 = keys[i], keys[i + 1]
        t = (time - k0.time) / (k1.time - k0.time)
        t = apply_easing(t, k0.ease)
        return tuple(k0.value[j] + (k1.value[j] - k0.value[j]) * t
                     for j in range(3))


# -- the scene store ---------------------------------------------------------


class UnifiedScene:
    """``UnifiedScene`` (``PTRTtransfer.cuh:1056-1388``)."""

    def __init__(self, width: int = 800, height: int = 600):
        self.width = width
        self.height = height
        self.camera = UnifiedCameraConfig()
        self.meshes: List[UnifiedMeshDesc] = []
        self.lights: List[UnifiedLight] = []
        self.sky = UnifiedSkyConfig()
        self.ambient_light = (0.03, 0.03, 0.03)
        self.bvh_leaf_target = 12
        self.bvh_leaf_tolerance = 5
        self.samples_per_pixel = 16
        self.max_bounce_depth = 8
        self.animations: Dict[str, TransformAnimation] = {}
        self.material_library: Dict[str, Material] = {}
        self.transforms_dirty = False
        self.lights_dirty = False
        self.materials_dirty = False
        self.mesh_dirty_flags: List[bool] = []

    # material library
    def add_library_material(self, name: str, mat: Material):
        self.material_library[name] = mat
        self.materials_dirty = True
        return self

    def get_library_material(self, name: str) -> Optional[Material]:
        return self.material_library.get(name)

    # camera / sky
    def set_camera(self, lookfrom, lookat, vup=(0, 1, 0), fov=60.0,
                   aperture=0.0, focus_dist=1.0):
        self.camera = UnifiedCameraConfig(tuple(lookfrom), tuple(lookat),
                                          tuple(vup), fov, aperture,
                                          focus_dist)
        return self

    def set_camera_config(self, cam: UnifiedCameraConfig):
        self.camera = cam
        return self

    def set_sky_gradient(self, top, bottom):
        self.sky.enabled = True
        self.sky.top_color = tuple(top)
        self.sky.bottom_color = tuple(bottom)
        self.sky.hdri_path = ""
        return self

    def set_hdri(self, path: str, intensity: float = 1.0,
                 rotation: float = 0.0):
        self.sky.enabled = True
        self.sky.hdri_path = path
        self.sky.hdri_intensity = intensity
        self.sky.hdri_rotation = rotation
        return self

    def disable_sky(self):
        self.sky.enabled = False
        return self

    def set_ambient_light(self, ambient):
        self.ambient_light = tuple(ambient)
        return self

    def set_bvh_params(self, leaf_target: int, tolerance: int = 5):
        self.bvh_leaf_target = leaf_target
        self.bvh_leaf_tolerance = tolerance
        return self

    def set_path_tracer_params(self, spp: int, max_depth: int):
        self.samples_per_pixel = spp
        self.max_bounce_depth = max_depth
        return self

    # meshes
    def add_mesh(self, mesh: UnifiedMeshDesc) -> ObjectHandle:
        idx = len(self.meshes)
        self.meshes.append(mesh)
        self.mesh_dirty_flags.append(True)
        return ObjectHandle(idx, self)

    def instantiate_object(self, desc: UnifiedMeshDesc,
                           name: str = "") -> ObjectHandle:
        new = dataclasses.replace(desc,
                                  transform=desc.transform.copy(),
                                  is_dynamic=True)
        if name:
            new.name = name
        return self.add_mesh(new)

    def add_mesh_from_obj(self, path, mat=None) -> ObjectHandle:
        return self.add_mesh(UnifiedMeshDesc.FromOBJ(path, mat))

    def add_cube(self, mat=None) -> ObjectHandle:
        return self.add_mesh(UnifiedMeshDesc.Cube(mat))

    def add_plane_xz(self, y, half_size, mat=None) -> ObjectHandle:
        return self.add_mesh(UnifiedMeshDesc.PlaneXZ(y, half_size, mat))

    def add_sphere(self, segments=32, mat=None) -> ObjectHandle:
        return self.add_mesh(UnifiedMeshDesc.Sphere(segments, mat))

    def add_triangles(self, tris, mat=None) -> ObjectHandle:
        return self.add_mesh(UnifiedMeshDesc.Triangles(tris, mat))

    # lights
    def add_light(self, light: UnifiedLight) -> LightHandle:
        idx = len(self.lights)
        self.lights.append(light)
        self.lights_dirty = True
        return LightHandle(idx, self)

    def add_point_light(self, pos, color, intensity=1.0, range=100.0,
                        radius=0.0) -> LightHandle:
        return self.add_light(
            UnifiedLight.Point(pos, color, intensity, range, radius))

    def add_directional_light(self, dir, color, intensity=1.0) -> LightHandle:
        return self.add_light(UnifiedLight.Directional(dir, color, intensity))

    def add_spot_light(self, pos, dir, color, intensity=1.0, inner_cone=0.5,
                       outer_cone=0.7, range=100.0, radius=0.0) -> LightHandle:
        return self.add_light(UnifiedLight.Spot(
            pos, dir, color, intensity, inner_cone, outer_cone, range, radius))

    def add_area_light(self, pos, dir, color, width, height,
                       intensity=1.0) -> LightHandle:
        return self.add_light(
            UnifiedLight.Area(pos, dir, color, width, height, intensity))

    # lookup
    def find_object(self, name: str) -> ObjectHandle:
        for i, m in enumerate(self.meshes):
            if m.name == name:
                return ObjectHandle(i, self)
        return ObjectHandle()

    def find_light(self, name: str) -> LightHandle:
        for i, l in enumerate(self.lights):
            if l.name == name:
                return LightHandle(i, self)
        return LightHandle()

    # animation
    def add_animation(self, object_name: str, anim: TransformAnimation):
        self.animations[object_name] = anim
        return self

    def update_animations(self, time: float) -> None:
        """``updateAnimations`` (``PTRTtransfer.cuh:1286-1295``)."""
        for name, anim in self.animations.items():
            obj = self.find_object(name)
            if obj.is_valid():
                self.meshes[obj.index].transform = anim.evaluate(time)
                self.mark_mesh_dirty(obj.index)

    # dirty tracking
    def mark_mesh_dirty(self, index: int) -> None:
        if 0 <= index < len(self.mesh_dirty_flags):
            self.mesh_dirty_flags[index] = True
            self.transforms_dirty = True

    def mark_all_meshes_dirty(self) -> None:
        self.mesh_dirty_flags = [True] * len(self.mesh_dirty_flags)
        self.transforms_dirty = True

    def clear_dirty_flags(self) -> None:
        self.mesh_dirty_flags = [False] * len(self.mesh_dirty_flags)
        self.transforms_dirty = False
        self.lights_dirty = False
        self.materials_dirty = False

    def has_dirty_meshes(self) -> bool:
        return any(self.mesh_dirty_flags)

    def get_dirty_mesh_indices(self) -> List[int]:
        return [i for i, d in enumerate(self.mesh_dirty_flags) if d]

    @property
    def mesh_count(self) -> int:
        return len(self.meshes)

    @property
    def light_count(self) -> int:
        return len(self.lights)

    @property
    def dynamic_mesh_count(self) -> int:
        return sum(1 for m in self.meshes if m.is_dynamic)


# -- builders (PTRTtransfer.cuh:1684-2393) -----------------------------------


def _make_mesh(desc: UnifiedMeshDesc) -> Mesh:
    if desc.type == MeshType.ObjFile:
        return Mesh(desc.obj_path)
    if desc.type == MeshType.Cube:
        return Mesh.cube()
    if desc.type == MeshType.PlaneXZ:
        return Mesh.plane_xz(desc.plane_y, desc.plane_half_size)
    if desc.type == MeshType.PlaneXY:
        m = Mesh.plane_xz(0.0, desc.plane_half_size)
        m.rotate_self_euler_xyz(math.pi / 2, 0.0, 0.0)
        return m.translate_verts(0.0, 0.0, desc.plane_y)
    if desc.type == MeshType.PlaneYZ:
        m = Mesh.plane_xz(0.0, desc.plane_half_size)
        m.rotate_self_euler_xyz(0.0, 0.0, math.pi / 2)
        return m.translate_verts(desc.plane_y, 0.0, 0.0)
    if desc.type == MeshType.Sphere:
        return Mesh.sphere(desc.sphere_segments)
    if desc.type == MeshType.Triangles:
        return Mesh.from_triangles(desc.triangle_verts.reshape(-1, 3, 3))
    raise ValueError(f"unsupported mesh type {desc.type}")


def _resolve_material(scene: UnifiedScene, desc: UnifiedMeshDesc) -> Material:
    if desc.material_ref:
        mat = scene.get_library_material(desc.material_ref)
        if mat is not None:
            return mat
    return desc.material


def _apply_transform(mesh: Mesh, desc: UnifiedMeshDesc) -> None:
    """Static meshes bake TRS into vertices; dynamic meshes carry a
    Transform3D (``PTRTtransfer.cuh:2136-2157``)."""
    t = desc.transform
    if desc.type == MeshType.Triangles:
        return  # verts already world space (PTRTtransfer.cuh:2250-2270)
    if desc.is_dynamic:
        mesh.transform = Transform3D(tuple(t.position), tuple(t.rotation),
                                     tuple(t.scale))
    elif not t.is_identity():
        tr = Transform3D(tuple(t.position), tuple(t.rotation), tuple(t.scale))
        m = tr.world_matrix()
        mesh.vertices = (mesh.vertices @ m[:3, :3].T + m[:3, 3]).astype(
            np.float32)
        mesh.verts_dirty = True


def _unified_light_to_light(l: UnifiedLight) -> Light:
    t = LightType(int(l.type))
    return Light(type=t, position=tuple(l.position),
                 direction=tuple(l.direction), color=tuple(l.color),
                 intensity=l.intensity, range=l.range,
                 inner_cone=l.inner_cone, outer_cone=l.outer_cone,
                 radius=(l.radius if t != LightType.AREA else
                         0.5 * math.sqrt(l.area_width * l.area_height)),
                 width=(l.area_width if t == LightType.AREA else 0.0),
                 height=(l.area_height if t == LightType.AREA else 0.0))


class UnifiedSceneBuilder:
    """``UnifiedSceneBuilder`` (``PTRTtransfer.cuh:1684-2393``)."""

    # -- PT ------------------------------------------------------------------
    @staticmethod
    def build_pt_scene(unified: UnifiedScene, device="cuda") -> PTScene:
        """``buildPTScene`` (``PTRTtransfer.cuh:2120-2202``) into a
        ``Scene`` on ``device``."""
        scene = PTScene(unified.width, unified.height, device=device)
        for desc in unified.meshes:
            mesh = _make_mesh(desc)
            _apply_transform(mesh, desc)
            mesh.is_dynamic = desc.is_dynamic
            scene.add_mesh(mesh, _resolve_material(unified, desc))
        for l in unified.lights:
            scene.lights.append(_unified_light_to_light(l))
        scene._light_dirty = True
        lf, la = unified.camera.lookfrom, unified.camera.lookat
        scene.set_camera(lf, la, unified.camera.vup, unified.camera.vfov,
                         unified.camera.aperture, unified.camera.focus_dist)
        if unified.sky.hdri_path:
            from ptrt_tpu_torch.utils.hdr import load_hdr

            scene.set_environment_map(
                load_hdr(unified.sky.hdri_path) * unified.sky.hdri_intensity,
                rotation=unified.sky.hdri_rotation)
        elif unified.sky.enabled:
            scene.set_sky_gradient(unified.sky.top_color,
                                   unified.sky.bottom_color)
        else:
            scene.set_sky_enabled(False)
        scene.perf.samples_per_pixel = unified.samples_per_pixel
        scene.perf.max_bounce_depth = unified.max_bounce_depth
        unified.clear_dirty_flags()
        return scene

    @staticmethod
    def update_pt_scene(scene: PTScene, unified: UnifiedScene) -> None:
        """``updatePTScene`` (``PTRTtransfer.cuh:2204-2393``): dynamic meshes
        update their Transform3D (TLAS-only), static dirty meshes re-bake,
        Triangles-type meshes re-fill vertices; light/material edits pushed
        via commit paths."""
        changed = False
        for i in unified.get_dirty_mesh_indices():
            desc = unified.meshes[i]
            if i >= len(scene.meshes):
                # object spawned after build (instantiateObject path)
                mesh = _make_mesh(desc)
                _apply_transform(mesh, desc)
                mesh.is_dynamic = desc.is_dynamic
                scene.add_mesh(mesh, _resolve_material(unified, desc))
                changed = True
                continue
            mesh = scene.meshes[i]
            if desc.type == MeshType.Triangles:
                mesh.set_triangles(desc.triangle_verts.reshape(-1, 3, 3))
            elif desc.is_dynamic:
                t = desc.transform
                mesh.transform = Transform3D(tuple(t.position),
                                             tuple(t.rotation),
                                             tuple(t.scale))
                mesh.verts_dirty = True
            else:
                fresh = _make_mesh(desc)
                _apply_transform(fresh, desc)
                mesh.vertices = fresh.vertices
                mesh.faces = fresh.faces
                mesh.verts_dirty = True
            changed = True
        if changed:
            scene.commit_object_changes()
        if unified.materials_dirty:
            for i, desc in enumerate(unified.meshes):
                scene.mesh_materials[i] = _resolve_material(unified, desc)
            scene.commit_material_changes()
        if unified.lights_dirty:
            scene.lights = [_unified_light_to_light(l)
                            for l in unified.lights]
            scene.commit_light_changes()
        unified.clear_dirty_flags()

    @staticmethod
    def update_pt_camera(scene: PTScene, unified: UnifiedScene) -> None:
        c = unified.camera
        scene.set_camera(c.lookfrom, c.lookat, c.vup, c.vfov, c.aperture,
                         c.focus_dist)

    # -- RT ------------------------------------------------------------------
    @staticmethod
    def build_rt_scene(unified: UnifiedScene, device="cuda") -> RTScene:
        """``buildRTScene`` (``PTRTtransfer.cuh:1684-1853``) into an
        ``RTScene`` on ``device``."""
        scene = RTScene(unified.width, unified.height, device=device)
        for desc in unified.meshes:
            mesh = _make_mesh(desc)
            _apply_transform(mesh, desc)
            mesh.is_dynamic = desc.is_dynamic
            scene.add_mesh(mesh, _resolve_material(unified, desc))
        for l in unified.lights:
            scene.lights.append(_unified_light_to_light(l))
        scene._dirty = True
        c = unified.camera
        scene.set_camera(c.lookfrom, c.lookat, c.vup, c.vfov, c.aperture,
                         c.focus_dist)
        scene.set_ambient_light(unified.ambient_light)
        if unified.sky.enabled:
            scene.set_sky_gradient(unified.sky.top_color,
                                   unified.sky.bottom_color)
        else:
            scene.use_sky = False
        unified.clear_dirty_flags()
        return scene

    @staticmethod
    def update_rt_scene(scene: RTScene, unified: UnifiedScene) -> None:
        """``updateRTScene`` (``PTRTtransfer.cuh:1855-2032``)."""
        changed = False
        for i in unified.get_dirty_mesh_indices():
            desc = unified.meshes[i]
            if i >= len(scene.meshes):
                mesh = _make_mesh(desc)
                _apply_transform(mesh, desc)
                mesh.is_dynamic = desc.is_dynamic
                scene.add_mesh(mesh, _resolve_material(unified, desc))
                changed = True
                continue
            mesh = scene.meshes[i]
            if desc.type == MeshType.Triangles:
                mesh.set_triangles(desc.triangle_verts.reshape(-1, 3, 3))
            elif desc.is_dynamic:
                t = desc.transform
                mesh.transform = Transform3D(tuple(t.position),
                                             tuple(t.rotation),
                                             tuple(t.scale))
                mesh.verts_dirty = True
            else:
                fresh = _make_mesh(desc)
                _apply_transform(fresh, desc)
                mesh.vertices = fresh.vertices
                mesh.faces = fresh.faces
                mesh.verts_dirty = True
            changed = True
        if changed or unified.materials_dirty or unified.lights_dirty:
            if unified.materials_dirty:
                for i, desc in enumerate(unified.meshes):
                    scene.mesh_materials[i] = _resolve_material(unified, desc)
            if unified.lights_dirty:
                scene.lights = [_unified_light_to_light(l)
                                for l in unified.lights]
            scene._dirty = True
        unified.clear_dirty_flags()

    @staticmethod
    def update_rt_camera(scene: RTScene, unified: UnifiedScene) -> None:
        c = unified.camera
        scene.set_camera(c.lookfrom, c.lookat, c.vup, c.vfov, c.aperture,
                         c.focus_dist)


class UnifiedScenePresets:
    """``UnifiedScenePresets`` (``PTRTtransfer.cuh:2399-2583``)."""

    @staticmethod
    def CornellBox(width=800, height=800) -> UnifiedScene:
        s = UnifiedScene(width, height)
        s.set_camera((278, 273, -800), (278, 273, 0), (0, 1, 0), 40.0)
        white = Material.make((0.73, 0.73, 0.73), 0.9, 0.0)
        s.add_plane_xz(0, 278, white)
        s.add_plane_xz(548.8, 278, white)
        s.add_point_light((278, 530, 279.5), (1.0, 1.0, 1.0), 50.0)
        s.set_sky_gradient((0, 0, 0), (0, 0, 0))
        return s

    @staticmethod
    def MaterialShowcase(width=1280, height=720) -> UnifiedScene:
        s = UnifiedScene(width, height)
        s.set_camera((0, 5, 15), (0, 0, 0), (0, 1, 0), 45.0)
        s.add_plane_xz(-1.0, 50.0, Materials.MarbleCarrara())
        s.add_directional_light((-0.5, -1.0, -0.3), (1.0, 0.95, 0.9), 2.0)
        s.add_point_light((5, 8, 5), (1.0, 0.9, 0.8), 100.0)
        s.set_sky_gradient((0.6, 0.7, 1.0), (1.0, 1.0, 1.0))
        return s

    @staticmethod
    def Empty(width=800, height=600) -> UnifiedScene:
        s = UnifiedScene(width, height)
        s.set_camera((0, 5, 10), (0, 0, 0), (0, 1, 0), 60.0)
        s.add_plane_xz(-1.0, 50.0, Material.make((0.8, 0.8, 0.8)))
        s.add_directional_light((-0.5, -1.0, -0.3), (1.0, 1.0, 1.0), 1.0)
        s.set_sky_gradient((0.6, 0.7, 1.0), (1.0, 1.0, 1.0))
        return s

    @staticmethod
    def DynamicObjectsDemo(width=1280, height=720) -> UnifiedScene:
        s = UnifiedScene(width, height)
        s.set_camera((0, 8, 15), (0, 2, 0), (0, 1, 0), 50.0)
        s.add_plane_xz(-0.5, 30.0, Materials.Concrete())
        for i in range(5):
            cube = s.add_cube(Materials.PlasticRed())
            cube.set_position(((i - 2) * 3.0, 1.0, 0.0)).set_scale(1.5)
            cube.set_name(f"cube_{i}")
            s.meshes[cube.index].is_dynamic = True
        sphere = s.add_sphere(32, Materials.Chrome())
        sphere.set_position((0, 3, 5)).set_scale(1.0).set_name("sphere_main")
        s.meshes[sphere.index].is_dynamic = True
        anim = TransformAnimation()
        (anim.add_position_key(0.0, (0, 3, 5))
             .add_position_key(2.0, (5, 5, 5), EaseType.EaseInOut)
             .add_position_key(4.0, (0, 3, -5), EaseType.EaseInOut)
             .add_position_key(6.0, (-5, 5, 5), EaseType.EaseInOut)
             .add_position_key(8.0, (0, 3, 5), EaseType.EaseInOut)
             .set_looping(True))
        s.add_animation("sphere_main", anim)
        light = s.add_point_light((5, 10, 5), (1.0, 0.9, 0.8), 200.0)
        light.set_name("main_light")
        s.lights[light.index].animated = True
        s.add_directional_light((-0.3, -1.0, -0.5), (0.5, 0.6, 0.8), 0.5)
        s.set_sky_gradient((0.4, 0.5, 0.8), (0.9, 0.9, 1.0))
        return s

    @staticmethod
    def GlassDemo(width=1280, height=720) -> UnifiedScene:
        s = UnifiedScene(width, height)
        s.set_camera((0, 4, 12), (0, 1.5, 0), (0, 1, 0), 45.0)
        s.add_plane_xz(0.0, 20.0, Materials.MarbleCarrara())
        s.add_sphere(64, Materials.Glass()).set_position((0, 2, 0)) \
            .set_scale(2.0).set_name("glass_sphere")
        s.add_sphere(64, Materials.Diamond()).set_position((-4, 1.5, 0)) \
            .set_scale(1.5).set_name("diamond")
        s.add_sphere(48, Materials.Water()).set_position((4, 1.5, 0)) \
            .set_scale(1.5).set_name("water")
        s.add_cube(Materials.FrostedGlass()).set_position((0, 1, -4)) \
            .set_scale((6, 2, 0.3)).set_name("frosted_panel")
        s.add_point_light((5, 10, 5), (1.0, 1.0, 1.0), 150.0, 50.0, 0.5)
        s.add_point_light((-5, 8, -3), (0.9, 0.9, 1.0), 100.0)
        s.add_directional_light((-0.5, -1.0, 0.2), (1.0, 0.95, 0.9), 1.0)
        s.set_sky_gradient((0.7, 0.8, 1.0), (1.0, 1.0, 1.0))
        return s

    @staticmethod
    def MetalDemo(width=1280, height=720) -> UnifiedScene:
        s = UnifiedScene(width, height)
        s.set_camera((0, 6, 14), (0, 2, 0), (0, 1, 0), 45.0)
        s.add_plane_xz(0.0, 30.0, Materials.MarbleNero())
        for x, mat in [(-6, Materials.Gold()), (-3, Materials.Silver()),
                       (0, Materials.Copper()), (3, Materials.Chrome()),
                       (6, Materials.BrushedAluminum())]:
            s.add_sphere(48, mat).set_position((x, 1.5, 0)).set_scale(1.5)
        s.add_cube(Materials.CarPaint((0.8, 0.1, 0.1))) \
            .set_position((-2, 1, 4)).set_scale(2.0) \
            .set_rotation_degrees((0, 30, 0))
        s.add_cube(Materials.PearlescentPaint((0.1, 0.2, 0.8))) \
            .set_position((2, 1, 4)).set_scale(2.0) \
            .set_rotation_degrees((0, -30, 0))
        s.add_point_light((0, 12, 8), (1.0, 1.0, 1.0), 300.0)
        s.add_point_light((-8, 8, -5), (0.9, 0.95, 1.0), 150.0)
        s.add_point_light((8, 8, -5), (1.0, 0.95, 0.9), 150.0)
        s.set_sky_gradient((0.2, 0.2, 0.3), (0.5, 0.5, 0.6))
        return s
