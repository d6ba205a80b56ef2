"""RTIOW-basis camera with depth of field — counterpart of
``ptrt_tpu/scene/camera.py``: the same basis construction and ray math in
float32 on the camera's device, plus the view / projection /
inverse-view-projection matrices that motion vectors reproject through.

A camera is made two ways: ``Camera.make`` in torch ops (its arguments
numbers or tensors), and ``camera_make`` from its 15 host inputs
(``camera_inputs``), on the card one launch of the hand-written kernel of
``csrc/camera.cu``, which a frame program captures into its graph.
"""

from __future__ import annotations

import array
import ctypes
from dataclasses import dataclass

import torch

from ptrt_tpu_torch import kernels
from ptrt_tpu_torch.core import mat as m4
from ptrt_tpu_torch.core import rng as prng
from ptrt_tpu_torch.core.vec import PI, Vec3, cross, normalize
from ptrt_tpu_torch.render.ray import RayBatch
from ptrt_tpu_torch.utils.logging import span


@dataclass(frozen=True)
class Camera:
    origin: Vec3
    lower_left_corner: Vec3
    horizontal: Vec3
    vertical: Vec3
    u: Vec3
    v: Vec3
    w: Vec3
    lens_radius: torch.Tensor
    view: torch.Tensor
    proj: torch.Tensor
    inv_view_proj: torch.Tensor
    fov: torch.Tensor  # vertical, degrees (float32)
    aspect: torch.Tensor  # float32, the made ones below too
    near_clip: torch.Tensor
    far_clip: torch.Tensor

    @staticmethod
    def make(lookfrom, lookat, vup=(0.0, 1.0, 0.0), vfov=60.0,
             aspect_ratio=16.0 / 9.0, aperture=0.0, focus_dist=1.0,
             znear=0.1, zfar=1000.0, *, device) -> "Camera":
        """Points and numbers from the host, or 0-d float32 tensors (and
        Vec3s of them) on ``device``, as ``set_position`` passes.  The
        host numbers reach the device in one copy (``_on_device``: a
        camera move makes no synchronizing call).  Spans: ``camera.make``
        around ``camera.stage`` (that copy), then ``camera.math`` (the
        rest)."""
        leaves = []
        for p in (lookfrom, lookat, vup):
            leaves += [p.x, p.y, p.z] if isinstance(p, Vec3) else [p[0], p[1],
                                                                    p[2]]
        with span("camera.make"):
            vals = _on_device(leaves + [vfov, aspect_ratio, focus_dist,
                                        aperture, znear, zfar], device)
            with span("camera.math"):
                return _made(vals, znear, zfar)

    def ray_through(self, s: float, t: float):
        """Host-side pinhole ray through viewport coords (s, t) in [0, 1]^2:
        numpy (origin, direction) for picking and debug-ray generators."""
        import numpy as np

        g = lambda v: np.array([float(v.x), float(v.y), float(v.z)])
        o = g(self.origin)
        d = (g(self.lower_left_corner) + g(self.horizontal) * s
             + g(self.vertical) * t - o)
        return o, d / max(np.linalg.norm(d), 1e-12)

    def get_view_proj(self) -> torch.Tensor:
        return self.proj @ self.view

    def get_ray_simple(self, s, t) -> RayBatch:
        """Pinhole rays, marked specular like the reference's camera rays."""
        d = normalize(self.lower_left_corner + self.horizontal * s
                      + self.vertical * t - self.origin)
        shape = d.x.shape
        spec = torch.ones(shape, dtype=torch.bool, device=d.x.device)
        return RayBatch(self.origin.broadcast_to(shape), d, spec)

    def get_ray(self, s, t, rng_state):
        """DOF rays when aperture > 0.  Returns (rng_state, RayBatch)."""
        rng_state, rd = prng.sample_unit_disk(rng_state)
        rd = rd * self.lens_radius
        offset = self.u * rd.x + self.v * rd.y
        use_dof = self.lens_radius > 0.0
        offset = offset * torch.where(use_dof, 1.0, 0.0)
        d = (self.lower_left_corner + self.horizontal * s + self.vertical * t
             - self.origin - offset)
        d = normalize(d)
        shape = d.x.shape
        spec = torch.ones(shape, dtype=torch.bool, device=d.x.device)
        return rng_state, RayBatch((self.origin + offset).broadcast_to(shape),
                                   d, spec)

    # -- edits (value-semantic: each returns a new camera) ------------------
    def set_position(self, pos) -> "Camera":
        """Move the eye, keeping the current look-at point and focus."""
        dev = self.origin.x.device
        old_center = (self.lower_left_corner + self.horizontal * 0.5
                      + self.vertical * 0.5)
        focus = (self.origin - old_center).length()
        lookat = self.origin - self.w * focus
        pos = _as_vec3(pos, dev)
        return Camera.make(pos, lookat, self.v, self.fov, self.aspect,
                           aperture=self.lens_radius * 2.0,
                           focus_dist=(pos - lookat).length(),
                           znear=self.near_clip, zfar=self.far_clip,
                           device=dev)

    def look_at(self, target, vup=(0.0, 1.0, 0.0)) -> "Camera":
        """Re-aim at a target from the current origin."""
        dev = self.origin.x.device
        target = _as_vec3(target, dev)
        return Camera.make(self.origin, target, _as_vec3(vup, dev), self.fov,
                           self.aspect, aperture=self.lens_radius * 2.0,
                           focus_dist=(self.origin - target).length(),
                           znear=self.near_clip, zfar=self.far_clip,
                           device=dev)


def _made(vals: list, znear, zfar) -> Camera:
    """``Camera.make``'s math on its 15 values (0-d float32 tensors, in
    ``camera_inputs``' order); ``znear`` and ``zfar`` as given to it (the
    projection's clip terms are a host computation where they are
    numbers)."""
    lookfrom, lookat, vup = (Vec3(*vals[k:k + 3]) for k in (0, 3, 6))
    vfov, aspect_ratio, focus_dist, aperture_t, near_t, far_t = vals[9:]

    theta = vfov * (PI / 180.0)
    h = torch.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = aspect_ratio * viewport_height

    w = normalize(lookfrom - lookat)
    u = normalize(cross(vup, w))
    v = cross(w, u)

    horizontal = u * (focus_dist * viewport_width)
    vertical = v * (focus_dist * viewport_height)
    llc = (lookfrom - horizontal * 0.5 - vertical * 0.5
           - w * focus_dist)

    view = m4.look_at(lookfrom, lookat, vup)
    proj = m4.perspective(theta, aspect_ratio, znear, zfar)
    return Camera(origin=lookfrom, lower_left_corner=llc,
                  horizontal=horizontal, vertical=vertical, u=u, v=v, w=w,
                  lens_radius=aperture_t / 2.0, view=view, proj=proj,
                  inv_view_proj=m4.inverse(proj @ view), fov=vfov,
                  aspect=aspect_ratio, near_clip=near_t, far_clip=far_t)


# -- a camera from its host inputs ---------------------------------------------
# lookfrom, lookat, vup (3 each), fov (degrees), aspect, focus_dist,
# aperture, znear, zfar
CAMERA_INPUTS = 15

# each leaf's place in the one float32 buffer ``camera_make`` writes: the
# matrices 256 bytes apart (each as aligned for a matrix product as a
# tensor of its own), then the vectors' three values each and the numbers
_LAYOUT = (("view", 0, 16), ("proj", 64, 16), ("inv_view_proj", 128, 16),
           ("origin", 192, 3), ("lower_left_corner", 195, 3),
           ("horizontal", 198, 3), ("vertical", 201, 3), ("u", 204, 3),
           ("v", 207, 3), ("w", 210, 3), ("lens_radius", 213, 1),
           ("fov", 214, 1), ("aspect", 215, 1), ("near_clip", 216, 1),
           ("far_clip", 217, 1))
_BUFFER = 218


def camera_inputs(lookfrom, lookat, vup=(0.0, 1.0, 0.0), vfov=60.0,
                  aspect_ratio=16.0 / 9.0, aperture=0.0, focus_dist=1.0,
                  znear=0.1, zfar=1000.0) -> tuple:
    """The 15 host inputs of ``Camera.make``'s camera of these host
    numbers (its arguments), each rounded to float32 as it rounds them:
    what ``camera_make`` takes."""
    xyz = lambda p: [p.x, p.y, p.z] if isinstance(p, Vec3) else [p[0], p[1],
                                                                 p[2]]
    vals = [*xyz(lookfrom), *xyz(lookat), *xyz(vup), vfov, aspect_ratio,
            focus_dist, aperture, znear, zfar]
    return tuple(array.array("f", [float(v) for v in vals]))


def _unpacked(buf: torch.Tensor) -> Camera:
    """The camera whose tensors are views of ``buf`` (``_LAYOUT``)."""
    leaf = {}
    for name, off, n in _LAYOUT:
        if n == 16:
            leaf[name] = buf[off:off + 16].view(4, 4)
        elif n == 3:
            leaf[name] = Vec3(buf[off], buf[off + 1], buf[off + 2])
        else:
            leaf[name] = buf[off]
    return Camera(**leaf)


def camera_make_plain(inputs, device) -> Camera:
    """Plain version of ``camera_make``: ``Camera.make``'s math on the
    inputs (host numbers or 0-d float32 tensors on ``device``).  No span
    opens in it: a program's body calls it."""
    vals = [v if torch.is_tensor(v)
            else torch.tensor(float(v), dtype=torch.float32, device=device)
            for v in inputs]
    return _made(vals, float(inputs[13]), float(inputs[14]))


class CameraMakeArgs(kernels.Args):
    """``struct CameraMakeArgs`` of ``csrc/camera.cu``."""

    _fields_ = [("inputs", ctypes.c_void_p * CAMERA_INPUTS)] + [
        (name, ctypes.c_void_p) for name in (
            "view", "proj", "inv_view_proj", "origin", "lower_left_corner",
            "horizontal", "vertical", "u", "v", "w", "lens_radius", "fov",
            "aspect", "near_clip", "far_clip")]


def camera_make(inputs, device) -> Camera:
    """The camera of ``inputs``, ``camera_inputs``' 15 values: host numbers
    (staged on the card in one copy), or 0-d float32 tensors on ``device``
    (a frame program's staged values, which a captured launch reads at
    each replay).  On the card one launch of the hand-written
    ``camera_make`` (``csrc/camera.cu``) writes every leaf into one buffer
    that the Camera's tensors view: ``Camera.make``'s values bit for bit,
    but ``inv_view_proj`` (the inverse of the same ``proj @ view`` in
    double, rounded: nearer its exact inverse than torch's float32 LU); on
    the CPU ``camera_make_plain``.  ``znear`` and ``zfar`` enter the
    projection as their float32 values (``Camera.make`` takes them as
    given): the same for the default 0.1 and 1000."""
    device = torch.device(device)
    kernels.require_supported(device)
    if len(inputs) != CAMERA_INPUTS:
        raise ValueError(f"{len(inputs)} camera inputs, expected "
                         f"{CAMERA_INPUTS}")
    if device.type == "cpu":
        return camera_make_plain(inputs, device)
    if device.index is None:  # "cuda": the current card, as tensors name it
        device = torch.device("cuda", torch.cuda.current_device())
    if not all(torch.is_tensor(v) for v in inputs):
        inputs = _on_device(list(inputs), device)
    a = CameraMakeArgs()
    a.inputs = (ctypes.c_void_p * CAMERA_INPUTS)(*[
        kernels.scalar_ptr(f"inputs[{k}]", v, device)
        for k, v in enumerate(inputs)])
    cam = _unpacked(torch.empty(_BUFFER, dtype=torch.float32, device=device))
    for name, _, n in _LAYOUT:
        v = getattr(cam, name)
        setattr(a, name, (v.x if n == 3 else v).data_ptr())
    rc = kernels.get_lib().ptrt_camera_make(ctypes.addressof(a),
                                            kernels.stream_ptr(device))
    kernels.launches["camera_make"] += 1
    kernels.check(rc, "camera_make")
    return cam


def _on_device(values: list, device) -> list:
    """0-d float32 tensors on ``device`` of ``values`` (host numbers, or 0-d
    tensors kept as they are): the host numbers, rounded to float32, in
    one copy, on the card from pinned memory without waiting for it (the
    span ``camera.stage``)."""
    with span("camera.stage"):
        device = torch.device(device)
        host = [float(v) for v in values if not torch.is_tensor(v)]
        staged = iter(())
        if host:
            buf = torch.tensor(host, dtype=torch.float32)
            buf = (buf.pin_memory().to(device, non_blocking=True)
                   if device.type == "cuda" else buf.to(device))
            staged = iter(buf.unbind(0))
        return [torch.as_tensor(v, dtype=torch.float32, device=device)
                if torch.is_tensor(v) else next(staged) for v in values]


def _as_vec3(x, device) -> Vec3:
    f32 = lambda c: torch.as_tensor(c, dtype=torch.float32, device=device)
    if isinstance(x, Vec3):
        return x.map(f32)
    return Vec3(f32(x[0]), f32(x[1]), f32(x[2]))


def pixel_grid(width: int, height: int, device, jitter_x=0.5, jitter_y=0.5):
    """(s, t) tensors for the full (height, width) pixel grid, bottom-up
    like the reference's framebuffer convention."""
    xs = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    ys = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    s = (xs + jitter_x) / float(width)
    t = (ys + jitter_y) / float(height)
    shape = torch.broadcast_shapes(s.shape, t.shape, (height, width))
    return s.expand(shape), t.expand(shape)
