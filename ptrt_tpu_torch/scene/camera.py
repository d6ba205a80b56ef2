"""RTIOW-basis camera with depth of field — counterpart of
``ptrt_tpu/scene/camera.py``: the same basis construction and ray math in
float32 on the camera's device, plus the view / projection /
inverse-view-projection matrices that motion vectors reproject through.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ptrt_tpu_torch.core import mat as m4
from ptrt_tpu_torch.core import rng as prng
from ptrt_tpu_torch.core.vec import PI, Vec3, cross, normalize
from ptrt_tpu_torch.render.ray import RayBatch


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
        Vec3s of them) on ``device``, as ``set_position`` passes."""
        f32 = lambda v: torch.as_tensor(v, dtype=torch.float32,
                                        device=device)
        v3 = lambda p: (p.map(f32) if isinstance(p, Vec3)
                        else Vec3(f32(p[0]), f32(p[1]), f32(p[2])))
        lookfrom, lookat, vup = v3(lookfrom), v3(lookat), v3(vup)
        vfov, aspect_ratio = f32(vfov), f32(aspect_ratio)
        focus_dist = f32(focus_dist)

        theta = vfov * (PI / 180.0)
        h = torch.tan(theta / 2.0)
        viewport_height = 2.0 * h
        viewport_width = aspect_ratio * viewport_height

        w = normalize(lookfrom - lookat)
        u = normalize(cross(vup, w))
        v = cross(w, u)

        horizontal = u * (focus_dist * viewport_width)
        vertical = v * (focus_dist * viewport_height)
        llc = lookfrom - horizontal * 0.5 - vertical * 0.5 - w * focus_dist

        view = m4.look_at(lookfrom, lookat, vup)
        proj = m4.perspective(theta, aspect_ratio, znear, zfar)
        return Camera(origin=lookfrom, lower_left_corner=llc,
                      horizontal=horizontal, vertical=vertical, u=u, v=v, w=w,
                      lens_radius=f32(aperture) / 2.0, view=view, proj=proj,
                      inv_view_proj=m4.inverse(proj @ view), fov=vfov,
                      aspect=aspect_ratio, near_clip=f32(znear),
                      far_clip=f32(zfar))

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
