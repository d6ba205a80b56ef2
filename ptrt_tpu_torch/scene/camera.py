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

    @staticmethod
    def make(lookfrom, lookat, vup=(0.0, 1.0, 0.0), vfov=60.0,
             aspect_ratio=16.0 / 9.0, aperture=0.0, focus_dist=1.0,
             znear=0.1, zfar=1000.0, *, device) -> "Camera":
        f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        v3 = lambda p: Vec3(f32(p[0]), f32(p[1]), f32(p[2]))
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
                      inv_view_proj=m4.inverse(proj @ view))

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


def pixel_grid(width: int, height: int, device, jitter_x=0.5, jitter_y=0.5):
    """(s, t) tensors for the full (height, width) pixel grid, bottom-up
    like the reference's framebuffer convention."""
    xs = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    ys = torch.arange(height, dtype=torch.float32, device=device)[:, None]
    s = (xs + jitter_x) / float(width)
    t = (ys + jitter_y) / float(height)
    shape = torch.broadcast_shapes(s.shape, t.shape, (height, width))
    return s.expand(shape), t.expand(shape)
