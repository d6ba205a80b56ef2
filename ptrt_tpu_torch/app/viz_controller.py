"""VisualizationController — debug-geometry hotkeys wired into the frame
loop; a copy of ``ptrt_tpu/app/viz_controller.py`` over this package's
``utils/visualization.py``.

Rebuild of the reference's ``VisualizationController``
(``app_utils.cuh:304-368``): F toggles the camera frustum wireframe, V
toggles stored debug rays, P toggles a grid of primary camera rays, +/-
scale the ray length, H prints help.  The controller owns the debug meshes
it adds to the scene and removes them on toggle-off; geometry edits go
through the scene's normal dirty tracking, so a toggle costs one static
rebake and nothing per-frame.
"""

from __future__ import annotations

import numpy as np

from ptrt_tpu_torch.geometry.mesh import Mesh
from ptrt_tpu_torch.scene.materials import Material
from ptrt_tpu_torch.utils.visualization import (generate_arrow,
                                          generate_frustum_wireframe)

HELP_TEXT = """
Visualization hotkeys (app_utils.cuh:304-368):
  F      toggle camera-frustum wireframe (captured at toggle time)
  V      toggle stored debug rays
  P      toggle primary-ray grid (captured at toggle time)
  + / -  ray length x1.25 / x0.8
  H      this help
"""


def _viz_material(color=(1.0, 0.85, 0.1)) -> Material:
    m = Material.make(color, roughness=0.6)
    m.emission = tuple(c * 2.0 for c in color)
    return m


class VisualizationController:
    """Owns debug meshes; ``handle_keys`` consumes an InputState-style key
    set with edge detection (press, not hold)."""

    def __init__(self, scene):
        self.scene = scene
        self.ray_length = 5.0
        self.show_frustum = False
        self.show_rays = False
        self.show_primary = False
        self.debug_rays: list[tuple] = []  # (origin, direction)
        self._frustum_mesh: Mesh | None = None
        self._ray_mesh: Mesh | None = None
        self._primary_mesh: Mesh | None = None
        self._prev_keys: set = set()

    # -- ray storage (games push picking rays here) --------------------------
    def add_debug_ray(self, origin, direction) -> None:
        self.debug_rays.append((tuple(map(float, origin)),
                                tuple(map(float, direction))))
        if self.show_rays:
            self._rebuild_rays()

    def clear_debug_rays(self) -> None:
        self.debug_rays.clear()
        if self.show_rays:
            self._rebuild_rays()

    # -- toggles -------------------------------------------------------------
    def toggle_frustum(self) -> None:
        self.show_frustum = not self.show_frustum
        if self.show_frustum:
            cam = self.scene.camera
            aspect = self.scene.width / self.scene.height
            tris = generate_frustum_wireframe(cam, aspect,
                                              far_dist=self.ray_length)
            self._frustum_mesh = self.scene.add_mesh(
                Mesh.from_triangles(tris), _viz_material((0.2, 0.9, 1.0)))
        elif self._frustum_mesh is not None:
            self.scene.remove_mesh(self._frustum_mesh)
            self._frustum_mesh = None

    def toggle_rays(self) -> None:
        self.show_rays = not self.show_rays
        self._rebuild_rays()

    def toggle_primary(self) -> None:
        self.show_primary = not self.show_primary
        if self.show_primary:
            cam = self.scene.camera
            tris = []
            for sx in np.linspace(0.1, 0.9, 4):
                for sy in np.linspace(0.1, 0.9, 3):
                    o, d = cam.ray_through(float(sx), float(sy))
                    tris.append(generate_arrow(o, d, self.ray_length,
                                               shaft_radius=0.008))
            self._primary_mesh = self.scene.add_mesh(
                Mesh.from_triangles(np.concatenate(tris)),
                _viz_material((1.0, 0.4, 0.9)))
        elif self._primary_mesh is not None:
            self.scene.remove_mesh(self._primary_mesh)
            self._primary_mesh = None

    def scale_ray_length(self, factor: float) -> None:
        self.ray_length = float(np.clip(self.ray_length * factor, 0.1, 100.0))
        if self.show_rays:
            self._rebuild_rays()

    def _rebuild_rays(self) -> None:
        if self._ray_mesh is not None:
            self.scene.remove_mesh(self._ray_mesh)
            self._ray_mesh = None
        if self.show_rays and self.debug_rays:
            tris = [generate_arrow(o, d, self.ray_length, shaft_radius=0.01)
                    for o, d in self.debug_rays]
            self._ray_mesh = self.scene.add_mesh(
                Mesh.from_triangles(np.concatenate(tris)), _viz_material())

    # -- frame-loop hook -----------------------------------------------------
    def handle_keys(self, keys: set) -> None:
        """Edge-triggered hotkeys (press events), like the GLFW key callback
        in the reference frame loop."""
        pressed = keys - self._prev_keys
        self._prev_keys = set(keys)
        if "f" in pressed:
            self.toggle_frustum()
        if "v" in pressed:
            self.toggle_rays()
        if "p" in pressed:
            self.toggle_primary()
        if "+" in pressed or "=" in pressed:
            self.scale_ray_length(1.25)
        if "-" in pressed:
            self.scale_ray_length(0.8)
        if "h" in pressed:
            print(HELP_TEXT)
