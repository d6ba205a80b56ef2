"""Heightfield fluid feeding the dynamic-triangle path (counterpart of
``ptrt_tpu/games/fluid.py``).

A damped 2D wave equation on an (N, N) grid — one stencil pass a tick,
plain torch in the reference's order of operations — and the heightfield
turned into a triangle soup each frame.  Through handles
(``run_headless``) the soup refills the mesh with ``set_triangles``; as a
fused frame (``run_fused``) it refits the surface's BVH in place on the
device (K5), with no host rebuild.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ptrt_tpu_torch.games.cube_slider import jax_linspace
from ptrt_tpu_torch.games.fused import DerivedScene, FusedRunner
from ptrt_tpu_torch.scene.materials import Materials
from ptrt_tpu_torch.scene.unified import UnifiedScene, UnifiedSceneBuilder

WAVE_SPEED = 6.0
DAMPING = 0.995
DT = 1.0 / 30.0


class FluidState(NamedTuple):
    height: torch.Tensor  # (N, N) water height
    velocity: torch.Tensor  # (N, N) vertical velocity


def _div(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` correctly rounded on every device (a CUDA kernel given a
    host scalar divisor multiplies by its reciprocal)."""
    return torch.div(t, torch.full_like(t, c))


def _grid(n: int, device) -> tuple:
    """``jnp.mgrid[0:n, 0:n]``: (ys, xs) as float32."""
    r = torch.arange(n, dtype=torch.float32, device=device)
    return r[:, None].expand(n, n), r[None, :].expand(n, n)


def init_state(n: int = 32, drop: bool = True, device="cuda") -> FluidState:
    h = torch.zeros((n, n), dtype=torch.float32, device=device)
    if drop:
        ys, xs = _grid(n, device)
        r2 = (xs - n * 0.35) ** 2 + (ys - n * 0.5) ** 2
        h = h + 0.6 * torch.exp(_div(-r2, 0.02 * n * n))
    return FluidState(height=h, velocity=torch.zeros((n, n),
                                                     dtype=torch.float32,
                                                     device=device))


def step(state: FluidState, dt: torch.Tensor, wave_speed: torch.Tensor,
         damping: torch.Tensor) -> FluidState:
    """Damped 2D wave equation, wrapping borders — one stencil pass.  The
    scalars are 0-d float32 tensors (on the host or the state's device)."""
    h = state.height
    lap = (
        torch.roll(h, 1, 0) + torch.roll(h, -1, 0)
        + torch.roll(h, 1, 1) + torch.roll(h, -1, 1) - 4.0 * h
    )
    v = (state.velocity + wave_speed * wave_speed * lap * dt) * damping
    return FluidState(height=h + v * dt, velocity=v)


def add_drop(state: FluidState, x: float, y: float, amplitude: float = 0.5,
             radius: float = 0.05) -> FluidState:
    n = state.height.shape[0]
    ys, xs = _grid(n, state.height.device)
    r2 = (_div(xs, n) - x) ** 2 + (_div(ys, n) - y) ** 2
    return state._replace(height=state.height + amplitude * torch.exp(
        _div(-r2, radius * radius)))


def heightfield_to_triangles(height: torch.Tensor, extent: float = 4.0,
                             base_y: float = 0.0) -> torch.Tensor:
    """(N, N) heights -> (T, 3, 3) triangle soup, two triangles a cell,
    the grid as ``jnp.linspace`` gives it."""
    n = height.shape[0]
    xs = jax_linspace(-extent / 2, extent / 2, n, height.device)
    px = xs[None, :].expand(n, n)
    pz = xs[:, None].expand(n, n)
    # XLA drops an add of 0.0, which keeps a -0.0 height's sign
    py = base_y + height if base_y != 0.0 else height

    p = torch.stack([px, py, pz], dim=-1)  # (n, n, 3)
    a = p[:-1, :-1]
    b = p[:-1, 1:]
    c = p[1:, 1:]
    d = p[1:, :-1]
    t1 = torch.stack([a, c, b], dim=-2)  # winding: up-facing normals
    t2 = torch.stack([a, d, c], dim=-2)
    return torch.cat([t1.reshape(-1, 3, 3), t2.reshape(-1, 3, 3)], 0)


def build_scene(width: int = 320, height: int = 180, n: int = 24,
                device="cuda") -> tuple:
    """Water pool: the fluid surface, a floor and a light rig.  Returns
    (UnifiedScene, Scene on ``device``, the initial state there)."""
    u = UnifiedScene(width, height)
    u.set_sky_gradient((0.5, 0.65, 0.9), (0.9, 0.95, 1.0))
    state = init_state(n, device="cpu")
    tris = heightfield_to_triangles(state.height).numpy()
    u.add_triangles(tris, Materials.Water()).set_name("fluid")
    u.add_plane_xz(-0.6, 12.0, Materials.Concrete()).set_name("floor")
    u.add_point_light((3, 5, 2), (1.0, 0.95, 0.9), 4.0, range=30.0,
                      radius=0.2)
    u.add_directional_light((-0.4, -1.0, -0.3), (0.7, 0.8, 1.0), 0.8)
    u.set_camera((0, 2.5, -4.0), (0, 0, 0), (0, 1, 0), 55.0)
    u.samples_per_pixel = 1
    u.max_bounce_depth = 4
    scene = UnifiedSceneBuilder.build_pt_scene(u, device=device)
    return u, scene, FluidState(*[f.to(scene.device) for f in state])


def derive_scene(state: FluidState) -> DerivedScene:
    """Fluid state -> scene update: the identity transform and a device
    refit of the surface's BVH from the new heightfield."""
    tris = heightfield_to_triangles(state.height)
    dev = tris.device
    f32 = dict(dtype=torch.float32, device=dev)
    return DerivedScene(
        pos=torch.zeros((1, 3), **f32), rot=torch.zeros((1, 3), **f32),
        scale=torch.ones((1, 3), **f32),
        refits={0: tuple(tris[:, k].contiguous() for k in range(3))})


def step_scalars() -> tuple:
    """(dt, wave speed, damping) as 0-d float32 host tensors (a fused
    frame's input is dt, which a ``FusedRunner`` stages on the device; the
    other two are the step's constants)."""
    f = lambda v: torch.tensor(np.float32(v))
    return f(DT), f(WAVE_SPEED), f(DAMPING)


def make_runner(scene) -> FusedRunner:
    _, ws, damp = step_scalars()
    return FusedRunner(scene,
                       step_fn=lambda s, dt_: step(s, dt_, ws, damp),
                       derive_fn=derive_scene)


def run_fused(n_frames: int = 30, width: int = 320, height: int = 180,
              grid: int = 24, preset: str = "fast", present=None,
              device="cuda"):
    """The step, the refit and the frame fused; returns (state, frames a
    second, last RGB8)."""
    u, scene, state = build_scene(width, height, grid, device)
    scene.set_performance_preset(preset)
    dt = step_scalars()[0]
    return make_runner(scene).run(state, lambda i: dt, n_frames,
                                  present=present)


def run_headless(n_steps: int = 20, width: int = 160, height: int = 90,
                 grid: int = 24, render_every: int = 10, device="cuda"):
    """Through handles: each tick's soup to the host and into
    ``set_triangles``; returns (final state, frames as numpy)."""
    u, scene, state = build_scene(width, height, grid, device)
    scene.set_performance_preset("fast")
    frames = []
    dt, ws, damp = step_scalars()
    for i in range(n_steps):
        state = step(state, dt, ws, damp)
        tris = heightfield_to_triangles(state.height).cpu().numpy()
        u.find_object("fluid").set_triangles(tris)
        UnifiedSceneBuilder.update_pt_scene(scene, u)
        if i % render_every == 0:
            frames.append(scene.render_frame())
    return state, frames
