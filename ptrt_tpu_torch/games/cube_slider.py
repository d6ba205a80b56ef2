"""Cube Slider — the endless-runner demo game (counterpart of
``ptrt_tpu/games/cube_slider.py``).

A player cube slides down a glowing track, dodging dark obstacle cubes and
collecting emissive pickups.  The game state is a NamedTuple of tensors on
the scene's device and ``step`` is plain torch, in the reference's order of
operations; the scene follows the state through the unified scene's handles
(``sync_scene``, ``run_headless``) or as fused frames (``derive_scene``,
``run_fused``).  The initial level comes from JAX's threefry draws
(``core/threefry.py``), so a seed gives the reference's level.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ptrt_tpu_torch.core import threefry
from ptrt_tpu_torch.games.fused import DerivedScene, FusedRunner
from ptrt_tpu_torch.scene.materials import Material, Materials
from ptrt_tpu_torch.scene.unified import UnifiedScene, UnifiedSceneBuilder

N_OBSTACLES = 6
N_PICKUPS = 3
TRACK_HALF_W = 2.2
PLAYER_Z = 0.0
SPEED = 8.0
LANE_ACCEL = 18.0
DT = 1.0 / 30.0  # the scripted loops' fixed tick


class GameState(NamedTuple):
    t: torch.Tensor  # game time, 0-d float32
    player_x: torch.Tensor
    player_vx: torch.Tensor
    obstacle_z: torch.Tensor  # (N,) distance ahead
    obstacle_x: torch.Tensor
    pickup_z: torch.Tensor
    pickup_x: torch.Tensor
    pickup_alive: torch.Tensor  # bool (N,)
    score: torch.Tensor
    alive: torch.Tensor  # bool, 0-d


def jax_linspace(start: float, stop: float, num: int,
                 device="cpu") -> torch.Tensor:
    """float32 ``jnp.linspace(start, stop, num)`` as XLA compiles it in a
    jitted function: the step ``i * float32(1 / (num - 1))`` (XLA turns a
    division by a constant into a product with its reciprocal), then
    ``start * (1 - step) + stop * step``, the last value ``stop``.  (An
    eager ``jnp.linspace`` fuses that last sum into one multiply-add; at
    the cube slider's 6 and 3 points the two agree.)"""
    f = np.float32
    if num == 1:
        return torch.tensor([f(start)], device=device)
    it = torch.arange(num - 1, dtype=torch.float32, device=device)
    st = it * float(f(1.0) / f(num - 1))
    head = float(f(start)) * (1.0 - st) + float(f(stop)) * st
    return torch.cat([head, torch.full((1,), float(f(stop)),
                                       dtype=torch.float32, device=device)])


def init_state(seed: int = 0, device="cuda") -> GameState:
    """The level of ``seed``: the reference's ``init_state(seed)`` bit for
    bit (its threefry draws in numpy), on ``device``."""
    k1, k2, k3, k4 = threefry.split(threefry.prng_key(seed), 4)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(device)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    u = threefry.uniform
    return GameState(
        t=zero, player_x=zero.clone(), player_vx=zero.clone(),
        obstacle_z=jax_linspace(10.0, 60.0, N_OBSTACLES, device)
        + t(u(k1, (N_OBSTACLES,))) * 4.0,
        obstacle_x=t(u(k2, (N_OBSTACLES,), -TRACK_HALF_W, TRACK_HALF_W)),
        pickup_z=jax_linspace(15.0, 55.0, N_PICKUPS, device)
        + t(u(k3, (N_PICKUPS,))) * 5.0,
        pickup_x=t(u(k4, (N_PICKUPS,), -TRACK_HALF_W, TRACK_HALF_W)),
        pickup_alive=torch.ones(N_PICKUPS, dtype=torch.bool, device=device),
        score=zero.clone(),
        alive=torch.ones((), dtype=torch.bool, device=device),
    )


def step(state: GameState, steer: torch.Tensor,
         dt: torch.Tensor) -> GameState:
    """One fixed game tick.  ``steer`` in [-1, 1] and ``dt`` are 0-d
    float32 tensors (on the host or the state's device)."""
    alive_f = state.alive.to(torch.float32)
    vx = state.player_vx + steer * LANE_ACCEL * dt
    vx = vx * 0.92  # lane damping
    px = torch.clamp(state.player_x + vx * dt * alive_f, -TRACK_HALF_W,
                     TRACK_HALF_W)

    # the world scrolls toward the player
    oz = state.obstacle_z - SPEED * dt * alive_f
    pz = state.pickup_z - SPEED * dt * alive_f

    # passed obstacles come back ahead in a hash-scrambled lane
    def recycle(z, x, salt):
        passed = z < -2.0
        h = torch.sin(z * 12.9898 + x * 78.233 + salt) * 43758.5453
        new_x = (h - torch.floor(h)) * 2.0 * TRACK_HALF_W - TRACK_HALF_W
        return torch.where(passed, z + 64.0, z), torch.where(passed, new_x,
                                                             x)

    oz, ox = recycle(oz, state.obstacle_x, 1.0)
    passed_pk = pz < -2.0  # recycled pickups come back alive
    pz, pxk = recycle(pz, state.pickup_x, 2.0)

    # collisions (box overlap in x and z at the player's z)
    hit_obs = ((torch.abs(oz - PLAYER_Z) < 0.9)
               & (torch.abs(ox - px) < 0.9)).any()
    got_pick = ((torch.abs(pz - PLAYER_Z) < 0.8)
                & (torch.abs(pxk - px) < 0.8) & state.pickup_alive)
    score = (state.score + got_pick.sum() * 10.0
             + SPEED * dt * 0.5 * alive_f)
    pk_alive = (state.pickup_alive | passed_pk) & ~got_pick

    return GameState(
        t=state.t + dt,
        player_x=px,
        player_vx=vx,
        obstacle_z=oz,
        obstacle_x=ox,
        pickup_z=pz,
        pickup_x=pxk,
        pickup_alive=pk_alive,
        score=score,
        alive=state.alive & ~hit_obs,
    )


def build_scene(width: int = 640, height: int = 360,
                device="cuda") -> tuple:
    """The purple-glow track world: (UnifiedScene, Scene on ``device``)."""
    u = UnifiedScene(width, height)
    u.set_sky_gradient((0.55, 0.5, 0.75), (0.45, 0.42, 0.6))

    track = Material.make((0.75, 0.6, 0.95), 0.4)
    track = track.replace(emission=(0.25, 0.18, 0.4))
    u.add_plane_xz(-0.5, 200.0, track).set_name("track")

    player = u.add_cube(Materials.Silver()).set_name("player")
    player.set_scale(0.8).set_dynamic(True)

    for i in range(N_OBSTACLES):
        ob = u.add_cube(Material.make((0.08, 0.06, 0.1), 0.6))
        ob.set_name(f"obstacle_{i}").set_scale(0.9).set_dynamic(True)
    for i in range(N_PICKUPS):
        pk = u.add_cube(Materials.EmissiveLamp((1.0, 0.5, 1.0), 6.0))
        pk.set_name(f"pickup_{i}").set_scale(0.5).set_dynamic(True)

    u.add_point_light((0, 8, 4), (0.9, 0.8, 1.0), 3.0, range=40.0,
                      radius=0.3)
    u.set_camera((0, 2.2, -4.5), (0, 0.4, 6.0), (0, 1, 0), 55.0)
    u.samples_per_pixel = 1
    u.max_bounce_depth = 3
    return u, UnifiedSceneBuilder.build_pt_scene(u, device=device)


def sync_scene(u: UnifiedScene, pt_scene, state: GameState) -> None:
    """Push the game state into the scene through handles (the reference's
    per-frame edit and commit path; it reads the state to the host)."""
    s = GameState(*[np.asarray(f.cpu()) for f in state])
    u.find_object("player").set_position((float(s.player_x), 0.0, PLAYER_Z))
    for i in range(N_OBSTACLES):
        u.find_object(f"obstacle_{i}").set_position(
            (float(s.obstacle_x[i]), 0.0, float(s.obstacle_z[i])))
    for i in range(N_PICKUPS):
        y = 0.2 if bool(s.pickup_alive[i]) else -100.0  # hide collected
        u.find_object(f"pickup_{i}").set_position(
            (float(s.pickup_x[i]), y, float(s.pickup_z[i])))
    UnifiedSceneBuilder.update_pt_scene(pt_scene, u)


def derive_scene(state: GameState, base_rot: torch.Tensor,
                 base_scale: torch.Tensor) -> DerivedScene:
    """Game state -> each instance's TRS (dynamic-mesh order: player,
    obstacles, pickups).  A collected pickup hides by dropping far below
    the track."""
    zero = torch.zeros_like(state.player_x)
    player = torch.stack([state.player_x, zero, zero + PLAYER_Z])[None, :]
    obst = torch.stack([state.obstacle_x, torch.zeros_like(state.obstacle_x),
                        state.obstacle_z], dim=-1)
    pk_y = torch.where(state.pickup_alive, 0.2, -100.0)
    pick = torch.stack([state.pickup_x, pk_y, state.pickup_z], dim=-1)
    pos = torch.cat([player, obst, pick], dim=0)
    return DerivedScene(pos=pos, rot=base_rot, scale=base_scale)


def base_trs(scene) -> tuple:
    """The dynamic meshes' rotations and scales as (I, 3) tensors on the
    scene's device (what ``derive_scene`` keeps from the built scene)."""
    dyn = [m for m in scene.meshes if m.is_dynamic]
    t = lambda a: torch.from_numpy(np.stack(a).astype(np.float32)).to(
        scene.device)
    return (t([m.transform.rotation for m in dyn]),
            t([m.transform.scale for m in dyn]))


def script_inputs(i: int) -> tuple:
    """Frame ``i``'s scripted input: (steer, dt) as 0-d float32 host
    tensors (a ``FusedRunner`` stages them on the device)."""
    return (torch.tensor(np.float32(np.sin(i * 0.2))),
            torch.tensor(np.float32(DT)))


def make_runner(scene) -> FusedRunner:
    base_rot, base_scale = base_trs(scene)
    return FusedRunner(
        scene, step_fn=lambda s, inp: step(s, inp[0], inp[1]),
        derive_fn=lambda s: derive_scene(s, base_rot, base_scale))


def run_fused(n_frames: int = 60, width: int = 640, height: int = 360,
              preset: str = "fast", present=None, device="cuda"):
    """The north-star loop: the step, the scene update and the frame, no
    host scene edit.  Returns (state, frames a second, last RGB8)."""
    u, scene = build_scene(width, height, device)
    scene.set_performance_preset(preset)
    runner = make_runner(scene)
    return runner.run(init_state(0, scene.device), script_inputs, n_frames,
                      present=present)


def run_headless(n_steps: int = 30, width: int = 160, height: int = 90,
                 render_every: int = 10, preset: str = "fast",
                 device="cuda"):
    """Drive the game loop through handles; returns (final state, the
    frames rendered as numpy)."""
    u, scene = build_scene(width, height, device)
    scene.set_performance_preset(preset)
    state = init_state(0, scene.device)
    frames = []
    for i in range(n_steps):
        state = step(state, *script_inputs(i))
        sync_scene(u, scene, state)
        if i % render_every == 0:
            frames.append(scene.render_frame())
    return state, frames
