"""Tycoon — the grid-building demo game (counterpart of
``ptrt_tpu/games/tycoon.py``).

Voxel buildings placed on a dark ground plane.  ``TycoonGame`` is the
handle-based game: an economy tick, an occupancy grid, and each placement
a dynamic cube stack instantiated through the unified scene (a demolished
one collapses to scale 1e-5 at y = -100).  The fused variant pre-allocates
a dynamic slot for every (cell, building type) pair, collapsed to scale
1e-6 in place while hidden, so placing and demolishing are edits of the
device state inside the step (``fused_step``), and the frame needs no host
scene edit (``run_fused``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ptrt_tpu_torch.games.fused import DerivedScene, FusedRunner
from ptrt_tpu_torch.scene.materials import Material, Materials
from ptrt_tpu_torch.scene.unified import (UnifiedMeshDesc, UnifiedScene,
                                          UnifiedSceneBuilder)

GRID = 8
CELL = 2.0

BUILDING_TYPES = [
    # (name, cost, income/s, height, material factory)
    ("hut", 50.0, 2.0, 0.8, lambda: Materials.WoodOak()),
    ("shop", 120.0, 6.0, 1.4, lambda: Materials.PlasticRed()),
    ("tower", 400.0, 18.0, 3.0, lambda: Materials.Chrome()),
]


class EconomyState(NamedTuple):
    money: torch.Tensor
    income: torch.Tensor
    t: torch.Tensor


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(np.float32(v), device=device)


def init_economy(start_money: float = 100.0, device="cuda") -> EconomyState:
    return EconomyState(money=_f32(start_money, device),
                        income=_f32(0.0, device), t=_f32(0.0, device))


def tick(state: EconomyState, dt: torch.Tensor) -> EconomyState:
    return EconomyState(money=state.money + state.income * dt,
                        income=state.income, t=state.t + dt)


def _base_scene(width: int, height: int) -> UnifiedScene:
    u = UnifiedScene(width, height)
    u.set_sky_gradient((0.45, 0.45, 0.55), (0.25, 0.22, 0.25))
    u.add_plane_xz(0.0, GRID * CELL,
                   Material.make((0.25, 0.18, 0.12), 0.8)).set_name("map")
    u.add_directional_light((-0.4, -1.0, -0.2), (1.0, 0.95, 0.85), 1.2)
    u.add_point_light((0, 10, -6), (0.9, 0.9, 1.0), 3.0, range=50.0,
                      radius=0.3)
    u.set_camera((0, 9, -14), (0, 0, 0), (0, 1, 0), 50.0)
    u.samples_per_pixel = 1
    u.max_bounce_depth = 3
    return u


class TycoonGame:
    def __init__(self, width: int = 320, height: int = 180, device="cuda"):
        self.unified = _base_scene(width, height)
        self.scene = UnifiedSceneBuilder.build_pt_scene(self.unified,
                                                        device=device)
        self.economy = init_economy(device=self.scene.device)
        self.grid = np.full((GRID, GRID), -1, np.int32)  # building type ids
        self.build_mode = False

    # -- game verbs ----------------------------------------------------------
    def toggle_build_mode(self) -> bool:
        self.build_mode = not self.build_mode
        return self.build_mode

    def can_place(self, gx: int, gz: int, type_id: int) -> bool:
        if not (0 <= gx < GRID and 0 <= gz < GRID):
            return False
        if self.grid[gz, gx] >= 0:
            return False
        return float(self.economy.money) >= BUILDING_TYPES[type_id][1]

    def place_building(self, gx: int, gz: int, type_id: int) -> bool:
        """Spend money, mark the grid, spawn the building's mesh."""
        if not self.can_place(gx, gz, type_id):
            return False
        name, cost, income, h, mat = BUILDING_TYPES[type_id]
        self.economy = EconomyState(
            money=self.economy.money - cost,
            income=self.economy.income + income,
            t=self.economy.t)
        self.grid[gz, gx] = type_id
        x = (gx - (GRID - 1) / 2.0) * CELL
        z = (gz - (GRID - 1) / 2.0) * CELL
        handle = self.unified.instantiate_object(
            UnifiedMeshDesc.Cube(mat()), name=f"b_{gx}_{gz}")
        handle.set_scale((1.4, h, 1.4)).set_position((x, h / 2.0, z))
        UnifiedSceneBuilder.update_pt_scene(self.scene, self.unified)
        return True

    def demolish(self, gx: int, gz: int) -> bool:
        if not (0 <= gx < GRID and 0 <= gz < GRID) or self.grid[gz, gx] < 0:
            return False
        tid = int(self.grid[gz, gx])
        self.grid[gz, gx] = -1
        self.economy = EconomyState(
            money=self.economy.money,
            income=self.economy.income - BUILDING_TYPES[tid][2],
            t=self.economy.t)
        # hide by a scale collapse (the reference's hidden <-> visible trick)
        self.unified.find_object(f"b_{gx}_{gz}").set_scale(1e-5) \
            .set_position((0, -100, 0))
        UnifiedSceneBuilder.update_pt_scene(self.scene, self.unified)
        return True

    def update(self, dt: float) -> None:
        self.economy = tick(self.economy, torch.tensor(np.float32(dt)))

    def render(self) -> np.ndarray:
        return self.scene.render_frame()


# -- fused variant ------------------------------------------------------------


class FusedTycoonState(NamedTuple):
    grid: torch.Tensor  # (GRID, GRID) int32 building type, -1 = empty
    pop: torch.Tensor  # (GRID, GRID) float32 pop-up animation in [0, 1]
    money: torch.Tensor
    income: torch.Tensor
    t: torch.Tensor


def init_fused_state(start_money: float = 200.0, device="cuda",
                     grid: int | None = None) -> FusedTycoonState:
    """The empty ``grid`` x ``grid`` map (``GRID`` by default)."""
    n = GRID if grid is None else grid
    return FusedTycoonState(
        grid=torch.full((n, n), -1, dtype=torch.int32, device=device),
        pop=torch.zeros((n, n), dtype=torch.float32, device=device),
        money=_f32(start_money, device), income=_f32(0.0, device),
        t=_f32(0.0, device))


# action codes of the fused step's input tuple
ACT_NONE, ACT_PLACE, ACT_DEMOLISH = 0, 1, 2


def _int(v, device) -> torch.Tensor:
    return v if torch.is_tensor(v) else torch.tensor(
        int(v), dtype=torch.int32, device=device)


def _pick(idx: torch.Tensor, values) -> torch.Tensor:
    """``float32(values)[idx]`` for a few host constants, chosen on the
    device by selects (no table copied to the card); ``idx`` in range."""
    out = torch.full(idx.shape, float(values[0]), dtype=torch.float32,
                     device=idx.device)
    for k, v in enumerate(values[1:], start=1):
        out = torch.where(idx == k, float(v), out)
    return out


def fused_step(s: FusedTycoonState, inp) -> FusedTycoonState:
    """One tick: the economy and at most one build or demolish action, on
    the device, as the reference's jitted step.  ``inp`` = (action, gx,
    gz, type_id, dt): 0-d int32 tensors and a 0-d float32 ``dt`` on the
    state's device (a runner stages them there; Python ints are made
    tensors here).  The map is ``s.grid``'s size."""
    action, gx, gz, tid, dt = inp
    n = s.grid.shape[0]
    dev = s.grid.device
    action, gx, gz, tid = (_int(v, dev) for v in (action, gx, gz, tid))
    costs = [b[1] for b in BUILDING_TYPES]
    incomes = [b[2] for b in BUILDING_TYPES]
    inb = (gx >= 0) & (gx < n) & (gz >= 0) & (gz < n)
    gxc = torch.clamp(gx, 0, n - 1)
    gzc = torch.clamp(gz, 0, n - 1)
    tidc = torch.clamp(tid, 0, len(BUILDING_TYPES) - 1)
    # the cell by a flat index_select and the writes by a select over the
    # map: indexing with a 0-d device tensor would read it to the host
    flat = (gzc * n + gxc).to(torch.int64).reshape(1)
    cell = s.grid.reshape(-1).index_select(0, flat).reshape(())
    at = torch.arange(n * n, device=dev).reshape(n, n) == flat
    cost = _pick(tidc, costs)
    can_place = ((action == ACT_PLACE) & inb & (cell < 0)
                 & (s.money >= cost))
    can_demo = (action == ACT_DEMOLISH) & inb & (cell >= 0)
    grid = torch.where(at & can_place, tidc.to(torch.int32), s.grid)
    grid = torch.where(at & can_demo, -1, grid)
    money = s.money + s.income * dt - torch.where(can_place, cost, 0.0)
    income = (s.income
              + torch.where(can_place, _pick(tidc, incomes), 0.0)
              - torch.where(can_demo,
                            _pick(torch.clamp(cell, min=0), incomes), 0.0))
    pop = torch.clamp(s.pop + 2.0 * dt, 0.0, 1.0)
    pop = torch.where(at & can_place, 0.0, pop)
    return FusedTycoonState(grid=grid, pop=pop, money=money, income=income,
                            t=s.t + dt)


def _cell_centers(grid: int | None = None) -> np.ndarray:
    n = GRID if grid is None else grid
    gx, gz = np.meshgrid(np.arange(n), np.arange(n), indexing="xy")
    x = (gx - (n - 1) / 2.0) * CELL
    z = (gz - (n - 1) / 2.0) * CELL
    return np.stack([x.reshape(-1), np.zeros(n * n),
                     z.reshape(-1)], axis=1).astype(np.float32)


def derive_fused_scene(s: FusedTycoonState,
                       centers: torch.Tensor) -> DerivedScene:
    """(grid^2 x types) instance TRS from the grid: the instance of (type
    t, cell c) shows iff grid[c] == t, with a pop-up height animation;
    hidden ones collapse to scale 1e-6 in place."""
    grid = s.grid.reshape(-1)  # (C,)
    anim = 0.2 + 0.8 * s.pop.reshape(-1)  # pop-up ease
    pos_list, scale_list = [], []
    for t, b in enumerate(BUILDING_TYPES):
        vis = grid == t
        h = float(np.float32(b[3])) * anim
        sy = torch.where(vis, h, 1e-6)
        sxz = torch.where(vis, 1.4, 1e-6)
        pos_list.append(torch.stack(
            [centers[:, 0], sy * 0.5, centers[:, 2]], dim=1))
        scale_list.append(torch.stack([sxz, sy, sxz], dim=1))
    pos = torch.cat(pos_list)
    return DerivedScene(pos=pos, rot=torch.zeros_like(pos),
                        scale=torch.cat(scale_list))


def build_fused_scene(width: int = 640, height: int = 360, device="cuda",
                      grid: int | None = None):
    """The scene with grid^2 x types pre-allocated dynamic building slots
    (type-major, as ``derive_fused_scene`` orders them; ``grid`` is
    ``GRID`` by default, the reference's map): (UnifiedScene, Scene on
    ``device``, the cell centres there)."""
    n = GRID if grid is None else grid
    u = _base_scene(width, height)
    centers = _cell_centers(n)
    for t, (name, _, _, _, mat) in enumerate(BUILDING_TYPES):
        for c in range(n * n):
            h = u.add_cube(mat())
            h.set_name(f"slot_{name}_{c}")
            h.set_position((float(centers[c, 0]), -100.0,
                            float(centers[c, 2]))).set_scale(1e-6)
            u.meshes[h.index].is_dynamic = True
    scene = UnifiedSceneBuilder.build_pt_scene(u, device=device)
    return u, scene, torch.from_numpy(centers).to(scene.device)


def run_script(n_frames: int, grid: int | None = None) -> list:
    """``run_fused``'s scripted input: a random placement every third
    frame (seed 7), (action, gx, gz, type) a frame."""
    n = GRID if grid is None else grid
    rng = np.random.default_rng(7)
    script = [(ACT_PLACE, int(rng.integers(0, n)),
               int(rng.integers(0, n)), int(rng.integers(0, 3)))
              for _ in range(n_frames + 1)]
    return [script[i] if i % 3 == 0 else (ACT_NONE, 0, 0, 0)
            for i in range(n_frames + 1)]


def make_runner(scene, centers) -> FusedRunner:
    return FusedRunner(scene, step_fn=fused_step,
                       derive_fn=lambda s: derive_fused_scene(s, centers))


def run_fused(n_frames: int = 60, width: int = 640, height: int = 360,
              preset: str = "fast", present=None, device="cuda"):
    """The fused tycoon loop: scripted placements taken inside the step.
    Returns (state, frames a second, last RGB8)."""
    u, scene, centers = build_fused_scene(width, height, device)
    scene.set_performance_preset(preset)
    dt = torch.tensor(np.float32(1.0 / 30.0))
    script = run_script(n_frames)
    return make_runner(scene, centers).run(
        init_fused_state(device=scene.device),
        lambda i: (*script[i], dt), n_frames, present=present)


def run_headless(n_steps: int = 8, width: int = 160, height: int = 90,
                 device="cuda"):
    """A scripted session through handles: earn, build, render."""
    game = TycoonGame(width, height, device)
    game.scene.set_performance_preset("fast")
    frames = [game.render()]
    placements = [(2, 2, 0), (3, 2, 0), (5, 4, 1), (2, 5, 0)]
    pi = 0
    for i in range(n_steps):
        game.update(1.0)
        if pi < len(placements):
            gx, gz, tid = placements[pi]
            if game.place_building(gx, gz, tid):
                pi += 1
    frames.append(game.render())
    return game, frames
