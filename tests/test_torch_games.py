"""The port's games (``ptrt_tpu_torch/games``) against the JAX package's.

The same seeds and scripts go through both packages; where a state is
carried across it goes through ``tables.from_reference(game_state=...)``.
Tolerances, each for a stated reason:

* the threefry draws and the cube slider's initial level: bit for bit
  (seeds 0, 1, 7, 12345);
* ``cube_slider.step`` over 90 ticks of the scripted steering: the time,
  the obstacles' and pickups' z, the score, ``alive`` and the pickups'
  flags bit for bit; the player's x and lane speed within 2e-6 relative
  plus 1e-6 absolute (XLA's CPU backend fuses the lane speed's
  multiply-adds in the jitted step, torch rounds each product, and the
  damping loop carries that ulp along); an obstacle or pickup x bit for
  bit until it is recycled, then within 0.05 (the recycle hash
  ``fract(sin(z 12.9898 + x 78.233 + salt) 43758.5453)`` turns an ulp of
  ``sin``'s argument, ~4e-6 at z ~ 60, into ~4e-6 x 12.99 x 43758 ~ 2 of
  its product before the fract: the lane may land anywhere; measured 0.017
  on this script);
* ``fluid.step`` over 50 ticks from the reference's state: heights within
  1e-6, velocities within 5e-6 (the fused multiply-adds again; heights are
  O(0.6), the velocities O(5)); ``add_drop`` within 1e-7 (``exp``'s ulps);
  ``heightfield_to_triangles`` of the same heights bit for bit (the grid as
  XLA computes ``jnp.linspace`` inside the jitted function);
* ``tycoon.fused_step`` and each game's ``derive_*``: bit for bit;
* the fused cube slider's last frame at 48x32 "fast" against the
  reference's ``run_fused`` from the same PCG state: within 1 LSB on at
  least 99% of the pixels (``tests/test_torch_dynamic.py``'s frame
  tolerance).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ptrt_tpu.games import cube_slider as ref_cs
from ptrt_tpu.games import fluid as ref_fl
from ptrt_tpu.games import tycoon as ref_ty

from ptrt_tpu_torch import tables
from ptrt_tpu_torch.core import threefry
from ptrt_tpu_torch.games import cube_slider, fluid, tycoon
from ptrt_tpu_torch.geometry import scene_geom, tlas
from ptrt_tpu_torch.scene import pt_scene, unified
from test_torch_shading import torch_one_thread  # noqa: F401

CPU = torch.device("cpu")
SEEDS = (0, 1, 7, 12345)
DT = np.float32(1.0 / 30.0)


def _np(x) -> np.ndarray:
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


def _bits_equal(a, b) -> bool:
    a, b = _np(a), _np(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


def _carry(cls, ref_state):
    """A reference game state in the port, through ``tables``."""
    fields = {k: np.asarray(getattr(ref_state, k)) for k in ref_state._fields}
    return tables.from_reference(device=CPU, game_state=(cls, fields))[
        "game_state"]


# -- threefry and the initial level -------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert _bits_equal(key, threefry.prng_key(seed))
    keys = jax.random.split(key, 4)
    mine = threefry.split(threefry.prng_key(seed), 4)
    assert _bits_equal(keys, mine)
    for k, m in zip(keys, mine):
        for shape, lo, hi in (((6,), 0.0, 1.0), ((3,), -2.2, 2.2),
                              ((5,), -7.0, 3.5)):
            assert _bits_equal(jax.random.uniform(k, shape, minval=lo,
                                                  maxval=hi),
                               threefry.uniform(m, shape, lo, hi))


@pytest.mark.parametrize("seed", SEEDS)
def test_cube_slider_init_state_bit_for_bit(seed):
    ref = ref_cs.init_state(seed)
    port = cube_slider.init_state(seed, device="cpu")
    for k in ref._fields:
        assert _bits_equal(getattr(ref, k), getattr(port, k)), k


@pytest.mark.parametrize("n", (3, 6, 8, 24, 256))
def test_linspace_as_jax_computes_it(n):
    """Eager ``jnp.linspace`` at the cube slider's counts, and the jitted
    one inside ``heightfield_to_triangles`` (checked through its
    triangles below): the port's grid is the jitted form."""
    got = cube_slider.jax_linspace(-2.0, 2.0, n)
    grid = np.asarray(ref_fl.heightfield_to_triangles(jnp.zeros((n, n))))
    xs = np.concatenate([grid[:(n - 1) ** 2].reshape(n - 1, n - 1, 3, 3)[
        0, :, 0, 0], grid[(n - 1) ** 2 - 1:(n - 1) ** 2, 2, 0]])
    assert _bits_equal(xs.astype(np.float32), got)
    if n in (3, 6):
        assert _bits_equal(jnp.linspace(10.0, 60.0, n),
                           cube_slider.jax_linspace(10.0, 60.0, n))


# -- the steps ----------------------------------------------------------------

def test_cube_slider_step_90_ticks():
    ref = ref_cs.init_state(0)
    port = cube_slider.init_state(0, device="cpu")
    lanes = {"obstacle_x": "obstacle_z", "pickup_x": "pickup_z"}
    # a lane is recycled when its z jumps back ahead
    recycled = {k: np.zeros(_np(getattr(port, k)).shape, bool)
                for k in lanes}
    for i in range(90):
        z_before = {k: _np(getattr(port, z)).copy() for k, z in lanes.items()}
        steer = np.float32(np.sin(i * 0.2))
        ref = ref_cs.step(ref, jnp.float32(steer), jnp.float32(DT))
        port = cube_slider.step(port, torch.tensor(steer), torch.tensor(DT))
        for k in ("t", "obstacle_z", "pickup_z", "score", "alive",
                  "pickup_alive"):
            assert _bits_equal(getattr(ref, k), getattr(port, k)), (i, k)
        for k in ("player_x", "player_vx"):
            np.testing.assert_allclose(_np(getattr(port, k)),
                                       _np(getattr(ref, k)), rtol=2e-6,
                                       atol=1e-6, err_msg=f"{i} {k}")
        for k, was in recycled.items():
            was |= _np(getattr(port, lanes[k])) > z_before[k]
            r, p = _np(getattr(ref, k)), _np(getattr(port, k))
            assert np.array_equal(r[~was], p[~was]), (i, k)
            assert (np.abs(r - p) <= 0.05).all(), (i, k)
    # the script recycles lanes and collects no pickup
    assert all(v.any() for v in recycled.values())
    assert bool(port.alive) and float(port.score) == float(ref.score) > 0


def test_fluid_step_50_ticks():
    ref = ref_fl.init_state(16)
    port = _carry(fluid.FluidState, ref)
    dt, ws, damp = fluid.step_scalars()
    for _ in range(50):
        ref = ref_fl.step(ref, jnp.float32(DT), jnp.float32(6.0),
                          jnp.float32(0.995))
        port = fluid.step(port, dt, ws, damp)
    np.testing.assert_allclose(_np(port.height), _np(ref.height), atol=1e-6)
    np.testing.assert_allclose(_np(port.velocity), _np(ref.velocity),
                               atol=5e-6)
    assert np.isfinite(_np(port.height)).all()
    # the port's own initial state: within exp's ulps
    np.testing.assert_allclose(_np(fluid.init_state(16, device="cpu").height),
                               _np(ref_fl.init_state(16).height), atol=1e-7)


@pytest.mark.parametrize("n", (8, 16, 24))
def test_add_drop_and_triangles(n):
    rng = np.random.default_rng(n)
    h = (rng.normal(size=(n, n)) * 0.3).astype(np.float32)
    h[0, 0], h[0, 1] = -0.0, 0.0
    ref = ref_fl.FluidState(jnp.asarray(h), jnp.asarray(h * 0.5))
    port = _carry(fluid.FluidState, ref)
    r = ref_fl.add_drop(ref, 0.3, 0.6, 0.4, 0.1)
    p = fluid.add_drop(port, 0.3, 0.6, 0.4, 0.1)
    np.testing.assert_allclose(_np(p.height), _np(r.height), atol=1e-7)
    tris = fluid.heightfield_to_triangles(torch.from_numpy(h))
    assert tris.shape == (2 * (n - 1) ** 2, 3, 3)
    assert _bits_equal(ref_fl.heightfield_to_triangles(jnp.asarray(h)), tris)


def _tycoon_steps(script, dt, start_money=200.0):
    ref = ref_ty.init_fused_state(start_money)
    port = tycoon.init_fused_state(start_money, device="cpu")
    for inp in script:
        ref = ref_ty.fused_step(ref, tuple(jnp.int32(v) for v in inp)
                                + (jnp.float32(dt),))
        port = tycoon.fused_step(port, (*inp, torch.tensor(np.float32(dt))))
        for k in ref._fields:
            assert _bits_equal(getattr(ref, k), getattr(port, k)), (inp, k)
    return ref, port


def test_tycoon_fused_step_placement_script(monkeypatch):
    """``tests/test_fused.py``'s script at GRID 3: a tower refused, a hut
    placed, then demolished."""
    monkeypatch.setattr(ref_ty, "GRID", 3)
    monkeypatch.setattr(tycoon, "GRID", 3)
    script = [(tycoon.ACT_PLACE, 1, 1, 2), (tycoon.ACT_PLACE, 1, 1, 0),
              (tycoon.ACT_DEMOLISH, 1, 1, 0), (tycoon.ACT_NONE, 0, 0, 0),
              (tycoon.ACT_PLACE, 7, -1, 0), (tycoon.ACT_DEMOLISH, 2, 2, 0)]
    ref, port = _tycoon_steps(script, 1.0)
    assert int(port.grid[1, 1]) == -1 and float(port.income) == 0.0


def test_tycoon_fused_step_run_script():
    """``run_fused``'s 61 inputs (seed 7), and the derived instances."""
    ref, port = _tycoon_steps(tycoon.run_script(60), DT)
    assert (_np(port.grid) >= 0).sum() >= 1
    centers = tycoon._cell_centers()
    assert _bits_equal(ref_ty._cell_centers(), centers)
    r = ref_ty.derive_fused_scene(ref, jnp.asarray(centers))
    p = tycoon.derive_fused_scene(port, torch.from_numpy(centers))
    for k in ("pos", "rot", "scale"):
        assert _bits_equal(getattr(r, k), getattr(p, k)), k


def test_derive_scenes_match_reference():
    ref = ref_cs.init_state(7)
    port = cube_slider.init_state(7, device="cpu")
    rot = np.random.default_rng(0).uniform(-1, 1, (10, 3)).astype(np.float32)
    scl = np.random.default_rng(1).uniform(0.5, 1, (10, 3)).astype(
        np.float32)
    r = ref_cs.derive_scene(ref._replace(pickup_alive=jnp.asarray(
        [True, False, True])), jnp.asarray(rot), jnp.asarray(scl))
    p = cube_slider.derive_scene(port._replace(pickup_alive=torch.tensor(
        [True, False, True])), torch.from_numpy(rot), torch.from_numpy(scl))
    for k in ("pos", "rot", "scale"):
        assert _bits_equal(getattr(r, k), getattr(p, k)), k
    fr = ref_fl.init_state(8)
    rd = ref_fl.derive_scene(fr)
    pd = fluid.derive_scene(_carry(fluid.FluidState, fr))
    for k in ("pos", "rot", "scale"):
        assert _bits_equal(getattr(rd, k), getattr(pd, k)), k
    assert list(rd.refits) == list(pd.refits) == [0]
    for a, b in zip(rd.refits[0], pd.refits[0]):
        assert _bits_equal(a, b)


def test_game_states_round_trip_tables():
    for ref, cls in ((ref_cs.init_state(3), cube_slider.GameState),
                     (ref_fl.init_state(8), fluid.FluidState),
                     (ref_ty.init_economy(), tycoon.EconomyState),
                     (ref_ty.init_fused_state(), tycoon.FusedTycoonState)):
        port = _carry(cls, ref)
        assert isinstance(port, cls)
        back = tables.to_numpy(port)
        assert set(back) == set(ref._fields)
        for k in ref._fields:
            assert _bits_equal(getattr(ref, k), back[k]), (cls, k)


# -- the handle game ----------------------------------------------------------

def test_tycoon_game_handles():
    g = tycoon.TycoonGame(32, 18, device="cpu")
    assert g.place_building(2, 2, 0)
    assert not g.place_building(2, 2, 0)  # occupied
    assert not g.place_building(9, 0, 0)  # off the map
    assert float(g.economy.income) > 0
    g.update(10.0)
    assert float(g.economy.money) == 50.0 + 20.0
    n = len(g.scene.meshes)
    assert g.scene.meshes[-1].is_dynamic
    img = g.render()
    assert img.shape == (18, 32, 3)
    assert g.demolish(2, 2)
    assert not g.demolish(2, 2)
    assert float(g.economy.income) == 0.0
    assert len(g.scene.meshes) == n  # hidden, not removed
    assert g.scene.meshes[-1].transform.scale == (1e-5, 1e-5, 1e-5)
    assert g.render().shape == (18, 32, 3)
    assert g.toggle_build_mode()


# -- fused runs (the reference's tests/test_fused.py on the port) ------------

def test_fused_cube_slider_smoke():
    state, fps, rgb8 = cube_slider.run_fused(n_frames=2, width=96,
                                             height=64, device="cpu")
    assert rgb8.shape == (64, 96, 3) and rgb8.dtype == np.uint8
    assert fps > 0
    assert float(state.t) > 0


def test_fused_fluid_refit_smoke():
    state, fps, rgb8 = fluid.run_fused(n_frames=2, width=96, height=64,
                                       grid=8, device="cpu")
    assert rgb8.shape == (64, 96, 3)
    assert fps > 0
    assert np.isfinite(_np(state.height)).all()


def test_fused_fluid_lbvh_smoke():
    u, scene, state = fluid.build_scene(96, 64, 8, device="cpu")
    scene.set_performance_preset("fast")
    for m in scene.meshes:
        if m.is_dynamic:
            m.device_lbvh = True
    dt = fluid.step_scalars()[0]
    state, fps, rgb8 = fluid.make_runner(scene).run(state, lambda i: dt, 2)
    assert rgb8.shape == (64, 96, 3)
    assert np.isfinite(_np(state.height)).all()
    assert rgb8.max() > 0


def test_fused_tycoon_placement(monkeypatch):
    """Placement and demolition are device actions inside the step: the
    economy and the grid respond with no host scene edit."""
    monkeypatch.setattr(tycoon, "GRID", 3)  # 27 slots
    u, scene, centers = tycoon.build_fused_scene(96, 64, device="cpu")
    scene.set_performance_preset("fast")
    runner = tycoon.make_runner(scene, centers)
    dt = torch.tensor(np.float32(1.0))
    script = [(tycoon.ACT_PLACE, 1, 1, 2), (tycoon.ACT_PLACE, 1, 1, 0),
              (tycoon.ACT_DEMOLISH, 1, 1, 0), (tycoon.ACT_NONE, 0, 0, 0)]
    state, fps, rgb8 = runner.run(
        tycoon.init_fused_state(200.0, device="cpu"),
        lambda i: (*script[i], dt), 3)
    assert rgb8.shape == (64, 96, 3)
    assert int(state.grid[1, 1]) == -1
    hut_cost, hut_income = tycoon.BUILDING_TYPES[0][1:3]
    assert float(state.money) == pytest.approx(200.0 - hut_cost + hut_income,
                                               abs=1e-3)
    assert float(state.income) == pytest.approx(0.0, abs=1e-5)
    assert runner.world.iset.count == 27


def test_fused_frame_matches_reference():
    """The fused cube slider's last frame, 48x32 "fast", both packages from
    the same PCG state (seeded at frame 0)."""
    _, _, got = cube_slider.run_fused(n_frames=2, width=48, height=32,
                                      device="cpu")
    _, _, want = ref_cs.run_fused(n_frames=2, width=48, height=32)
    lsb = (np.abs(got.astype(int) - np.asarray(want).astype(int)).max(-1)
           <= 1).mean()
    assert lsb >= 0.99, lsb


class _Forbidden(AssertionError):
    pass


def _forbid_host_updates(monkeypatch):
    def refuse(*a, **k):
        raise _Forbidden("a fused frame went through a host scene update")

    monkeypatch.setattr(pt_scene.Scene, "_rebuild_geometry", refuse)
    monkeypatch.setattr(tlas, "build_tlas", refuse)
    monkeypatch.setattr(scene_geom, "build_tlas", refuse)
    monkeypatch.setattr(unified.UnifiedSceneBuilder, "update_pt_scene",
                        staticmethod(refuse))


@pytest.mark.parametrize("game", ("cube_slider", "fluid", "tycoon"))
def test_fused_frames_make_no_host_scene_update(game, monkeypatch):
    """Once a FusedRunner is built, two frames of each game run with the
    host scene updates (``Scene._rebuild_geometry``, the host tree build,
    ``UnifiedSceneBuilder.update_pt_scene``) made to raise; the tree K11's
    plain version wrote equals the host build of its boxes."""
    if game == "cube_slider":
        _, sc = cube_slider.build_scene(48, 32, device="cpu")
        runner, state = (cube_slider.make_runner(sc),
                         cube_slider.init_state(0, device="cpu"))
        inputs = cube_slider.script_inputs
    elif game == "fluid":
        _, sc, state = fluid.build_scene(48, 32, 8, device="cpu")
        runner = fluid.make_runner(sc)
        inputs = lambda i, dt=fluid.step_scalars()[0]: dt
    else:
        monkeypatch.setattr(tycoon, "GRID", 3)
        _, sc, centers = tycoon.build_fused_scene(48, 32, device="cpu")
        runner = tycoon.make_runner(sc, centers)
        state = tycoon.init_fused_state(device="cpu")
        dt = torch.tensor(np.float32(1.0))
        inputs = lambda i: (tycoon.ACT_PLACE, i, 1, 0, dt)
    sc.set_performance_preset("fast")
    build_tlas = tlas.build_tlas
    _forbid_host_updates(monkeypatch)
    with pytest.raises(_Forbidden):
        sc._rebuild_geometry()
    state, fps, rgb8 = runner.run(state, inputs, 2)
    assert rgb8.shape == (32, 48, 3) and sc.frame_count == 3
    iset = runner.world.iset
    assert np.array_equal(
        iset.tlas.numpy(), build_tlas(iset.bb_min.numpy(),
                                      iset.bb_max.numpy()))
    if game == "tycoon":
        assert (_np(state.grid) >= 0).sum() == 3  # the warm-up and two


def test_frame_setup_copies_nothing_to_the_card(monkeypatch):
    """The camera rays and the upscale, which every PT frame runs, build no
    tensor from host data: on the card each such tensor was a synchronizing
    copy (``chip_smoke.py`` phase 15 counted ten a fused frame, one of them
    the jitter table indexed by a device tensor, a read back to the host).
    The frame index, jitter, blue-noise rotation, PCG salt and upscale
    factor are host numbers now, with the same float32 values."""
    from ptrt_tpu_torch.core.bluenoise import blue_noise_table
    from ptrt_tpu_torch.core import rng
    from ptrt_tpu_torch.core.taa import taa_jitter
    from ptrt_tpu_torch.core.vec import Vec3
    from ptrt_tpu_torch.render import pipeline
    from ptrt_tpu_torch.scene.camera import Camera

    cam = Camera.make((0.0, 1.0, -3.0), (0.0, 0.0, 1.0), device=CPU)
    ys, xs = torch.meshgrid(torch.arange(12), torch.arange(16),
                            indexing="ij")
    state = rng.seed(xs, ys, 0)
    table = blue_noise_table(CPU)
    img = Vec3(*[torch.rand((6, 8)) for _ in range(3)])
    # the tensor forms give the same values as the host forms
    for f in (0, 5, 17, 1 << 33):
        jx, jy = taa_jitter(torch.tensor(f))
        assert (float(jx), float(jy)) == taa_jitter(f)

    def refuse(*a, **k):
        raise AssertionError("a tensor made from host data in a frame")

    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)
    sub, ray = pipeline.camera_rays(cam, state, 7, 1, table)
    up = pipeline.upscale_bilinear(img, 15, 20)
    monkeypatch.undo()
    assert tuple(up.x.shape) == (15, 20) and tuple(ray.origin.x.shape) == (
        12, 16)
