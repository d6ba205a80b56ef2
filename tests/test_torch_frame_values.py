"""A frame's per-frame values on the device: the frame index as a tensor.

A frame captured into a CUDA graph (``ptrt_tpu_torch/graphs.py``) cannot
take its frame index as a host number, which the capture would freeze, so
the jitter, the blue-noise rotation and the whole trace also take it as a
0-d integer tensor on the frame's device.  Held here, on the CPU:

* ``taa_jitter`` and ``next_blue_noise`` of a tensor index equal the int
  path and the reference's functions bit for bit, frames 0-40;
* the jitter table is made once a device (no host copy in a frame);
* a 32x18 ``trace_frame`` and a balanced ``render_world`` give the same
  bits with the index as an int and as a tensor;
* ``graphs.HostValues`` stages host values as int32 / float32 with their
  exact values, and a fixed structure refuses a change; ``graphs``' tree
  helpers; ``capture`` and ``FusedRunner.capture`` on the CPU.
~10 s.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ptrt_tpu.core import bluenoise as ref_bn
from ptrt_tpu.core import taa as ref_taa

from ptrt_tpu_torch import graphs
from ptrt_tpu_torch.app.bench_scene import build_bench_scene
from ptrt_tpu_torch.core import bluenoise, taa
from ptrt_tpu_torch.render import pipeline
from test_torch_shading import torch_one_thread  # noqa: F401

FRAMES = range(41)
CPU = torch.device("cpu")


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def test_taa_jitter_tensor_index():
    idx = torch.arange(41, dtype=torch.int32)
    jx, jy = taa.taa_jitter(idx)
    rx, ry = ref_taa.taa_jitter(jnp.arange(41, dtype=jnp.int32))
    assert np.array_equal(_bits(jx.numpy()), _bits(rx))
    assert np.array_equal(_bits(jy.numpy()), _bits(ry))
    for f in FRAMES:
        tx, ty = taa.taa_jitter(torch.tensor(f, dtype=torch.int32))
        assert tx.dim() == 0
        hx, hy = taa.taa_jitter(f)
        assert _bits(tx.numpy()) == _bits(hx) and _bits(ty.numpy()) == _bits(hy)


def test_next_blue_noise_tensor_index():
    table = bluenoise.blue_noise_table(CPU)
    ref_table = jnp.asarray(table.numpy())
    ys, xs = torch.meshgrid(torch.arange(0, 70, 3), torch.arange(0, 90, 7),
                            indexing="ij")
    for f in FRAMES:
        u, v = bluenoise.next_blue_noise(table, xs, ys, f)
        tu, tv = bluenoise.next_blue_noise(
            table, xs, ys, torch.tensor(f, dtype=torch.int32))
        ru, rv = ref_bn.next_blue_noise(ref_table, jnp.asarray(xs.numpy()),
                                        jnp.asarray(ys.numpy()),
                                        jnp.int32(f))
        for got in (u, tu):
            assert np.array_equal(_bits(got.numpy()), _bits(ru)), f
        for got in (v, tv):
            assert np.array_equal(_bits(got.numpy()), _bits(rv)), f


def test_jitter_table_once_a_device(monkeypatch):
    """The table is made at the first tensor call on a device; later calls
    build no tensor from host data."""
    taa._tables.clear()
    taa.taa_jitter(torch.tensor(3))
    assert list(taa._tables) == ["cpu"]
    table = taa.halton_table(CPU)
    assert taa.halton_table("cpu") is table

    def refuse(*a, **k):
        raise AssertionError("a tensor made from host data")

    monkeypatch.setattr(torch, "tensor", refuse)
    jx, _ = taa.taa_jitter(torch.arange(5))
    assert jx.shape == (5,) and list(taa._tables) == ["cpu"]


@pytest.fixture(scope="module")
def scene():
    sc = build_bench_scene(32, 18, target_tris=2000, device="cpu")
    sc.set_performance_preset("balanced")
    sc._ensure_device_state()
    return sc


def test_trace_frame_int_and_tensor_index(scene):
    sc = scene
    outs = []
    for f in (7, torch.tensor(7, dtype=torch.int32)):
        outs.append(pipeline.trace_frame(
            sc._geom, sc._mat_table, sc._light_table, len(sc.lights),
            sc.sky(), sc.camera, sc._rng_state, f, 32, 18, 2, 3,
            sc._blue_noise, split=True))
    (sa, a), (sb, b) = outs
    assert torch.equal(sa, sb)
    for k in a._fields:
        assert all(torch.equal(x, y) for x, y in zip(
            graphs.tree_leaves(getattr(a, k)),
            graphs.tree_leaves(getattr(b, k)))), k
    assert int(a.rays_traced) > 32 * 18


def test_render_world_int_and_tensor_index(scene):
    """Two balanced frames (SVGF's history carried) from one saved state,
    the index a host int and a tensor: RGB8, PCG state and denoiser
    history bit for bit."""
    sc = scene
    saved = (sc._rng_state, sc._denoiser_state)
    prev = sc.camera.get_view_proj()
    runs = []
    for as_tensor in (False, True):
        sc._rng_state, sc._denoiser_state = saved
        imgs = []
        for f in (4, 5):
            idx = torch.tensor(f, dtype=torch.int32) if as_tensor else f
            imgs.append(sc.render_world(sc._geom, sc.camera, idx, prev))
        runs.append((imgs, sc._rng_state, sc._denoiser_state))
    (ia, ra, da), (ib, rb, db) = runs
    assert all(torch.equal(x, y) for x, y in zip(ia, ib))
    assert torch.equal(ra, rb)
    la, lb = graphs.tree_leaves(da), graphs.tree_leaves(db)
    assert len(la) == len(lb) > 5
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert ia[1].float().std() > 1.0


def test_host_values_stage_exact_values():
    hv = graphs.HostValues(CPU, fixed=True)
    vals = (1, -7, (np.int64(2**31 - 1), 0.1), torch.tensor(np.float32(1e-3)),
            torch.tensor(5, dtype=torch.int64), np.float32(-2.5))
    got = hv.stage(vals)
    assert isinstance(got, tuple) and isinstance(got[2], tuple)
    flat = [got[0], got[1], got[2][0], got[2][1], got[3], got[4], got[5]]
    want = [np.int32(1), np.int32(-7), np.int32(2**31 - 1), np.float32(0.1),
            np.float32(1e-3), np.int32(5), np.float32(-2.5)]
    for t, w in zip(flat, want):
        assert t.dim() == 0 and t.dtype == torch.from_numpy(
            np.asarray(w)).dtype
        assert t.numpy().tobytes() == np.asarray(w).tobytes()
    again = hv.stage((2, 3, (4, 0.5), torch.tensor(np.float32(2.0)), 6, 7.0))
    assert int(again[0]) == 2 and float(again[2][1]) == 0.5
    assert again[0].data_ptr() == got[0].data_ptr()  # one buffer, reused
    with pytest.raises(ValueError):
        hv.stage((1, 2))
    with pytest.raises(TypeError):
        graphs.HostValues(CPU).stage((torch.zeros(3),))


def test_tree_helpers_and_cpu_capture(scene):
    sc = scene
    den = sc._denoiser_state
    assert den is not None
    copy = graphs.clone_tree(den)
    assert dataclasses.is_dataclass(copy)
    leaves = graphs.tree_leaves(copy)
    assert len(leaves) == len(graphs.tree_leaves(den))
    assert all(a.data_ptr() != b.data_ptr()
               for a, b in zip(leaves, graphs.tree_leaves(den)))
    graphs.copy_tree(copy, den)
    assert all(torch.equal(a, b) for a, b in zip(leaves,
                                                 graphs.tree_leaves(den)))
    with pytest.raises(ValueError):
        graphs.copy_tree(copy, (den.depth,))
    fn = lambda x: x + 1
    assert graphs.capture(fn, (torch.zeros(2),)) is fn
    with pytest.raises(ValueError):
        graphs.capture_frame(lambda: None, lambda: None, CPU)


def test_fused_runner_capture_needs_the_card():
    from ptrt_tpu_torch.games import cube_slider

    _, sc = cube_slider.build_scene(32, 18, device="cpu")
    sc.set_performance_preset("fast")
    runner = cube_slider.make_runner(sc)
    state = cube_slider.init_state(0, device="cpu")
    with pytest.raises(ValueError):
        runner.capture(state, cube_slider.script_inputs(0),
                       sc.camera.get_view_proj())
    with pytest.raises(RuntimeError):
        runner.replay(cube_slider.script_inputs(1), 1)
    assert runner.state is None
