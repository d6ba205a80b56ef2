"""The port's bench entry points on the CPU: ``ptrt_tpu_torch/bench.py``,
``tools/bench_presets.py`` and ``tools/bench_games.py``.

* ``bench.py`` at 32x18 (the bench scene at ~2,000 triangles, one timed
  frame; env overrides as the reference's) prints one JSON line with the
  reference's keys, and its timed frame's ``rays_traced`` equals the
  reference's trace-only frame (``ptrt_tpu.scene.pt_scene._trace_only``)
  on the reference's scene of the same size from the same seed, frame 1
  after the warm-up frame 0, exactly.  The reference's program is
  compiled with its brute-force intersection (the same closest hits as
  its BVH walk: the counts agree, and it compiles in ~20 s against ~47).
* ``bench_presets.apply_preset`` sets what the reference's does, for
  each of the six presets, ``ultra_ultra`` included (the reference's
  module is loaded with its JAX cache settings made no-ops, so the
  tests' JAX cache directory stays as ``conftest.py`` set it).
* ``bench_games`` runs one tiny game run and prints its lines.
20-50 s (most of it the reference's compile).
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import pytest

from ptrt_tpu.app.bench_scene import build_bench_scene as ref_bench_scene
from ptrt_tpu.scene import pt_scene as ref_pt_scene

from ptrt_tpu_torch import bench
from ptrt_tpu_torch.scene.pt_scene import Scene
from ptrt_tpu_torch.tools import bench_games, bench_presets
from test_torch_shading import torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, TRIS = 32, 18, 2000
ENV = {"PTRT_BENCH_W": str(W), "PTRT_BENCH_H": str(H),
       "PTRT_BENCH_TRIS": str(TRIS), "PTRT_BENCH_FRAMES": "1"}
REF_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
REF_EXTRA = {"fps", "platform", "setup_s", "compile_s", "frames",
             "rays_per_frame", "retried", "phases"}
REF_PHASES = {"spp1_camera_ms", "spp1_camera_nee_ms", "spp1_bounce1_ms",
              "spp1_deep_bounces_ms", "spp1_total_ms", "hbm_copy_gbps",
              "gather_ns_idx", "gather_gbps"}


@pytest.fixture(scope="module")
def line():
    """bench.py's main on the CPU: its one printed line, parsed."""
    import contextlib
    import io

    saved = {k: os.environ.get(k) for k in ENV}
    os.environ.update(ENV)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            bench.main(["--device", "cpu"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    lines = buf.getvalue().strip().splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_bench_line_has_the_reference_keys(line):
    assert set(line) == REF_KEYS
    ex = line["extra"]
    assert REF_EXTRA <= set(ex)
    assert REF_PHASES <= set(ex["phases"])
    assert ex["platform"] == "cpu" and ex["retried"] is False
    assert ex["frames"] == 1 and line["unit"] == "Mrays/s"
    for k in ("build_s", "card", "device_name", "power_limit", "torch",
              "cuda", "nvcc", "triton"):
        assert k in ex, k
    assert f"{W}x{H}@4spp d4" in line["metric"]
    # Mrays/s rounded to 2 decimals as the reference's: 0.0 at this size
    assert line["value"] >= 0 and ex["fps"] > 0 and ex["compile_s"] > 0
    assert line["vs_baseline"] == round(line["value"] / 1000.0, 4)
    assert ex["rays_per_frame"] == round(sum(ex["rays_traced"]) / 1e6, 2)


def test_bench_rays_equal_the_reference_trace_only_frame(line):
    sc = ref_bench_scene(W, H, target_tris=TRIS)
    sc._ensure_device_state()
    fn = ref_pt_scene._trace_only(W, H, bench.SPP, bench.DEPTH,
                                  len(sc.lights), True,
                                  sc._sky().has_env_sampling)
    state = sc._rng_state
    for i in range(2):  # the warm-up frame 0, then the timed frame 1
        state, bufs = fn(sc._geom, sc._mat_table, sc._light_table,
                         sc._sky(), sc.camera, state, jnp.int32(i),
                         sc._blue_noise)
    want = int(jax.device_get(bufs.rays_traced))
    assert line["extra"]["rays_traced"] == [want]


def _reference_bench_presets():
    """The repo's tools/bench_presets.py, its module-level JAX cache
    settings made no-ops while it loads."""
    spec = importlib.util.spec_from_file_location(
        "ref_bench_presets", os.path.join(REPO, "tools", "bench_presets.py"))
    mod = importlib.util.module_from_spec(spec)
    update = jax.config.update
    jax.config.update = lambda *a, **k: None
    try:
        spec.loader.exec_module(mod)
    finally:
        jax.config.update = update
    return mod


@pytest.mark.parametrize("preset", bench_presets.PRESETS)
def test_apply_preset_sets_the_reference_values(preset):
    ref = _reference_bench_presets()
    assert ref.PRESETS == bench_presets.PRESETS
    rs = ref_pt_scene.Scene(16, 12)
    ps = Scene(16, 12, device="cpu")
    ref.apply_preset(rs, preset)
    bench_presets.apply_preset(ps, preset)
    for k, v in vars(rs.perf).items():
        assert getattr(ps.perf, k) == v, (preset, k)
    if preset == "ultra_ultra":
        p = ps.perf
        assert (p.samples_per_pixel, p.max_bounce_depth,
                p.russian_roulette_start_bounce) == (256, 32, 16)
        assert not (p.enable_denoiser or p.enable_bloom
                    or p.enable_motion_vectors)


def test_bench_presets_fresh_state_and_line(capsys):
    """One preset on a tiny scene: the reference's keys; the scene's state
    is a fresh one's before each preset."""
    out = bench_presets.main(["--device", "cpu", "--tris", "2000", "--w",
                              "16", "--h", "12", "--frames", "1",
                              "--presets", "fast,balanced"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(x)["preset"] for x in lines] == ["fast", "balanced"]
    for rec in out:
        assert {"preset", "fps", "frame_ms", "compile_s", "render_size",
                "tris"} <= set(rec)
    assert out[0]["render_size"] == [4, 5]  # fast: scale 0.35
    assert out[1]["render_size"] == [12, 16]


def test_bench_games_lines(capsys, monkeypatch):
    monkeypatch.setenv("PTRT_GAME_W", "32")
    monkeypatch.setenv("PTRT_GAME_H", "18")
    monkeypatch.setenv("PTRT_GAME_FRAMES", "1")
    monkeypatch.setenv("PTRT_GAME_PRESETS", "fast")
    monkeypatch.setenv("PTRT_GAMES", "cube_slider,tycoon")
    out = bench_games.main(["--device", "cpu"])
    text = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 2 and json.loads(text[-1]) == out
    assert [r["game"] for r in out] == ["cube_slider", "tycoon"]
    assert all(r["fps"] > 0 for r in out)
    monkeypatch.setenv("PTRT_GAMES", "pong")
    with pytest.raises(ValueError):
        bench_games.main(["--device", "cpu"])
