"""The fidelity corpus tool (``ptrt_tpu_torch/tools/fidelity.py``) against
the repo's JAX tool, ``tools/make_fidelity.py``.

Tables: each of the seven recipes builds its scene in both packages, and
the packed tables are held to each other: the triangle and node rows, the
instance set, the material and light tables and the sky byte for byte, the
camera within rtol 1e-6 (``test_torch_unified.py``'s bounds), but where a
game's step leaves ulps behind:

* ``game_cube_slider``: the instance matrices and boxes within 0.05, the
  bound ``tests/test_torch_games.py`` states for a recycled obstacle's x
  (the player's x carries the fused multiply-adds of the jitted step;
  measured 2.4e-7 here, one entry);
* ``game_fluid``: the surface's rows and boxes within 1e-6, the bound
  ``tests/test_torch_games.py`` states for the fluid step's heights
  (measured 9e-8); the tree's shape, held in its rows as float values,
  is the same.

Renders: ``fidelity.render`` at 64x36, 3 balanced frames with motion
vectors off, against the reference's frame of the same recipe at
``golden.MIN_PSNR`` (35 dB).  The reference frame is its stages in its
``_frame_fn`` order: its cached jitted split trace (``_trace_split``), then
SVGF, bloom and the tonemap called eagerly (its jitted frame program takes
minutes to compile); a scene the reference intersects by brute force is
traced eagerly too (``jax.disable_jit``, as ``test_torch_rt.py`` does:
~15 s where the jitted trace compiles ~30 s).  With motion vectors off
the reference's frame builds ``mv = jnp.zeros((rh, rw, 2))`` and unpacks
it as a pair, which raises (ROADMAP.md, "Found and held"); the test passes
the two zero planes the port passes.  Tier-1 renders ``game_tycoon`` (~60 s on one CPU core, most of
it the reference's first frame: its eager trace ~15 s, the first compile
of its eager post ops ~35 s); the other six are ``slow``.

Importing ``tools/make_fidelity.py`` points JAX's compilation cache at the
shared directory the TPU tools use and sets its minimum compile time to 0;
``tests/conftest.py`` keeps tests off that directory.  The ``reference``
fixture saves those config values before the import and restores them
after it, and asserts that they stay restored.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ptrt_tpu_torch import tables
from ptrt_tpu_torch.tools import fidelity, golden
from test_torch_shading import torch_one_thread  # noqa: F401
from test_torch_slice import ref_np
from test_torch_unified import GEOM_KEYS, _same, _same_camera, _same_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, FRAMES = 64, 36, 3
# the instance set's matrices and boxes, and the triangle and node rows
INST_ATOL = {"game_cube_slider": 0.05, "game_fluid": 1e-6}
GEOM_ATOL = {"game_fluid": 1e-6}
TIER1_RENDERS = ("game_tycoon",)
# the config values the reference tool's import changes
JAX_KEYS = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs", "jax_platforms")


@pytest.fixture(scope="module")
def reference():
    """``tools/make_fidelity.py`` as a module, JAX's config as it was."""
    saved = {k: getattr(jax.config, k) for k in JAX_KEYS}
    spec = importlib.util.spec_from_file_location(
        "make_fidelity", os.path.join(ROOT, "tools", "make_fidelity.py"))
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    assert {k: getattr(jax.config, k) for k in JAX_KEYS} == saved
    yield module
    assert {k: getattr(jax.config, k) for k in JAX_KEYS} == saved


def test_the_recipes_are_the_reference_tool_s(reference):
    assert list(fidelity.SCENES) == list(reference.SCENES)
    assert fidelity.OUT_DIR.endswith(os.path.join("build", "fidelity"))
    cache = jax.config.jax_compilation_cache_dir
    assert cache == os.environ.get("PTRT_TEST_CACHE",
                                   "/tmp/ptrt_jax_cache_tests")


# -- tables -------------------------------------------------------------------


def _close_tree(r, p, atol: float, what: str):
    """``_same_tree`` within ``atol`` (rtol 0): shapes and dtypes equal."""
    if isinstance(r, dict):
        for k in r:
            if not k.startswith("_") and k in p:
                _close_tree(r[k], p[k], atol, f"{what}.{k}")
    elif isinstance(r, tuple):
        assert len(r) == len(p), what
        for j, (a, b) in enumerate(zip(r, p)):
            _close_tree(a, b, atol, f"{what}[{j}]")
    elif r is None or isinstance(r, (int, float, bool)):
        assert r == p, what
    else:
        a, b = np.asarray(r), np.asarray(p)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=what)


def _tree(r, p, atol: float, what: str):
    if atol:
        _close_tree(r, p, atol, what)
    else:
        _same_tree(r, p, what)


@pytest.mark.parametrize("name", list(fidelity.SCENES))
def test_recipe_tables_match_the_reference(reference, name):
    ref = reference.SCENES[name](W, H)
    port = fidelity.SCENES[name](W, H, "cpu")
    ref._ensure_device_state()
    port._ensure_device_state()
    assert [m.num_triangles for m in port.meshes] == [
        m.num_triangles for m in ref.meshes]
    assert [m.is_dynamic for m in port.meshes] == [
        m.is_dynamic for m in ref.meshes]
    rg, pg = ref_np(ref._geom), tables.to_numpy(port._geom)
    assert ("static" in rg) == ("static" in pg)
    geom_atol, inst_atol = GEOM_ATOL.get(name, 0.0), INST_ATOL.get(name, 0.0)
    static_r, static_p = rg.get("static", rg), pg.get("static", pg)
    for k in GEOM_KEYS:
        _same_tree(static_r[k], static_p[k], f"static.{k}")
    if "static" in rg:
        ri, pi = rg["iset"], pg["iset"]
        for k in GEOM_KEYS:
            _tree(ri["geom"][k], pi["geom"][k], geom_atol, f"iset.{k}")
        _same_tree(ri["roots"], pi["roots"], "roots")
        for k in ("mats", "bb_min", "bb_max"):
            _tree(ri[k], pi[k], inst_atol, k)
    _same(ref._mat_table.packed, port._mat_table.packed.numpy(), "mats")
    _same(ref._light_table.packed, port._light_table.packed.numpy(), "lts")
    rs, ps = ref_np(ref._sky()), tables.to_numpy(port.sky())
    for key in ("top", "bottom", "use_sky"):
        _same_tree(rs[key], ps[key], key)
    assert rs.get("env") is None and ps.get("env") is None
    _same_camera(ref.camera, port.camera)


# -- renders ------------------------------------------------------------------


def _ref_render(sc, frames: int) -> np.ndarray:
    """The reference's balanced frames with motion vectors off (see the
    module's docstring): the last, (H, W, 3) uint8."""
    from ptrt_tpu.render import bloom as ref_bloom
    from ptrt_tpu.render import denoiser as ref_den
    from ptrt_tpu.render import pipeline as ref_pipeline
    from ptrt_tpu.scene import pt_scene as ref_pt

    sc.set_performance_preset("balanced")
    sc.perf.enable_motion_vectors = False
    sc._ensure_device_state()
    rh, rw = sc.render_size
    assert (rh, rw) == (sc.height, sc.width)
    p = sc.perf
    statics = (rw, rh, int(p.samples_per_pixel), int(p.max_bounce_depth),
               len(sc.lights), sc._use_brute(), sc._sky().has_env_sampling,
               True, bool(p.enable_russian_roulette),
               int(p.russian_roulette_start_bounce), bool(p.camera_nee_fix))
    if sc._use_brute():  # eagerly: half the jitted trace's compile
        def trace(g, m, lt, sky, cam, st, fi, bn):
            with jax.disable_jit():
                return ref_pipeline.trace_frame(
                    g, m, lt, len(sc.lights), sky, cam, st, fi, rw, rh,
                    statics[2], statics[3], split=True, use_brute=True,
                    blue_noise_tbl=bn, rr_enabled=statics[8],
                    rr_start=statics[9], camera_nee=statics[10])
    else:
        trace = ref_pt._trace_split(*statics)
    den = ref_den.init_denoiser_state(rh, rw)
    zero = jnp.zeros((rh, rw), jnp.float32)
    img = None
    for _ in range(frames):
        sc._rng_state, bufs = trace(
            sc._geom, sc._mat_table, sc._light_table, sc._sky(), sc.camera,
            sc._rng_state, jnp.int32(sc.frame_count), sc._blue_noise)
        color, den = ref_den.denoise_frame(bufs, (zero, zero), den,
                                           sc.camera, sc.frame_count)
        color = ref_bloom.apply_bloom(color)
        img = np.asarray(ref_pipeline.tonemap_to_rgb8(color))
        sc.frame_count += 1
    return img


@pytest.mark.parametrize("name", [
    n if n in TIER1_RENDERS else pytest.param(n, marks=pytest.mark.slow)
    for n in fidelity.SCENES])
def test_render_matches_the_reference(reference, name):
    want = _ref_render(reference.SCENES[name](W, H), FRAMES)
    img = fidelity.render(name, W, H, FRAMES, device="cpu")
    assert img.shape == want.shape == (H, W, 3) and img.dtype == np.uint8
    assert img.std() > 2.0
    db = golden.psnr(img, want)
    assert db >= golden.MIN_PSNR, f"{name}: PSNR {db:.1f} dB"


def test_main_writes_the_pngs(tmp_path, capsys):
    out = tmp_path / "fidelity"
    assert fidelity.main(["--cpu", "--w", "24", "--h", "16", "--frames",
                          "2", "--only", "game_tycoon,game_cube_slider",
                          "--out", str(out)]) == 0
    assert sorted(os.listdir(out)) == ["game_cube_slider.png",
                                       "game_tycoon.png"]
    png = (out / "game_tycoon.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert int.from_bytes(png[16:20], "big") == 24  # IHDR width, height
    assert int.from_bytes(png[20:24], "big") == 16
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and all(line.endswith("[cpu]") for line in lines)
    assert "first frame" in lines[0] and "ms a frame" in lines[0]
    with pytest.raises(ValueError):
        fidelity.main(["--cpu", "--only", "nope", "--out", str(out)])


def test_the_card_is_the_default():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the default renders on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fidelity.build("game_tycoon", 24, 16)
