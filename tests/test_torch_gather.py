"""The Pallas row-gather probes against the port's ``row_gather``.

Every probe of ``tools/probe_pallas_gather_r5.py``,
``tools/probe_pallas_gather2_r5.py`` and ``tools/prof_pallas_gather.py``
runs here in Pallas interpret mode (``pl.pallas_call`` patched with
``interpret=True`` for the test; the tools stay as they are) and is held
to the plain version of ``ptrt_tpu_torch.core.gather.row_gather``
(``index_select``) on the same table and indices: exactly, bit for bit.

The probes' module-level settings are kept except where interpret mode on
a CPU would be slow: the lane counts of the grid probes (1M and 230,400)
are cut to two tiles of 512 lanes, and the chained probes of
``prof_pallas_gather.py`` get an integer-valued table so that their row
sums are exact in float32 whatever the order of summation.  Importing the
tools does not move JAX's compilation cache: their ``jax.config.update``
calls are skipped while they load.

``MaterialTable.gather`` is held to the reference's, exactly, on the bench
scene's 17 materials.  This file runs in ~6 s on one CPU core.
"""

import ast
import functools
import importlib
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu
from ptrt_tpu.app.bench_scene import build_bench_scene as ref_bench_scene

from ptrt_tpu_torch.app.bench_scene import build_bench_scene
from ptrt_tpu_torch.core.gather import row_gather, row_gather_plain
from ptrt_tpu_torch.scene.materials import FIELDS_F, FIELDS_V3, MaterialTable
from ptrt_tpu_torch.tools import probe_gather
from test_torch_shading import torch_one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _load(name: str, monkeypatch):
    """Import ``tools/<name>.py`` with its ``jax.config.update`` calls
    skipped."""
    cache = jax.config.jax_compilation_cache_dir
    with monkeypatch.context() as mp:
        mp.setattr(jax.config, "update", lambda *a, **k: None)
        m = importlib.import_module(f"tools.{name}")
    assert jax.config.jax_compilation_cache_dir == cache
    return m


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _gather(table, idx) -> np.ndarray:
    return row_gather(_t(table), _t(idx)).numpy()


# -- probe_pallas_gather_r5.py -------------------------------------------------


R5 = ["probe_vector_index", "probe_take", "probe_take_clip",
      "probe_take_along_axis", "probe_adv_indexing", "probe_lax_gather",
      "probe_onehot_matmul", "probe_scalar_loop", "probe_dynamic_slice"]


@pytest.mark.parametrize("probe", R5)
def test_probe_r5(probe, monkeypatch, interpret):
    m = _load("probe_pallas_gather_r5", monkeypatch)
    assert {f.__name__ for _, f in m.PROBES} == set(R5)
    out = np.asarray(getattr(m, probe)())
    table = np.arange(m.K * m.W, dtype=np.float32).reshape(m.K, m.W)
    idx = np.arange(m.R, dtype=np.int32)[::-1] % m.K
    assert np.array_equal(out, _gather(table, idx))


# -- probe_pallas_gather2_r5.py ------------------------------------------------


def _gather2_inputs(m):
    table = np.asarray(jnp.arange(m.K * m.W, dtype=jnp.float32).reshape(
        m.K, m.W) * 1e-4)
    idx = (np.arange(m.K, dtype=np.int32)[::-1] * 7) % m.K
    return table, idx


@pytest.mark.parametrize("probe", ["probe_taa_same_shape",
                                   "probe_take_same_n"])
def test_probe_gather2_rows(probe, monkeypatch, interpret):
    m = _load("probe_pallas_gather2_r5", monkeypatch)
    out = np.asarray(getattr(m, probe)())
    table, idx = _gather2_inputs(m)
    assert np.array_equal(out, _gather(table, idx))


def test_probe_gather2_lane_form(monkeypatch, interpret):
    """``probe_taa_axis1`` gathers along the lane dimension:
    ``out[i, j] = table[i, idx[j] % W]``, a row gather of the transposed
    table, as ``probe_gather.lane_form`` computes it."""
    m = _load("probe_pallas_gather2_r5", monkeypatch)
    out = np.asarray(m.probe_taa_axis1())
    table, idx = _gather2_inputs(m)
    want = probe_gather.lane_form(row_gather, _t(table), _t(idx))
    assert np.array_equal(out, want.numpy())


def _main_kernel(path: str, name: str, env: dict):
    """A kernel function defined under the file's ``__main__`` guard,
    compiled from its own source lines into ``env``."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            code = compile(ast.Module([node], []), path, "exec")
            exec(code, env)
            return env[name]
    raise LookupError(f"{name} not in {path}")


@pytest.mark.parametrize("kernel,dtype", [("oh_kernel", jnp.bfloat16),
                                          ("taa_kernel", jnp.float32)])
def test_probe_gather2_timed_kernels(kernel, dtype, interpret):
    """The timed grid kernels of the file's main block, with its table
    (2048, 64) and the grid call it makes, over 2 tiles of 512 lanes
    instead of 512 tiles of 2048.  The one-hot kernel rounds the table to
    bf16 before its MXU product, so it is held to the bf16 table's
    gather."""
    kt, tr, r = 2048, 512, 1024
    path = os.path.join(REPO, "tools", "probe_pallas_gather2_r5.py")
    fn = _main_kernel(path, kernel, {"jax": jax, "jnp": jnp, "KT": kt,
                                     "TR": tr})
    g = np.random.default_rng(0)
    table = g.normal(size=(kt, 64)).astype(np.float32)
    idx = g.integers(0, kt, r).astype(np.int32)
    out = np.asarray(pl.pallas_call(
        fn, grid=(r // tr,),
        out_shape=jax.ShapeDtypeStruct((r, 64), jnp.float32),
        in_specs=[pl.BlockSpec((kt, 64), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((tr,), lambda i: (i,),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((tr, 64), lambda i: (i, 0),
                               memory_space=pltpu.VMEM))(table, idx))
    t = _t(table).to(torch.bfloat16 if dtype == jnp.bfloat16
                     else torch.float32)
    want = row_gather(t, _t(idx)).float().numpy()
    assert np.array_equal(out, want)


# -- prof_pallas_gather.py -----------------------------------------------------

PROF_BLK = 512  # lanes per grid block (the file's 2048 would be 4x slower)


@pytest.mark.parametrize("make", ["make_take", "make_taa", "make_onehot_f32",
                                  "make_onehot_bf16"])
def test_prof_chained(make, monkeypatch, interpret):
    """The probes' K chained gathers (row sum fed back into the index) over
    2 blocks of lanes, against ``probe_gather.chained`` on the port's
    gather.  ``make_taa`` keeps column 0 of each row rather than the row
    sum, so its chain is rebuilt here with that rule."""
    m = _load("prof_pallas_gather", monkeypatch)
    monkeypatch.setattr(m, "BLK", PROF_BLK)
    g = np.random.default_rng(3)
    table = g.integers(-4, 5, (m.N, m.W)).astype(np.float32)
    r = 2 * m.BLK
    idx = g.integers(0, m.N, r).astype(np.int32)
    monkeypatch.setattr(m, "R", r)
    monkeypatch.setattr(m, "tbl", jnp.asarray(table))
    if make.startswith("make_onehot"):
        dt = jnp.float32 if make.endswith("f32") else jnp.bfloat16
        call = m.make_onehot(dt)
    else:
        call = getattr(m, make)()
    out = np.asarray(call(jnp.asarray(idx)))
    assert m.K == probe_gather.CHAIN
    t, i = _t(table), _t(idx)
    if make == "make_taa":
        acc = torch.zeros(r)
        for _ in range(m.K):
            s = row_gather(t, i)[:, 0]
            i = (i + s.to(torch.int32)) % m.N
            acc = acc + s
        want = acc
    else:
        want = probe_gather.chained(row_gather, t, i)
    assert np.array_equal(out, want.numpy())


def test_prof_scalar_loop(monkeypatch, interpret):
    """``make_scalar_loop`` copies row ``idx[j]`` into scratch row ``j % 8``
    for every lane of a block and writes scratch element (0, 0) to the
    whole block: the gathered row of the block's lane ``BLK - 8``."""
    m = _load("prof_pallas_gather", monkeypatch)
    monkeypatch.setattr(m, "BLK", PROF_BLK)
    g = np.random.default_rng(4)
    r = 2 * m.BLK
    idx = g.integers(0, m.N, r).astype(np.int32)
    monkeypatch.setattr(m, "R", r)
    out = np.asarray(m.make_scalar_loop()(jnp.asarray(idx)))
    rows = row_gather(_t(np.asarray(m.tbl)), _t(idx)).numpy()
    last = rows[np.arange(r) // m.BLK * m.BLK + m.BLK - 8, 0]
    assert np.array_equal(out, last)


# -- the wrapper ---------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_row_gather_plain(dtype, idx_dtype):
    g = np.random.default_rng(5)
    table = torch.from_numpy(g.normal(size=(37, 12)).astype(
        np.float32)).to(dtype)
    idx = torch.from_numpy(g.integers(0, 37, 500)).to(idx_dtype)
    got = row_gather(table, idx)
    assert got.dtype == dtype and got.shape == (500, 12)
    assert torch.equal(got, table[idx.long()])
    fm = row_gather(table, idx, field_major=True)
    assert fm.is_contiguous() and torch.equal(fm, got.t())


def test_row_gather_clamps_and_checks():
    table = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    got = row_gather(table, torch.tensor([-3, 0, 3, 9]))
    assert torch.equal(got, table[[0, 0, 3, 3]])
    assert torch.equal(got, row_gather_plain(table, torch.tensor([-3, 0, 3,
                                                                  9])))
    with pytest.raises(TypeError):
        row_gather(table.double(), torch.tensor([0]))
    with pytest.raises(TypeError):
        row_gather(table, torch.tensor([0.0]))
    with pytest.raises(ValueError):
        row_gather(table.t(), torch.tensor([0]))  # not contiguous
    with pytest.raises(ValueError):
        row_gather(table, torch.zeros((2, 2), dtype=torch.int64))


# -- MaterialTable.gather ------------------------------------------------------


def test_material_gather_matches_reference():
    ref = ref_bench_scene(16, 12, target_tris=300)
    port = build_bench_scene(16, 12, target_tris=300, device="cpu")
    ref._ensure_device_state()
    port._ensure_device_state()
    packed = np.array(ref._mat_table.packed)
    assert np.array_equal(port._mat_table.packed.numpy(), packed)
    ids = np.random.default_rng(6).integers(0, packed.shape[0], (7, 9))
    want = ref._mat_table.gather(jnp.asarray(ids, jnp.int32))
    got = MaterialTable(torch.from_numpy(packed)).gather(
        torch.from_numpy(ids))
    for name in FIELDS_V3:
        for c in "xyz":
            a = getattr(getattr(got, name), c)
            assert a.is_contiguous() and a.shape == (7, 9)
            assert np.array_equal(a.numpy(), np.asarray(
                getattr(getattr(want, name), c))), (name, c)
    for name in FIELDS_F:
        assert np.array_equal(getattr(got, name).numpy(),
                              np.asarray(getattr(want, name))), name


# -- the probe tool -------------------------------------------------------------


@pytest.mark.parametrize("probe", probe_gather.PROBES, ids=lambda p: p.source)
def test_probe_tool_shapes(probe):
    """Each probe of ``ptrt_tpu_torch/tools/probe_gather.py`` builds the
    Pallas probe's table and index shapes, and its kernel run equals its
    plain run (on the CPU both are ``index_select``)."""
    shapes = {"tools/probe_pallas_gather_r5.py:42": ((2048, 128), 1024),
              "tools/probe_pallas_gather2_r5.py:38": ((2048, 128), 2048),
              "tools/probe_pallas_gather2_r5.py:158": ((2048, 64), 1 << 20),
              "tools/probe_pallas_gather2_r5.py:133": ((2048, 64), 1 << 20),
              "tools/prof_pallas_gather.py:79": ((1024, 64), 230_400),
              "tools/prof_pallas_gather.py:79,107,138,166": ((1024, 64),
                                                            230_400)}
    table, idx = probe.make(torch.device("cpu"))
    assert (tuple(table.shape), idx.numel()) == shapes[probe.source]
    assert torch.equal(probe.run(row_gather, table, idx),
                       probe.run(row_gather_plain, table, idx))
