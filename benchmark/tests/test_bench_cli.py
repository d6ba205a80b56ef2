"""The command refuses to run without a card, and nothing it or the
reference loads is JAX or the JAX package."""

import os
import subprocess
import sys

import pytest

from benchmark import cells, session

ROOT = cells.ROOT


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "bench_scene.trace_4spp", "--seed", "3000000001",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no CUDA card" in r.stderr


def test_forbidden_names_are_compared_whole(monkeypatch):
    fake = type(sys)("fake")
    monkeypatch.setitem(sys.modules, "ptrt_tpu_torch_extra", fake)
    monkeypatch.setitem(sys.modules, "jaxtyping", fake)
    assert session.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ptrt_tpu.render", fake)
    monkeypatch.setitem(sys.modules, "jax", fake)
    assert session.forbidden_modules() == ["jax", "ptrt_tpu.render"]


@pytest.mark.parametrize("package", ["benchmark.reference", "benchmark"])
def test_imports_leave_the_port_and_jax_out(package):
    """Every module of the reference loads without the port, and the
    harness's own modules without JAX or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"import {package} as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if '.tests' in m.name or m.name.endswith('.run'):\n"
        "        continue\n"
        "    if m.name.startswith('benchmark.scenes.'):\n"
        "        continue\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'ptrt_tpu'"
        + (", 'ptrt_tpu_torch'" if package.endswith("reference") else "")
        + "))\n"
        "print(bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
