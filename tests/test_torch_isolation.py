"""ptrt_tpu_torch must run where JAX is not installed.

The machine with the GPU has no JAX, and importing any ``ptrt_tpu`` module
imports JAX, so the port may import neither.  One check imports the package
and every submodule in a fresh interpreter and inspects ``sys.modules``;
another scans the sources (and ``chip_smoke.py``) for such imports.  The
smoke script itself must refuse to run without a GPU.
"""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ptrt_tpu_torch")

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import ptrt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ptrt_tpu_torch.__path__,
                                               "ptrt_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "ptrt_tpu"
             or m.startswith("ptrt_tpu."))
print(len(names), bad)
"""


def test_import_pulls_in_no_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 25  # every submodule was imported
    assert bad == "[]", bad


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "ptrt_tpu"
            or name.startswith("ptrt_tpu."))


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_has_no_jax_or_reference_import(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (
            f"{path}:{node.lineno} imports {names}")


def test_chip_smoke_fails_without_gpu():
    """No CUDA here: the smoke run must exit non-zero and print no result."""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    """Copied alone into an empty directory, the script cannot pass."""
    src = os.path.join(REPO, "chip_smoke.py")
    dst = tmp_path / "chip_smoke.py"
    dst.write_text(open(src).read())
    out = subprocess.run([sys.executable, str(dst)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# -- the port's own copies of the reference's two data files -----------------

_COPIES = (("native", "bvh_builder.cpp"), ("core", "_bluenoise_64.npy"))


@pytest.mark.parametrize("sub,name", _COPIES, ids=[n for _, n in _COPIES])
def test_port_copy_is_byte_equal_to_the_reference(sub, name):
    """The port builds its BVH and draws its blue noise from its own copies,
    which must stay the reference's bytes (so both build identical trees and
    jitter identically)."""
    with open(os.path.join(PKG, sub, name), "rb") as fh:
        ours = fh.read()
    with open(os.path.join(REPO, "ptrt_tpu", sub, name), "rb") as fh:
        ref = fh.read()
    assert ours == ref


def _names_reference_dir(value) -> bool:
    parts = value.replace("\\", "/").split("/")
    return "ptrt_tpu" in parts


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_builds_no_path_into_the_reference(path):
    """No string that a source passes to a call (``os.path.join``, ``open``,
    ``np.load``, ...) names the JAX package's directory, and no name
    ``REFERENCE_DIR`` is left: the port reads no file under ``ptrt_tpu/``.
    (Strings that only cite the reference, as docs and the kernel table's
    ``replaces`` entries do, are not call arguments.)"""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            assert node.id != "REFERENCE_DIR", f"{path}:{node.lineno}"
        if not isinstance(node, ast.Call):
            continue
        for arg in list(node.args) + [k.value for k in node.keywords]:
            for sub in ast.walk(arg):
                if isinstance(sub, ast.Constant) and isinstance(sub.value,
                                                                str):
                    assert not _names_reference_dir(sub.value), (
                        f"{path}:{sub.lineno} passes {sub.value!r}")


def test_port_modules_load_no_file_of_the_reference(tmp_path):
    """Loading the blue-noise table and the native builder's source path
    touches only the port's package."""
    code = r"""
import builtins, os, sys
import numpy as np
ref = os.path.join(os.getcwd(), "ptrt_tpu") + os.sep
opened = []
real_open = builtins.open
def spy(f, *a, **k):
    opened.append(os.path.abspath(str(f)))
    return real_open(f, *a, **k)
builtins.open = spy
from ptrt_tpu_torch.core import bluenoise
from ptrt_tpu_torch import native
bluenoise.blue_noise_table("cpu")
print(native.SOURCE.startswith(ref), any(p.startswith(ref) for p in opened))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]


# the port's entry points that run the engine whole, and the graph capture
_ENTRY_POINTS = ("graphs.py", "entry.py", "bench.py",
                 os.path.join("tools", "bench_presets.py"),
                 os.path.join("tools", "bench_games.py"))


_IMPORT_EACH = r"""
import importlib, json, sys
bad = lambda: sorted(m for m in sys.modules if m == "jax"
                     or m.startswith("jax.") or m == "ptrt_tpu"
                     or m.startswith("ptrt_tpu."))
out = {}
for name in sys.argv[1:]:
    importlib.import_module(name)
    out[name] = bad()
print(json.dumps(out))
"""


def _module(rel: str) -> str:
    return "ptrt_tpu_torch." + rel[:-3].replace(os.sep, ".")


@pytest.fixture(scope="module")
def entry_point_imports():
    """One fresh interpreter imports the entry points one by one: the
    forbidden modules loaded after each."""
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_EACH,
         *[_module(r) for r in _ENTRY_POINTS]],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    import json

    return json.loads(out.stdout)


@pytest.mark.parametrize("rel", _ENTRY_POINTS)
def test_entry_point_is_scanned_and_imports_no_jax(rel, entry_point_imports):
    """Each is among the sources the checks above scan, and importing it
    pulls in neither ``jax`` nor ``ptrt_tpu``."""
    assert os.path.join(PKG, rel) in set(_sources())
    assert entry_point_imports[_module(rel)] == []
