"""The kernel wrappers on the CPU: their plain versions and their checks.

A CUDA kernel has no CPU mode, so here each wrapper must take its plain
version — because its tensors lie on the CPU, without building or loading
the kernel library or counting a launch — and must refuse what its kernel
would not take.  The tonemap's plain version is held to the reference's
``tonemap_to_rgb8``: exact on at least 99.9% of pixels (XLA's and torch's
powf differ by an ulp now and then) and within 1 LSB on all of them.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ptrt_tpu.core.vec import Vec3 as RefVec3
from ptrt_tpu.render.pipeline import tonemap_to_rgb8 as ref_tonemap

from ptrt_tpu_torch import kernels
from ptrt_tpu_torch.app.bench_scene import build_bench_scene
from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.render import pipeline, traverse
from test_torch_shading import torch_one_thread  # noqa: F401


def _hdr(h, w, seed):
    r = np.random.default_rng(seed)
    a = r.lognormal(mean=-1.0, sigma=1.5, size=(3, h, w)).astype(np.float32)
    a[:, :4] = 0.0  # black rows
    a[:, 4:8] *= 1e4  # blown out
    return a


@pytest.mark.parametrize("total_samples", [1, 4])
def test_tonemap_plain_matches_reference(total_samples):
    a = _hdr(270, 480, total_samples)
    ref = np.asarray(ref_tonemap(RefVec3(*[jnp.asarray(c) for c in a]),
                                 total_samples))
    got = pipeline.tonemap_to_rgb8(Vec3(*[torch.from_numpy(c) for c in a]),
                                   total_samples).numpy()
    assert got.shape == ref.shape == (270, 480, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1
    assert (diff.max(-1) == 0).mean() >= 0.999


def test_tonemap_flips_y():
    a = np.zeros((3, 4, 5), np.float32)
    a[:, 0, :] = 1.0  # bottom row of the HDR image (camera t = 0)
    img = pipeline.tonemap_rgb8(Vec3(*[torch.from_numpy(c) for c in a]), 1.0)
    assert img[-1].min() > 0 and img[:-1].max() == 0


@pytest.fixture(scope="module")
def geom():
    sc = build_bench_scene(16, 12, target_tris=300, device="cpu")
    sc._ensure_device_state()
    return sc._geom


def _rays(n, seed=0):
    r = np.random.default_rng(seed)
    o = (r.uniform(-3, 3, (n, 3)) + [0, 0.5, 6]).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v = lambda a: Vec3(*[torch.from_numpy(np.ascontiguousarray(a[:, k]))
                         for k in range(3)])
    return v(o), v(d), torch.full((n,), 1e30)


@pytest.fixture
def no_kernels(monkeypatch):
    """Fail if anything builds or loads the kernel library; reset counts."""
    def refuse():
        raise AssertionError("a CPU tensor reached the CUDA kernel path")

    monkeypatch.setattr(kernels, "get_lib", refuse)
    kernels.launches.clear()
    yield
    assert sum(kernels.launches.values()) == 0


def test_closest_hit_uses_plain_on_cpu(geom, no_kernels):
    o, d, t = _rays(300)
    got = traverse.closest_hit(geom, o, d, t)
    want = traverse.closest_hit_plain(geom, o, d, t)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (got[3] >= 0).any()


def test_any_hit_uses_plain_on_cpu(geom, no_kernels):
    o, d, _ = _rays(300, 1)
    t = torch.full((300,), 4.0)
    got = traverse.any_hit(geom, o, d, t)
    assert torch.equal(got, traverse.any_hit_plain(geom, o, d, t))
    assert got.any() and not got.all()


def test_closest_hit_live_uses_plain_on_cpu(geom, no_kernels):
    o, d, _ = _rays(300, 2)
    alive = torch.arange(300) % 5 != 0
    got = traverse.closest_hit_live(geom, o, d, alive)
    want = traverse.closest_hit_plain(geom, o, d,
                                      torch.where(alive, 1e30, -1.0))
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (got.slot[alive] >= 0).any() and (got.slot[~alive] < 0).all()


@pytest.mark.parametrize("walk", traverse.WALKS)
def test_walk_counts_uses_plain_on_cpu(geom, no_kernels, walk):
    o, d, t = _rays(40, 3)
    got = traverse.walk_counts(geom, o, d, t, walk)
    want = traverse.walk_counts_plain(geom, o, d, t, walk)
    assert (got.nodes, got.tris) == (want.nodes, want.tris) and got.nodes > 0
    pairs = [(got.answer, want.answer)] if walk == "any" else zip(
        got.answer, want.answer)
    for a, b in pairs:
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["float alive", "short alive", "2-D alive"])
def test_closest_hit_live_refuses_bad_alive(geom, no_kernels, bad):
    o, d, _ = _rays(30)
    alive = {"float alive": torch.ones(30),
             "short alive": torch.ones(29, dtype=torch.bool),
             "2-D alive": torch.ones(6, 5, dtype=torch.bool)}[bad]
    with pytest.raises((TypeError, ValueError)):
        traverse.closest_hit_live(geom, o, d, alive)


def test_walk_counts_refuses_unknown_walk(geom, no_kernels):
    o, d, t = _rays(8)
    with pytest.raises(ValueError):
        traverse.walk_counts(geom, o, d, t, "nearest")


def test_tonemap_uses_plain_on_cpu(no_kernels):
    hdr = Vec3(*[torch.from_numpy(c) for c in _hdr(12, 20, 3)])
    assert torch.equal(pipeline.tonemap_rgb8(hdr, 0.5),
                       pipeline.tonemap_rgb8_plain(hdr, 0.5))


def _bad_ray_inputs():
    """(name, mutate) pairs; mutate(o, d, t) -> (o, d, t) a kernel refuses."""
    return [
        ("float64 t_max", lambda o, d, t: (o, d, t.double())),
        ("2-D t_max", lambda o, d, t: (o, d, t.reshape(10, -1))),
        ("strided origin", lambda o, d, t: (
            Vec3(torch.stack([o.x, o.x], 1)[:, 0], o.y, o.z), d, t)),
        ("short direction", lambda o, d, t: (o, Vec3(d.x[:-1], d.y, d.z), t)),
        ("int32 direction", lambda o, d, t: (o, Vec3(d.x.int(), d.y, d.z), t)),
    ]


@pytest.mark.parametrize("case", range(len(_bad_ray_inputs())),
                         ids=[n for n, _ in _bad_ray_inputs()])
@pytest.mark.parametrize("fn", ["closest_hit", "any_hit"])
def test_walk_wrappers_refuse_bad_rays(geom, no_kernels, fn, case):
    o, d, t = _rays(300)
    o, d, t = _bad_ray_inputs()[case][1](o, d, t)
    with pytest.raises((TypeError, ValueError)):
        getattr(traverse, fn)(geom, o, d, t)


def test_walk_wrappers_refuse_bad_tables(geom, no_kernels):
    import dataclasses

    o, d, t = _rays(30)
    bad = dataclasses.replace(geom, tri_rows=geom.tri_rows[:, :40])
    with pytest.raises(ValueError):
        traverse.closest_hit(bad, o, d, t)
    bad = dataclasses.replace(geom, node_rows=geom.node_rows.double())
    with pytest.raises(TypeError):
        traverse.any_hit(bad, o, d, t)


@pytest.mark.parametrize("bad", ["float64", "1-D", "transposed", "shape"])
def test_tonemap_refuses_bad_hdr(no_kernels, bad):
    p = [torch.rand(6, 8) for _ in range(3)]
    if bad == "float64":
        p[1] = p[1].double()
    elif bad == "1-D":
        p = [c.reshape(-1) for c in p]
    elif bad == "transposed":
        p[2] = torch.rand(8, 6).t()
    else:
        p[0] = torch.rand(6, 9)
    with pytest.raises((TypeError, ValueError)):
        pipeline.tonemap_rgb8(Vec3(*p), 1.0)


def test_wrappers_refuse_other_devices(geom):
    o, d, t = _rays(8)
    meta = lambda v: v.map(lambda c: c.to("meta"))
    with pytest.raises(ValueError):
        traverse.closest_hit(geom, meta(o), meta(d), t.to("meta"))
    with pytest.raises(ValueError):
        pipeline.tonemap_rgb8(Vec3(*[torch.zeros(2, 2, device="meta")] * 3),
                              1.0)
