"""ptrt_tpu_torch random streams, jitter and camera rays against the JAX
reference.  The PCG bits are the algorithm, so the streams must agree bit
for bit, states above 2^31 included; the TAA and blue-noise jitters are
exact table lookups and hashes; camera rays are float32 arithmetic in both
packages and must agree to rtol=1e-6."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ptrt_tpu.core import rng as ref_rng
from ptrt_tpu.core.bluenoise import blue_noise_table as ref_blue_noise_table
from ptrt_tpu.core.bluenoise import next_blue_noise as ref_next_blue_noise
from ptrt_tpu.core.taa import taa_jitter as ref_taa_jitter
from ptrt_tpu.scene.camera import Camera as RefCamera

from ptrt_tpu_torch.core import rng
from ptrt_tpu_torch.core.bluenoise import blue_noise_table, next_blue_noise
from ptrt_tpu_torch.core.taa import taa_jitter
from ptrt_tpu_torch.scene.camera import Camera
from test_torch_shading import torch_one_thread  # noqa: F401

CPU = torch.device("cpu")
N = 100_000


def _states(seed):
    r = np.random.default_rng(seed)
    s = r.integers(0, 2 ** 32, size=N, dtype=np.uint64).astype(np.uint32)
    s[:4] = [0, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]  # edges
    return s


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def test_states_cover_high_bit():
    assert (_states(0) >= 2 ** 31).mean() > 0.4


@pytest.mark.parametrize("steps", [1, 3])
def test_uniform_bit_exact(steps):
    s = _states(1)
    rs, ps = jnp.asarray(s), _t(s)
    for _ in range(steps):
        rs, ru = ref_rng.uniform(rs)
        ps, pu = rng.uniform(ps)
        assert np.array_equal(np.asarray(rs), ps.numpy().astype(np.uint32))
        assert np.array_equal(_bits(ru), _bits(pu.numpy()))


def test_uniform2_bit_exact():
    s = _states(2)
    rs, r1, r2 = ref_rng.uniform2(jnp.asarray(s))
    ps, p1, p2 = rng.uniform2(_t(s))
    assert np.array_equal(np.asarray(rs), ps.numpy().astype(np.uint32))
    assert np.array_equal(_bits(r1), _bits(p1.numpy()))
    assert np.array_equal(_bits(r2), _bits(p2.numpy()))


@pytest.mark.parametrize("frame", [0, 7, 2 ** 31 + 5])
def test_seed_bit_exact(frame):
    r = np.random.default_rng(3)
    x = r.integers(0, 4096, size=N).astype(np.int32)
    y = r.integers(0, 4096, size=N).astype(np.int32)
    ref = ref_rng.seed(jnp.asarray(x), jnp.asarray(y), np.uint32(frame))
    got = rng.seed(torch.from_numpy(x), torch.from_numpy(y), frame)
    assert np.array_equal(np.asarray(ref), got.numpy().astype(np.uint32))


@pytest.mark.parametrize("salt", [1, 2, 4, 17, 2 ** 32 - 3])
def test_fold_bit_exact(salt):
    s = _states(4)
    ref = ref_rng.fold(jnp.asarray(s), np.uint32(salt))
    got = rng.fold(_t(s), salt)
    assert np.array_equal(np.asarray(ref), got.numpy().astype(np.uint32))


def test_mul32_matches_uint32_wraparound():
    a = _states(5)
    for c in (0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35, 747796405):
        want = (a.astype(np.uint64) * np.uint64(c)) & np.uint64(0xFFFFFFFF)
        got = rng.mul32(_t(a), c).numpy()
        assert np.array_equal(want.astype(np.int64), got)


def test_taa_jitter_exact():
    f = np.arange(-20, 70, dtype=np.int32)
    rx, ry = ref_taa_jitter(jnp.asarray(f))
    px, py = taa_jitter(torch.from_numpy(f))
    assert np.array_equal(_bits(rx), _bits(px.numpy()))
    assert np.array_equal(_bits(ry), _bits(py.numpy()))


@pytest.mark.parametrize("frame", [0, 1, 5, 123456, 2 ** 31 + 11])
def test_next_blue_noise_exact(frame):
    r = np.random.default_rng(6)
    x = r.integers(0, 2000, size=4096).astype(np.int32)
    y = r.integers(0, 2000, size=4096).astype(np.int32)
    tbl = blue_noise_table(CPU)
    assert np.array_equal(np.asarray(ref_blue_noise_table()), tbl.numpy())
    ru, rv = ref_next_blue_noise(ref_blue_noise_table(), jnp.asarray(x),
                                 jnp.asarray(y), np.uint32(frame))
    pu, pv = next_blue_noise(tbl, torch.from_numpy(x), torch.from_numpy(y),
                             frame)
    assert np.array_equal(_bits(ru), _bits(pu.numpy()))
    assert np.array_equal(_bits(rv), _bits(pv.numpy()))


CAMS = [
    dict(lookfrom=(0, 1.2, -1.5), lookat=(0, 0, 6), vfov=60.0,
         aspect_ratio=16 / 9, aperture=0.0, focus_dist=7.6),
    dict(lookfrom=(3, 2, 1), lookat=(-1, 0.5, 8), vfov=35.0,
         aspect_ratio=4 / 3, aperture=0.2, focus_dist=5.0),
]


@pytest.mark.parametrize("cam", range(len(CAMS)))
def test_camera_get_ray(cam):
    kw = CAMS[cam]
    ref = RefCamera.make(**kw)
    port = Camera.make(**kw, device=CPU)
    for name in ("origin", "lower_left_corner", "horizontal", "vertical"):
        rv, pv = getattr(ref, name), getattr(port, name)
        for a, b in zip((rv.x, rv.y, rv.z), (pv.x, pv.y, pv.z)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)
    r = np.random.default_rng(7)
    s = r.random((48, 64), dtype=np.float32)
    t = r.random((48, 64), dtype=np.float32)
    st = _states(8)[:48 * 64].reshape(48, 64)
    rs, rray = jax.jit(lambda s_, t_, st_: ref.get_ray(s_, t_, st_))(
        jnp.asarray(s), jnp.asarray(t), jnp.asarray(st))
    ps, pray = port.get_ray(torch.from_numpy(s), torch.from_numpy(t), _t(st))
    assert np.array_equal(np.asarray(rs), ps.numpy().astype(np.uint32))
    for a, b in zip((rray.origin, rray.direction),
                    (pray.origin, pray.direction)):
        for ca, cb in zip((a.x, a.y, a.z), (b.x, b.y, b.z)):
            np.testing.assert_allclose(cb.numpy(), np.asarray(ca), rtol=1e-6,
                                       atol=1e-7)
