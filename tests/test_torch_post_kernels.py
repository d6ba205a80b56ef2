"""The plain versions of K0 (camera rays), K7 (motion vectors) and K8
(``svgf_variance``, ``svgf_firefly``) against the JAX reference, and their
dispatching entry points on the CPU.

On the card each entry point launches its hand-written kernel
(``csrc/camera.cu``, ``csrc/motion.cu``, ``csrc/svgf.cu``), which
``chip_smoke.py`` holds to the plain version there; here, on the CPU, the
entry point returns the plain version, and the plain version is held to
the reference on the same numpy inputs, made from a seed.  The reference
runs eagerly (un-jitted, so XLA fuses nothing).

Tolerances.  The firefly clamp is max, min and one product: exact.  The
variance estimate: exact (every operation is one IEEE operation in the
same order in both, measured bit for bit); it is asserted within rtol 1e-6
(atol 1e-9) so that a one-ulp change of an XLA CPU kernel does not fail
it.  Camera rays: the PCG states exact, the jitter, origin and direction
within rtol 1e-6 (atol 1e-7), as tests/test_torch_rng_camera.py holds
``get_ray``.  Motion vectors: rtol 1e-5 (atol 1e-6), as
tests/test_torch_post.py holds them.  The whole file runs in ~10 s on
one CPU core.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ptrt_tpu.core import rng as ref_rng
from ptrt_tpu.core.bluenoise import blue_noise_table as ref_blue_noise_table
from ptrt_tpu.core.bluenoise import next_blue_noise as ref_next_blue_noise
from ptrt_tpu.core.taa import taa_jitter as ref_taa_jitter
from ptrt_tpu.core.vec import Vec3 as RefVec3
from ptrt_tpu.render import denoiser as ref_den
from ptrt_tpu.render import motion as ref_motion
from ptrt_tpu.scene.camera import Camera as RefCamera

from ptrt_tpu_torch.core.bluenoise import blue_noise_table
from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.render import denoiser, motion, pipeline, shade
from ptrt_tpu_torch.scene.camera import Camera
from test_torch_shading import torch_one_thread  # noqa: F401

CPU = torch.device("cpu")
SIZES = ((1, 1), (5, 7), (23, 37))
S, P = ref_den.DEFAULT_SETTINGS, denoiser.DEFAULT_SETTINGS


def _pv(a):
    return Vec3(*[torch.from_numpy(np.ascontiguousarray(c)) for c in a])


def _rv(a):
    return RefVec3(*[jnp.asarray(c) for c in a])


def _np(x):
    if isinstance(x, (Vec3, RefVec3)):
        return np.stack([np.asarray(c) for c in (x.x, x.y, x.z)])
    return np.asarray(x)


def _geometry(h, w, seed, sky_share=0.2):
    """Depth, unit normals and object ids of an (h, w) frame: sky pixels
    both past the depth threshold and with a zero normal, ids in 0-3 and
    -1 (none)."""
    r = np.random.default_rng(seed)
    depth = r.uniform(0.5, 20.0, (h, w)).astype(np.float32)
    n = r.normal(size=(3, h, w)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    sky = r.random((h, w)) < sky_share
    depth[sky & (r.random((h, w)) < 0.5)] = 1e30
    n[:, sky & (depth < 1e9)] = 0.0
    obj = r.integers(-1, 4, (h, w)).astype(np.int32)
    return depth, n, obj


def _history(h, w, seed):
    """A channel history: means over a wide range, second moments on both
    sides of mean^2 (the temporal variance clamps at 0), lengths 0-5."""
    r = np.random.default_rng(seed)
    mean = r.lognormal(-1.0, 1.5, (3, h, w)).astype(np.float32)
    m2 = (mean * mean * r.uniform(0.8, 3.0, (3, h, w))).astype(np.float32)
    length = r.integers(0, 6, (h, w)).astype(np.float32)
    return mean, m2, length


def _port_hist(mean, m2, length):
    return denoiser.ChannelHistory(mean=_pv(mean), m2=_pv(m2),
                                   length=torch.from_numpy(length))


def _ref_hist(mean, m2, length):
    return ref_den.ChannelHistory(mean=_rv(mean), m2=_rv(m2),
                                  length=jnp.asarray(length))


def _settings(use_obj: bool):
    return (dataclasses.replace(S, use_object_ids=use_obj),
            dataclasses.replace(P, use_object_ids=use_obj))


# -- K8: svgf_variance -------------------------------------------------------


@pytest.mark.parametrize("use_obj", [True, False], ids=["ids", "no-ids"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_estimate_variance_matches_reference(size, use_obj):
    h, w = size
    depth, n, obj = _geometry(h, w, seed=h * 100 + w)
    hist = _history(h, w, seed=h * 100 + w + 1)
    s_cfg, p_cfg = _settings(use_obj)
    want = _np(ref_den.estimate_variance(
        _ref_hist(*hist), jnp.asarray(depth), _rv(n), jnp.asarray(obj),
        s_cfg))
    got = denoiser.estimate_variance_plain(
        _port_hist(*hist), torch.from_numpy(depth), _pv(n),
        torch.from_numpy(obj), p_cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    sky = (depth > 1e9) | ((n * n).sum(0) < 0.1)
    assert (got[sky] == 0).all()
    if h * w > 1:  # every history length 0-5 reached, sky and surface
        assert set(hist[2][~sky].astype(int)) == set(range(6))
        assert sky.any() and (~sky).any()


# -- K8: svgf_firefly --------------------------------------------------------


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_firefly_suppression_matches_reference(size):
    """Fireflies in the corners and on the borders, where the zero-padded
    neighbourhood reaches past the image."""
    h, w = size
    depth, n, _ = _geometry(h, w, seed=7 * h + w)
    img = np.random.default_rng(h + w).lognormal(
        -1.0, 1.0, (3, h, w)).astype(np.float32)
    for y, x in ((0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1),
                 (h // 2, 0), (0, w // 2)):
        img[:, y, x] = 50.0
    want = _np(ref_den.firefly_suppression(_rv(img), jnp.asarray(depth),
                                           _rv(n), 3.0, 1e9))
    got = _np(denoiser.firefly_suppression_plain(
        _pv(img), torch.from_numpy(depth), _pv(n), 3.0, 1e9))
    assert np.array_equal(got, want)
    sky = (depth > 1e9) | ((n * n).sum(0) < 0.1)
    assert np.array_equal(got[:, sky], img[:, sky])
    assert (got[:, ~sky] <= 10.0).all()


def test_firefly_suppression_all_sky():
    h, w = 9, 13
    depth = np.full((h, w), 1e30, np.float32)
    n = np.zeros((3, h, w), np.float32)
    img = np.random.default_rng(3).lognormal(0.0, 2.0, (3, h, w)).astype(
        np.float32)
    want = _np(ref_den.firefly_suppression(_rv(img), jnp.asarray(depth),
                                           _rv(n), 3.0, 1e9))
    got = _np(denoiser.firefly_suppression(_pv(img), torch.from_numpy(depth),
                                           _pv(n), 3.0, 1e9))
    assert np.array_equal(got, want) and np.array_equal(got, img)


# -- the two-channel entry points and the CPU dispatch -----------------------


def test_firefly_pair_equals_each_channel():
    h, w = 23, 37
    depth, n, _ = _geometry(h, w, seed=11)
    r = np.random.default_rng(12)
    imgs = [_pv(r.lognormal(-1.0, 1.5, (3, h, w)).astype(np.float32))
            for _ in range(2)]
    g = (torch.from_numpy(depth), _pv(n))
    pair = denoiser.firefly_suppression_pair(imgs, *g, 1e9)
    for img, got in zip(imgs, pair):
        want = denoiser.firefly_suppression(img, *g, 3.0, 1e9)
        assert np.array_equal(_np(got), _np(want))
    with pytest.raises(ValueError):
        denoiser.firefly_suppression_pair(imgs[:1], *g, 1e9)


@pytest.mark.parametrize("use_obj", [True, False], ids=["ids", "no-ids"])
def test_variance_pair_equals_each_channel(use_obj):
    h, w = 23, 37
    depth, n, obj = _geometry(h, w, seed=13)
    hists = [_port_hist(*_history(h, w, seed=s)) for s in (14, 15)]
    g = (torch.from_numpy(depth), _pv(n), torch.from_numpy(obj))
    cfg = _settings(use_obj)[1]
    pair = denoiser.estimate_variance_pair(hists, *g, cfg)
    for hist, got in zip(hists, pair):
        want = denoiser.estimate_variance(hist, *g, cfg)
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        denoiser.estimate_variance_pair(hists * 2, *g, cfg)


def _camera(aperture: float, w: int, h: int, device=CPU):
    kw = dict(lookfrom=(3.0, 2.0, -1.0), lookat=(-1.0, 0.5, 8.0),
              vfov=35.0, aspect_ratio=w / h, aperture=aperture,
              focus_dist=5.0)
    return kw, Camera.make(**kw, device=device)


def _rng_state(h, w, seed):
    s = np.random.default_rng(seed).integers(0, 2 ** 32, (h, w),
                                              dtype=np.uint64)
    s.flat[:2] = [0, 2 ** 32 - 1]
    return s.astype(np.int64)


def test_cpu_dispatch_returns_the_plain_versions():
    h, w = 5, 7
    depth, n, obj = _geometry(h, w, seed=21)
    g = (torch.from_numpy(depth), _pv(n), torch.from_numpy(obj))
    hist = _port_hist(*_history(h, w, seed=22))
    assert torch.equal(denoiser.estimate_variance(hist, *g, P),
                       denoiser.estimate_variance_plain(hist, *g, P))
    img = hist.mean
    assert np.array_equal(
        _np(denoiser.firefly_suppression(img, *g[:2], 3.0, 1e9)),
        _np(denoiser.firefly_suppression_plain(img, *g[:2], 3.0, 1e9)))
    _, cam = _camera(0.2, w, h)
    vp = _camera(0.0, w, h)[1].get_view_proj()
    for a, b in zip(motion.motion_vectors(g[0], cam, vp, w, h),
                    motion.motion_vectors_plain(g[0], cam, vp, w, h)):
        assert torch.equal(a, b)
    st = torch.from_numpy(_rng_state(h, w, 23))
    bn = blue_noise_table(CPU)
    sa, ra = pipeline.camera_rays(cam, st, 5, 1, bn)
    sb, rb = pipeline.camera_rays_plain(cam, st, 5, 1, bn)
    assert torch.equal(sa, sb)
    for a, b in ((ra.origin, rb.origin), (ra.direction, rb.direction)):
        assert np.array_equal(_np(a.map(lambda c: c.expand(h, w))),
                              _np(b.map(lambda c: c.expand(h, w))))


@pytest.mark.parametrize("stage", ["firefly", "variance", "motion",
                                   "camera"])
def test_other_devices_are_refused(stage):
    """A tensor on neither the CPU nor the card has no kernel and no plain
    version: the entry point raises before it computes anything."""
    meta = torch.device("meta")
    z = torch.empty((4, 4), device=meta)
    v = Vec3(z, z, z)
    calls = {
        "firefly": lambda: denoiser.firefly_suppression(v, z, v, 3.0, 1e9),
        "variance": lambda: denoiser.estimate_variance(
            denoiser.ChannelHistory(mean=v, m2=v, length=z), z, v,
            torch.empty((4, 4), dtype=torch.int32, device=meta), P),
        "motion": lambda: motion.motion_vectors(z, None, z, 4, 4),
        "camera": lambda: pipeline.camera_rays(
            None, torch.empty((4, 4), dtype=torch.int64, device=meta), 0, 0,
            z),
    }
    with pytest.raises(ValueError, match="no kernel or plain version"):
        calls[stage]()


# -- K7: motion vectors ------------------------------------------------------


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_motion_vectors_match_reference(size):
    """Sky pixels (1e30, and 5e29 between the two packages' sky
    thresholds) and a previous camera that sees some points from behind."""
    h, w = size
    depth = np.random.default_rng(h * w).uniform(0.5, 30.0, (h, w)).astype(
        np.float32)
    depth.flat[::5] = 1e30
    depth.flat[1::7] = 5e29
    kw, cam = _camera(0.0, w, h)
    kw0 = dict(kw, lookfrom=(4.0, 2.5, 2.0), lookat=(3.0, 2.0, -3.0))
    want = ref_motion.motion_vectors(
        jnp.asarray(depth), RefCamera.make(**kw),
        RefCamera.make(**kw0).get_view_proj(), w, h)
    got = motion.motion_vectors(
        torch.from_numpy(depth), cam,
        Camera.make(**kw0, device=CPU).get_view_proj(), w, h)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
        assert (a.numpy()[depth >= 1e29] == 0).all()


# -- K0: camera rays ---------------------------------------------------------


def _ref_camera_rays(kw, st, frame: int, sample: int, tile, h, w):
    """The camera-ray part of the reference's ``trace_batch``
    (``ptrt_tpu/render/pipeline.py:92-109``) for one sample (sb = 1)."""
    ys, xs = jnp.mgrid[0:h, 0:w]
    if tile is not None:
        y0, x0, full_h, full_w = tile
        ys, xs = ys + y0, xs + x0
    else:
        full_h, full_w = h, w
    s_idx = jnp.arange(1) + sample
    fidx = frame + s_idx
    jx_t, jy_t = ref_taa_jitter(fidx)
    bx, by = ref_next_blue_noise(ref_blue_noise_table(), xs, ys,
                                 fidx[:, None, None])
    jitter_x = jx_t[:, None, None] + (bx - 0.5) * 0.25
    jitter_y = jy_t[:, None, None] + (by - 0.5) * 0.25
    xf = xs.astype(jnp.float32)[None, :, :]
    yf = ys.astype(jnp.float32)[None, :, :]
    sg = (xf + 0.5 + jitter_x) / float(full_w)
    tg = (yf + 0.5 + jitter_y) / float(full_h)
    sub = ref_rng.fold(jnp.asarray(st.astype(np.uint32)),
                       s_idx[:, None, None] + 1)
    return RefCamera.make(**kw).get_ray(sg, tg, sub)


@pytest.mark.parametrize("index", ["int", "tensor"])
@pytest.mark.parametrize("aperture", [0.0, 0.2], ids=["pinhole", "dof"])
@pytest.mark.parametrize("tile", [None, (5, 9, 24, 40)],
                         ids=["whole", "tile"])
def test_camera_rays_match_reference(tile, aperture, index):
    """One sample's rays (sample 2 of frame 21: a TAA index past the
    table's 16) as a whole 24x40 frame or its 12x20 tile at (5, 9), a
    pinhole or a lens, the frame index a Python int or a 0-d tensor."""
    h, w = (24, 40) if tile is None else (12, 20)
    frame, sample = 21, 2
    kw, cam = _camera(aperture, 40, 24)
    st = _rng_state(h, w, seed=31)
    idx = frame if index == "int" else torch.tensor(frame, dtype=torch.int32)
    sub, ray = pipeline.camera_rays(cam, torch.from_numpy(st), idx, sample,
                                    blue_noise_table(CPU), tile)
    rsub, rray = _ref_camera_rays(kw, st, frame, sample, tile, h, w)
    assert np.array_equal(sub.numpy().astype(np.uint32),
                          np.asarray(rsub)[0])
    for a, b in ((ray.origin, rray.origin), (ray.direction, rray.direction)):
        for ca, cb in zip((a.x, a.y, a.z), (b.x, b.y, b.z)):
            np.testing.assert_allclose(
                ca.expand(h, w).numpy(), np.broadcast_to(
                    np.asarray(cb), (1, h, w))[0], rtol=1e-6, atol=1e-7)
    spread = _np(ray.origin.map(lambda c: c.expand(h, w))).std(axis=(1, 2))
    assert (spread > 0).any() == (aperture > 0)  # the lens moves origins


def test_path_state_takes_own_planes():
    """``PathState.start(own=True)`` takes the camera rays' contiguous
    planes as they are; without it every plane is a copy."""
    h, w = 6, 8
    _, cam = _camera(0.2, w, h)
    sub, ray = pipeline.camera_rays(
        cam, torch.from_numpy(_rng_state(h, w, 41)), 3, 0,
        blue_noise_table(CPU))
    planes = [sub, ray.origin.x, ray.direction.z]
    taken = shade.PathState.start(ray, sub, False, own=True)
    copied = shade.PathState.start(ray, sub, False)
    for p, t, c in zip(planes, (taken.rng, taken.o.x, taken.d.z),
                       (copied.rng, copied.o.x, copied.d.z)):
        assert t.data_ptr() == p.data_ptr() and t.shape == (h * w,)
        assert c.data_ptr() != p.data_ptr() and torch.equal(c, t)
