"""The post stack against the JAX reference on identical inputs.

The buffers are real: the port traces the bench scene (48x64, then a
24x40 frame under 33 px tall so the à-trous dilation 16 reaches past the
image) with the denoiser's split channels, under three cameras orbiting
by 1.5 degrees a frame.  Both packages then get the same numpy arrays;
the reference runs eagerly (un-jitted, so XLA fuses nothing).

Bounds, per output.  Matrices, projection and motion vectors: rtol 1e-5
(motion is a difference of two uvs, so atol 1e-6 of the unit uv range).
Firefly suppression: exact (max, min and one product).  Temporal stage,
variance and one à-trous pass: rtol 1e-5 (atol 1e-7) on every pixel,
history length exact.  Three chained frames of ``denoise_frame``, each
package on its own state: rtol 1e-5 (atol 1e-6) on 99.9% of pixels and
1e-3 on all, history lengths equal on 99.9% — an ulp of the exp in the
à-trous weights (XLA's and torch's differ) could move a pixel across an
edge-stop threshold in a later frame.  Measured: the temporal means,
variances and lengths bit-identical, à-trous and the denoised colour
within 3.4e-7 relative everywhere.  Bloom and the bilinear upscale: rtol
1e-5, atol 1e-6.  This file runs in ~45 s on one CPU core.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from ptrt_tpu.core import mat as ref_mat
from ptrt_tpu.core.vec import Vec3 as RefVec3
from ptrt_tpu.render import bloom as ref_bloom
from ptrt_tpu.render import denoiser as ref_den
from ptrt_tpu.render import motion as ref_motion
from ptrt_tpu.render import pipeline as ref_pipeline
from ptrt_tpu.scene.camera import Camera as RefCamera
from ptrt_tpu.scene.camera import pixel_grid as ref_pixel_grid

from ptrt_tpu_torch.app.bench_scene import build_bench_scene
from ptrt_tpu_torch.core import mat
from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.render import bloom, denoiser, motion, pipeline
from ptrt_tpu_torch.scene.camera import Camera, pixel_grid
from test_torch_shading import torch_one_thread  # noqa: F401

CPU = torch.device("cpu")
ORBIT_DEG = 0.3


def _cam_kw(k: int, w: int, h: int) -> dict:
    a = np.radians(ORBIT_DEG * k)
    r = 9.0
    return dict(lookfrom=(r * np.sin(a), 3.5, -r * np.cos(a) + 5.0),
                lookat=(0.0, 0.0, 5.0), vup=(0.0, 1.0, 0.0), vfov=50.0,
                aspect_ratio=w / h, aperture=0.0, focus_dist=9.5)


def _np(x):
    if isinstance(x, Vec3):
        return np.stack([c.numpy() for c in (x.x, x.y, x.z)])
    if isinstance(x, RefVec3):
        return np.stack([np.asarray(c) for c in (x.x, x.y, x.z)])
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pv(a):
    return Vec3(*[torch.from_numpy(np.ascontiguousarray(c)) for c in a])


def _rv(a):
    return RefVec3(*[jnp.asarray(c) for c in a])


def _frames(w, h):
    """Three traced frames (numpy) under the orbiting cameras, plus the
    motion vectors of frames 1 and 2 against their predecessors."""
    sc = build_bench_scene(w, h, target_tris=1500, device="cpu")
    sc.set_performance_preset("balanced")
    sc._ensure_device_state()
    out = []
    for k in range(3):
        cam = Camera.make(**_cam_kw(k, w, h), device=CPU)
        sc._rng_state, b = pipeline.trace_frame(
            sc._geom, sc._mat_table, sc._light_table, len(sc.lights), sc.sky(),
            cam, sc._rng_state, k, w, h, 1, 3, sc._blue_noise, split=True,
            rr_start=1)
        f = {name: _np(getattr(b, name)) for name in (
            "color", "diffuse", "specular", "emission", "normal", "depth",
            "object_id", "roughness", "transmission")}
        f["camera"] = cam
        if k:
            mx, my = motion.motion_vectors(b.depth, cam,
                                           out[-1]["camera"].get_view_proj(),
                                           w, h)
            f["mv"] = (mx.numpy(), my.numpy())
        else:
            f["mv"] = (np.zeros((h, w), np.float32),) * 2
        out.append(f)
    return out


@pytest.fixture(scope="module")
def frames():
    return _frames(64, 48)


@pytest.fixture(scope="module")
def small_frames():
    return _frames(40, 24)


def _close(got, want, rtol, share=1.0, atol=0.0, what=""):
    got = np.asarray(_np(got), np.float64)
    want = np.asarray(_np(want), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    ok = np.abs(got - want) <= rtol * np.abs(want) + atol
    if want.ndim == 3:  # a Vec3 plane stack: a pixel is ok if all three are
        ok = ok.all(0)
    assert ok.mean() >= share, (
        f"{what}: {(~ok).sum()} of {ok.size} beyond rtol {rtol}, max abs "
        f"err {np.abs(got - want).max():.3g}")


def _tiers(got, want, what, tiers=((1e-5, 1.0),), atol=1e-7):
    for rtol, share in tiers:
        _close(got, want, rtol, share, atol, what)


# -- matrices, camera, motion vectors -----------------------------------------


@pytest.mark.parametrize("k", [0, 1, 5])
def test_camera_matrices(k):
    kw = _cam_kw(k, 64, 48)
    ref = RefCamera.make(**kw)
    cam = Camera.make(**kw, device=CPU)
    for name in ("view", "proj", "inv_view_proj"):
        _close(_np(getattr(cam, name)), getattr(ref, name), 1e-5, atol=1e-6,
               what=name)
    _close(_np(cam.get_view_proj()), ref.get_view_proj(), 1e-5, atol=1e-6)
    eye = kw["lookfrom"]
    f32 = lambda p: Vec3(*[torch.tensor(float(c)) for c in p])
    r32 = lambda p: RefVec3(*[jnp.float32(c) for c in p])
    _close(_np(mat.look_at(f32(eye), f32((0, 0, 5)), f32((0, 1, 0)))),
           ref_mat.look_at(r32(eye), r32((0, 0, 5)), r32((0, 1, 0))), 1e-6,
           atol=1e-7)
    _close(_np(mat.perspective(torch.tensor(0.9), torch.tensor(1.5), 0.1,
                               1000.0)),
           ref_mat.perspective(jnp.float32(0.9), jnp.float32(1.5), 0.1,
                               1000.0), 1e-6)


def test_project_point_and_rays():
    r = np.random.default_rng(5)
    p = r.uniform(-20, 20, (3, 4096)).astype(np.float32)
    p[:, :4] = 0.0  # w = 0 edge of the 1e-12 guard for an identity row
    m = r.normal(size=(4, 4)).astype(np.float32)
    m[3, :3] = 0.0
    m[3, 3] = 0.0
    ndc, w = mat.project_point(torch.from_numpy(m), _pv(p))
    rndc, rw = ref_mat.project_point(jnp.asarray(m), _rv(p))
    _close(_np(w), rw, 1e-6)
    _close(_np(ndc), rndc, 1e-5, atol=1e-6)
    s, t = pixel_grid(40, 24, CPU)
    rs, rt = ref_pixel_grid(40, 24)
    assert np.array_equal(s.numpy(), np.asarray(rs))
    assert np.array_equal(t.numpy(), np.asarray(rt))
    kw = _cam_kw(2, 40, 24)
    ray = Camera.make(**kw, device=CPU).get_ray_simple(s, t)
    rray = RefCamera.make(**kw).get_ray_simple(rs, rt)
    _close(_np(ray.direction), rray.direction, 1e-6, atol=1e-7)


def test_motion_vectors(frames):
    f0, f1 = frames[0], frames[1]
    kw0, kw1 = _cam_kw(0, 64, 48), _cam_kw(1, 64, 48)
    depth = f1["depth"].copy()
    depth[0, :4] = 5e29  # between the two sky thresholds: still moves
    rmx, rmy = ref_motion.motion_vectors(
        jnp.asarray(depth), RefCamera.make(**kw1),
        RefCamera.make(**kw0).get_view_proj(), 64, 48)
    mx, my = motion.motion_vectors(
        torch.from_numpy(depth), Camera.make(**kw1, device=CPU),
        Camera.make(**kw0, device=CPU).get_view_proj(), 64, 48)
    _close(_np(mx), rmx, 1e-5, atol=1e-6, what="mx")
    _close(_np(my), rmy, 1e-5, atol=1e-6, what="my")
    sky = depth >= 1e29
    assert sky.any() and (~sky).any()
    assert (_np(mx)[sky] == 0).all() and (_np(my)[sky] == 0).all()
    assert np.abs(_np(mx)[~sky]).max() > 1e-3  # the orbit really moves


# -- SVGF stages ---------------------------------------------------------------


def _states(f, hist_len, first=False):
    """The same previous-frame state in both packages: history from frame
    ``f``'s channels, lengths ``hist_len``."""
    ref_hist = lambda c: ref_den.ChannelHistory(
        mean=_rv(f[c]), m2=_rv(f[c] * f[c] * 1.1),
        length=jnp.asarray(hist_len))
    port_hist = lambda c: denoiser.ChannelHistory(
        mean=_pv(f[c]), m2=_pv(f[c] * f[c] * 1.1),
        length=torch.from_numpy(hist_len))
    ref = ref_den.DenoiserState(
        diffuse=ref_hist("diffuse"), specular=ref_hist("specular"),
        normal=_rv(f["normal"]), depth=jnp.asarray(f["depth"]),
        object_id=jnp.asarray(f["object_id"]), first_frame=jnp.asarray(first))
    port = denoiser.DenoiserState(
        diffuse=port_hist("diffuse"), specular=port_hist("specular"),
        normal=_pv(f["normal"]), depth=torch.from_numpy(f["depth"]),
        object_id=torch.from_numpy(f["object_id"]),
        first_frame=torch.tensor(first))
    return ref, port


def _g(f, port: bool):
    """(depth, normal, object id) of a frame in one package's types."""
    if port:
        return (torch.from_numpy(f["depth"]), _pv(f["normal"]),
                torch.from_numpy(f["object_id"]))
    return (jnp.asarray(f["depth"]), _rv(f["normal"]),
            jnp.asarray(f["object_id"]))


S = ref_den.DEFAULT_SETTINGS
P = denoiser.DEFAULT_SETTINGS


def test_settings_match():
    assert S.diffuse == ref_den.ChannelSettings(**vars(P.diffuse))
    assert S.specular == ref_den.ChannelSettings(**vars(P.specular))
    for k, v in vars(P).items():
        if k not in ("diffuse", "specular"):
            assert getattr(S, k) == v, k


def test_firefly_suppression(frames):
    f = frames[1]
    img = f["diffuse"].copy()
    img[:, 10, 10] = 50.0  # a firefly
    got = denoiser.firefly_suppression(_pv(img), *_g(f, True)[:2], 3.0, 1e9)
    want = ref_den.firefly_suppression(_rv(img), *_g(f, False)[:2], 3.0, 1e9)
    assert np.array_equal(_np(got), _np(want))
    assert _np(got)[:, 10, 10].max() <= 10.0 or f["depth"][10, 10] > 1e9


@pytest.mark.parametrize("prev", ["moved", "still"])
@pytest.mark.parametrize("channel", ["diffuse", "specular"])
def test_temporal_accumulation(frames, channel, prev):
    """"moved": history from the previous camera, this frame's motion
    vectors; "still": history from this very frame and no motion, so every
    surface pixel keeps it."""
    f = frames[1]
    h, w = f["depth"].shape
    lens = np.random.default_rng(7).integers(1, 40, (h, w)).astype(
        np.float32)
    rs, ps = _states(frames[0] if prev == "moved" else f, lens)
    mv = f["mv"] if prev == "moved" else (np.zeros((h, w), np.float32),) * 2
    ch_r, ch_p = getattr(S, channel), getattr(P, channel)
    cap = None
    if channel == "specular":
        cap = np.clip(f["roughness"] / 0.35, 0, 1) * 5.0 + 1.0
    want = ref_den.temporal_accumulation(
        _rv(f[channel]), getattr(rs, channel), jnp.asarray(mv[0]),
        jnp.asarray(mv[1]), *_g(f, False), rs, ch_r, S,
        hist_cap=None if cap is None else jnp.asarray(cap))
    got = denoiser.temporal_accumulation(
        _pv(f[channel]), getattr(ps, channel), torch.from_numpy(mv[0]),
        torch.from_numpy(mv[1]), *_g(f, True), ps, ch_p, P,
        hist_cap=None if cap is None else torch.from_numpy(cap))
    _tiers(_np(got.mean), want.mean, "mean")
    _tiers(_np(got.m2), want.m2, "m2")
    assert np.array_equal(_np(got.length), _np(want.length))
    # history kept where it should be: at this size a jittered floor pixel
    # spans more depth than the 0.5% rejection allows, so a moved camera
    # keeps it on a few pixels only
    kept = (_np(got.length) > 1)[f["depth"] < 1e9].mean()
    assert kept > (0.05 if prev == "moved" else 0.9), kept


def test_temporal_first_frame_flag(frames):
    """``first=True`` makes the history the current frame, as the
    reference's ``denoise_channel`` does before its temporal stage."""
    f = frames[1]
    lens = np.full(f["depth"].shape, 9.0, np.float32)
    _, ps = _states(frames[0], lens)
    cur = _pv(f["diffuse"])
    mv = [torch.from_numpy(m) for m in f["mv"]]
    got = denoiser.temporal_accumulation(cur, ps.diffuse, *mv, *_g(f, True),
                                         ps, P.diffuse, P,
                                         first=torch.tensor(True))
    subst = denoiser.ChannelHistory(mean=cur, m2=cur * cur,
                                    length=torch.ones_like(ps.depth))
    want = denoiser.temporal_accumulation_plain(cur, subst, *mv,
                                                *_g(f, True), ps, P.diffuse, P)
    for a, b in ((got.mean, want.mean), (got.m2, want.m2),
                 (got.length, want.length)):
        assert np.array_equal(_np(a), _np(b))


@pytest.mark.parametrize("first", [False, True])
def test_temporal_pair_is_each_channel_alone(frames, first):
    """``temporal_accumulation_pair`` (one launch on the card for both
    channels of a split frame) equals the one-channel entry on each channel,
    which equals the reference, with the specular cap on its channel and
    the first-frame flag off or on."""
    f = frames[1]
    h, w = f["depth"].shape
    lens = np.random.default_rng(9).integers(1, 40, (h, w)).astype(np.float32)
    rs, ps = _states(frames[0], lens, first=first)
    cap = np.clip(f["roughness"] / 0.35, 0, 1) * 5.0 + 1.0
    mv = tuple(torch.from_numpy(m) for m in f["mv"])
    chans = [(_pv(f[c]), getattr(ps, c), getattr(P, c), k)
             for c, k in (("diffuse", None),
                          ("specular", torch.from_numpy(cap)))]
    pair = denoiser.temporal_accumulation_pair(
        chans, *mv, *_g(f, True), ps, P, first=ps.first_frame)
    for (cur, hist, ch, k), got, name in zip(chans, pair,
                                             ("diffuse", "specular")):
        alone = denoiser.temporal_accumulation(
            cur, hist, *mv, *_g(f, True), ps, ch, P, hist_cap=k,
            first=ps.first_frame)
        for a, b in ((got.mean, alone.mean), (got.m2, alone.m2),
                     (got.length, alone.length)):
            assert np.array_equal(_np(a), _np(b))
        # the reference's denoise_channel: history := current on the first
        # frame, before its temporal stage
        rh = getattr(rs, name)
        if first:
            rh = ref_den.ChannelHistory(mean=_rv(f[name]),
                                        m2=_rv(f[name] * f[name]),
                                        length=jnp.ones((h, w)))
        want = ref_den.temporal_accumulation(
            _rv(f[name]), rh, *(jnp.asarray(m) for m in f["mv"]),
            *_g(f, False), rs, getattr(S, name), S,
            hist_cap=None if k is None else jnp.asarray(cap))
        _tiers(_np(got.mean), want.mean, f"{name} mean")
        _tiers(_np(got.m2), want.m2, f"{name} m2")
        assert np.array_equal(_np(got.length), _np(want.length))


def test_estimate_variance(frames):
    f = frames[1]
    lens = np.random.default_rng(8).integers(1, 8, f["depth"].shape).astype(
        np.float32)
    rs, ps = _states(f, lens)
    want = ref_den.estimate_variance(rs.diffuse, *_g(f, False), S)
    got = denoiser.estimate_variance(ps.diffuse, *_g(f, True), P)
    _tiers(_np(got), want, "variance")


@pytest.mark.parametrize("size", ["48x64", "24x40"])
@pytest.mark.parametrize("step", [1, 2, 4, 8, 16])
def test_atrous_iteration(frames, small_frames, size, step):
    f = (frames if size == "48x64" else small_frames)[1]
    var = np.abs(np.random.default_rng(step).normal(
        0, 0.05, f["depth"].shape)).astype(np.float32)
    want = ref_den.atrous_iteration(_rv(f["diffuse"]), jnp.asarray(var),
                                    *_g(f, False), step, S.diffuse, S)
    got = denoiser.atrous_iteration(_pv(f["diffuse"]), torch.from_numpy(var),
                                    *_g(f, True), step, P.diffuse, P)
    _tiers(_np(got[0]), want[0], "image")
    _tiers(_np(got[1]), want[1], "variance")
    if size == "24x40" and step == 16:
        # rows +-32 lie wholly outside a 24-row image: the all-zero shift
        assert f["depth"].shape[0] < 33


def _ref_bufs(f):
    return ref_pipeline.FrameBuffers(
        color=_rv(f["color"]), diffuse=_rv(f["diffuse"]),
        specular=_rv(f["specular"]), emission=_rv(f["emission"]),
        normal=_rv(f["normal"]), depth=jnp.asarray(f["depth"]),
        object_id=jnp.asarray(f["object_id"]),
        roughness=jnp.asarray(f["roughness"]),
        transmission=jnp.asarray(f["transmission"]),
        rays_traced=jnp.float32(0))


def _port_bufs(f):
    return pipeline.FrameBuffers(
        color=_pv(f["color"]), diffuse=_pv(f["diffuse"]),
        specular=_pv(f["specular"]), emission=_pv(f["emission"]),
        normal=_pv(f["normal"]), depth=torch.from_numpy(f["depth"]),
        object_id=torch.from_numpy(f["object_id"]),
        roughness=torch.from_numpy(f["roughness"]),
        transmission=torch.from_numpy(f["transmission"]),
        rays_traced=torch.tensor(0))


@pytest.mark.parametrize("size", ["48x64", "24x40"])
def test_denoise_frame_three_frames(frames, small_frames, size):
    fs = frames if size == "48x64" else small_frames
    h, w = fs[0]["depth"].shape
    rs = ref_den.init_denoiser_state(h, w)
    ps = denoiser.init_denoiser_state(h, w, CPU)
    for k, f in enumerate(fs):
        rc, rs = ref_den.denoise_frame(
            _ref_bufs(f), tuple(jnp.asarray(m) for m in f["mv"]), rs, None, k)
        pc, ps = denoiser.denoise_frame(
            _port_bufs(f), tuple(torch.from_numpy(m) for m in f["mv"]), ps,
            None, k)
        tiers = ((1e-5, 0.999), (1e-3, 1.0))
        _tiers(_np(pc), rc, f"frame {k} color", tiers, atol=1e-6)
        for ch in ("diffuse", "specular"):
            hr, hp = getattr(rs, ch), getattr(ps, ch)
            _tiers(_np(hp.mean), hr.mean, f"frame {k} {ch} mean", tiers,
                   atol=1e-6)
            agree = (_np(hp.length) == _np(hr.length)).mean()
            assert agree >= 0.999, (k, ch, agree)
        assert not bool(ps.first_frame)
    # history survived the camera moves (on a few pixels at this size, see
    # test_temporal_accumulation)
    surface = fs[-1]["depth"] < 1e9
    assert (_np(ps.diffuse.length)[surface] > 1).mean() > 0.03


def test_denoise_frame_unsplit(small_frames):
    """Split denoising off: one channel, the colour, through the one-channel
    temporal stage (the split frame takes the two-channel launch), on a
    frame with history; one à-trous pass (the eager reference takes seconds
    a pass)."""
    f = small_frames[1]
    lens = np.random.default_rng(10).integers(1, 40, f["depth"].shape).astype(
        np.float32)
    rs, ps = _states(small_frames[0], lens)
    unsplit = lambda m: m.DenoiserSettings(
        diffuse=dataclasses.replace(m.DEFAULT_SETTINGS.diffuse,
                                    atrous_iterations=1),
        enable_split_denoising=False)
    rc, rs = ref_den.denoise_frame(
        _ref_bufs(f), tuple(jnp.asarray(m) for m in f["mv"]), rs, None, 1,
        unsplit(ref_den))
    pc, ps = denoiser.denoise_frame(
        _port_bufs(f), tuple(torch.from_numpy(m) for m in f["mv"]), ps, None,
        1, unsplit(denoiser))
    tiers = ((1e-5, 0.999), (1e-3, 1.0))
    _tiers(_np(pc), rc, "color", tiers, atol=1e-6)
    _tiers(_np(ps.diffuse.mean), rs.diffuse.mean, "mean", tiers, atol=1e-6)
    assert np.array_equal(_np(ps.diffuse.length), _np(rs.diffuse.length))
    # the specular history is carried, untouched
    assert np.array_equal(_np(ps.specular.length), _np(rs.specular.length))


# -- bloom and upscale ---------------------------------------------------------


def _hdr(h, w, seed):
    r = np.random.default_rng(seed)
    a = r.lognormal(-1.0, 1.2, (3, h, w)).astype(np.float32)
    a[:, h // 3, w // 4] = 40.0  # a hot spot
    return a


@pytest.mark.parametrize("shape", [(67, 45), (33, 31), (5, 4)])
def test_blur_down(shape):
    """One mip step (on the card a phase of the bloom chain's launch)."""
    a = _hdr(*shape, 1)
    want = ref_bloom._downsample_v(ref_bloom._blur_h(_rv(a)))
    got = bloom.blur_down_plain(_pv(a))
    assert _np(got).shape == (3, shape[0] // 2, (shape[1] + 1) // 2)
    _close(_np(got), want, 1e-6, atol=1e-7)
    # the chain's mip 0 is this step on the bright pass of its input
    mips, _, _ = bloom.bloom_chain(_pv(a))
    assert np.array_equal(_np(mips[0]), _np(bloom.blur_down_plain(
        bloom.bright_pass(_pv(a)))))


@pytest.mark.parametrize("shape", [(67, 45), (48, 64), (3, 7)])
def test_apply_bloom(shape):
    a = _hdr(*shape, 2)
    want = ref_bloom.apply_bloom(_rv(a))
    got = bloom.apply_bloom(_pv(a))
    _close(_np(got), want, 1e-5, atol=1e-6, what="bloom")
    assert not np.allclose(_np(got), a)  # the glow is there


@pytest.mark.parametrize("src,dst", [((27, 37), (48, 64)), ((36, 48),
                                                           (48, 64)),
                                     ((8, 11), (23, 31))])
def test_upscale_bilinear(src, dst):
    a = _hdr(*src, 3)
    want = _np(ref_pipeline.upscale_bilinear(_rv(a), *dst))
    got = _np(pipeline.upscale_bilinear(_pv(a), *dst))
    assert got.shape == (3, *dst)
    for rows in (slice(0, 2), slice(-2, None)):  # the edge rows first
        _close(got[:, rows], want[:, rows], 1e-5, atol=1e-6, what="edge")
        _close(got[:, :, rows], want[:, :, rows], 1e-5, atol=1e-6,
               what="edge columns")
    _close(got, want, 1e-5, atol=1e-6, what="upscale")


def test_upscale_bilinear_rejects_downscale():
    """``jax.image.resize`` widens its triangle when it shrinks an axis
    (antialiasing); only the upscale is ported, so a shrink raises."""
    with pytest.raises(ValueError, match="upscale only"):
        pipeline.upscale_bilinear(_pv(_hdr(8, 11, 4)), 4, 11)
