"""The split-channel trace and the whole balanced frame against the
reference.

Shading: ``evaluate_bsdf_split`` and ``sample_direct_lighting(split=True)``
on the fixed random lanes of ``test_torch_shading.py``, at its bounds (and
for the same reasons): rtol 1e-5 on 99.5% of lanes and 1e-3 on all.

Trace: ``trace_frame(split=True)`` on the reference's own tables, against
the reference's jitted split trace, with the balanced preset's settings
(1 spp, depth 4, Russian roulette from bounce 1) on the bench scene at
64x48 with ~2000 triangles.  As in ``test_torch_slice.py``: the object id
exact, depth and normal to rtol 1e-5; radiance and the diffuse, specular
and emission channels statistically (a float-level difference can flip a
lane's roulette or lobe choice, after which that path diverges): each
channel's energy within 1%, at least 97% of pixels within 1e-3 relative,
rays traced within 0.5%.

The whole slice: the port's ``Scene`` under the "balanced" preset renders
three frames, the camera orbiting 2 degrees before each; the reference
runs the same frames as its frame program does — its jitted split trace,
then motion vectors, SVGF, bloom and the tonemap, called eagerly, with its
previous view-projection and denoiser state carried from frame to frame.
Bounds: the uint8 image within 1 LSB on at least 99% of pixels in every
frame, and the final SVGF history lengths within rtol 1e-5 on at least
99% (a diverged path changes its pixel's radiance, and the à-trous passes
spread that over the neighbourhood; a length fetched bilinearly from a
reprojected position is not an integer, and motion vectors that differ in
the last bits move it by ulps).  This file runs in
~45 s on one CPU core (the reference's split trace compiles once, ~30 s).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ptrt_tpu.app.bench_scene import build_bench_scene as ref_bench_scene
from ptrt_tpu.render import bloom as ref_bloom
from ptrt_tpu.render import bsdf as ref_bsdf
from ptrt_tpu.render import denoiser as ref_den
from ptrt_tpu.render import motion as ref_motion
from ptrt_tpu.render import nee as ref_nee
from ptrt_tpu.render import pipeline as ref_pipeline

from ptrt_tpu_torch import tables
from ptrt_tpu_torch.app.bench_scene import build_bench_scene
from ptrt_tpu_torch.render import bsdf, nee, pipeline
from test_torch_shading import (DIRECTION, N, _close, _pv, _rv,  # noqa: F401
                                inputs, torch_one_thread)
from test_torch_slice import ref_np

W, H, DEPTH, TRIS = 64, 48, 4, 2000
CPU = torch.device("cpu")


# -- shading ------------------------------------------------------------------


def test_evaluate_bsdf_split(inputs):
    x = inputs
    rd, rs = ref_bsdf.evaluate_bsdf_split(
        _rv(x["n"]), jnp.asarray(x["front"]), x["ref_mat"], _rv(x["l"]),
        _rv(-x["d"]))
    gd, gs = bsdf.evaluate_bsdf_split(_pv(x["n"]),
                                      torch.from_numpy(x["front"]), x["mat"],
                                      _pv(x["l"]), _pv(-x["d"]))
    _close(gd, rd, "diffuse")
    _close(gs, rs, "specular")
    # transmissive lanes route everything to specular
    trans = ((x["mat"].transmission > 0) & (x["mat"].metallic < 0.1)).numpy()
    assert trans.any() and (gd.x.numpy()[trans] == 0).all()


def test_sample_direct_lighting_split(inputs):
    x = inputs
    shadow = np.arange(N) % 3 == 0
    active = np.arange(N) % 5 != 0
    rs, rl, rpdf, (rd, rsp) = ref_nee.sample_direct_lighting(
        jnp.asarray(x["state"]), _rv(x["point"]), _rv(x["n"]),
        jnp.asarray(x["front"]), x["ref_mat"], _rv(x["d"]), x["ref_lights"],
        x["n_lights"], lambda o, d, t, li=None: jnp.asarray(shadow),
        split=True, active=jnp.asarray(active))
    ps, pl_, ppdf, (pd, psp) = nee.sample_direct_lighting(
        torch.from_numpy(x["state"].astype(np.int64)), _pv(x["point"]),
        _pv(x["n"]), torch.from_numpy(x["front"]), x["mat"], _pv(x["d"]),
        x["lights"], x["n_lights"], lambda o, d, t: torch.from_numpy(shadow),
        split=True, active=torch.from_numpy(active))
    assert np.array_equal(np.asarray(rs), ps.numpy().astype(np.uint32))
    _close(pl_, rl, "L", DIRECTION)
    _close(ppdf, rpdf, "pdf")
    _close(pd, rd, "diffuse contribution")
    _close(psp, rsp, "specular contribution")
    assert (pd.x.numpy() != 0).any() and (psp.x.numpy() != 0).any()


# -- the split trace ----------------------------------------------------------


def _balanced(sc):
    sc.set_performance_preset("balanced")
    sc.perf.samples_per_pixel = 1
    return sc


def _orbit_kw(k: int) -> dict:
    """The bench camera orbited by 2k degrees about its look-at point."""
    a = math.radians(2.0 * k)
    return dict(lookfrom=(7.5 * math.sin(a), 1.2, 6.0 - 7.5 * math.cos(a)),
                lookat=(0.0, 0.0, 6.0), fov=60)


@pytest.fixture(scope="module")
def ref_scene():
    sc = _balanced(ref_bench_scene(W, H, target_tris=TRIS))
    sc._ensure_device_state()
    assert not sc._use_brute()
    return sc


@pytest.fixture(scope="module")
def ref_trace(ref_scene):
    """The reference's jitted split trace under the balanced settings."""
    sc, p = ref_scene, ref_scene.perf
    return jax.jit(lambda g, m, l, s, c, st, fi, bn: ref_pipeline.trace_frame(
        g, m, l, len(sc.lights), s, c, st, fi, W, H, 1, DEPTH, split=True,
        use_brute=False, blue_noise_tbl=bn, rr_enabled=True,
        rr_start=p.russian_roulette_start_bounce))


def _v(v):
    return np.stack([np.asarray(c) for c in (v.x, v.y, v.z)])


def test_trace_frame_split(ref_scene, ref_trace):
    sc = ref_scene
    ref_state, ref_bufs = ref_trace(sc._geom, sc._mat_table, sc._light_table,
                                    sc._sky(), sc.camera, sc._rng_state,
                                    jnp.int32(0), sc._blue_noise)
    port = tables.from_reference(
        device=CPU, geometry=ref_np(sc._geom),
        materials=ref_np(sc._mat_table), lights=ref_np(sc._light_table),
        sky=ref_np(sc._sky()), camera=ref_np(sc.camera),
        rng_state=np.asarray(sc._rng_state),
        blue_noise=np.asarray(sc._blue_noise))
    state, bufs = pipeline.trace_frame(
        port["geometry"], port["materials"], port["lights"], len(sc.lights),
        port["sky"], port["camera"], port["rng_state"], 0, W, H, 1, DEPTH,
        port["blue_noise"], split=True,
        rr_start=sc.perf.russian_roulette_start_bounce)
    assert np.array_equal(np.asarray(ref_state), state.numpy().astype(
        np.uint32))
    assert np.array_equal(bufs.object_id.numpy(),
                          np.asarray(ref_bufs.object_id))
    hit = np.asarray(ref_bufs.object_id) >= 0
    np.testing.assert_allclose(bufs.depth.numpy(), np.asarray(ref_bufs.depth),
                               rtol=1e-5)
    np.testing.assert_allclose(_v(bufs.normal)[:, hit],
                               _v(ref_bufs.normal)[:, hit], rtol=1e-5,
                               atol=1e-6)
    r, g = float(ref_bufs.rays_traced), int(bufs.rays_traced)
    assert abs(g - r) <= 0.005 * r, (g, r)
    for name in ("color", "diffuse", "specular", "emission"):
        rc, gc = _v(getattr(ref_bufs, name)), _v(getattr(bufs, name))
        assert np.isfinite(gc).all()
        assert rc.sum() > 0, name  # every channel carries light here
        np.testing.assert_allclose(gc.sum(axis=(1, 2)), rc.sum(axis=(1, 2)),
                                   rtol=0.01, err_msg=name)
        close = np.isclose(gc, rc, rtol=1e-3, atol=1e-6).all(axis=0)
        assert close.mean() >= 0.97, (name, close.mean())


# -- the whole balanced frame -------------------------------------------------


def _ref_frames(sc, trace, n):
    """``n`` frames of the reference's balanced frame program, eagerly after
    the jitted trace, with the camera orbiting.  Returns the uint8 images
    and the final denoiser state."""
    rng, vp, cam0 = sc._rng_state, sc.prev_view_proj, sc.camera
    den_state = ref_den.init_denoiser_state(H, W)
    imgs = []
    for k in range(n):
        sc.set_camera(**_orbit_kw(k))
        rng, bufs = trace(sc._geom, sc._mat_table, sc._light_table,
                          sc._sky(), sc.camera, rng, jnp.int32(sc.frame_count),
                          sc._blue_noise)
        mv = ref_motion.motion_vectors(bufs.depth, sc.camera, vp, W, H)
        color, den_state = ref_den.denoise_frame(bufs, mv, den_state,
                                                 sc.camera, sc.frame_count)
        color = ref_bloom.apply_bloom(color)
        imgs.append(np.asarray(ref_pipeline.tonemap_to_rgb8(color)))
        sc.frame_count += 1
        vp = sc.camera.get_view_proj()
    sc.camera = cam0
    return imgs, den_state


def test_balanced_scene_three_frames(ref_scene, ref_trace):
    ref_imgs, ref_state = _ref_frames(ref_scene, ref_trace, 3)
    sc = _balanced(build_bench_scene(W, H, target_tris=TRIS, device="cpu"))
    assert (sc.perf.enable_denoiser and sc.perf.enable_bloom
            and sc.perf.enable_motion_vectors)
    for k, want in enumerate(ref_imgs):
        sc.set_camera(**_orbit_kw(k))
        img = sc.render_frame()
        assert img.shape == (H, W, 3) and img.dtype == np.uint8
        diff = np.abs(img.astype(int) - want.astype(int)).max(-1)
        assert (diff <= 1).mean() >= 0.99, (k, (diff <= 1).mean())
        assert img.std() > 5.0
    assert sc._accum is None  # no progressive average under the denoiser
    st = sc._denoiser_state
    for ch in ("diffuse", "specular"):
        same = np.isclose(getattr(st, ch).length.numpy(),
                          np.asarray(getattr(ref_state, ch).length),
                          rtol=1e-5, atol=0.0)
        assert same.mean() >= 0.99, (ch, same.mean())
    surface = sc.last_frame.depth.numpy() < 1e9
    assert (st.diffuse.length.numpy()[surface] > 1).mean() > 0.3
