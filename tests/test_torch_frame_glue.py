"""The frame's glue as K12 and K13: the plain versions of
``upscale_bilinear`` (K12, ``csrc/upscale.cu``), the ray count (K13, in
``shade_scatter``'s kernel, ``csrc/shade.cu``), ``sample_sums`` and
``progressive_average`` (K13, ``csrc/frame.cu``), and their dispatching
entry points on the CPU.

On the card each entry point launches its hand-written kernel, which
``chip_smoke.py`` (phase 22) holds bit for bit to the plain version there;
here, on the CPU, the entry point returns the plain version, which is held
to the composition it replaced (a copy of that code, kept in this file) bit
for bit, and to the JAX reference where it has a counterpart:

* the upscale's cached tap tables give the former ``_resize_axis``'s
  result bit for bit, their int32 copy (what K12 reads) is the int64
  index, and the upscale is held to the reference's
  ``upscale_bilinear`` (``jax.image.resize``, eager) at the games' and the
  presets' ratios and at odd sizes, within rtol 1e-5 and atol 1e-6
  (tests/test_torch_post.py's tolerance for it);
* a 64x48 frame's ``rays_traced`` (one count a bounce, in
  ``shade_scatter``) is the int the former count (the live lanes before
  each K1, the NEE lanes after each ``shade_nee``) gives, and within 0.5%
  of the reference's float32 count (tests/test_torch_slice.py's bound), on
  the reference's own tables (136 triangles: the reference intersects by
  brute force; its frame compiles in ~10 s); so is ``trace_path``'s,
  unsplit, split and with env NEE (the HDRI scene of
  test_torch_env_frame.py, its reference frame another ~10 s);
* ``shade_scatter`` with the count's arguments leaves the state the plain
  stage leaves and adds what ``count_rays_plain`` adds after it, at bounce
  0 (with the base), a middle bounce and the last (no next walk), unsplit,
  split and with env NEE (two shadow rays a NEE lane); no lane dead on
  entry has ``do_nee``; the wrapper refuses a counter that is not a 0-d
  int64 on the state's device and ``casts`` outside 0-2;
* the sample sums (with NaN, inf and luminance above 100, split and not)
  and the progressive average (the same view-projection, another, keep 0,
  a restart) give the former composition's bits, and so do whole frames;
* each new entry point refuses a CUDA request on a machine without CUDA
  and, for CPU tensors, takes its plain version without building or
  loading the kernel library;
* every kernel argument structure (``kernels.Args``) refuses a field it
  does not have.

The file runs in ~40 s on one CPU core (~25 s of it the reference's two
frame programs).
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ptrt_tpu.core.vec import Vec3 as RefVec3
from ptrt_tpu.render import pipeline as ref_pipeline
from ptrt_tpu.scene.materials import Material as RefMaterial
from ptrt_tpu.scene.materials import Materials as RefMaterials
from ptrt_tpu.scene.pt_scene import Scene as RefScene

from ptrt_tpu_torch import kernels, tables
from ptrt_tpu_torch.app.bench_scene import build_bench_scene
from ptrt_tpu_torch.core import rng as prng
from ptrt_tpu_torch.core.vec import Vec3, clamp_vector_soft, where
from ptrt_tpu_torch.render import (bloom, denoiser, integrator, motion,
                                   pipeline, rt_shading, shade, traverse)
from ptrt_tpu_torch.render.shade import (NeeRecord, PathState,
                                         count_rays_plain, shade_nee,
                                         shade_scatter)
from ptrt_tpu_torch.scene import pt_scene
from ptrt_tpu_torch.scene.materials import MaterialTable
from test_torch_env_frame import _ref_trace, build, ref_scene
from test_torch_shading import torch_one_thread  # noqa: F401
from test_torch_slice import ref_np

CPU = torch.device("cpu")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def same_bits(a, b) -> bool:
    """Equal tensors, Vec3s or tuples of them, floats by their bits."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(a, Vec3):
        return all(same_bits(x, y) for x, y in zip((a.x, a.y, a.z),
                                                   (b.x, b.y, b.z)))
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_bits(x, y)
                                        for x, y in zip(a, b))
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(_bits(a), _bits(b)))


def _planes(shape, seed, scale=1.0):
    r = np.random.default_rng(seed)
    return Vec3(*[torch.from_numpy((r.lognormal(-1.0, 1.5, shape)
                                    * scale).astype(np.float32))
                  for _ in range(3)])


# -- K12: the upscale -------------------------------------------------------------


def _former_resize_axis(a, dim, out_n):
    """``_resize_axis`` as it was before its taps were cached (tables made
    on every call, inline)."""
    in_n = a.shape[dim]
    inv_scale = float(np.float32(1.0 / (out_n / in_n)))
    f = (torch.arange(out_n, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    i0 = torch.floor(f)
    taps = []
    for i in (i0, i0 + 1.0):
        wgt = torch.clamp(1.0 - torch.abs(f - i), min=0.0)
        inside = (i >= 0) & (i <= in_n - 1)
        taps.append((i.clamp(0, in_n - 1).long(),
                     torch.where(inside, wgt, 0.0)))
    total = taps[0][1] + taps[1][1]
    norm = torch.where(total != 0, total, 1.0)
    shape = [1] * a.dim()
    shape[dim] = out_n
    out = None
    for idx, wgt in taps:
        wn = torch.where(torch.abs(total) > 1000.0 * 1.1920929e-07,
                         wgt / norm, 0.0).view(shape)
        term = a.index_select(dim, idx) * wn
        out = term if out is None else out + term
    return out


# (in_h, in_w) -> (out_h, out_w): the "fast" ratio (672x378 -> 1920x1080)
# and the "performance" one (1440x810 -> 1920x1080) cut to a tenth, the
# fused games' ratio (224x125 -> 640x360) cut to an eighth and its 112x62
# -> 320x180, odd sizes, an axis left as it is, a 1x1 and a 2x3 source
UPSCALES = [((38, 67), (108, 192)), ((81, 144), (108, 192)),
            ((16, 28), (45, 80)), ((62, 112), (180, 320)),
            ((7, 5), (7, 13)), ((23, 37), (61, 99)), ((1, 1), (4, 6)),
            ((2, 3), (9, 7))]
# and at the games' full 224x125 -> 640x360.  There the reference, run by
# XLA on the CPU, is off its own taps by up to 5.3e-5 relative on 0.06% of
# pixels (its 224-wide contraction), where this plain version stays within
# 2.0e-7 of them in float64: it is held to the reference at the reduced
# sizes only
FORMER_UPSCALES = UPSCALES + [((125, 224), (360, 640))]
_ids = lambda sizes: [f"{a[1]}x{a[0]}-{b[1]}x{b[0]}" for a, b in sizes]


@pytest.mark.parametrize("src,dst", FORMER_UPSCALES,
                         ids=_ids(FORMER_UPSCALES))
def test_taps_give_the_former_resize(src, dst):
    img = _planes(src, seed=src[0] * 7 + src[1])
    got = pipeline.upscale_bilinear(img, *dst)
    want = img.map(lambda c: _former_resize_axis(
        _former_resize_axis(c, 0, dst[0]), 1, dst[1]))
    assert got.x.shape == dst and same_bits(got, want)


# the shapes K12 takes on the main path (the games' 224x125 -> 640x360 and
# 112x62 -> 320x180, the scenes' 672x378 and 1440x810 -> 1920x1080) and a
# 1x1 and a 2x3 source
INDEX32_UPSCALES = [((125, 224), (360, 640)), ((62, 112), (180, 320)),
                    ((378, 672), (1080, 1920)), ((810, 1440), (1080, 1920)),
                    ((1, 1), (360, 640)), ((2, 3), (360, 640))]


@pytest.mark.parametrize("src,dst", INDEX32_UPSCALES,
                         ids=_ids(INDEX32_UPSCALES))
def test_int32_taps_are_the_index(src, dst):
    for n, m in zip(src, dst):
        taps = pipeline.resize_taps(n, m, CPU)
        assert taps.index32.dtype == torch.int32
        assert taps.index32.shape == taps.index.shape == (2, m)
        assert torch.equal(taps.index32.long(), taps.index)


def test_taps_are_made_once_a_size_and_device():
    a = pipeline.resize_taps(62, 180, CPU)
    assert pipeline.resize_taps(62, 180, "cpu") is a
    assert pipeline.resize_taps(62, 181, CPU) is not a
    assert a.index.shape == (2, 180) and a.index.dtype == torch.int64
    assert a.weight.shape == (2, 180) and a.weight.dtype == torch.float32
    # every output sample's weights sum to 1 within a rounding, its taps
    # inside the input
    assert torch.allclose(a.weight.sum(0), torch.ones(180), atol=1e-6)
    assert int(a.index.min()) >= 0 and int(a.index.max()) <= 61
    with pytest.raises(ValueError, match="upscale only"):
        pipeline.resize_taps(10, 9, CPU)


@pytest.mark.parametrize("src,dst", UPSCALES, ids=_ids(UPSCALES))
def test_upscale_matches_reference(src, dst):
    img = _planes(src, seed=src[0] + 3 * src[1])
    got = pipeline.upscale_bilinear(img, *dst)
    ref = ref_pipeline.upscale_bilinear(
        RefVec3(*[jnp.asarray(c.numpy()) for c in (img.x, img.y, img.z)]),
        *dst)
    for g, r in zip((got.x, got.y, got.z), (ref.x, ref.y, ref.z)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-6)


# -- K13: the ray counts -------------------------------------------------------------

W, H, SPP, DEPTH = 64, 48, 2, 3


@pytest.fixture(scope="module")
def frame():
    """The reference's 64x48 frame (the gradient sky, a directional and an
    area light, 2 spp, depth 3) and the port's on its tables."""
    sc = build(RefScene(W, H), RefMaterial, RefMaterials, lights=True,
               env=None)
    sc._ensure_device_state()
    assert sc._use_brute()
    n = len(sc.lights)
    ref_state, ref = jax.jit(
        lambda g, m, l, s, c, st, bn: ref_pipeline.trace_frame(
            g, m, l, n, s, c, st, jnp.int32(0), W, H, SPP, DEPTH,
            split=False, use_brute=True, blue_noise_tbl=bn))(
        sc._geom, sc._mat_table, sc._light_table, sc._sky(), sc.camera,
        sc._rng_state, sc._blue_noise)
    port = tables.from_reference(
        device=CPU, geometry=ref_np(sc._geom),
        materials=ref_np(sc._mat_table), lights=ref_np(sc._light_table),
        sky=ref_np(sc._sky()), camera=ref_np(sc.camera),
        rng_state=np.asarray(sc._rng_state),
        blue_noise=np.asarray(sc._blue_noise))
    state, bufs = pipeline.trace_frame(
        port["geometry"], port["materials"], port["lights"], n,
        port["sky"], port["camera"], port["rng_state"], 0, W, H, SPP, DEPTH,
        port["blue_noise"])
    return {"port": port, "n_lights": n, "ref": ref,
            "ref_state": np.asarray(ref_state), "state": state, "bufs": bufs}


@pytest.fixture(scope="module")
def env_frame():
    """The reference's 64x48 HDRI frame of test_torch_env_frame.py (env NEE
    and two lights, 2 spp, depth 3) and the port's tables of it."""
    sc = ref_scene()
    _, ref = _ref_trace(sc, False)
    port = tables.from_reference(
        device=CPU, geometry=ref_np(sc._geom),
        materials=ref_np(sc._mat_table), lights=ref_np(sc._light_table),
        sky=ref_np(sc._sky()), camera=ref_np(sc.camera),
        rng_state=np.asarray(sc._rng_state),
        blue_noise=np.asarray(sc._blue_noise))
    return {"port": port, "n_lights": len(sc.lights), "ref": ref}


def _walks(port, nee, n_lights):
    """K2's answers for a NEE record: the light's shadow rays, the env's."""
    g = port["geometry"]
    in_shadow = (traverse.any_hit(g, nee.shadow_o, nee.shadow_d,
                                  nee.shadow_t) if n_lights else None)
    env = (traverse.any_hit(g, nee.env_o, nee.env_d, nee.env_t)
           if nee.env_t is not None else None)
    return in_shadow, env


def _sample(port, s, split):
    sub, ray = pipeline.camera_rays(port["camera"], port["rng_state"], 0, s,
                                    port["blue_noise"])
    return PathState.start(ray, sub, split,
                           env_nee=port["sky"].has_env_sampling)


def _former_count(port, n_lights, split=False):
    """The frame's rays as the bounce loop counted them before: each
    bounce's live lanes before K1 and its NEE lanes after ``shade_nee`` (a
    shadow ray each for the light and, with env NEE, the env sample)."""
    rays = 0
    sky = port["sky"]
    casts = int(sky.has_env_sampling) + int(n_lights > 0)
    for s in range(SPP):
        ps = _sample(port, s, split)
        for bounce in range(DEPTH):
            rays += int(ps.alive.sum())
            k1 = traverse.closest_hit_live(port["geometry"], ps.o, ps.d,
                                           ps.alive)
            nee = shade_nee(ps, port["geometry"], k1, port["materials"],
                            port["lights"], n_lights, sky, bounce)
            rays += casts * int(nee.do_nee.sum())
            in_shadow, env = _walks(port, nee, n_lights)
            shade_scatter(ps, nee, in_shadow, port["materials"], bounce,
                          env_shadow=env)
    return rays


def test_rays_traced_as_before_and_as_the_reference(frame):
    got = frame["bufs"].rays_traced
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == _former_count(frame["port"], frame["n_lights"])
    r = float(frame["ref"].rays_traced)
    assert abs(int(got) - r) <= 0.005 * r, (int(got), r)
    # the frame's state advanced as the reference's
    assert np.array_equal(frame["ref_state"],
                          frame["state"].numpy().astype(np.uint32))


@pytest.mark.parametrize("config", ["unsplit", "split", "env NEE"])
def test_trace_path_rays_as_before_and_as_the_reference(config, frame,
                                                        env_frame):
    """``trace_path``'s count, summed over the frame's samples: the former
    count's int and the reference frame's count within 0.5% (a split trace
    takes the unsplit one's paths)."""
    src = env_frame if config == "env NEE" else frame
    port, n_lights = src["port"], src["n_lights"]
    split = config == "split"
    rays = 0
    for s in range(SPP):
        sub, ray = pipeline.camera_rays(port["camera"], port["rng_state"], 0,
                                        s, port["blue_noise"])
        _, out = integrator.trace_path(
            port["geometry"], port["materials"], port["lights"], n_lights,
            port["sky"], ray, sub, DEPTH, split=split, own_ray=True)
        assert out.rays_traced.dtype == torch.int64
        rays += int(out.rays_traced)
    assert rays == _former_count(port, n_lights, split)
    r = float(src["ref"].rays_traced)
    assert abs(rays - r) <= 0.005 * r, (rays, r)


def _same_state(a: PathState, b: PathState) -> bool:
    return all(same_bits(getattr(a, f.name), getattr(b, f.name))
               for f in dataclasses.fields(PathState))


# (configuration, the bounce at which the count is held): a middle bounce
# unsplit, split and with env NEE (two shadow rays a NEE lane), bounce 0
# (its base: the camera walk took every lane) and the last bounce (no next
# walk to count)
COUNT_CASES = {"unsplit": ("unsplit", 1), "split": ("split", 1),
               "env NEE": ("env NEE", 1), "bounce 0": ("unsplit", 0),
               "last bounce": ("env NEE", DEPTH - 1)}


@pytest.mark.parametrize("case", list(COUNT_CASES))
def test_shade_scatter_counts_as_the_plain_count_after_the_plain_stage(
        case, frame, env_frame):
    config, stop = COUNT_CASES[case]
    src = env_frame if config == "env NEE" else frame
    port, n_lights = src["port"], src["n_lights"]
    g, mats, sky = port["geometry"], port["materials"], port["sky"]
    casts = int(sky.has_env_sampling) + int(n_lights > 0)
    assert casts == (2 if config == "env NEE" else 1)
    ps = _sample(port, 1, config == "split")
    for bounce in range(stop + 1):
        k1 = traverse.closest_hit_live(g, ps.o, ps.d, ps.alive)
        nee = shade_nee(ps, g, k1, mats, port["lights"], n_lights, sky,
                        bounce)
        in_shadow, env = _walks(port, nee, n_lights)
        if bounce < stop:
            shade_scatter(ps, nee, in_shadow, mats, bounce, env_shadow=env)
    # the record's contract: no lane dead on entry casts a shadow ray
    assert not bool((nee.do_nee & ~ps.alive).any())
    assert int(nee.do_nee.sum()) > 0
    count = dict(casts=casts, next_bounce=stop + 1 < DEPTH,
                 base=ps.alive.numel() if stop == 0 else 0)
    got, want = ps.clone(), ps.clone()
    got_rays = torch.tensor(11, dtype=torch.int64)
    want_rays = got_rays.clone()
    shade_scatter(got, nee, in_shadow, mats, stop, env_shadow=env,
                  rays=got_rays, **count)
    shade.shade_scatter_plain(want, nee, in_shadow, mats, stop, True, 2,
                              env)
    count_rays_plain(want_rays, want.alive if count["next_bounce"] else None,
                     nee.do_nee, casts, count["base"])
    assert _same_state(got, want)
    assert got_rays.dtype == torch.int64 and got_rays.dim() == 0
    assert int(got_rays) == int(want_rays)
    # what it counted: the base, the NEE lanes' shadow rays and the lanes
    # left for the next walk
    assert int(got_rays) == 11 + count["base"] + casts * int(
        nee.do_nee.sum()) + (int(want.alive.sum()) if count["next_bounce"]
                             else 0)


def _count_call(dev, **count):
    """``shade_scatter`` on 12 lanes of ``dev`` with the count's
    arguments (a NEE record without lights or env)."""
    f32 = dict(dtype=torch.float32, device=dev)
    v = lambda: Vec3(*[torch.ones(12, **f32) for _ in range(3)])
    flag = lambda val: torch.full((12,), val, dtype=torch.bool, device=dev)
    ray = pipeline.RayBatch(v(), v(), flag(False))
    ps = PathState.start(ray, torch.zeros(12, dtype=torch.int64,
                                          device=dev), False)
    hit = traverse.Hit(hit=flag(True), t=torch.ones(12, **f32), point=v(),
                       normal=v(), front_face=flag(True),
                       mesh_index=torch.zeros(12, dtype=torch.int32,
                                              device=dev),
                       u=torch.zeros(12, **f32), v=torch.zeros(12, **f32))
    nee = NeeRecord(hit, flag(True), *[None] * 6)
    shade_scatter(ps, nee, None, MaterialTable(torch.zeros((1, 32), **f32)),
                  0, **count)


@pytest.mark.parametrize("count,error", [
    (dict(rays=torch.zeros(1, dtype=torch.int64)), "0-D"),
    (dict(rays=torch.zeros((), dtype=torch.int32)), "int64"),
    (dict(rays=torch.zeros((), dtype=torch.int64, device="meta")),
     "expected cpu"),
    (dict(rays=torch.zeros((), dtype=torch.int64), casts=3), "0-2"),
    (dict(rays=torch.zeros((), dtype=torch.int64), casts=-1), "0-2"),
    (dict(casts=1, base=12), "come with rays")],
    ids=["1-d", "int32", "another device", "casts 3", "casts -1",
         "no counter"])
def test_the_count_refuses(count, error):
    with pytest.raises((TypeError, ValueError), match=error):
        _count_call(CPU, **count)


@pytest.mark.parametrize("casts", [0, 1, 2])
def test_count_rays_plain(casts):
    r = np.random.default_rng(casts)
    alive = torch.from_numpy(r.random(1001) < 0.3)
    do_nee = torch.from_numpy(r.random(1001) < 0.6)
    rays = torch.tensor(7, dtype=torch.int64)
    count_rays_plain(rays, alive, do_nee, casts, base=5)
    assert int(rays) == (7 + 5 + int(torch.count_nonzero(alive))
                         + casts * int(torch.count_nonzero(do_nee)))
    count_rays_plain(rays, None, None, 2, base=0)
    count_rays_plain(rays, torch.zeros(9, dtype=torch.bool))
    assert int(rays) == (12 + int(torch.count_nonzero(alive))
                         + casts * int(torch.count_nonzero(do_nee)))


# -- K13: the sample sums ------------------------------------------------------------


def _path_state(n, seed, split):
    """A PathState of n lanes whose radiance holds NaN, +inf, -inf and
    luminances above 100 at seeded lanes (the other planes as the start
    leaves them)."""
    r = np.random.default_rng(seed)
    ray = pipeline.RayBatch(Vec3.zeros((n,), CPU), Vec3.zeros((n,), CPU),
                            torch.zeros(n, dtype=torch.bool))
    ps = PathState.start(ray, torch.zeros(n, dtype=torch.int64), split)
    ps.accum = _planes((n,), seed, scale=40.0)
    for c, val in ((ps.accum.x, float("nan")), (ps.accum.y, float("inf")),
                   (ps.accum.z, -float("inf")), (ps.accum.x, 400.0)):
        c[torch.from_numpy(r.choice(n, max(1, n // 50), replace=False))] = val
    if split:
        ps.diffuse = _planes((n,), seed + 1)
        ps.specular = _planes((n,), seed + 2)
        ps.emission = _planes((n,), seed + 3)
        ps.diffuse.y[3] = float("nan")
    return ps


def _former_sums(samples, rng_state, height, width):
    """The frame's sums as ``trace_frame`` composed them before: each
    sample's clamped radiance and channels added in sample order, then
    ``* (1 / spp)``, and the state's PCG advance."""
    sums = None
    for ps in samples:
        rs = lambda v: (None if v is None else v.map(
            lambda c: c.reshape(height, width)))
        parts = (rs(clamp_vector_soft(ps.accum, 100.0)), rs(ps.diffuse),
                 rs(ps.specular), rs(ps.emission))
        sums = parts if sums is None else tuple(
            a if b is None else a + b for a, b in zip(sums, parts))
    state, _ = prng.uniform(rng_state)
    inv = 1.0 / float(len(samples))
    return tuple(None if a is None else a * inv for a in sums), state


@pytest.mark.parametrize("split", [False, True], ids=["unsplit", "split"])
@pytest.mark.parametrize("spp", [1, 3, 16])
def test_sample_sums_give_the_former_bits(spp, split):
    height, width = 9, 13
    samples = [_path_state(height * width, 100 * spp + s, split)
               for s in range(spp)]
    rng_state = torch.from_numpy(np.random.default_rng(spp).integers(
        0, 2 ** 32, (height, width)).astype(np.int64))
    sums = state = None
    for s, ps in enumerate(samples):
        sums, state = pipeline.sample_sums(sums, ps, s, spp, rng_state)
        assert (state is None) == (s < spp - 1)
    want, want_state = _former_sums(samples, rng_state, height, width)
    assert same_bits(sums, want) and torch.equal(state, want_state)
    assert (sums[1] is None) == (not split)


def test_frames_give_the_former_composition():
    """Whole 32x24 frames (2 spp, and split) against ``trace_frame`` as it
    was composed before: ``trace_path`` a sample, its rays summed."""
    sc = build_bench_scene(32, 24, target_tris=400, device="cpu")
    sc._ensure_device_state()
    args = (sc._geom, sc._mat_table, sc._light_table, len(sc.lights),
            sc.sky(), sc.camera, sc._rng_state, 3, 32, 24, 2, 3,
            sc._blue_noise)
    for split in (False, True):
        state, got = pipeline.trace_frame(*args, split=split)
        outs = []
        for s in range(2):
            sub, ray = pipeline.camera_rays(sc.camera, sc._rng_state, 3, s,
                                            sc._blue_noise)
            outs.append(integrator.trace_path(
                *args[:5], ray, sub, 3, split=split, own_ray=True)[1])
        sums = None
        for o in outs:
            parts = (o.radiance, o.diffuse, o.specular, o.emission)
            sums = parts if sums is None else tuple(
                a if b is None else a + b for a, b in zip(sums, parts))
        want_state, _ = prng.uniform(sc._rng_state)
        want = tuple(None if a is None else a * 0.5 for a in sums)
        assert torch.equal(state, want_state)
        assert same_bits((got.color, got.diffuse, got.specular,
                          got.emission), want)
        assert int(got.rays_traced) == sum(int(o.rays_traced) for o in outs)
        first = outs[0]
        assert same_bits((got.normal, got.depth, got.object_id,
                          got.roughness, got.transmission),
                         (first.first_normal, first.first_depth,
                          first.first_object_id, first.first_roughness,
                          first.first_transmission))


# -- K13: the progressive average -------------------------------------------------------


def _former_accumulate(color, view_proj, accum, keep=None):
    """``accumulate`` as it was (the plain version's former body)."""
    if accum is None:
        return color * torch.ones(()).reciprocal(), (color, torch.ones(()),
                                                     view_proj)
    total, count, vp = accum
    same = (view_proj == vp).all()
    if keep is not None:
        same = same & (keep != 0)
    total = where(same, total + color, color)
    count = torch.where(same, count + 1.0, 1.0)
    return total * count.reciprocal(), (total, count, view_proj)


@pytest.mark.parametrize("case", ["restart", "same", "moved", "keep 0",
                                  "keep 1", "nan view"])
def test_progressive_average_gives_the_former_bits(case):
    shape = (11, 17)
    color = _planes(shape, seed=1)
    color.y[2, 3] = float("nan")
    total = _planes(shape, seed=2, scale=5.0)
    vp = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 4)).astype(np.float32))
    view = vp.clone()
    if case == "moved":
        view[2, 1] += 1e-3
    if case == "nan view":
        view[0, 0] = float("nan")
    accum = None if case == "restart" else (total, torch.tensor(
        6.0), vp)
    keep = {"keep 0": torch.tensor(0, dtype=torch.int32),
            "keep 1": torch.tensor(1, dtype=torch.int32)}.get(case)
    got = pt_scene.accumulate(color, view, accum, keep)
    want = _former_accumulate(color, view, accum, keep)
    assert same_bits(got[0], want[0]) and same_bits(got[1][:2], want[1][:2])
    assert got[1][2] is view
    restarted = case in ("restart", "moved", "keep 0", "nan view")
    assert float(got[1][1]) == (1.0 if restarted else 7.0)


# -- dispatch -----------------------------------------------------------------


@pytest.fixture
def no_kernels(monkeypatch):
    """Fail if anything builds or loads the kernel library; reset counts."""
    def refuse():
        raise AssertionError("a CPU tensor reached the CUDA kernel path")

    monkeypatch.setattr(kernels, "get_lib", refuse)
    kernels.launches.clear()
    yield
    assert sum(kernels.launches.values()) == 0


def _calls(dev):
    """A call of each new entry point on tensors of ``dev``."""
    f32 = dict(dtype=torch.float32, device=dev)
    v = lambda shape: Vec3(*[torch.ones(shape, **f32) for _ in range(3)])
    ray = pipeline.RayBatch(v((12,)), v((12,)),
                            torch.zeros(12, dtype=torch.bool, device=dev))
    rng = torch.zeros((3, 4), dtype=torch.int64, device=dev)
    vp = torch.eye(4, **f32)
    return {
        "upscale_bilinear": lambda: pipeline.upscale_bilinear(v((3, 4)), 6,
                                                              8),
        # the ray count: shade_scatter's counting call
        "count_rays": lambda: _count_call(
            dev, rays=torch.zeros((), dtype=torch.int64, device=dev),
            casts=1, next_bounce=True, base=12),
        "sample_sums": lambda: pipeline.sample_sums(
            None, PathState.start(ray, rng.reshape(-1), False), 0, 1, rng),
        "progressive_average": lambda: pt_scene.accumulate(
            v((3, 4)), vp, (v((3, 4)), torch.ones((), **f32), vp),
            torch.zeros((), dtype=torch.int32, device=dev)),
    }


@pytest.mark.parametrize("kernel", ["upscale_bilinear", "count_rays",
                                    "sample_sums", "progressive_average"])
def test_cpu_tensors_take_the_plain_versions(kernel, no_kernels):
    _calls(CPU)[kernel]()


@pytest.mark.parametrize("kernel", ["upscale_bilinear", "count_rays",
                                    "sample_sums", "progressive_average"])
def test_a_cuda_request_without_cuda_is_refused(kernel, no_kernels,
                                                monkeypatch):
    """Tensors that claim the card (torch's fake tensors, which need none)
    on a machine where torch sees no CUDA device: the entry point raises
    before it computes anything, and no plain version serves them."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with FakeTensorMode(allow_non_fake_inputs=True):
        call = _calls(torch.device("cuda", 0))[kernel]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# -- the kernels' argument structures ----------------------------------------------

ARGS = [(mod, name) for mod in (bloom, denoiser, motion, pipeline,
                                rt_shading, shade, pt_scene)
        for name, cls in sorted(vars(mod).items())
        if isinstance(cls, type) and issubclass(cls, ctypes.Structure)
        and cls.__module__ == mod.__name__]


def test_every_argument_structure_checks_its_fields():
    assert len(ARGS) == 16
    for mod, name in ARGS:
        assert issubclass(getattr(mod, name), kernels.Args), name


@pytest.mark.parametrize("mod,name", ARGS,
                         ids=[name for _, name in ARGS])
def test_an_argument_structure_refuses_a_misspelt_field(mod, name):
    cls = getattr(mod, name)
    a = cls()
    field, kind = cls._fields_[0][:2]
    value = 3 if issubclass(kind, (ctypes.c_int, ctypes.c_longlong,
                                   ctypes.c_void_p)) else None
    if value is not None:
        setattr(a, field, value)  # its own fields it takes
        assert getattr(a, field) == value
    with pytest.raises(AttributeError, match="no field"):
        setattr(a, f"{field}_", 1)
    assert not hasattr(a, f"{field}_")
