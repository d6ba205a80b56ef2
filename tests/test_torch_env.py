"""The HDRI sky and env NEE of ptrt_tpu_torch against the JAX reference.

* HDR files: the port's ``load_hdr`` of files the reference's ``save_hdr``
  writes (flat scanlines) and of new-style RLE files (encoded here) equals
  the reference's ``load_hdr`` bit for bit; PPM round trips.
* ``build_env_sampling``: bit for bit the reference's tables (alias rows,
  pdf, (SH, SW)) on a seeded 32x64 map with a sun, a 300x600 map (the
  downsample branch) and an all-zero map.
* ``sample_env``, ``env_pdf_dir`` and the HDRI ``sample_sky`` on 4,096
  seeded PCG states and directions at rotations 0, 0.7 and -3.0, the
  reference jitted on the CPU.
* The K3 plain stages with env NEE: one bounce at bounces 0-3, split and
  unsplit, with and without lights, on ``test_torch_shade.py``'s random
  lanes (every lobe and light type) lit by an HDRI, against the reference's
  integrator body with ``env_nee=True``, the same occlusion masks given to
  both; and the wrappers on the CPU.

Bounds.  PCG states, flags, alias picks and texel indices are exact (the
indices: at least 99.9% of directions, measured 100%).  XLA's sin, cos,
atan2 and acos on the CPU differ from torch's by an ulp or two, which moves
a sampled direction by up to ~5e-7 (held within 2e-6) and a pdf by up to
~2e-7 relative (held to rtol 1e-5; ``env_pdf_dir`` near the poles to
POLE_PDF).  Where a quantity passes through the
bilinear fetch next to the 1e4 sun, the map's gradient magnifies that ulp:
radiance at one and the same direction agrees to rtol 1e-5 on 99.7% of the
sampled directions (max 6e-5), so radiance, the env contributions and the
accumulators they reach are held to ENV_VALUE (rtol 1e-5 on 99%, 1e-3 on
all).  Random directions (few near the sun) are held to FETCH (measured: 1
of 4,096 at 1.66e-5, the rest within 1e-5).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from ptrt_tpu.core import rng as ref_rng
from ptrt_tpu.core.vec import Vec3 as RefVec3
from ptrt_tpu.core.vec import where as ref_where
from ptrt_tpu.render import bsdf as ref_bsdf
from ptrt_tpu.render import nee as ref_nee
from ptrt_tpu.render import sky as ref_sky
from ptrt_tpu.render.pbr import beer_lambert as ref_beer_lambert
from ptrt_tpu.core.vec import clamp_vector_soft as ref_clamp_soft
from ptrt_tpu.utils import hdr as ref_hdr

from ptrt_tpu_torch import tables
from ptrt_tpu_torch.app.hdri import synthetic_env
from ptrt_tpu_torch.core.vec import Vec3
from ptrt_tpu_torch.render import shade
from ptrt_tpu_torch.render import sky as port_sky
from ptrt_tpu_torch.render.nee import env_lighting_lit
from ptrt_tpu_torch.utils import hdr, imageio
from test_torch_kernels_cpu import no_kernels  # noqa: F401
from test_torch_shade import (N, SHADOW, _exact, _geom, _k1,  # noqa: F401
                              _port_state, _pv, _ref_hit, _rv, lanes)
from test_torch_shading import (AT_PEAK, DIRECTION, VALUE, _close,  # noqa: F401
                                torch_one_thread)
from test_torch_slice import ref_np

CPU = torch.device("cpu")
ENV_VALUE = ((1e-5, 0.99), (1e-3, 1.0))
# env_pdf_dir divides by sqrt(1 - y*y), which cancels near the poles: 3 of
# 4,096 directions with |y| > 0.9997 differ by 1.3e-5 to 1.7e-5 (XLA
# contracts the product and difference on the CPU, torch rounds both)
POLE_PDF = ((1e-5, 0.999), (1e-4, 1.0))
# the HDRI fetch along random directions: 1 of 4,096 (rotation 0.7) at
# 1.66e-5, the rest within 1e-5
FETCH = ((1e-5, 0.999), (1e-4, 1.0))
ENV_SHADOW = np.arange(N) % 4 == 1  # the env walk's occlusion, both sides
ROTATIONS = (0.0, 0.7, -3.0)


def _skies(env, rot):
    """(reference HDRI SkyConfig, the port's, carried across)."""
    rs = ref_sky.SkyConfig.hdri(env, rot)
    return rs, tables.from_reference(device=CPU, sky=ref_np(rs))["sky"]


@pytest.fixture(scope="module")
def env_map():
    return synthetic_env(32, 64, seed=1)


# -- HDR and PPM files -------------------------------------------------------


def _rle_hdr(path, img):
    """Write ``img`` as a new-style RLE Radiance file (runs of 3+ equal
    bytes as runs, the rest as literals), with the reference's RGBE
    quantisation."""
    ref_hdr.save_hdr(path, img)  # the flat file's RGBE bytes
    with open(path, "rb") as f:
        data = f.read()
    h, w = img.shape[:2]
    header_end = data.index(f"-Y {h} +X {w}\n".encode()) + len(
        f"-Y {h} +X {w}\n")
    rgbe = np.frombuffer(data[header_end:], np.uint8).reshape(h, w, 4)
    out = bytearray(data[:header_end])
    for y in range(h):
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            row = rgbe[y, :, c]
            x = 0
            while x < w:
                run = 1
                while x + run < w and run < 127 and row[x + run] == row[x]:
                    run += 1
                if run >= 3:
                    out += bytes([128 + run, row[x]])
                    x += run
                    continue
                start = x
                while x < w and x - start < 128 and not (
                        x + 2 < w and row[x] == row[x + 1] == row[x + 2]):
                    x += 1
                out += bytes([x - start]) + row[start:x].tobytes()
    with open(path, "wb") as f:
        f.write(bytes(out))


@pytest.mark.parametrize("rle", [False, True], ids=["flat", "rle"])
def test_load_hdr_matches_reference(tmp_path, env_map, rle):
    img = env_map.copy()
    img[3, 5:40] = 0.25  # a run the RLE encoder keeps as a run
    img[7, :] = 0.0  # exponent 0 texels
    path = str(tmp_path / "env.hdr")
    (_rle_hdr if rle else ref_hdr.save_hdr)(path, img)
    want = ref_hdr.load_hdr(path)
    got = hdr.load_hdr(path)
    assert got.dtype == np.float32 and got.shape == img.shape
    assert np.array_equal(got, want)
    # RGBE keeps 8 bits of mantissa a texel, scaled to its largest channel
    assert (np.abs(got - img)
            <= img.max(-1, keepdims=True) * 2.0 ** -7 * 1.0001).all()
    if rle:
        flat = str(tmp_path / "flat.hdr")
        ref_hdr.save_hdr(flat, img)
        assert os.path.getsize(path) < os.path.getsize(flat)
        assert np.array_equal(got, hdr.load_hdr(flat))


def test_save_hdr_matches_reference(tmp_path, env_map):
    a, b = str(tmp_path / "a.hdr"), str(tmp_path / "b.hdr")
    ref_hdr.save_hdr(a, env_map)
    hdr.save_hdr(b, env_map)
    assert open(a, "rb").read() == open(b, "rb").read()


@pytest.mark.parametrize("ascii_p3", [True, False], ids=["P3", "P6"])
def test_ppm_round_trip(tmp_path, ascii_p3):
    img = np.random.default_rng(5).integers(0, 256, (7, 11, 3)).astype(
        np.uint8)
    path = str(tmp_path / "img.ppm")
    imageio.save_ppm(path, img, ascii_p3=ascii_p3)
    assert np.array_equal(imageio.load_ppm(path), img)
    png = str(tmp_path / "img.png")
    imageio.save_png(png, img)
    assert open(png, "rb").read()[:8] == b"\x89PNG\r\n\x1a\n"


# -- the importance sampler --------------------------------------------------


@pytest.mark.parametrize("shape", [(32, 64), (300, 600), "zero"])
def test_build_env_sampling_bit_exact(shape):
    env = (np.zeros((16, 32, 3), np.float32) if shape == "zero"
           else synthetic_env(*shape, seed=3))
    want = ref_sky.build_env_sampling(env)
    got = port_sky.build_env_sampling(env)
    assert got[2] == want[2]
    assert got[2] == ((256, 512) if shape == (300, 600) else env.shape[:2])
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_from_reference_carries_hdri(env_map):
    rs, ps = _skies(env_map, 0.7)
    assert ps.has_env_sampling and ps.env_sample_hw == rs.env_sample_hw
    for name in ("env", "env_alias", "env_pdf", "env_rotation", "use_sky"):
        got, want = getattr(ps, name), np.asarray(getattr(rs, name))
        assert got.dtype == torch.float32 and np.array_equal(got.numpy(),
                                                             want), name
    back = tables.to_numpy(ps)
    assert np.array_equal(back["env"], env_map)
    # and the port's own constructor builds the same sky
    own = port_sky.SkyConfig.hdri(env_map, 0.7, device=CPU)
    for name in ("env", "env_alias", "env_pdf", "env_rotation"):
        assert torch.equal(getattr(own, name), getattr(ps, name)), name


def _dirs(n, seed):
    r = np.random.default_rng(seed)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # directions whose u sits just above 0 and just below 1 at each rotation
    for i, rot in enumerate(ROTATIONS):
        for j, eps in enumerate((1e-6, -1e-6, 3e-4, -3e-4)):
            phi = np.float64(-np.pi - rot + eps * 2 * np.pi)
            sel = slice((4 * i + j) * 16, (4 * i + j + 1) * 16)
            th = np.linspace(0.1, 3.0, 16)
            d[sel] = np.stack([np.sin(th) * np.cos(phi), np.cos(th),
                               np.sin(th) * np.sin(phi)], 1)
    return d


def _texels(u, v, sh, sw, xp):
    """env_pdf_dir's texel indices from (u, v), in numpy or torch."""
    if xp is np:
        return (np.clip((u * sw).astype(np.int32), 0, sw - 1),
                np.clip((v * sh).astype(np.int32), 0, sh - 1))
    return (torch.clamp((u * sw).to(torch.int64), 0, sw - 1).numpy(),
            torch.clamp((v * sh).to(torch.int64), 0, sh - 1).numpy())


@pytest.mark.parametrize("rot", ROTATIONS)
def test_sample_env_matches_reference(env_map, rot):
    rs, ps = _skies(env_map, rot)
    st = np.random.default_rng(11).integers(0, 2 ** 32, 4096,
                                            dtype=np.uint64).astype(np.uint32)
    ref = jax.jit(lambda s, sky: ref_sky.sample_env(s, sky))(jnp.asarray(st),
                                                            rs)
    got = port_sky.sample_env(torch.from_numpy(st.astype(np.int64)), ps)
    _exact(got[0], np.asarray(ref[0]).astype(np.int64), "PCG state")
    # the alias pick, from the same four draws
    sh, sw = rs.env_sample_hw
    s = jnp.asarray(st)
    s, u1 = ref_rng.uniform(s)
    s, u2 = ref_rng.uniform(s)
    k = np.minimum((np.asarray(u1) * (sh * sw)).astype(np.int32),
                   sh * sw - 1)
    row = np.asarray(rs.env_alias)[k]
    j = np.where(np.asarray(u2) < row[:, 0], k, row[:, 1].astype(np.int32))
    assert len(np.unique(j)) > 20
    ty = (np.arccos(np.clip(got[1].y.numpy(), -1, 1)) / np.pi * sh).astype(
        int)
    assert (np.abs(ty - j // sw) <= 1).all()  # the direction is in its row
    err = max(float(np.abs(getattr(got[1], c).numpy()
                           - np.asarray(getattr(ref[1], c))).max())
              for c in "xyz")
    assert err <= 2e-6, err
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-5)
    # radiance: the port's fetch against the reference's at the port's own
    # direction (the two samples' directions differ by the ulps above, which
    # the sun's edge magnifies past any radiance tolerance)
    at_own = jax.jit(lambda dd, sky: ref_sky.sample_sky(dd, sky))(
        _rv(got[1]), rs)
    _close(got[3], at_own, "radiance at the port's direction", ENV_VALUE)


@pytest.mark.parametrize("rot", ROTATIONS)
def test_env_pdf_dir_and_sky_match_reference(env_map, rot):
    rs, ps = _skies(env_map, rot)
    d = _dirs(4096, 12)
    rd, pd = _rv(d), _pv(d)
    sh, sw = rs.env_sample_hw
    # texel indices: the reference's u, v formula in jnp, the port's own
    phi = jnp.arctan2(rd.z, rd.x) + rs.env_rotation
    u_r = np.asarray(jnp.mod((phi + np.pi) * (1.0 / (2 * np.pi)), 1.0))
    v_r = np.asarray(jnp.arccos(jnp.clip(rd.y, -1.0, 1.0)) * (1.0 / np.pi))
    u_p, v_p = port_sky._env_uv(pd, ps)
    assert 0.0 <= float(u_p.min()) and float(u_p.max()) <= 1.0
    same = np.ones(len(d), bool)
    for a, b in zip(_texels(u_r, v_r, sh, sw, np),
                    _texels(u_p, v_p, sh, sw, torch)):
        same &= a == b
    assert same.mean() >= 0.999, same.mean()
    want = np.asarray(jax.jit(lambda dd, sky: ref_sky.env_pdf_dir(sky, dd))(
        rd, rs))
    got = port_sky.env_pdf_dir(ps, pd).numpy()
    _close(torch.from_numpy(got[same]), want[same], "env_pdf_dir", POLE_PDF)
    sky_r = jax.jit(lambda dd, sky: ref_sky.sample_sky(dd, sky))(rd, rs)
    _close(port_sky.sample_sky(pd, ps), sky_r, "sample_sky", FETCH)


def test_sky_disabled_and_gradient(env_map):
    rs, ps = _skies(env_map, 0.0)
    ps = dataclasses.replace(ps, use_sky=torch.tensor(0.0))
    d = _dirs(256, 4)
    assert float(port_sky.sample_sky(_pv(d), ps).max_component().abs().max()
                 ) == 0.0
    # the gradient branch is untouched
    g = port_sky.SkyConfig.gradient(device=CPU)
    assert g.env is None and not g.has_env_sampling


# -- the K3 plain stages with env NEE -----------------------------------------


def _ref_env_bounce(x, hit, split, bounce, n_lights, rr_start, rs, prev):
    """One bounce of the reference's integrator body with env NEE
    (``ptrt_tpu/render/integrator.py:307-466``) on the same lanes; the env
    and light walks answer ENV_SHADOW and SHADOW.  Returns (state dict,
    the env walk's arguments)."""
    acc = [_rv(a) for a in x["accum"]]
    zero3 = RefVec3.zeros((N,))
    alive, d = jnp.asarray(x["alive"]), _rv(x["d"])
    throughput, rng = _rv(x["throughput"]), jnp.asarray(x["state"])
    ray_spec = jnp.asarray(x["ray_spec"])
    prev_spec, path_spec = (jnp.asarray(x["prev_spec"]),
                            jnp.asarray(x["path_spec"]))
    prev_pdf, prev_did_nee = (jnp.asarray(a) for a in prev)
    accum, acc_d, acc_s, acc_e = acc
    is_first = bounce == 0
    out = {}
    mat = x["ref_table"].gather(jnp.maximum(hit.mesh_index, 0))

    miss = alive & ~hit.hit
    w_sky = jnp.where(prev_did_nee & ~prev_spec, ref_bsdf.mis_weight(
        prev_pdf, ref_sky.env_pdf_dir(rs, d)), 1.0)
    sky_c = ref_sky.sample_sky(d, rs) * throughput * w_sky
    accum = accum + ref_where(miss, sky_c, zero3)
    acc_s = acc_s + ref_where(miss & path_spec, sky_c, zero3)
    acc_d = acc_d + ref_where(miss & ~path_spec, sky_c, zero3)
    alive = alive & hit.hit

    t_unit = RefVec3(*[jnp.maximum(c, 1e-6) for c in (
        mat.albedo.x, mat.albedo.y, mat.albedo.z)])
    absorb = ref_beer_lambert(RefVec3(-jnp.log(t_unit.x), -jnp.log(t_unit.y),
                                      -jnp.log(t_unit.z)), hit.t)
    throughput = ref_where(alive & ~hit.front_face, throughput * absorb,
                           throughput)
    emissive = ((mat.emission.x > 0.0) | (mat.emission.y > 0.0)
                | (mat.emission.z > 0.0))
    emit_on = alive & emissive & (is_first | prev_spec)
    contrib_e = throughput * mat.emission
    accum = accum + ref_where(emit_on, contrib_e, zero3)
    acc_e = acc_e + ref_where(emit_on & is_first, contrib_e, zero3)
    acc_s = acc_s + ref_where(emit_on & (not is_first) & path_spec,
                              contrib_e, zero3)
    acc_d = acc_d + ref_where(emit_on & (not is_first) & ~path_spec,
                              contrib_e, zero3)

    do_nee = alive & ~ray_spec
    walk = {}

    def env_hit(o, dd, t, li=None):
        walk.update(o=o, d=dd, t=t)
        return jnp.asarray(ENV_SHADOW)

    rng, l_e, pdf_e, env_c = ref_nee.sample_env_lighting(
        rng, hit.point, hit.normal, hit.front_face, mat, d, rs, env_hit,
        split=split, active=do_nee)
    w_e = ref_bsdf.mis_weight(pdf_e, ref_bsdf.material_pdf(
        hit.normal, hit.front_face, mat, -d, l_e))
    walk.update(pdf=pdf_e, w=w_e, contrib=env_c)
    gate_e = do_nee & (pdf_e > 0.0)
    if split:
        env_d, env_s = env_c
        acc_d = acc_d + ref_where(gate_e, throughput * env_d * w_e, zero3)
        acc_s = acc_s + ref_where(gate_e, throughput * env_s * w_e, zero3)
        env_c = env_d + env_s
    accum = accum + ref_where(gate_e, throughput * env_c * w_e, zero3)

    if n_lights > 0:
        rng, l_nee, pdf_nee, nee_c = ref_nee.sample_direct_lighting(
            rng, hit.point, hit.normal, hit.front_face, mat, d,
            x["ref_lights"], n_lights,
            lambda o, dd, t, li=None: jnp.asarray(SHADOW), split=split,
            active=do_nee)
        w = ref_bsdf.mis_weight(pdf_nee, ref_bsdf.material_pdf(
            hit.normal, hit.front_face, mat, -d, l_nee))
        gate = do_nee & (pdf_nee > 0.0)
        if split:
            nee_d, nee_s = nee_c
            acc_d = acc_d + ref_where(gate, throughput * nee_d * w, zero3)
            acc_s = acc_s + ref_where(gate, throughput * nee_s * w, zero3)
            nee_c = nee_d + nee_s
        accum = accum + ref_where(gate, throughput * nee_c * w, zero3)

    rng, sc = ref_bsdf.material_scatter(rng, hit.normal, hit.front_face, mat,
                                        d)
    alive = alive & sc.valid
    prev_pdf = jnp.where(alive, ref_bsdf.material_pdf(
        hit.normal, hit.front_face, mat, -d, sc.direction), prev_pdf)
    prev_did_nee = jnp.where(alive, do_nee, prev_did_nee)
    prev_spec = jnp.where(alive, sc.is_specular, prev_spec)
    path_spec = path_spec & jnp.where(alive, sc.is_specular, True)
    rng, u_rr = ref_rng.uniform(rng)
    p = jnp.clip(throughput.max_component(), 0.05, 0.95)
    rr_on = bounce >= rr_start
    alive = alive & ~(rr_on & (u_rr > p))
    throughput = ref_where(rr_on & alive, throughput / p, throughput)
    throughput = ref_clamp_soft(throughput * sc.attenuation, 50.0)
    offset = ref_where(sc.direction.dot(hit.normal) > 0.0, hit.normal * 1e-4,
                       hit.normal * -1e-4)
    out.update(
        o=ref_where(alive, hit.point + offset, _rv(x["o"])),
        d=ref_where(alive, sc.direction, d),
        ray_spec=jnp.where(alive, sc.is_specular, ray_spec),
        throughput=throughput, alive=alive, accum=accum, diffuse=acc_d,
        specular=acc_s, emission=acc_e, prev_was_specular=prev_spec,
        path_still_specular=path_spec, rng=rng, do_nee=do_nee,
        prev_pdf=prev_pdf, prev_did_nee=prev_did_nee)
    return out, walk


def _prev(bounce):
    """The env MIS carries entering ``bounce``: none at bounce 0, random
    after it."""
    if bounce == 0:
        return np.zeros(N, np.float32), np.zeros(N, bool)
    r = np.random.default_rng(100 + bounce)
    return r.exponential(1.0, N).astype(np.float32), r.random(N) < 0.6


def _env_state(x, split, bounce):
    ps = _port_state(x, split)
    pdf, did = _prev(bounce)
    ps.prev_pdf, ps.prev_did_nee = torch.from_numpy(pdf), torch.from_numpy(
        did)
    assert ps.env_nee
    return ps


@pytest.mark.parametrize("split", [False, True], ids=["plain", "split"])
@pytest.mark.parametrize("bounce,n_lights", [(0, 4), (1, 4), (2, 4), (3, 4),
                                             (2, 0)],
                         ids=["b0", "b1", "b2", "b3", "b2-hdri-only"])
def test_env_stages_match_reference(lanes, env_map, split, bounce, n_lights):
    x = lanes
    rs, sky = _skies(env_map, 0.7)
    ps = _env_state(x, split, bounce)
    nee = shade.shade_nee_plain(ps, _geom(x), _k1(x), x["table"],
                                x["lights"], n_lights, sky, bounce)
    want, walk = _ref_env_bounce(x, _ref_hit(nee.hit), split, bounce,
                                 n_lights, 1, rs, _prev(bounce))
    dn = nee.do_nee.numpy()
    _exact(nee.do_nee, want["do_nee"], "do_nee")
    assert dn.mean() > 0.4
    assert (nee.env_t.numpy() == np.where(dn, 1e28, -1.0).astype(
        np.float32)).all()
    _exact(nee.env_t, walk["t"], "env t_max")
    m = torch.from_numpy(dn)
    sub = lambda v: v.map(lambda c: c[m]) if isinstance(v, Vec3) else v[m]
    rsub = lambda v: (RefVec3(*[jnp.asarray(np.asarray(c)[dn])
                                for c in (v.x, v.y, v.z)])
                      if isinstance(v, RefVec3) else np.asarray(v)[dn])
    _close(sub(nee.env_o), rsub(walk["o"]), "env shadow origin", DIRECTION)
    _close(sub(nee.env_d), rsub(walk["d"]), "env L", DIRECTION)
    _close(sub(nee.env_pdf), rsub(walk["pdf"]), "env pdf")
    _close(sub(nee.env_w), rsub(walk["w"]), "env MIS weight", ENV_VALUE)
    lit = env_lighting_lit((nee.env_c, nee.env_cs) if split else nee.env_c,
                           nee.env_pdf, torch.from_numpy(ENV_SHADOW))
    for k, got in enumerate(lit if split else [lit]):
        ref_c = walk["contrib"][k] if split else walk["contrib"]
        _close(got, ref_c, f"env contribution {k}", ENV_VALUE)
    if n_lights == 0:
        assert nee.shadow_t is None

    shade.shade_scatter_plain(
        ps, nee, torch.from_numpy(SHADOW) if n_lights else None, x["table"],
        bounce, rr_enabled=True, rr_start=1,
        env_shadow=torch.from_numpy(ENV_SHADOW))
    _exact(ps.rng, np.asarray(want["rng"]).astype(np.int64), "PCG state")
    for name in ("alive", "ray_spec", "prev_was_specular",
                 "path_still_specular", "prev_did_nee"):
        _exact(getattr(ps, name), want[name], name)
    _close(ps.prev_pdf, want["prev_pdf"], "prev_pdf", AT_PEAK)
    for name in ("accum",) + (("diffuse", "specular", "emission")
                              if split else ()):
        _close(getattr(ps, name), want[name], name, ENV_VALUE)
    _close(ps.o, want["o"], "origin", DIRECTION)
    _close(ps.d, want["d"], "direction", DIRECTION)
    _close(ps.throughput, want["throughput"], "throughput", AT_PEAK)


def test_env_draws_four_numbers_before_the_lights(lanes, env_map):
    """Without lights an env NEE bounce draws the env sample's four numbers,
    the scatter's three and the roulette's one, on every lane; with lights,
    five more between."""
    x = lanes
    _, sky = _skies(env_map, 0.0)
    for n_lights, draws in ((0, 8), (4, 13)):
        ps = _env_state(x, False, 1)
        nee = shade.shade_nee_plain(ps, _geom(x), _k1(x), x["table"],
                                    x["lights"], n_lights, sky, 1)
        shade.shade_scatter_plain(
            ps, nee, torch.from_numpy(SHADOW) if n_lights else None,
            x["table"], 1, True, 2, env_shadow=torch.from_numpy(ENV_SHADOW))
        s = jnp.asarray(x["state"])
        for _ in range(draws):
            s, _ = ref_rng.uniform(s)
        _exact(ps.rng, np.asarray(s).astype(np.int64), "PCG state")


def test_env_wrappers_use_plain_on_cpu(lanes, env_map, no_kernels):
    x = lanes
    _, sky = _skies(env_map, -3.0)
    ps, ps2 = _env_state(x, True, 2), _env_state(x, True, 2)
    args = (_geom(x), _k1(x), x["table"], x["lights"], 4, sky)
    nee = shade.shade_nee(ps, *args, bounce=2)
    nee2 = shade.shade_nee_plain(ps2, *args, bounce=2)
    for a, b in zip(nee[1:], nee2[1:]):
        if isinstance(a, Vec3):
            assert all(torch.equal(p, q) for p, q in zip(
                (a.x, a.y, a.z), (b.x, b.y, b.z)))
        elif a is not None:
            assert torch.equal(a, b)
    occl, env_occl = torch.from_numpy(SHADOW), torch.from_numpy(ENV_SHADOW)
    shade.shade_scatter(ps, nee, occl, x["table"], 2, True, 1,
                        env_shadow=env_occl)
    shade.shade_scatter_plain(ps2, nee2, occl, x["table"], 2, True, 1,
                              env_shadow=env_occl)
    for f in dataclasses.fields(shade.PathState):
        u, v = getattr(ps, f.name), getattr(ps2, f.name)
        if isinstance(u, Vec3):
            assert all(torch.equal(p, q) for p, q in zip(
                (u.x, u.y, u.z), (v.x, v.y, v.z))), f.name
        elif u is not None:
            assert torch.equal(u, v), f.name
    # the wrappers refuse an env state whose record or answer is missing
    with pytest.raises(TypeError):
        shade.shade_scatter(ps, nee, occl, x["table"], 2, True, 1)
    with pytest.raises(ValueError):
        shade.shade_scatter(ps, nee._replace(env_t=None), occl, x["table"],
                            2, True, 1, env_shadow=env_occl)
    with pytest.raises(ValueError):  # env NEE under a gradient sky
        shade.shade_nee(ps, *args[:-1],
                        port_sky.SkyConfig.gradient(device=CPU), bounce=2)


def test_hdri_sky_and_env_nee_go_together(lanes, env_map):
    """Env NEE runs exactly where the sky is an HDRI: an HDRI without
    sampling tables is refused where it is carried across or built, and
    the stages refuse a state whose env NEE disagrees with the sky."""
    ref = ref_np(ref_sky.SkyConfig.hdri(env_map, 0.7,
                                        importance_sampling=False))
    with pytest.raises(ValueError, match="sampling tables"):
        tables.from_reference(device=CPU, sky=ref)
    _, sky = _skies(env_map, 0.7)
    with pytest.raises(ValueError, match="sampling tables"):
        dataclasses.replace(sky, env_alias=None, env_pdf=None)
    with pytest.raises(ValueError, match="sampling tables"):
        dataclasses.replace(port_sky.SkyConfig.gradient(device=CPU),
                            env_alias=sky.env_alias, env_pdf=sky.env_pdf)
    x = lanes
    ps = _port_state(x, False)
    assert not ps.env_nee
    args = (_geom(x), _k1(x), x["table"], x["lights"], 4, sky, 1)
    for stage in (shade.shade_nee, shade.shade_nee_plain):
        with pytest.raises(ValueError, match="env NEE"):
            stage(ps.clone(), *args)


def test_env_table_bytes_counts_each_texel_once(env_map):
    """The HDRI bound reads a texel, a pdf entry and an alias row once
    however many lanes look them up: misses and samples along one direction
    read its four texels and its pdf entry; the samples' alias rows are as
    many as the samples, at most the table."""
    from ptrt_tpu_torch.tools import stages

    _, sky = _skies(env_map, -3.0)
    one = lambda n: Vec3(*[torch.full((n,), c) for c in (0.6, 0.48, -0.64)])
    mis = torch.ones(1000, dtype=torch.bool)
    rows = sky.env_alias.shape[0]
    assert rows == 32 * 64
    assert stages.env_table_bytes(sky, one(1000), mis, one(1000)) == (
        4 * 12 + 4 + 1000 * 8)
    assert stages.env_table_bytes(sky, one(1000), mis, one(3000)) == (
        4 * 12 + 4 + rows * 8)
    assert stages.env_table_bytes(sky, one(0), mis[:0], one(10)) == (
        4 * 12 + 4 + 10 * 8)
    # the fetch indices are those sample_sky blends: a map whose texels
    # hold their own index gives back a blend of those four
    d = Vec3(*[torch.from_numpy(c) for c in _dirs(256, 9).T])
    tex, pdf_tex = port_sky.env_texels(sky, d)
    h, w = sky.env.shape[:2]
    ids = torch.arange(h * w, dtype=torch.float32).reshape(h, w, 1)
    idx_sky = dataclasses.replace(sky, env=ids.expand(h, w, 3).contiguous())
    got = port_sky.sample_sky(d, idx_sky).x
    lo, hi = tex.min(-1).values, tex.max(-1).values
    assert ((got >= lo - 0.5) & (got <= hi + 0.5)).all()
    assert ((pdf_tex >= 0) & (pdf_tex < rows)).all()
