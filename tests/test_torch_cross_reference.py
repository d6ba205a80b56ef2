"""An independent radiance gate for ptrt_tpu_torch: a from-scratch numpy
tracer.

A copy of the numpy side of ``tests/test_cross_reference.py`` (``_np_trace``
and its helpers, ``_cornell_tris``, ``_np_scene``; that file imports the JAX
package, so it is copied, never imported), held against the port's
``trace_frame`` on the CPU instead of the reference's:

1. ``test_point_light_direct_analytic`` — depth-1 direct lighting of a
   diffuse floor by a point light against its closed form, the reference
   test's settings and bounds (median relative error below 2%, PSNR above
   38 dB on the floor's core pixels).
2. ``test_numpy_tracer_agrees_gi_reduced`` — the GI Cornell box (depth 3)
   at 24x24 and 64 samples on each side, in tier-1 (~6 s): PSNR above 24
   dB and the mean energy within 4%.  Both estimators carry 6x fewer
   samples than the 384 of the full comparison, so each pixel's noise is
   ~2.4x larger and the PSNR limit is lower than its 28 dB.  Measured on
   the CPU with the engine's frames 0-3 and 4-7 against the numpy tracer
   at seeds 7, 1, 2 and 3: 27.5-28.0 dB, the energy 2.7-3.0% apart (the
   full comparison allows 3% at 40x30); a pdf, cosine or MIS bug costs
   10-30% of the energy and fails both bounds.
3. The reference's three 384-sample comparisons (GI, glass, area light)
   against the port, with the reference's settings and PSNR and energy
   limits, marked ``slow`` as they are there.

The numpy tracer mirrors the reference SEMANTICS the engine implements
(one-sample NEE with power-2 MIS, emission only on primary / after-specular
hits, ``(range/(range+d))^2`` attenuation, soft clamps 50/500/100) so the
two estimators target the same integral.  Russian roulette is off on the
engine's side, as in the reference test.
"""

import numpy as np
import pytest
import torch

from ptrt_tpu_torch.geometry.mesh import Mesh
from ptrt_tpu_torch.render import pipeline
from ptrt_tpu_torch.scene.materials import Material
from ptrt_tpu_torch.scene.pt_scene import Scene
from test_torch_shading import torch_one_thread  # noqa: F401

# ---------------------------------------------------------------------------
# independent numpy renderer (a copy of tests/test_cross_reference.py's)
# ---------------------------------------------------------------------------


def _norm(v, eps=1e-20):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), eps)


def _dot(a, b):
    return np.sum(a * b, axis=-1)


def _camera_rays(cam_desc, w, h, u1, u2):
    """RTIOW camera basis (``camera.cuh:95-121, 156-166``), numpy."""
    lookfrom = np.asarray(cam_desc["from"], np.float64)
    lookat = np.asarray(cam_desc["at"], np.float64)
    vup = np.array([0.0, 1.0, 0.0])
    vfov, aspect = cam_desc["vfov"], w / h
    theta = np.deg2rad(vfov)
    hh = np.tan(theta / 2.0)
    vieww, viewh = aspect * 2 * hh, 2 * hh
    wv = _norm(lookfrom - lookat)
    uv = _norm(np.cross(vup, wv))
    vv = np.cross(wv, uv)
    horizontal = uv * vieww
    vertical = vv * viewh
    llc = lookfrom - horizontal / 2 - vertical / 2 - wv
    ys, xs = np.mgrid[0:h, 0:w]
    s = (xs + 0.5 + u1) / w  # u1/u2 in [-0.5, 0.5): pixel-area sampling
    t = (ys + 0.5 + u2) / h
    d = (llc + horizontal * s[..., None] + vertical * t[..., None]
         - lookfrom)
    return (np.broadcast_to(lookfrom, d.shape).astype(np.float32),
            _norm(d).astype(np.float32))


def _intersect(o, d, v0, e1, e2, t_min, t_max):
    """Brute-force Möller–Trumbore over all triangles
    (``intersection.cuh:219-255`` semantics: two-sided, inclusive
    barycentric epsilon).  o, d: (R, 3); returns (t, tri_idx)."""
    oo = o[:, None, :]
    dd = d[:, None, :]
    hv = np.cross(dd, e2[None])
    a = _dot(e1[None], hv)
    valid = np.abs(a) > 1e-9
    f = 1.0 / np.where(valid, a, 1.0)
    s = oo - v0[None]
    u = f * _dot(s, hv)
    q = np.cross(s, e1[None])
    v = f * _dot(dd, q)
    t = f * _dot(e2[None], q)
    beps = 1e-6
    ok = (valid & (u >= -beps) & (u <= 1 + beps) & (v >= -beps)
          & (u + v <= 1 + beps) & (t > t_min)
          & (t < (t_max[:, None] if np.ndim(t_max) else t_max)))
    t = np.where(ok, t, np.inf)
    idx = np.argmin(t, axis=1)
    tbest = t[np.arange(len(o)), idx]
    return np.where(np.isfinite(tbest), tbest, np.inf), idx


def _fresnel3(c, f0):
    """``pbr_utils.cuh:16-22``; c: (R,), f0: (R, 3) -> (R, 3)."""
    f = 1.0 - np.clip(c, 0.0, 1.0)
    f5 = (f * f) * (f * f) * f
    return f0 + (1.0 - f0) * f5[:, None]


def _ggx_d(ndoth, rough):
    """``pbr_utils.cuh:37-48``."""
    a2 = (rough * rough) ** 2
    den = ndoth * ndoth * (a2 - 1.0) + 1.0
    return a2 / np.maximum(np.pi * den * den, 1e-6)


def _smith_g1(ndotx, rough):
    """``pbr_utils.cuh:56-62``."""
    r = rough + 1.0
    k = r * r * 0.125
    return ndotx / (ndotx * (1.0 - k) + k + 1e-6)


def _soft_clamp(v, max_lum):
    """Luminance-preserving soft clamp (``path_logic.cuh:44-52``)."""
    lum = v @ np.array([0.2126, 0.7152, 0.0722])
    sc = np.where((lum > max_lum) & (lum > 0), max_lum / np.maximum(
        lum, 1e-30), 1.0)
    return v * sc[:, None]


def _onb(n):
    """Frisvad frame (``sampling.cuh:73-91``)."""
    s = np.where(n[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = np.stack([1.0 + s * n[:, 0] ** 2 * a, s * b, -s * n[:, 0]], axis=1)
    bt = np.cross(n, t)
    return t, bt


def _schlick_dielectric(c, ior_i, ior_t):
    """``pbr_utils.cuh:127-138``."""
    r0 = ((ior_i - ior_t) / (ior_i + ior_t)) ** 2
    f = 1.0 - np.clip(c, 0.0, 1.0)
    return r0 + (1.0 - r0) * (f * f) * (f * f) * f


def _opaque_eval(n, l, v, albedo, f0, rough):
    """``evaluateBSDF`` opaque branch (``path_logic.cuh:157-250``): returns
    f * NdotL and the scatter pdf of ``l`` (``pdf.cuh:208-217``)."""
    ndotv = np.maximum(_dot(n, v), 0.0)
    ndotl_s = _dot(n, l)
    ndotl = np.maximum(ndotl_s, 0.0)
    h = _norm(l + v)
    ndoth = np.maximum(_dot(n, h), 0.0)
    vdoth = np.maximum(_dot(v, h), 0.0)
    dterm = _ggx_d(ndoth, rough)
    g = _smith_g1(ndotl, rough) * _smith_g1(ndotv, rough)
    fr = _fresnel3(vdoth, f0)
    spec = fr * (dterm * g / (4.0 * ndotv * ndotl + 0.001))[:, None]
    kd = (1.0 - fr)
    diffuse = kd * albedo / np.pi
    f_cos = (diffuse + spec) * ndotl[:, None]
    dead = (ndotv <= 0.0) | (ndotl_s <= 0.0)
    f_cos[dead] = 0.0
    # scatter pdf of l: specular_prob = max Fresnel at ndotv (metal = 0)
    f_base = _fresnel3(ndotv, f0)
    sp = np.max(f_base, axis=1)
    pdf_spec = dterm * ndoth / (4.0 * vdoth + 1e-6)
    pdf = sp * pdf_spec + (1.0 - sp) * ndotl / np.pi
    pdf = np.where((ndotl_s > 0.0) & (ndotv > 0.0), pdf, 0.0)
    return f_cos, pdf


def _trans_eval(n, l, v, front, albedo, f0, rough, trans_rough, ior):
    """``evaluateBSDF`` transmissive branch (``path_logic.cuh:157-250``,
    NdotL>0 reflection side / NdotL<0 BTDF side) + the trans scatter pdf
    of ``l`` (``pdf.cuh:176-206``); metal = 0, clearcoat = 0."""
    ndotv = np.maximum(_dot(n, v), 0.0)
    ndotl_s = _dot(n, l)
    ndotl = np.maximum(ndotl_s, 0.0)
    ndotl_abs = np.abs(ndotl_s)
    eta = np.where(front, 1.0 / ior, ior)

    # reflection side
    h_r = _norm(l + v)
    ndoth_r = np.maximum(_dot(n, h_r), 0.0)
    vdoth_r = np.maximum(_dot(v, h_r), 0.0)
    d_r = _ggx_d(ndoth_r, rough)
    g_r = _smith_g1(ndotl, rough) * _smith_g1(ndotv, rough)
    f_r = _fresnel3(vdoth_r, f0)
    refl = f_r * (d_r * g_r / (4.0 * ndotv * ndotl + 1e-6))[:, None] \
        * ndotl[:, None]

    # refraction side (path_logic.cuh:87-100 analog in bsdf.py)
    h_t = _norm(-(v * eta[:, None] + l))
    flip = _dot(n, h_t) < 0.0
    h_t = np.where(flip[:, None], -h_t, h_t)
    vdoth_t = np.maximum(_dot(v, h_t), 0.0)
    ldoth_t = np.abs(_dot(l, h_t))
    k = 1.0 - eta * eta * (1.0 - vdoth_t * vdoth_t)
    d_t = _ggx_d(np.maximum(_dot(n, h_t), 0.0), trans_rough)
    g_t = _smith_g1(ndotl_abs, trans_rough) * _smith_g1(ndotv, trans_rough)
    f_t3 = 1.0 - _fresnel3(vdoth_t, f0)
    numer = eta * eta * g_t * d_t * vdoth_t * ldoth_t
    denom = ndotv * ndotl_abs * (eta * vdoth_t + ldoth_t) ** 2
    btdf = albedo * f_t3 * (numer / (denom + 1e-6))[:, None] \
        * ndotl_abs[:, None]
    btdf = np.where((k >= 0.0)[:, None], btdf, 0.0)

    f_cos = np.where((ndotl_s > 0.0)[:, None], refl, btdf)
    f_cos = np.where((ndotv <= 0.0)[:, None], 0.0, f_cos)

    # pdf (pdf.cuh:176-206): prob_base = 1 (no coat); material_pdf picks
    # schlick_dielectric_one_ior(ndotv, ior_ratio), ior_ratio = front ?
    # 1/ior : ior
    ior_ratio = np.where(front, 1.0 / ior, ior)
    reflect_prob = _schlick_dielectric(ndotv, np.ones_like(ior), ior_ratio)
    pdf_reflect = d_r * ndoth_r / (4.0 * vdoth_r + 1e-6)
    h_pl = _norm(v + l)
    vdoth_pl = np.maximum(_dot(v, h_pl), 0.0)
    k_pl = 1.0 - ior_ratio * ior_ratio * (1.0 - vdoth_pl * vdoth_pl)
    d_tir = _ggx_d(np.maximum(_dot(n, h_pl), 0.0), trans_rough)
    pdf_tir = d_tir * np.maximum(_dot(n, h_pl), 0.0) / (4.0 * vdoth_pl
                                                        + 1e-6)
    pos = reflect_prob * pdf_reflect + np.where(
        k_pl < 0.0, (1.0 - reflect_prob) * pdf_tir, 0.0)
    # pdf_ggx_refract (pdf.cuh:97-123)
    dwh_dwo = (ior_ratio * ior_ratio * ldoth_t) / (
        (ior_ratio * vdoth_t + ldoth_t) ** 2 + 1e-12)
    pdf_refract = d_t * np.maximum(_dot(n, h_t), 0.0) * np.abs(dwh_dwo)
    pdf_refract = np.where((ndotv <= 0.0) | (ndotl_s >= 0.0), 0.0,
                           pdf_refract)
    neg = (1.0 - reflect_prob) * pdf_refract
    pdf = np.where(ndotl_s > 0.0, pos, neg)
    pdf = np.where(ndotv == 0.0, 0.0, pdf)
    return f_cos, pdf


def _trans_scatter_eval(n, l, v, eta, albedo, f0, rough, trgh, refl_prob,
                        sampled_refract):
    """Transmissive-case f/pdf accumulation of ``material_scatter``
    (``path_logic.cuh:621-685``; clearcoat 0, metal 0): base reflection +
    BTDF + the refract-sampled-as-reflection (TIR) term."""
    ndotv = np.maximum(_dot(n, v), 0.0)
    ndotl_s = _dot(n, l)
    ndotl = np.maximum(ndotl_s, 0.0)
    ndotl_abs = np.abs(ndotl_s)
    p_tr = refl_prob
    p_trr = 1.0 - refl_prob

    h_refl = _norm(v + l)
    ndoth_refl = np.maximum(_dot(n, h_refl), 0.0)
    vdoth_refl = np.maximum(_dot(v, h_refl), 0.0)
    d_refl = _ggx_d(ndoth_refl, rough)
    g_refl = _smith_g1(ndotl, rough) * _smith_g1(ndotv, rough)
    f_refl = _fresnel3(vdoth_refl, f0)
    pdf_refl = d_refl * ndoth_refl / (4.0 * vdoth_refl + 1e-6)
    refl_on = (p_tr > 0.0) & (ndotl_s > 0.0)
    pdf = np.where(refl_on, p_tr * pdf_refl, 0.0)
    f = np.where(refl_on[:, None], f_refl * (
        d_refl * g_refl / (4.0 * ndotv * ndotl + 1e-6) * ndotl)[:, None],
        0.0)

    h_rf = _norm(-(v * eta[:, None] + l))
    h_rf = np.where((_dot(n, h_rf) < 0.0)[:, None], -h_rf, h_rf)
    vdoth_rf = np.maximum(_dot(v, h_rf), 0.0)
    ldoth_rf = np.abs(_dot(l, h_rf))
    ndoth_rf = np.maximum(_dot(n, h_rf), 0.0)
    k_rf = 1.0 - eta * eta * (1.0 - vdoth_rf * vdoth_rf)
    d_rf = _ggx_d(ndoth_rf, trgh)
    g_rf = _smith_g1(ndotl_abs, trgh) * _smith_g1(ndotv, trgh)
    dwh = (eta * eta * ldoth_rf) / ((eta * vdoth_rf + ldoth_rf) ** 2
                                    + 1e-12)
    pdf_rf = d_rf * ndoth_rf * np.abs(dwh)
    refr_on = (p_trr > 0.0) & (ndotl_s < 0.0) & (k_rf >= 0.0)
    pdf = pdf + np.where(refr_on, p_trr * pdf_rf, 0.0)
    fr3 = 1.0 - _fresnel3(vdoth_rf, f0)
    numer = eta * eta * g_rf * d_rf * vdoth_rf * ldoth_rf
    denom = ndotv * ndotl_abs * (eta * vdoth_rf + ldoth_rf) ** 2
    f = f + np.where(refr_on[:, None],
                     albedo * fr3 * (numer / (denom + 1e-6)
                                     * ndotl_abs)[:, None], 0.0)

    d_tirr = _ggx_d(ndoth_refl, trgh)
    g_tirr = _smith_g1(ndotl, trgh) * _smith_g1(ndotv, trgh)
    pdf_tirr = d_tirr * ndoth_refl / (4.0 * vdoth_refl + 1e-6)
    tir_on = sampled_refract & (ndotl_s > 0.0)
    pdf = pdf + np.where(tir_on, p_trr * pdf_tirr, 0.0)
    f = f + np.where(tir_on[:, None], (d_tirr * g_tirr / (
        4.0 * ndotv * ndotl + 1e-6) * ndotl)[:, None], 0.0)
    return f, pdf


def _np_trace(scene, cam_desc, w, h, spp, depth, rng):
    """Independent wavefront path tracer in numpy.  Mirrors the reference
    semantics (one-sample NEE + power-2 MIS ``path_logic.cuh:840-857``,
    emission gating ``:831-836``, clamps ``:24-29``) with its OWN random
    streams; lambertian+GGX opaque materials only."""
    v0, e1, e2 = scene["v0"], scene["e1"], scene["e2"]
    mesh_id = scene["mesh_id"]
    albedo = scene["albedo"]
    f0 = scene["f0"]
    rough = scene["rough"]
    emission = scene["emission"]
    lpos = np.asarray(scene["light_pos"], np.float32)
    lrad = np.asarray(scene["light_radiance"], np.float32)  # color*intensity
    lrange = float(scene["light_range"])

    acc = np.zeros((h * w, 3), np.float64)
    for _ in range(spp):
        u1, u2 = rng.random((h, w)) - 0.5, rng.random((h, w)) - 0.5
        o, d = _camera_rays(cam_desc, w, h, u1, u2)
        o = o.reshape(-1, 3)
        d = d.reshape(-1, 3)
        throughput = np.ones((h * w, 3), np.float32)
        radiance = np.zeros((h * w, 3), np.float32)
        alive = np.ones(h * w, bool)
        prev_spec = np.ones(h * w, bool)  # camera "specular" flag semantics
        ray_spec = np.zeros(h * w, bool)  # camera_nee fix: bounce-0 NEE on
        for bounce in range(depth):
            t, ti = _intersect(o, d, v0, e1, e2, 1e-4,
                               np.full(len(o), 1e30))
            hit = np.isfinite(t) & alive
            alive = hit
            if not alive.any():
                break
            p = o + d * t[:, None]
            ng = _norm(np.cross(e1[ti], e2[ti]))
            front = _dot(d, ng) < 0.0
            n = np.where(front[:, None], ng, -ng)
            m = mesh_id[ti]
            alb, sf0, rgh = albedo[m], f0[m], rough[m]
            emi = emission[m]
            tr = scene["trans"][m]
            trgh = np.maximum(scene["trans_rough"][m], rgh)
            ior = scene["ior"][m]
            is_tr = tr > 0.0

            # interior Beer-Lambert (path_logic:823-829): back-face hits
            # absorb exp(-(-log(albedo))*t) = albedo^t per channel
            t_unit = np.maximum(alb, 1e-6)
            absorb = np.exp(np.log(t_unit) * t[:, None])
            inside = alive & ~front
            throughput = np.where(inside[:, None], throughput * absorb,
                                  throughput)

            # emission only on primary / after-specular (path_logic:831-836)
            emit_on = alive & (emi.sum(axis=1) > 0) & (
                (bounce == 0) | prev_spec)
            radiance[emit_on] += throughput[emit_on] * emi[emit_on]

            # NEE (camera_nee fix: bounce-0 NEE allowed)
            vdir = -d
            if scene.get("light_area") is None:
                # point light: delta sample, pdf_nee = 1 (nee.py:54-71)
                tol = lpos[None] - p
                dist = np.maximum(np.linalg.norm(tol, axis=1), 1e-6)
                l = tol / dist[:, None]
                pdf_nee = np.ones(len(o), np.float32)
            else:
                # rect AREA light: uniform point on the quad, solid-angle
                # pdf dist^2/(A cos_emit), single-sided (nee.py:73-96)
                lw, lh, ldir = scene["light_area"]
                ua = rng.random(len(o))
                va = rng.random(len(o))
                tb_u, tb_v = _onb(np.broadcast_to(ldir, (len(o), 3)))
                q = (lpos[None] + tb_u * (lw * (ua - 0.5))[:, None]
                     + tb_v * (lh * (va - 0.5))[:, None])
                tol = q - p
                dist = np.maximum(np.linalg.norm(tol, axis=1), 1e-6)
                l = tol / dist[:, None]
                cos_emit = _dot(-l, np.broadcast_to(ldir, l.shape))
                pdf_nee = np.where(
                    cos_emit > 1e-6,
                    dist * dist / (max(lw * lh, 1e-12)
                                   * np.maximum(cos_emit, 1e-6)), 0.0)
            att = (lrange / (lrange + dist)) ** 2
            # shadow ray (offset + t bound like nee.py:138-147); the
            # engine's shadow walk skips TRANSMISSIVE occluders
            # (shadow_opaque flag) — mirror with the opaque triangle set
            # opaque = transmission <= 0.5 (scene_geom.py:205-211)
            ok_occ = scene["trans"][mesh_id] <= 0.5
            off = np.where(_dot(n, l)[:, None] > 0, n, -n) * 1e-4
            st, _ = _intersect(p + off, l, v0[ok_occ], e1[ok_occ],
                               e2[ok_occ], 1e-4, dist - 1e-3)
            lit = ~np.isfinite(st) & (pdf_nee > 0.0)
            f_o, pdf_o = _opaque_eval(n, l, vdir, alb, sf0, rgh)
            f_g, pdf_g = _trans_eval(n, l, vdir, front, alb, sf0, rgh,
                                     trgh, ior)
            f_cos = np.where(is_tr[:, None], f_g, f_o)
            pdf_b = np.where(is_tr, pdf_g, pdf_o)
            mis = pdf_nee ** 2 / (pdf_nee ** 2 + pdf_b * pdf_b + 1e-10)
            scale = att / np.maximum(pdf_nee, 1e-12)
            contrib = _soft_clamp(f_cos * lrad[None] * scale[:, None], 500.0)
            # engine gates NEE on the incoming ray's specular flag
            gate = alive & lit & ~ray_spec
            radiance[gate] += (throughput * contrib * mis[:, None])[gate]

            # scatter (material_scatter, path_logic:490-780; coat 0):
            # lobes 1 reflect / 2 refract / 3 diffuse, one shared (u, g1,
            # g2) draw per lane like the engine's branchless kernel
            ndotv = np.maximum(_dot(n, vdir), 0.0)
            f_base = _fresnel3(ndotv, sf0)
            sp_prob = np.max(f_base, axis=1)
            eta = np.where(front, 1.0 / ior, ior)
            ior_i = np.where(front, 1.0, ior)
            ior_t = np.where(front, ior, 1.0)
            refl_prob = _schlick_dielectric(ndotv, ior_i, ior_t)
            u = rng.random(len(o))
            g1, g2 = rng.random(len(o)), rng.random(len(o))
            lobe = np.where(is_tr,
                            np.where(u < refl_prob, 1, 2),
                            np.where(u < sp_prob, 1, 3))
            # GGX half vector at the selected lobe's roughness
            # (sampling.cuh:187-208)
            s_rough = np.where(lobe == 2, trgh, rgh)
            a2 = (s_rough * s_rough) ** 2
            g2c = np.minimum(g2, 0.9999999)
            phi = 2 * np.pi * g1
            ct = np.sqrt((1.0 - g2c) / (1.0 + (a2 - 1.0) * g2c))
            stn = np.sqrt(np.maximum(0.0, 1.0 - ct * ct))
            tgt, btg = _onb(n)
            hvec = (tgt * (stn * np.cos(phi))[:, None]
                    + btg * (stn * np.sin(phi))[:, None] + n * ct[:, None])
            spec_dir = d - hvec * (2.0 * _dot(d, hvec))[:, None]
            # refraction with H-flip + TIR (path_logic:563-586)
            h_refr = np.where((_dot(vdir, hvec) < 0.0)[:, None], -hvec,
                              hvec)
            vdoth_tir = np.abs(_dot(vdir, h_refr))
            k_tir = 1.0 - eta * eta * (1.0 - vdoth_tir * vdoth_tir)
            tir = k_tir < 0.0
            cos_t = np.sqrt(np.maximum(k_tir, 0.0))
            refr_dir = _norm(-vdir * eta[:, None]
                             + h_refr * (eta * vdoth_tir - cos_t)[:, None])
            tir_dir = d - h_refr * (2.0 * _dot(d, h_refr))[:, None]
            refract_dir = np.where(tir[:, None], tir_dir, refr_dir)
            # cosine hemisphere (sampling.cuh:141-147)
            r = np.sqrt(g1)
            phid = 2 * np.pi * g2
            diff_dir = (tgt * (r * np.cos(phid))[:, None]
                        + btg * (r * np.sin(phid))[:, None]
                        + n * np.sqrt(np.maximum(0.0, 1.0 - g1))[:, None])
            newd = _norm(np.where((lobe == 3)[:, None], diff_dir,
                                  np.where((lobe == 2)[:, None],
                                           refract_dir, spec_dir)))
            is_spec_lane = np.where(
                lobe == 1, rgh < 0.1,
                np.where(lobe == 2, tir | (trgh < 0.1), False))

            f_o, pdf_o2 = _opaque_eval(n, newd, vdir, alb, sf0, rgh)
            f_g, pdf_g2 = _trans_scatter_eval(n, newd, vdir, eta, alb, sf0,
                                              rgh, trgh, refl_prob,
                                              lobe == 2)
            f_cos_s = np.where(is_tr[:, None], f_g, f_o)
            pdf_s = np.where(is_tr, pdf_g2, pdf_o2)
            atten = f_cos_s / np.maximum(pdf_s, 1e-6)[:, None]
            ok = pdf_s > 0.0
            alive = alive & ok
            throughput = _soft_clamp(throughput * atten, 50.0)
            prev_spec = np.where(alive, is_spec_lane, prev_spec)
            ray_spec = np.where(alive, is_spec_lane, ray_spec)
            o = p + np.where(_dot(newd, n)[:, None] > 0, n, -n) * 1e-4
            d = newd
        acc += _soft_clamp(radiance, 100.0)
    return (acc / spp).reshape(h, w, 3)


# ---------------------------------------------------------------------------
# shared scene construction (both renderers consume the same arrays)
# ---------------------------------------------------------------------------


def _quad(a, b, c, dd):
    """Two triangles for quad a-b-c-d."""
    return np.array([[a, b, c], [a, c, dd]], np.float32)


def _cornell_tris():
    """Cornell-style box, open front (+z): floor/ceiling/back/left/right
    + a small tall box.  Returns (tris, mesh_sizes) per material group."""
    fl = _quad([-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1])
    ce = _quad([-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1])
    bk = _quad([-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1])
    lf = _quad([-1, 0, 1], [-1, 0, -1], [-1, 2, -1], [-1, 2, 1])
    rt = _quad([1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1])
    white = np.concatenate([fl, ce, bk])
    # small box: axis-aligned, 0.5 wide, 0.9 tall at (0.25, *, -0.3)
    x0, x1, y0, y1, z0, z1 = -0.05, 0.45, 0.0, 0.9, -0.55, -0.05
    box = np.concatenate([
        _quad([x0, y1, z1], [x1, y1, z1], [x1, y1, z0], [x0, y1, z0]),
        _quad([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]),
        _quad([x1, y0, z1], [x1, y0, z0], [x1, y1, z0], [x1, y1, z1]),
        _quad([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0]),
        _quad([x1, y0, z0], [x0, y0, z0], [x0, y1, z0], [x1, y1, z0]),
    ])
    return [white, lf, rt, box]


_MATS = [
    dict(albedo=(0.73, 0.73, 0.73)),
    dict(albedo=(0.65, 0.05, 0.05)),
    dict(albedo=(0.12, 0.45, 0.15)),
    dict(albedo=(0.60, 0.55, 0.40)),
]
_CAM = dict({"from": (0.0, 1.0, 2.9), "at": (0.0, 1.0, 0.0), "vfov": 42.0})
_LIGHT = dict(pos=(0.0, 1.85, 0.1), color=(1.0, 0.95, 0.9), intensity=2.5,
              range=100.0)


_AREA = dict(pos=(0.0, 1.95, 0.0), dir=(0.0, -1.0, 0.0), w=0.7, h=0.5,
             color=(1.0, 0.95, 0.9), intensity=3.0, range=100.0)


def _np_scene(groups, area=False, mats=None):
    mats = _MATS if mats is None else mats
    tris = np.concatenate(groups)
    mesh_id = np.concatenate([np.full(len(g), i, np.int32)
                              for i, g in enumerate(groups)])
    v0 = tris[:, 0]
    light = _AREA if area else _LIGHT
    rough = np.maximum(  # MIN_ROUGH clamp (path_logic.cuh:167)
        np.array([m.get("rough", 1.0) for m in mats], np.float32), 0.02)
    return dict(
        v0=v0, e1=tris[:, 1] - v0, e2=tris[:, 2] - v0, mesh_id=mesh_id,
        albedo=np.array([m["albedo"] for m in mats], np.float32),
        f0=np.full((len(mats), 3), 0.04, np.float32),
        rough=rough,
        emission=np.zeros((len(mats), 3), np.float32),
        trans=np.array([m.get("trans", 0.0) for m in mats], np.float32),
        trans_rough=np.array([m.get("trans_rough", 0.0) for m in mats],
                             np.float32),
        ior=np.array([m.get("ior", 1.5) for m in mats], np.float32),
        light_pos=light["pos"],
        light_radiance=np.asarray(light["color"], np.float32)
        * light["intensity"],
        light_range=light["range"],
        light_area=((light["w"], light["h"],
                     np.asarray(light["dir"], np.float32))
                    if area else None),
    )


def _engine_scene(groups, w, h, spp, depth, area=False, mats=None):
    mats = _MATS if mats is None else mats
    sc = Scene(w, h, device="cpu")
    for g, m in zip(groups, mats):
        sc.add_triangles(g, Material(
            albedo=m["albedo"], roughness=m.get("rough", 1.0),
            specular=(0.04, 0.04, 0.04),
            transmission=m.get("trans", 0.0),
            transmission_roughness=m.get("trans_rough", 0.0),
            ior=m.get("ior", 1.5)))
    if area:
        sc.add_area_light(_AREA["pos"], _AREA["dir"], _AREA["w"], _AREA["h"],
                          _AREA["color"], _AREA["intensity"])
    else:
        sc.add_point_light(_LIGHT["pos"], _LIGHT["color"],
                           _LIGHT["intensity"], range=_LIGHT["range"],
                           radius=0.0)
    sc.set_sky_enabled(False)
    sc.set_camera(_CAM["from"], _CAM["at"], fov=_CAM["vfov"])
    sc.perf.samples_per_pixel = spp
    sc.perf.max_bounce_depth = depth
    sc.perf.resolution_scale = 1.0
    sc.perf.enable_denoiser = False
    return sc


def _engine_hdr(sc, spp, depth, frames):
    """Average `frames` independent linear-HDR traces of the port's
    ``trace_frame`` (RR off, unsplit, camera NEE on)."""
    sc._ensure_device_state()
    rh, rw = sc.render_size
    acc = None
    for k in range(frames):
        state, bufs = pipeline.trace_frame(
            sc._geom, sc._mat_table, sc._light_table, len(sc.lights),
            sc.sky(), sc.camera, sc._rng_state, k, rw, rh, spp, depth,
            sc._blue_noise, split=False, rr_enabled=False, rr_start=2,
            camera_nee=True)
        sc._rng_state = state
        c = torch.stack([bufs.color.x, bufs.color.y, bufs.color.z],
                        dim=-1).numpy().astype(np.float64)
        acc = c if acc is None else acc + c
    return acc / frames


def _psnr(a, b):
    peak = max(float(a.max()), 1e-6)
    mse = float(np.mean((a - b) ** 2))
    return 10.0 * np.log10(peak * peak / max(mse, 1e-20))


# ---------------------------------------------------------------------------


class TestCrossReference:
    def test_point_light_direct_analytic(self):
        """Depth-1 direct lighting vs the closed-form image: no Monte Carlo
        on either side beyond sub-pixel jitter."""
        w, h, spp = 48, 36, 8
        groups = [_cornell_tris()[0][:2]]  # floor quad only
        mats = [_MATS[0]]
        sc = Scene(w, h, device="cpu")
        sc.add_triangles(groups[0], Material(albedo=mats[0]["albedo"],
                                             roughness=1.0,
                                             specular=(0.04, 0.04, 0.04)))
        sc.add_point_light(_LIGHT["pos"], _LIGHT["color"], _LIGHT["intensity"],
                           range=_LIGHT["range"], radius=0.0)
        sc.set_sky_enabled(False)
        sc.set_camera((0.0, 1.4, 2.9), (0.0, 0.0, 0.0), fov=_CAM["vfov"])
        sc.perf.samples_per_pixel = spp
        sc.perf.max_bounce_depth = 1
        sc.perf.resolution_scale = 1.0
        sc.perf.enable_denoiser = False
        img = _engine_hdr(sc, spp, 1, frames=2)

        # analytic: pixel-center ray, exact NEE formula (delta light)
        scene = _np_scene(groups)
        cam = dict({"from": (0.0, 1.4, 2.9), "at": (0.0, 0.0, 0.0),
                    "vfov": _CAM["vfov"]})
        o, d = _camera_rays(cam, w, h, np.zeros((h, w)), np.zeros((h, w)))
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        t, ti = _intersect(o, d, scene["v0"], scene["e1"], scene["e2"],
                           1e-4, np.full(len(o), 1e30))
        hitm = np.isfinite(t)
        t = np.where(hitm, t, 0.0)
        p = o + d * t[:, None]
        ng = _norm(np.cross(scene["e1"][ti], scene["e2"][ti]))
        front = _dot(d, ng) < 0.0
        n = np.where(front[:, None], ng, -ng)
        lpos = np.asarray(_LIGHT["pos"], np.float32)
        tol = lpos[None] - p
        dist = np.linalg.norm(tol, axis=1)
        l = tol / dist[:, None]
        att = (_LIGHT["range"] / (_LIGHT["range"] + dist)) ** 2
        f_cos, pdf_b = _opaque_eval(n, l, -d, scene["albedo"][[0] * len(o)],
                                    scene["f0"][[0] * len(o)],
                                    scene["rough"][[0] * len(o)])
        mis = 1.0 / (1.0 + pdf_b * pdf_b + 1e-10)
        lrad = np.asarray(_LIGHT["color"], np.float32) * _LIGHT["intensity"]
        ana = f_cos * lrad[None] * att[:, None] * mis[:, None]
        ana[~hitm] = 0.0
        ana = ana.reshape(h, w, 3)

        # compare on hit pixels whose whole pixel footprint is floor
        hitmask = hitm.reshape(h, w)
        core = hitmask & np.roll(hitmask, 1, 0) & np.roll(hitmask, -1, 0)
        rel = np.abs(img - ana).sum(-1) / np.maximum(ana.sum(-1), 1e-4)
        assert float(np.median(rel[core])) < 0.02, float(
            np.median(rel[core]))
        assert _psnr(ana, np.where(core[..., None], img, ana)) > 38.0

    def test_numpy_tracer_agrees_gi_reduced(self):
        """Depth-3 GI at 24x24 and 64 samples a side: the tier-1 cut of
        ``test_numpy_tracer_agrees_gi`` (limits in the module's note)."""
        w, h = 24, 24
        depth = 3
        groups = _cornell_tris()
        sc = _engine_scene(groups, w, h, 16, depth)
        img_engine = _engine_hdr(sc, 16, depth, frames=4)  # 64 samples

        scene = _np_scene(groups)
        img_np = _np_trace(scene, _CAM, w, h, 64, depth,
                           np.random.default_rng(7))
        psnr = _psnr(img_np, img_engine)
        assert psnr > 24.0, f"cross-implementation PSNR {psnr:.1f} dB"
        e1 = float(img_engine.mean())
        e2 = float(img_np.mean())
        assert abs(e1 - e2) / max(e2, 1e-9) < 0.04, (e1, e2)

    @pytest.mark.slow  # minutes: 384-sample renders on both sides
    def test_numpy_tracer_agrees_gi(self):
        """Depth-3 GI: engine vs the independent numpy tracer."""
        w, h = 40, 30
        depth = 3
        groups = _cornell_tris()
        sc = _engine_scene(groups, w, h, 16, depth)
        img_engine = _engine_hdr(sc, 16, depth, frames=24)  # 384 samples

        scene = _np_scene(groups)
        rng = np.random.default_rng(7)
        img_np = _np_trace(scene, _CAM, w, h, 384, depth, rng)

        psnr = _psnr(img_np, img_engine)
        # independent MC estimators, 384 samples each: agreement is bounded
        # by noise (~sqrt(2)*sigma/sqrt(N)); a pdf/cosine/MIS bug costs
        # 10-30% energy and craters this number
        assert psnr > 28.0, f"cross-implementation PSNR {psnr:.1f} dB"
        # and the mean image energy must agree closely (bias check)
        e1 = float(img_engine.mean())
        e2 = float(img_np.mean())
        assert abs(e1 - e2) / max(e2, 1e-9) < 0.03, (e1, e2)

    @pytest.mark.slow  # ~3 min: 384-sample renders on both sides
    def test_numpy_tracer_agrees_glass(self):
        """Transmissive branch: a glass sphere (GGX refraction, TIR,
        Schlick dielectric lobe selection, Beer-Lambert interior
        absorption) inside the Cornell box — the full trans-case f/pdf
        accumulation of ``material_scatter`` mirrored independently.
        Glass is where radiometry bugs hide (wrong eta, missing
        |NdotL|, bad half-vector flip all shift energy 10%+)."""
        w, h = 36, 27
        depth = 5
        sph = Mesh.sphere(10, radius=0.45)
        sph.transform.set_position(-0.25, 0.55, 0.15)
        va, vb, vc = sph.triangle_arrays(world=True)
        sphere_tris = np.stack([va, vb, vc], axis=1).astype(np.float32)
        groups = _cornell_tris()[:3] + [sphere_tris]
        mats = _MATS[:3] + [dict(albedo=(0.9, 0.95, 0.98), rough=0.05,
                                 trans=1.0, ior=1.5)]

        sc = _engine_scene(groups, w, h, 16, depth, mats=mats)
        img_engine = _engine_hdr(sc, 16, depth, frames=24)

        scene = _np_scene(groups, mats=mats)
        img_np = _np_trace(scene, _CAM, w, h, 384, depth,
                           np.random.default_rng(3))
        psnr = _psnr(img_np, img_engine)
        assert psnr > 25.0, f"glass cross PSNR {psnr:.1f} dB"
        e1 = float(img_engine.mean())
        e2 = float(img_np.mean())
        assert abs(e1 - e2) / max(e2, 1e-9) < 0.05, (e1, e2)

    @pytest.mark.slow  # ~2 min: 384-sample renders on both sides
    def test_numpy_tracer_agrees_area_light(self):
        """Rect area light (the engine's solid-angle quad sampling is an
        IMPROVEMENT over the reference's Area->Point degradation,
        ``PTRTtransfer.cuh:1833`` — so it cannot be validated against the
        reference at all; the independent estimator is the only check)."""
        w, h = 40, 30
        depth = 2
        groups = _cornell_tris()
        sc = _engine_scene(groups, w, h, 16, depth, area=True)
        img_engine = _engine_hdr(sc, 16, depth, frames=24)

        scene = _np_scene(groups, area=True)
        img_np = _np_trace(scene, _CAM, w, h, 384, depth,
                           np.random.default_rng(11))
        psnr = _psnr(img_np, img_engine)
        assert psnr > 26.0, f"area-light cross PSNR {psnr:.1f} dB"
        e1 = float(img_engine.mean())
        e2 = float(img_np.mean())
        assert abs(e1 - e2) / max(e2, 1e-9) < 0.04, (e1, e2)
