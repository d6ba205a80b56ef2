"""BSDF evaluation, sampling and pdfs — the multi-lobe PBR material model.

Counterpart of ``ptrt_tpu/render/bsdf.py`` (``mis_weight``,
``evaluate_bsdf``, ``evaluate_bsdf_split``, ``material_pdf``,
``material_scatter``), branchless and
term for term: every lobe is evaluated for every lane and masked.  Plain
torch here; on the card the K3 kernels (``csrc/shade.cu``) repeat this
arithmetic operation by operation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import rng as prng
from benchmark.reference.vec import (PI, Vec3, clamp01, fmax, lerp, normalize,
                                     reflect, where)
from benchmark.reference.pbr import (calculate_iridescence, distribution_ggx,
                                       fresnel_schlick, geometry_smith,
                                       geometry_smith_transmission,
                                       schlick_dielectric)

MIN_ROUGH = 0.02


def mis_weight(pdf1, pdf2):
    """Power-2 heuristic."""
    p1 = pdf1 * pdf1
    p2 = pdf2 * pdf2
    return p1 / (p1 + p2 + 1e-10)


def _f0_base(mat, ndotv) -> Vec3:
    """Base F0 with metallic lerp + iridescence modulation."""
    metal = clamp01(mat.metallic)
    f0 = lerp(mat.specular, mat.albedo, metal)
    irid = clamp01(mat.iridescence)
    irid_color = calculate_iridescence(mat.iridescence_thickness, ndotv, 1.3,
                                       mat.ior)
    return where(irid > 0.0, lerp(f0, irid_color, irid), f0)


def evaluate_bsdf(n: Vec3, front_face, mat, l: Vec3, v: Vec3) -> Vec3:
    """Full BSDF eval for NEE; returns f * |NdotL|."""
    ndotv = fmax(n.dot(v), 0.0)
    metal = clamp01(mat.metallic)
    rough = fmax(mat.roughness, MIN_ROUGH)
    trans = clamp01(mat.transmission)
    albedo = mat.albedo
    f0_base = _f0_base(mat, ndotv)

    ndotl_s = n.dot(l)  # signed

    # --- transmissive branch (trans > 0 && metal < 0.1) --------------------
    is_trans = (trans > 0.0) & (metal < 0.1)
    trans_rough = fmax(mat.transmission_roughness, rough)
    eta = torch.where(front_face, 1.0 / mat.ior, mat.ior)

    # reflection side (NdotL > 0)
    h_r = normalize(l + v, 1e-20)
    d_r = distribution_ggx(n, h_r, rough)
    g_r = geometry_smith(n, v, l, rough)
    vdoth_r = fmax(v.dot(h_r), 0.0)
    f_r = fresnel_schlick(vdoth_r, f0_base)
    spec_refl = f_r * (d_r * g_r / (4.0 * ndotv * fmax(ndotl_s, 0.0) + 1e-6))
    trans_refl = spec_refl * fmax(ndotl_s, 0.0)

    # refraction side (NdotL < 0)
    h_t = normalize(-(v * eta + l), 1e-20)
    h_t = where(n.dot(h_t) < 0.0, -h_t, h_t)
    vdoth_t = fmax(v.dot(h_t), 0.0)
    ldoth_t = torch.abs(l.dot(h_t))
    ndotl_abs = torch.abs(ndotl_s)
    k = 1.0 - eta * eta * (1.0 - vdoth_t * vdoth_t)
    d_t = distribution_ggx(n, h_t, trans_rough)
    g_t = geometry_smith_transmission(n, v, l, trans_rough)
    f_fres = fresnel_schlick(vdoth_t, f0_base)
    f_t = Vec3.full(1.0) - f_fres
    numer = eta * eta * (1.0 - metal) * g_t * d_t * vdoth_t * ldoth_t
    denom = ndotv * ndotl_abs * (eta * vdoth_t + ldoth_t) ** 2
    btdf = albedo * f_t * (numer / (denom + 1e-6))
    trans_refr = where(k >= 0.0, btdf * ndotl_abs, 0.0)

    trans_result = where(ndotl_s > 0.0, trans_refl, trans_refr)

    # --- opaque branch -----------------------------------------------------
    ndotl = fmax(ndotl_s, 0.0)
    spec = f_r * (d_r * g_r / (4.0 * ndotv * ndotl + 0.001))
    kd = (Vec3.full(1.0) - f_r) * (1.0 - metal)
    diffuse = kd * albedo * (1.0 / PI)
    opaque_result = (diffuse + spec) * ndotl

    result = where(is_trans, trans_result, opaque_result)
    zero_mask = (ndotv <= 0.0) | (~is_trans & (ndotl_s <= 0.0))
    return where(zero_mask, 0.0, result)


def evaluate_bsdf_split(n: Vec3, front_face, mat, l: Vec3, v: Vec3):
    """Diffuse/specular split of ``evaluate_bsdf`` for the denoiser's
    channels; transmissive lanes route everything to specular.  Returns
    (diffuse, specular), each f * NdotL."""
    full = evaluate_bsdf(n, front_face, mat, l, v)

    ndotv = fmax(n.dot(v), 0.0)
    metal = clamp01(mat.metallic)
    rough = fmax(mat.roughness, MIN_ROUGH)
    trans = clamp01(mat.transmission)
    f0_base = _f0_base(mat, ndotv)
    is_trans = (trans > 0.0) & (metal < 0.1)

    ndotl = fmax(n.dot(l), 0.0)
    h = normalize(l + v, 1e-20)
    vdoth = fmax(v.dot(h), 0.0)
    d = distribution_ggx(n, h, rough)
    g = geometry_smith(n, v, l, rough)
    f = fresnel_schlick(vdoth, f0_base)
    out_spec = f * (d * g / (4.0 * ndotv * ndotl + 0.001)) * ndotl
    kd = (Vec3.full(1.0) - f) * (1.0 - metal)
    out_diff = kd * mat.albedo * (1.0 / PI) * ndotl

    zero = (ndotv <= 0.0) | (ndotl <= 0.0)
    out_spec = where(zero, 0.0, out_spec)
    out_diff = where(zero, 0.0, out_diff)

    # transmissive: all in the specular channel, via the full evaluator
    out_spec = where(is_trans & (ndotv > 0.0), full, out_spec)
    out_diff = where(is_trans, 0.0, out_diff)
    return out_diff, out_spec


def pdf_ggx_reflect(n: Vec3, v: Vec3, l: Vec3, roughness):
    ndotv = fmax(n.dot(v), 0.0)
    h = normalize(v + l, 1e-20)
    ndoth = fmax(n.dot(h), 0.0)
    vdoth = fmax(v.dot(h), 0.0)
    d = distribution_ggx(n, h, roughness)
    pdf = d * ndoth / (4.0 * vdoth + 1e-6)
    return torch.where(ndotv == 0.0, 0.0, pdf)


def pdf_ggx_refract(n: Vec3, v: Vec3, l: Vec3, roughness, ior_ratio):
    ndotv = fmax(n.dot(v), 0.0)
    ndotl = n.dot(l)
    eta = ior_ratio
    h = normalize(-(v * eta + l), 1e-20)
    h = where(n.dot(h) < 0.0, -h, h)
    vdoth = fmax(v.dot(h), 0.0)
    ldoth = torch.abs(l.dot(h))
    ndoth = fmax(n.dot(h), 0.0)
    d = distribution_ggx(n, h, roughness)
    dwh_dwo = (eta * eta * ldoth) / ((eta * vdoth + ldoth) ** 2 + 1e-12)
    pdf = d * ndoth * torch.abs(dwh_dwo)
    return torch.where((ndotv <= 0.0) | (ndotl >= 0.0), 0.0, pdf)


def material_pdf(n: Vec3, front_face, mat, v: Vec3, l: Vec3):
    """Overall scatter pdf for MIS."""
    ndotv = fmax(n.dot(v), 0.0)
    ndotl_s = n.dot(l)
    ndotl = fmax(ndotl_s, 0.0)

    metal = clamp01(mat.metallic)
    rough = fmax(mat.roughness, MIN_ROUGH)
    trans = clamp01(mat.transmission)
    f0_base = _f0_base(mat, ndotv)
    f_base = fresnel_schlick(ndotv, f0_base)

    total = torch.zeros_like(ndotv)

    # clearcoat lobe
    clearcoat = clamp01(mat.clearcoat)
    cc_rough = fmax(mat.clearcoat_roughness, 0.001)
    f_coat = fresnel_schlick(ndotv, Vec3.full(0.04))
    f_coat_avg = (f_coat.x + f_coat.y + f_coat.z) * (1.0 / 3.0)
    has_coat = clearcoat > 0.0
    p_coat = torch.where(has_coat, clamp01(f_coat_avg * clearcoat), 0.0)
    total = total + torch.where(
        has_coat & (ndotl_s > 0.0),
        p_coat * pdf_ggx_reflect(n, v, l, cc_rough), 0.0)
    prob_base = torch.where(has_coat, 1.0 - p_coat, 1.0)

    # transmissive branch
    is_trans = (trans > 0.0) & (metal < 0.1)
    trans_rough = fmax(mat.transmission_roughness, rough)
    ior_ratio = torch.where(front_face, 1.0 / mat.ior, mat.ior)
    reflect_prob = schlick_dielectric(ndotv, 1.0, ior_ratio)

    pdf_reflect = pdf_ggx_reflect(n, v, l, rough)
    h = normalize(v + l, 1e-20)
    vdoth = fmax(v.dot(h), 0.0)
    k = 1.0 - ior_ratio * ior_ratio * (1.0 - vdoth * vdoth)
    pdf_tir = pdf_ggx_reflect(n, v, l, trans_rough)
    trans_pos = prob_base * reflect_prob * pdf_reflect + torch.where(
        k < 0.0, prob_base * (1.0 - reflect_prob) * pdf_tir, 0.0)
    pdf_refract = pdf_ggx_refract(n, v, l, trans_rough, ior_ratio)
    trans_neg = prob_base * (1.0 - reflect_prob) * pdf_refract
    trans_total = total + torch.where(ndotl_s > 0.0, trans_pos, trans_neg)

    # opaque branch
    max_fresnel = f_base.max_component()
    specular_prob = torch.where(metal > 0.0, 1.0, max_fresnel)
    pdf_spec = pdf_ggx_reflect(n, v, l, rough)
    pdf_diff = fmax(ndotl, 0.0) * (1.0 / PI)
    opaque_total = total + torch.where(
        ndotl_s > 0.0,
        prob_base * (specular_prob * pdf_spec
                     + (1.0 - specular_prob) * pdf_diff), 0.0)

    result = torch.where(is_trans, trans_total, opaque_total)
    return torch.where(ndotv == 0.0, 0.0, result)


class ScatterResult(NamedTuple):
    direction: Vec3
    attenuation: Vec3  # f * cos / pdf
    is_specular: torch.Tensor  # bool
    pdf: torch.Tensor
    valid: torch.Tensor  # bool — False = absorbed (path terminates)


def material_scatter(state, n: Vec3, front_face, mat, ray_dir: Vec3):
    """Sample the multi-lobe BSDF.  Returns (rng_state, ScatterResult).

    The lobe id is a per-lane select; one GGX half-vector and one cosine
    sample are drawn from a shared uniform pair."""
    v = -ray_dir
    ndotv = fmax(n.dot(v), 0.0)

    metal = clamp01(mat.metallic)
    rough = fmax(mat.roughness, MIN_ROUGH)
    trans = clamp01(mat.transmission)
    albedo = mat.albedo
    f0_base = _f0_base(mat, ndotv)
    f_base_nv = fresnel_schlick(ndotv, f0_base)

    # clearcoat selection prob
    clearcoat = clamp01(mat.clearcoat)
    cc_rough = fmax(mat.clearcoat_roughness, 0.001)
    f0_coat = Vec3.full(0.04)
    f_coat_nv = fresnel_schlick(ndotv, f0_coat)
    f_coat_avg = (f_coat_nv.x + f_coat_nv.y + f_coat_nv.z) * (1.0 / 3.0)
    p_coat = torch.where(clearcoat > 0.0, clamp01(f_coat_avg * clearcoat),
                         0.0)
    prob_base = 1.0 - p_coat

    is_trans = (trans > 0.0) & (metal < 0.1)
    trans_rough = fmax(mat.transmission_roughness, rough)
    eta = torch.where(front_face, 1.0 / mat.ior, mat.ior)
    ior_i = torch.where(front_face, 1.0, mat.ior)
    ior_t = torch.where(front_face, mat.ior, 1.0)
    reflect_prob = schlick_dielectric(ndotv, ior_i, ior_t)
    p_trans_reflect = prob_base * reflect_prob

    # opaque selection probs
    max_fresnel = f_base_nv.max_component()
    specular_prob = torch.where(metal > 0.0, 1.0, max_fresnel)
    p_opq_spec = prob_base * specular_prob
    p_opq_diff = prob_base * (1.0 - specular_prob)

    # ---- lobe selection ----------------------------------------------------
    state, u = prng.uniform(state)
    state, g1, g2 = prng.uniform2(state)

    # lobe ids: 0 coat-reflect, 1 base-reflect, 2 refract, 3 diffuse, 4 absorb
    lobe_trans = torch.where(
        u < p_coat, 0, torch.where(u < p_coat + p_trans_reflect, 1, 2))
    lobe_opq = torch.where(
        u < p_coat, 0,
        torch.where(u < p_coat + p_opq_spec, 1,
                    torch.where(p_opq_diff > 1e-6, 3, 4)))
    lobe = torch.where(is_trans, lobe_trans, lobe_opq)

    sample_rough = torch.where(lobe == 0, cc_rough,
                               torch.where(lobe == 2, trans_rough, rough))
    h = prng.ggx_half_vector_from(g1, g2, n, sample_rough)
    diffuse_dir = prng.hemisphere_to_world(
        prng.cosine_hemisphere_from(g1, g2), n)

    refl_dir = reflect(-v, h)

    # refraction with H-flip + TIR
    h_refr = where(v.dot(h) < 0.0, -h, h)
    vdoth_tir = torch.abs(v.dot(h_refr))
    k_tir = 1.0 - eta * eta * (1.0 - vdoth_tir * vdoth_tir)
    tir = k_tir < 0.0
    cos_t = torch.sqrt(fmax(k_tir, 0.0))
    refr_dir = normalize((-v) * eta + h_refr * (eta * vdoth_tir - cos_t),
                         1e-20)
    refract_branch_dir = where(tir, reflect(-v, h_refr), refr_dir)

    scattered = where(lobe == 3, diffuse_dir,
                      where(lobe == 2, refract_branch_dir, refl_dir))
    scattered = normalize(scattered, 1e-20)

    is_refraction = (lobe == 2) & ~tir
    is_specular = torch.where(
        lobe == 0, cc_rough < 0.1,
        torch.where(lobe == 1, rough < 0.1,
                    torch.where(lobe == 2, tir | (trans_rough < 0.1),
                                False)))

    ndotl_s = n.dot(scattered)
    ndotl = fmax(ndotl_s, 0.0)
    ndotl_abs = torch.abs(ndotl_s)

    # ---- f/pdf accumulation ------------------------------------------------
    h_refl = normalize(v + scattered, 1e-20)
    ndoth_refl = fmax(n.dot(h_refl), 0.0)
    vdoth_refl = fmax(v.dot(h_refl), 0.0)

    h_rf = normalize(-(v * eta + scattered), 1e-20)
    h_rf = where(n.dot(h_rf) < 0.0, -h_rf, h_rf)
    vdoth_rf = fmax(v.dot(h_rf), 0.0)
    ldoth_rf = torch.abs(scattered.dot(h_rf))
    ndoth_rf = fmax(n.dot(h_rf), 0.0)

    # clearcoat attenuation of the base
    vdoth_for_coat = torch.where(
        is_refraction,
        fmax(v.dot(normalize(v * eta + scattered, 1e-20)), 0.0), vdoth_refl)
    f_coat_atten = fresnel_schlick(vdoth_for_coat, f0_coat)
    base_atten = Vec3.full(1.0) - f_coat_atten * clearcoat

    f_total = Vec3.full(torch.zeros_like(ndotv))
    pdf_total = torch.zeros_like(ndotv)

    # coat lobe (NdotL > 0)
    d_coat = distribution_ggx(n, h_refl, cc_rough)
    g_coat = geometry_smith(n, v, scattered, cc_rough)
    f_coat = fresnel_schlick(vdoth_refl, f0_coat)
    pdf_coat = d_coat * ndoth_refl / (4.0 * vdoth_refl + 1e-6)
    coat_on = (p_coat > 0.0) & (ndotl_s > 0.0)
    pdf_total = pdf_total + torch.where(coat_on, p_coat * pdf_coat, 0.0)
    brdf_coat = f_coat * (d_coat * g_coat / (4.0 * ndotv * ndotl + 1e-6))
    f_total = f_total + where(coat_on, brdf_coat * (clearcoat * ndotl), 0.0)

    # ---------------- transmissive case terms ------------------------------
    # base reflection
    d_refl_t = distribution_ggx(n, h_refl, rough)
    g_refl_t = geometry_smith(n, v, scattered, rough)
    f_refl_t = fresnel_schlick(vdoth_refl, f0_base)
    pdf_refl_t = d_refl_t * ndoth_refl / (4.0 * vdoth_refl + 1e-6)
    refl_on_t = (p_trans_reflect > 0.0) & (ndotl_s > 0.0)
    pdf_t = torch.where(refl_on_t, p_trans_reflect * pdf_refl_t, 0.0)
    brdf_refl_t = f_refl_t * (d_refl_t * g_refl_t
                              / (4.0 * ndotv * ndotl + 1e-6))
    f_t = where(refl_on_t, brdf_refl_t * base_atten * ndotl, 0.0)

    # refraction btdf
    p_trans_refract = prob_base * (1.0 - reflect_prob)
    k_rf = 1.0 - eta * eta * (1.0 - vdoth_rf * vdoth_rf)
    d_rf = distribution_ggx(n, h_rf, trans_rough)
    g_rf = geometry_smith_transmission(n, v, scattered, trans_rough)
    dwh_dwo = (eta * eta * ldoth_rf) / ((eta * vdoth_rf + ldoth_rf) ** 2
                                        + 1e-12)
    pdf_rf = d_rf * ndoth_rf * torch.abs(dwh_dwo)
    refr_on = (p_trans_refract > 0.0) & (ndotl_s < 0.0) & (k_rf >= 0.0)
    pdf_t = pdf_t + torch.where(refr_on, p_trans_refract * pdf_rf, 0.0)
    f_rf_fres = Vec3.full(1.0) - fresnel_schlick(vdoth_rf, f0_base)
    numer_rf = eta * eta * (1.0 - metal) * g_rf * d_rf * vdoth_rf * ldoth_rf
    denom_rf = ndotv * ndotl_abs * (eta * vdoth_rf + ldoth_rf) ** 2
    btdf = albedo * f_rf_fres * (numer_rf / (denom_rf + 1e-6))
    f_t = f_t + where(refr_on, btdf * base_atten * ndotl_abs, 0.0)

    # TIR / refraction-sampled-as-reflection
    d_tirr = distribution_ggx(n, h_refl, trans_rough)
    g_tirr = geometry_smith(n, v, scattered, trans_rough)
    pdf_tirr = d_tirr * ndoth_refl / (4.0 * vdoth_refl + 1e-6)
    tir_on = (lobe == 2) & (ndotl_s > 0.0)
    pdf_t = pdf_t + torch.where(tir_on, p_trans_refract * pdf_tirr, 0.0)
    brdf_tirr = Vec3.full(d_tirr * g_tirr / (4.0 * ndotv * ndotl + 1e-6))
    f_t = f_t + where(tir_on, brdf_tirr * base_atten * ndotl, 0.0)

    # ---------------- opaque case terms ------------------------------------
    pdf_o = p_opq_spec * pdf_refl_t
    f_o = f_refl_t * (d_refl_t * g_refl_t / (4.0 * ndotv * ndotl + 1e-6))
    f_o = f_o * base_atten * ndotl

    # diffuse + sheen
    diff_on = p_opq_diff > 1e-6
    pdf_diff = ndotl * (1.0 / PI)
    pdf_o = pdf_o + torch.where(diff_on, p_opq_diff * pdf_diff, 0.0)
    sheen = clamp01(mat.sheen)
    kd = (Vec3.full(1.0) - f_base_nv) * (1.0 - metal)
    f_diff = kd * albedo * (ndotl / PI)
    fh = 1.0 - fmax(v.dot(h_refl), 0.0)
    fh5 = (fh * fh) * (fh * fh) * fh
    csheen = lerp(Vec3.full(1.0), mat.sheen_tint, 0.5)
    f_diff = f_diff + csheen * (sheen * fh5 * ndotl)
    f_o = f_o + where(diff_on, f_diff * base_atten, 0.0)

    # ---- combine -----------------------------------------------------------
    pdf_total = pdf_total + torch.where(is_trans, pdf_t, pdf_o)
    f_total = f_total + where(is_trans, f_t, f_o)

    pdf_out = torch.where(is_trans, fmax(pdf_total, 1e-6), pdf_total)
    attenuation = f_total / fmax(pdf_total, 1e-6)

    valid = ~(~is_trans & (lobe == 4))
    attenuation = where(valid, attenuation, 0.0)
    return state, ScatterResult(direction=scattered, attenuation=attenuation,
                                is_specular=is_specular & valid, pdf=pdf_out,
                                valid=valid)
