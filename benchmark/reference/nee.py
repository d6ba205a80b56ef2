"""Next-event estimation: direct-light and env-map sampling with shadow rays.

Counterpart of ``ptrt_tpu/render/nee.py`` (``sample_light``,
``sample_direct_lighting``, ``sample_env_lighting``): uniform light pick,
cone sampling of spherical lights, range attenuation, smooth spot cones,
rect area lights, the HDRI's alias-method sample, and the shadow rays
through the any-hit walk (K2).  Each estimate is cut in two around its
walk: a setup part (the PCG draws, the shadow ray and the unshadowed,
clamped contribution) and a lit part (the walk's answer and the pdf
gate)."""

from __future__ import annotations

import torch

from benchmark.reference import rng as prng
from benchmark.reference.vec import (TWO_PI, Vec3, clamp_vector_soft, fmax,
                                     fmin, sdiv, where)
from benchmark.reference.bsdf import evaluate_bsdf, evaluate_bsdf_split
from benchmark.reference.sky import SkyConfig, sample_env
from benchmark.reference.lights import LightTable, LightType

MAX_NEE_CONTRIBUTION = 500.0


def sample_light(state, lights: LightTable, n_lights: int, point: Vec3):
    """Pick one light uniformly and sample a direction to it.

    Returns (state, L, pdf_sample, radiance, attenuation, light_dist)."""
    state, r = prng.uniform(state)
    r = fmin(r, 0.99999994)
    li = (r * n_lights).to(torch.int64)

    row = lights.packed[li]
    ltype = row[..., 0].to(torch.int32)
    lpos = Vec3(row[..., 1], row[..., 2], row[..., 3])
    ldir = Vec3(row[..., 4], row[..., 5], row[..., 6])
    lcol = Vec3(row[..., 7], row[..., 8], row[..., 9])
    lint = row[..., 10]
    lrange = row[..., 11]
    linner = row[..., 12]
    louter = row[..., 13]
    lradius = row[..., 14]
    lwidth = row[..., 15]
    lheight = row[..., 16]

    pdf_pick = 1.0 / float(n_lights)
    radiance = lcol * lint

    to_light = lpos - point
    dist_sq = fmax(to_light.length_squared(), 1e-12)
    dist = torch.sqrt(dist_sq)
    l_point = to_light * (1.0 / dist)

    # soft-shadow cone sample for radius > 0
    sin2 = fmin(lradius * lradius / dist_sq, 0.9999)
    cos_max = torch.sqrt(1.0 - sin2)
    state, l_cone = prng.sample_cone_direction(state, l_point, cos_max)
    solid_angle = TWO_PI * (1.0 - cos_max)
    pdf_cone = torch.where(solid_angle > 1e-6, sdiv(pdf_pick, solid_angle),
                           pdf_pick)

    soft = lradius > 0.0
    l_local = where(soft, l_cone, l_point)
    pdf_local = torch.where(soft, pdf_cone, pdf_pick)

    # rect area lights: uniform point on the rect, solid-angle pdf
    state, ua, va = prng.uniform2(state)
    tb_u, tb_v = prng.ortho_normal_basis(ldir)
    q = (lpos + tb_u * (lwidth * (ua - 0.5))
         + tb_v * (lheight * (va - 0.5)))
    to_q = q - point
    dist_q_sq = fmax(to_q.length_squared(), 1e-12)
    dist_q = torch.sqrt(dist_q_sq)
    l_area = to_q * (1.0 / dist_q)
    cos_emit = (-l_area).dot(ldir)
    area = fmax(lwidth * lheight, 1e-12)
    pdf_area_sa = pdf_pick * dist_q_sq / (area * fmax(cos_emit, 1e-6))
    is_area = ltype == int(LightType.AREA)
    emits = cos_emit > 1e-6
    l_local = where(is_area, l_area, l_local)
    pdf_local = torch.where(is_area, torch.where(emits, pdf_area_sa, 0.0),
                            pdf_local)
    dist = torch.where(is_area, dist_q, dist)

    att = lrange / (lrange + dist)
    att = att * att

    # spot falloff
    theta = l_local.dot(-ldir)
    eps_cone = linner - louter
    spot_smooth = torch.clamp((theta - louter) / torch.where(
        torch.abs(eps_cone) < 1e-12, 1.0, eps_cone), 0.0, 1.0)
    spot_hard = torch.where(theta >= louter, 1.0, 0.0)
    spot = torch.where(eps_cone <= 1e-6, spot_hard, spot_smooth)
    att = att * torch.where(ltype == int(LightType.SPOT), spot, 1.0)

    is_dir = ltype == int(LightType.DIRECTIONAL)
    l_out = where(is_dir, -ldir, l_local)
    pdf_out = torch.where(is_dir, pdf_pick, pdf_local)
    att_out = torch.where(is_dir, 1.0, att)
    dist_out = torch.where(is_dir, 1e30, dist)
    return state, l_out, pdf_out, radiance, att_out, dist_out


def _contribution(normal, front_face, mat, l, v, radiance, scale, split):
    """The clamped, unshadowed estimate ``bsdf * radiance * scale`` (a
    (diffuse, specular) pair when ``split``)."""
    if split:
        bd, bs = evaluate_bsdf_split(normal, front_face, mat, l, v)
        return (clamp_vector_soft(bd * radiance * scale, MAX_NEE_CONTRIBUTION),
                clamp_vector_soft(bs * radiance * scale, MAX_NEE_CONTRIBUTION))
    bsdf = evaluate_bsdf(normal, front_face, mat, l, v)
    return clamp_vector_soft(bsdf * radiance * scale, MAX_NEE_CONTRIBUTION)


def direct_lighting_setup(state, point: Vec3, normal: Vec3, front_face, mat,
                          ray_dir: Vec3, lights: LightTable, n_lights: int,
                          split: bool = False, active=None):
    """The half of ``sample_direct_lighting`` before the shadow walk.

    Returns (state, L, pdf, shadow origin, shadow t_max, contribution): the
    contribution is the clamped, unshadowed estimate (a Vec3, or a
    (diffuse, specular) pair when ``split``); ``direct_lighting_lit`` masks
    it with the walk's answer."""
    v = -ray_dir
    state, l, pdf_sample, radiance, att, dist = sample_light(
        state, lights, n_lights, point)

    offset = where(normal.dot(l) > 0.0, normal * 1e-4, normal * -1e-4)
    shadow_o = point + offset
    shadow_t = dist - 1e-3
    if active is not None:
        shadow_t = torch.where(active, shadow_t, -1.0)

    scale = att / fmax(pdf_sample, 1e-12)
    out = _contribution(normal, front_face, mat, l, v, radiance, scale, split)
    return state, l, pdf_sample, shadow_o, shadow_t, out


def direct_lighting_lit(contribution, pdf, in_shadow):
    """The unshadowed contribution where the light is visible and its pdf
    positive, else zero (a Vec3 or a (diffuse, specular) pair)."""
    lit = ~in_shadow & (pdf > 0.0)
    if isinstance(contribution, tuple):
        return tuple(where(lit, c, 0.0) for c in contribution)
    return where(lit, contribution, 0.0)


def env_lighting_setup(state, point: Vec3, normal: Vec3, front_face, mat,
                       ray_dir: Vec3, sky: SkyConfig, split: bool = False,
                       active=None):
    """The half of the reference's ``sample_env_lighting`` before the
    shadow walk: the env sample through the alias table (four PCG draws),
    its shadow ray (``t_max = 1e28``; -1 where ``active`` is false) and the
    unshadowed contribution ``bsdf * radiance / max(pdf, 1e-12)``,
    soft-clamped.  Returns (state, L, pdf, shadow origin, shadow t_max,
    contribution); ``env_lighting_lit`` masks it with the walk's answer."""
    v = -ray_dir
    state, l, pdf_sa, radiance = sample_env(state, sky)
    offset = where(normal.dot(l) > 0.0, normal * 1e-4, normal * -1e-4)
    shadow_o = point + offset
    shadow_t = torch.full_like(pdf_sa, 1e28)
    if active is not None:
        shadow_t = torch.where(active, shadow_t, -1.0)
    scale = sdiv(1.0, fmax(pdf_sa, 1e-12))
    out = _contribution(normal, front_face, mat, l, v, radiance, scale, split)
    return state, l, pdf_sa, shadow_o, shadow_t, out


def env_lighting_lit(contribution, pdf, in_shadow):
    """The unshadowed env contribution where the sample is visible and its
    pdf above 1e-12, else zero."""
    lit = ~in_shadow & (pdf > 1e-12)
    if isinstance(contribution, tuple):
        return tuple(where(lit, c, 0.0) for c in contribution)
    return where(lit, contribution, 0.0)


def sample_env_lighting(state, point: Vec3, normal: Vec3, front_face, mat,
                        ray_dir: Vec3, sky: SkyConfig, any_hit_fn,
                        split: bool = False, active=None):
    """One-sample env-map NEE through the alias table: ``env_lighting_setup``,
    the shadow walk ``any_hit_fn(origin, direction, t_max) -> bool``, then
    ``env_lighting_lit``.  Returns (state, L, pdf, contribution) with the
    contribution a Vec3, or a (diffuse, specular) pair when ``split``; the
    caller does the MIS weighting, as for ``sample_direct_lighting``."""
    state, l, pdf_sa, shadow_o, shadow_t, out = env_lighting_setup(
        state, point, normal, front_face, mat, ray_dir, sky, split=split,
        active=active)
    in_shadow = any_hit_fn(shadow_o, l, shadow_t)
    return state, l, pdf_sa, env_lighting_lit(out, pdf_sa, in_shadow)


def sample_direct_lighting(state, point: Vec3, normal: Vec3, front_face, mat,
                           ray_dir: Vec3, lights: LightTable, n_lights: int,
                           any_hit_fn, split: bool = False, active=None):
    """One-sample NEE estimate.

    ``any_hit_fn(origin, direction, t_max) -> bool`` is the shadow walk.
    ``active`` masks lanes that need NEE: the others get ``t_max = -1`` so
    their shadow rays are dead lanes.  Returns (state, L, pdf, contribution)
    with the contribution a Vec3, or a (diffuse, specular) pair when
    ``split``.
    """
    state, l, pdf_sample, shadow_o, shadow_t, out = direct_lighting_setup(
        state, point, normal, front_face, mat, ray_dir, lights, n_lights,
        split=split, active=active)
    in_shadow = any_hit_fn(shadow_o, l, shadow_t)
    return state, l, pdf_sample, direct_lighting_lit(out, pdf_sample,
                                                     in_shadow)
