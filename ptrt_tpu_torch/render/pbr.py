"""Microfacet / Fresnel / thin-film shading primitives — counterpart of
``ptrt_tpu/render/pbr.py``, term for term."""

from __future__ import annotations

import torch

from ptrt_tpu_torch.core.vec import PI, TWO_PI, Vec3, clamp01, fmax


def fresnel_schlick(cos_theta, f0: Vec3) -> Vec3:
    c = clamp01(cos_theta)
    f = 1.0 - c
    f5 = (f * f) * (f * f) * f
    return f0 + (Vec3.full(1.0) - f0) * f5


def fresnel_schlick_roughness(cos_theta, f0: Vec3, roughness) -> Vec3:
    """Schlick's Fresnel with the reflectance ceiling lowered by roughness
    (the ambient term of the RT shading)."""
    c = clamp01(cos_theta)
    f = 1.0 - c
    f5 = (f * f) * (f * f) * f
    mr = 1.0 - roughness
    max_refl = Vec3(fmax(mr, f0.x), fmax(mr, f0.y), fmax(mr, f0.z))
    return f0 + (max_refl - f0) * f5


def distribution_ggx(n: Vec3, h: Vec3, roughness) -> torch.Tensor:
    a = roughness * roughness
    a2 = a * a
    ndoth = fmax(n.dot(h), 0.0)
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    denom = PI * denom * denom
    return a2 / fmax(denom, 1e-6)


def distribution_ggx_fast(ndoth, a2) -> torch.Tensor:
    """GGX D from a precomputed N.H and alpha^2 (no clamps)."""
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    return a2 / (PI * denom * denom + 1e-6)


def geometry_schlick_ggx(ndotv, roughness) -> torch.Tensor:
    r = roughness + 1.0
    k = (r * r) * 0.125
    return ndotv / (ndotv * (1.0 - k) + k + 1e-6)


def geometry_smith(n: Vec3, v: Vec3, l: Vec3, roughness) -> torch.Tensor:
    ndotv = fmax(n.dot(v), 0.0)
    ndotl = fmax(n.dot(l), 0.0)
    return (geometry_schlick_ggx(ndotl, roughness)
            * geometry_schlick_ggx(ndotv, roughness))


def geometry_smith_transmission(n: Vec3, v: Vec3, l: Vec3,
                                roughness) -> torch.Tensor:
    """abs-NdotL Smith for BTDF lobes."""
    ndotv = fmax(n.dot(v), 0.0)
    ndotl = torch.abs(n.dot(l))
    return (geometry_schlick_ggx(ndotl, roughness)
            * geometry_schlick_ggx(ndotv, roughness))


def _f32_sqrt(x: float, like: torch.Tensor) -> torch.Tensor:
    """sqrt of a Python float in float32, as the reference's jnp.sqrt of a
    Python scalar computes it."""
    return torch.sqrt(torch.tensor(x, dtype=torch.float32, device=like.device))


def calculate_iridescence(thickness, cos_theta, film_ior=1.3,
                          base_ior=1.5) -> Vec3:
    """Thin-film interference at 650/550/450 nm."""
    c = clamp01(cos_theta)
    sin_theta = torch.sqrt(fmax(1.0 - c * c, 0.0))
    sin_film = sin_theta / film_ior
    tir = sin_film * sin_film > 1.0
    cos_film = torch.sqrt(fmax(1.0 - sin_film * sin_film, 0.0))
    opd = 2.0 * film_ior * thickness * cos_film

    r_af = ((1.0 - film_ior) / (1.0 + film_ior)) ** 2
    r_fb = ((film_ior - base_ior) / (film_ior + base_ior)) ** 2
    sqrt_r1r2 = torch.sqrt(r_af * r_fb)
    r_max = (_f32_sqrt(r_af, c) + torch.sqrt(r_fb)) ** 2
    inv_r_max = 1.0 / (r_max + 1e-6)

    out = []
    for wavelength in (650.0, 550.0, 450.0):
        delta = TWO_PI * opd / wavelength
        r_total = r_af + r_fb + 2.0 * sqrt_r1r2 * torch.cos(delta)
        out.append(torch.clamp(r_total * inv_r_max, 0.0, 1.0))
    return Vec3(*[torch.where(tir, 1.0, ch) for ch in out])


def schlick_dielectric(cos_theta, ior_i, ior_t) -> torch.Tensor:
    c = clamp01(cos_theta)
    r0 = (ior_i - ior_t) / (ior_i + ior_t)
    r0 = r0 * r0
    f = 1.0 - c
    f5 = (f * f) * (f * f) * f
    return r0 + (1.0 - r0) * f5


def schlick_dielectric_one_ior(cos_theta, ior) -> torch.Tensor:
    """``schlick_dielectric`` from air (ior 1)."""
    return schlick_dielectric(cos_theta, 1.0, ior)


def beer_lambert(absorption: Vec3, dist) -> Vec3:
    """exp(-sigma * t)."""
    c = absorption.map(lambda a: fmax(a, 0.0))
    return (-c * dist).exp()


def log_safe(v: Vec3) -> Vec3:
    """log of each component clamped below at 1e-12."""
    return v.map(lambda c: torch.log(fmax(c, 1e-12)))
