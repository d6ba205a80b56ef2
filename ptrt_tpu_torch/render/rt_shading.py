"""RT backend shading: one-bounce real-time PBR lighting, and K10.

Counterpart of ``ptrt_tpu/render/rt_shading.py``: ambient + per-light GGX
(isotropic or anisotropic, iridescence tint, sheen, the subsurface wrap,
clearcoat) + analytic shadows, and the glass branch that recurses exactly
one level (a reflection ray and a refraction ray, each walked and shaded
once more; Beer–Lambert as ``pow(albedo, dist)``).

The plain functions (``build_tangent_frame`` ... ``shade_primary``) are the
reference's, term for term, in plain torch; ``shade_core`` and
``shade_primary`` take the reference's ``closest_fn`` / ``any_hit_fn``
seams.  The uint32 hash and LCG run in int64 masked to 32 bits.

The frame runs as stages around the walks (K1 ``closest_hit``, K2
``any_hit``), each a wrapper that launches its hand-written kernel of
``csrc/rt_shade.cu`` (K10) for CUDA tensors and runs its plain version for
CPU tensors, with no fallback between the two:

* ``rt_light_rays`` — the hit record from K1's triangle slot (point,
  face-forwarded normal, front flag) and the shadow ray of every light for
  every lane, light-major (ray ``i * N + lane``), ``t_max = -1`` where the
  lane missed, so ONE K2 launch walks the shadow rays of all lights;
* ``rt_shade`` — ``shade_core`` given K2's occlusion bits, or the sky on a
  miss;
* ``rt_glass_rays`` — the G glass lanes listed in lane order, and for
  each a reflection ray (rays 0..G-1) and a refraction ray (G..2G-1), each
  GGX-perturbed from the hit point's hash seed, with its seed and an (N,)
  plane of every lane's place in the list (-1 off glass);
* ``rt_resolve`` — the glass terms (Beer–Lambert, the Fresnel mix) added to
  the primary colour, then Reinhard, ``pow(·, 0.4545454545)``, ``*255``
  truncated to RGB8, rows flipped; on the card the encode after Reinhard is
  a table built from the plain encode (``encode_lut``).

A frame: camera rays -> K1 -> ``rt_light_rays`` -> K2 -> ``rt_shade``;
with glass in the scene -> ``rt_glass_rays`` -> K1 (2G rays for the G
glass lanes; none where G = 0) -> ``rt_light_rays`` -> K2 -> ``rt_shade``;
then ``rt_resolve`` (``rt_frame``).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ptrt_tpu_torch import kernels
from ptrt_tpu_torch.core.rng import MASK32
from ptrt_tpu_torch.core.vec import (PI, Vec3, clamp01, cross, fmax, lerp,
                                     normalize, reflect, where)
from ptrt_tpu_torch.render import pipeline, traverse
from ptrt_tpu_torch.render.pbr import (distribution_ggx, fresnel_schlick,
                                       fresnel_schlick_roughness,
                                       geometry_smith)
from ptrt_tpu_torch.scene.lights import LightType, LightTable
from ptrt_tpu_torch.scene.materials import MaterialTable

INV_PI = 1.0 / math.pi
LCG_MUL, LCG_ADD = 747796405, 2891336453
# the frame's tonemap (the reference's Reinhard + gamma 2.2)
GAMMA = 0.4545454545
# RTParams: ambient xyz, sky top xyz, sky bottom xyz, use_sky
PARAMS = 10


def _clamp(v, lo, hi):
    if isinstance(v, Vec3):
        return v.map(lambda c: torch.clamp(c, lo, hi))
    return torch.clamp(v, lo, hi)


def build_tangent_frame(n: Vec3):
    use_z = torch.abs(n.z) < 0.9999
    ref = where(use_z, Vec3(0.0, 0.0, 1.0), Vec3(1.0, 0.0, 0.0))
    t = normalize(cross(ref, n), 1e-20)
    b = cross(n, t)
    return t, b


def anisotropy_to_alpha(roughness, anisotropy):
    r2 = roughness * roughness
    aspect = torch.sqrt(1.0 - 0.9 * torch.abs(anisotropy))
    ax_pos = r2 / aspect
    ay_pos = r2 * aspect
    ax = torch.where(anisotropy >= 0.0, ax_pos, ay_pos)
    ay = torch.where(anisotropy >= 0.0, ay_pos, ax_pos)
    return fmax(ax, 0.001), fmax(ay, 0.001)


def distribution_ggx_aniso(n: Vec3, h: Vec3, t: Vec3, b: Vec3, ax, ay):
    ndoth = n.dot(h)
    tdoth = t.dot(h)
    bdoth = b.dot(h)
    denom = (tdoth * tdoth / (ax * ax)) + (bdoth * bdoth / (ay * ay)) + (
        ndoth * ndoth)
    denom = PI * ax * ay * denom * denom
    d = 1.0 / fmax(denom, 0.001)
    return torch.where(ndoth > 0.0, d, 0.0)


def _g1_aniso(ndotv, tdotv, bdotv, ax, ay):
    lam = torch.sqrt(ax * ax * tdotv * tdotv + ay * ay * bdotv * bdotv
                     + ndotv * ndotv)
    return 2.0 * ndotv / (ndotv + lam + 0.001)


def geometry_smith_aniso(n: Vec3, v: Vec3, l: Vec3, t: Vec3, b: Vec3, ax,
                         ay):
    ndotv = fmax(n.dot(v), 0.0)
    ndotl = fmax(n.dot(l), 0.0)
    return (_g1_aniso(ndotv, t.dot(v), b.dot(v), ax, ay)
            * _g1_aniso(ndotl, t.dot(l), b.dot(l), ax, ay))


def _lcg(seed: torch.Tensor) -> torch.Tensor:
    return (seed * LCG_MUL + LCG_ADD) & MASK32


def perturb_direction_ggx(dir: Vec3, n: Vec3, roughness, seed):
    """GGX cone perturbation with the inline LCG.  ``seed``: int64 values in
    [0, 2^32); it advances twice whether or not the perturbed direction is
    used.  Returns (direction, seed)."""
    seed = _lcg(seed)
    u1 = seed.to(torch.float32) * 2.3283064365386963e-10
    seed = _lcg(seed)
    u2 = seed.to(torch.float32) * 2.3283064365386963e-10

    a = roughness * roughness
    phi = 2.0 * PI * u1
    cos_t = torch.sqrt((1.0 - u2) / (1.0 + (a * a - 1.0) * u2))
    sin_t = torch.sqrt(fmax(1.0 - cos_t * cos_t, 0.0))
    t, b = build_tangent_frame(dir)
    out = normalize(t * (torch.cos(phi) * sin_t) + b * (torch.sin(phi) * sin_t)
                    + dir * cos_t, 1e-20)
    return where(roughness < 0.01, dir, out), seed


def beer_lambert_rt(trans_rgb: Vec3, dist) -> Vec3:
    """pow(t, dist) form."""
    t = _clamp(trans_rgb, 0.0, 1.0)
    return t.map(lambda c: torch.pow(c, dist))


def sample_sky_rt(dir: Vec3, top: Vec3, bottom: Vec3, use_sky) -> Vec3:
    t = 0.5 * (dir.y + 1.0)
    return lerp(bottom, top, t) * use_sky


def _hash_seed(p: Vec3) -> torch.Tensor:
    """The float bits of ``p.x*12.9898 + p.y*78.233 + p.z*45.164`` (float32,
    left to right), one LCG step on: int64 values in [0, 2^32)."""
    f = p.x * 12.9898 + p.y * 78.233 + p.z * 45.164
    seed = f.to(torch.float32).view(torch.int32).to(torch.int64) & MASK32
    return _lcg(seed)


def calculate_iridescence(thickness, cos_theta, film_ior: float = 1.3,
                          base_ior: float = 1.5) -> Vec3:
    """``pbr.calculate_iridescence`` with both indices Python floats, as
    the RT shading calls it: ``r_af`` and ``r_fb`` in double, their square
    roots in float32, and their sum rounded once where it is added."""
    c = clamp01(cos_theta)
    sin_theta = torch.sqrt(fmax(1.0 - c * c, 0.0))
    sin_film = sin_theta / film_ior
    tir = sin_film * sin_film > 1.0
    cos_film = torch.sqrt(fmax(1.0 - sin_film * sin_film, 0.0))
    opd = 2.0 * film_ior * thickness * cos_film

    r_af = ((1.0 - film_ior) / (1.0 + film_ior)) ** 2
    r_fb = ((film_ior - base_ior) / (film_ior + base_ior)) ** 2
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=c.device)
    sqrt_r1r2 = torch.sqrt(f32(r_af * r_fb))
    r_max = torch.sqrt(f32(r_af)) + torch.sqrt(f32(r_fb))
    r_max = r_max * r_max
    inv_r_max = 1.0 / (r_max + 1e-6)

    out = []
    for wavelength in (650.0, 550.0, 450.0):
        delta = 2.0 * PI * opd / wavelength
        r_total = r_af + r_fb + 2.0 * sqrt_r1r2 * torch.cos(delta)
        out.append(torch.where(tir, 1.0, torch.clamp(r_total * inv_r_max,
                                                     0.0, 1.0)))
    return Vec3(*out)


def light_vectors(lights: LightTable, i: int, point: Vec3):
    """Light ``i`` seen from ``point``: (its row, the direction to it, the
    distance, whether it is directional).  An area light is shaded as a
    point light, as the reference does."""
    row = lights.packed[i]
    is_dir = row[0] == float(LightType.DIRECTIONAL)
    lpos = Vec3(row[1], row[2], row[3])
    ldir = Vec3(row[4], row[5], row[6])
    to_light = lpos - point
    dist = fmax(torch.sqrt(to_light.length_squared()), 1e-6)
    l_pt = to_light * (1.0 / dist)
    l = where(is_dir, -ldir, l_pt)
    return row, l, dist, is_dir


def shadow_ray(hit, ng: Vec3, l: Vec3, dist, is_dir):
    """The shadow ray of one light: (origin, t_max), as ``shade_core``
    casts it."""
    eps = 1e-3 * fmax(hit.t, 1.0)
    return hit.point + ng * eps, torch.where(is_dir, 1e30, dist)


def shade_core(hit, ray_dir: Vec3, mat, lights: LightTable, n_lights: int,
               ambient: Vec3, sky_top: Vec3, sky_bottom: Vec3, use_sky, geom,
               any_hit_fn) -> Vec3:
    """The reference's ``shade_core``: emission, the ambient term and each
    light's shadowed GGX lobe (``any_hit_fn(origin, l, t_max)`` once a
    light, in order), without the glass branch."""
    v = -ray_dir
    ng = hit.normal
    rough = torch.clamp(mat.roughness, 0.02, 1.0)
    metal = torch.clamp(mat.metallic, 0.0, 1.0)
    is_glass = (mat.transmission > 0.0) & (metal < 0.1)
    f0 = lerp(mat.specular, mat.albedo, metal)

    color = mat.emission

    ndotv = fmax(ng.dot(v), 0.0)
    f_amb = fresnel_schlick_roughness(ndotv, f0, rough)
    kd_amb = (Vec3.full(1.0) - f_amb) * (1.0 - metal)
    kd_amb = where(is_glass, Vec3.full(0.0), kd_amb)
    color = color + kd_amb * mat.albedo * ambient

    t_frame, b_frame = build_tangent_frame(ng)
    ax, ay = anisotropy_to_alpha(rough, mat.anisotropy)

    for i in range(n_lights):
        row, l, dist, is_dir = light_vectors(lights, i, hit.point)
        ltype = row[0]
        ldir = Vec3(row[4], row[5], row[6])
        lcol = Vec3(row[7], row[8], row[9])
        lint, lrange, linner, louter = row[10], row[11], row[12], row[13]

        att = lrange / (lrange + dist)
        att = att * att
        theta = l.dot(-ldir)
        eps_cone = linner - louter
        spot = torch.clamp((theta - louter) / torch.where(
            torch.abs(eps_cone) < 1e-12, 1e-12, eps_cone), 0.0, 1.0)
        att = att * torch.where(ltype == float(LightType.SPOT), spot, 1.0)
        attenuation = torch.where(is_dir, 1.0, att)

        origin, light_dist = shadow_ray(hit, ng, l, dist, is_dir)
        in_shadow = any_hit_fn(origin, l, light_dist)

        h = normalize(l + v, 1e-20)
        ndotl = fmax(ng.dot(l), 0.0)
        vdoth = fmax(v.dot(h), 0.0)

        use_aniso = torch.abs(mat.anisotropy) > 0.01
        d_iso = distribution_ggx(ng, h, rough)
        g_iso = geometry_smith(ng, v, l, rough)
        d_an = distribution_ggx_aniso(ng, h, t_frame, b_frame, ax, ay)
        g_an = geometry_smith_aniso(ng, v, l, t_frame, b_frame, ax, ay)
        d = torch.where(use_aniso, d_an, d_iso)
        g = torch.where(use_aniso, g_an, g_iso)

        f = fresnel_schlick(vdoth, f0)
        irid = calculate_iridescence(mat.iridescence_thickness, vdoth)
        f = where(mat.iridescence > 0.0,
                  lerp(f, f * irid, mat.iridescence), f)

        spec = f * (d * g / (4.0 * ndotv * ndotl + 0.001))

        ks = f
        kd = (Vec3.full(1.0) - ks) * (1.0 - metal)
        diffuse = mat.albedo * INV_PI

        # sheen adds to kD
        x = 1.0 - vdoth
        fh = (x * x) * (x * x) * x
        sheen_color = lerp(Vec3.full(1.0), mat.sheen_tint, fh)
        kd = kd + where(mat.sheen > 0.0,
                        sheen_color * (mat.sheen * (1.0 - metal)),
                        Vec3.full(0.0))

        # subsurface wrap
        sss = fmax(v.dot(-l), 0.0)
        sss = sss * sss * mat.subsurface_radius
        diffuse = where(mat.subsurface_radius > 0.0,
                        lerp(diffuse, mat.subsurface_color * INV_PI, sss),
                        diffuse)

        # thin transmission for glass (the primary shade adds the full
        # glass branch besides)
        thin = (Vec3.full(1.0) - f) * mat.transmission
        kd = where(is_glass, Vec3.full(0.0), kd)
        thin = where(is_glass, thin, Vec3.full(0.0))

        radiance = lcol * (lint * 20.0 * ndotl * attenuation)
        lo = (kd * diffuse + spec + thin) * radiance

        # clearcoat
        cc_d = distribution_ggx(ng, h, mat.clearcoat_roughness)
        cc_g = geometry_smith(ng, v, l, mat.clearcoat_roughness)
        cc_f = fresnel_schlick(vdoth, Vec3.full(0.04))
        cc_brdf = cc_f * (cc_d * cc_g / (4.0 * ndotv * ndotl + 0.001))
        lo_cc = (lo * (Vec3.full(1.0) - cc_f * mat.clearcoat)
                 + cc_brdf * radiance * mat.clearcoat)
        lo = where(mat.clearcoat > 0.0, lo_cc, lo)

        lit = torch.logical_not(in_shadow)
        color = color + where(lit, lo, Vec3.full(0.0))

    return color


def shade_one_bounce(geom, materials: MaterialTable, lights, n_lights,
                     ambient, sky_top, sky_bottom, use_sky, o: Vec3, d: Vec3,
                     closest_fn, any_hit_fn) -> Vec3:
    """Trace and shade once, without recursion; a miss returns the sky."""
    h = closest_fn(o, d)
    mat = materials.gather(fmax(h.mesh_index, 0))
    shaded = shade_core(h, d, mat, lights, n_lights, ambient, sky_top,
                        sky_bottom, use_sky, geom, any_hit_fn)
    sky = sample_sky_rt(d, sky_top, sky_bottom, use_sky)
    return where(h.hit, shaded, sky)


class GlassTerms(NamedTuple):
    """A primary hit's glass branch up to its two rays."""

    is_glass: torch.Tensor
    fr: Vec3  # Schlick's Fresnel of the entry
    eps: torch.Tensor
    r_dir: Vec3  # the (perturbed) reflection direction
    t_dir: Vec3  # the (perturbed) refraction direction
    refr_ok: torch.Tensor  # no total internal reflection
    seed: torch.Tensor  # after both perturbations


def glass_terms(hit, ray_dir: Vec3, mat) -> GlassTerms:
    """The reference's glass branch before its walks: the Fresnel term, the
    reflection direction perturbed first, then the refraction direction
    perturbed from the seed the reflection left."""
    metal = torch.clamp(mat.metallic, 0.0, 1.0)
    is_glass = (mat.transmission > 0.0) & (metal < 0.1)

    i = ray_dir
    nf = hit.normal  # already face-forwarded by traversal
    entering = hit.front_face
    n1 = torch.where(entering, 1.0, mat.ior)
    n2 = torch.where(entering, mat.ior, 1.0)
    eta = n1 / n2

    r0 = (n2 - n1) / (n2 + n1)
    f0s = r0 * r0
    cos_theta = fmax((-i).dot(nf), 0.0)
    fr = fresnel_schlick(cos_theta, Vec3.full(f0s))

    eps = 1e-3 * fmax(hit.t, 1.0)
    seed = _hash_seed(hit.point)

    r_dir = normalize(reflect(i, nf), 1e-20)
    refl_rough = torch.maximum(mat.roughness, mat.transmission_roughness)
    r_pert, seed = perturb_direction_ggx(r_dir, nf, refl_rough, seed)
    r_dir = where(refl_rough > 0.02, r_pert, r_dir)

    ndoti = nf.dot(i)
    k = 1.0 - eta * eta * (1.0 - ndoti * ndoti)
    refr_ok = k >= 0.0
    t_dir = normalize(
        i * eta - nf * (eta * ndoti + torch.sqrt(fmax(k, 0.0))), 1e-20)
    t_pert, seed = perturb_direction_ggx(t_dir, -nf,
                                         mat.transmission_roughness, seed)
    t_dir = where(mat.transmission_roughness > 0.02, t_pert, t_dir)
    return GlassTerms(is_glass, fr, eps, r_dir, t_dir, refr_ok, seed)


def glass_add(g: GlassTerms, mat, r_col: Vec3, behind: Vec3,
              thickness) -> Vec3:
    """The glass branch's colour from its two shades (``behind``: the
    refraction ray's shade, the sky on a miss)."""
    absorb = beer_lambert_rt(_clamp(mat.albedo, 0.0, 1.0), thickness)
    t_col = where(g.refr_ok, absorb * behind, Vec3.full(0.0))
    fr = where(g.refr_ok, g.fr, Vec3.full(1.0))
    add = fr * r_col + (Vec3.full(1.0) - fr) * mat.transmission * t_col
    return where(g.is_glass, add, Vec3.full(0.0))


def shade_primary(geom, materials: MaterialTable, lights, n_lights: int,
                  ambient: Vec3, sky_top: Vec3, sky_bottom: Vec3, use_sky, hit,
                  ray_dir: Vec3, closest_fn, any_hit_fn,
                  scene_has_glass: bool) -> Vec3:
    """``shade_core`` with the glass branch: a reflection and a refraction
    ray, each traced by ``closest_fn`` and shaded once."""
    mat = materials.gather(fmax(hit.mesh_index, 0))
    color = shade_core(hit, ray_dir, mat, lights, n_lights, ambient, sky_top,
                       sky_bottom, use_sky, geom, any_hit_fn)
    if not scene_has_glass:
        return color
    g = glass_terms(hit, ray_dir, mat)
    nf = hit.normal
    r_col = shade_one_bounce(geom, materials, lights, n_lights, ambient,
                             sky_top, sky_bottom, use_sky,
                             hit.point + nf * g.eps, g.r_dir, closest_fn,
                             any_hit_fn)
    h2 = closest_fn(hit.point - nf * g.eps, g.t_dir)
    thickness = torch.where(h2.hit, h2.t, 1.0)
    mat2 = materials.gather(fmax(h2.mesh_index, 0))
    behind_hit = shade_core(h2, g.t_dir, mat2, lights, n_lights, ambient,
                            sky_top, sky_bottom, use_sky, geom, any_hit_fn)
    behind = where(h2.hit, behind_hit,
                   sample_sky_rt(g.t_dir, sky_top, sky_bottom, use_sky))
    return color + glass_add(g, mat, r_col, behind, thickness)


# -- the frame's stages: plain versions ----------------------------------------


class ShadowRays(NamedTuple):
    """The shadow rays of every light for every lane, light-major (ray
    ``i * N + lane``): flat (L * N,) planes; ``t`` is -1 on a lane that
    missed."""

    o: Vec3
    d: Vec3
    t: torch.Tensor


class GlassRays(NamedTuple):
    """The glass branch's rays of the G glass lanes (lanes that hit a glass
    material): ``lanes`` (G,) int32, the glass lanes in increasing lane
    order; a lane's reflection ray at its place p in ``lanes``, its
    refraction ray at G + p: flat (2G,) planes, ``t`` = T_MAX; ``seed``
    (G,) int64, the seed after both perturbations; ``index`` (N,) int32,
    each lane's place in ``lanes`` or -1 off glass."""

    lanes: torch.Tensor
    o: Vec3
    d: Vec3
    t: torch.Tensor
    seed: torch.Tensor
    index: torch.Tensor


def params_vec(params: torch.Tensor, k: int) -> Vec3:
    return Vec3(params[k], params[k + 1], params[k + 2])


def rt_params(ambient, sky_top, sky_bottom, use_sky: bool,
              device) -> torch.Tensor:
    """The (10,) float32 lighting parameters the stages take: ambient, sky
    top, sky bottom, use_sky."""
    return torch.tensor([*ambient, *sky_top, *sky_bottom,
                         1.0 if use_sky else 0.0], dtype=torch.float32,
                        device=device)


def rt_light_rays_plain(geom, o: Vec3, d: Vec3, k1: traverse.Closest,
                        lights: LightTable, n_lights: int):
    """Plain version of ``rt_light_rays``: (Hit, ShadowRays or None)."""
    hit = traverse.hit_record(geom, o, d, k1)
    if n_lights == 0:
        return hit, None
    os_, ls, ts = [], [], []
    for i in range(n_lights):
        _, l, dist, is_dir = light_vectors(lights, i, hit.point)
        origin, t = shadow_ray(hit, hit.normal, l, dist, is_dir)
        os_.append(origin)
        ls.append(l)
        ts.append(torch.where(hit.hit, t, -1.0))
    cat = lambda vs: Vec3(*[torch.cat([getattr(v, c) for v in vs])
                            for c in "xyz"])
    return hit, ShadowRays(cat(os_), cat(ls), torch.cat(ts))


def rt_shade_plain(hit, d: Vec3, occluded, materials: MaterialTable,
                   lights: LightTable, n_lights: int,
                   params: torch.Tensor) -> Vec3:
    """Plain version of ``rt_shade``: ``shade_core`` with light ``i``'s
    occlusion read from rows ``i * N ...`` of ``occluded``, the sky on a
    miss."""
    n = d.x.shape[0]
    occ = iter([] if n_lights == 0 else occluded.view(n_lights, n))
    mat = materials.gather(fmax(hit.mesh_index, 0))
    ambient, top, bottom = (params_vec(params, k) for k in (0, 3, 6))
    use_sky = params[9]
    shaded = shade_core(hit, d, mat, lights, n_lights, ambient, top, bottom,
                        use_sky, None, lambda o, l, t: next(occ))
    return where(hit.hit, shaded, sample_sky_rt(d, top, bottom, use_sky))


def rt_glass_rays_plain(hit, d: Vec3, materials: MaterialTable) -> GlassRays:
    """Plain version of ``rt_glass_rays``: the glass branch's terms of every
    lane, taken at the glass lanes (``nonzero``'s order)."""
    mat = materials.gather(fmax(hit.mesh_index, 0))
    g = glass_terms(hit, d, mat)
    lanes = torch.nonzero(hit.hit & g.is_glass).squeeze(1)
    index = torch.full(hit.hit.shape, -1, dtype=torch.int32,
                       device=lanes.device)
    index[lanes] = torch.arange(lanes.shape[0], dtype=torch.int32,
                                device=lanes.device)
    at = lambda v: v.map(lambda c: c[lanes])
    nf, point, eps = at(hit.normal), at(hit.point), g.eps[lanes]
    cat = lambda a, b: Vec3(torch.cat([a.x, b.x]), torch.cat([a.y, b.y]),
                            torch.cat([a.z, b.z]))
    o = cat(point + nf * eps, point - nf * eps)
    t = torch.full((2 * lanes.shape[0],), traverse.T_MAX,
                   dtype=torch.float32, device=lanes.device)
    return GlassRays(lanes.to(torch.int32), o, cat(at(g.r_dir), at(g.t_dir)),
                     t, g.seed[lanes], index)


def encode_plain(r: torch.Tensor) -> torch.Tensor:
    """The frame's encode of one plane of Reinhard values r = c / (c + 1):
    ``pow(max(r, 0), 0.4545454545) * 255``, clamped, truncated to uint8."""
    return torch.clamp(torch.pow(fmax(r, 0.0), GAMMA) * 255.0, 0,
                       255).to(torch.uint8)


# rt_resolve's encode table: buckets of the float bits of r in [0, 2] (2.0's
# bits; csrc/rt_shade.cu kLutTop), then a word each for r in (2, inf], r
# negative and r NaN
LUT_TOP = 0x40000000
LUT_BUCKETS = (LUT_TOP >> pipeline.LUT_SHIFT) + 1
_luts: dict = {}


def encode_lut(device) -> torch.Tensor:
    """``rt_resolve``'s encode table, int32 on ``device``: the buckets of
    ``pipeline.encode_lut`` for ``encode_plain`` over [0, 2] (a bucket's
    byte at its start and its one threshold), then three words that hold
    the plain encode's byte, run on ``device``, of 4.0, -1.0 and NaN, for
    r above 2, negative (and -0) and NaN; they hold no threshold.  Kept
    only because ``chip_smoke.py`` finds the kernel equal to the plain
    encode on every float32 colour bit pattern."""
    key = str(device)
    if key not in _luts:
        body = pipeline.encode_lut(device, encode_plain, LUT_TOP)
        rep = torch.tensor([4.0, -1.0, math.nan], device=device)
        special = ((encode_plain(rep).to(torch.int32) << 17)
                   | (1 << pipeline.LUT_SHIFT))
        _luts[key] = torch.cat([body, special]).to(torch.int32)
    return _luts[key]


def encode_lut_plain(r: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    """The byte ``csrc/rt_shade.cu`` reads from ``lut`` for Reinhard values
    ``r`` (any float32): its bucket's byte, plus one at or past the
    bucket's threshold; a special word past the buckets."""
    b = r.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    nan = (b & 0x7FFFFFFF) > 0x7F800000
    k = torch.where(b <= LUT_TOP, b >> pipeline.LUT_SHIFT,
                    torch.where(b <= 0x7F800000, LUT_BUCKETS,
                                torch.where(nan, LUT_BUCKETS + 2,
                                            LUT_BUCKETS + 1)))
    e = lut[k].to(torch.int64)
    return ((e >> 17) + ((b & 0xFFFF) >= (e & 0x1FFFF)).long()).to(
        torch.uint8)


def glass_color_plain(color: Vec3, hit, d: Vec3, materials: MaterialTable,
                      glass: GlassRays, sec_color: Vec3, sec_k1) -> Vec3:
    """The frame's colour with the glass terms added on the glass lanes
    (the glass pass of ``rt_resolve``, in plain torch)."""
    n_glass = glass.lanes.shape[0]
    mat = materials.gather(fmax(hit.mesh_index, 0))
    g = glass_terms(hit, d, mat)
    k = glass.index.clamp_min(0).long()
    k2 = k + n_glass
    thickness = torch.where(sec_k1.slot[k2] >= 0, sec_k1.t[k2], 1.0)
    add = glass_add(g, mat, sec_color.map(lambda c: c[k]),
                    sec_color.map(lambda c: c[k2]), thickness)
    return where(glass.index >= 0, color + add, color)


def rt_resolve_plain(color: Vec3, hit, d: Vec3, materials: MaterialTable,
                     glass: GlassRays | None, sec_color: Vec3 | None,
                     sec_k1, height: int, width: int) -> torch.Tensor:
    """Plain version of ``rt_resolve``: the glass terms added on the glass
    lanes (``sec_color`` is None in a scene without glass or without a
    glass lane), the sky kept on a miss, then the tonemap to (H, W, 3)
    uint8 with the rows flipped.  ``sec_color``: the 2G secondary shades of
    ``glass``' rays; ``sec_k1``: K1's record of them (only the refraction
    rays' t and slot are read)."""
    if sec_color is not None:
        color = glass_color_plain(color, hit, d, materials, glass, sec_color,
                                  sec_k1)
    c = color / (color + 1.0)
    rgb8 = torch.stack([encode_plain(ch) for ch in (c.x, c.y, c.z)], dim=-1)
    return rgb8.view(height, width, 3).flip(0)


# -- K10: the kernels ----------------------------------------------------------

_P = ctypes.c_void_p
_P3 = ctypes.c_void_p * 3


class RtArgs(ctypes.Structure):
    """``struct RtArgs`` of ``csrc/rt_shade.cu``."""

    _fields_ = [
        ("n", ctypes.c_longlong),
        ("mat", _P), ("lights", _P), ("params", _P), ("e1", _P3),
        ("e2", _P3),
        ("n_mats", ctypes.c_int), ("mat_width", ctypes.c_int),
        ("n_light_rows", ctypes.c_int), ("light_width", ctypes.c_int),
        ("n_lights", ctypes.c_int), ("n_slots", ctypes.c_int),
        ("o", _P3), ("d", _P3),
        ("hit_t", _P), ("hit_slot", _P), ("hit_mesh", _P),
        ("hit", _P), ("point", _P3), ("normal", _P3), ("front", _P),
        ("sh_o", _P3), ("sh_d", _P3), ("sh_t", _P), ("occluded", _P),
        ("color", _P3),
        ("g_o", _P3), ("g_d", _P3), ("g_t", _P), ("seed", _P),
        ("lanes", _P), ("index", _P), ("counts", _P),
        ("n_glass", ctypes.c_longlong),
        ("sec_color", _P3), ("sec_t", _P), ("sec_slot", _P),
        ("rgb", _P), ("height", ctypes.c_int), ("width", ctypes.c_int),
        ("lut", _P),
    ]


_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
KERNELS = ("rt_light_rays", "rt_shade", "rt_glass_rays", "rt_resolve",
           "rt_resolve_glass")


def _flat(name: str, v, n: int, dtype, dev) -> list:
    """Check the flat (n,) planes of a Vec3 or tensor; their pointers."""
    comps = [v.x, v.y, v.z] if isinstance(v, Vec3) else [v]
    for k, c in enumerate(comps):
        cname = f"{name}.{'xyz'[k]}" if isinstance(v, Vec3) else name
        kernels.check_tensor(cname, c, dtype, 1, dev)
        if c.shape[0] != n:
            raise ValueError(f"{cname}: length {c.shape[0]} != {n}")
    return [c.data_ptr() for c in comps]


def _set(a: RtArgs, field: str, ptrs: list) -> None:
    setattr(a, field, _P3(*ptrs) if len(ptrs) == 3 else ptrs[0])


def _planes(n: int, dev, dtype, rows: int) -> list:
    return list(torch.empty((rows, n), dtype=dtype, device=dev).unbind(0))


def _tables(a: RtArgs, materials: MaterialTable | None,
            lights: LightTable | None, n_lights: int, dev) -> None:
    """Check the tables a kernel reads and set their pointers."""
    if materials is not None:
        kernels.check_tensor("materials.packed", materials.packed, _F32, 2,
                             dev)
        if materials.packed.shape[0] < 1 or materials.packed.shape[1] < 27:
            raise ValueError("materials.packed: need at least (1, 27)")
        a.mat = materials.packed.data_ptr()
        a.n_mats, a.mat_width = materials.packed.shape
    if n_lights > 0:
        kernels.check_tensor("lights.packed", lights.packed, _F32, 2, dev)
        if (lights.packed.shape[0] < n_lights
                or lights.packed.shape[1] < 14):
            raise ValueError(f"lights.packed: need at least ({n_lights}, 14)")
        a.lights = lights.packed.data_ptr()
        a.n_light_rows, a.light_width = lights.packed.shape
    a.n_lights = int(n_lights)


def _launch(name: str, a: RtArgs, dev) -> None:
    fn = getattr(kernels.get_lib(), f"ptrt_{name}")
    rc = fn(ctypes.addressof(a), kernels.stream_ptr(dev))
    kernels.launches[name] += 1
    kernels.check(rc, name)


def rt_light_rays(geom, o: Vec3, d: Vec3, k1: traverse.Closest,
                  lights: LightTable, n_lights: int):
    """The hit record of K1's answer ``k1`` for the flat rays ``o``, ``d``
    and the shadow rays of every light (kernel ``rt_light_rays``).  Returns
    (Hit, ShadowRays or None without lights); the Hit's ``t``, ``mesh``,
    ``u`` and ``v`` are K1's planes.  On a lane that missed, the point,
    normal and front flag are unspecified on the card and the shadow rays'
    origin and direction too (their ``t`` is -1)."""
    if traverse.iset_of(geom) is not None or k1.inst is not None:
        raise ValueError("rt_light_rays: the RT backend walks one static "
                         "SceneGeometry, not instances")
    dev = geom.device
    kernels.require_supported(dev)
    n = k1.t.shape[0]
    a = RtArgs()
    for name, v, dt in (("o", o, _F32), ("d", d, _F32)):
        _set(a, name, _flat(name, v, n, dt, dev))
    for name, field, v, dt in (("k1.t", "hit_t", k1.t, _F32),
                               ("k1.slot", "hit_slot", k1.slot, _I32),
                               ("k1.mesh", "hit_mesh", k1.mesh, _I32)):
        _set(a, field, _flat(name, v, n, dt, dev))
    _tables(a, None, lights, n_lights, dev)
    if dev.type == "cpu":
        return rt_light_rays_plain(geom, o, d, k1, lights, n_lights)
    m = geom.num_tri_slots
    _set(a, "e1", _flat("geom.e1", geom.e1, m, _F32, dev))
    _set(a, "e2", _flat("geom.e2", geom.e2, m, _F32, dev))
    a.n_slots = m
    a.n = n
    found, front = _planes(n, dev, _BOOL, 2)
    f = _planes(n, dev, _F32, 6)
    point, normal = Vec3(*f[0:3]), Vec3(*f[3:6])
    _set(a, "hit", [found.data_ptr()])
    _set(a, "front", [front.data_ptr()])
    _set(a, "point", [c.data_ptr() for c in f[0:3]])
    _set(a, "normal", [c.data_ptr() for c in f[3:6]])
    rays = None
    if n_lights > 0:
        s = _planes(n_lights * n, dev, _F32, 7)
        rays = ShadowRays(Vec3(*s[0:3]), Vec3(*s[3:6]), s[6])
        _set(a, "sh_o", [c.data_ptr() for c in s[0:3]])
        _set(a, "sh_d", [c.data_ptr() for c in s[3:6]])
        _set(a, "sh_t", [s[6].data_ptr()])
    _launch("rt_light_rays", a, dev)
    hit = traverse.Hit(hit=found, t=k1.t, point=point, normal=normal,
                       front_face=front, mesh_index=k1.mesh, u=k1.u, v=k1.v)
    return hit, rays


def _hit_args(a: RtArgs, hit, d: Vec3, n: int, dev) -> None:
    for name, field, v, dt in (("hit.hit", "hit", hit.hit, _BOOL),
                               ("hit.t", "hit_t", hit.t, _F32),
                               ("hit.point", "point", hit.point, _F32),
                               ("hit.normal", "normal", hit.normal, _F32),
                               ("hit.front_face", "front", hit.front_face,
                                _BOOL),
                               ("hit.mesh_index", "hit_mesh", hit.mesh_index,
                                _I32), ("d", "d", d, _F32)):
        _set(a, field, _flat(name, v, n, dt, dev))


def rt_shade(hit, d: Vec3, occluded, materials: MaterialTable,
             lights: LightTable, n_lights: int,
             params: torch.Tensor) -> Vec3:
    """``shade_core`` of every lane given K2's answer ``occluded`` for
    ``rt_light_rays``' shadow rays (None without lights), the sky on a miss
    (kernel ``rt_shade``).  Returns the colour, flat (N,) planes."""
    dev = d.x.device
    kernels.require_supported(dev)
    n = d.x.shape[0]
    a = RtArgs()
    _hit_args(a, hit, d, n, dev)
    kernels.check_tensor("params", params, _F32, 1, dev)
    if params.shape[0] != PARAMS:
        raise ValueError(f"params: need ({PARAMS},)")
    if n_lights > 0:
        _set(a, "occluded", _flat("occluded", occluded, n_lights * n, _BOOL,
                                  dev))
    _tables(a, materials, lights, n_lights, dev)
    if dev.type == "cpu":
        return rt_shade_plain(hit, d, occluded, materials, lights, n_lights,
                              params)
    a.n = n
    a.params = params.data_ptr()
    c = _planes(n, dev, _F32, 3)
    _set(a, "color", [p.data_ptr() for p in c])
    _launch("rt_shade", a, dev)
    return Vec3(*c)


def rt_glass_rays(hit, d: Vec3, materials: MaterialTable) -> GlassRays:
    """The glass lanes and their reflection and refraction rays (kernel
    ``rt_glass_rays``, one launch), as ``GlassRays`` says.  On the card it
    reads G to the host once (the frame's one read) to size the records."""
    dev = d.x.device
    kernels.require_supported(dev)
    n = d.x.shape[0]
    a = RtArgs()
    _hit_args(a, hit, d, n, dev)
    _tables(a, materials, None, 0, dev)
    if dev.type == "cpu":
        return rt_glass_rays_plain(hit, d, materials)
    a.n = n
    g = _planes(2 * n, dev, _F32, 7)  # room for every lane's two rays
    lanes, index = _planes(n, dev, _I32, 2)
    seed = torch.empty(n, dtype=torch.int64, device=dev)
    counts = torch.empty(1 + (n + 255) // 256, dtype=_I32, device=dev)
    _set(a, "g_o", [c.data_ptr() for c in g[0:3]])
    _set(a, "g_d", [c.data_ptr() for c in g[3:6]])
    _set(a, "g_t", [g[6].data_ptr()])
    for field, t in (("seed", seed), ("lanes", lanes), ("index", index),
                     ("counts", counts)):
        _set(a, field, [t.data_ptr()])
    _launch("rt_glass_rays", a, dev)
    n_glass = int(counts[0])
    rays = [c[:2 * n_glass] for c in g]
    return GlassRays(lanes[:n_glass], Vec3(*rays[0:3]), Vec3(*rays[3:6]),
                     rays[6], seed[:n_glass], index)


def rt_resolve(color: Vec3, hit, d: Vec3, materials: MaterialTable,
               glass: GlassRays | None, sec_color: Vec3 | None, sec_k1,
               height: int, width: int) -> torch.Tensor:
    """The frame's colour to RGB8: Reinhard, gamma, ``*255`` truncated,
    rows flipped (kernel ``rt_resolve``, every pixel), then on the glass
    lanes ``glass.lanes`` their glass terms from the 2G secondary shades
    ``sec_color`` and K1's record ``sec_k1`` of the glass rays (both None
    without a glass lane), written over their pixels (kernel
    ``rt_resolve_glass``, launched by the same C entry after it).  Returns
    (H, W, 3) uint8.  Without glass shades only ``color`` is read (``hit``,
    ``d`` and ``materials`` may be None)."""
    dev = color.x.device
    kernels.require_supported(dev)
    n = color.x.shape[0]
    if n != height * width:
        raise ValueError(f"{n} lanes are not a {height}x{width} frame")
    if (sec_color is None) != (sec_k1 is None):
        raise ValueError("sec_color and sec_k1 come together")
    if sec_color is not None and (glass is None or materials is None):
        raise ValueError("sec_color needs the glass records and materials")
    a = RtArgs()
    _set(a, "color", _flat("color", color, n, _F32, dev))
    n_glass = 0
    if sec_color is not None:
        _hit_args(a, hit, d, n, dev)
        n_glass = glass.lanes.shape[0]
        _set(a, "lanes", _flat("glass.lanes", glass.lanes, n_glass, _I32,
                               dev))
        _set(a, "sec_color", _flat("sec_color", sec_color, 2 * n_glass, _F32,
                                   dev))
        _set(a, "sec_t", _flat("sec_k1.t", sec_k1.t, 2 * n_glass, _F32, dev))
        _set(a, "sec_slot", _flat("sec_k1.slot", sec_k1.slot, 2 * n_glass,
                                  _I32, dev))
        a.n_glass = n_glass
    _tables(a, materials, None, 0, dev)
    if dev.type == "cpu":
        return rt_resolve_plain(color, hit, d, materials, glass, sec_color,
                                sec_k1, height, width)
    if height > 65535 or n >= 1 << 31:
        raise ValueError(f"rt_resolve: a {height}x{width} frame is past the "
                         "kernel's 65,535 rows or 2^31 pixels")
    a.n = n
    a.height, a.width = height, width
    out = torch.empty((height, width, 3), dtype=torch.uint8, device=dev)
    a.rgb = out.data_ptr()
    a.lut = encode_lut(dev).data_ptr()
    _launch("rt_resolve", a, dev)
    if n_glass > 0:  # the C entry launched rt_resolve_glass after it
        kernels.launches["rt_resolve_glass"] += 1
    return out


def kernel_info(materials: MaterialTable, lights: LightTable,
                n_lights: int) -> dict:
    """{kernel: registers, local-memory bytes a thread, threads a block,
    resident blocks a SM, dynamic shared bytes a block} of the K10 kernels
    with these tables (measurement only; needs the card)."""
    a = RtArgs()
    dev = materials.packed.device
    _tables(a, materials, lights, n_lights, dev)
    out = {}
    for k, name in enumerate(KERNELS):
        vals = [ctypes.c_int() for _ in range(5)]
        rc = kernels.get_lib().ptrt_rt_info(
            k, ctypes.addressof(a), *[ctypes.byref(v) for v in vals])
        kernels.check(rc, f"{name} info")
        out[name] = dict(zip(("registers", "local_bytes", "threads",
                              "blocks_per_sm", "shared_bytes"),
                             (v.value for v in vals)))
    return out


# -- the frame -----------------------------------------------------------------


class RTFrame(NamedTuple):
    """What ``rt_frame`` computed: the image and its stages' records
    (``glass`` None in a scene without glass; the ``sec_*`` records of the
    2G glass rays None without a glass lane)."""

    rgb8: torch.Tensor
    k1: traverse.Closest
    hit: traverse.Hit
    shadow: ShadowRays | None
    occluded: torch.Tensor | None
    color: Vec3
    glass: GlassRays | None
    sec_k1: traverse.Closest | None
    sec_hit: traverse.Hit | None
    sec_shadow: ShadowRays | None
    sec_occluded: torch.Tensor | None
    sec_color: Vec3 | None


def _shade_pass(geom, o, d, t_max, materials, lights, n_lights, params):
    k1 = traverse.closest_hit(geom, o, d, t_max)
    hit, shadow = rt_light_rays(geom, o, d, k1, lights, n_lights)
    occ = (traverse.any_hit(geom, shadow.o, shadow.d, shadow.t)
           if shadow is not None else None)
    color = rt_shade(hit, d, occ, materials, lights, n_lights, params)
    return k1, hit, shadow, occ, color


def rt_frame(geom, materials: MaterialTable, lights: LightTable,
             n_lights: int, params: torch.Tensor, o: Vec3, d: Vec3,
             height: int, width: int, has_glass: bool) -> RTFrame:
    """One RT frame of the flat camera rays ``o``, ``d`` (the pixel grid,
    bottom row first): the primary walk and shade, where the scene has
    glass the glass lanes' rays (2G for G glass lanes) walked and shaded,
    the resolve to RGB8.  With no glass lane in view (G = 0) the glass pass
    is skipped."""
    n = d.x.shape[0]
    t_max = torch.full((n,), traverse.T_MAX, dtype=torch.float32,
                       device=d.x.device)
    k1, hit, shadow, occ, color = _shade_pass(geom, o, d, t_max, materials,
                                              lights, n_lights, params)
    glass = sec = None
    if has_glass:
        glass = rt_glass_rays(hit, d, materials)
        if glass.lanes.shape[0] > 0:
            sec = _shade_pass(geom, glass.o, glass.d, glass.t, materials,
                              lights, n_lights, params)
    rgb8 = rt_resolve(color, hit, d, materials, glass,
                      None if sec is None else sec[4],
                      None if sec is None else sec[0], height, width)
    return RTFrame(rgb8, k1, hit, shadow, occ, color, glass,
                   *(sec if sec is not None else (None,) * 5))
