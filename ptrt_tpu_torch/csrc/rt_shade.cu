// rt_light_rays, rt_shade, rt_glass_rays and rt_resolve: the one-bounce RT
// backend's shading (K10), the stages around its walks.
//
// Replaces: the shading of ptrt_tpu/scene/rt_scene.py _rt_frame_program
// (:182-222), which XLA compiles into the fusions of the jitted RT frame:
// render/rt_shading.py shade_core (:111, with its shadow ray a light,
// :163-166), shade_one_bounce (:230) and shade_primary (:243, the glass
// branch :261-305), and the frame's sky, Reinhard, gamma and RGB8 (:207-
// 218).  The JAX package has no Pallas kernel here: this is the port's own
// hand-written kernel for that hot path.  A frame:
//   K1 -> rt_light_rays -> K2 -> rt_shade
//   [glass] -> rt_glass_rays -> K1 (2N rays) -> rt_light_rays -> K2
//           -> rt_shade
//   -> rt_resolve
// (render/rt_shading.py rt_frame).
//
// What bounds them on the card: memory traffic.  A lane's arithmetic is a
// few hundred float operations a light, while each stage reads and writes
// the lane's planes: K1's record (t, slot, mesh), the hit record (flag,
// point, normal, front), the ray direction, the occlusion bits of every
// light, the colour, and rt_light_rays writes 28 bytes of shadow ray a
// light a lane.  The plain torch version runs the same work as several
// hundred elementwise launches a shade, each a round trip of whole planes
// through device memory.
//
// What this design does about it (a first design, right before fast): one
// thread a lane, every intermediate in registers, the material and light
// rows read through the read-only cache (the tables are a few KB), the
// shadow rays of all lights written by one launch so one K2 launch walks
// them, and the hit record rebuilt from K1's slot here, so no torch op runs
// between the kernels.  rt_resolve reads the glass lanes' two secondary
// colours and K1's refraction record and writes RGB8 in flipped rows.
//
// Float order: this file builds with -fmad=false and follows the plain torch
// version operation by operation, including how torch on the card rounds
// scalars: `x / c` for a Python scalar c multiplies by the float reciprocal
// of float(c); `c / x` is (1 / x) * c.  Python-side constants are rounded
// from double, as torch does (F below).  The seed chain (the hash of the hit
// point, then two LCG steps a perturbation, reflection first) is exact.

#include <cuda_runtime.h>
#include <stdint.h>

#define F(x) static_cast<float>(x)

struct RtArgs {
    long long n;               // lanes
    const float* mat;          // (n_mats, mat_width) material rows
    const float* lights;       // (n_light_rows, light_width) light rows
    const float* params;       // ambient xyz, sky top xyz, bottom xyz, use_sky
    const float* e1[3];        // triangle edges by slot (hit normal)
    const float* e2[3];
    int n_mats, mat_width, n_light_rows, light_width;
    int n_lights;              // lights shaded (the light loop's count)
    int n_slots;               // triangle slots of e1 / e2
    const float* o[3];         // rays (rt_light_rays)
    const float* d[3];         // ray directions
    const float* hit_t;        // K1's answer
    const int* hit_slot;
    const int* hit_mesh;
    uint8_t* hit;              // hit record: written by rt_light_rays
    float* point[3];
    float* normal[3];
    uint8_t* front;
    float* sh_o[3];            // shadow rays, light-major: ray j * n + lane
    float* sh_d[3];
    float* sh_t;               // -1 where the lane missed
    const uint8_t* occluded;   // K2's answer for them (rt_shade)
    float* color[3];           // rt_shade's colour (rt_resolve reads it)
    float* g_o[3];             // glass rays: reflection 0..n-1, refraction
    float* g_d[3];             //   n..2n-1 (rt_glass_rays)
    float* g_t;
    int* seed;                 // the seed after both perturbations
    const float* sec_color[3]; // the 2n secondary shades (rt_resolve)
    const float* sec_t;        // K1's record of the glass rays
    const int* sec_slot;
    uint8_t* rgb;              // (height, width, 3), rows flipped
    int height, width;
};

namespace {

constexpr int kThreads = 256;
constexpr float kPi = F(3.141592653589793);
constexpr float kTwoPiD = F(2.0 * 3.141592653589793);   // 2.0 * PI
constexpr float kInvPi = F(1.0 / 3.141592653589793);    // INV_PI
constexpr int kDirectional = 1, kSpot = 2;  // scene/lights.py LightType

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 v3(float s) { return V3{s, s, s}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) {
    return V3{a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
    return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
    return V3{a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 mul(V3 a, float s) {
    return V3{a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 neg(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
    return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x};
}
template <typename P>
__device__ __forceinline__ V3 ld3(const P& p, long long i) {
    return V3{p[0][i], p[1][i], p[2][i]};
}
__device__ __forceinline__ void st3(float* const p[3], long long i, V3 v) {
    p[0][i] = v.x;
    p[1][i] = v.y;
    p[2][i] = v.z;
}

// torch's clamp_min / clamp / maximum: NaN propagates
__device__ __forceinline__ float cmax(float x, float s) {
    return isnan(x) ? x : fmaxf(x, s);
}
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
    return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp01(float x) {
    return clampf(x, 0.0f, 1.0f);
}
__device__ __forceinline__ float tmaximum(float a, float b) {
    return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ V3 normalize(V3 a, float eps) {
    return mul(a, rsqrtf(dot(a, a) + eps));
}
__device__ __forceinline__ V3 reflect(V3 i, V3 n) {
    return sub(i, mul(n, 2.0f * dot(i, n)));
}
__device__ __forceinline__ V3 lerp(V3 a, V3 b, float t) {
    return add(a, mul(sub(b, a), t));
}
__device__ __forceinline__ float lerpf(float a, float b, float t) {
    return a + (b - a) * t;
}

// -- tables -------------------------------------------------------------------

struct Mat {
    V3 albedo, specular, emission, subsurface_color, sheen_tint;
    float metallic, roughness, ior, transmission, transmission_roughness;
    float clearcoat, clearcoat_roughness, subsurface_radius, anisotropy;
    float sheen, iridescence, iridescence_thickness;
};

// scene/materials.py packed row: albedo 0-2, specular 3-5, emission 6-8,
// subsurface_color 9-11, sheen_tint 12-14, then the scalars from 15; the id
// clamped into the table as the plain version's gather clamps it
__device__ Mat fetch_mat(const RtArgs& a, int id) {
    id = min(max(id, 0), a.n_mats - 1);
    const float* r = a.mat + static_cast<long long>(id) * a.mat_width;
    float v[27];
#pragma unroll
    for (int k = 0; k < 27; ++k) v[k] = __ldg(r + k);
    Mat m;
    m.albedo = V3{v[0], v[1], v[2]};
    m.specular = V3{v[3], v[4], v[5]};
    m.emission = V3{v[6], v[7], v[8]};
    m.subsurface_color = V3{v[9], v[10], v[11]};
    m.sheen_tint = V3{v[12], v[13], v[14]};
    m.metallic = v[15];
    m.roughness = v[16];
    m.ior = v[17];
    m.transmission = v[18];
    m.transmission_roughness = v[19];
    m.clearcoat = v[20];
    m.clearcoat_roughness = v[21];
    m.subsurface_radius = v[22];
    m.anisotropy = v[23];
    m.sheen = v[24];
    m.iridescence = v[25];
    m.iridescence_thickness = v[26];
    return m;
}

__device__ __forceinline__ bool is_glass(const Mat& m) {
    return m.transmission > 0.0f && clamp01(m.metallic) < F(0.1);
}

struct LightDir {
    V3 l;
    float dist;
    bool is_dir;
};

// rt_shading.light_vectors: light j seen from the point (an area light is
// shaded as a point light)
__device__ LightDir light_dir(const RtArgs& a, int j, V3 point) {
    const float* r = a.lights + static_cast<long long>(j) * a.light_width;
    LightDir out;
    out.is_dir = __ldg(r) == F(kDirectional);
    const V3 to_light = sub(V3{__ldg(r + 1), __ldg(r + 2), __ldg(r + 3)},
                            point);
    out.dist = cmax(sqrtf(dot(to_light, to_light)), F(1e-6));
    const V3 l_pt = mul(to_light, 1.0f / out.dist);
    out.l = out.is_dir ? neg(V3{__ldg(r + 4), __ldg(r + 5), __ldg(r + 6)})
                       : l_pt;
    return out;
}

// -- render/pbr.py and rt_shading.py -------------------------------------------

__device__ __forceinline__ float pow5(float f) { return (f * f) * (f * f) * f; }
__device__ __forceinline__ V3 fresnel_schlick(float cos_theta, V3 f0) {
    const float f5 = pow5(1.0f - clamp01(cos_theta));
    return add(f0, mul(sub(v3(1.0f), f0), f5));
}
// fresnel_schlick(c, Vec3.full(0.04)): Python computes 1.0 - 0.04 in double
__device__ __forceinline__ float fresnel_coat(float cos_theta) {
    const float f5 = pow5(1.0f - clamp01(cos_theta));
    return f5 * F(1.0 - 0.04) + F(0.04);
}
__device__ __forceinline__ V3 fresnel_schlick_roughness(float cos_theta,
                                                        V3 f0, float rough) {
    const float f5 = pow5(1.0f - clamp01(cos_theta));
    const float mr = 1.0f - rough;
    const V3 max_refl{tmaximum(mr, f0.x), tmaximum(mr, f0.y),
                      tmaximum(mr, f0.z)};
    return add(f0, mul(sub(max_refl, f0), f5));
}
__device__ __forceinline__ float distribution_ggx(V3 n, V3 h, float rough) {
    const float a = rough * rough;
    const float a2 = a * a;
    const float ndoth = cmax(dot(n, h), 0.0f);
    float denom = ndoth * ndoth * (a2 - 1.0f) + 1.0f;
    denom = kPi * denom * denom;
    return a2 / cmax(denom, F(1e-6));
}
__device__ __forceinline__ float schlick_ggx(float ndotv, float rough) {
    const float r = rough + 1.0f;
    const float k = (r * r) * F(0.125);
    return ndotv / (ndotv * (1.0f - k) + k + F(1e-6));
}
__device__ __forceinline__ float geometry_smith(V3 n, V3 v, V3 l,
                                               float rough) {
    const float ndotv = cmax(dot(n, v), 0.0f);
    const float ndotl = cmax(dot(n, l), 0.0f);
    return schlick_ggx(ndotl, rough) * schlick_ggx(ndotv, rough);
}

// calculate_iridescence(thickness, cos_theta) with the reference's defaults
// (film 1.3 on base 1.5, both Python floats): r_af and r_fb in double, their
// square roots in float32, their sum rounded once
__device__ V3 iridescence(float thickness, float cos_theta) {
    constexpr double film = 1.3, base = 1.5;
    constexpr double r_af = ((1.0 - film) / (1.0 + film)) *
                            ((1.0 - film) / (1.0 + film));
    constexpr double r_fb = ((film - base) / (film + base)) *
                            ((film - base) / (film + base));
    const float c = clamp01(cos_theta);
    const float sin_theta = sqrtf(cmax(1.0f - c * c, 0.0f));
    const float sin_film = sin_theta * (1.0f / F(film));
    const bool tir = sin_film * sin_film > 1.0f;
    const float cos_film = sqrtf(cmax(1.0f - sin_film * sin_film, 0.0f));
    const float opd = thickness * F(2.0 * film) * cos_film;
    const float sqrt_r1r2 = sqrtf(F(r_af * r_fb));
    float r_max = sqrtf(F(r_af)) + sqrtf(F(r_fb));
    r_max = r_max * r_max;
    const float inv_r_max = 1.0f / (r_max + F(1e-6));
    float out[3];
    const float wl[3] = {650.0f, 550.0f, 450.0f};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float delta = opd * kTwoPiD * (1.0f / wl[k]);
        const float r_total = sqrt_r1r2 * 2.0f * cosf(delta) + F(r_af + r_fb);
        out[k] = tir ? 1.0f : clamp01(r_total * inv_r_max);
    }
    return V3{out[0], out[1], out[2]};
}

__device__ __forceinline__ void tangent_frame(V3 n, V3& t, V3& b) {
    const bool use_z = fabsf(n.z) < F(0.9999);
    const V3 ref = use_z ? V3{0.0f, 0.0f, 1.0f} : V3{1.0f, 0.0f, 0.0f};
    t = normalize(cross(ref, n), F(1e-20));
    b = cross(n, t);
}
__device__ __forceinline__ float distribution_ggx_aniso(V3 n, V3 h, V3 t,
                                                        V3 b, float ax,
                                                        float ay) {
    const float ndoth = dot(n, h);
    const float tdoth = dot(t, h);
    const float bdoth = dot(b, h);
    float denom = tdoth * tdoth / (ax * ax) + bdoth * bdoth / (ay * ay) +
                  ndoth * ndoth;
    denom = kPi * ax * ay * denom * denom;
    const float d = 1.0f / cmax(denom, F(0.001));
    return ndoth > 0.0f ? d : 0.0f;
}
__device__ __forceinline__ float g1_aniso(float ndotv, float tdotv,
                                          float bdotv, float ax, float ay) {
    const float lam = sqrtf(ax * ax * tdotv * tdotv + ay * ay * bdotv * bdotv +
                            ndotv * ndotv);
    return 2.0f * ndotv / (ndotv + lam + F(0.001));
}

__device__ __forceinline__ V3 sky(const RtArgs& a, V3 d) {
    const float t = (d.y + 1.0f) * 0.5f;
    const V3 top{a.params[3], a.params[4], a.params[5]};
    const V3 bottom{a.params[6], a.params[7], a.params[8]};
    return mul(lerp(bottom, top, t), a.params[9]);
}

__device__ __forceinline__ uint32_t lcg(uint32_t s) {
    return s * 747796405u + 2891336453u;
}

// perturb_direction_ggx: the seed advances twice whether or not the
// perturbed direction is taken
__device__ V3 perturb(V3 dir, float rough, uint32_t& seed) {
    seed = lcg(seed);
    const float u1 = static_cast<float>(seed) * F(2.3283064365386963e-10);
    seed = lcg(seed);
    const float u2 = static_cast<float>(seed) * F(2.3283064365386963e-10);
    const float a = rough * rough;
    const float phi = u1 * kTwoPiD;
    const float cos_t = sqrtf((1.0f - u2) / ((a * a - 1.0f) * u2 + 1.0f));
    const float sin_t = sqrtf(cmax(1.0f - cos_t * cos_t, 0.0f));
    V3 t, b;
    tangent_frame(dir, t, b);
    const V3 out = normalize(add(add(mul(t, cosf(phi) * sin_t),
                                     mul(b, sinf(phi) * sin_t)),
                                 mul(dir, cos_t)),
                             F(1e-20));
    return rough < F(0.01) ? dir : out;
}

// _hash_seed: the float bits of p.x*12.9898 + p.y*78.233 + p.z*45.164, one
// LCG step on
__device__ __forceinline__ uint32_t hash_seed(V3 p) {
    const float f = p.x * F(12.9898) + p.y * F(78.233) + p.z * F(45.164);
    return lcg(__float_as_uint(f));
}

// shade_core of a hit lane, light j's occlusion at occluded[j * n + i]
__device__ V3 shade_core(const RtArgs& a, long long i, V3 d, V3 ng, V3 point,
                         const Mat& m) {
    const V3 v = neg(d);
    const float rough = clampf(m.roughness, F(0.02), 1.0f);
    const float metal = clamp01(m.metallic);
    const bool glass = m.transmission > 0.0f && metal < F(0.1);
    const V3 f0 = lerp(m.specular, m.albedo, metal);

    V3 color = m.emission;
    const float ndotv = cmax(dot(ng, v), 0.0f);
    const V3 f_amb = fresnel_schlick_roughness(ndotv, f0, rough);
    const V3 kd_amb = glass ? v3(0.0f) : mul(sub(v3(1.0f), f_amb),
                                             1.0f - metal);
    const V3 ambient{a.params[0], a.params[1], a.params[2]};
    color = add(color, mul(mul(kd_amb, m.albedo), ambient));

    V3 tf, bf;
    tangent_frame(ng, tf, bf);
    const float r2 = rough * rough;
    const float aspect = sqrtf(1.0f - fabsf(m.anisotropy) * F(0.9));
    const float ax_pos = r2 / aspect, ay_pos = r2 * aspect;
    const float ax = cmax(m.anisotropy >= 0.0f ? ax_pos : ay_pos, F(0.001));
    const float ay = cmax(m.anisotropy >= 0.0f ? ay_pos : ax_pos, F(0.001));
    const bool use_aniso = fabsf(m.anisotropy) > F(0.01);

    for (int j = 0; j < a.n_lights; ++j) {
        if (a.occluded[static_cast<long long>(j) * a.n + i] != 0) continue;
        const float* r = a.lights + static_cast<long long>(j) * a.light_width;
        const LightDir ld = light_dir(a, j, point);
        const V3 l = ld.l;
        const int ltype = static_cast<int>(__ldg(r));
        const V3 ldir{__ldg(r + 4), __ldg(r + 5), __ldg(r + 6)};
        const V3 lcol{__ldg(r + 7), __ldg(r + 8), __ldg(r + 9)};
        const float lint = __ldg(r + 10), lrange = __ldg(r + 11);
        const float linner = __ldg(r + 12), louter = __ldg(r + 13);

        float att = lrange / (lrange + ld.dist);
        att = att * att;
        const float theta = dot(l, neg(ldir));
        const float eps_cone = linner - louter;
        const float spot = clamp01(
            (theta - louter) /
            (fabsf(eps_cone) < F(1e-12) ? F(1e-12) : eps_cone));
        att = att * (ltype == kSpot ? spot : 1.0f);
        const float attenuation = ld.is_dir ? 1.0f : att;

        const V3 h = normalize(add(l, v), F(1e-20));
        const float ndotl = cmax(dot(ng, l), 0.0f);
        const float vdoth = cmax(dot(v, h), 0.0f);

        float dd, g;
        if (use_aniso) {
            dd = distribution_ggx_aniso(ng, h, tf, bf, ax, ay);
            g = g1_aniso(ndotv, dot(tf, v), dot(bf, v), ax, ay) *
                g1_aniso(ndotl, dot(tf, l), dot(bf, l), ax, ay);
        } else {
            dd = distribution_ggx(ng, h, rough);
            g = geometry_smith(ng, v, l, rough);
        }
        V3 f = fresnel_schlick(vdoth, f0);
        if (m.iridescence > 0.0f) {
            const V3 irid = iridescence(m.iridescence_thickness, vdoth);
            f = lerp(f, mul(f, irid), m.iridescence);
        }
        const float denom_s = 4.0f * ndotv * ndotl + F(0.001);
        const V3 spec = mul(f, dd * g / denom_s);
        V3 kd = mul(sub(v3(1.0f), f), 1.0f - metal);
        V3 diffuse = mul(m.albedo, kInvPi);

        // sheen adds to kD
        const float x = 1.0f - vdoth;
        const float fh = (x * x) * (x * x) * x;
        if (m.sheen > 0.0f)
            kd = add(kd, mul(lerp(v3(1.0f), m.sheen_tint, fh),
                             m.sheen * (1.0f - metal)));
        // subsurface wrap
        float sss = cmax(dot(v, neg(l)), 0.0f);
        sss = sss * sss * m.subsurface_radius;
        if (m.subsurface_radius > 0.0f)
            diffuse = lerp(diffuse, mul(m.subsurface_color, kInvPi), sss);
        // thin transmission for glass
        V3 thin = v3(0.0f);
        if (glass) {
            thin = mul(sub(v3(1.0f), f), m.transmission);
            kd = v3(0.0f);
        }
        const V3 radiance = mul(lcol, lint * 20.0f * ndotl * attenuation);
        V3 lo = mul(add(add(mul(kd, diffuse), spec), thin), radiance);
        // clearcoat
        if (m.clearcoat > 0.0f) {
            const float cc_d = distribution_ggx(ng, h, m.clearcoat_roughness);
            const float cc_g = geometry_smith(ng, v, l, m.clearcoat_roughness);
            const float cc_f = fresnel_coat(vdoth);
            const float cc_brdf = cc_f * (cc_d * cc_g / denom_s);
            lo = add(mul(lo, 1.0f - cc_f * m.clearcoat),
                     mul(mul(radiance, cc_brdf), m.clearcoat));
        }
        color = add(color, lo);
    }
    return color;
}

// glass_terms: the Fresnel term, refraction validity and, with rays, the two
// (perturbed) directions and the seed
struct Glass {
    V3 fr;
    bool refr_ok;
    V3 r_dir, t_dir;
    uint32_t seed;
};

template <bool RAYS>
__device__ Glass glass_terms(V3 i, V3 nf, bool entering, V3 point,
                             const Mat& m) {
    Glass g;
    const float n1 = entering ? 1.0f : m.ior;
    const float n2 = entering ? m.ior : 1.0f;
    const float eta = n1 / n2;
    const float r0 = (n2 - n1) / (n2 + n1);
    const float f0s = r0 * r0;
    const float cos_theta = cmax(dot(neg(i), nf), 0.0f);
    g.fr = fresnel_schlick(cos_theta, v3(f0s));
    const float ndoti = dot(nf, i);
    const float k = 1.0f - eta * eta * (1.0f - ndoti * ndoti);
    g.refr_ok = k >= 0.0f;
    if (!RAYS) return g;
    uint32_t seed = hash_seed(point);
    g.r_dir = normalize(reflect(i, nf), F(1e-20));
    const float refl_rough = tmaximum(m.roughness, m.transmission_roughness);
    const V3 r_pert = perturb(g.r_dir, refl_rough, seed);
    if (refl_rough > F(0.02)) g.r_dir = r_pert;
    g.t_dir = normalize(sub(mul(i, eta), mul(nf, eta * ndoti +
                                                 sqrtf(cmax(k, 0.0f)))),
                        F(1e-20));
    const V3 t_pert = perturb(g.t_dir, m.transmission_roughness, seed);
    if (m.transmission_roughness > F(0.02)) g.t_dir = t_pert;
    g.seed = seed;
    return g;
}

// -- the kernels -----------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
rt_light_rays_kernel(const RtArgs a) {
    const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                        threadIdx.x;
    if (i >= a.n) return;
    // hit record (traverse.hit_record): a miss's normal is zero
    const int slot = a.hit_slot[i];
    const bool found = slot >= 0;
    const V3 d = ld3(a.d, i);
    const float t = a.hit_t[i];
    V3 c = v3(0.0f);
    if (found && slot < a.n_slots) c = cross(ld3(a.e1, slot), ld3(a.e2, slot));
    V3 n = normalize(c, F(1e-30));
    const bool front = dot(d, n) < 0.0f;
    n = front ? n : neg(n);
    const V3 point = add(ld3(a.o, i), mul(d, t));
    a.hit[i] = found;
    st3(a.point, i, point);
    st3(a.normal, i, n);
    a.front[i] = front;
    // the shadow ray of every light (shade_core's, before its any-hit)
    const float eps = cmax(t, 1.0f) * F(1e-3);
    const V3 origin = add(point, mul(n, eps));
    for (int j = 0; j < a.n_lights; ++j) {
        const long long k = static_cast<long long>(j) * a.n + i;
        if (!found) {
            a.sh_t[k] = -1.0f;
            continue;
        }
        const LightDir ld = light_dir(a, j, point);
        st3(a.sh_o, k, origin);
        st3(a.sh_d, k, ld.l);
        a.sh_t[k] = ld.is_dir ? F(1e30) : ld.dist;
    }
}

__global__ void __launch_bounds__(kThreads) rt_shade_kernel(const RtArgs a) {
    const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                        threadIdx.x;
    if (i >= a.n) return;
    const V3 d = ld3(a.d, i);
    V3 c;
    if (a.hit[i] != 0) {
        const Mat m = fetch_mat(a, a.hit_mesh[i]);
        c = shade_core(a, i, d, ld3(a.normal, i), ld3(a.point, i), m);
    } else {
        c = sky(a, d);
    }
    st3(a.color, i, c);
}

__global__ void __launch_bounds__(kThreads)
rt_glass_rays_kernel(const RtArgs a) {
    const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                        threadIdx.x;
    if (i >= a.n) return;
    const V3 d = ld3(a.d, i);
    const long long i2 = a.n + i;
    bool live = a.hit[i] != 0;
    Mat m;
    if (live) {
        m = fetch_mat(a, a.hit_mesh[i]);
        live = is_glass(m);
    }
    if (!live) {  // dead rays: origin 0, the primary direction, t_max -1
        st3(a.g_o, i, v3(0.0f));
        st3(a.g_o, i2, v3(0.0f));
        st3(a.g_d, i, d);
        st3(a.g_d, i2, d);
        a.g_t[i] = -1.0f;
        a.g_t[i2] = -1.0f;
        a.seed[i] = 0;
        return;
    }
    const V3 nf = ld3(a.normal, i);
    const V3 point = ld3(a.point, i);
    const Glass g = glass_terms<true>(d, nf, a.front[i] != 0, point, m);
    const V3 off = mul(nf, cmax(a.hit_t[i], 1.0f) * F(1e-3));
    st3(a.g_o, i, add(point, off));
    st3(a.g_o, i2, sub(point, off));
    st3(a.g_d, i, g.r_dir);
    st3(a.g_d, i2, g.t_dir);
    a.g_t[i] = F(1e30);
    a.g_t[i2] = F(1e30);
    a.seed[i] = static_cast<int>(g.seed);
}

__global__ void __launch_bounds__(kThreads)
rt_resolve_kernel(const RtArgs a) {
    const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                        threadIdx.x;
    if (i >= a.n) return;
    V3 c = ld3(a.color, i);
    if (a.sec_color[0] != nullptr && a.hit[i] != 0) {
        const Mat m = fetch_mat(a, a.hit_mesh[i]);
        if (is_glass(m)) {
            const Glass g = glass_terms<false>(ld3(a.d, i), ld3(a.normal, i),
                                               a.front[i] != 0, v3(0.0f), m);
            const long long i2 = a.n + i;
            const float thickness = a.sec_slot[i2] >= 0 ? a.sec_t[i2] : 1.0f;
            const V3 alb{clamp01(clamp01(m.albedo.x)),
                         clamp01(clamp01(m.albedo.y)),
                         clamp01(clamp01(m.albedo.z))};
            const V3 absorb{powf(alb.x, thickness), powf(alb.y, thickness),
                            powf(alb.z, thickness)};
            const V3 t_col = g.refr_ok ? mul(absorb, ld3(a.sec_color, i2))
                                       : v3(0.0f);
            const V3 fr = g.refr_ok ? g.fr : v3(1.0f);
            const V3 glass_add =
                add(mul(fr, ld3(a.sec_color, i)),
                    mul(mul(sub(v3(1.0f), fr), m.transmission), t_col));
            c = add(c, glass_add);
        }
    }
    // Reinhard, gamma, *255 truncated; the rows flipped
    const float ch[3] = {c.x, c.y, c.z};
    const long long y = i / a.width, x = i - y * a.width;
    uint8_t* out = a.rgb + ((a.height - 1 - y) * a.width + x) * 3;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float r = ch[k] / (ch[k] + 1.0f);
        const float gm = powf(cmax(r, 0.0f), F(0.4545454545));
        out[k] = static_cast<uint8_t>(clampf(gm * 255.0f, 0.0f, 255.0f));
    }
}

template <typename K>
int launch(K kernel, const RtArgs* args, void* stream) {
    if (args->n > 0) {
        const unsigned blocks =
            static_cast<unsigned>((args->n + kThreads - 1) / kThreads);
        kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            *args);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptrt_rt_light_rays(const RtArgs* args, void* stream) {
    return launch(rt_light_rays_kernel, args, stream);
}
extern "C" int ptrt_rt_shade(const RtArgs* args, void* stream) {
    return launch(rt_shade_kernel, args, stream);
}
extern "C" int ptrt_rt_glass_rays(const RtArgs* args, void* stream) {
    return launch(rt_glass_rays_kernel, args, stream);
}
extern "C" int ptrt_rt_resolve(const RtArgs* args, void* stream) {
    return launch(rt_resolve_kernel, args, stream);
}

// Registers, local-memory bytes a thread, threads a block, resident blocks a
// SM and dynamic shared bytes a block of kernel k (rt_light_rays, rt_shade,
// rt_glass_rays, rt_resolve).
extern "C" int ptrt_rt_info(int k, const RtArgs* args, int* regs,
                            int* local_bytes, int* threads, int* per_sm,
                            int* shared_bytes) {
    (void)args;
    const void* kernel =
        k == 0 ? reinterpret_cast<const void*>(rt_light_rays_kernel)
        : k == 1 ? reinterpret_cast<const void*>(rt_shade_kernel)
        : k == 2 ? reinterpret_cast<const void*>(rt_glass_rays_kernel)
                 : reinterpret_cast<const void*>(rt_resolve_kernel);
    cudaFuncAttributes attr = {};
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    *threads = kThreads;
    *shared_bytes = 0;
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                          kThreads, 0);
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    return static_cast<int>(e);
}
