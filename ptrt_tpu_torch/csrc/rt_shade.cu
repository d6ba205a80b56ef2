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
//   [glass] -> rt_glass_rays (G glass lanes) -> K1 (2G rays)
//           -> rt_light_rays -> K2 -> rt_shade
//   -> rt_resolve -> [glass] rt_resolve_glass (the G glass lanes' pixels)
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
// rt_light_rays keeps the first design: one thread a lane, every
// intermediate in registers, the tables through the read-only cache, the
// shadow rays of all lights written by one launch so one K2 launch walks
// them, the hit record rebuilt from K1's slot, so no torch op runs between
// the kernels.
//
// rt_resolve (bound: its bytes, 12 in and 3 out a pixel and ~80 a glass
// lane, 0.011 ms at 1080p) was one thread a pixel in its first design: a
// 64-bit division for the row, three powf under no fast-math and three
// byte stores at stride 3 a pixel, every lane reading the index plane and
// the glass lanes diverging inside warps: 0.031 ms, its instructions, not
// its bytes, holding it.  Now two launches.  The encode pass takes four
// neighbouring pixels of a row a thread (the row is the block's y), 16-byte
// loads of the three colour planes and three 4-byte stores of the 12
// interleaved bytes, and reads no index plane; after Reinhard the encode is
// a table built from the plain encode (rt_shading.encode_lut, as K6's in
// tonemap.cu) in place of the powf: one word for each 2^16 float bit
// patterns of r in [0, 2] and three for r above 2, negative and NaN, which
// chip_smoke.py holds equal to the plain encode on all 2^32 float32
// colours.  Then rt_resolve_glass, one thread a glass lane over the G
// glass lanes, adds the glass terms to the lane's colour and writes its
// pixel again.  Measured on an H100 at 1080p, queued (PERF.md): 0.018 ms
// (the encode pass 0.011, the glass pass 0.005); the index plane read four
// lanes at a time in one launch instead, 0.021.
//
// rt_glass_rays writes the rays of the glass lanes only.  The first design
// wrote a reflection and a refraction ray for every lane, dead ones with
// t_max -1, so K1, rt_light_rays, K2 and rt_shade ran the glass pass on 2N
// rays where 5.8% of the hit lanes are glass (1080p bench scene).  Now one
// cooperative launch, the grid the card holds at once, lists the G glass
// lanes in lane order, in three phases between two grid syncs: (1) each
// block counts the glass lanes of its run of lanes (a thread's flag a tile
// kept in a register; the flags, mesh ids and materials of kBatch tiles
// asked for a round at a time, not one tile's chain after another's); (2)
// each block sums the counts before its own and writes its lanes' places
// (the index plane, -1 off glass) and the glass lanes at their places; (3)
// the grid's threads share out the G places, one glass lane each: its
// reflection ray at its place p, its refraction ray at G + p and its seed.
// The order is the plain version's nonzero order, so the records are
// deterministic.  G lies in counts[0]; the wrapper reads it once a frame to
// size the glass pass.  Bound: the hit flag, mesh id and index plane over
// every lane, 41 bytes in and 64 out a glass lane: 0.007 ms at 1080p.
// Measured on an H100 (PERF.md): 0.021-0.022 ms (the first design 0.059);
// with the rays written in phase (2), each block its own glass lanes tile
// by tile, 0.027, and with phase (1) one tile's loads after another's,
// 0.024: a block that meets a glass object ran its tiles' chains of
// dependent loads one after another.
//
// rt_shade (bound: its bytes, 0.028 ms on the primary pass at 1080p) ran at
// 2 blocks of 256 a SM in its first design: 90 registers and 32 bytes of
// stack, from the whole 27-float material row held in registers across the
// light loop, the rare lobes (anisotropic GGX, iridescence, sheen, the
// subsurface wrap, clear coat) inline so their registers counted for every
// lane, and the sky lanes (39%) sharing warps with the hit lanes.  Now:
// the material and light tables are staged in shared memory once a block
// (dynamic shared memory sized from the tables' shapes; a table whose
// staging would cost resident blocks is read through the read-only cache by
// the same code), each material field read from the row where it is used;
// the rare lobes are out of line (__noinline__), called only by the lanes
// whose material has them; inside the light loop the material's scalars,
// f0 and the lobe flags are read from the staged row and worked out again
// each light (volatile shared loads, so the compiler holds none of them in
// registers across the loop); a block takes two lanes a thread, writes its
// sky lanes first and lists its hit lanes in shared memory in lane order,
// so the warps that shade run full: 64 registers, 4 blocks a SM, no spill
// stores.  Measured on an H100 at 1080p, queued (PERF.md): 0.085 ms on the
// primary pass against the first design's 0.139.  Without the loads again
// each light: 75 registers, 3 blocks, 0.094; at 2 blocks 0.135; at 4, 64
// registers with 40 bytes of spill stores, 0.082; with f0 and the scalars
// loaded again but the lobe flags held, 8 bytes of spill stores.  The list
// of one lane a thread 0.104 (a block's warps left without a lane hold
// their slots), of four 0.097, no list 0.098.  On the 146,120 glass rays
// the list of two lanes fills fewer blocks than the card holds: 0.018 ms
// against 0.014 without a list.
//
// Float order: this file builds with -fmad=false and follows the plain torch
// version operation by operation, including how torch on the card rounds
// scalars: `x / c` for a Python scalar c multiplies by the float reciprocal
// of float(c); `c / x` is (1 / x) * c.  Python-side constants are rounded
// from double, as torch does (F below).  The seed chain (the hash of the hit
// point, then two LCG steps a perturbation, reflection first) is exact.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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
    float* g_o[3];             // glass rays: reflection 0..G-1, refraction
    float* g_d[3];             //   G..2G-1 (rt_glass_rays; room for 2n)
    float* g_t;
    long long* seed;           // (G) the seed after both perturbations
    int* lanes;                // (G) the glass lanes, in lane order
    int* index;                // (n) a lane's place in lanes, -1 off glass
    int* counts;               // rt_glass_rays: G, then a count a block
    long long n_glass;         // G (rt_resolve_glass)
    const float* sec_color[3]; // the 2G secondary shades (rt_resolve_glass)
    const float* sec_t;        // K1's record of the glass rays
    const int* sec_slot;
    uint8_t* rgb;              // (height, width, 3), rows flipped
    int height, width;
    const int* lut;            // rt_resolve's encode table
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// resident blocks a SM rt_shade is compiled for: the fastest of 2, 3 and 4
// with no spill stores; the lanes a thread takes, the fastest of 1, 2, 4
// (see the note at the top)
constexpr int kShadeBlocks = 4;
constexpr int kShadeLanes = 2;
// rt_glass_rays: tiles of kThreads lanes whose glass flags a thread keeps
// in a register between the count and the places (past them it asks again)
constexpr int kFlagTiles = 32;
constexpr int kBatch = 8;  // tiles whose loads a thread issues together
// dynamic shared memory a launch may ask for without an opt-in
constexpr int kMaxStagedBytes = 48 * 1024;
constexpr int kMaxDevices = 16;
// rt_resolve: threads a block, pixels a thread; its encode table's buckets
// (float bits of r = c / (c + 1) in [0, 2], shifted right by 16), then its
// three special words
constexpr int kResolveThreads = 128;
constexpr int kPix = 4;
constexpr uint32_t kLutTop = 0x40000000u;  // 2.0f
constexpr uint32_t kLutBuckets = (kLutTop >> 16) + 1;
constexpr float kPi = F(3.141592653589793);
constexpr float kTwoPiD = F(2.0 * 3.141592653589793);   // 2.0 * PI
constexpr float kInvPi = F(1.0 / 3.141592653589793);    // INV_PI
constexpr int kDirectional = 1, kSpot = 2;  // scene/lights.py LightType

// scene/materials.py packed row: the columns read here
enum MatCol {
    kAlbedo = 0, kSpecular = 3, kEmission = 6, kSubsurfaceColor = 9,
    kSheenTint = 12, kMetallic = 15, kRoughness = 16, kIor = 17,
    kTransmission = 18, kTransRoughness = 19, kClearcoat = 20,
    kClearcoatRoughness = 21, kSubsurfaceRadius = 22, kAnisotropy = 23,
    kSheen = 24, kIridescence = 25, kIridescenceThickness = 26,
};

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

// -- tables -------------------------------------------------------------------

// A read of a table: shared memory where the block staged it, else the
// read-only path.
template <bool kStaged>
__device__ __forceinline__ float tl(const float* p) {
    if (kStaged) return *p;
    return __ldg(p);
}
template <bool kStaged>
__device__ __forceinline__ V3 tl3(const float* p) {
    return V3{tl<kStaged>(p), tl<kStaged>(p + 1), tl<kStaged>(p + 2)};
}
// The same read inside a loop: from shared memory a volatile load, so the
// row is read again each time instead of held in registers across the loop.
template <bool kStaged>
__device__ __forceinline__ float tl_again(const float* p) {
    if (kStaged) return *static_cast<const volatile float*>(p);
    return __ldg(p);
}
template <bool kStaged>
__device__ __forceinline__ V3 tl3_again(const float* p) {
    return V3{tl_again<kStaged>(p), tl_again<kStaged>(p + 1),
              tl_again<kStaged>(p + 2)};
}

// the material row of an id, clamped into the table as the plain version's
// gather clamps it
__device__ __forceinline__ const float* mat_row(const RtArgs& a,
                                                const float* table, int id) {
    id = min(max(id, 0), a.n_mats - 1);
    return table + static_cast<long long>(id) * a.mat_width;
}

__device__ __forceinline__ bool is_glass(float transmission, float metallic) {
    return transmission > 0.0f && clamp01(metallic) < F(0.1);
}

struct LightDir {
    V3 l;
    float dist;
    bool is_dir;
};

// rt_shading.light_vectors: the light of row r seen from the point (an area
// light is shaded as a point light)
template <bool kStaged>
__device__ __forceinline__ LightDir light_dir(const float* r, V3 point) {
    LightDir out;
    out.is_dir = tl<kStaged>(r) == F(kDirectional);
    const V3 to_light = sub(tl3<kStaged>(r + 1), point);
    out.dist = cmax(sqrtf(dot(to_light, to_light)), F(1e-6));
    const V3 l_pt = mul(to_light, 1.0f / out.dist);
    out.l = out.is_dir ? neg(tl3<kStaged>(r + 4)) : l_pt;
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
__device__ __forceinline__ V3 iridescence(float thickness, float cos_theta) {
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

// -- shade_core's rare lobes, out of line --------------------------------------

// the anisotropic GGX terms of one light: (D, G) with the tangent frame of
// ng and the alphas of the lane's roughness and anisotropy
template <bool kStaged>
__device__ __noinline__ float2 aniso_lobe(const float* r, V3 ng, V3 v, V3 l,
                                          V3 h, float rough, float ndotv,
                                          float ndotl) {
    const float anisotropy = tl<kStaged>(r + kAnisotropy);
    V3 tf, bf;
    tangent_frame(ng, tf, bf);
    const float r2 = rough * rough;
    const float aspect = sqrtf(1.0f - fabsf(anisotropy) * F(0.9));
    const float ax_pos = r2 / aspect, ay_pos = r2 * aspect;
    const float ax = cmax(anisotropy >= 0.0f ? ax_pos : ay_pos, F(0.001));
    const float ay = cmax(anisotropy >= 0.0f ? ay_pos : ax_pos, F(0.001));
    const float dd = distribution_ggx_aniso(ng, h, tf, bf, ax, ay);
    const float g = g1_aniso(ndotv, dot(tf, v), dot(bf, v), ax, ay) *
                    g1_aniso(ndotl, dot(tf, l), dot(bf, l), ax, ay);
    return make_float2(dd, g);
}

// the iridescent tint of the Fresnel term
template <bool kStaged>
__device__ __noinline__ V3 iridescent(const float* r, V3 f, float vdoth) {
    const V3 irid = iridescence(tl<kStaged>(r + kIridescenceThickness),
                                vdoth);
    return lerp(f, mul(f, irid), tl<kStaged>(r + kIridescence));
}

struct Diffuse {
    V3 kd, albedo;  // kD and the diffuse albedo over pi
};

// sheen adds to kD; the subsurface wrap bends the diffuse albedo
template <bool kStaged>
__device__ __noinline__ Diffuse sheen_subsurface(const float* r, Diffuse df,
                                                 float metal, float vdoth,
                                                 V3 v, V3 l) {
    const float sheen = tl<kStaged>(r + kSheen);
    const float x = 1.0f - vdoth;
    const float fh = (x * x) * (x * x) * x;
    if (sheen > 0.0f)
        df.kd = add(df.kd, mul(lerp(v3(1.0f), tl3<kStaged>(r + kSheenTint),
                                    fh),
                               sheen * (1.0f - metal)));
    const float radius = tl<kStaged>(r + kSubsurfaceRadius);
    float sss = cmax(dot(v, neg(l)), 0.0f);
    sss = sss * sss * radius;
    if (radius > 0.0f)
        df.albedo = lerp(df.albedo,
                         mul(tl3<kStaged>(r + kSubsurfaceColor), kInvPi), sss);
    return df;
}

// the clear coat over one light's lobe
template <bool kStaged>
__device__ __noinline__ V3 clearcoat(const float* r, V3 lo, V3 radiance,
                                     V3 ng, V3 v, V3 l, V3 h, float vdoth,
                                     float denom_s) {
    const float coat = tl<kStaged>(r + kClearcoat);
    const float coat_rough = tl<kStaged>(r + kClearcoatRoughness);
    const float cc_d = distribution_ggx(ng, h, coat_rough);
    const float cc_g = geometry_smith(ng, v, l, coat_rough);
    const float cc_f = fresnel_coat(vdoth);
    const float cc_brdf = cc_f * (cc_d * cc_g / denom_s);
    return add(mul(lo, 1.0f - cc_f * coat), mul(mul(radiance, cc_brdf), coat));
}

// -- shade_core ------------------------------------------------------------------

constexpr int kLobeAniso = 1, kLobeIrid = 2, kLobeSheenSss = 4, kLobeCoat = 8;

// shade_core of hit lane i (material row r, light rows lts), light j's
// occlusion at occluded[j * n + i].  The material's scalars, f0 and lobe
// flags are read and worked out again each light (tl_again), so they take
// no registers across the light loop.
template <bool kStaged>
__device__ __forceinline__ V3 shade_core(const RtArgs& a, const float* r,
                                         const float* lts, long long i) {
    const V3 d = ld3(a.d, i);
    const V3 ng = ld3(a.normal, i);
    const V3 point = ld3(a.point, i);
    const V3 v = neg(d);
    const float ndotv = cmax(dot(ng, v), 0.0f);
    V3 color;
    {
        const float rough =
            clampf(tl<kStaged>(r + kRoughness), F(0.02), 1.0f);
        const float metal = clamp01(tl<kStaged>(r + kMetallic));
        const bool glass =
            tl<kStaged>(r + kTransmission) > 0.0f && metal < F(0.1);
        const V3 f0 = lerp(tl3<kStaged>(r + kSpecular),
                           tl3<kStaged>(r + kAlbedo), metal);
        color = tl3<kStaged>(r + kEmission);
        const V3 f_amb = fresnel_schlick_roughness(ndotv, f0, rough);
        const V3 kd_amb = glass ? v3(0.0f) : mul(sub(v3(1.0f), f_amb),
                                                 1.0f - metal);
        const V3 ambient{a.params[0], a.params[1], a.params[2]};
        color = add(color,
                    mul(mul(kd_amb, tl3<kStaged>(r + kAlbedo)), ambient));
    }
    for (int j = 0; j < a.n_lights; ++j) {
        if (a.occluded[static_cast<long long>(j) * a.n + i] != 0) continue;
        const float* lr = lts + static_cast<long long>(j) * a.light_width;
        const LightDir ld = light_dir<kStaged>(lr, point);
        const V3 l = ld.l;
        const float lrange = tl<kStaged>(lr + 11);
        float att = lrange / (lrange + ld.dist);
        att = att * att;
        const float theta = dot(l, neg(tl3<kStaged>(lr + 4)));
        const float louter = tl<kStaged>(lr + 13);
        const float eps_cone = tl<kStaged>(lr + 12) - louter;
        const float spot = clamp01(
            (theta - louter) /
            (fabsf(eps_cone) < F(1e-12) ? F(1e-12) : eps_cone));
        att = att * (static_cast<int>(tl<kStaged>(lr)) == kSpot ? spot : 1.0f);
        const float attenuation = ld.is_dir ? 1.0f : att;

        const V3 h = normalize(add(l, v), F(1e-20));
        const float ndotl = cmax(dot(ng, l), 0.0f);
        const float vdoth = cmax(dot(v, h), 0.0f);

        const float rough =
            clampf(tl_again<kStaged>(r + kRoughness), F(0.02), 1.0f);
        const int lobes =
            (fabsf(tl_again<kStaged>(r + kAnisotropy)) > F(0.01) ? kLobeAniso
                                                                  : 0) |
            (tl_again<kStaged>(r + kIridescence) > 0.0f ? kLobeIrid : 0) |
            (tl_again<kStaged>(r + kSheen) > 0.0f ||
                     tl_again<kStaged>(r + kSubsurfaceRadius) > 0.0f
                 ? kLobeSheenSss
                 : 0) |
            (tl_again<kStaged>(r + kClearcoat) > 0.0f ? kLobeCoat : 0);
        float dd, g;
        if (lobes & kLobeAniso) {
            const float2 dg =
                aniso_lobe<kStaged>(r, ng, v, l, h, rough, ndotv, ndotl);
            dd = dg.x;
            g = dg.y;
        } else {
            dd = distribution_ggx(ng, h, rough);
            g = geometry_smith(ng, v, l, rough);
        }
        const float metal = clamp01(tl_again<kStaged>(r + kMetallic));
        V3 f = fresnel_schlick(vdoth, lerp(tl3_again<kStaged>(r + kSpecular),
                                           tl3_again<kStaged>(r + kAlbedo),
                                           metal));
        if (lobes & kLobeIrid) f = iridescent<kStaged>(r, f, vdoth);
        const float denom_s = 4.0f * ndotv * ndotl + F(0.001);
        const V3 spec = mul(f, dd * g / denom_s);
        Diffuse df{mul(sub(v3(1.0f), f), 1.0f - metal),
                   mul(tl3_again<kStaged>(r + kAlbedo), kInvPi)};
        if (lobes & kLobeSheenSss)
            df = sheen_subsurface<kStaged>(r, df, metal, vdoth, v, l);
        // thin transmission for glass
        V3 thin = v3(0.0f);
        const float transmission = tl_again<kStaged>(r + kTransmission);
        if (transmission > 0.0f && metal < F(0.1)) {
            thin = mul(sub(v3(1.0f), f), transmission);
            df.kd = v3(0.0f);
        }
        const V3 radiance = mul(tl3<kStaged>(lr + 7),
                                tl<kStaged>(lr + 10) * 20.0f * ndotl *
                                    attenuation);
        V3 lo = mul(add(add(mul(df.kd, df.albedo), spec), thin), radiance);
        if (lobes & kLobeCoat)
            lo = clearcoat<kStaged>(r, lo, radiance, ng, v, l, h, vdoth,
                                    denom_s);
        color = add(color, lo);
    }
    return color;
}

// glass_terms: the Fresnel term, refraction validity and, with rays, the two
// (perturbed) directions and the seed (material row r, global memory)
struct Glass {
    V3 fr;
    bool refr_ok;
    V3 r_dir, t_dir;
    uint32_t seed;
};

template <bool RAYS>
__device__ Glass glass_terms(V3 i, V3 nf, bool entering, V3 point,
                             const float* r) {
    Glass g;
    const float ior = __ldg(r + kIor);
    const float n1 = entering ? 1.0f : ior;
    const float n2 = entering ? ior : 1.0f;
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
    const float trans_rough = __ldg(r + kTransRoughness);
    const float refl_rough = tmaximum(__ldg(r + kRoughness), trans_rough);
    const V3 r_pert = perturb(g.r_dir, refl_rough, seed);
    if (refl_rough > F(0.02)) g.r_dir = r_pert;
    g.t_dir = normalize(sub(mul(i, eta), mul(nf, eta * ndoti +
                                                 sqrtf(cmax(k, 0.0f)))),
                        F(1e-20));
    const V3 t_pert = perturb(g.t_dir, trans_rough, seed);
    if (trans_rough > F(0.02)) g.t_dir = t_pert;
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
        const LightDir ld = light_dir<false>(
            a.lights + static_cast<long long>(j) * a.light_width, point);
        st3(a.sh_o, k, origin);
        st3(a.sh_d, k, ld.l);
        a.sh_t[k] = ld.is_dir ? F(1e30) : ld.dist;
    }
}

// A block stages the tables (kStaged) and takes kShadeLanes lanes a thread,
// kThreads * kShadeLanes neighbouring lanes: it writes the sky of its lanes
// that missed, lists its hit lanes in shared memory in lane order and
// shades them from the list, kThreads at a time.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, kShadeBlocks)
rt_shade_kernel(const RtArgs a) {
    constexpr int kChunk = kThreads * kShadeLanes;
    extern __shared__ float staged[];
    __shared__ int warp_hits[kWarps];
    __shared__ int list[kChunk];
    const float* mats = a.mat;
    const float* lts = a.lights;
    if (kStaged) {
        const int n_mat = a.n_mats * a.mat_width;
        const int n_light = a.n_lights > 0 ? a.n_light_rows * a.light_width
                                           : 0;
        for (int k = threadIdx.x; k < n_mat; k += kThreads)
            staged[k] = __ldg(a.mat + k);
        for (int k = threadIdx.x; k < n_light; k += kThreads)
            staged[n_mat + k] = __ldg(a.lights + k);
        mats = staged;
        lts = staged + n_mat;
    }
    const long long base = blockIdx.x * static_cast<long long>(kChunk);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    bool hit[kShadeLanes];
#pragma unroll
    for (int k = 0; k < kShadeLanes; ++k) {
        const long long i = base + k * kThreads + threadIdx.x;
        hit[k] = i < a.n && a.hit[i] != 0;
    }
    int n_hit = 0;
#pragma unroll
    for (int k = 0; k < kShadeLanes; ++k) {
        const int j = k * kThreads + threadIdx.x;
        if (!hit[k] && base + j < a.n)
            st3(a.color, base + j, sky(a, ld3(a.d, base + j)));
        const unsigned ballot = __ballot_sync(0xffffffffu, hit[k]);
        if (k > 0) __syncthreads();  // the round before has read warp_hits
        if (lane == 0) warp_hits[warp] = __popc(ballot);
        __syncthreads();  // (the first also shows the staged tables)
        int at = n_hit + __popc(ballot & ((1u << lane) - 1u));
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const int c = warp_hits[w];
            at += w < warp ? c : 0;
            n_hit += c;
        }
        if (hit[k]) list[at] = j;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < n_hit; k += kThreads) {
        const long long i = base + list[k];
        st3(a.color, i,
            shade_core<kStaged>(a, mat_row(a, mats, a.hit_mesh[i]), lts, i));
    }
}

__device__ __forceinline__ bool glass_lane(const RtArgs& a, long long i) {
    if (i >= a.n || a.hit[i] == 0) return false;
    const float* r = mat_row(a, a.mat, a.hit_mesh[i]);
    return is_glass(__ldg(r + kTransmission), __ldg(r + kMetallic));
}

// One cooperative launch in three phases (see the note at the top): block
// b takes lanes [b, b + 1) * tiles * kThreads.
__global__ void __launch_bounds__(kThreads)
rt_glass_rays_kernel(const __grid_constant__ RtArgs a, int tiles) {
    __shared__ int warp_n[kWarps];
    __shared__ int red[2][kWarps];
    cg::grid_group grid = cg::this_grid();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long first =
        static_cast<long long>(blockIdx.x) * tiles * kThreads + threadIdx.x;
    // 1. each thread's glass lanes, kBatch tiles at a time (their flags,
    // then their mesh ids, then the materials: each a round of independent
    // loads), then the block's count
    unsigned flags = 0u;
    int count = 0;
    for (int t0 = 0; t0 < tiles; t0 += kBatch) {
        int mesh[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
            const long long i =
                first + static_cast<long long>(t0 + b) * kThreads;
            mesh[b] = t0 + b < tiles && i < a.n && a.hit[i] != 0 ? 0 : -1;
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
            if (mesh[b] >= 0)
                mesh[b] = max(a.hit_mesh[first + static_cast<long long>(
                                                     t0 + b) * kThreads],
                              0);
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
            bool g = false;
            if (mesh[b] >= 0) {
                const float* r = mat_row(a, a.mat, mesh[b]);
                g = is_glass(__ldg(r + kTransmission), __ldg(r + kMetallic));
            }
            if (t0 + b < kFlagTiles) flags |= static_cast<unsigned>(g) <<
                                              (t0 + b);
            count += g;
        }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
        count += __shfl_xor_sync(0xffffffffu, count, s);
    if (lane == 0) warp_n[warp] = count;
    __syncthreads();
    if (threadIdx.x == 0) {
        int c = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) c += warp_n[w];
        a.counts[1 + blockIdx.x] = c;
    }
    grid.sync();
    // 2. the glass lanes of the blocks before this one, and of all; then
    // each tile's glass lanes in lane order: their places and the lanes
    int before = 0, total = 0;
    for (int b = threadIdx.x; b < static_cast<int>(gridDim.x);
         b += kThreads) {
        const int c = __ldcg(a.counts + 1 + b);
        total += c;
        before += b < static_cast<int>(blockIdx.x) ? c : 0;
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
        before += __shfl_xor_sync(0xffffffffu, before, s);
        total += __shfl_xor_sync(0xffffffffu, total, s);
    }
    if (lane == 0) {
        red[0][warp] = before;
        red[1][warp] = total;
    }
    __syncthreads();
    before = total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        before += red[0][w];
        total += red[1][w];
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) a.counts[0] = total;
    int place = before;
    for (int t = 0; t < tiles; ++t) {
        const long long i = first + static_cast<long long>(t) * kThreads;
        const bool g = t < kFlagTiles ? ((flags >> t) & 1u) != 0u
                                      : glass_lane(a, i);
        const unsigned ballot = __ballot_sync(0xffffffffu, g);
        __syncthreads();  // the tile before has read warp_n
        if (lane == 0) warp_n[warp] = __popc(ballot);
        __syncthreads();
        int at = place + __popc(ballot & ((1u << lane) - 1u)), tile_n = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
            const int c = warp_n[w];
            at += w < warp ? c : 0;
            tile_n += c;
        }
        place += tile_n;
        if (i < a.n) a.index[i] = g ? at : -1;
        if (g) a.lanes[at] = static_cast<int>(i);
    }
    grid.sync();
    // 3. the rays of the glass lanes, spread over the whole grid
    const long long stride = static_cast<long long>(gridDim.x) * kThreads;
    for (long long p = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
         p < total; p += stride) {
        const long long i = __ldcg(a.lanes + p);
        const float* r = mat_row(a, a.mat, a.hit_mesh[i]);
        const V3 nf = ld3(a.normal, i);
        const V3 point = ld3(a.point, i);
        const Glass gl =
            glass_terms<true>(ld3(a.d, i), nf, a.front[i] != 0, point, r);
        const V3 off = mul(nf, cmax(a.hit_t[i], 1.0f) * F(1e-3));
        const long long p2 = total + p;
        st3(a.g_o, p, add(point, off));
        st3(a.g_o, p2, sub(point, off));
        st3(a.g_d, p, gl.r_dir);
        st3(a.g_d, p2, gl.t_dir);
        a.g_t[p] = F(1e30);
        a.g_t[p2] = F(1e30);
        a.seed[p] = static_cast<long long>(gl.seed);
    }
}

// -- rt_resolve ------------------------------------------------------------------

// the byte of one colour channel: Reinhard, then the encode's table
// (rt_shading.encode_lut): a word for each 2^16 float bit patterns of r in
// [0, 2] (the byte at the bucket's start, bits 17 up, and where in the
// bucket the one threshold it may hold lies, low 17 bits, 2^16 where none),
// then one word each for r in (2, inf], r negative (-0 among them) and r
// NaN; a special word holds no threshold
__device__ __forceinline__ uint32_t resolve_byte(float c, const int* lut) {
    const float r = c / (c + 1.0f);
    const uint32_t b = __float_as_uint(r);
    const uint32_t k =
        b <= kLutTop ? b >> 16
        : b <= 0x7f800000u ? kLutBuckets
        : (b & 0x7fffffffu) > 0x7f800000u ? kLutBuckets + 2u
                                          : kLutBuckets + 1u;
    const uint32_t e = static_cast<uint32_t>(__ldg(lut + k));
    return (e >> 17) + ((b & 0xffffu) >= (e & 0x1ffffu) ? 1u : 0u);
}

// lane i's colour plus the glass terms of its place p: the Fresnel mix of
// the reflection shade (at p), Beer-Lambert over the refraction ray's t and
// the transmitted shade (at G + p)
__device__ __forceinline__ V3 glass_color(const RtArgs& a, long long i,
                                          long long p, V3 c) {
    const float* r = mat_row(a, a.mat, a.hit_mesh[i]);
    const Glass g = glass_terms<false>(ld3(a.d, i), ld3(a.normal, i),
                                       a.front[i] != 0, v3(0.0f), r);
    const long long k2 = a.n_glass + p;
    const float thickness = a.sec_slot[k2] >= 0 ? a.sec_t[k2] : 1.0f;
    const V3 alb{clamp01(clamp01(__ldg(r + kAlbedo))),
                 clamp01(clamp01(__ldg(r + kAlbedo + 1))),
                 clamp01(clamp01(__ldg(r + kAlbedo + 2)))};
    const V3 absorb{powf(alb.x, thickness), powf(alb.y, thickness),
                    powf(alb.z, thickness)};
    const V3 t_col = g.refr_ok ? mul(absorb, ld3(a.sec_color, k2))
                               : v3(0.0f);
    const V3 fr = g.refr_ok ? g.fr : v3(1.0f);
    const V3 glass_add = add(
        mul(fr, ld3(a.sec_color, p)),
        mul(mul(sub(v3(1.0f), fr), __ldg(r + kTransmission)), t_col));
    return add(c, glass_add);
}

// the colour planes to RGB8 without the glass terms, rows flipped: four
// neighbouring pixels of a row a thread, the row the block's y; 16-byte
// loads and three 4-byte stores where kVec (the width a multiple of 4),
// else a pixel at a time.  rt_resolve_glass writes the glass lanes' pixels
// again after it.
template <bool kVec>
__global__ void __launch_bounds__(kResolveThreads)
rt_resolve_kernel(const RtArgs a) {
    const int y = blockIdx.y;
    const int x = (blockIdx.x * kResolveThreads + threadIdx.x) * kPix;
    if (x >= a.width) return;
    const int m = min(kPix, a.width - x);
    const long long at = static_cast<long long>(y) * a.width + x;
    float c[3][kPix];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        if (kVec) {
            const float4 v =
                __ldg(reinterpret_cast<const float4*>(a.color[k] + at));
            c[k][0] = v.x;
            c[k][1] = v.y;
            c[k][2] = v.z;
            c[k][3] = v.w;
        } else {
#pragma unroll
            for (int p = 0; p < kPix; ++p)
                c[k][p] = p < m ? __ldg(a.color[k] + at + p) : 0.0f;
        }
    }
    uint32_t px[kPix][3];
#pragma unroll
    for (int p = 0; p < kPix; ++p)
#pragma unroll
        for (int k = 0; k < 3; ++k) px[p][k] = resolve_byte(c[k][p], a.lut);
    uint8_t* dst =
        a.rgb + (static_cast<long long>(a.height - 1 - y) * a.width + x) * 3;
    if (kVec) {
        // r0 g0 b0 r1 | g1 b1 r2 g2 | b2 r3 g3 b3, little-endian words
        uint32_t* d = reinterpret_cast<uint32_t*>(dst);
        d[0] = px[0][0] | px[0][1] << 8 | px[0][2] << 16 | px[1][0] << 24;
        d[1] = px[1][1] | px[1][2] << 8 | px[2][0] << 16 | px[2][1] << 24;
        d[2] = px[2][2] | px[3][0] << 8 | px[3][1] << 16 | px[3][2] << 24;
    } else {
#pragma unroll
        for (int p = 0; p < kPix; ++p) {
            if (p >= m) break;
#pragma unroll
            for (int k = 0; k < 3; ++k)
                dst[3 * p + k] = static_cast<uint8_t>(px[p][k]);
        }
    }
}

// the G glass lanes' pixels again, one glass lane a thread: its colour plus
// its glass terms (32-bit row arithmetic: the wrapper holds n below 2^31)
__global__ void __launch_bounds__(kThreads)
rt_resolve_glass_kernel(const RtArgs a) {
    const long long p = blockIdx.x * static_cast<long long>(kThreads) +
                        threadIdx.x;
    if (p >= a.n_glass) return;
    const int i = __ldg(a.lanes + p);
    const V3 c = glass_color(a, i, p, ld3(a.color, i));
    const unsigned y = static_cast<unsigned>(i) /
                       static_cast<unsigned>(a.width);
    const unsigned x = static_cast<unsigned>(i) - y * a.width;
    uint8_t* dst = a.rgb + (static_cast<long long>(a.height - 1 - y) *
                                a.width + x) * 3;
    dst[0] = static_cast<uint8_t>(resolve_byte(c.x, a.lut));
    dst[1] = static_cast<uint8_t>(resolve_byte(c.y, a.lut));
    dst[2] = static_cast<uint8_t>(resolve_byte(c.z, a.lut));
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

// rt_shade's tables: their bytes, and whether the staged kernel keeps
// kShadeBlocks a SM with them (remembered a device for the last size asked)
cudaError_t shade_staging(const RtArgs* a, int* bytes, bool* staged) {
    const long long floats =
        static_cast<long long>(a->n_mats) * a->mat_width +
        (a->n_lights > 0
             ? static_cast<long long>(a->n_light_rows) * a->light_width
             : 0);
    *bytes = static_cast<int>(floats * 4 < kMaxStagedBytes ? floats * 4
                                                            : kMaxStagedBytes);
    *staged = false;
    if (floats * 4 > kMaxStagedBytes) return cudaSuccess;
    static int last_bytes[kMaxDevices], last_per_sm[kMaxDevices];
    static bool known[kMaxDevices];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess && (dev < 0 || dev >= kMaxDevices))
        e = cudaErrorInvalidDevice;
    if (e != cudaSuccess) return e;
    if (!known[dev] || last_bytes[dev] != *bytes) {
        int per_sm = 0;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, reinterpret_cast<const void*>(rt_shade_kernel<true>),
            kThreads, *bytes);
        if (e != cudaSuccess) return e;
        last_bytes[dev] = *bytes;
        last_per_sm[dev] = per_sm;
        known[dev] = true;
    }
    *staged = last_per_sm[dev] >= kShadeBlocks;
    return cudaSuccess;
}

// rt_glass_rays' grid: the blocks the card holds at once, each a run of
// ``tiles`` tiles of kThreads lanes, at most a block a tile
cudaError_t glass_grid(long long n, int* grid, int* tiles) {
    static int per_sm[kMaxDevices], sms[kMaxDevices];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess && (dev < 0 || dev >= kMaxDevices))
        e = cudaErrorInvalidDevice;
    if (e == cudaSuccess && per_sm[dev] == 0) {
        e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm[dev], rt_glass_rays_kernel, kThreads, 0);
    }
    if (e != cudaSuccess) return e;
    const long long need = (n + kThreads - 1) / kThreads;
    const long long most = static_cast<long long>(sms[dev]) *
                           (per_sm[dev] > 0 ? per_sm[dev] : 1);
    const long long t = (need + most - 1) / most;
    *tiles = static_cast<int>(t);
    *grid = static_cast<int>((need + t - 1) / t);
    return cudaSuccess;
}

}  // namespace

extern "C" int ptrt_rt_light_rays(const RtArgs* args, void* stream) {
    return launch(rt_light_rays_kernel, args, stream);
}

extern "C" int ptrt_rt_shade(const RtArgs* args, void* stream) {
    if (args->n <= 0) return static_cast<int>(cudaGetLastError());
    int bytes = 0;
    bool staged = false;
    const cudaError_t e = shade_staging(args, &bytes, &staged);
    if (e != cudaSuccess) return static_cast<int>(e);
    constexpr int kChunk = kThreads * kShadeLanes;
    const unsigned blocks =
        static_cast<unsigned>((args->n + kChunk - 1) / kChunk);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (staged)
        rt_shade_kernel<true><<<blocks, kThreads, bytes, s>>>(*args);
    else
        rt_shade_kernel<false><<<blocks, kThreads, 0, s>>>(*args);
    return static_cast<int>(cudaGetLastError());
}

// rt_glass_rays: ``counts`` holds 1 + ceil(n / 256) ints; G is written to
// counts[0].  The ray planes have room for 2n rays, seed and lanes for n.
extern "C" int ptrt_rt_glass_rays(const RtArgs* args, void* stream) {
    if (args->n <= 0) return static_cast<int>(cudaGetLastError());
    int grid = 0, tiles = 0;
    const cudaError_t e = glass_grid(args->n, &grid, &tiles);
    if (e != cudaSuccess) return static_cast<int>(e);
    RtArgs a = *args;
    void* params[] = {&a, &tiles};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(rt_glass_rays_kernel), dim3(grid),
        dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream)));
}

// rt_resolve: the encode pass over every pixel, then, with glass lanes
// (n_glass > 0: lanes and the sec_* planes set), rt_resolve_glass over
// them.  The vector path needs the width a multiple of 4, 16-byte aligned
// colour planes and a 4-byte aligned image.
extern "C" int ptrt_rt_resolve(const RtArgs* args, void* stream) {
    const RtArgs& a = *args;
    if (a.n <= 0) return static_cast<int>(cudaGetLastError());
    if (a.height > 65535 || a.n >= (1LL << 31) ||
        a.n != static_cast<long long>(a.height) * a.width)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    bool vec = a.width % kPix == 0 &&
               reinterpret_cast<uintptr_t>(a.rgb) % 4 == 0;
    for (int k = 0; k < 3; ++k)
        vec = vec && reinterpret_cast<uintptr_t>(a.color[k]) % 16 == 0;
    constexpr int kSpan = kResolveThreads * kPix;
    const dim3 grid((a.width + kSpan - 1) / kSpan, a.height);
    if (vec)
        rt_resolve_kernel<true><<<grid, kResolveThreads, 0, s>>>(a);
    else
        rt_resolve_kernel<false><<<grid, kResolveThreads, 0, s>>>(a);
    if (a.n_glass > 0) {
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
        const unsigned blocks =
            static_cast<unsigned>((a.n_glass + kThreads - 1) / kThreads);
        rt_resolve_glass_kernel<<<blocks, kThreads, 0, s>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
}

// Registers, local-memory bytes a thread, threads a block, resident blocks a
// SM and dynamic shared bytes a block of kernel k (rt_light_rays, rt_shade,
// rt_glass_rays, rt_resolve's vector path, rt_resolve_glass); rt_shade's as
// a launch with these tables takes it, staged or not.
extern "C" int ptrt_rt_info(int k, const RtArgs* args, int* regs,
                            int* local_bytes, int* threads, int* per_sm,
                            int* shared_bytes) {
    int bytes = 0;
    bool staged = false;
    cudaError_t e = cudaSuccess;
    if (k == 1) e = shade_staging(args, &bytes, &staged);
    if (!staged) bytes = 0;
    const void* kernel =
        k == 0   ? reinterpret_cast<const void*>(rt_light_rays_kernel)
        : k == 1 ? (staged ? reinterpret_cast<const void*>(
                                 rt_shade_kernel<true>)
                           : reinterpret_cast<const void*>(
                                 rt_shade_kernel<false>))
        : k == 2 ? reinterpret_cast<const void*>(rt_glass_rays_kernel)
        : k == 3 ? reinterpret_cast<const void*>(rt_resolve_kernel<true>)
                 : reinterpret_cast<const void*>(rt_resolve_glass_kernel);
    const int block = k == 3 ? kResolveThreads : kThreads;
    cudaFuncAttributes attr = {};
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
    *threads = block;
    *shared_bytes = bytes;
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                          block, bytes);
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    return static_cast<int>(e);
}
