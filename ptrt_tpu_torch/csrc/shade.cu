// shade_nee and shade_scatter: the per-bounce shading of the wavefront path
// tracer (K3), the two stages around the shadow walk.
//
// Replaces: the bounce body of ptrt_tpu/render/integrator.py trace_path
// (:285-466) between the walks, which XLA compiles into the fusions of the
// jitted trace program: the material fetch (scene/materials.py:147), the
// bounce-0 G-buffer, sky on miss (render/sky.py sample_sky), Beer-Lambert,
// emission, next-event estimation (render/nee.py sample_light :21 and
// sample_direct_lighting :101), MIS (render/bsdf.py material_pdf :157,
// mis_weight :27), material_scatter (:222), Russian roulette and the ray
// advance.  Per bounce:  K1 closest_hit -> shade_nee -> K2 any_hit ->
// shade_scatter.
//
// What bounds them on the card: memory traffic, and from bounce 1 on how
// sparsely it is used.  A lane's arithmetic is a few thousand float
// operations at most, while each stage reads and writes the lane's PathState
// planes (origin, direction, throughput, four accumulators, flags, PCG
// state: up to ~140 bytes in, ~100 out) and the records between the stages
// (hit: ~30 bytes; NEE: ~50 bytes).  After bounce 0 most lanes are dead (at
// 1080p on the bench scene 61%, 8% and 4% of the lanes are alive at
// bounces 1, 2 and 3) and lie scattered among the live ones, so a live
// lane's 4-byte reads each cost a 32-byte sector and its chain of dependent
// loads (alive, K1's slot, the triangle, the material, the light) runs for
// a warp that holds one or two such lanes.  The plain torch version runs the
// same work as ~2,700 elementwise launches a bounce, each a round trip of
// whole planes through device memory, and its material fetch alone writes
// 32 planes (265 MB at 1080p) that the shading reads back.
//
// What this design does about it: every intermediate in registers.  The
// material table (M x 32 floats) and the light table are staged in shared
// memory when they fit (read through __ldg when not), so the material fetch
// is a shared-memory row read folded into each stage.  The hit record
// (point, face-forwarded normal, front flag) is rebuilt here from K1's
// triangle slot, so no torch op runs between the kernels.  Planes are
// updated in place.  Dead lanes (and lanes without NEE) skip the shading
// whose result the plain version masks away, but still draw their PCG
// numbers, so the streams stay bit-exact on every lane.
//
// shade_nee moves for a dead lane only what nothing can spare: it reads the
// alive flag and the PCG state and writes the hit and NEE flags, the state
// and t_max = -1.  K1's answer, the ray and the record's other planes are
// never touched there (the record's contract in render/shade.py says which
// planes hold where); a live lane that misses writes no hit record, one
// without NEE no shadow record.  A block stages the tables once for 512
// lanes, two to a thread.  Bounce 0 shades every lane (the G-buffer is
// written on every lane).  A 1080p wavefront takes 0.12, 0.10, 0.07 and
// 0.06 ms at bounces 0-3.  What is left at the sparse bounces is
// the sectors: counted at 32 bytes for each scattered 4-byte access, bounce
// 3 moves ~150 MB, 0.045 ms at the card's rate.  Filling warps with live
// lanes from a block-local list (only the NEE part, or the whole live path)
// gained 2-4% at bounces 1-3 and lost 1-3% at bounce 0, asking for the next
// lanes' flags ahead lost 3%, and more resident blocks spilled: all left
// out, with their times in PERF.md.
//
// shade_scatter waits on the chain of loads of its live lanes, so what sets
// its time is how many lanes a SM has in flight and how sparsely they lie.
// A block of 256 threads asks for every lane's alive flag and PCG state and
// for the material table at once (shade_scatter reads no light), finishes
// the dead lanes (their PCG stream only) and then runs the live path.  At
// bounce 0, where 61% of the lanes live, side by side, each thread keeps
// its one lane and the kernel is held to 64 registers, 4 blocks a SM.  From
// bounce 1 on a block takes 1,024 lanes, four a thread, and lists its live
// lanes with their PCG states in shared memory, so a warp runs the lobe
// code for 32 live lanes and not for the one or two among dead ones it
// held (at bounce 1, 11% of the lanes live and 39% of the warps hold one);
// 80 registers, 3 blocks a SM.  A live lane reads its NEE record only where
// do_nee and pdf > 0 (its contribution only where lit) and the hit point
// only where it survives, and writes its alive flag only where it dies.
// Each lane carries its own PCG state, so its numbers do not depend on the
// thread that runs it.  A 1080p wavefront takes 0.113, 0.076, 0.060 and
// 0.044 ms at bounces 0-3, against 0.121, 0.096, 0.077 and 0.061 for the
// earlier design's one thread a lane in 128-thread blocks.  Asking for every plane a live
// lane may need at once (its NEE record, accumulators and hit point) lost
// 5-25% at bounces 1-3, with or without spills; 2 lanes a thread measured
// within 3% of 4; the bounce-0 kernel at 3 blocks a SM (70-80 registers)
// lost 8-14% (PERF.md).
//
// shade_scatter also adds the bounce's rays into the trace's int64 counter
// (ShadeArgs.rays; replaces ptrt_tpu/render/integrator.py :302, :378, :401,
// the reference's ray counts): each NEE lane's shadow rays (count_casts,
// one for the env and one for the light sample) and, but at the last
// bounce, each lane it leaves alive for the next bounce's K1, bounce 0
// adding the base (its walk took every lane).  A lane dead on entry adds
// nothing: shade_nee writes do_nee false on every such lane.  One atomic a
// block adds the block's sum, so the count costs no launch of its own (it
// was a kernel of its own, 0.0036 ms a bounce at 1080p, half of it the
// launch).  From bounce 1 a live lane returns its rays (its do_nee is
// loaded with its record, its survival is the scatter's own result), a
// thread sums its lanes in a register, a warp with __reduce_add_sync and
// the block in shared memory.  At bounce 0, where the lane code leaves no
// register to spare (the HDRI kernel spills), a lane returns only whether
// it lives on: the prologue's barrier counts the block's NEE lanes from
// their do_nee flags (__syncthreads_count) and a barrier after the lane
// work counts the survivors.  Summing the rays in the lane code there
// raised the HDRI kernel's spills from 56 / 76 to 68 / 92 bytes and its
// time by 5%; counting from bounce 1 on as at bounce 0 cost 0.005 ms at
// bounce 3, and reading the flags back from the planes after the lane work
// 0.007 (PERF.md).  Bounces 0-3 each take 0.000-0.003 ms more.

// The HDRI kernels (shade_nee_kernel_hdri, shade_scatter_kernel<.., true>;
// launched where the sky is an HDRI, which always comes with env NEE:
// env_nee set, env_map set) also replace the env parts of integrator.py
// (:326-345, :375-399, :431-437), render/sky.py sample_env :171,
// env_pdf_dir :215 and the HDRI sample_sky :232, and render/nee.py
// sample_env_lighting :164.  A miss fetches the map bilinearly,
// MIS-weighted against the env sampler where the lane drew an env sample
// at its last hit and did not scatter specularly.  A NEE lane draws its env
// sample (four PCG numbers, before the light's five) from the alias table
// and writes the env record; shade_scatter adds the env term before the
// light's and, where the lane survives its scatter, writes the MIS carries
// (prev_pdf, prev_nee).  What holds them is latency and the map's texels:
// a live lane's chain of dependent loads, and at bounce 0 a NEE lane's env
// texels and from bounce 1 a miss's, scattered over a 100 MB map.
//
// The design: shade_nee from bounce 1 lists a block's 1,024 live lanes,
// four a thread, in shared memory with their PCG states and K1's slots,
// hits from the back and misses from the front, and runs the hits, then
// the misses, so a warp runs one path for 32 lanes (the first design ran
// every lane, the env work for one or two live lanes of a warp).  A NEE
// lane draws both directions and writes their rays first, then fetches its
// material once and builds its Lobes once for both BSDFs and the env MIS
// pdf; a miss maps its direction once for the radiance and the pdf.  The
// map is read as each texel's bilinear quad (SkyConfig.env_quads: one
// aligned 64-byte read a fetch, where the map's own rows cost two to four
// sectors; 5.3 times the map's bytes, made once a map on the card and
// read by every frame program where it lies).  shade_scatter fetches the
// material after the env term and shares one Lobes between its two
// material_pdf's.  shade_nee at 3 blocks a SM (73 / 75 registers, no
// spills; at 4, 64 registers spilled 40-68 bytes and lost 2-5%),
// shade_scatter at 4 blocks at bounce 0 (64 registers, 56 bytes spilled
// before the ray count, 64 with it; 3 blocks lost 10%) and 3 from bounce 1
// (80, 20 bytes before the count, 36 with it; 2 blocks lost 10%, 4
// spilled 108 bytes and lost 8%).
// 128-thread blocks and the env texels prefetched across the light sample
// measured slower; a 16-byte texel copy gained 1-2%, texel pairs no more,
// the quads 8%.  The two families share the G-buffer writes
// (gbuffer_hit, gbuffer_miss), the scatter's NEE term (add_nee) and its
// tail (scatter_on).  Called from the gradient kernels, helpers for the
// hit normal, Beer-Lambert and emission, the NEE record's store and the
// BSDF and pdf past their lane terms each changed those kernels' SASS,
// which stays as it was (digests compiled on the card, PERF.md), so
// nee_lane, nee_sample, evaluate_bsdf and material_pdf keep their own
// copies of that code and env_hit, env_nee, evaluate_bsdf_at and
// material_pdf_at theirs: a change to one is made to both, bit for bit.
// From bounce 1 a block's lists (8 KB in the scatter, 12 KB in shade_nee)
// sit beside the staged tables, past the default 48 KB a block, so every
// launch raises the kernel's cap (allow_tables).  Split, bounces 0-3,
// the 1080p hdri wavefronts: shade_nee 0.276 / 0.272 / 0.176 / 0.130 ->
// 0.244 / 0.217 / 0.110 / 0.079 ms, shade_scatter 0.194 / 0.123 / 0.088 /
// 0.060 -> 0.178 / 0.116 / 0.083 / 0.058 (PERF.md).

// Float order: this file builds with -fmad=false and follows the plain torch
// version operation by operation, including how torch on the card rounds
// scalars: `x / c` for a Python scalar c multiplies by the float reciprocal
// of float(c); `c / x` is (1 / x) * c; `vec.sdiv` divides.  Python-side
// constants are rounded from double, as torch does (F below).

#include <cuda_runtime.h>
#include <stdint.h>

#define F(x) static_cast<float>(x)

struct ShadeArgs {
    long long n;
    // tables
    const float* mat;          // (n_mats, mat_width) material rows
    const float* lights;       // (n_light_rows, light_width) light rows
    const float* sky;          // top xyz, bottom xyz, use_sky (, rotation)
    const float* e1[3];        // triangle edges by slot (hit normal)
    const float* e2[3];
    int n_mats, mat_width, n_light_rows, light_width;
    int n_lights;              // lights to pick from; 0: no NEE
    float pdf_pick;            // float(1.0 / n_lights)
    // K1's answer
    const float* hit_t;
    const int* hit_slot;
    const int* hit_mesh;
    // PathState, updated in place
    float* o[3];
    float* d[3];
    float* thr[3];
    float* acc[3];
    float* acc_d[3];           // split channels (null unless split)
    float* acc_s[3];
    float* acc_e[3];
    uint8_t* alive;
    uint8_t* ray_spec;
    uint8_t* prev_spec;
    uint8_t* path_spec;
    long long* rng;            // PCG state, values in [0, 2^32)
    float* first_normal[3];
    float* first_depth;
    int* first_obj;
    float* first_rough;
    float* first_trans;
    // hit record: written by shade_nee, read by shade_scatter
    uint8_t* hit;
    float* point[3];
    float* normal[3];
    uint8_t* front;
    // NEE record: written by shade_nee, read by shade_scatter
    uint8_t* do_nee;
    float* shadow_o[3];
    float* l[3];
    float* shadow_t;
    float* pdf_nee;
    float* nee_c[3];           // unshadowed, clamped (the diffuse half if split)
    float* nee_s[3];           // the specular half (split only)
    const uint8_t* in_shadow;  // K2's answer (shade_scatter)
    int split, bounce, rr_enabled, rr_start;
    // the HDRI sky and its env NEE, both on or both off (env_nee 0 and
    // env_map null: the gradient); env_nee picks the kernels' instantiation
    const float* env_map;        // (env_map_h, env_map_w, 4, 4): each
                                 // texel's bilinear quad of the linear HDR
                                 // map (SkyConfig.env_quads)
    const float* env_alias;      // (env_sh * env_sw, 2): keep prob, alias index
    const float* env_pdf_table;  // (env_sh * env_sw,) solid-angle pdf
    int env_map_h, env_map_w, env_sh, env_sw;
    float env_inv_sh, env_inv_sw, env_pi_sh;  // float(1/sh), (1/sw), (pi/sh)
    int env_nee;
    // the env MIS carries (PathState), updated in place by shade_scatter
    float* prev_pdf;
    uint8_t* prev_nee;
    // the env sample's record: written by shade_nee, read by shade_scatter
    float* env_o[3];
    float* env_l[3];
    float* env_t;
    float* env_pdf;
    float* env_mis;            // mis_weight(env pdf, material_pdf)
    float* env_c[3];           // unshadowed, clamped (the diffuse half if split)
    float* env_cs[3];          // the specular half (split only)
    const uint8_t* in_shadow_env;  // K2's answer for the env shadow rays
    // instances (all null without them): K4's instance plane; where it is
    // >= 0, hit_slot indexes the instance set's edges and the normal goes
    // through the instance's normal matrix (columns 12:21 of its row)
    const int* hit_inst;
    const float* inst_e1[3];
    const float* inst_e2[3];
    const float* inst_mats;    // (I, 24)
    // the trace's ray count, added by shade_scatter (rays null: none):
    // count_base, count_casts shadow rays for each lane with do_nee, and,
    // where count_next, the lanes it leaves alive for the next bounce's walk
    long long* rays;           // 0-d int64, added into
    long long count_base;
    int count_casts, count_next;
};

namespace {

constexpr int kNeeThreads = 256;   // shade_nee's block
constexpr int kNeeChunk = 512;     // lanes a block takes
constexpr int kNeeBlocks = 4;      // resident blocks a SM it is compiled for
constexpr int kScatterThreads = 256;  // shade_scatter's block
constexpr int kScatterLanes = 4;      // lanes a thread from bounce 1 on
// resident blocks a SM each shade_scatter is compiled for: bounce 0 (64
// registers) and from bounce 1 on (80)
constexpr int kScatterB0Blocks = 4, kScatterBlocks = 3;
// the HDRI kernels: shade_nee's lanes a thread from bounce 1 on (a block
// of kNeeThreads lists kEnvNeeChunk lanes), and the resident blocks a SM
// each is compiled for: shade_nee at bounce 0 and from bounce 1 on,
// shade_scatter at bounce 0 and from bounce 1 on
constexpr int kEnvNeeLanes = 4;
constexpr int kEnvNeeChunk = kNeeThreads * kEnvNeeLanes;
constexpr int kEnvNeeBlocks = 3, kEnvListBlocks = 3;
constexpr int kEnvScatterB0Blocks = 4, kEnvScatterBlocks = 3;
constexpr int kMaxStagedBytes = 48 * 1024;
constexpr float kPi = F(3.141592653589793);
constexpr float kTwoPi = F(2.0 * 3.141592653589793);
constexpr float kInvPi = F(1.0 / 3.141592653589793);  // (1.0 / PI)
constexpr float kInvTwoPi = F(1.0 / (2.0 * 3.141592653589793));  // 1/TWO_PI
constexpr float kMinRough = F(0.02);
constexpr float kMaxBounceWeight = 50.0f;
constexpr float kMaxNee = 500.0f;
constexpr float kRrMin = F(0.05), kRrMax = F(0.95);
// light types (scene/lights.py)
constexpr int kDirectional = 1, kSpot = 2, kArea = 3;

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
__device__ __forceinline__ V3 div(V3 a, float s) {
    return V3{a.x / s, a.y / s, a.z / s};
}
__device__ __forceinline__ V3 neg(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }
__device__ __forceinline__ float dot(V3 a, V3 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
    return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 ld3(const float* const p[3], long long i) {
    return V3{p[0][i], p[1][i], p[2][i]};
}
__device__ __forceinline__ void st3(float* const p[3], long long i, V3 v) {
    p[0][i] = v.x;
    p[1][i] = v.y;
    p[2][i] = v.z;
}

// torch's clamp_min / clamp_max / clamp / maximum: NaN propagates
__device__ __forceinline__ float cmax(float x, float s) {
    return isnan(x) ? x : fmaxf(x, s);
}
__device__ __forceinline__ float cmin(float x, float s) {
    return isnan(x) ? x : fminf(x, s);
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
__device__ __forceinline__ float max_component(V3 v) {
    return tmaximum(v.x, tmaximum(v.y, v.z));
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
__device__ __forceinline__ float luminance(V3 c) {
    return F(0.2126) * c.x + F(0.7152) * c.y + F(0.0722) * c.z;
}
// vec.clamp_vector_soft
__device__ __forceinline__ V3 clamp_soft(V3 v, float max_lum) {
    const float lum = luminance(v);
    const float scale =
        (lum > max_lum && lum > 0.0f) ? max_lum / cmax(lum, F(1e-30)) : 1.0f;
    return mul(v, scale);
}

// -- PCG (core/rng.py) --------------------------------------------------------

__device__ __forceinline__ float uniform(uint32_t& s) {
    s = s * 747796405u + 2891336453u;
    uint32_t word = ((s >> ((s >> 28) + 4)) ^ s) * 277803737u;
    word = (word >> 22) ^ word;
    return static_cast<float>(word) * F(2.3283064365386963e-10);
}
__device__ __forceinline__ void skip(uint32_t& s, int k) {
    for (int j = 0; j < k; ++j) uniform(s);
}

__device__ __forceinline__ void ortho_normal_basis(V3 n, V3& t, V3& bt) {
    const float len2 = dot(n, n);
    const V3 nn = mul(n, rsqrtf(cmax(len2, F(1e-30))));
    const float s = nn.z >= 0.0f ? 1.0f : -1.0f;
    const float a = -(1.0f / (s + nn.z));
    const float b = nn.x * nn.y * a;
    t = V3{1.0f + s * nn.x * nn.x * a, s * b, -s * nn.x};
    bt = cross(nn, t);
    if (len2 < F(1e-20)) {
        t = V3{1.0f, 0.0f, 0.0f};
        bt = V3{0.0f, 1.0f, 0.0f};
    }
}
__device__ __forceinline__ V3 to_world(V3 t, V3 b, V3 n, V3 s) {
    return add(add(mul(t, s.x), mul(b, s.y)), mul(n, s.z));
}
__device__ __forceinline__ V3 hemisphere_to_world(V3 s, V3 n) {
    V3 t, b;
    ortho_normal_basis(n, t, b);
    return to_world(t, b, n, s);
}
__device__ __forceinline__ V3 cone_direction_from(float u1, float u2, V3 dir,
                                                  float cos_max) {
    const float ct = 1.0f - u1 * (1.0f - cos_max);
    const float st = sqrtf(cmax(1.0f - ct * ct, 0.0f));
    const float phi = u2 * kTwoPi;
    return hemisphere_to_world(V3{st * cosf(phi), st * sinf(phi), ct}, dir);
}
__device__ __forceinline__ V3 cosine_hemisphere_from(float u1, float u2) {
    const float r = sqrtf(u1);
    const float phi = u2 * kTwoPi;
    return V3{r * cosf(phi), r * sinf(phi), sqrtf(cmax(1.0f - u1, 0.0f))};
}
__device__ __forceinline__ V3 ggx_half_vector_from(float u1, float u2, V3 n,
                                                   float rough) {
    const float a = rough * rough;
    const float a2 = a * a;
    const float u2c = cmin(u2, F(0.9999999));
    const float phi = u1 * kTwoPi;
    const float ct = sqrtf((1.0f - u2c) / ((a2 - 1.0f) * u2c + 1.0f));
    const float st = sqrtf(cmax(1.0f - ct * ct, 0.0f));
    return hemisphere_to_world(V3{st * cosf(phi), st * sinf(phi), ct}, n);
}

// -- tables -------------------------------------------------------------------

struct Mat {
    V3 albedo, specular, emission, sheen_tint;
    float metallic, roughness, ior, transmission, transmission_roughness;
    float clearcoat, clearcoat_roughness, sheen, iridescence,
        iridescence_thickness;
};

// scene/materials.py packed row: albedo 0-2, specular 3-5, emission 6-8,
// subsurface_color 9-11, sheen_tint 12-14, then the scalars from 15
__device__ __forceinline__ Mat load_mat(const float* r) {
    Mat m;
    m.albedo = V3{r[0], r[1], r[2]};
    m.specular = V3{r[3], r[4], r[5]};
    m.emission = V3{r[6], r[7], r[8]};
    m.sheen_tint = V3{r[12], r[13], r[14]};
    m.metallic = r[15];
    m.roughness = r[16];
    m.ior = r[17];
    m.transmission = r[18];
    m.transmission_roughness = r[19];
    m.clearcoat = r[20];
    m.clearcoat_roughness = r[21];
    m.sheen = r[24];
    m.iridescence = r[25];
    m.iridescence_thickness = r[26];
    return m;
}

// stage the material and light tables in shared memory when they fit;
// returns whether they were staged
__device__ bool stage_tables(const ShadeArgs& a, float* smem,
                             const float*& mat, const float*& lights) {
    const int n_mat = a.n_mats * a.mat_width;
    const int n_light = a.lights ? a.n_light_rows * a.light_width : 0;
    mat = a.mat;
    lights = a.lights;
    if ((n_mat + n_light) * 4 > kMaxStagedBytes) return false;
    for (int k = threadIdx.x; k < n_mat; k += blockDim.x)
        smem[k] = __ldg(a.mat + k);
    for (int k = threadIdx.x; k < n_light; k += blockDim.x)
        smem[n_mat + k] = __ldg(a.lights + k);
    __syncthreads();
    mat = smem;
    lights = smem + n_mat;
    return true;
}
__device__ __forceinline__ float tload(const float* p, bool staged) {
    return staged ? *p : __ldg(p);
}
__device__ Mat fetch_mat(const ShadeArgs& a, const float* table, bool staged,
                         int id) {
    id = min(max(id, 0), a.n_mats - 1);
    const float* r = table + static_cast<long long>(id) * a.mat_width;
    if (staged) return load_mat(r);
    float row[27];
#pragma unroll
    for (int k = 0; k < 27; ++k) row[k] = __ldg(r + k);
    return load_mat(row);
}

// -- render/pbr.py ------------------------------------------------------------

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
__device__ __forceinline__ float distribution_ggx(V3 n, V3 h, float rough) {
    const float a = rough * rough;
    const float a2 = a * a;
    const float ndoth = cmax(dot(n, h), 0.0f);
    float denom = ndoth * ndoth * (a2 - 1.0f) + 1.0f;
    denom = denom * kPi * denom;
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
__device__ __forceinline__ float geometry_smith_transmission(V3 n, V3 v, V3 l,
                                                            float rough) {
    const float ndotv = cmax(dot(n, v), 0.0f);
    const float ndotl = fabsf(dot(n, l));
    return schlick_ggx(ndotl, rough) * schlick_ggx(ndotv, rough);
}
__device__ __forceinline__ float schlick_dielectric(float cos_theta,
                                                   float ior_i, float ior_t) {
    const float c = clamp01(cos_theta);
    float r0 = (ior_i - ior_t) / (ior_i + ior_t);
    r0 = r0 * r0;
    return r0 + (1.0f - r0) * pow5(1.0f - c);
}

// calculate_iridescence(thickness, cos_theta, 1.3, ior)
__device__ V3 iridescence(float thickness, float cos_theta, float base_ior) {
    constexpr double film = 1.3;
    constexpr double r_af_d = ((1.0 - film) / (1.0 + film)) *
                              ((1.0 - film) / (1.0 + film));
    const float r_af = F(r_af_d);
    const float c = clamp01(cos_theta);
    const float sin_theta = sqrtf(cmax(1.0f - c * c, 0.0f));
    const float sin_film = sin_theta * (1.0f / F(film));
    const bool tir = sin_film * sin_film > 1.0f;
    const float cos_film = sqrtf(cmax(1.0f - sin_film * sin_film, 0.0f));
    const float opd = thickness * F(2.0 * film) * cos_film;
    float r_fb = (F(film) - base_ior) / (base_ior + F(film));
    r_fb = r_fb * r_fb;
    const float sqrt_r1r2 = sqrtf(r_fb * r_af);
    float r_max = sqrtf(r_af) + sqrtf(r_fb);
    r_max = r_max * r_max;
    const float inv_r_max = 1.0f / (r_max + F(1e-6));
    float out[3];
    const float wl[3] = {650.0f, 550.0f, 450.0f};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float delta = opd * kTwoPi * (1.0f / wl[k]);
        const float r_total = (r_fb + r_af) + sqrt_r1r2 * 2.0f * cosf(delta);
        out[k] = tir ? 1.0f : clamp01(r_total * inv_r_max);
    }
    return V3{out[0], out[1], out[2]};
}

// -- render/bsdf.py -----------------------------------------------------------

__device__ __forceinline__ float mis_weight(float pdf1, float pdf2) {
    const float p1 = pdf1 * pdf1;
    const float p2 = pdf2 * pdf2;
    return p1 / (p1 + p2 + F(1e-10));
}

__device__ V3 f0_base(const Mat& m, float ndotv) {
    const float metal = clamp01(m.metallic);
    const V3 f0 = lerp(m.specular, m.albedo, metal);
    const float irid = clamp01(m.iridescence);
    if (!(irid > 0.0f)) return f0;
    return lerp(f0, iridescence(m.iridescence_thickness, ndotv, m.ior), irid);
}

__device__ __forceinline__ bool is_transmissive(const Mat& m) {
    return clamp01(m.transmission) > 0.0f && clamp01(m.metallic) < F(0.1);
}

// evaluate_bsdf (full) for a transmissive lane; returns f * |NdotL|
__device__ V3 bsdf_transmissive(V3 n, bool front, const Mat& m, V3 l, V3 v,
                                float ndotv, V3 f0b, V3 f_r, float d_r,
                                float g_r) {
    const float metal = clamp01(m.metallic);
    const float rough = cmax(m.roughness, kMinRough);
    const float ndotl_s = dot(n, l);
    if (ndotv <= 0.0f) return v3(0.0f);
    if (ndotl_s > 0.0f) {
        const V3 spec_refl = mul(
            f_r, d_r * g_r / (ndotv * 4.0f * cmax(ndotl_s, 0.0f) + F(1e-6)));
        return mul(spec_refl, cmax(ndotl_s, 0.0f));
    }
    const float trans_rough = tmaximum(m.transmission_roughness, rough);
    const float eta = front ? 1.0f / m.ior : m.ior;
    V3 h_t = normalize(neg(add(mul(v, eta), l)), F(1e-20));
    h_t = sel(dot(n, h_t) < 0.0f, neg(h_t), h_t);
    const float vdoth_t = cmax(dot(v, h_t), 0.0f);
    const float ldoth_t = fabsf(dot(l, h_t));
    const float ndotl_abs = fabsf(ndotl_s);
    const float k = 1.0f - eta * eta * (1.0f - vdoth_t * vdoth_t);
    const float d_t = distribution_ggx(n, h_t, trans_rough);
    const float g_t = geometry_smith_transmission(n, v, l, trans_rough);
    const V3 f_t = sub(v3(1.0f), fresnel_schlick(vdoth_t, f0b));
    const float numer =
        eta * eta * (1.0f - metal) * g_t * d_t * vdoth_t * ldoth_t;
    const float sq = eta * vdoth_t + ldoth_t;
    const float denom = ndotv * ndotl_abs * (sq * sq);
    const V3 btdf = mul(mul(m.albedo, f_t), numer / (denom + F(1e-6)));
    return k >= 0.0f ? mul(btdf, ndotl_abs) : v3(0.0f);
}

// evaluate_bsdf, or evaluate_bsdf_split's (diffuse, specular) when split;
// `diff` is zero unless split
__device__ void evaluate_bsdf(V3 n, bool front, const Mat& m, V3 l, V3 v,
                              bool split, V3& diff, V3& spec) {
    const float ndotv = cmax(dot(n, v), 0.0f);
    const float metal = clamp01(m.metallic);
    const float rough = cmax(m.roughness, kMinRough);
    const V3 f0b = f0_base(m, ndotv);
    const float ndotl_s = dot(n, l);
    const V3 h_r = normalize(add(l, v), F(1e-20));
    const float d_r = distribution_ggx(n, h_r, rough);
    const float g_r = geometry_smith(n, v, l, rough);
    const float vdoth_r = cmax(dot(v, h_r), 0.0f);
    const V3 f_r = fresnel_schlick(vdoth_r, f0b);
    diff = v3(0.0f);
    if (is_transmissive(m)) {
        // split: all of it in the specular channel
        spec = bsdf_transmissive(n, front, m, l, v, ndotv, f0b, f_r, d_r, g_r);
        return;
    }
    const float ndotl = cmax(ndotl_s, 0.0f);
    const bool zero = ndotv <= 0.0f || ndotl_s <= 0.0f;
    const V3 s = mul(f_r, d_r * g_r / (ndotv * 4.0f * ndotl + F(0.001)));
    const V3 kd = mul(sub(v3(1.0f), f_r), 1.0f - metal);
    const V3 dif = mul(mul(kd, m.albedo), kInvPi);
    if (zero) {
        spec = v3(0.0f);
    } else if (split) {
        spec = mul(s, ndotl);
        diff = mul(dif, ndotl);
    } else {
        spec = mul(add(dif, s), ndotl);
    }
}

__device__ float pdf_ggx_reflect(V3 n, V3 v, V3 l, float rough) {
    const float ndotv = cmax(dot(n, v), 0.0f);
    const V3 h = normalize(add(v, l), F(1e-20));
    const float ndoth = cmax(dot(n, h), 0.0f);
    const float vdoth = cmax(dot(v, h), 0.0f);
    const float d = distribution_ggx(n, h, rough);
    const float pdf = d * ndoth / (vdoth * 4.0f + F(1e-6));
    return ndotv == 0.0f ? 0.0f : pdf;
}

__device__ float pdf_ggx_refract(V3 n, V3 v, V3 l, float rough, float eta) {
    const float ndotv = cmax(dot(n, v), 0.0f);
    const float ndotl = dot(n, l);
    V3 h = normalize(neg(add(mul(v, eta), l)), F(1e-20));
    h = sel(dot(n, h) < 0.0f, neg(h), h);
    const float vdoth = cmax(dot(v, h), 0.0f);
    const float ldoth = fabsf(dot(l, h));
    const float ndoth = cmax(dot(n, h), 0.0f);
    const float d = distribution_ggx(n, h, rough);
    const float sq = eta * vdoth + ldoth;
    const float dwh_dwo = (eta * eta * ldoth) / (sq * sq + F(1e-12));
    const float pdf = d * ndoth * fabsf(dwh_dwo);
    return (ndotv <= 0.0f || ndotl >= 0.0f) ? 0.0f : pdf;
}

__device__ float material_pdf(V3 n, bool front, const Mat& m, V3 v, V3 l) {
    const float ndotv = cmax(dot(n, v), 0.0f);
    if (ndotv == 0.0f) return 0.0f;
    const float ndotl_s = dot(n, l);
    const float ndotl = cmax(ndotl_s, 0.0f);
    const float metal = clamp01(m.metallic);
    const float rough = cmax(m.roughness, kMinRough);

    const float clearcoat = clamp01(m.clearcoat);
    const float cc_rough = cmax(m.clearcoat_roughness, F(0.001));
    const float fc = fresnel_coat(ndotv);
    const float f_coat_avg = (fc + fc + fc) * F(1.0 / 3.0);
    const bool has_coat = clearcoat > 0.0f;
    const float p_coat = has_coat ? clamp01(f_coat_avg * clearcoat) : 0.0f;
    float total = 0.0f;
    total = total + ((has_coat && ndotl_s > 0.0f)
                         ? p_coat * pdf_ggx_reflect(n, v, l, cc_rough)
                         : 0.0f);
    const float prob_base = has_coat ? 1.0f - p_coat : 1.0f;

    if (is_transmissive(m)) {
        const float trans_rough = tmaximum(m.transmission_roughness, rough);
        const float ior_ratio = front ? 1.0f / m.ior : m.ior;
        const float reflect_prob = schlick_dielectric(ndotv, 1.0f, ior_ratio);
        if (ndotl_s > 0.0f) {
            const float pdf_reflect = pdf_ggx_reflect(n, v, l, rough);
            const V3 h = normalize(add(v, l), F(1e-20));
            const float vdoth = cmax(dot(v, h), 0.0f);
            const float k =
                1.0f - ior_ratio * ior_ratio * (1.0f - vdoth * vdoth);
            const float pdf_tir = pdf_ggx_reflect(n, v, l, trans_rough);
            const float trans_pos =
                prob_base * reflect_prob * pdf_reflect +
                (k < 0.0f ? prob_base * (1.0f - reflect_prob) * pdf_tir
                          : 0.0f);
            return total + trans_pos;
        }
        const float pdf_refract =
            pdf_ggx_refract(n, v, l, trans_rough, ior_ratio);
        return total + prob_base * (1.0f - reflect_prob) * pdf_refract;
    }
    const V3 f_base = fresnel_schlick(ndotv, f0_base(m, ndotv));
    const float specular_prob = metal > 0.0f ? 1.0f : max_component(f_base);
    if (!(ndotl_s > 0.0f)) return total + 0.0f;
    const float pdf_spec = pdf_ggx_reflect(n, v, l, rough);
    const float pdf_diff = cmax(ndotl, 0.0f) * kInvPi;
    return total + prob_base * (specular_prob * pdf_spec +
                                (1.0f - specular_prob) * pdf_diff);
}

// The terms of evaluate_bsdf and material_pdf that depend only on the
// normal, v = -d and the material, for the HDRI kernels: built once a lane
// and shared by every direction the lane evaluates (shade_nee: the env
// sample's and the light's BSDF and the env MIS pdf; shade_scatter: the
// light's MIS pdf and the scatter direction's).  Each value comes from the
// same operations as in the two functions above, so evaluate_bsdf_at and
// material_pdf_at return their bits.  Their bodies repeat the two
// functions': the gradient kernels' SASS changed when the two called
// shared helpers for them (see the note at the top), so each keeps its
// own copy, and a change to one is made to both.
struct Lobes {
    float ndotv, metal, rough, trans_rough, eta;
    V3 f0b;
    bool trans, has_coat;
    float cc_rough, p_coat, prob_base, reflect_prob, specular_prob;
};

__device__ __forceinline__ Lobes lobes(V3 n, bool front, const Mat& m,
                                       V3 v) {
    Lobes b;
    b.ndotv = cmax(dot(n, v), 0.0f);
    b.metal = clamp01(m.metallic);
    b.rough = cmax(m.roughness, kMinRough);
    b.f0b = f0_base(m, b.ndotv);
    b.trans = is_transmissive(m);
    b.trans_rough = tmaximum(m.transmission_roughness, b.rough);
    b.eta = front ? 1.0f / m.ior : m.ior;
    const float clearcoat = clamp01(m.clearcoat);
    b.cc_rough = cmax(m.clearcoat_roughness, F(0.001));
    const float fc = fresnel_coat(b.ndotv);
    const float f_coat_avg = (fc + fc + fc) * F(1.0 / 3.0);
    b.has_coat = clearcoat > 0.0f;
    b.p_coat = b.has_coat ? clamp01(f_coat_avg * clearcoat) : 0.0f;
    b.prob_base = b.has_coat ? 1.0f - b.p_coat : 1.0f;
    b.reflect_prob = schlick_dielectric(b.ndotv, 1.0f, b.eta);
    const V3 f_base = fresnel_schlick(b.ndotv, b.f0b);
    b.specular_prob = b.metal > 0.0f ? 1.0f : max_component(f_base);
    return b;
}

// evaluate_bsdf on a lane's Lobes
__device__ void evaluate_bsdf_at(const Lobes& b, V3 n, bool front,
                                 const Mat& m, V3 l, V3 v, bool split,
                                 V3& diff, V3& spec) {
    const float ndotl_s = dot(n, l);
    const V3 h_r = normalize(add(l, v), F(1e-20));
    const float d_r = distribution_ggx(n, h_r, b.rough);
    const float g_r = geometry_smith(n, v, l, b.rough);
    const float vdoth_r = cmax(dot(v, h_r), 0.0f);
    const V3 f_r = fresnel_schlick(vdoth_r, b.f0b);
    diff = v3(0.0f);
    if (b.trans) {
        spec = bsdf_transmissive(n, front, m, l, v, b.ndotv, b.f0b, f_r, d_r,
                                 g_r);
        return;
    }
    const float ndotl = cmax(ndotl_s, 0.0f);
    const bool zero = b.ndotv <= 0.0f || ndotl_s <= 0.0f;
    const V3 s = mul(f_r, d_r * g_r / (b.ndotv * 4.0f * ndotl + F(0.001)));
    const V3 kd = mul(sub(v3(1.0f), f_r), 1.0f - b.metal);
    const V3 dif = mul(mul(kd, m.albedo), kInvPi);
    if (zero) {
        spec = v3(0.0f);
    } else if (split) {
        spec = mul(s, ndotl);
        diff = mul(dif, ndotl);
    } else {
        spec = mul(add(dif, s), ndotl);
    }
}

// material_pdf on a lane's Lobes
__device__ float material_pdf_at(const Lobes& b, V3 n, V3 v, V3 l) {
    if (b.ndotv == 0.0f) return 0.0f;
    const float ndotl_s = dot(n, l);
    const float ndotl = cmax(ndotl_s, 0.0f);
    float total = 0.0f;
    total = total + ((b.has_coat && ndotl_s > 0.0f)
                         ? b.p_coat * pdf_ggx_reflect(n, v, l, b.cc_rough)
                         : 0.0f);
    if (b.trans) {
        if (ndotl_s > 0.0f) {
            const float pdf_reflect = pdf_ggx_reflect(n, v, l, b.rough);
            const V3 h = normalize(add(v, l), F(1e-20));
            const float vdoth = cmax(dot(v, h), 0.0f);
            const float k = 1.0f - b.eta * b.eta * (1.0f - vdoth * vdoth);
            const float pdf_tir = pdf_ggx_reflect(n, v, l, b.trans_rough);
            const float trans_pos =
                b.prob_base * b.reflect_prob * pdf_reflect +
                (k < 0.0f ? b.prob_base * (1.0f - b.reflect_prob) * pdf_tir
                          : 0.0f);
            return total + trans_pos;
        }
        const float pdf_refract =
            pdf_ggx_refract(n, v, l, b.trans_rough, b.eta);
        return total + b.prob_base * (1.0f - b.reflect_prob) * pdf_refract;
    }
    if (!(ndotl_s > 0.0f)) return total + 0.0f;
    const float pdf_spec = pdf_ggx_reflect(n, v, l, b.rough);
    const float pdf_diff = cmax(ndotl, 0.0f) * kInvPi;
    return total + b.prob_base * (b.specular_prob * pdf_spec +
                                  (1.0f - b.specular_prob) * pdf_diff);
}

struct Scatter {
    V3 direction, attenuation;
    bool is_specular, valid;
};

__device__ Scatter material_scatter(uint32_t& s, V3 n, bool front,
                                    const Mat& m, V3 ray_dir) {
    const V3 v = neg(ray_dir);
    const float ndotv = cmax(dot(n, v), 0.0f);
    const float metal = clamp01(m.metallic);
    const float rough = cmax(m.roughness, kMinRough);
    const V3 f0b = f0_base(m, ndotv);
    const V3 f_base_nv = fresnel_schlick(ndotv, f0b);

    const float clearcoat = clamp01(m.clearcoat);
    const float cc_rough = cmax(m.clearcoat_roughness, F(0.001));
    const float fc_nv = fresnel_coat(ndotv);
    const float f_coat_avg = (fc_nv + fc_nv + fc_nv) * F(1.0 / 3.0);
    const float p_coat =
        clearcoat > 0.0f ? clamp01(f_coat_avg * clearcoat) : 0.0f;
    const float prob_base = 1.0f - p_coat;

    const bool is_trans = is_transmissive(m);
    const float trans_rough = tmaximum(m.transmission_roughness, rough);
    const float eta = front ? 1.0f / m.ior : m.ior;
    const float ior_i = front ? 1.0f : m.ior;
    const float ior_t = front ? m.ior : 1.0f;
    const float reflect_prob = schlick_dielectric(ndotv, ior_i, ior_t);
    const float p_trans_reflect = prob_base * reflect_prob;

    const float specular_prob =
        metal > 0.0f ? 1.0f : max_component(f_base_nv);
    const float p_opq_spec = prob_base * specular_prob;
    const float p_opq_diff = prob_base * (1.0f - specular_prob);

    // lobe selection: 0 coat, 1 base reflect, 2 refract, 3 diffuse, 4 absorb
    const float u = uniform(s);
    const float g1 = uniform(s);
    const float g2 = uniform(s);
    int lobe;
    if (u < p_coat) {
        lobe = 0;
    } else if (is_trans) {
        lobe = u < p_coat + p_trans_reflect ? 1 : 2;
    } else {
        lobe = u < p_coat + p_opq_spec ? 1 : (p_opq_diff > F(1e-6) ? 3 : 4);
    }

    V3 scattered;
    bool tir = false;
    if (lobe == 3) {
        scattered = hemisphere_to_world(cosine_hemisphere_from(g1, g2), n);
    } else {
        const float sample_rough =
            lobe == 0 ? cc_rough : (lobe == 2 ? trans_rough : rough);
        const V3 h = ggx_half_vector_from(g1, g2, n, sample_rough);
        if (lobe == 2) {
            const V3 h_refr = sel(dot(v, h) < 0.0f, neg(h), h);
            const float vdoth_tir = fabsf(dot(v, h_refr));
            const float k_tir =
                1.0f - eta * eta * (1.0f - vdoth_tir * vdoth_tir);
            tir = k_tir < 0.0f;
            if (tir) {
                scattered = reflect(neg(v), h_refr);
            } else {
                const float cos_t = sqrtf(cmax(k_tir, 0.0f));
                scattered = normalize(
                    add(mul(neg(v), eta),
                        mul(h_refr, eta * vdoth_tir - cos_t)),
                    F(1e-20));
            }
        } else {
            scattered = reflect(neg(v), h);
        }
    }
    scattered = normalize(scattered, F(1e-20));

    const bool is_refraction = lobe == 2 && !tir;
    bool is_specular = false;
    if (lobe == 0) is_specular = cc_rough < F(0.1);
    if (lobe == 1) is_specular = rough < F(0.1);
    if (lobe == 2) is_specular = tir || trans_rough < F(0.1);

    const float ndotl_s = dot(n, scattered);
    const float ndotl = cmax(ndotl_s, 0.0f);
    const float ndotl_abs = fabsf(ndotl_s);

    const V3 h_refl = normalize(add(v, scattered), F(1e-20));
    const float ndoth_refl = cmax(dot(n, h_refl), 0.0f);
    const float vdoth_refl = cmax(dot(v, h_refl), 0.0f);

    // clearcoat attenuation of the base
    const float vdoth_for_coat =
        is_refraction
            ? cmax(dot(v, normalize(add(mul(v, eta), scattered), F(1e-20))),
                   0.0f)
            : vdoth_refl;
    const float base_atten = 1.0f - fresnel_coat(vdoth_for_coat) * clearcoat;

    // coat lobe (NdotL > 0)
    float pdf_total = 0.0f;
    V3 f_total = v3(0.0f);
    const bool coat_on = p_coat > 0.0f && ndotl_s > 0.0f;
    if (coat_on) {
        const float d_coat = distribution_ggx(n, h_refl, cc_rough);
        const float g_coat = geometry_smith(n, v, scattered, cc_rough);
        const float f_coat = fresnel_coat(vdoth_refl);
        const float pdf_coat =
            d_coat * ndoth_refl / (vdoth_refl * 4.0f + F(1e-6));
        pdf_total = pdf_total + p_coat * pdf_coat;
        const float brdf_coat =
            f_coat * (d_coat * g_coat / (ndotv * 4.0f * ndotl + F(1e-6)));
        f_total = add(f_total, v3(brdf_coat * (clearcoat * ndotl)));
    } else {
        pdf_total = pdf_total + 0.0f;
        f_total = add(f_total, v3(0.0f));
    }

    // base reflection terms, shared by both cases
    const float d_refl_t = distribution_ggx(n, h_refl, rough);
    const float g_refl_t = geometry_smith(n, v, scattered, rough);
    const V3 f_refl_t = fresnel_schlick(vdoth_refl, f0b);
    const float pdf_refl_t =
        d_refl_t * ndoth_refl / (vdoth_refl * 4.0f + F(1e-6));

    float pdf_case;
    V3 f_case;
    if (is_trans) {
        const bool refl_on_t = p_trans_reflect > 0.0f && ndotl_s > 0.0f;
        float pdf_t = refl_on_t ? p_trans_reflect * pdf_refl_t : 0.0f;
        V3 f_t = v3(0.0f);
        if (refl_on_t) {
            const V3 brdf_refl_t =
                mul(f_refl_t, d_refl_t * g_refl_t /
                                  (ndotv * 4.0f * ndotl + F(1e-6)));
            f_t = mul(mul(brdf_refl_t, base_atten), ndotl);
        }
        // refraction btdf
        const float p_trans_refract = prob_base * (1.0f - reflect_prob);
        V3 h_rf = normalize(neg(add(mul(v, eta), scattered)), F(1e-20));
        h_rf = sel(dot(n, h_rf) < 0.0f, neg(h_rf), h_rf);
        const float vdoth_rf = cmax(dot(v, h_rf), 0.0f);
        const float ldoth_rf = fabsf(dot(scattered, h_rf));
        const float ndoth_rf = cmax(dot(n, h_rf), 0.0f);
        const float k_rf = 1.0f - eta * eta * (1.0f - vdoth_rf * vdoth_rf);
        const bool refr_on =
            p_trans_refract > 0.0f && ndotl_s < 0.0f && k_rf >= 0.0f;
        if (refr_on) {
            const float d_rf = distribution_ggx(n, h_rf, trans_rough);
            const float g_rf =
                geometry_smith_transmission(n, v, scattered, trans_rough);
            const float sq = eta * vdoth_rf + ldoth_rf;
            const float dwh_dwo = (eta * eta * ldoth_rf) / (sq * sq + F(1e-12));
            const float pdf_rf = d_rf * ndoth_rf * fabsf(dwh_dwo);
            pdf_t = pdf_t + p_trans_refract * pdf_rf;
            const V3 f_rf_fres =
                sub(v3(1.0f), fresnel_schlick(vdoth_rf, f0b));
            const float numer_rf = eta * eta * (1.0f - metal) * g_rf * d_rf *
                                   vdoth_rf * ldoth_rf;
            const float denom_rf = ndotv * ndotl_abs * (sq * sq);
            const V3 btdf = mul(mul(m.albedo, f_rf_fres),
                                numer_rf / (denom_rf + F(1e-6)));
            f_t = add(f_t, mul(mul(btdf, base_atten), ndotl_abs));
        } else {
            pdf_t = pdf_t + 0.0f;
            f_t = add(f_t, v3(0.0f));
        }
        // TIR / refraction sampled as reflection
        const bool tir_on = lobe == 2 && ndotl_s > 0.0f;
        if (tir_on) {
            const float d_tirr = distribution_ggx(n, h_refl, trans_rough);
            const float g_tirr = geometry_smith(n, v, scattered, trans_rough);
            const float pdf_tirr =
                d_tirr * ndoth_refl / (vdoth_refl * 4.0f + F(1e-6));
            pdf_t = pdf_t + p_trans_refract * pdf_tirr;
            const float brdf_tirr =
                d_tirr * g_tirr / (ndotv * 4.0f * ndotl + F(1e-6));
            f_t = add(f_t, mul(v3(brdf_tirr * base_atten), ndotl));
        } else {
            pdf_t = pdf_t + 0.0f;
            f_t = add(f_t, v3(0.0f));
        }
        pdf_case = pdf_t;
        f_case = f_t;
    } else {
        float pdf_o = p_opq_spec * pdf_refl_t;
        V3 f_o = mul(f_refl_t,
                     d_refl_t * g_refl_t / (ndotv * 4.0f * ndotl + F(1e-6)));
        f_o = mul(mul(f_o, base_atten), ndotl);
        // diffuse + sheen
        const bool diff_on = p_opq_diff > F(1e-6);
        const float pdf_diff = ndotl * kInvPi;
        pdf_o = pdf_o + (diff_on ? p_opq_diff * pdf_diff : 0.0f);
        if (diff_on) {
            const float sheen = clamp01(m.sheen);
            const V3 kd = mul(sub(v3(1.0f), f_base_nv), 1.0f - metal);
            // ndotl / PI: torch multiplies by the reciprocal of float(PI)
            V3 f_diff = mul(mul(kd, m.albedo), ndotl * (1.0f / kPi));
            const float fh = 1.0f - cmax(dot(v, h_refl), 0.0f);
            const float fh5 = pow5(fh);
            const V3 csheen = add(v3(1.0f), mul(sub(m.sheen_tint, v3(1.0f)),
                                                F(0.5)));
            f_diff = add(f_diff, mul(csheen, sheen * fh5 * ndotl));
            f_o = add(f_o, mul(f_diff, base_atten));
        } else {
            f_o = add(f_o, v3(0.0f));
        }
        pdf_case = pdf_o;
        f_case = f_o;
    }
    pdf_total = pdf_total + pdf_case;
    f_total = add(f_total, f_case);

    Scatter out;
    out.direction = scattered;
    out.valid = !(!is_trans && lobe == 4);
    out.attenuation =
        out.valid ? div(f_total, cmax(pdf_total, F(1e-6))) : v3(0.0f);
    out.is_specular = is_specular && out.valid;
    return out;
}

// -- render/nee.py sample_light -----------------------------------------------

struct LightSample {
    V3 l, radiance;
    float pdf, att, dist;
};

__device__ LightSample sample_light(uint32_t& s, const ShadeArgs& a,
                                    const float* table, bool staged,
                                    V3 point) {
    float r = uniform(s);
    r = cmin(r, F(0.99999994));
    int li = static_cast<int>(r * static_cast<float>(a.n_lights));
    li = min(max(li, 0), a.n_light_rows - 1);
    const float* row = table + static_cast<long long>(li) * a.light_width;
    float w[17];
#pragma unroll
    for (int k = 0; k < 17; ++k) w[k] = tload(row + k, staged);
    const int ltype = static_cast<int>(w[0]);
    const V3 lpos{w[1], w[2], w[3]};
    const V3 ldir{w[4], w[5], w[6]};
    const V3 lcol{w[7], w[8], w[9]};
    const float lint = w[10], lrange = w[11], linner = w[12], louter = w[13];
    const float lradius = w[14], lwidth = w[15], lheight = w[16];
    const float pdf_pick = a.pdf_pick;

    LightSample out;
    out.radiance = mul(lcol, lint);

    const V3 to_light = sub(lpos, point);
    const float dist_sq = cmax(dot(to_light, to_light), F(1e-12));
    float dist = sqrtf(dist_sq);
    const V3 l_point = mul(to_light, 1.0f / dist);

    // soft-shadow cone sample for radius > 0
    const float sin2 = cmin(lradius * lradius / dist_sq, F(0.9999));
    const float cos_max = sqrtf(1.0f - sin2);
    const float cu1 = uniform(s);
    const float cu2 = uniform(s);
    const bool soft = lradius > 0.0f;
    V3 l_local = l_point;
    float pdf_local = pdf_pick;
    if (soft) {
        l_local = cone_direction_from(cu1, cu2, l_point, cos_max);
        const float solid_angle = (1.0f - cos_max) * kTwoPi;
        pdf_local = solid_angle > F(1e-6) ? pdf_pick / solid_angle : pdf_pick;
    }

    // rect area lights: uniform point on the rect, solid-angle pdf
    const float ua = uniform(s);
    const float va = uniform(s);
    if (ltype == kArea) {
        V3 tb_u, tb_v;
        ortho_normal_basis(ldir, tb_u, tb_v);
        const V3 q = add(add(lpos, mul(tb_u, lwidth * (ua - F(0.5)))),
                         mul(tb_v, lheight * (va - F(0.5))));
        const V3 to_q = sub(q, point);
        const float dist_q_sq = cmax(dot(to_q, to_q), F(1e-12));
        const float dist_q = sqrtf(dist_q_sq);
        const V3 l_area = mul(to_q, 1.0f / dist_q);
        const float cos_emit = dot(neg(l_area), ldir);
        const float area = cmax(lwidth * lheight, F(1e-12));
        const float pdf_area_sa =
            dist_q_sq * pdf_pick / (area * cmax(cos_emit, F(1e-6)));
        l_local = l_area;
        pdf_local = cos_emit > F(1e-6) ? pdf_area_sa : 0.0f;
        dist = dist_q;
    }

    float att = lrange / (lrange + dist);
    att = att * att;
    if (ltype == kSpot) {
        const float theta = dot(l_local, neg(ldir));
        const float eps_cone = linner - louter;
        const float spot_smooth = clampf(
            (theta - louter) / (fabsf(eps_cone) < F(1e-12) ? 1.0f : eps_cone),
            0.0f, 1.0f);
        const float spot_hard = theta >= louter ? 1.0f : 0.0f;
        att = att * (eps_cone <= F(1e-6) ? spot_hard : spot_smooth);
    }

    const bool is_dir = ltype == kDirectional;
    out.l = is_dir ? neg(ldir) : l_local;
    out.pdf = is_dir ? pdf_pick : pdf_local;
    out.att = is_dir ? 1.0f : att;
    out.dist = is_dir ? F(1e30) : dist;
    return out;
}

// gradient sky (render/sky.py sample_sky)
__device__ __forceinline__ V3 sample_sky(V3 d, const float* sky) {
    const float t = (d.y + 1.0f) * F(0.5);
    const V3 top{sky[0], sky[1], sky[2]};
    const V3 bottom{sky[3], sky[4], sky[5]};
    return mul(lerp(bottom, top, t), sky[6]);
}

// -- the HDRI (render/sky.py) ---------------------------------------------------
//
// torch.remainder / jnp.mod, which C's fmod and % are not: a negative
// remainder moves up by the divisor
//
// fmodf(x, 1) is x - truncf(x), exactly (Sterbenz), but for the sign of a
// zero remainder, which no use of it here can see
__device__ __forceinline__ float rem1(float x) {
    float r = x - truncf(x);
    if (r != 0.0f && r < 0.0f) r += 1.0f;
    return r;
}
__device__ __forceinline__ int imod(int x, int m) {
    const int r = x % m;
    return r < 0 ? r + m : r;
}

// (u, v) of a direction on the rotated equirect map (sky[7]: the rotation)
__device__ __forceinline__ void env_uv(const ShadeArgs& a, V3 d, float& u,
                                       float& v) {
    const float phi = atan2f(d.z, d.x) + a.sky[7];
    const float theta = acosf(clampf(d.y, -1.0f, 1.0f));
    u = rem1((phi + kPi) * kInvTwoPi);
    v = theta * kInvPi;
}

// the HDRI's radiance at the map coordinates (u, v) of a direction:
// bilinear, wrap in u, clamp in v.  The kernel reads the map's quads (the
// four texels a fetch at (x0, y0) weighs, render/sky.py bilinear_quads): one
// aligned 64-byte read, four 16-byte loads, through the read-only cache
// (the quads, 0.5 GB for a 4096x2048 map, are never staged)
__device__ V3 env_bilinear(const ShadeArgs& a, float u, float v) {
    const int h = a.env_map_h, w = a.env_map_w;
    const float fx = u * static_cast<float>(w) - F(0.5);
    const float fy = v * static_cast<float>(h) - F(0.5);
    const float x0 = floorf(fx), y0 = floorf(fy);
    const float tx = fx - x0, ty = fy - y0;
    const int x0i = imod(static_cast<int>(x0), w);
    const int y0i = min(max(static_cast<int>(y0), 0), h - 1);
    const float4* q = reinterpret_cast<const float4*>(a.env_map) +
                      (static_cast<long long>(y0i) * w + x0i) * 4;
    const float4 t00 = __ldg(q), t01 = __ldg(q + 1), t10 = __ldg(q + 2),
                 t11 = __ldg(q + 3);
    const V3 top = lerp(V3{t00.x, t00.y, t00.z}, V3{t01.x, t01.y, t01.z}, tx);
    const V3 bot = lerp(V3{t10.x, t10.y, t10.z}, V3{t11.x, t11.y, t11.z}, tx);
    return mul(lerp(top, bot, ty), a.sky[6]);
}

// env_pdf_dir: the solid-angle pdf the env sampler gives direction d, at
// d's map coordinates (u, v) (a miss computes them once for the radiance
// and the pdf)
__device__ float env_pdf_uv(const ShadeArgs& a, V3 d, float u, float v) {
    const int sh = a.env_sh, sw = a.env_sw;
    const int tx = min(max(static_cast<int>(u * static_cast<float>(sw)), 0),
                       sw - 1);
    const int ty = min(max(static_cast<int>(v * static_cast<float>(sh)), 0),
                       sh - 1);
    const float sin_c = sinf((static_cast<float>(ty) + F(0.5)) * a.env_pi_sh);
    const float sin_t = sqrtf(cmax(1.0f - d.y * d.y, 0.0f));
    return __ldg(a.env_pdf_table + ty * sw + tx) * sin_c /
           cmax(sin_t, F(1e-6));
}

struct EnvSample {
    V3 l, radiance;
    float pdf;
};

// sample_env: four PCG draws (texel pick, alias test, jitter in u and v)
__device__ EnvSample sample_env(uint32_t& s, const ShadeArgs& a) {
    const int sh = a.env_sh, sw = a.env_sw, n = sh * sw;
    const float u1 = uniform(s);
    const float u2 = uniform(s);
    const float ju = uniform(s);
    const float jv = uniform(s);
    const int k = min(static_cast<int>(u1 * static_cast<float>(n)), n - 1);
    const float2 row = __ldg(reinterpret_cast<const float2*>(a.env_alias) + k);
    const int j = u2 < row.x ? k : static_cast<int>(row.y);  // C2: a value
    const int ty = j / sw;
    const int tx = j - ty * sw;
    const float v = (static_cast<float>(ty) + jv) * a.env_inv_sh;
    const float u = (static_cast<float>(tx) + ju) * a.env_inv_sw;
    const float theta = v * kPi;
    const float phi = u * kTwoPi - kPi - a.sky[7];
    const float sin_t = sinf(theta);
    EnvSample out;
    out.l = V3{sin_t * cosf(phi), cosf(theta), sin_t * sinf(phi)};
    // the texel-centre sin (the tabulated pdf's normalisation)
    const float sin_c = sinf((static_cast<float>(ty) + F(0.5)) * a.env_pi_sh);
    out.pdf = __ldg(a.env_pdf_table + j) * sin_c / cmax(sin_t, F(1e-6));
    float mu, mv;
    env_uv(a, out.l, mu, mv);
    out.radiance = env_bilinear(a, mu, mv);
    return out;
}

// -- the two stages -----------------------------------------------------------

__device__ __forceinline__ const float* mat_row(const ShadeArgs& a,
                                                const float* table, int id) {
    id = min(max(id, 0), a.n_mats - 1);
    return table + static_cast<long long>(id) * a.mat_width;
}

// A NEE sample's unshadowed contribution, clamped, into its record: the
// BSDF (bs; the diffuse half bd and the specular half bs when split) times
// the radiance and `scale`, into c (and cs when split).  The HDRI
// kernel's two samples share it; nee_sample keeps its own copy (see the
// note at the top).
__device__ __forceinline__ void store_nee(float* const c[3],
                                          float* const cs[3], long long i,
                                          V3 bd, V3 bs, V3 radiance,
                                          float scale, bool split) {
    if (split) {
        st3(c, i, clamp_soft(mul(mul(bd, radiance), scale), kMaxNee));
        st3(cs, i, clamp_soft(mul(mul(bs, radiance), scale), kMaxNee));
    } else {
        st3(c, i, clamp_soft(mul(mul(bs, radiance), scale), kMaxNee));
    }
}

// The NEE light sample of lane i and its record (shadow origin, L, t_max,
// pdf, the clamped unshadowed contribution); draws the lane's five PCG
// numbers and stores its state.
__device__ void nee_sample(const ShadeArgs& a, const float* mat_table,
                           const float* light_table, bool staged, long long i,
                           V3 point, V3 n, bool front, V3 d, int mesh,
                           uint32_t s) {
    const bool split = a.split != 0;
    const Mat m = fetch_mat(a, mat_table, staged, mesh);
    const LightSample ls = sample_light(s, a, light_table, staged, point);
    a.rng[i] = static_cast<long long>(s);
    const V3 offset = dot(n, ls.l) > 0.0f ? mul(n, F(1e-4)) : mul(n, F(-1e-4));
    st3(a.shadow_o, i, add(point, offset));
    st3(a.l, i, ls.l);
    a.shadow_t[i] = ls.dist - F(1e-3);
    a.pdf_nee[i] = ls.pdf;
    const float scale = ls.att / cmax(ls.pdf, F(1e-12));
    V3 bd, bs;
    evaluate_bsdf(n, front, m, ls.l, neg(d), split, bd, bs);
    if (split) {
        st3(a.nee_c, i, clamp_soft(mul(mul(bd, ls.radiance), scale), kMaxNee));
        st3(a.nee_s, i, clamp_soft(mul(mul(bs, ls.radiance), scale), kMaxNee));
    } else {
        st3(a.nee_c, i, clamp_soft(mul(mul(bs, ls.radiance), scale), kMaxNee));
    }
}

// A lane dead on entry (from bounce 1 on): its flags, the PCG draws of the
// NEE it does not do, the t_max plane = -1.  It reads nothing of K1's
// answer or the state and writes nothing else of the record.
__device__ __forceinline__ void dead_lane(const ShadeArgs& a, long long i,
                                          uint32_t s) {
    a.hit[i] = 0;
    a.do_nee[i] = 0;
    if (a.n_lights > 0) {
        skip(s, 5);
        a.rng[i] = static_cast<long long>(s);
        a.shadow_t[i] = -1.0f;
    }
}

// The bounce-0 G-buffer of lane i: its hit's normal, depth, mesh and the
// material row's roughness and transmission, or a miss's defaults.
__device__ __forceinline__ void gbuffer_hit(const ShadeArgs& a, long long i,
                                            V3 n, float t, int mesh,
                                            const float* row, bool staged) {
    st3(a.first_normal, i, n);
    a.first_depth[i] = t;
    a.first_obj[i] = mesh;
    a.first_rough[i] = tload(row + 16, staged);
    a.first_trans[i] = tload(row + 18, staged);
}
__device__ __forceinline__ void gbuffer_miss(const ShadeArgs& a,
                                             long long i) {
    st3(a.first_normal, i, v3(0.0f));
    a.first_depth[i] = F(1e30);
    a.first_obj[i] = -1;
    a.first_rough[i] = 1.0f;
    a.first_trans[i] = 0.0f;
}

// One lane that shade_nee has to shade: alive on entry, or any lane at
// bounce 0 (whose G-buffer is written on every lane).
__device__ void nee_lane(const ShadeArgs& a, const float* mat_table,
                         const float* light_table, bool staged, long long i,
                         uint32_t s) {
    const bool split = a.split != 0;
    const bool is_first = a.bounce == 0;
    const bool nee_on = a.n_lights > 0;
    const bool alive_in = !is_first || a.alive[i] != 0;

    // hit record (traverse.hit_record)
    const int slot = a.hit_slot[i];
    const V3 d = ld3(a.d, i);
    const bool found = slot >= 0;
    a.hit[i] = found;
    if (!found) {
        if (is_first) gbuffer_miss(a, i);
        if (alive_in) {  // sky on miss; the lane dies
            a.alive[i] = 0;
            const V3 sky_c = mul(sample_sky(d, a.sky), ld3(a.thr, i));
            st3(a.acc, i, add(ld3(a.acc, i), sky_c));
            if (split) {
                float* const* ch = a.path_spec[i] != 0 ? a.acc_s : a.acc_d;
                st3(ch, i, add(ld3(ch, i), sky_c));
            }
        }
    }
    const float t = found ? a.hit_t[i] : 0.0f;
    const int mesh = found ? a.hit_mesh[i] : 0;
    V3 n = v3(0.0f), point = v3(0.0f);
    bool front = false, do_nee = false;
    if (found) {
        const V3 o = ld3(a.o, i);
        // a uniform branch: hit_inst is null in a scene without instances
        const int inst = a.hit_inst != nullptr ? a.hit_inst[i] : -1;
        if (inst >= 0) {
            // traverse._mat_normal of the set's triangle, as the reference
            const V3 c = cross(ld3(a.inst_e1, slot), ld3(a.inst_e2, slot));
            const float* m = a.inst_mats + 24 * inst;
            n = normalize(V3{dot(V3{m[12], m[13], m[14]}, c),
                             dot(V3{m[15], m[16], m[17]}, c),
                             dot(V3{m[18], m[19], m[20]}, c)},
                          F(1e-30));
        } else {
            n = normalize(cross(ld3(a.e1, slot), ld3(a.e2, slot)), F(1e-30));
        }
        front = dot(d, n) < 0.0f;
        n = front ? n : neg(n);
        point = add(o, mul(d, t));
        const float* const row = mat_row(a, mat_table, mesh);
        if (is_first) gbuffer_hit(a, i, n, t, mesh, row, staged);
        if (alive_in) {
            st3(a.point, i, point);
            st3(a.normal, i, n);
            a.front[i] = front;
            do_nee = a.ray_spec[i] == 0;
            // interior Beer-Lambert absorption, coefficient -log(albedo)
            V3 thr = ld3(a.thr, i);
            if (!front) {
                const V3 alb{tload(row + 0, staged), tload(row + 1, staged),
                             tload(row + 2, staged)};
                const V3 c{cmax(-logf(cmax(alb.x, F(1e-6))), 0.0f),
                           cmax(-logf(cmax(alb.y, F(1e-6))), 0.0f),
                           cmax(-logf(cmax(alb.z, F(1e-6))), 0.0f)};
                const V3 absorb{expf(-c.x * t), expf(-c.y * t),
                                expf(-c.z * t)};
                thr = mul(thr, absorb);
                st3(a.thr, i, thr);
            }
            // emission (bounce 0 or after a specular bounce)
            const V3 emission{tload(row + 6, staged), tload(row + 7, staged),
                              tload(row + 8, staged)};
            const bool emissive = emission.x > 0.0f || emission.y > 0.0f ||
                                  emission.z > 0.0f;
            if (emissive && (is_first || a.prev_spec[i] != 0)) {
                const V3 ce = mul(thr, emission);
                st3(a.acc, i, add(ld3(a.acc, i), ce));
                if (split) {
                    float* const* ch =
                        is_first ? a.acc_e
                                 : (a.path_spec[i] != 0 ? a.acc_s : a.acc_d);
                    st3(ch, i, add(ld3(ch, i), ce));
                }
            }
        }
    }
    a.do_nee[i] = do_nee;
    if (!nee_on) return;
    if (do_nee) {
        nee_sample(a, mat_table, light_table, staged, i, point, n, front, d,
                   mesh, s);
    } else {
        skip(s, 5);
        a.rng[i] = static_cast<long long>(s);
        a.shadow_t[i] = -1.0f;
    }
}

// A block stages the tables once and takes kNeeChunk neighbouring lanes,
// kNeeChunk / kNeeThreads to a thread.
__global__ void __launch_bounds__(kNeeThreads, kNeeBlocks)
shade_nee_kernel(const ShadeArgs a) {
    extern __shared__ float smem[];
    const float *mat_table, *light_table;
    const bool staged = stage_tables(a, smem, mat_table, light_table);
    const bool nee_on = a.n_lights > 0;
    const long long base = static_cast<long long>(blockIdx.x) * kNeeChunk;
    const int lanes = static_cast<int>(
        a.n - base < kNeeChunk ? a.n - base : kNeeChunk);
    for (int j = threadIdx.x; j < lanes; j += kNeeThreads) {
        const long long i = base + j;
        const uint32_t s = nee_on ? static_cast<uint32_t>(a.rng[i]) : 0u;
        if (a.bounce == 0 || a.alive[i] != 0)
            nee_lane(a, mat_table, light_table, staged, i, s);
        else
            dead_lane(a, i, s);
    }
}

// -- shade_nee's HDRI kernel ----------------------------------------------------

// The NEE a lane does not do (a dead lane besides its hit flag, a miss, a
// hit after a specular scatter): its flag, the PCG draws (four of the env
// sample, then five of the light's), the t_max planes = -1, the state.
__device__ __forceinline__ void env_no_nee(const ShadeArgs& a, long long i,
                                           uint32_t s) {
    a.do_nee[i] = 0;
    skip(s, 4);
    a.env_t[i] = -1.0f;
    if (a.n_lights > 0) {
        skip(s, 5);
        a.shadow_t[i] = -1.0f;
    }
    a.rng[i] = static_cast<long long>(s);
}

// A lane alive on entry that misses: the HDRI along d times the throughput,
// MIS-weighted against the env sampler after a non-specular scatter from a
// hit that drew an env sample (d's map coordinates computed once for the
// radiance and the pdf), into the accumulators; the lane dies.  Every
// plane it reads is asked for before the texels arrive (prev_pdf too,
// whether or not the weight applies), and nothing is written before.
__device__ void env_miss(const ShadeArgs& a, long long i, V3 d, uint32_t s) {
    const bool split = a.split != 0;
    const V3 thr = ld3(a.thr, i);
    const bool mis = a.prev_nee[i] != 0 && a.prev_spec[i] == 0;
    const float prev_pdf = a.prev_pdf[i];
    const V3 acc = ld3(a.acc, i);
    float* const* ch = split && a.path_spec[i] != 0 ? a.acc_s : a.acc_d;
    const V3 acc_ch = split ? ld3(ch, i) : v3(0.0f);
    float u, v;
    env_uv(a, d, u, v);
    V3 sky_c = mul(env_bilinear(a, u, v), thr);
    if (mis) sky_c = mul(sky_c, mis_weight(prev_pdf, env_pdf_uv(a, d, u, v)));
    st3(a.acc, i, add(acc, sky_c));
    if (split) st3(ch, i, add(acc_ch, sky_c));
    a.alive[i] = 0;
    a.hit[i] = 0;
    env_no_nee(a, i, s);
}

// The two NEE samples of a lane and their records: both directions drawn
// first (the env sample's four PCG numbers, then the light's five) and
// their rays written, then the material fetched once and its Lobes built
// once for the two BSDF evaluations and the env MIS pdf.
__device__ void env_nee(const ShadeArgs& a, const float* mat_table,
                        const float* light_table, bool staged, long long i,
                        V3 point, V3 n, bool front, V3 d, int mesh,
                        uint32_t s) {
    const bool split = a.split != 0;
    const bool lights = a.n_lights > 0;
    const EnvSample es = sample_env(s, a);
    const V3 off_e = dot(n, es.l) > 0.0f ? mul(n, F(1e-4)) : mul(n, F(-1e-4));
    st3(a.env_o, i, add(point, off_e));
    st3(a.env_l, i, es.l);
    a.env_t[i] = F(1e28);
    a.env_pdf[i] = es.pdf;
    LightSample ls{};
    float scale = 0.0f;
    if (lights) {
        ls = sample_light(s, a, light_table, staged, point);
        const V3 off = dot(n, ls.l) > 0.0f ? mul(n, F(1e-4))
                                           : mul(n, F(-1e-4));
        st3(a.shadow_o, i, add(point, off));
        st3(a.l, i, ls.l);
        a.shadow_t[i] = ls.dist - F(1e-3);
        a.pdf_nee[i] = ls.pdf;
        scale = ls.att / cmax(ls.pdf, F(1e-12));
    }
    a.rng[i] = static_cast<long long>(s);
    const Mat m = fetch_mat(a, mat_table, staged, mesh);
    const V3 v = neg(d);
    const Lobes b = lobes(n, front, m, v);
    V3 bd, bs;
    const float scale_e = 1.0f / cmax(es.pdf, F(1e-12));
    evaluate_bsdf_at(b, n, front, m, es.l, v, split, bd, bs);
    store_nee(a.env_c, a.env_cs, i, bd, bs, es.radiance, scale_e, split);
    a.env_mis[i] = mis_weight(es.pdf, material_pdf_at(b, n, v, es.l));
    if (!lights) return;
    evaluate_bsdf_at(b, n, front, m, ls.l, v, split, bd, bs);
    store_nee(a.nee_c, a.nee_s, i, bd, bs, ls.radiance, scale, split);
}

// A lane that hits (K1's slot `slot`): the hit record, the G-buffer
// (FIRST: bounce 0, where a lane dead on entry writes it too), and where
// the lane was alive on entry Beer-Lambert, emission and the NEE samples.
template <bool FIRST>
__device__ void env_hit(const ShadeArgs& a, const float* mat_table,
                        const float* light_table, bool staged, long long i,
                        int slot, V3 d, bool alive_in, uint32_t s) {
    const bool split = a.split != 0;
    a.hit[i] = 1;
    const float t = a.hit_t[i];
    const int mesh = a.hit_mesh[i];
    const V3 o = ld3(a.o, i);
    V3 n;
    // a uniform branch: hit_inst is null in a scene without instances
    const int inst = a.hit_inst != nullptr ? a.hit_inst[i] : -1;
    if (inst >= 0) {
        // traverse._mat_normal of the set's triangle, as the reference
        const V3 c = cross(ld3(a.inst_e1, slot), ld3(a.inst_e2, slot));
        const float* m = a.inst_mats + 24 * inst;
        n = normalize(V3{dot(V3{m[12], m[13], m[14]}, c),
                         dot(V3{m[15], m[16], m[17]}, c),
                         dot(V3{m[18], m[19], m[20]}, c)},
                      F(1e-30));
    } else {
        n = normalize(cross(ld3(a.e1, slot), ld3(a.e2, slot)), F(1e-30));
    }
    const bool front = dot(d, n) < 0.0f;
    n = front ? n : neg(n);
    const V3 point = add(o, mul(d, t));
    const float* const row = mat_row(a, mat_table, mesh);
    if (FIRST) {
        gbuffer_hit(a, i, n, t, mesh, row, staged);
        if (!alive_in) {
            env_no_nee(a, i, s);
            return;
        }
    }
    st3(a.point, i, point);
    st3(a.normal, i, n);
    a.front[i] = front;
    // interior Beer-Lambert absorption, coefficient -log(albedo)
    V3 thr = ld3(a.thr, i);
    if (!front) {
        const V3 alb{tload(row + 0, staged), tload(row + 1, staged),
                     tload(row + 2, staged)};
        const V3 c{cmax(-logf(cmax(alb.x, F(1e-6))), 0.0f),
                   cmax(-logf(cmax(alb.y, F(1e-6))), 0.0f),
                   cmax(-logf(cmax(alb.z, F(1e-6))), 0.0f)};
        const V3 absorb{expf(-c.x * t), expf(-c.y * t), expf(-c.z * t)};
        thr = mul(thr, absorb);
        st3(a.thr, i, thr);
    }
    // emission (bounce 0 or after a specular bounce)
    const V3 emission{tload(row + 6, staged), tload(row + 7, staged),
                      tload(row + 8, staged)};
    const bool emissive =
        emission.x > 0.0f || emission.y > 0.0f || emission.z > 0.0f;
    if (emissive && (FIRST || a.prev_spec[i] != 0)) {
        const V3 ce = mul(thr, emission);
        st3(a.acc, i, add(ld3(a.acc, i), ce));
        if (split) {
            float* const* ch =
                FIRST ? a.acc_e : (a.path_spec[i] != 0 ? a.acc_s : a.acc_d);
            st3(ch, i, add(ld3(ch, i), ce));
        }
    }
    if (a.ray_spec[i] != 0) {
        env_no_nee(a, i, s);
        return;
    }
    a.do_nee[i] = 1;
    env_nee(a, mat_table, light_table, staged, i, point, n, front, d, mesh, s);
}

// A lane at bounce 0, where every lane writes its G-buffer.
__device__ void env_lane0(const ShadeArgs& a, const float* mat_table,
                          const float* light_table, bool staged, long long i,
                          uint32_t s) {
    const int slot = a.hit_slot[i];
    const V3 d = ld3(a.d, i);
    const bool alive_in = a.alive[i] != 0;
    if (slot >= 0) {
        env_hit<true>(a, mat_table, light_table, staged, i, slot, d, alive_in,
                      s);
        return;
    }
    gbuffer_miss(a, i);
    if (alive_in) {
        env_miss(a, i, d, s);
    } else {
        a.hit[i] = 0;
        env_no_nee(a, i, s);
    }
}

// shade_nee's HDRI kernel; a block stages the tables once.  Bounce 0
// (LIST false): kNeeChunk neighbouring lanes, each its own thread.  From
// bounce 1 (LIST): kEnvNeeChunk lanes, kEnvNeeLanes a thread.  The block
// asks for every lane's alive flag and PCG state at once, then for K1's
// slot of the live ones, finishes the dead lanes and lists the live ones
// with their states and slots in shared memory, the hits from the back
// and the misses from the front.  It runs the hits first (the longer
// path), then the misses: a warp takes 32 listed lanes that all hit or
// all miss, but for the one warp where the two meet.
template <bool LIST>
__global__ void __launch_bounds__(kNeeThreads,
                                  LIST ? kEnvListBlocks : kEnvNeeBlocks)
shade_nee_kernel_hdri(const ShadeArgs a) {
    constexpr int kChunk = LIST ? kEnvNeeChunk : kNeeChunk;
    extern __shared__ float smem[];
    __shared__ int list_lane[LIST ? kChunk : 1];
    __shared__ int list_slot[LIST ? kChunk : 1];
    __shared__ uint32_t list_state[LIST ? kChunk : 1];
    __shared__ int n_miss, n_hit;
    const long long base = static_cast<long long>(blockIdx.x) * kChunk;
    const int lanes = static_cast<int>(
        a.n - base < kChunk ? a.n - base : kChunk);
    const float *mat_table, *light_table;
    if (!LIST) {
        const bool staged = stage_tables(a, smem, mat_table, light_table);
        for (int j = threadIdx.x; j < lanes; j += kNeeThreads)
            env_lane0(a, mat_table, light_table, staged, base + j,
                      static_cast<uint32_t>(a.rng[base + j]));
        return;
    }
    if (threadIdx.x == 0) n_miss = n_hit = 0;
    constexpr int L = kEnvNeeLanes;
    bool live[L];
    uint32_t state[L];
    int slot[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
        const int j = threadIdx.x + k * kNeeThreads;
        live[k] = false;
        state[k] = 0u;
        if (j < lanes) {
            live[k] = a.alive[base + j] != 0;
            state[k] = static_cast<uint32_t>(a.rng[base + j]);
        }
    }
#pragma unroll
    for (int k = 0; k < L; ++k)
        slot[k] = live[k] ? a.hit_slot[base + threadIdx.x + k * kNeeThreads]
                          : -1;
    const bool staged = stage_tables(a, smem, mat_table, light_table);
    __syncthreads();  // n_miss = n_hit = 0 is seen, staged or not
    const int warp_lane = threadIdx.x & 31;
    const unsigned below = (1u << warp_lane) - 1u;
#pragma unroll
    for (int k = 0; k < L; ++k) {
        const int j = threadIdx.x + k * kNeeThreads;
        if (j < lanes && !live[k]) {
            a.hit[base + j] = 0;
            env_no_nee(a, base + j, state[k]);
        }
        const bool hit = slot[k] >= 0, miss = live[k] && !hit;
        const unsigned bm = __ballot_sync(0xffffffffu, miss);
        const unsigned bh = __ballot_sync(0xffffffffu, hit);
        int at_m = 0, at_h = 0;
        if (warp_lane == 0) {
            if (bm != 0u) at_m = atomicAdd(&n_miss, __popc(bm));
            if (bh != 0u) at_h = atomicAdd(&n_hit, __popc(bh));
        }
        at_m = __shfl_sync(0xffffffffu, at_m, 0);
        at_h = __shfl_sync(0xffffffffu, at_h, 0);
        if (miss || hit) {
            const int at = hit ? kChunk - 1 - (at_h + __popc(bh & below))
                               : at_m + __popc(bm & below);
            list_lane[at] = j;
            list_slot[at] = slot[k];
            list_state[at] = state[k];
        }
    }
    __syncthreads();
    const int hits = n_hit, total = n_hit + n_miss;
    for (int k = threadIdx.x; k < total; k += kNeeThreads) {
        const bool hit = k < hits;
        const int at = hit ? kChunk - 1 - k : k - hits;
        const long long i = base + list_lane[at];
        const V3 d = ld3(a.d, i);
        if (hit)
            env_hit<false>(a, mat_table, light_table, staged, i,
                           list_slot[at], d, true, list_state[at]);
        else
            env_miss(a, i, d, list_state[at]);
    }
}

// A NEE sample's term in shade_scatter: thr * c * w into the sum and, when
// split, c (the diffuse half) and cs (the specular half) into their
// channels; c and cs read only where the sample is lit.
__device__ __forceinline__ void add_nee(const ShadeArgs& a, long long i,
                                        V3 thr, float w, bool lit,
                                        float* const c[3], float* const cs[3],
                                        bool split) {
    V3 nee_c = lit ? ld3(c, i) : v3(0.0f);
    if (split) {
        const V3 nee_s = lit ? ld3(cs, i) : v3(0.0f);
        st3(a.acc_d, i, add(ld3(a.acc_d, i), mul(mul(thr, nee_c), w)));
        st3(a.acc_s, i, add(ld3(a.acc_s, i), mul(mul(thr, nee_s), w)));
        nee_c = add(nee_c, nee_s);
    }
    st3(a.acc, i, add(ld3(a.acc, i), mul(mul(thr, nee_c), w)));
}

// shade_scatter past the NEE terms: the scatter `sc` drawn, its flags (and
// `carry()`, the HDRI kernel's env MIS carries) where it is valid, Russian
// roulette and the ray advance; the lane's PCG state stored.  Returns
// whether the lane lives on.
template <typename Carry>
__device__ __forceinline__ bool scatter_on(const ShadeArgs& a, long long i,
                                           uint32_t& s, V3 n, V3 thr,
                                           const Scatter& sc, Carry carry) {
    bool alive = sc.valid;
    if (alive) {
        a.prev_spec[i] = sc.is_specular;
        if (!sc.is_specular) a.path_spec[i] = 0;
        carry();
    }

    // Russian roulette
    const float u_rr = uniform(s);
    const float p = clampf(max_component(thr), kRrMin, kRrMax);
    if (a.rr_enabled && a.bounce >= a.rr_start) {
        alive = alive && !(u_rr > p);
        if (alive) thr = div(thr, p);
    }

    // advance the ray
    if (alive) {
        st3(a.thr, i, clamp_soft(mul(thr, sc.attenuation), kMaxBounceWeight));
        const V3 offset = dot(sc.direction, n) > 0.0f ? mul(n, F(1e-4))
                                                      : mul(n, F(-1e-4));
        st3(a.o, i, add(ld3(a.point, i), offset));
        st3(a.d, i, sc.direction);
        a.ray_spec[i] = sc.is_specular;
    } else {
        a.alive[i] = 0;
    }
    a.rng[i] = static_cast<long long>(s);
    return alive;
}

// A live lane's rays in the trace's count, where its thread sums them: the
// next bounce's walk where it lives on (and the count takes the next
// bounce), count_casts shadow rays where it drew its NEE samples.
__device__ __forceinline__ unsigned lane_rays(const ShadeArgs& a,
                                              bool lives_on, bool did_nee) {
    return (lives_on && a.count_next != 0 ? 1u : 0u) +
           (did_nee ? static_cast<unsigned>(a.count_casts) : 0u);
}

// One lane alive on entry to shade_scatter, with its PCG state: MIS and the
// NEE sum, the scatter, Russian roulette and the ray advance.  It writes a
// flag only where the plain stage may change it (alive only where the lane
// dies), and the ray and throughput only where the lane lives on.  Returns
// with RAYS the lane's rays in the count (lane_rays), else whether it lives
// on.
template <bool RAYS>
__device__ unsigned scatter_lane(const ShadeArgs& a, const float* mat_table,
                                 bool staged, long long i, uint32_t s) {
    const bool split = a.split != 0;
    const Mat m = fetch_mat(a, mat_table, staged, a.hit_mesh[i]);
    const V3 n = ld3(a.normal, i);
    const bool front = a.front[i] != 0;
    const V3 d = ld3(a.d, i);
    const V3 thr = ld3(a.thr, i);
    const bool did_nee =
        (a.n_lights > 0 || (RAYS && a.count_casts > 0)) && a.do_nee[i] != 0;

    // NEE with MIS
    if (a.n_lights > 0 && did_nee) {
        const float pdf = a.pdf_nee[i];
        if (pdf > 0.0f) {
            const bool lit = a.in_shadow[i] == 0;
            const V3 l = ld3(a.l, i);
            const float w = mis_weight(pdf, material_pdf(n, front, m, neg(d),
                                                         l));
            add_nee(a, i, thr, w, lit, a.nee_c, a.nee_s, split);
        }
    }

    const Scatter sc = material_scatter(s, n, front, m, d);
    const bool lives_on = scatter_on(a, i, s, n, thr, sc, [] {});
    return RAYS ? lane_rays(a, lives_on, did_nee) : lives_on;
}

// scatter_lane in shade_scatter's HDRI kernel: the env sample's term (its
// MIS weight from shade_nee) before the light's, and where the lane lives
// on the env MIS carries.  The material is fetched after the env term and
// its Lobes built once for the light's MIS pdf and the scatter
// direction's.  Returns as scatter_lane<RAYS>.
template <bool RAYS>
__device__ unsigned scatter_lane_hdri(const ShadeArgs& a,
                                      const float* mat_table, bool staged,
                                      long long i, uint32_t s) {
    const bool split = a.split != 0;
    const V3 n = ld3(a.normal, i);
    const bool front = a.front[i] != 0;
    const V3 d = ld3(a.d, i);
    const V3 thr = ld3(a.thr, i);
    const bool did_nee = a.do_nee[i] != 0;

    // the env sample with MIS (its weight from shade_nee)
    if (did_nee) {
        const float pdf = a.env_pdf[i];
        if (pdf > 0.0f) {
            const bool lit = a.in_shadow_env[i] == 0 && pdf > F(1e-12);
            add_nee(a, i, thr, a.env_mis[i], lit, a.env_c, a.env_cs, split);
        }
    }

    const Mat m = fetch_mat(a, mat_table, staged, a.hit_mesh[i]);
    const V3 v = neg(d);
    const Lobes b = lobes(n, front, m, v);
    // NEE with MIS
    if (a.n_lights > 0 && did_nee) {
        const float pdf = a.pdf_nee[i];
        if (pdf > 0.0f) {
            const bool lit = a.in_shadow[i] == 0;
            const V3 l = ld3(a.l, i);
            const float w = mis_weight(pdf, material_pdf_at(b, n, v, l));
            add_nee(a, i, thr, w, lit, a.nee_c, a.nee_s, split);
        }
    }

    // the scatter, and the env MIS carries where the lane lives on
    const Scatter sc = material_scatter(s, n, front, m, d);
    const bool lives_on = scatter_on(a, i, s, n, thr, sc, [&] {
        a.prev_pdf[i] = material_pdf_at(b, n, v, sc.direction);
        a.prev_nee[i] = did_nee;
    });
    return RAYS ? lane_rays(a, lives_on, did_nee) : lives_on;
}

// A block takes LANES lanes a thread, kScatterThreads * LANES neighbouring
// lanes (see the note at the top).  It asks for every lane's alive flag and
// PCG state and for the material table at once, finishes the dead lanes,
// and runs the live path: with LANES == 1 (bounce 0) each thread its own
// lane, else from a list of the block's live lanes (and their PCG states)
// in shared memory, 32 to a warp.
template <int LANES, bool ENV>
__global__ void __launch_bounds__(
    kScatterThreads, ENV ? (LANES == 1 ? kEnvScatterB0Blocks
                                       : kEnvScatterBlocks)
                         : (LANES == 1 ? kScatterB0Blocks : kScatterBlocks))
shade_scatter_kernel(const ShadeArgs a) {
    constexpr int kChunk = kScatterThreads * LANES;
    extern __shared__ float smem[];
    __shared__ int live_lane[LANES > 1 ? kChunk : 1];
    __shared__ uint32_t live_state[LANES > 1 ? kChunk : 1];
    __shared__ int n_live;
    // the ray count's block sums: at bounce 0 its NEE lanes, from bounce 1
    // on its warps' sums
    __shared__ unsigned block_nee;
    __shared__ unsigned warp_rays[LANES > 1 ? kScatterThreads / 32 : 1];
    const long long base = static_cast<long long>(blockIdx.x) * kChunk;
    const int lanes = static_cast<int>(
        a.n - base < kChunk ? a.n - base : kChunk);
    const bool counting = a.rays != nullptr;
    if (LANES > 1 && threadIdx.x == 0) n_live = 0;
    bool live[LANES];
    uint32_t state[LANES];
    bool nee = false;  // at bounce 0: the thread's lane has do_nee
#pragma unroll
    for (int k = 0; k < LANES; ++k) {
        const int j = threadIdx.x + k * kScatterThreads;
        live[k] = false;
        state[k] = 0u;
        if (j < lanes) {
            live[k] = a.alive[base + j] != 0;
            state[k] = static_cast<uint32_t>(a.rng[base + j]);
            if (LANES == 1 && counting && a.count_casts != 0)
                nee = a.do_nee[base + j] != 0;
        }
    }
    const int n_mat = a.n_mats * a.mat_width;
    const bool staged = n_mat * 4 <= kMaxStagedBytes;
    if (staged)
        for (int k = threadIdx.x; k < n_mat; k += kScatterThreads)
            smem[k] = __ldg(a.mat + k);
    const float* const mat_table = staged ? smem : a.mat;
    const int warp_lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < LANES; ++k) {
        const int j = threadIdx.x + k * kScatterThreads;
        if (j < lanes && !live[k]) {  // only the PCG stream moves
            uint32_t s = state[k];    // (scatter 3, roulette 1)
            skip(s, 4);
            a.rng[base + j] = static_cast<long long>(s);
        }
        if (LANES > 1) {
            if (k == 0) __syncthreads();  // n_live = 0 is seen
            const unsigned ballot = __ballot_sync(0xffffffffu, live[k]);
            int at = 0;
            if (warp_lane == 0 && ballot != 0u)
                at = atomicAdd(&n_live, __popc(ballot));
            at = __shfl_sync(0xffffffffu, at, 0);
            if (live[k]) {
                at += __popc(ballot & ((1u << warp_lane) - 1u));
                live_lane[at] = j;
                live_state[at] = state[k];
            }
        }
    }
    if (LANES == 1) {  // the barrier also counts the block's NEE lanes
        const int block = __syncthreads_count(nee);
        if (threadIdx.x == 0) block_nee = static_cast<unsigned>(block);
    } else {
        __syncthreads();
    }
    // at bounce 0 whether the thread's lane lives on, from bounce 1 on its
    // lanes' rays in the count
    unsigned rays = 0;
    if (LANES == 1) {
        if (live[0]) {
            if constexpr (ENV)
                rays = scatter_lane_hdri<false>(a, mat_table, staged,
                                                base + threadIdx.x, state[0]);
            else
                rays = scatter_lane<false>(a, mat_table, staged,
                                           base + threadIdx.x, state[0]);
        }
    } else {
        for (int k = threadIdx.x; k < n_live; k += kScatterThreads) {
            if constexpr (ENV)
                rays += scatter_lane_hdri<true>(a, mat_table, staged,
                                                base + live_lane[k],
                                                live_state[k]);
            else
                rays += scatter_lane<true>(a, mat_table, staged,
                                           base + live_lane[k],
                                           live_state[k]);
        }
    }
    // the ray count: at bounce 0 a barrier's count of the lanes left alive
    // (and the NEE lanes' above: the lane code keeps no count of its own),
    // from bounce 1 on a warp's sum in registers and the warps' in shared
    // memory; one atomic a block into the trace's counter (block 0 adds
    // the base)
    if (counting) {
        unsigned long long add = 0;
        if (LANES == 1) {
            const int alive = __syncthreads_count(rays);
            add = (a.count_next != 0 ? static_cast<unsigned>(alive) : 0u) +
                  static_cast<unsigned long long>(block_nee) *
                      static_cast<unsigned>(a.count_casts);
        } else {
            const unsigned w = __reduce_add_sync(0xffffffffu, rays);
            if (warp_lane == 0) warp_rays[threadIdx.x >> 5] = w;
            __syncthreads();
            if (threadIdx.x == 0) {
#pragma unroll
                for (int k = 0; k < kScatterThreads / 32; ++k)
                    add += warp_rays[k];
            }
        }
        if (threadIdx.x == 0) {
            if (blockIdx.x == 0)
                add += static_cast<unsigned long long>(a.count_base);
            if (add != 0)
                atomicAdd(reinterpret_cast<unsigned long long*>(a.rays), add);
        }
    }
}

// dynamic shared memory for stage_tables: the tables when they fit, else 0
int table_bytes(const ShadeArgs* a) {
    const int n = a->n_mats * a->mat_width +
                  (a->lights ? a->n_light_rows * a->light_width : 0);
    return n * 4 <= kMaxStagedBytes ? n * 4 : 0;
}
// and for shade_scatter's material table
int material_bytes(const ShadeArgs* a) {
    const int n = a->n_mats * a->mat_width;
    return n * 4 <= kMaxStagedBytes ? n * 4 : 0;
}
// lanes a shade_nee block takes: the HDRI kernel's list from bounce 1 on
int nee_chunk(const ShadeArgs* a) {
    return a->env_nee != 0 && a->bounce > 0 ? kEnvNeeChunk : kNeeChunk;
}
// lanes a shade_scatter block takes at this bounce
int scatter_chunk(const ShadeArgs* a) {
    return kScatterThreads * (a->bounce == 0 ? 1 : kScatterLanes);
}
// Both K3 kernels take their HDRI instantiation where env_nee is set;
// shade_nee refuses an HDRI sky without env NEE and env NEE without the map
bool env_args_ok(const ShadeArgs* a) {
    return (a->env_nee != 0) == (a->env_map != nullptr);
}

using Kernel = void (*)(ShadeArgs);
constexpr int kKernels = 7, kMaxDevices = 64;

// The kernel of stage 0 (shade_nee) or 1 (shade_scatter) for these args,
// and its index below kKernels.
Kernel k3_kernel(int stage, const ShadeArgs* a, int* index) {
    const bool env = a->env_nee != 0, first = a->bounce == 0;
    if (stage == 0) {
        *index = !env ? 0 : (first ? 1 : 2);
        return !env ? shade_nee_kernel
                    : (first ? shade_nee_kernel_hdri<false>
                             : shade_nee_kernel_hdri<true>);
    }
    *index = 3 + 2 * !first + env;
    return first ? (env ? shade_scatter_kernel<1, true>
                        : shade_scatter_kernel<1, false>)
                 : (env ? shade_scatter_kernel<kScatterLanes, true>
                        : shade_scatter_kernel<kScatterLanes, false>);
}

// Lets a K3 kernel take kMaxStagedBytes of dynamic shared memory for its
// tables beside its static lists (by default a block's static and dynamic
// bytes together stay within 48 KB, and the lists take up to 12 KB); once a
// kernel a device.
cudaError_t allow_tables(Kernel kernel, int index) {
    static bool allowed[kKernels][kMaxDevices];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (allowed[index][dev]) return cudaSuccess;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxStagedBytes);
    allowed[index][dev] = e == cudaSuccess;
    return e;
}

// One launch of stage 0 or 1 over args->n lanes.
int launch_k3(int stage, const ShadeArgs* args, void* stream) {
    if (args->n > 0) {
        int index = 0;
        const Kernel kernel = k3_kernel(stage, args, &index);
        const cudaError_t e = allow_tables(kernel, index);
        if (e != cudaSuccess) return static_cast<int>(e);
        const int chunk = stage == 0 ? nee_chunk(args) : scatter_chunk(args);
        const unsigned blocks =
            static_cast<unsigned>((args->n + chunk - 1) / chunk);
        kernel<<<blocks, stage == 0 ? kNeeThreads : kScatterThreads,
                 stage == 0 ? table_bytes(args) : material_bytes(args),
                 static_cast<cudaStream_t>(stream)>>>(*args);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ptrt_shade_nee(const ShadeArgs* args, void* stream) {
    if (!env_args_ok(args))
        return static_cast<int>(cudaErrorInvalidValue);
    return launch_k3(0, args, stream);
}

// Registers, local-memory bytes a thread, threads and lanes a block,
// resident blocks a SM and the dynamic shared bytes a block asks for (with
// this launch's tables) of shade_nee (stage 0) or shade_scatter (stage 1).
extern "C" int ptrt_shade_info(int stage, const ShadeArgs* args, int* regs,
                               int* local_bytes, int* threads, int* lanes,
                               int* per_sm, int* shared_bytes) {
    cudaFuncAttributes attr = {};
    *threads = stage == 0 ? kNeeThreads : kScatterThreads;
    *lanes = stage == 0 ? nee_chunk(args) : scatter_chunk(args);
    *shared_bytes = stage == 0 ? table_bytes(args) : material_bytes(args);
    int index = 0;
    const Kernel kernel = k3_kernel(stage, args, &index);
    cudaError_t e = allow_tables(kernel, index);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            per_sm, kernel, *threads, *shared_bytes);
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    return static_cast<int>(e);
}

extern "C" int ptrt_shade_scatter(const ShadeArgs* args, void* stream) {
    return launch_k3(1, args, stream);
}
