// svgf_temporal and svgf_atrous: the two per-pixel stages of the SVGF
// denoiser that carry its memory traffic; svgf_variance and svgf_firefly,
// its variance estimate and firefly clamp (see "the variance estimate and
// the firefly clamp" below for what they replace and what bounds them).
//
// Replaces: ptrt_tpu/render/denoiser.py temporal_accumulation (:276, with
// _edge_aware_bilinear :217 and the first-frame history of denoise_channel
// :490) and atrous_iteration (:425).  Under XLA each is a fusion of dozens
// of shifted copies, gathers and selects over (H, W) planes.
//
// What bounds them on the card.  The temporal stage: memory traffic and
// the latency of its dependent loads.  A channel reads 22 planes (23 with a
// history cap) and writes 7, 0.072 ms at 1080p at the card's memory rate;
// a pixel reads a 3x3 window of colour, depth, normal and id and, at four
// bilinear corners that the motion vectors choose, the previous frame's
// depth, normal and id and three history planes.  The a-trous pass:
// instruction rate, not bytes.  Its 13 planes
// (9 read, 4 written) take 0.032 ms at the card's memory rate, but a pixel
// runs 25 taps of an IEEE division, an accurate expf, two dot products and
// nine unfused multiplies and adds into the sums (this file builds with
// -fmad=false): about 88 SASS instructions a tap as built, 2,200 a surface
// pixel, which over the 1,260,000 surface pixels of a 1080p bench view is
// ~0.09 ms at one warp instruction a cycle on each of 132 SMs x 4
// schedulers at ~1.75 GHz.  The plain torch versions write
// every shifted plane and every intermediate to device memory (hundreds of
// 8 MB planes per pass at 1080p).
//
// What this design does about it.  The temporal stage (see "the temporal
// stage" below): a block fills the 3x3 windows of its pixels from a tile in
// shared memory, loaded once; every history load of a pixel is issued at
// once, since the nearest-pixel fallback and the rejection read one of the
// four corners already loaded; and one launch runs both channels of a
// split frame, whose geometry (G-buffers, motion, the previous frame's
// surface, every edge and rejection test) is the same, so it is read and
// tested once.  It applies the first-frame rule from a device flag, so the
// frame needs no host round trip.  The a-trous pass cuts
// instructions a pixel (see "the a-trous pass" below): a block filters from
// a shared-memory tile that holds, once for each pixel and not once for
// each of its 25 neighbours, the luminance and a skip mark that replaces
// the bounds compares and the sky test of a tap; the taps are three wide
// shared-memory reads at compile-time offsets, with every edge test of a
// tap evaluated without a branch between them; a sky pixel copies its
// input and skips the taps.  A 1080p pass takes 0.09-0.11 ms (PERF.md).

// Border rules follow the reference exactly: the temporal 3x3 window clamps
// coordinates, the bilinear corners clip after floor, the a-trous taps
// outside the image are masked (zero-padded cells whose weight is 0),
// including dilations past the image.  The float operations follow the plain
// version's order; this file builds with -fmad=false, so no product is
// fused into an add the plain version rounds separately.

#include <cuda_runtime.h>
#include <stdint.h>

// one channel of the temporal stage: its colour, history, cap, outputs and
// settings
struct SvgfChannel {
    const float* cur[3];
    const float* hist_mean[3];
    const float* hist_m2[3];
    const float* hist_len;
    const float* cap;            // per-pixel history cap, or null
    float* out_mean[3];
    float* out_m2[3];
    float* out_len;
    float clamp_scale, tau, min_alpha, max_history;
};

struct SvgfTemporalArgs {
    SvgfChannel ch[2];           // ch[1] is read only when channels == 2
    const float* mv_x;
    const float* mv_y;
    const float* depth;
    const float* normal[3];
    const int* obj;
    const float* prev_depth;
    const float* prev_normal[3];
    const int* prev_obj;
    const unsigned char* first;  // 0-d bool: history := current, or null
    int h, w, channels;
    float edge_depth, edge_normal;
    float reject_abs, reject_rel, reject_normal;
    float sky_depth;
    int use_obj;
};

struct SvgfAtrousArgs {
    const float* img[3];
    const float* var;
    const float* depth;
    const float* normal[3];
    const int* obj;
    float* out_img[3];
    float* out_var;
    int h, w, step;
    float sigma_l, edge_depth, edge_normal, sky_depth;
    int use_obj;
    int tile_w, tile_h;  // the block's tile: an instantiated one (see below)
};

// one channel of the variance estimate: its history and the output plane
struct SvgfVarianceChannel {
    const float* mean[3];
    const float* m2[3];
    const float* len;
    float* out;
};

struct SvgfVarianceArgs {
    SvgfVarianceChannel ch[2];   // ch[1] is read only when channels == 2
    const float* depth;
    const float* normal[3];
    const int* obj;
    int h, w, channels;
    float sky_depth;
    int use_obj;
};

struct SvgfFireflyArgs {
    const float* img[2][3];      // img[1] and out[1]: when channels == 2
    float* out[2][3];
    const float* depth;
    const float* normal[3];
    int h, w, channels;
    float sky_depth;
};

namespace {

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 ld3(const float* const p[3], int i) {
    return V3{p[0][i], p[1][i], p[2][i]};
}
__device__ __forceinline__ void st3(float* const p[3], int i, V3 v) {
    p[0][i] = v.x;
    p[1][i] = v.y;
    p[2][i] = v.z;
}
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
__device__ __forceinline__ V3 vmax(V3 a, V3 b) {
    return V3{fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z)};
}
__device__ __forceinline__ V3 vmin(V3 a, V3 b) {
    return V3{fminf(a.x, b.x), fminf(a.y, b.y), fminf(a.z, b.z)};
}
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }
__device__ __forceinline__ float dot(V3 a, V3 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ float luminance(V3 c) {
    return 0.2126f * c.x + 0.7152f * c.y + 0.0722f * c.z;
}
__device__ __forceinline__ bool is_sky(float d, V3 n, float thr) {
    return d > thr || dot(n, n) < 0.1f;
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}
// clip(int(f), 0, n - 1) for an integer-valued float; NaN -> 0
__device__ __forceinline__ int clip_index(float f, int n) {
    return static_cast<int>(fminf(fmaxf(f, 0.0f), static_cast<float>(n - 1)));
}

__device__ __forceinline__ bool edge_discontinuity(float d0, float d1, V3 n0,
                                                   V3 n1, int o0, int o1,
                                                   float depth_thr,
                                                   float normal_thr,
                                                   bool use_obj) {
    bool edge = use_obj && o0 != o1 && o0 >= 0 && o1 >= 0;
    const float max_d = fmaxf(d0, d1);
    edge = edge ||
           (max_d > 1e-6f && fabsf(d0 - d1) / fmaxf(max_d, 1e-6f) > depth_thr);
    return edge || dot(n0, n1) < normal_thr;
}

// -- the temporal stage ---------------------------------------------------------
//
// A block takes a TW x TH tile of pixels and loads the clamped 3x3 windows
// of all of them, (TW + 2) x (TH + 2) cells of depth, normal, id and each
// channel's colour, into shared memory once; at the image's edge a cell
// holds the clamped pixel, as the reference's window does.  A pixel then
// tests its window once for both channels (a 9-bit mask of the same
// surface) and its four bilinear corners once: the previous frame's depth,
// normal and id there give the corner weights, the fetched depth and the
// rejection.  The nearest pixel of the fallback and of the rejection is
// always one of the corners: floor(pu) is floor(pu - 0.5) or that plus 1
// (pu - 0.5 is exact below 2^23; beyond it, and for NaN or infinite
// motion, both clip to the same border), and clipping keeps the order; so
// no load waits for the corner weights.  Each channel then sums its window,
// fetches its history at the corners (its current colour on the first
// frame) and blends, in the plain version's float order.
//
// The stage waits on its loads, so the number of threads a SM keeps in
// flight sets its time: at 4 blocks of 256 (64 registers) a 1080p channel
// takes 0.150 ms and both channels in one launch 0.218 ms, against 0.179 ms
// a channel for the earlier design (one thread a pixel, its window through
// L1, 60 registers).  3 blocks (71-80 registers) took 0.172 and 0.240; 5
// and 6 blocks spilled and took 0.174-0.228 and 0.287-0.500; asking for
// the motion and the corners before the tile's barrier gained nothing
// (PERF.md).

constexpr int kTemporalW = 32, kTemporalH = 8;  // a block's tile
constexpr int kTemporalThreads = kTemporalW * kTemporalH;
constexpr int kTemporalBlocks = 4;  // resident blocks a SM: 64 registers
constexpr int kTemporalPitch = kTemporalW + 2;
constexpr int kTemporalCells = kTemporalPitch * (kTemporalH + 2);

// one channel's history at a pixel: its planes, or on the first frame its
// current colour (mean c, second moment c * c, length 1)
__device__ __forceinline__ void history_at(const SvgfChannel& c, bool first,
                                           int q, V3& mean, V3& m2,
                                           float& len) {
    if (first) {
        mean = ld3(c.cur, q);
        m2 = mul(mean, mean);
        len = 1.0f;
    } else {
        mean = ld3(c.hist_mean, q);
        m2 = ld3(c.hist_m2, q);
        len = c.hist_len[q];
    }
}

// v[k] for a k known only at run time, without a local-memory array
template <typename T>
__device__ __forceinline__ T pick4(const T (&v)[4], int k) {
    return k == 0 ? v[0] : (k == 1 ? v[1] : (k == 2 ? v[2] : v[3]));
}

template <int CH>
__global__ void __launch_bounds__(kTemporalThreads, kTemporalBlocks)
svgf_temporal_kernel(const SvgfTemporalArgs a) {
    __shared__ float s_d[kTemporalCells];
    __shared__ float s_n[3][kTemporalCells];
    __shared__ int s_o[kTemporalCells];
    __shared__ float s_c[CH][3][kTemporalCells];
    const int w = a.w, h = a.h;
    const int bx = blockIdx.x * kTemporalW, by = blockIdx.y * kTemporalH;
    const bool use_obj = a.use_obj != 0;
    for (int c = threadIdx.y * kTemporalW + threadIdx.x; c < kTemporalCells;
         c += kTemporalThreads) {
        const int r = c / kTemporalPitch;
        const int q = clampi(by - 1 + r, 0, h - 1) * w +
                      clampi(bx - 1 + (c - r * kTemporalPitch), 0, w - 1);
        s_d[c] = a.depth[q];
#pragma unroll
        for (int k = 0; k < 3; ++k) s_n[k][c] = a.normal[k][q];
        s_o[c] = a.obj[q];
#pragma unroll
        for (int ch = 0; ch < CH; ++ch)
#pragma unroll
            for (int k = 0; k < 3; ++k) s_c[ch][k][c] = a.ch[ch].cur[k][q];
    }
    __syncthreads();
    const int x = bx + threadIdx.x;
    const int y = by + threadIdx.y;
    if (x >= w || y >= h) return;
    const int p = y * w + x;
    const int cc = (threadIdx.y + 1) * kTemporalPitch + threadIdx.x + 1;
    const bool first = a.first != nullptr && *a.first != 0;
    const float d = s_d[cc];
    const V3 n{s_n[0][cc], s_n[1][cc], s_n[2][cc]};
    const int o = s_o[cc];

    // the 3x3 window's same-surface cells (clamped window), bit (dy+1)*3+dx+1
    unsigned same = 0;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
            const int t = cc - dy * kTemporalPitch - dx;
            if (!edge_discontinuity(d, s_d[t],
                                    n, V3{s_n[0][t], s_n[1][t], s_n[2][t]},
                                    o, s_o[t], a.edge_depth, a.edge_normal,
                                    use_obj))
                same |= 1u << ((dy + 1) * 3 + dx + 1);
        }
    }

    // reproject
    const float pu = (static_cast<float>(x) + 0.5f) - a.mv_x[p] * static_cast<float>(w);
    const float pv = (static_cast<float>(y) + 0.5f) - a.mv_y[p] * static_cast<float>(h);
    const bool in_bounds = pu >= 0.5f && pv >= 0.5f &&
                           pu < static_cast<float>(w) - 0.5f &&
                           pv < static_cast<float>(h) - 0.5f;

    // the four bilinear corners, the previous frame's surface there and
    // the corner weights it leaves
    const float fx = pu - 0.5f, fy = pv - 0.5f;
    const float x0 = floorf(fx), y0 = floorf(fy);
    const float sx = fx - x0, sy = fy - y0;
    const int x0c = clip_index(x0, w), y0c = clip_index(y0, h);
    const int x1c = clip_index(x0 + 1.0f, w), y1c = clip_index(y0 + 1.0f, h);
    const int cq[4] = {y0c * w + x0c, y0c * w + x1c, y1c * w + x0c,
                       y1c * w + x1c};
    float cw[4] = {(1.0f - sx) * (1.0f - sy), sx * (1.0f - sy),
                   (1.0f - sx) * sy, sx * sy};
    float pd[4];
    V3 pn[4];
    int po[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        pd[c] = a.prev_depth[cq[c]];
        pn[c] = ld3(a.prev_normal, cq[c]);
        po[c] = a.prev_obj[cq[c]];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
        if (edge_discontinuity(d, pd[c], n, pn[c], o, po[c], a.edge_depth,
                               a.edge_normal, use_obj))
            cw[c] = 0.0f;
    const float total_w = cw[0] + cw[1] + cw[2] + cw[3];
    const bool fallback = total_w < 1e-6f;
    // the nearest pixel: the corner at (clip(floor(pu)), clip(floor(pv)))
    const int k_near = (clip_index(floorf(pv), h) == y0c ? 0 : 2) +
                       (clip_index(floorf(pu), w) == x0c ? 0 : 1);
    const float inv_w = 1.0f / fmaxf(total_w, 1e-6f);
    const float h_d =
        fallback ? pick4(pd, k_near)
                 : (((pd[0] * cw[0] + pd[1] * cw[1]) + pd[2] * cw[2]) +
                    pd[3] * cw[3]) * inv_w;

    // rejection: object id and normal at the nearest previous pixel, depth
    // against the fetched history depth
    bool valid = in_bounds;
    if (use_obj) valid = valid && pick4(po, k_near) == o;
    const float dd = fabsf(d - h_d);
    valid = valid && !(dd > a.reject_abs || dd > a.reject_rel * fmaxf(d, 1e-6f));
    valid = valid && dot(n, pick4(pn, k_near)) >= a.reject_normal;
    const bool sky = is_sky(d, n, a.sky_depth);

#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
        const SvgfChannel& c = a.ch[ch];
        const V3 cur{s_c[ch][0][cc], s_c[ch][1][cc], s_c[ch][2][cc]};

        // 3x3 same-surface statistics of the current frame
        V3 n_mean{0.0f, 0.0f, 0.0f}, n_m2{0.0f, 0.0f, 0.0f};
        float n_cnt = 0.0f;
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
            for (int dx = -1; dx <= 1; ++dx) {
                const int t = cc - dy * kTemporalPitch - dx;
                const V3 nc{s_c[ch][0][t], s_c[ch][1][t], s_c[ch][2][t]};
                const float wgt =
                    (same >> ((dy + 1) * 3 + dx + 1)) & 1u ? 1.0f : 0.0f;
                n_mean = add(n_mean, mul(nc, wgt));
                n_m2 = add(n_m2, mul(mul(nc, nc), wgt));
                n_cnt = n_cnt + wgt;
            }
        }
        const bool empty = n_cnt == 0.0f;
        const float inv = 1.0f / fmaxf(n_cnt, 1.0f);
        n_mean = sel(empty, cur, mul(n_mean, inv));
        n_m2 = sel(empty, mul(cur, cur), mul(n_m2, inv));
        const V3 n_var = vmax(sub(n_m2, mul(n_mean, n_mean)), V3{0.0f, 0.0f, 0.0f});
        const V3 n_std{sqrtf(n_var.x), sqrtf(n_var.y), sqrtf(n_var.z)};
        const V3 soft_min = sub(n_mean, mul(n_std, c.clamp_scale));
        const V3 soft_max = add(n_mean, mul(n_std, c.clamp_scale));

        // edge-aware bilinear history fetch, or the nearest corner
        V3 hm[4], h2[4];
        float hl[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) history_at(c, first, cq[k], hm[k], h2[k], hl[k]);
        V3 h_mean, h_m2;
        float h_len;
        if (fallback) {
            h_mean = pick4(hm, k_near);
            h_m2 = pick4(h2, k_near);
            h_len = pick4(hl, k_near);
        } else {
            V3 am = mul(hm[0], cw[0]);
            V3 a2 = mul(h2[0], cw[0]);
            float al = hl[0] * cw[0];
#pragma unroll
            for (int k = 1; k < 4; ++k) {
                am = add(am, mul(hm[k], cw[k]));
                a2 = add(a2, mul(h2[k], cw[k]));
                al = al + hl[k] * cw[k];
            }
            h_mean = mul(am, inv_w);
            h_m2 = mul(a2, inv_w);
            h_len = al * inv_w;
        }
        if (valid) h_mean = vmin(vmax(h_mean, soft_min), soft_max);

        // variance-adaptive alpha; the cap clamps the length first
        const float cap = c.cap != nullptr ? c.cap[p] : c.max_history;
        h_len = fminf(h_len, cap);
        const V3 var = vmax(sub(h_m2, mul(h_mean, h_mean)), V3{0.0f, 0.0f, 0.0f});
        const float std_approx = (sqrtf(var.x) + sqrtf(var.y) + sqrtf(var.z)) / 3.0f;
        const float variance_alpha = std_approx / (std_approx + c.tau);
        const float history_alpha = 1.0f / (h_len + 1.0f);
        float alpha = fminf(fmaxf(fmaxf(variance_alpha, history_alpha), c.min_alpha),
                            1.0f);
        alpha = valid ? alpha : 1.0f;
        float new_len = valid ? fminf(h_len + 1.0f, cap) : 1.0f;

        V3 out_mean = add(mul(h_mean, 1.0f - alpha), mul(cur, alpha));
        V3 out_m2 = add(mul(h_m2, 1.0f - alpha), mul(mul(cur, cur), alpha));
        if (sky) {
            out_mean = cur;
            out_m2 = mul(cur, cur);
            new_len = 1.0f;
        }
        st3(c.out_mean, p, out_mean);
        st3(c.out_m2, p, out_m2);
        c.out_len[p] = new_len;
    }
}

template <int CH>
cudaError_t launch_temporal(const SvgfTemporalArgs& a, cudaStream_t stream) {
    const dim3 grid((a.w + kTemporalW - 1) / kTemporalW,
                    (a.h + kTemporalH - 1) / kTemporalH);
    svgf_temporal_kernel<CH><<<grid, dim3(kTemporalW, kTemporalH), 0, stream>>>(a);
    return cudaGetLastError();
}

// -- the à-trous pass ---------------------------------------------------------
//
// A block owns TW neighbouring columns of TH rows that lie `step` apart
// (blockIdx.y = row chunk * step + the rows' residue; at step 1 that is a
// plain TH x TW tile).  The 25 taps of its pixels then fall on
// (TH + 4) x (TW + 4 step) pixels, which the block loads once, row by row,
// into shared memory as cells of 40 bytes:
//     colour and its luminance | normal and depth | variance and object id.
// What depends on the tap's pixel alone is computed here, once a cell and
// not once for each of its 25 neighbours: the luminance, and the tap's two
// skip rules.  A cell outside the image (zero colour and variance) or of a
// sky pixel carries NaN in normal.x, so its normal test `dot(n, n_n) >=
// threshold` fails by itself: that mark takes the place of four bounds
// compares and a sky test a tap.  (The reference zero-pads and masks; a
// masked tap adds colour * 0, which this keeps, NaN colours included.)  A
// centre pixel that carries the mark is sky, or has a NaN normal that no tap
// passes: both keep their colour and variance, and skip the taps.  With the
// step a template parameter every tap is a shared-memory read at a
// compile-time offset.  Tiles (render/denoiser.py ATROUS_TILES): 32 x 16 at
// steps 1 and 2, 64 x 8 at steps 4, 8 and 16 (61 KB at step 16, three
// blocks a SM).  A taller or wider tile loads fewer halo cells a pixel but
// holds fewer blocks a SM, and measured slower; so did 128 and 512 threads
// a block and a launch bound for 5 or 6 blocks (PERF.md).

constexpr int kAtrousThreads = 256;
constexpr int kAtrousCellBytes = 40;
constexpr int kMaxSharedBytes = 232448;  // a block's most on this card

// 5x5 B-spline weights outer((1,4,6,4,1)) / 256, exact in float
__host__ __device__ constexpr float atrous_weight(int k) {
    return (k == 0 || k == 4) ? 1.0f / 16.0f
                              : ((k == 1 || k == 3) ? 4.0f / 16.0f
                                                    : 6.0f / 16.0f);
}

// STEP 0: the step is args.step (any other dilation than the instantiated)
template <int STEP, int TW, int TH>
__global__ void __launch_bounds__(kAtrousThreads)
svgf_atrous_kernel(const SvgfAtrousArgs a) {
    extern __shared__ float4 atrous_tile[];
    const int step = STEP ? STEP : a.step;
    const int pitch = TW + 4 * step;  // cells a tile row
    const int cells = (TH + 4) * pitch;
    float4* const colour = atrous_tile;          // rgb, luminance
    float4* const surface = atrous_tile + cells; // normal (x NaN: skip), depth
    float2* const rest =                         // variance, object id bits
        reinterpret_cast<float2*>(atrous_tile + 2 * cells);
    const int w = a.w, h = a.h;
    const int chunk = blockIdx.y / step;
    const int y0 = chunk * (step * TH) + (blockIdx.y - chunk * step);
    const int x0 = blockIdx.x * TW;
    if (y0 >= h) return;  // the whole block: no row of this residue
    const bool use_obj = a.use_obj != 0;
    const float nan = __int_as_float(0x7fc00000);

    for (int c = threadIdx.x; c < cells; c += kAtrousThreads) {
        const int r = c / pitch;
        const int y = y0 + (r - 2) * step;
        const int x = x0 - 2 * step + (c - r * pitch);
        float4 cl = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float4 sf = make_float4(nan, 0.0f, 0.0f, 0.0f);
        float2 rs = make_float2(0.0f, 0.0f);
        if (y >= 0 && y < h && x >= 0 && x < w) {
            const int q = y * w + x;
            const V3 t_c = ld3(a.img, q);
            const V3 t_n = ld3(a.normal, q);
            const float t_d = a.depth[q];
            cl = make_float4(t_c.x, t_c.y, t_c.z, luminance(t_c));
            sf = make_float4(is_sky(t_d, t_n, a.sky_depth) ? nan : t_n.x,
                             t_n.y, t_n.z, t_d);
            rs = make_float2(a.var[q],
                             __int_as_float(use_obj ? a.obj[q] : 0));
        }
        colour[c] = cl;
        surface[c] = sf;
        rest[c] = rs;
    }
    __syncthreads();

    for (int p = threadIdx.x; p < TW * TH; p += kAtrousThreads) {
        const int j = p / TW, i = p - j * TW;
        const int y = y0 + j * step, x = x0 + i;
        if (y >= h || x >= w) continue;
        const int cc = (j + 2) * pitch + i + 2 * step;
        const int q = y * w + x;
        const float4 c_cl = colour[cc];
        const float4 c_sf = surface[cc];
        const float2 c_rs = rest[cc];
        const V3 c{c_cl.x, c_cl.y, c_cl.z};
        const float variance = c_rs.x;
        if (isnan(c_sf.x)) {  // sky, or no tap passes the normal test
            st3(a.out_img, q, c);
            a.out_var[q] = variance;
            continue;
        }
        const float center_lum = c_cl.w;
        const V3 n{c_sf.x, c_sf.y, c_sf.z};
        const float d = c_sf.w;
        const int o = __float_as_int(c_rs.y);

        const float var_scale = sqrtf(fmaxf(variance, 1e-6f));
        const float adaptive_sigma = a.sigma_l * (1.0f + var_scale * 2.0f);
        const float inv_sigma_sq =
            1.0f / (2.0f * adaptive_sigma * adaptive_sigma + 1e-6f);

        V3 acc{0.0f, 0.0f, 0.0f};
        float acc_var = 0.0f, total_w = 0.0f;
#pragma unroll
        for (int dy = -2; dy <= 2; ++dy) {
#pragma unroll
            for (int dx = -2; dx <= 2; ++dx) {
                const int t = cc - dy * pitch - dx * step;
                const float4 t_cl = colour[t];
                const float4 t_sf = surface[t];
                const float2 t_rs = rest[t];
                const float k_w = atrous_weight(dy + 2) * atrous_weight(dx + 2);
                const V3 n_c{t_cl.x, t_cl.y, t_cl.z};
                const V3 n_n{t_sf.x, t_sf.y, t_sf.z};
                const float n_d = t_sf.w;
                // every test of every tap, with no branch between them
                const int n_o = __float_as_int(t_rs.y);
                const bool obj_edge =
                    use_obj & (o != n_o) & (o >= 0) & (n_o >= 0);
                const float max_d = fmaxf(d, n_d);
                const bool depth_edge =
                    (max_d > 1e-6f) &
                    (fabsf(d - n_d) / fmaxf(max_d, 1e-6f) > a.edge_depth);
                // false on a marked cell: outside the image, or sky
                const bool keep = !obj_edge & !depth_edge &
                                  (dot(n, n_n) >= a.edge_normal);
                const float lum_diff = fabsf(center_lum - t_cl.w);
                const float w_l = expf(-lum_diff * lum_diff * inv_sigma_sq);
                const float wgt = keep ? k_w * w_l : 0.0f;
                acc = add(acc, mul(n_c, wgt));
                acc_var = acc_var + t_rs.x * wgt;
                total_w = total_w + wgt;
            }
        }
        const bool ok = total_w >= 1e-6f;
        const float inv_w = 1.0f / fmaxf(total_w, 1e-6f);
        st3(a.out_img, q, ok ? mul(acc, inv_w) : c);
        a.out_var[q] = ok ? acc_var * inv_w : variance;
    }
}

template <int STEP, int TW, int TH>
cudaError_t launch_atrous(const SvgfAtrousArgs& a, cudaStream_t stream) {
    const int step = STEP ? STEP : a.step;
    const long long bytes = static_cast<long long>(TH + 4) *
                            (TW + 4LL * step) * kAtrousCellBytes;
    if (step < 1 || bytes > kMaxSharedBytes) return cudaErrorInvalidValue;
    const auto kernel = svgf_atrous_kernel<STEP, TW, TH>;
    if (bytes > 48 * 1024) {  // a cheap call, per device: every launch
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(bytes));
        if (e != cudaSuccess) return e;
    }
    const long long span = static_cast<long long>(step) * TH;
    const dim3 grid((a.w + TW - 1) / TW,
                    static_cast<unsigned>((a.h + span - 1) / span * step));
    kernel<<<grid, kAtrousThreads, bytes, stream>>>(a);
    return cudaGetLastError();
}

// (step, tile width, tile height) of every instantiated pass.  Step 0 takes
// any other step at run time.  No frame runs one (denoise_channel's steps
// are the five above), but atrous_iteration keeps the reference's any-step
// interface, which the tile test and chip_smoke.py's steps 3 and 5 reach;
// it is exact and untuned: 109 registers, 0.1955 ms at step 3 at 1080p
// (PERF.md).  The wrapper picks one (render/denoiser.py atrous_launch).
#define PTRT_ATROUS_TILES(X)                                                  \
    X(1, 32, 16) X(2, 32, 16) X(4, 64, 8) X(8, 64, 8) X(16, 64, 8) X(0, 32, 4)

// -- the variance estimate and the firefly clamp ----------------------------
//
// svgf_variance replaces ptrt_tpu/render/denoiser.py estimate_variance
// (:390): a channel's temporal variance max(m2 - mean^2, 0), boosted by
// 1 + (1 - min(length / 4, 1)) * 3, floored by the 3x3 edge-clamped spatial
// variance of its mean over the pixels of the centre's object (every pixel
// with object ids off), as luminance; 0 on sky.  svgf_firefly replaces
// firefly_suppression (:190): each colour clamped to 1.25 times its
// zero-padded 8-neighbourhood maximum and to 10; sky passes through.
// Under XLA each is a fusion of shifted copies and selects; the plain torch
// versions launch ~520 (variance) and ~85 (firefly) kernels a channel over
// 8 MB planes at 1080p.
//
// What bounds them on the card: bytes.  The variance of both channels of a
// split frame reads the shared depth, normal and id once (5 planes) and a
// channel's mean, m2 and length (7) and writes one: 21 planes, 0.052 ms at
// 1080p at 3.35 TB/s.  The firefly clamp of both reads depth and normal (4)
// and a channel's colour (3) and writes it (3): 16 planes, 0.040 ms.  A
// pixel runs a few dozen float operations and nine taps through L1.
//
// What this design does about it: one thread a pixel, a 32 x 8 block, one
// launch for both channels of a split frame (the sky test, the window's
// clamped offsets and same-object weights made once a pixel); the taps'
// neighbours come through L1, where a block's rows overlap.  The float
// operations follow the plain version's order: the nine taps summed from
// zero in its row-major order, each as (nc * nc) * wgt, the divisor a true
// 1 / max(count, 1) then a multiply; max and min propagate NaN as torch's
// maximum, minimum, clamp_min and clamp_max do (fmaxf would drop it).

constexpr int kPixelW = 32, kPixelH = 8;  // a block of one thread a pixel

// torch.maximum / torch.minimum, and clamp_min / clamp_max against a
// number: a NaN operand is the result, the first operand's first
__device__ __forceinline__ float tmax(float a, float b) {
    return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
    return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}
__device__ __forceinline__ V3 tmax3(V3 a, V3 b) {
    return V3{tmax(a.x, b.x), tmax(a.y, b.y), tmax(a.z, b.z)};
}
__device__ __forceinline__ V3 tmin3(V3 a, V3 b) {
    return V3{tmin(a.x, b.x), tmin(a.y, b.y), tmin(a.z, b.z)};
}

template <int CH>
__global__ void __launch_bounds__(kPixelW * kPixelH)
svgf_variance_kernel(const SvgfVarianceArgs a) {
    const int w = a.w, h = a.h;
    const int x = blockIdx.x * kPixelW + threadIdx.x;
    const int y = blockIdx.y * kPixelH + threadIdx.y;
    if (x >= w || y >= h) return;
    const int p = y * w + x;
    if (is_sky(a.depth[p], ld3(a.normal, p), a.sky_depth)) {
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) a.ch[ch].out[p] = 0.0f;
        return;
    }
    // the window's taps in the plain version's order: out[y, x] of the tap
    // (dy, dx) is the pixel (clamp(y - dy), clamp(x - dx))
    const int o = a.obj[p];
    int q[9];
    float wgt[9];
    float cnt = 0.0f;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
            const int k = (dy + 1) * 3 + dx + 1;
            q[k] = clampi(y - dy, 0, h - 1) * w + clampi(x - dx, 0, w - 1);
            wgt[k] = (a.use_obj == 0 || a.obj[q[k]] == o) ? 1.0f : 0.0f;
            cnt = cnt + wgt[k];
        }
    }
    const float inv = 1.0f / tmax(cnt, 1.0f);
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
        const SvgfVarianceChannel& c = a.ch[ch];
        const V3 m = ld3(c.mean, p);
        const V3 zero{0.0f, 0.0f, 0.0f};
        const V3 var = tmax3(sub(ld3(c.m2, p), mul(m, m)), zero);
        const float reliability = tmin(c.len[p] * 0.25f, 1.0f);
        const float boost = 1.0f + (1.0f - reliability) * 3.0f;
        V3 sp_mean = zero, sp_m2 = zero;
#pragma unroll
        for (int k = 0; k < 9; ++k) {
            const V3 nc = ld3(c.mean, q[k]);
            sp_mean = add(sp_mean, mul(nc, wgt[k]));
            sp_m2 = add(sp_m2, mul(mul(nc, nc), wgt[k]));
        }
        sp_mean = mul(sp_mean, inv);
        sp_m2 = mul(sp_m2, inv);
        const V3 sp_var = tmax3(sub(sp_m2, mul(sp_mean, sp_mean)), zero);
        c.out[p] = luminance(tmax3(mul(var, boost), sp_var));
    }
}

template <int CH>
__global__ void __launch_bounds__(kPixelW * kPixelH)
svgf_firefly_kernel(const SvgfFireflyArgs a) {
    const int w = a.w, h = a.h;
    const int x = blockIdx.x * kPixelW + threadIdx.x;
    const int y = blockIdx.y * kPixelH + threadIdx.y;
    if (x >= w || y >= h) return;
    const int p = y * w + x;
    const bool sky = is_sky(a.depth[p], ld3(a.normal, p), a.sky_depth);
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
        const V3 c = ld3(a.img[ch], p);
        V3 out = c;
        if (!sky) {
            // the zero-padded neighbours in the plain version's order
            V3 max_n{0.0f, 0.0f, 0.0f};
#pragma unroll
            for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
                for (int dx = -1; dx <= 1; ++dx) {
                    if (dy == 0 && dx == 0) continue;
                    const int sy = y - dy, sx = x - dx;
                    const V3 t = (sy >= 0 && sy < h && sx >= 0 && sx < w)
                                     ? ld3(a.img[ch], sy * w + sx)
                                     : V3{0.0f, 0.0f, 0.0f};
                    max_n = tmax3(max_n, t);
                }
            }
            out = tmin3(tmin3(c, mul(max_n, 1.25f)), V3{10.0f, 10.0f, 10.0f});
        }
        st3(a.out[ch], p, out);
    }
}

dim3 pixel_grid(int h, int w) {
    return dim3((w + kPixelW - 1) / kPixelW, (h + kPixelH - 1) / kPixelH);
}

}  // namespace

extern "C" int ptrt_svgf_temporal(const SvgfTemporalArgs* args, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (args->channels != 1 && args->channels != 2)
        return static_cast<int>(cudaErrorInvalidValue);
    if (args->h <= 0 || args->w <= 0)
        return static_cast<int>(cudaGetLastError());
    return static_cast<int>(args->channels == 2 ? launch_temporal<2>(*args, s)
                                                : launch_temporal<1>(*args, s));
}

// Registers, local-memory bytes a thread, threads a block, static shared
// bytes a block and resident blocks a SM of the temporal kernel of one or
// two channels.
extern "C" int ptrt_svgf_temporal_info(int channels, int* regs,
                                       int* local_bytes, int* threads,
                                       int* shared_bytes, int* per_sm) {
    if (channels != 1 && channels != 2)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto kernel = channels == 2 ? svgf_temporal_kernel<2>
                                      : svgf_temporal_kernel<1>;
    cudaFuncAttributes attr = {};
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            per_sm, kernel, kTemporalThreads, 0);
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    *threads = kTemporalThreads;
    *shared_bytes = static_cast<int>(attr.sharedSizeBytes);
    return static_cast<int>(e);
}

extern "C" int ptrt_svgf_atrous(const SvgfAtrousArgs* args, void* stream) {
    if (args->h <= 0 || args->w <= 0)
        return static_cast<int>(cudaGetLastError());
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTRT_ATROUS_LAUNCH(S, TW, TH)                                         \
    if ((S == 0 || args->step == S) && args->tile_w == TW &&                  \
        args->tile_h == TH)                                                   \
        return static_cast<int>(launch_atrous<S, TW, TH>(*args, s));
    PTRT_ATROUS_TILES(PTRT_ATROUS_LAUNCH)
#undef PTRT_ATROUS_LAUNCH
    return static_cast<int>(cudaErrorInvalidValue);  // no such tile
}

// Registers, local-memory bytes a thread, and resident blocks a SM at
// `shared_bytes` of dynamic shared memory, of the à-trous kernel of a tile.
extern "C" int ptrt_svgf_atrous_info(int step, int tile_w, int tile_h,
                                     int shared_bytes, int* regs,
                                     int* local_bytes, int* per_sm) {
#define PTRT_ATROUS_INFO(S, TW, TH)                                           \
    if (step == S && tile_w == TW && tile_h == TH) {                          \
        const auto kernel = svgf_atrous_kernel<S, TW, TH>;                    \
        cudaFuncAttributes attr = {};                                         \
        cudaError_t e = cudaFuncGetAttributes(&attr, kernel);                 \
        if (e == cudaSuccess && shared_bytes > 48 * 1024)                     \
            e = cudaFuncSetAttribute(                                         \
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,          \
                kMaxSharedBytes);                                             \
        if (e == cudaSuccess)                                                 \
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                \
                per_sm, kernel, kAtrousThreads, shared_bytes);                \
        *regs = attr.numRegs;                                                 \
        *local_bytes = static_cast<int>(attr.localSizeBytes);                 \
        return static_cast<int>(e);                                           \
    }
    PTRT_ATROUS_TILES(PTRT_ATROUS_INFO)
#undef PTRT_ATROUS_INFO
    return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int ptrt_svgf_variance(const SvgfVarianceArgs* args, void* stream) {
    if (args->channels != 1 && args->channels != 2)
        return static_cast<int>(cudaErrorInvalidValue);
    if (args->h <= 0 || args->w <= 0)
        return static_cast<int>(cudaGetLastError());
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 block(kPixelW, kPixelH);
    if (args->channels == 2)
        svgf_variance_kernel<2><<<pixel_grid(args->h, args->w), block, 0, s>>>(*args);
    else
        svgf_variance_kernel<1><<<pixel_grid(args->h, args->w), block, 0, s>>>(*args);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int ptrt_svgf_firefly(const SvgfFireflyArgs* args, void* stream) {
    if (args->channels != 1 && args->channels != 2)
        return static_cast<int>(cudaErrorInvalidValue);
    if (args->h <= 0 || args->w <= 0)
        return static_cast<int>(cudaGetLastError());
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 block(kPixelW, kPixelH);
    if (args->channels == 2)
        svgf_firefly_kernel<2><<<pixel_grid(args->h, args->w), block, 0, s>>>(*args);
    else
        svgf_firefly_kernel<1><<<pixel_grid(args->h, args->w), block, 0, s>>>(*args);
    return static_cast<int>(cudaGetLastError());
}
