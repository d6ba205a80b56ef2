// svgf_temporal and svgf_atrous: the two per-pixel stages of the SVGF
// denoiser that carry its memory traffic.
//
// Replaces: ptrt_tpu/render/denoiser.py temporal_accumulation (:276, with
// _edge_aware_bilinear :217 and the first-frame history of denoise_channel
// :490) and atrous_iteration (:425).  Under XLA each is a fusion of dozens
// of shifted copies, gathers and selects over (H, W) planes.
//
// What bounds them on the card: memory traffic and load count.  The
// temporal stage reads a 3x3 neighbourhood of colour, depth, normal and id
// (9 x 8 floats) and four bilinear corners of eight history planes per
// pixel; an à-trous pass reads up to 25 taps of nine planes.  The plain
// torch versions write every shifted plane and every intermediate to device
// memory (hundreds of 8 MB planes per pass at 1080p).
//
// What this design does about it: one thread per pixel, every intermediate
// in registers; neighbour loads hit L1/L2 because the threads of a 32x8
// block share their windows; each output plane is written once.  The
// temporal kernel fetches its own history (four corners plus the
// nearest-pixel fallback) and applies the first-frame rule from a device
// flag, so the frame needs no host round trip.  Border rules follow the
// reference exactly: the temporal 3x3 window clamps coordinates, the
// bilinear corners clip after floor, the à-trous taps outside the image
// are skipped (zero-padded and masked), including dilations past the
// image.  The float operations follow the plain version's order; this file
// builds with -fmad=false, so no product is fused into an add the plain
// version rounds separately.

#include <cuda_runtime.h>
#include <stdint.h>

struct SvgfTemporalArgs {
    const float* cur[3];
    const float* hist_mean[3];
    const float* hist_m2[3];
    const float* hist_len;
    const float* mv_x;
    const float* mv_y;
    const float* depth;
    const float* normal[3];
    const int* obj;
    const float* prev_depth;
    const float* prev_normal[3];
    const int* prev_obj;
    const float* cap;            // per-pixel history cap, or null
    const unsigned char* first;  // 0-d bool: history := current, or null
    float* out_mean[3];
    float* out_m2[3];
    float* out_len;
    int h, w;
    float clamp_scale, tau, min_alpha, max_history;
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
};

namespace {

constexpr int kBlockX = 32, kBlockY = 8;

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

// one history plane, with the first-frame rule applied
struct History {
    const SvgfTemporalArgs* a;
    bool first;
    __device__ V3 mean(int i) const {
        return first ? ld3(a->cur, i) : ld3(a->hist_mean, i);
    }
    __device__ V3 m2(int i) const {
        if (first) {
            const V3 c = ld3(a->cur, i);
            return mul(c, c);
        }
        return ld3(a->hist_m2, i);
    }
    __device__ float len(int i) const { return first ? 1.0f : a->hist_len[i]; }
};

__global__ void __launch_bounds__(kBlockX * kBlockY)
svgf_temporal_kernel(const SvgfTemporalArgs a) {
    const int x = blockIdx.x * kBlockX + threadIdx.x;
    const int y = blockIdx.y * kBlockY + threadIdx.y;
    const int w = a.w, h = a.h;
    if (x >= w || y >= h) return;
    const int p = y * w + x;
    const bool use_obj = a.use_obj != 0;
    const History hist{&a, a.first != nullptr && *a.first != 0};

    const V3 cur = ld3(a.cur, p);
    const float d = a.depth[p];
    const V3 n = ld3(a.normal, p);
    const int o = a.obj[p];

    // 3x3 same-surface statistics of the current frame, clamped window
    V3 n_mean{0.0f, 0.0f, 0.0f}, n_m2{0.0f, 0.0f, 0.0f};
    float n_cnt = 0.0f;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
            const int q = clampi(y - dy, 0, h - 1) * w + clampi(x - dx, 0, w - 1);
            const V3 nc = ld3(a.cur, q);
            const bool same = !edge_discontinuity(
                d, a.depth[q], n, ld3(a.normal, q), o, a.obj[q], a.edge_depth,
                a.edge_normal, use_obj);
            const float wgt = same ? 1.0f : 0.0f;
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
    const V3 soft_min = sub(n_mean, mul(n_std, a.clamp_scale));
    const V3 soft_max = add(n_mean, mul(n_std, a.clamp_scale));

    // reproject
    const float pu = (static_cast<float>(x) + 0.5f) - a.mv_x[p] * static_cast<float>(w);
    const float pv = (static_cast<float>(y) + 0.5f) - a.mv_y[p] * static_cast<float>(h);
    const bool in_bounds = pu >= 0.5f && pv >= 0.5f &&
                           pu < static_cast<float>(w) - 0.5f &&
                           pv < static_cast<float>(h) - 0.5f;

    // edge-aware bilinear history fetch
    const float fx = pu - 0.5f, fy = pv - 0.5f;
    const float x0 = floorf(fx), y0 = floorf(fy);
    const float sx = fx - x0, sy = fy - y0;
    const int x0c = clip_index(x0, w), y0c = clip_index(y0, h);
    const int x1c = clip_index(x0 + 1.0f, w), y1c = clip_index(y0 + 1.0f, h);
    const int cq[4] = {y0c * w + x0c, y0c * w + x1c, y1c * w + x0c,
                       y1c * w + x1c};
    float cw[4] = {(1.0f - sx) * (1.0f - sy), sx * (1.0f - sy),
                   (1.0f - sx) * sy, sx * sy};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const int q = cq[c];
        if (edge_discontinuity(d, a.prev_depth[q], n, ld3(a.prev_normal, q), o,
                               a.prev_obj[q], a.edge_depth, a.edge_normal,
                               use_obj))
            cw[c] = 0.0f;
    }
    const float total_w = cw[0] + cw[1] + cw[2] + cw[3];
    const bool fallback = total_w < 1e-6f;
    const int nx = clip_index(floorf(pu), w), ny = clip_index(floorf(pv), h);
    const int nq = ny * w + nx;
    const float inv_w = 1.0f / fmaxf(total_w, 1e-6f);

    V3 h_mean, h_m2;
    float h_len, h_d;
    if (fallback) {
        h_mean = hist.mean(nq);
        h_m2 = hist.m2(nq);
        h_len = hist.len(nq);
        h_d = a.prev_depth[nq];
    } else {
        V3 am = mul(hist.mean(cq[0]), cw[0]);
        V3 a2 = mul(hist.m2(cq[0]), cw[0]);
        float al = hist.len(cq[0]) * cw[0];
        float ad = a.prev_depth[cq[0]] * cw[0];
#pragma unroll
        for (int c = 1; c < 4; ++c) {
            am = add(am, mul(hist.mean(cq[c]), cw[c]));
            a2 = add(a2, mul(hist.m2(cq[c]), cw[c]));
            al = al + hist.len(cq[c]) * cw[c];
            ad = ad + a.prev_depth[cq[c]] * cw[c];
        }
        h_mean = mul(am, inv_w);
        h_m2 = mul(a2, inv_w);
        h_len = al * inv_w;
        h_d = ad * inv_w;
    }

    // rejection: object id and normal at the nearest previous pixel, depth
    // against the fetched history depth
    bool valid = in_bounds;
    if (use_obj) valid = valid && a.prev_obj[nq] == o;
    const float dd = fabsf(d - h_d);
    valid = valid && !(dd > a.reject_abs || dd > a.reject_rel * fmaxf(d, 1e-6f));
    valid = valid && dot(n, ld3(a.prev_normal, nq)) >= a.reject_normal;

    if (valid) h_mean = vmin(vmax(h_mean, soft_min), soft_max);

    // variance-adaptive alpha; the cap clamps the length first
    const float cap = a.cap != nullptr ? a.cap[p] : a.max_history;
    h_len = fminf(h_len, cap);
    const V3 var = vmax(sub(h_m2, mul(h_mean, h_mean)), V3{0.0f, 0.0f, 0.0f});
    const float std_approx = (sqrtf(var.x) + sqrtf(var.y) + sqrtf(var.z)) / 3.0f;
    const float variance_alpha = std_approx / (std_approx + a.tau);
    const float history_alpha = 1.0f / (h_len + 1.0f);
    float alpha = fminf(fmaxf(fmaxf(variance_alpha, history_alpha), a.min_alpha),
                        1.0f);
    alpha = valid ? alpha : 1.0f;
    float new_len = valid ? fminf(h_len + 1.0f, cap) : 1.0f;

    V3 out_mean = add(mul(h_mean, 1.0f - alpha), mul(cur, alpha));
    V3 out_m2 = add(mul(h_m2, 1.0f - alpha), mul(mul(cur, cur), alpha));
    if (is_sky(d, n, a.sky_depth)) {
        out_mean = cur;
        out_m2 = mul(cur, cur);
        new_len = 1.0f;
    }
    st3(a.out_mean, p, out_mean);
    st3(a.out_m2, p, out_m2);
    a.out_len[p] = new_len;
}

// 5x5 B-spline weights outer((1,4,6,4,1))/256 * 256, exact in float
__constant__ float kAtrousW[5] = {1.0f / 16.0f, 4.0f / 16.0f, 6.0f / 16.0f,
                                  4.0f / 16.0f, 1.0f / 16.0f};

__global__ void __launch_bounds__(kBlockX * kBlockY)
svgf_atrous_kernel(const SvgfAtrousArgs a) {
    const int x = blockIdx.x * kBlockX + threadIdx.x;
    const int y = blockIdx.y * kBlockY + threadIdx.y;
    const int w = a.w, h = a.h;
    if (x >= w || y >= h) return;
    const int p = y * w + x;
    const bool use_obj = a.use_obj != 0;

    const V3 c = ld3(a.img, p);
    const float variance = a.var[p];
    const float d = a.depth[p];
    const V3 n = ld3(a.normal, p);
    const int o = a.obj[p];

    const float center_lum = luminance(c);
    const float var_scale = sqrtf(fmaxf(variance, 1e-6f));
    const float adaptive_sigma = a.sigma_l * (1.0f + var_scale * 2.0f);
    const float inv_sigma_sq =
        1.0f / (2.0f * adaptive_sigma * adaptive_sigma + 1e-6f);

    V3 acc{0.0f, 0.0f, 0.0f};
    float acc_var = 0.0f, total_w = 0.0f;
#pragma unroll
    for (int dy = -2; dy <= 2; ++dy) {
        const int qy = y - dy * a.step;
        if (qy < 0 || qy >= h) continue;
#pragma unroll
        for (int dx = -2; dx <= 2; ++dx) {
            const int qx = x - dx * a.step;
            if (qx < 0 || qx >= w) continue;
            const int q = qy * w + qx;
            const float k_w = kAtrousW[dy + 2] * kAtrousW[dx + 2];
            const V3 n_c = ld3(a.img, q);
            const float n_d = a.depth[q];
            const V3 n_n = ld3(a.normal, q);
            bool keep = true;
            if (use_obj) {
                const int n_o = a.obj[q];
                keep = !(o != n_o && o >= 0 && n_o >= 0);
            }
            const float max_d = fmaxf(d, n_d);
            keep = keep && !(max_d > 1e-6f &&
                             fabsf(d - n_d) / fmaxf(max_d, 1e-6f) > a.edge_depth);
            keep = keep && dot(n, n_n) >= a.edge_normal;
            keep = keep && !is_sky(n_d, n_n, a.sky_depth);
            const float lum_diff = fabsf(center_lum - luminance(n_c));
            const float w_l = expf(-lum_diff * lum_diff * inv_sigma_sq);
            const float wgt = keep ? k_w * w_l : 0.0f;
            acc = add(acc, mul(n_c, wgt));
            acc_var = acc_var + a.var[q] * wgt;
            total_w = total_w + wgt;
        }
    }
    const bool ok = total_w >= 1e-6f && !is_sky(d, n, a.sky_depth);
    const float inv_w = 1.0f / fmaxf(total_w, 1e-6f);
    st3(a.out_img, p, ok ? mul(acc, inv_w) : c);
    a.out_var[p] = ok ? acc_var * inv_w : variance;
}

dim3 grid_for(int h, int w) {
    return dim3((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
}

}  // namespace

extern "C" int ptrt_svgf_temporal(const SvgfTemporalArgs* args, void* stream) {
    if (args->h > 0 && args->w > 0) {
        svgf_temporal_kernel<<<grid_for(args->h, args->w),
                               dim3(kBlockX, kBlockY), 0,
                               static_cast<cudaStream_t>(stream)>>>(*args);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int ptrt_svgf_atrous(const SvgfAtrousArgs* args, void* stream) {
    if (args->h > 0 && args->w > 0) {
        svgf_atrous_kernel<<<grid_for(args->h, args->w),
                             dim3(kBlockX, kBlockY), 0,
                             static_cast<cudaStream_t>(stream)>>>(*args);
    }
    return static_cast<int>(cudaGetLastError());
}
