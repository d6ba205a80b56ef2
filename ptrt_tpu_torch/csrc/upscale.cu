// K12 upscale_bilinear: the bilinear upscale of a frame's three colour
// planes to the display size.
//
// Replaces: ptrt_tpu/render/pipeline.py upscale_bilinear (:174-178), one
// jax.image.resize(..., "bilinear") a plane (XLA, no Pallas): rows first,
// then columns, each output sample the triangle-weighted pair of input
// samples at (j + 0.5) * in / out - 0.5, taps outside the input dropped
// and the rest renormalised.  The plain torch version (render/pipeline.py
// _resize_axis) launches ~45 kernels a plane and axis, 275 a frame.
//
// What bounds it on the card: bytes.  The source planes are read once and
// the output planes written once, 12 bytes an input and an output pixel:
// 39 MB from 1440x810 to 1920x1080, 0.0116 ms at 3.35 TB/s; under the
// launch floor at the games' 224x125 -> 640x360.  A pixel runs 18 float
// operations.
//
// What this design does about it: one launch for the three planes, a block
// a tile of 32 * PIX x 8 output pixels, a warp an output row of the tile, a
// thread PIX neighbouring pixels of it.  The warp reads the tile's first
// and last column taps, which bound the source columns the tile names (the
// taps rise with the column: at most 32 * PIX + 4 for an upscale), asks for
// both source rows' values at all of them at once with coalesced loads, and
// runs the row pass once a column into shared memory, rounded to float32 as
// the plain version's (out_h, in_w) plane stores it; then the column pass
// from there, a thread's PIX columns' taps read with one load each (int32
// indices and float weights, render/pipeline.py resize_taps: the plain
// version's own taps, made once for each (in, out) size and device, so a
// frame captured into a CUDA graph builds nothing from host data), and its
// PIX pixels stored as one float4 where the row is 16-byte aligned.
// Neighbouring output pixels share their source columns (at 0.75 scale 128
// output columns read 97), where a thread a pixel runs the row pass twice
// for every pixel.  No block barrier: a warp reads only the row values it
// wrote.  PIX is 4 where those tiles give the card at least a block an SM
// (the scenes' 1920x1080 and the games' 640x360), else 1, so a small frame
// (the games' 320x180) spreads over more SMs.  Staging the tile's source
// rows in shared memory first, then the row pass from there, measured
// slower (PERF.md).  The float operations follow the plain version's
// order, a[r0] * w0 + a[r1] * w1 for each pass; this file builds with
// -fmad=false, so no product is fused into an add.

#include <cuda_runtime.h>
#include <stdint.h>

struct UpscaleArgs {
    const float* src[3];         // (in_h, in_w) each, contiguous
    float* dst[3];               // (out_h, out_w) each, contiguous
    const int* row_index;        // (2, out_h) int32: each output row's taps
    const float* row_weight;     // (2, out_h): their weights
    const int* col_index;        // (2, out_w) int32
    const float* col_weight;     // (2, out_w)
    int in_h, in_w, out_h, out_w;
};

namespace {

// a tile of 32 * PIX x kTileH output pixels, a warp a row, PIX pixels a
// thread (PIX 1 or 4)
constexpr int kTileH = 8;
constexpr int kThreads = 32 * kTileH;
constexpr int kMaxDevices = 64;

// the source columns a tile row's taps may name: an upscale's 32 * PIX
// neighbouring samples move by at most as many source columns (in <= out),
// plus the second tap, with room for the float32 rounding of the sample
// positions
template <int PIX>
constexpr int kSpan = 32 * PIX + 4;

// PIX neighbouring entries of a (n,) row from index x: one 16-byte load
// where four lie aligned and inside, else one at a time (`fill` past n)
template <int PIX, typename T, typename T4>
__device__ __forceinline__ void load_row(const T* p, int x, int n, T fill,
                                         T (&v)[PIX]) {
    if constexpr (PIX == 4) {
        if (x + 4 <= n && (reinterpret_cast<uintptr_t>(p + x) & 15u) == 0) {
            const T4 q = *reinterpret_cast<const T4*>(p + x);
            v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
            return;
        }
    }
#pragma unroll
    for (int i = 0; i < PIX; ++i) v[i] = x + i < n ? p[x + i] : fill;
}

template <int PIX>
__global__ void __launch_bounds__(kThreads, 4)
upscale_bilinear_kernel(const UpscaleArgs a) {
    constexpr int kTileW = 32 * PIX, kS = kSpan<PIX>;
    constexpr int kIters = (kS + 31) / 32;  // a lane's columns in the span
    __shared__ float row_pass[kTileH][3][kS];
    const int lane = threadIdx.x & 31, ty = threadIdx.x >> 5;
    const int x0 = blockIdx.x * kTileW;
    const int x = x0 + lane * PIX;  // the thread's first pixel
    const int y = blockIdx.y * kTileH + ty;
    if (y >= a.out_h) return;  // a warp's own row: no block barrier
    // the source columns the tile's taps name: from its first column's
    // first tap to its last column's second
    const int cmin = a.col_index[x0];
    const int span =
        a.col_index[a.out_w + min(x0 + kTileW, a.out_w) - 1] - cmin + 1;
    if (span > kS) __trap();  // not an upscale: refused by the C entry
    const long long r0 =
        static_cast<long long>(a.row_index[y]) * a.in_w + cmin;
    const long long r1 =
        static_cast<long long>(a.row_index[a.out_h + y]) * a.in_w + cmin;
    const float wr0 = a.row_weight[y], wr1 = a.row_weight[a.out_h + y];
    // the thread's columns' taps (past the row's end: any tap inside)
    int c0[PIX], c1[PIX];
    float wc0[PIX], wc1[PIX];
    load_row<PIX, int, int4>(a.col_index, x, a.out_w, cmin, c0);
    load_row<PIX, int, int4>(a.col_index + a.out_w, x, a.out_w, cmin, c1);
    load_row<PIX, float, float4>(a.col_weight, x, a.out_w, 0.0f, wc0);
    load_row<PIX, float, float4>(a.col_weight + a.out_w, x, a.out_w, 0.0f,
                                 wc1);

    // the row pass at the span's columns, rounded as the plain plane holds
    // it: every load asked for before the first is used
    float s0[kIters][3], s1[kIters][3];
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
        const int c = lane + 32 * it;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            s0[it][k] = c < span ? __ldg(a.src[k] + r0 + c) : 0.0f;
            s1[it][k] = c < span ? __ldg(a.src[k] + r1 + c) : 0.0f;
        }
    }
#pragma unroll
    for (int it = 0; it < kIters; ++it) {
        const int c = lane + 32 * it;
        if (c < span) {
#pragma unroll
            for (int k = 0; k < 3; ++k)
                row_pass[ty][k][c] = s0[it][k] * wr0 + s1[it][k] * wr1;
        }
    }
    __syncwarp();

    // the column pass, PIX pixels a plane
    if (x >= a.out_w) return;
    const long long p = static_cast<long long>(y) * a.out_w + x;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float* v = row_pass[ty][k];
        float o[PIX];
#pragma unroll
        for (int i = 0; i < PIX; ++i)
            o[i] = v[c0[i] - cmin] * wc0[i] + v[c1[i] - cmin] * wc1[i];
        float* d = a.dst[k] + p;
        if constexpr (PIX == 4) {
            if (x + 4 <= a.out_w &&
                (reinterpret_cast<uintptr_t>(d) & 15u) == 0) {
                *reinterpret_cast<float4*>(d) =
                    make_float4(o[0], o[1], o[2], o[3]);
                continue;
            }
        }
#pragma unroll
        for (int i = 0; i < PIX; ++i)
            if (x + i < a.out_w) d[i] = o[i];
    }
}

template <int PIX>
void launch(const UpscaleArgs* a, cudaStream_t stream) {
    const dim3 grid((a->out_w + 32 * PIX - 1) / (32 * PIX),
                    (a->out_h + kTileH - 1) / kTileH);
    upscale_bilinear_kernel<PIX><<<grid, kThreads, 0, stream>>>(*a);
}

// the card's SMs, once a device
cudaError_t sm_count(int* sms) {
    static int counts[kMaxDevices];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (counts[dev] == 0)
        e = cudaDeviceGetAttribute(&counts[dev],
                                   cudaDevAttrMultiProcessorCount, dev);
    *sms = counts[dev];
    return e;
}

}  // namespace

extern "C" int ptrt_upscale_bilinear(const UpscaleArgs* args, void* stream) {
    if (args->out_h <= 0 || args->out_w <= 0)
        return static_cast<int>(cudaGetLastError());
    // an upscale on each axis (kSpan holds a tile row's source columns)
    if (args->in_h <= 0 || args->in_w <= 0 || args->in_h > args->out_h ||
        args->in_w > args->out_w)
        return static_cast<int>(cudaErrorInvalidValue);
    int sms = 0;
    const cudaError_t e = sm_count(&sms);
    if (e != cudaSuccess) return static_cast<int>(e);
    // four pixels a thread where those tiles give every SM a block
    const long long tiles4 =
        static_cast<long long>((args->out_w + 127) / 128) *
        ((args->out_h + kTileH - 1) / kTileH);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (tiles4 >= sms)
        launch<4>(args, s);
    else
        launch<1>(args, s);
    return static_cast<int>(cudaGetLastError());
}
