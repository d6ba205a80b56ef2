// The bloom chain in one cooperative launch, `bloom_chain`: the soft-knee
// bright pass folded into mip 0, mips 1-5, the bilinear upsample-add from
// the coarsest mip back to mip 0 and, where asked, the composite hdr +
// up(mip 0).
//
// Replaces: ptrt_tpu/render/bloom.py apply_bloom (:92-118) — bright_pass
// (:21), _blur_h (:30) and _downsample_v (:47) at each of up to six mips,
// _upsample_bilinear (:65) up the chain and onto the image.  A mip step is
// the 5-tap horizontal Gaussian with an edge clamp, then the vertical 5-tap
// fused with the 2x decimation, from (h, w) to (h / 2, ceil(w / 2)).
//
// What bounds it on the card: bytes (the 1080p input read once and mip 0
// after the chain written once, 31 MB, 9.3 us at 3.35 TB/s) and, above
// that, the levels' latency: mips 1-5 are 1.55 MB to 6 KB, too small to
// fill the card, and the plain version ran each mip as a launch at a
// launch's floor, the upsample-add as ~440 eager torch ops.
//
// What this design does about it:
//  * one persistent grid of as many blocks as are co-resident
//    (`cudaLaunchCooperativeKernel`; a grid larger than the card holds
//    fails the launch, nothing splits it); the grid syncs between phases:
//    mip 0, each smaller mip, the upsample-add, the composite;
//  * a mip step is one block a 32x8 tile of outputs: the block asks for its
//    whole 19x67 input window (2-pixel halo, edge-clamped) at once, applies
//    the bright pass as it stores it in shared memory (mip 0), runs the
//    horizontal blur at the kept columns only, then the vertical blur with
//    the decimation;
//  * the whole upsample-add chain is one phase: a block takes a 64x16 tile
//    of mip 0, loads the small region of every coarser mip that the tile
//    reads (all loads in flight at once) and adds the levels up, coarse to
//    fine, in shared memory — recomputing the regions' small overlaps with
//    its neighbours instead of syncing the grid at every level;
//  * data made inside the launch is read with __ldcg (from L2, never a
//    stale L1 line); the argument block is __grid_constant__ (indexing it
//    by level copied it to local memory a thread, 1.8x slower).
//
// The float operations follow the plain version's order (render/bloom.py)
// and the upsample coordinates come from the wrapper's tables (computed on
// the CPU), so the result equals the plain version bit for bit; this file
// builds with -fmad=false.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLevels = 6;
constexpr int kThreads = 256;
constexpr int kTileW = 32, kTileH = kThreads / kTileW;  // outputs a tile
constexpr int kInW = 2 * kTileW + 3, kInH = 2 * kTileH + 3;
// the upsample-add's tile of mip 0 (kUpPix outputs a thread, in one column
// kThreads / kUpW rows apart), and the largest region of a level that such
// a tile reads (the wrapper checks every tile's against it)
constexpr int kUpW = 64, kUpH = 16, kUpPix = kUpW * kUpH / kThreads;
constexpr int kRegH = 12, kRegW = 40;
constexpr float kW0 = 0.227027f, kW1 = 0.316216f, kW2 = 0.070270f;

}  // namespace

// One axis of a bilinear upsample: the two taps, clamped into the input,
// and the fraction (as float bits), three rows of n.
struct BloomAxis {
    const int* table;
    int n;
};

struct BloomChainArgs {
    const float* hdr[3];
    int h, w;
    float threshold, knee, knee2;  // knee2 = 2 * knee
    int levels;
    float* mip[kMaxLevels][3];
    int mh[kMaxLevels], mw[kMaxLevels];
    BloomAxis ux[kMaxLevels], uy[kMaxLevels];  // step k: level k + 1 -> k
    BloomAxis cx, cy;                          // composite: mip 0 -> (h, w)
    // the rows (columns) of levels 1.. that each tile row (column) of mip
    // 0 reads, first and last: [tiles][levels - 1][2]
    const int* tile_rows;
    const int* tile_cols;
    float* top[3];  // mip 0 after the upsample-add chain
    float* out[3];  // hdr + up(top), or null
    int grid;
};

namespace {

struct Tile {
    float in[3][kInH][kInW];
    float hb[3][kInH][kTileW];
};

// a mip-0 tile's regions of the chained levels 1.. (index k - 1): each
// level's region (origin and size) and its values, first the blurred mip's,
// then, coarse to fine, those plus the upsample of the region below
struct Pyramid {
    float reg[kMaxLevels - 1][3][kRegH][kRegW];
    int y0[kMaxLevels], x0[kMaxLevels], ny[kMaxLevels], nx[kMaxLevels];
    int first[kMaxLevels + 1];  // where each level starts in the list
};

// torch.maximum and torch.clamp(v, 0, 1): NaN propagates
__device__ __forceinline__ float tmax(float a, float b) {
    return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float tclamp01(float v) {
    return v != v ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// One 32x8 tile of outputs of a mip step (with the bright pass on the
// input where kBright), the tile's origin (tx0, ty0) in outputs.
template <bool kBright>
__device__ __forceinline__ void down_tile(const float* const* src, int h,
                                          int w, float* const* dst, int oh,
                                          int ow, int tx0, int ty0, float thr,
                                          float knee, float knee2, Tile& t) {
    constexpr int kIn = kInH * kInW;
    constexpr int kLoads = (kIn + kThreads - 1) / kThreads;
    const int r0 = 2 * ty0 - 2, c0 = 2 * tx0 - 2;
    // every load of the window issued before any is stored
    float v[kLoads][3];
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
        const int i = threadIdx.x + j * kThreads;
        if (i < kIn) {
            const int ty = i / kInW, tx = i - ty * kInW;
            const int r = min(max(r0 + ty, 0), h - 1);
            const int c = min(max(c0 + tx, 0), w - 1);
            const size_t o = static_cast<size_t>(r) * w + c;
#pragma unroll
            for (int k = 0; k < 3; ++k) v[j][k] = __ldcg(src[k] + o);
        }
    }
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
        const int i = threadIdx.x + j * kThreads;
        if (i < kIn) {
            const int ty = i / kInW, tx = i - ty * kInW;
            float v0 = v[j][0], v1 = v[j][1], v2 = v[j][2];
            if (kBright) {
                const float soft = (tmax(v0, tmax(v1, v2)) - thr) + knee;
                const float f = tclamp01(soft / knee2 + 0.5f);
                v0 = v0 * f;
                v1 = v1 * f;
                v2 = v2 * f;
            }
            t.in[0][ty][tx] = v0;
            t.in[1][ty][tx] = v1;
            t.in[2][ty][tx] = v2;
        }
    }
    __syncthreads();
    // the horizontal blur at the kept columns 2x
    for (int i = threadIdx.x; i < kInH * kTileW; i += kThreads) {
        const int ty = i / kTileW, tx = i - ty * kTileW, c = 2 * tx + 2;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const float* row = t.in[k][ty];
            float o = row[c] * kW0;
            o = o + (row[c - 1] + row[c + 1]) * kW1;
            t.hb[k][ty][tx] = o + (row[c - 2] + row[c + 2]) * kW2;
        }
    }
    __syncthreads();
    const int tx = threadIdx.x % kTileW, ty = threadIdx.x / kTileW;
    const int x = tx0 + tx, y = ty0 + ty;
    if (x < ow && y < oh) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            float acc = t.hb[k][2 * ty][tx] * kW2;
            acc = acc + t.hb[k][2 * ty + 1][tx] * kW1;
            acc = acc + t.hb[k][2 * ty + 2][tx] * kW0;
            acc = acc + t.hb[k][2 * ty + 3][tx] * kW1;
            acc = acc + t.hb[k][2 * ty + 4][tx] * kW2;
            dst[k][static_cast<size_t>(y) * ow + x] = acc;
        }
    }
    __syncthreads();  // the tile is refilled next
}

__device__ __forceinline__ int tiles_of(int oh, int ow) {
    return ((ow + kTileW - 1) / kTileW) * ((oh + kTileH - 1) / kTileH);
}

template <bool kBright>
__device__ __forceinline__ void down_level(const float* const* src, int h,
                                           int w, float* const* dst, int oh,
                                           int ow, const BloomChainArgs& a,
                                           Tile& t) {
    const int tiles_x = (ow + kTileW - 1) / kTileW;
    const int tiles = tiles_of(oh, ow);
    for (int i = blockIdx.x; i < tiles; i += gridDim.x) {
        const int by = i / tiles_x;
        down_tile<kBright>(src, h, w, dst, oh, ow,
                           (i - by * tiles_x) * kTileW, by * kTileH,
                           a.threshold, a.knee, a.knee2, t);
    }
}

// The bilinear upsample of `src` (sh, sw) at one output pixel: the row's
// taps y0, y1 and fraction vf, the column's x0, x1 and uf.
__device__ __forceinline__ float up_at(const float* src, int sw, int y0,
                                       int y1, float vf, int x0, int x1,
                                       float uf) {
    const size_t r0 = static_cast<size_t>(y0) * sw,
                 r1 = static_cast<size_t>(y1) * sw;
    const float a00 = __ldcg(src + r0 + x0), a10 = __ldcg(src + r0 + x1);
    const float a01 = __ldcg(src + r1 + x0), a11 = __ldcg(src + r1 + x1);
    const float top = a00 + (a10 - a00) * uf;
    const float bot = a01 + (a11 - a01) * uf;
    return top + (bot - top) * vf;
}

// out[k] = base[k] + up(src[k]) over the (oh, ow) output
__device__ __forceinline__ void up_level(float* const* src, int sw,
                                         float* const* out,
                                         const float* const* base, int oh,
                                         int ow, BloomAxis ax, BloomAxis ay) {
    const int n = oh * ow;
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
         i += gridDim.x * kThreads) {
        const int y = i / ow, x = i - y * ow;
        const int y0 = __ldg(ay.table + y), y1 = __ldg(ay.table + ay.n + y);
        const float vf = __int_as_float(__ldg(ay.table + 2 * ay.n + y));
        const int x0 = __ldg(ax.table + x), x1 = __ldg(ax.table + ax.n + x);
        const float uf = __int_as_float(__ldg(ax.table + 2 * ax.n + x));
#pragma unroll
        for (int k = 0; k < 3; ++k)
            out[k][i] = __ldcg(base[k] + i) +
                        up_at(src[k], sw, y0, y1, vf, x0, x1, uf);
    }
}

// the bilinear upsample at taps (y0, x0), (y1, x1) of a region
__device__ __forceinline__ float region_at(float (*r)[kRegW], int y0,
                                           int y1, float vf, int x0, int x1,
                                           float uf) {
    const float top = r[y0][x0] + (r[y0][x1] - r[y0][x0]) * uf;
    const float bot = r[y1][x0] + (r[y1][x1] - r[y1][x0]) * uf;
    return top + (bot - top) * vf;
}

// One 64x16 tile of mip 0 after the whole upsample-add chain: the block loads
// the region of each chained level that the tile reads (all levels' loads
// in flight at once), then, coarse to fine in shared memory, adds to each
// level's blurred values the upsample of the region below, and writes mip
// 0's tile plus the upsample of level 1's region to `top`.  Blocks
// recompute the small overlaps of their regions; every value is the same
// operations as the plain chain's, so the same bits.
__device__ __forceinline__ void up_tile(const BloomChainArgs& a, int tile,
                                        Pyramid& p) {
    constexpr int kLoads = 4;
    const int levels = a.levels;
    const int tiles_x = (a.mw[0] + kUpW - 1) / kUpW;
    const int ty = tile / tiles_x, tx = tile - ty * tiles_x;
    if (threadIdx.x < 2 * (levels - 1)) {  // a thread a (level, axis)
        const int k = threadIdx.x >> 1;
        const int* b = (threadIdx.x & 1)
                           ? a.tile_cols + (tx * (levels - 1) + k) * 2
                           : a.tile_rows + (ty * (levels - 1) + k) * 2;
        const int lo = __ldg(b), n = __ldg(b + 1) - lo + 1;
        if (threadIdx.x & 1) {
            p.x0[k + 1] = lo;
            p.nx[k + 1] = n;
        } else {
            p.y0[k + 1] = lo;
            p.ny[k + 1] = n;
        }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int at = 0;
        for (int k = 1; k < levels; ++k) {
            p.first[k] = at;
            at += p.ny[k] * p.nx[k];
        }
        p.first[levels] = at;
    }
    // this thread's mip-0 outputs: one column, rows kThreads / kUpW apart
    const int x = tx * kUpW + threadIdx.x % kUpW;
    const int y_first = ty * kUpH + threadIdx.x / kUpW;
    constexpr int kRowStep = kThreads / kUpW;
    float base[kUpPix][3];
#pragma unroll
    for (int r = 0; r < kUpPix; ++r) {
        const int y = y_first + r * kRowStep;
        if (x < a.mw[0] && y < a.mh[0]) {
            const size_t o = static_cast<size_t>(y) * a.mw[0] + x;
#pragma unroll
            for (int c = 0; c < 3; ++c) base[r][c] = __ldcg(a.mip[0][c] + o);
        }
    }
    __syncthreads();
    // every level's blurred values, kLoads a thread issued before any is
    // stored
    const int total = p.first[levels];
    for (int at = 0; at < total; at += kLoads * kThreads) {
        float v[kLoads][3];
        int where[kLoads];
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
            const int i = at + threadIdx.x + j * kThreads;
            where[j] = -1;
            if (i < total) {
                int k = 1;
                while (i >= p.first[k + 1]) ++k;
                const int e = i - p.first[k], yy = e / p.nx[k],
                          xx = e - yy * p.nx[k];
                const size_t o = static_cast<size_t>(p.y0[k] + yy) *
                                     a.mw[k] + p.x0[k] + xx;
#pragma unroll
                for (int c = 0; c < 3; ++c) v[j][c] = __ldcg(a.mip[k][c] + o);
                where[j] = ((k - 1) * kRegH + yy) * kRegW + xx;
            }
        }
#pragma unroll
        for (int j = 0; j < kLoads; ++j) {
            if (where[j] >= 0) {
                const int k = where[j] / (kRegH * kRegW),
                          yx = where[j] - k * (kRegH * kRegW);
#pragma unroll
                for (int c = 0; c < 3; ++c)
                    (&p.reg[k][c][0][0])[yx] = v[j][c];
            }
        }
    }
    __syncthreads();
    for (int k = levels - 2; k >= 1; --k) {
        const int nx = p.nx[k], n = p.ny[k] * nx;
        const BloomAxis ay = a.uy[k], ax = a.ux[k];
        for (int i = threadIdx.x; i < n; i += kThreads) {
            const int yy = i / nx, xx = i - yy * nx;
            const int yl = p.y0[k] + yy, xl = p.x0[k] + xx;
            const int y0 = __ldg(ay.table + yl) - p.y0[k + 1];
            const int y1 = __ldg(ay.table + ay.n + yl) - p.y0[k + 1];
            const float vf = __int_as_float(__ldg(ay.table + 2 * ay.n + yl));
            const int x0 = __ldg(ax.table + xl) - p.x0[k + 1];
            const int x1 = __ldg(ax.table + ax.n + xl) - p.x0[k + 1];
            const float uf = __int_as_float(__ldg(ax.table + 2 * ax.n + xl));
#pragma unroll
            for (int c = 0; c < 3; ++c)
                p.reg[k - 1][c][yy][xx] =
                    p.reg[k - 1][c][yy][xx] +
                    region_at(p.reg[k][c], y0, y1, vf, x0, x1, uf);
        }
        __syncthreads();
    }
    if (x < a.mw[0]) {
        const BloomAxis ay = a.uy[0], ax = a.ux[0];
        const int x0 = __ldg(ax.table + x) - p.x0[1];
        const int x1 = __ldg(ax.table + ax.n + x) - p.x0[1];
        const float uf = __int_as_float(__ldg(ax.table + 2 * ax.n + x));
#pragma unroll
        for (int r = 0; r < kUpPix; ++r) {
            const int y = y_first + r * kRowStep;
            if (y >= a.mh[0]) break;
            const int y0 = __ldg(ay.table + y) - p.y0[1];
            const int y1 = __ldg(ay.table + ay.n + y) - p.y0[1];
            const float vf = __int_as_float(__ldg(ay.table + 2 * ay.n + y));
            const size_t o = static_cast<size_t>(y) * a.mw[0] + x;
#pragma unroll
            for (int c = 0; c < 3; ++c)
                a.top[c][o] = base[r][c] +
                              region_at(p.reg[0][c], y0, y1, vf, x0, x1, uf);
        }
    }
    __syncthreads();  // the regions are refilled next
}

__global__ void __launch_bounds__(kThreads)
bloom_chain_kernel(const __grid_constant__ BloomChainArgs a) {
    __shared__ union {
        Tile tile;
        Pyramid pyramid;
    } sm;
    Tile& tile = sm.tile;
    cg::grid_group grid = cg::this_grid();
    down_level<true>(a.hdr, a.h, a.w, a.mip[0], a.mh[0], a.mw[0], a, tile);
    for (int k = 1; k < a.levels; ++k) {
        grid.sync();
        down_level<false>(a.mip[k - 1], a.mh[k - 1], a.mw[k - 1], a.mip[k],
                          a.mh[k], a.mw[k], a, tile);
    }
    if (a.levels > 1) {
        grid.sync();
        const int tiles = ((a.mw[0] + kUpW - 1) / kUpW) *
                          ((a.mh[0] + kUpH - 1) / kUpH);
        for (int i = blockIdx.x; i < tiles; i += gridDim.x)
            up_tile(a, i, sm.pyramid);
    }
    if (a.out[0]) {
        grid.sync();
        up_level(a.top, a.mw[0], a.out, a.hdr, a.h, a.w, a.cx, a.cy);
    }
}

}  // namespace

// The chain's cooperative launch of `args->grid` blocks (the wrapper takes
// it from ptrt_bloom_chain_info); cudaLaunchCooperativeKernel refuses a
// grid the card cannot hold at once.
extern "C" int ptrt_bloom_chain(const BloomChainArgs* args, void* stream) {
    if (args->levels < 1 || args->levels > kMaxLevels || args->grid < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    void* params[] = {const_cast<BloomChainArgs*>(args)};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(bloom_chain_kernel), dim3(args->grid),
        dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream)));
}

// The chain kernel's registers, local bytes a thread, static shared bytes
// and resident blocks a SM, the SMs of the current device, threads a block,
// the tile (outputs) of a mip step, the upsample-add's tile of mip 0 and
// the largest region of a level it reads: the wrapper checks they are its.
extern "C" int ptrt_bloom_chain_info(int* regs, int* local_bytes,
                                     int* shared_bytes, int* per_sm,
                                     int* sms, int* layout) {
    cudaFuncAttributes attr = {};
    int dev = 0;
    cudaError_t e = cudaFuncGetAttributes(&attr, bloom_chain_kernel);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            per_sm, bloom_chain_kernel, kThreads, 0);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    *shared_bytes = static_cast<int>(attr.sharedSizeBytes);
    const int mine[] = {kThreads, kTileW, kTileH, kUpW, kUpH, kRegH, kRegW};
    for (int i = 0; i < 7; ++i) layout[i] = mine[i];
    return static_cast<int>(e);
}
