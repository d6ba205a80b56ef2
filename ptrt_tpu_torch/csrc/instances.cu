// K11: the per-frame instance update of a fused game frame
// (instances_update): the instance rows, their world boxes and the instance
// tree over those boxes, in place.
//
// Replaces: ptrt_tpu/geometry/dtransform.py instance_mats (:41) and
// instance_world_aabbs (:64), which the reference's fused frame
// (ptrt_tpu/games/fused.py:101-135) runs as XLA fusions every frame, and
// the port's host build of the instance tree (geometry/tlas.py build_tlas,
// numpy), which the reference has no counterpart of: it tests every box
// (ptrt_tpu/render/traverse.py _inst_hit_words).  A fused frame whose boxes
// come from the card would otherwise copy them to the host, build the tree
// there and upload it, every frame.
//
// What bounds it on the card: latency.  The sets the games move are 1
// (fluid), 10 (cube slider) and 192 (tycoon) instances: at 192 it reads 60 B
// and writes 120 B an instance plus 64 nodes of 128 B, ~43 KB, a hundredth
// of a microsecond at 3.35 TB/s.  The tree's levels depend on each other
// and the Morton order on every instance's centre, so the work is a chain
// of block barriers: 0.0205 ms at 192 on an H100 (PERF.md).
//
// What this design does about it:
//  * up to kOneBlockMax (1,024) instances, one launch of one block: a
//    thread an instance (strided) computes the rows (rot_xyz with sinf /
//    cosf, no fast math), the eight corners' box and the box centre in
//    float64; the centres' bounds by a block reduction; the 30-bit Morton
//    codes in float64 exactly as tlas.morton_order (non-finite and
//    degenerate axes included); the (code, id) pairs sorted in shared
//    memory by a bitonic network (each pair a distinct 64-bit key, so any
//    correct sort gives the stable order); then the tree level by level,
//    leaves first, a barrier between levels;
//  * past it (the same split as refit.cu's morton_sort / morton_codes), the
//    grid path: inst_rows_kernel over the card (the rows, boxes and each
//    block's centre bounds), inst_codes_kernel (every block reduces the
//    blocks' bounds, then a code a thread), torch.sort (stable) in the
//    wrapper, and one inst_level_kernel launch a tree level.  No host read.
//
// Exactness: built with -fmad=false and the plain version's product order
// (geometry/dtransform.py: each product and sum rounded on its own, the
// sums left to right), so the rows and boxes equal instances_update_plain's
// on the card where sinf / cosf agree with torch's.  The tree's min / max
// follow numpy's fmin / fmax (a NaN operand loses, a tie takes the second
// operand, so signed zeros too) in numpy's reduction order, so the tree
// equals build_tlas of the boxes written, bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWidth = 4;           // tlas.TLAS_WIDTH
constexpr int kRow = 8;             // tlas.TLAS_ROW
constexpr int kMatCols = 24;        // InstanceSet.mats
constexpr int kThreads = 1024;      // the one-block kernel
// instances the one-block kernel takes (its sort's keys; a power of two).
// On an H100 (chip_smoke.py phase 15) the one block's time grows with the
// set, 0.053 ms at 1,024 and 0.098 at 2,048, while the grid path's stays
// near 0.07 (0.071 at 2,049, 0.076 at 4,096): the crossover lies between
// the two, and 1,024 is the largest power of two below it.
constexpr int kOneBlockMax = 1024;
constexpr int kGridThreads = 256;   // the grid path's blocks
constexpr int kMaxLevels = 16;      // 4^15 leaves is past 2^24 instances
constexpr int kMaxWarps = kThreads / 32;

struct Inputs {
    const float* __restrict__ pos;    // (n, 3) each
    const float* __restrict__ rot;
    const float* __restrict__ scale;
    const float* __restrict__ llo;
    const float* __restrict__ lhi;
    float* mats;                      // (n, 24)
    float* bmin;                      // (n, 3)
    float* bmax;
    int n;
};

// the tree's levels, leaves first: node count and first node index of each
struct Levels {
    int n;
    int count[kMaxLevels];
    int off[kMaxLevels];
};

// torch.minimum / maximum: a NaN operand wins
__device__ __forceinline__ float nan_min(float a, float b) {
    return (a < b || isnan(a)) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
    return (a > b || isnan(a)) ? a : b;
}
// numpy's fmin / fmax: a NaN operand loses, a tie gives the second
__device__ __forceinline__ float np_fmin(float a, float b) {
    return (a < b || isnan(b)) ? a : b;
}
__device__ __forceinline__ float np_fmax(float a, float b) {
    return (a > b || isnan(b)) ? a : b;
}

// One instance: its rows and world box written, its box centre (float64)
// returned.  dtransform.instance_mats and instance_world_aabbs, operation
// for operation.
__device__ void instance_rows(const Inputs& a, int i, double c[3]) {
    float p[3], rr[3], s[3], lo[3], hi[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        p[k] = a.pos[3 * i + k];
        rr[k] = a.rot[3 * i + k];
        s[k] = a.scale[3 * i + k];
        lo[k] = a.llo[3 * i + k];
        hi[k] = a.lhi[3 * i + k];
    }
    const float cx = cosf(rr[0]), sx = sinf(rr[0]);
    const float cy = cosf(rr[1]), sy = sinf(rr[1]);
    const float cz = cosf(rr[2]), sz = sinf(rr[2]);
    float r[9];
    r[0] = cz * cy;
    r[1] = cz * sy * sx - sz * cx;
    r[2] = cz * sy * cx + sz * sx;
    r[3] = sz * cy;
    r[4] = sz * sy * sx + cz * cx;
    r[5] = sz * sy * cx - cz * sx;
    r[6] = -sy;
    r[7] = cy * sx;
    r[8] = cy * cx;
    // 1 / max(|s|, 1e-12) * sign(s), a zero scale counting as +
    float inv_s[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        float mag = fabsf(s[k]);
        mag = mag < 1e-12f ? 1e-12f : mag;
        inv_s[k] =
            (1.0f / mag) * (s[k] == 0.0f ? 1.0f : copysignf(1.0f, s[k]));
    }
    float* m = a.mats + static_cast<size_t>(kMatCols) * i;
#pragma unroll
    for (int row = 0; row < 3; ++row) {
        // S^-1 R^T: row `row` is R's column `row` over s[row]
        const float a0 = r[row] * inv_s[row];
        const float a1 = r[3 + row] * inv_s[row];
        const float a2 = r[6 + row] * inv_s[row];
        m[4 * row] = a0;
        m[4 * row + 1] = a1;
        m[4 * row + 2] = a2;
        m[4 * row + 3] = -(a0 * p[0] + a1 * p[1] + a2 * p[2]);
    }
#pragma unroll
    for (int row = 0; row < 3; ++row)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            m[12 + 3 * row + j] = r[3 * row + j] * inv_s[j];
    m[21] = 0.0f;
    m[22] = 0.0f;
    m[23] = 0.0f;

    // the eight corners through R S, plus t; min / max in corner order
    float w[9];
#pragma unroll
    for (int row = 0; row < 3; ++row)
#pragma unroll
        for (int j = 0; j < 3; ++j) w[3 * row + j] = r[3 * row + j] * s[j];
    float blo[3], bhi[3];
#pragma unroll
    for (int corner = 0; corner < 8; ++corner) {
        const float q0 = (corner & 4) ? hi[0] : lo[0];
        const float q1 = (corner & 2) ? hi[1] : lo[1];
        const float q2 = (corner & 1) ? hi[2] : lo[2];
#pragma unroll
        for (int row = 0; row < 3; ++row) {
            const float v = w[3 * row] * q0 + w[3 * row + 1] * q1 +
                            w[3 * row + 2] * q2 + p[row];
            blo[row] = corner == 0 ? v : nan_min(blo[row], v);
            bhi[row] = corner == 0 ? v : nan_max(bhi[row], v);
        }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        a.bmin[3 * i + k] = blo[k];
        a.bmax[3 * i + k] = bhi[k];
        c[k] = 0.5 * (static_cast<double>(blo[k]) +
                      static_cast<double>(bhi[k]));
    }
}

__device__ __forceinline__ void centre(const float* bmin, const float* bmax,
                                       int i, double c[3]) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
        c[k] = 0.5 * (static_cast<double>(bmin[3 * i + k]) +
                      static_cast<double>(bmax[3 * i + k]));
}

__device__ __forceinline__ void grow(double lo[3], double hi[3],
                                     const double c[3]) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        if (isfinite(c[k])) {
            lo[k] = fmin(lo[k], c[k]);
            hi[k] = fmax(hi[k], c[k]);
        }
    }
}

// The block's bounds of its threads' finite centres into bounds[0:3] (lo)
// and bounds[3:6] (hi); every thread of the block takes part.
__device__ void block_bounds(double lo[3], double hi[3], double* red,
                             double* bounds) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int warps = (blockDim.x + 31) >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            lo[k] = fmin(lo[k], __shfl_xor_sync(0xffffffffu, lo[k], off));
            hi[k] = fmax(hi[k], __shfl_xor_sync(0xffffffffu, hi[k], off));
        }
    if (lane == 0)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            red[6 * warp + k] = lo[k];
            red[6 * warp + 3 + k] = hi[k];
        }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            lo[k] = lane < warps ? red[6 * lane + k] : INFINITY;
            hi[k] = lane < warps ? red[6 * lane + 3 + k] : -INFINITY;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                lo[k] = fmin(lo[k], __shfl_xor_sync(0xffffffffu, lo[k], off));
                hi[k] = fmax(hi[k], __shfl_xor_sync(0xffffffffu, hi[k], off));
            }
        if (lane == 0)
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                bounds[k] = lo[k];
                bounds[3 + k] = hi[k];
            }
    }
    __syncthreads();
}

__device__ __forceinline__ unsigned spread10(unsigned v) {
    v &= 0x3FFu;
    v = (v | (v << 16)) & 0x030000FFu;
    v = (v | (v << 8)) & 0x0300F00Fu;
    v = (v | (v << 4)) & 0x030C30C3u;
    return (v | (v << 2)) & 0x09249249u;
}

// tlas.morton_order's code of one centre within the bounds, in float64
__device__ unsigned morton_code(const double c[3], const double* bounds) {
    unsigned q[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const double lo = bounds[k], hi = bounds[3 + k];
        const bool wide = hi > lo;
        const double base = wide ? lo : 0.0;
        const double scale = wide ? 1023.0 / (hi - lo) : 0.0;
        double v = isfinite(c[k]) ? (c[k] - base) * scale : 0.0;
        v = fmin(fmax(v, 0.0), 1023.0);
        q[k] = static_cast<unsigned>(v);
    }
    return (spread10(q[0]) << 2) | (spread10(q[1]) << 1) | spread10(q[2]);
}

__device__ __forceinline__ void write_row(float* tlas, int node, int slot,
                                          const float lo[3], float ref,
                                          const float hi[3], bool valid) {
    float4* row = reinterpret_cast<float4*>(
        tlas + (static_cast<size_t>(node) * kWidth + slot) * kRow);
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    row[0] = valid ? make_float4(lo[0], lo[1], lo[2], ref) : zero;
    row[1] = valid ? make_float4(hi[0], hi[1], hi[2], 1.0f) : zero;
}

// Row t of the leaves: the t-th instance in Morton order (id), or an empty
// slot (id < 0).  The instance's box verbatim, ref -1 - id.
__device__ void leaf_row(float* tlas, const Levels& lv, int t, int id,
                         const float* bmin, const float* bmax) {
    float lo[3] = {0.0f, 0.0f, 0.0f}, hi[3] = {0.0f, 0.0f, 0.0f};
    if (id >= 0)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            lo[k] = bmin[3 * id + k];
            hi[k] = bmax[3 * id + k];
        }
    write_row(tlas, lv.off[0] + t / kWidth, t % kWidth, lo,
              static_cast<float>(-1 - id), hi, id >= 0);
}

// Row t of level `level` > 0: child node t of the level below, its box the
// fmin / fmax over its valid rows' (lo, hi) both ways (an inverted box
// too), empty rows counting as +-inf, folded left to right as numpy's
// reduce does.
__device__ void inner_row(float* tlas, const Levels& lv, int level, int t) {
    const int node = lv.off[level] + t / kWidth, slot = t % kWidth;
    float lo[3] = {0.0f, 0.0f, 0.0f}, hi[3] = {0.0f, 0.0f, 0.0f};
    const bool valid = t < lv.count[level - 1];
    const int child = lv.off[level - 1] + t;
    if (valid) {
        const float* rows = tlas + static_cast<size_t>(child) * kWidth * kRow;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            lo[k] = np_fmin(rows[k], rows[4 + k]);
            hi[k] = np_fmax(rows[k], rows[4 + k]);
        }
#pragma unroll
        for (int s = 1; s < kWidth; ++s) {
            const float* r = rows + s * kRow;
            const bool used = r[7] != 0.0f;
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                lo[k] = np_fmin(lo[k],
                                used ? np_fmin(r[k], r[4 + k]) : INFINITY);
                hi[k] = np_fmax(hi[k],
                                used ? np_fmax(r[k], r[4 + k]) : -INFINITY);
            }
        }
    }
    write_row(tlas, node, slot, lo, static_cast<float>(child), hi, valid);
}

// Ascending bitonic sort of `size` (a power of two) keys in shared memory
// by the whole block.
__device__ void bitonic_sort(unsigned long long* keys, int size) {
    for (int k = 2; k <= size; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int t = threadIdx.x; t < size; t += blockDim.x) {
                const int u = t ^ j;
                if (u > t) {
                    const unsigned long long x = keys[t], y = keys[u];
                    const bool up = (t & k) == 0;
                    if ((x > y) == up) {
                        keys[t] = y;
                        keys[u] = x;
                    }
                }
            }
            __syncthreads();
        }
    }
}

// The whole update of at most kOneBlockMax instances in one block.
__global__ void __launch_bounds__(kThreads)
inst_update_kernel(const __grid_constant__ Inputs a, float* tlas,
                        const __grid_constant__ Levels lv) {
    __shared__ unsigned long long keys[kOneBlockMax];
    __shared__ double red[6 * kMaxWarps];
    __shared__ double bounds[6];
    double lo[3] = {INFINITY, INFINITY, INFINITY};
    double hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int i = threadIdx.x; i < a.n; i += kThreads) {
        double c[3];
        instance_rows(a, i, c);
        grow(lo, hi, c);
    }
    block_bounds(lo, hi, red, bounds);
    int size = 1;
    while (size < a.n) size <<= 1;
    // each thread reads back the boxes it wrote itself
    for (int i = threadIdx.x; i < size; i += kThreads) {
        unsigned long long key = ~0ull;
        if (i < a.n) {
            double c[3];
            centre(a.bmin, a.bmax, i, c);
            key = (static_cast<unsigned long long>(morton_code(c, bounds))
                   << 32) | static_cast<unsigned>(i);
        }
        keys[i] = key;
    }
    __syncthreads();
    bitonic_sort(keys, size);
    for (int t = threadIdx.x; t < lv.count[0] * kWidth; t += kThreads)
        leaf_row(tlas, lv, t,
                 t < a.n ? static_cast<int>(keys[t] & 0xffffffffu) : -1,
                 a.bmin, a.bmax);
    for (int level = 1; level < lv.n; ++level) {
        __syncthreads();
        for (int t = threadIdx.x; t < lv.count[level] * kWidth; t += kThreads)
            inner_row(tlas, lv, level, t);
    }
}

// The grid path.  instances_rows: a thread an instance, each block's
// centre bounds into partial[6 * block].
__global__ void __launch_bounds__(kGridThreads)
inst_rows_kernel(const __grid_constant__ Inputs a, double* partial) {
    __shared__ double red[6 * (kGridThreads / 32)];
    __shared__ double bounds[6];
    double lo[3] = {INFINITY, INFINITY, INFINITY};
    double hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    const int i = blockIdx.x * kGridThreads + threadIdx.x;
    if (i < a.n) {
        double c[3];
        instance_rows(a, i, c);
        grow(lo, hi, c);
    }
    block_bounds(lo, hi, red, bounds);
    if (threadIdx.x < 6) partial[6 * blockIdx.x + threadIdx.x] =
        bounds[threadIdx.x];
}

// instances_codes: every block reduces the blocks' bounds, then a code a
// thread.
__global__ void __launch_bounds__(kGridThreads)
inst_codes_kernel(const float* __restrict__ bmin,
                       const float* __restrict__ bmax, int n,
                       const double* __restrict__ partial, int blocks,
                       int* __restrict__ codes) {
    __shared__ double red[6 * (kGridThreads / 32)];
    __shared__ double bounds[6];
    double lo[3] = {INFINITY, INFINITY, INFINITY};
    double hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int b = threadIdx.x; b < blocks; b += kGridThreads)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            lo[k] = fmin(lo[k], partial[6 * b + k]);
            hi[k] = fmax(hi[k], partial[6 * b + 3 + k]);
        }
    block_bounds(lo, hi, red, bounds);
    const int i = blockIdx.x * kGridThreads + threadIdx.x;
    if (i < n) {
        double c[3];
        centre(bmin, bmax, i, c);
        codes[i] = static_cast<int>(morton_code(c, bounds));
    }
}

// instances_level: a thread a row of one level (``order``: the instances
// in Morton order, for the leaves).
__global__ void __launch_bounds__(kGridThreads)
inst_level_kernel(const float* bmin, const float* bmax, int n,
                       const int64_t* __restrict__ order, float* tlas,
                       const __grid_constant__ Levels lv, int level) {
    const int t = blockIdx.x * kGridThreads + threadIdx.x;
    if (t >= lv.count[level] * kWidth) return;
    if (level == 0)
        leaf_row(tlas, lv, t, t < n ? static_cast<int>(order[t]) : -1, bmin,
                 bmax);
    else
        inner_row(tlas, lv, level, t);
}

int make_levels(int n_levels, const int* counts, const int* offs,
                Levels* lv) {
    if (n_levels < 1 || n_levels > kMaxLevels || counts == nullptr ||
        offs == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    lv->n = n_levels;
    for (int k = 0; k < n_levels; ++k) {
        lv->count[k] = counts[k];
        lv->off[k] = offs[k];
    }
    return 0;
}

Inputs make_inputs(const float* pos, const float* rot, const float* scale,
                   const float* llo, const float* lhi, int n, float* mats,
                   float* bmin, float* bmax) {
    Inputs a;
    a.pos = pos;
    a.rot = rot;
    a.scale = scale;
    a.llo = llo;
    a.lhi = lhi;
    a.mats = mats;
    a.bmin = bmin;
    a.bmax = bmax;
    a.n = n;
    return a;
}

}  // namespace

extern "C" {

int ptrt_instances_update_max() { return kOneBlockMax; }

// instances_update: one launch of one block for 1..kOneBlockMax instances.
// ``counts`` / ``offs`` (host arrays of n_levels): tlas.level_layout(n).
int ptrt_instances_update(const float* pos, const float* rot,
                          const float* scale, const float* llo,
                          const float* lhi, int n, float* mats, float* bmin,
                          float* bmax, float* tlas, int n_levels,
                          const int* counts, const int* offs, void* stream) {
    if (n < 1 || n > kOneBlockMax)
        return static_cast<int>(cudaErrorInvalidValue);
    Levels lv;
    const int e = make_levels(n_levels, counts, offs, &lv);
    if (e != 0) return e;
    inst_update_kernel<<<1, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        make_inputs(pos, rot, scale, llo, lhi, n, mats, bmin, bmax), tlas,
        lv);
    return static_cast<int>(cudaGetLastError());
}

// The grid path's first two launches: the rows, boxes and bounds
// (``partial``: 6 doubles a block of kGridThreads instances), then the
// codes (n,) int32.
int ptrt_instances_codes(const float* pos, const float* rot,
                         const float* scale, const float* llo,
                         const float* lhi, int n, float* mats, float* bmin,
                         float* bmax, double* partial, int* codes,
                         void* stream) {
    if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int blocks = (n + kGridThreads - 1) / kGridThreads;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    inst_rows_kernel<<<blocks, kGridThreads, 0, s>>>(
        make_inputs(pos, rot, scale, llo, lhi, n, mats, bmin, bmax),
        partial);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    inst_codes_kernel<<<blocks, kGridThreads, 0, s>>>(
        bmin, bmax, n, partial, blocks, codes);
    return static_cast<int>(cudaGetLastError());
}

// The grid path's tree: one launch a level, leaves first; ``order`` (n,)
// int64, the instances in Morton order (torch.sort's indices).
int ptrt_instances_levels(const float* bmin, const float* bmax, int n,
                          const int64_t* order, float* tlas, int n_levels,
                          const int* counts, const int* offs, void* stream) {
    if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
    Levels lv;
    const int e = make_levels(n_levels, counts, offs, &lv);
    if (e != 0) return e;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    for (int level = 0; level < n_levels; ++level) {
        const int rows = lv.count[level] * kWidth;
        inst_level_kernel<<<(rows + kGridThreads - 1) / kGridThreads,
                                 kGridThreads, 0, s>>>(bmin, bmax, n, order,
                                                       tlas, lv, level);
        const cudaError_t le = cudaGetLastError();
        if (le != cudaSuccess) return static_cast<int>(le);
    }
    return 0;
}

}  // extern "C"
