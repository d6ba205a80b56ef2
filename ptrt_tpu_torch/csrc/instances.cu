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
// of dependent steps, and each block barrier on the chain costs more the
// more warps it waits for.  The first design (one block of 1,024 threads
// whatever the set, every bitonic stage a shared-memory pass and a
// barrier: ~40 barriers across 32 warps at 192 instances) took 0.0202 ms
// there on an H100 (PERF.md).
//
// What this design does about it (one launch of one block up to
// kOneBlockMax instances):
//  * the block is sized to the set: the next power of two >= n threads, at
//    least a warp, a thread an instance;
//  * each thread computes its instance's rows (rot_xyz with sinf / cosf, no
//    fast math), the eight corners' box and the box centre in float64; the
//    centres' bounds by warp shuffles, and across warps through shared
//    memory with one barrier;
//  * the 30-bit Morton codes in float64 exactly as tlas.morton_order
//    (non-finite and degenerate axes included), each (code, id) pair a
//    distinct 64-bit key in a register: thread t holds sorted position t,
//    so a bitonic stage of distance j exchanges by __shfl_xor_sync for
//    j < 32, and through shared memory (double-buffered: one barrier a
//    stage) only past that.  At 256 keys: 6 barriers over 8 warps instead
//    of 36 over 32.  Any correct sort of distinct keys gives the stable
//    order;
//  * the tree level by level, leaves first, straight from the sorted
//    registers; a barrier between levels (a __syncwarp for one warp).
//    On an H100 the three inner levels of 192 instances take ~0.005 ms
//    and the sort ~0.0034 (tools/k11_parts.py: the kernel with each part
//    cut out); keeping the boxes and levels in shared memory instead of
//    re-reading them through L2 saved only 0.0005, and was not kept
//    (PERF.md section 5).
//  Sets of up to 32 instances run in one warp with no block barrier.
//  Past kOneBlockMax (the same split as refit.cu's morton_sort /
//  morton_codes), the grid path: inst_rows_kernel over the card (the rows,
//  boxes and each block's centre bounds), inst_codes_kernel (every block
//  reduces the blocks' bounds, then a code a thread), torch.sort (stable)
//  in the wrapper, and one inst_level_kernel launch a tree level.  No host
//  read; its scratch is the caller's, allocated once.
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
constexpr int kMaxThreads = 1024;   // the one-block kernel's most
// the most instances the one-block kernel takes, a thread each.  One block
// is issue-bound on its one SM past a few hundred instances: on an H100 it
// takes 0.052 ms at 1,024 against the grid path's 0.065-0.067 at 1,025
// (chip_smoke.py phase 15), and variants holding 2, 4 and 8 keys a thread
// took 0.094, 0.18 and 0.36 ms at 2,048, 4,096 and 8,192 against the grid
// path's 0.067, 0.074 and 0.102 (PERF.md section 5): past a block's
// threads the grid path wins
constexpr int kOneBlockMax = kMaxThreads;
constexpr int kGridThreads = 256;   // the grid path's blocks
constexpr int kMaxLevels = 16;      // 4^15 leaves is past 2^24 instances
constexpr int kMaxWarps = kMaxThreads / 32;

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
__device__ __forceinline__ void instance_rows(const Inputs& a, int i,
                                              double c[3]) {
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

__device__ __forceinline__ void warp_bounds(double lo[3], double hi[3]) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            lo[k] = fmin(lo[k], __shfl_xor_sync(0xffffffffu, lo[k], off));
            hi[k] = fmax(hi[k], __shfl_xor_sync(0xffffffffu, hi[k], off));
        }
}

// The block's bounds of its threads' finite centres, left in every
// thread's lo / hi: warp shuffles, and for more than one warp the warps'
// bounds through ``red`` (6 doubles a warp) with one barrier.  Every
// thread of the block takes part.
__device__ __forceinline__ void block_bounds(double lo[3], double hi[3],
                                             double* red) {
    warp_bounds(lo, hi);
    const int warps = blockDim.x >> 5;
    if (warps == 1) return;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            red[6 * warp + k] = lo[k];
            red[6 * warp + 3 + k] = hi[k];
        }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        lo[k] = lane < warps ? red[6 * lane + k] : INFINITY;
        hi[k] = lane < warps ? red[6 * lane + 3 + k] : -INFINITY;
    }
    warp_bounds(lo, hi);
}

__device__ __forceinline__ unsigned spread10(unsigned v) {
    v &= 0x3FFu;
    v = (v | (v << 16)) & 0x030000FFu;
    v = (v | (v << 8)) & 0x0300F00Fu;
    v = (v | (v << 4)) & 0x030C30C3u;
    return (v | (v << 2)) & 0x09249249u;
}

// tlas.morton_order's code of one centre within the bounds, in float64
__device__ __forceinline__ unsigned morton_code(const double c[3],
                                                const double blo[3],
                                                const double bhi[3]) {
    unsigned q[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const double lo = blo[k], hi = bhi[k];
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
__device__ __forceinline__ void leaf_row(float* tlas, const Levels& lv,
                                         int t, int id, const float* bmin,
                                         const float* bmax) {
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
__device__ __forceinline__ void inner_row(float* tlas, const Levels& lv,
                                          int level, int t) {
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

// One bitonic compare-exchange: the key of sorted position p against its
// partner's y, for the merge of width k at distance j.
__device__ __forceinline__ unsigned long long exchange(unsigned long long x,
                                                       unsigned long long y,
                                                       int p, int j, int k) {
    const bool lower = (p & j) == 0, up = (p & k) == 0;
    return (lower == up) ? (x < y ? x : y) : (x < y ? y : x);
}

// Ascending bitonic sort of blockDim.x distinct keys, one a thread
// (thread t ends with sorted position t); ``buf``: 2 blockDim.x keys of
// shared memory, used only past one warp's reach.
__device__ __forceinline__ unsigned long long sort_keys(
    unsigned long long key, unsigned long long* buf) {
    const int size = blockDim.x, t = threadIdx.x;
    int parity = 0;
    for (int k = 2; k <= size; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            unsigned long long other;
            if (j >= 32) {
                // across warps: the partner thread t ^ j
                unsigned long long* b = buf + parity * size;
                b[t] = key;
                __syncthreads();
                other = b[t ^ j];
                parity ^= 1;
            } else {
                other = __shfl_xor_sync(0xffffffffu, key, j);
            }
            key = exchange(key, other, t, j, k);
        }
    }
    return key;
}

__device__ __forceinline__ void block_sync() {
    if (blockDim.x > 32)
        __syncthreads();
    else
        __syncwarp();
}

// The whole update of at most blockDim.x instances in one block of a
// power of two >= 32 threads, a thread an instance.
__global__ void __launch_bounds__(kMaxThreads, 1)
inst_update_kernel(const __grid_constant__ Inputs a, float* tlas,
                   const __grid_constant__ Levels lv) {
    extern __shared__ unsigned long long sort_buf[];
    __shared__ double red[6 * kMaxWarps];
    const int threads = blockDim.x, t = threadIdx.x;
    double lo[3] = {INFINITY, INFINITY, INFINITY};
    double hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    if (t < a.n) {
        double c[3];
        instance_rows(a, t, c);
        grow(lo, hi, c);
    }
    // (more than one warp: its barrier also publishes the boxes)
    block_bounds(lo, hi, red);
    unsigned long long key = ~0ull;
    if (t < a.n) {
        // the box this thread wrote itself
        double c[3];
        centre(a.bmin, a.bmax, t, c);
        key = (static_cast<unsigned long long>(morton_code(c, lo, hi))
               << 32) | static_cast<unsigned>(t);
    }
    key = sort_keys(key, sort_buf);
    if (threads == 32) __syncwarp();  // the other lanes' boxes
    // (a set's leaf rows, n rounded up to kWidth, fit its threads)
    if (t < lv.count[0] * kWidth)
        leaf_row(tlas, lv, t,
                 t < a.n ? static_cast<int>(key & 0xffffffffu) : -1, a.bmin,
                 a.bmax);
    for (int level = 1; level < lv.n; ++level) {
        block_sync();
        for (int u = t; u < lv.count[level] * kWidth; u += threads)
            inner_row(tlas, lv, level, u);
    }
}

// The grid path.  instances_rows: a thread an instance, each block's
// centre bounds into partial[6 * block].
__global__ void __launch_bounds__(kGridThreads)
inst_rows_kernel(const __grid_constant__ Inputs a, double* partial) {
    __shared__ double red[6 * (kGridThreads / 32)];
    double lo[3] = {INFINITY, INFINITY, INFINITY};
    double hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    const int i = blockIdx.x * kGridThreads + threadIdx.x;
    if (i < a.n) {
        double c[3];
        instance_rows(a, i, c);
        grow(lo, hi, c);
    }
    block_bounds(lo, hi, red);
    if (threadIdx.x == 0)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            partial[6 * blockIdx.x + k] = lo[k];
            partial[6 * blockIdx.x + 3 + k] = hi[k];
        }
}

// instances_codes: every block reduces the blocks' bounds, then a code a
// thread.
__global__ void __launch_bounds__(kGridThreads)
inst_codes_kernel(const float* __restrict__ bmin,
                       const float* __restrict__ bmax, int n,
                       const double* __restrict__ partial, int blocks,
                       int* __restrict__ codes) {
    __shared__ double red[6 * (kGridThreads / 32)];
    double lo[3] = {INFINITY, INFINITY, INFINITY};
    double hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int b = threadIdx.x; b < blocks; b += kGridThreads)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            lo[k] = fmin(lo[k], partial[6 * b + k]);
            hi[k] = fmax(hi[k], partial[6 * b + 3 + k]);
        }
    block_bounds(lo, hi, red);
    const int i = blockIdx.x * kGridThreads + threadIdx.x;
    if (i < n) {
        double c[3];
        centre(bmin, bmax, i, c);
        codes[i] = static_cast<int>(morton_code(c, lo, hi));
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

// the sort's buffers fit the 48 KB of shared memory a launch gets by default
static_assert(2 * sizeof(unsigned long long) * kOneBlockMax <= 48 * 1024,
              "no shared-memory attribute needed");

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
    int threads = 32;
    while (threads < n) threads <<= 1;
    // one warp reaches every key by shuffles: no shared sort buffer
    const size_t smem = threads > 32 ? 2 * sizeof(unsigned long long) *
                                           static_cast<size_t>(threads)
                                     : 0;
    inst_update_kernel<<<1, threads, smem,
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
