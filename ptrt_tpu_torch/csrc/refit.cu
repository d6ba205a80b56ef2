// K5: the device refit of a dynamic mesh's BVH (refit) and the Morton order
// of its Morton-sorted refill (morton_sort, morton_codes).
//
// Replaces: ptrt_tpu/geometry/refit.py refit_apply (:110) and
// ptrt_tpu/geometry/lbvh.py morton_order (:59, with morton_codes :41: the
// centroids, their bounds, the 30-bit codes and jax.lax.sort's stable
// order), which XLA compiles into gathers, a scatter, a sort and one fusion
// per tree level.
//
// What bounds them on the card: a few MB of traffic (a 130,050-triangle
// heightfield reads 4.7 MB of vertices and writes ~10 MB of tables) and,
// for the tree, its depth: a parent's boxes need its children's, so the
// levels run one after another.  No tiles, no products: the levers are
// launches and the latency between levels.
//
// What this design does about it:
//  * refit is one cooperative launch (`cudaLaunchCooperativeKernel`; the
//    grid is what the card holds at once, at most what the work needs),
//    its phases separated by grid syncs.  The slot phase: a thread a leaf
//    slot gathers its triangle (the plan's slot map, or order[rank] for the
//    Morton refill, so lbvh_slot_map's gather folds in here), writes its
//    nine fields of the triangle row and its v0 / e1 / e2 mirrors, and the
//    eight slots of a block reduce the block's box with shuffles.  Then one
//    phase a tree level, deepest first: eight threads a node, a thread a
//    slot, so a node's 48 box floats are written by neighbouring threads,
//    its slots' boxes (the block boxes or the children's node boxes) read
//    side by side, and the node's own box reduced with shuffles for its
//    parent.  A node reads its child base and leaf base from its own row
//    (offset in a merged set), so it indexes the merged tables directly;
//    the plan lists each level's nodes, so no parent indices or arrival
//    counters.  A first design ran the levels in one block of 1024
//    threads, a thread a node: 0.271 ms for the heightfield's 4,694 nodes
//    (the slot pass 0.025), one SM's load and store units serving every
//    node's scattered row (PERF.md);
//  * morton_sort, for a mesh of up to kSortMax triangles (the LBVH meshes of
//    the games, the dynamic scene's 8,192-triangle sphere), is the whole
//    order in one launch of one block: each float of the (T, 3) vertex
//    planes read once, coalesced, into a centroid component in shared
//    memory; the bounds by a block reduction; the codes; then a stable LSD
//    radix sort of (code, triangle) pairs held in registers, 8 bits a pass
//    (4 passes over 30 bits), each pass counting a digit a warp, scanning
//    the counts block-wide, ranking a digit's lanes by ballots of its bits
//    and exchanging
//    through shared memory.  It writes the order as int32 (and, when asked,
//    the codes): no torch.sort, index fill or cast after it.  The first
//    design ran the codes in one block that read each vertex twice at a
//    stride of 3 floats, then torch.sort's launches;
//  * morton_codes, for a larger mesh (a refilled heightfield or deforming
//    mesh of 130k or 1M triangles), is one cooperative launch over the card:
//    each block bounds its share of the centroids, a grid sync, every block
//    reduces the blocks' bounds, then the codes tile by tile.  The order
//    then comes from torch.sort (stable), as the reference leaves the sort
//    to jax.lax.sort outside any kernel.  Which of the two a refill takes
//    is a choice by the mesh's size before the launch (geometry/lbvh.py
//    morton_order against ptrt_morton_sort_max).  On an H100 the one
//    launch is the faster up to its most: 0.017 against 0.038 ms at 1,001
//    triangles, 0.040 against 0.063 at 8,192, level at 16,384 (PERF.md).
//
// Exactness: min and max are exact in any order and the triangle rows are
// copies and differences, so the tables equal the plain version's (and the
// reference's) bit for bit, up to the sign of a zero bound; the codes are
// the plain version's arithmetic, and a stable sort has one answer.  Built
// with -fmad=false, like the plain torch version's separate roundings.  The
// boxes one phase writes and the next reads go through L2 (__ldcg): the
// read-only path is not coherent within a launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLeaf = 8;             // LEAF_SIZE (geometry/bvh.py)
constexpr int kTriRow = 10 * kLeaf;  // tri_rows width
constexpr int kNodeRow = 64;         // node_rows width
constexpr float kBig = 3.0e30f;      // refit.BIG
constexpr int kThreads = 256;        // refit's block
constexpr int kMaxDevices = 64;
constexpr int kMBits = 10;           // lbvh.MBITS
constexpr int kSortThreads = 1024;   // morton_sort's one block
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kSortItems = 16;       // items a thread holds at most
constexpr int kSortMax = kSortThreads * kSortItems;  // 16,384 triangles
constexpr int kRadixBits = 8;        // a pass's digit
constexpr int kRadix = 1 << kRadixBits;
constexpr int kSortCounters = kRadix * kSortWarps;  // a digit a warp
constexpr int kCodeThreads = 1024;   // morton_codes' block

struct RefitArgs {
    const float* __restrict__ v0;  // (T, 3) each
    const float* __restrict__ v1;
    const float* __restrict__ v2;
    const int* __restrict__ slot_tri;  // (M,) or null
    const int* __restrict__ rank;      // (M,) or null (with order)
    const int* __restrict__ order;     // (T,) or null
    float* tri_rows;                   // at the plan's block offset
    float* mirror[9];                  // v0 e1 e2 x y z, at the slot offset
    float* node_rows;                  // the whole table (rows node_off..)
    const int* __restrict__ level_nodes;   // every node, deepest first
    const int* __restrict__ level_starts;  // (n_levels + 1,)
    float* blk_box;                    // (B, 6) scratch: min xyz, max xyz
    float* node_box;                   // (N, 6) scratch
    int n_tris, n_slots, n_levels, node_off, blk_off;
};

// The slot phase: a thread a leaf slot, grid-stride.  Every lane of a warp
// takes part in each round (the shuffles); lanes past the last slot write
// nothing.  n_slots is a multiple of kLeaf, and so is the stride.
__device__ void refit_slots(const RefitArgs& a) {
    const int stride = gridDim.x * kThreads;
    const int rounds = (a.n_slots + stride - 1) / stride;
    for (int r = 0; r < rounds; ++r) {
        const int s = r * stride + blockIdx.x * kThreads + threadIdx.x;
        const bool live = s < a.n_slots;
        int tri = -1;
        if (live) {
            if (a.slot_tri != nullptr) {
                tri = a.slot_tri[s];
            } else {
                const int rk = a.rank[s];
                tri = rk >= 0 ? a.order[rk] : -1;
            }
        }
        const bool pad = tri < 0 || tri >= a.n_tris;
        float p0[3], p1[3], p2[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            p0[k] = pad ? 0.0f : a.v0[3 * tri + k];
            p1[k] = pad ? 0.0f : a.v1[3 * tri + k];
            p2[k] = pad ? 0.0f : a.v2[3 * tri + k];
        }
        const int blk = s / kLeaf, j = s - blk * kLeaf;
        float* row = a.tri_rows + static_cast<size_t>(blk) * kTriRow;
        float lo[3], hi[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const float e1 = p1[k] - p0[k], e2 = p2[k] - p0[k];
            if (live) {
                row[(0 + k) * kLeaf + j] = p0[k];
                row[(3 + k) * kLeaf + j] = e1;
                row[(6 + k) * kLeaf + j] = e2;
                a.mirror[k][s] = p0[k];
                a.mirror[3 + k][s] = e1;
                a.mirror[6 + k][s] = e2;
            }
            lo[k] = pad ? kBig : fminf(fminf(p0[k], p1[k]), p2[k]);
            hi[k] = pad ? -kBig : fmaxf(fmaxf(p0[k], p1[k]), p2[k]);
        }
        // a block's eight slots are eight neighbouring lanes of one warp
#pragma unroll
        for (int off = 1; off < kLeaf; off <<= 1) {
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                lo[k] = fminf(lo[k], __shfl_xor_sync(0xffffffffu, lo[k], off,
                                                     kLeaf));
                hi[k] = fmaxf(hi[k], __shfl_xor_sync(0xffffffffu, hi[k], off,
                                                     kLeaf));
            }
        }
        if (live && j == 0) {
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                a.blk_box[6 * blk + k] = lo[k];
                a.blk_box[6 * blk + 3 + k] = hi[k];
            }
        }
    }
}

// One level's nodes: eight threads a node, a thread a slot.  A node's box is
// the min / max over its eight slots, unused slots at +-kBig (so a node
// without children gets the inverted +-kBig box, as the reference); unused
// slots keep (0, -1).
__device__ void refit_level(const RefitArgs& a, int begin, int end) {
    const int stride = gridDim.x * kThreads;
    const int span = (end - begin) * 8;
    const int rounds = (span + stride - 1) / stride;
    for (int r = 0; r < rounds; ++r) {
        const int q = r * stride + blockIdx.x * kThreads + threadIdx.x;
        const bool live = q < span;
        const int s = q & 7;
        float lo[3] = {kBig, kBig, kBig}, hi[3] = {-kBig, -kBig, -kBig};
        float* row = nullptr;
        int x = 0;
        if (live) {
            x = a.level_nodes[begin + (q >> 3)];
            row = a.node_rows + static_cast<size_t>(a.node_off + x) * kNodeRow;
            // float-encoded ints, decoded by value
            const int cba = static_cast<int>(row[48]);
            const int lb = static_cast<int>(row[49]);
            const uint32_t lmask = static_cast<uint32_t>(
                static_cast<int>(row[50]));
            const uint32_t imask = static_cast<uint32_t>(
                static_cast<int>(row[51]));
            const bool leaf = (lmask >> s) & 1u;
            const bool used = leaf || ((imask >> s) & 1u);
            if (used) {
                const float* box =
                    leaf ? a.blk_box + 6 * (lb + s - a.blk_off)
                         : a.node_box + 6 * (cba + s - a.node_off);
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    lo[k] = __ldcg(box + k);
                    hi[k] = __ldcg(box + 3 + k);
                }
            }
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                row[k * 8 + s] = used ? lo[k] : 0.0f;
                row[24 + k * 8 + s] = used ? hi[k] : -1.0f;
            }
        }
        // the node's box: the eight lanes of a node are neighbours
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) {
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                lo[k] = fminf(lo[k], __shfl_xor_sync(0xffffffffu, lo[k], off,
                                                     8));
                hi[k] = fmaxf(hi[k], __shfl_xor_sync(0xffffffffu, hi[k], off,
                                                     8));
            }
        }
        if (live && s == 0) {
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                a.node_box[6 * x + k] = lo[k];
                a.node_box[6 * x + 3 + k] = hi[k];
            }
        }
    }
}

__global__ void __launch_bounds__(kThreads)
refit_kernel(const __grid_constant__ RefitArgs a) {
    cg::grid_group grid = cg::this_grid();
    refit_slots(a);
    for (int l = 0; l < a.n_levels; ++l) {
        grid.sync();  // this level reads the boxes of the one before
        refit_level(a, a.level_starts[l], a.level_starts[l + 1]);
    }
}

__device__ __forceinline__ float centroid(float a, float b, float c) {
    return (fminf(fminf(a, b), c) + fmaxf(fmaxf(a, b), c)) * 0.5f;
}

// Folds centroid component ``c`` of axis ``k`` into the running bounds.
__device__ __forceinline__ void grow(float lo[3], float hi[3], int k,
                                     float c) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        lo[a] = k == a ? fminf(lo[a], c) : lo[a];
        hi[a] = k == a ? fmaxf(hi[a], c) : hi[a];
    }
}

// The block's min of ``lo`` and max of ``hi`` into ``out`` (lo xyz, hi xyz),
// in shared memory and visible to every thread on return.  ``red`` is
// 6 x 32 floats of shared scratch.
__device__ void block_bounds(float lo[3], float hi[3], float* red,
                             float* out) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        for (int off = 16; off > 0; off >>= 1) {
            lo[k] = fminf(lo[k], __shfl_xor_sync(0xffffffffu, lo[k], off));
            hi[k] = fmaxf(hi[k], __shfl_xor_sync(0xffffffffu, hi[k], off));
        }
        if (lane == 0) {
            red[32 * k + warp] = lo[k];
            red[32 * (3 + k) + warp] = hi[k];
        }
    }
    __syncthreads();
    if (warp == 0) {
        const bool in = lane < static_cast<int>(blockDim.x >> 5);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            float l = in ? red[32 * k + lane] : INFINITY;
            float h = in ? red[32 * (3 + k) + lane] : -INFINITY;
            for (int off = 16; off > 0; off >>= 1) {
                l = fminf(l, __shfl_xor_sync(0xffffffffu, l, off));
                h = fmaxf(h, __shfl_xor_sync(0xffffffffu, h, off));
            }
            if (lane == 0) {
                out[k] = l;
                out[3 + k] = h;
            }
        }
    }
    __syncthreads();
}

// The 30-bit code of centroid ``c`` in the bounds ``b`` (lo xyz, hi xyz):
// lbvh.morton_codes_plain's arithmetic, each operation rounded on its own.
__device__ __forceinline__ unsigned morton_code(const float* c,
                                                const float* b) {
    const int m = (1 << kMBits) - 1;
    int q[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float span = fmaxf(b[3 + k] - b[k], 1e-12f);
        const float f = (c[k] - b[k]) / span;
        const int v = static_cast<int>(f * static_cast<float>(m));
        q[k] = v < 0 ? 0 : (v > m ? m : v);
    }
    unsigned code = 0u;
#pragma unroll
    for (int s = 0; s < kMBits; ++s)
        code |= (((q[0] >> s) & 1u) << (3 * s)) |
                (((q[1] >> s) & 1u) << (3 * s + 1)) |
                (((q[2] >> s) & 1u) << (3 * s + 2));
    return code;
}

// Digit d's counter for warp w: digit-major, warp-minor, the warp's index
// XORed with the digit's low bits, so that one warp's digits update
// counters in different banks (rows of 32 words would put every digit of a
// warp in one bank: 32-way conflicts, 1.6x the sort's time at 8,192).
__device__ __forceinline__ int counter(unsigned d, int w) {
    return static_cast<int>((d << 5) | ((static_cast<unsigned>(w) ^ d) & 31u));
}

// The lanes among ``live`` whose digit equals this lane's ``d``: one ballot
// a digit bit (a warp multi-split; __match_any_sync took longer the more
// distinct the digits).  Every lane of the warp calls it.
__device__ __forceinline__ unsigned digit_peers(unsigned live, unsigned d) {
    unsigned peers = live;
#pragma unroll
    for (int b = 0; b < kRadixBits; ++b) {
        const unsigned set = __ballot_sync(0xffffffffu, (d >> b) & 1u);
        peers &= ((d >> b) & 1u) ? set : ~set;
    }
    return peers;
}

// Exclusive prefix sums, in place and in (digit, warp) order, of the
// kRadix x kSortWarps digit counters: kSortCounters / kSortThreads
// consecutive counters a thread, then the threads' sums scanned across the
// block.
__device__ void scan_counters(unsigned* cnt, unsigned* warp_sum) {
    static_assert(kSortCounters == 8 * kSortThreads, "8 counters a thread");
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned d = threadIdx.x >> 2;  // 8 of a digit's 32 warps
    const int w0 = 8 * (threadIdx.x & 3);
    unsigned v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = cnt[counter(d, w0 + j)];
    unsigned sum = 0u;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const unsigned x = v[j];
        v[j] = sum;
        sum += x;
    }
    unsigned incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        const unsigned x = warp_sum[lane];
        unsigned s = x;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const unsigned y = __shfl_up_sync(0xffffffffu, s, off);
            if (lane >= off) s += y;
        }
        warp_sum[lane] = s - x;
    }
    __syncthreads();
    const unsigned base = warp_sum[warp] + incl - sum;
#pragma unroll
    for (int j = 0; j < 8; ++j) cnt[counter(d, w0 + j)] = v[j] + base;
}

// morton_sort: one block, the whole Morton refill's order.  Dynamic shared
// memory: the centroids (3n floats, the (n, 3) layout), whose space the
// sort then reuses for the digit counters (kSortCounters words) followed by
// the keys and the ids (n words each).
__global__ void __launch_bounds__(kSortThreads)
morton_sort_kernel(const float* __restrict__ v0, const float* __restrict__ v1,
                   const float* __restrict__ v2, int n,
                   int* __restrict__ order, int* __restrict__ codes) {
    static_assert(kSortThreads % 3 == 1, "a step advances the axis by one");
    static_assert(kSortWarps == 32, "one warp scans the warps' sums");
    extern __shared__ uint4 sort_smem[];
    __shared__ float red[6 * 32];
    __shared__ float bounds[6];
    __shared__ unsigned warp_sum[kSortWarps];
    float* const cent = reinterpret_cast<float*>(sort_smem);
    unsigned* const cnt = reinterpret_cast<unsigned*>(sort_smem);
    unsigned* const keys = cnt + kSortCounters;
    int* const ids = reinterpret_cast<int*>(keys + n);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    // the centroids, each float of the (n, 3) planes read once, coalesced,
    // and their bounds
    float lo[3] = {INFINITY, INFINITY, INFINITY};
    float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    int k = static_cast<int>(threadIdx.x % 3);
#pragma unroll 4
    for (int f = threadIdx.x; f < 3 * n; f += kSortThreads) {
        const float c = centroid(__ldg(v0 + f), __ldg(v1 + f), __ldg(v2 + f));
        cent[f] = c;
        grow(lo, hi, k, c);
        k = k == 2 ? 0 : k + 1;
    }
    block_bounds(lo, hi, red, bounds);

    // a thread's items, warp-striped: position first + 32 s, where each
    // warp holds a run of 32 * ipt positions; position p is triangle p
    const int ipt = (n + kSortThreads - 1) / kSortThreads;
    const int first = warp * 32 * ipt + lane;
    unsigned key[kSortItems];
    int id[kSortItems];
#pragma unroll
    for (int s = 0; s < kSortItems; ++s) {
        const int p = first + 32 * s;
        key[s] = 0u;
        id[s] = p;
        if (s < ipt && p < n) {
            key[s] = morton_code(cent + 3 * p, bounds);
            if (codes != nullptr) codes[p] = static_cast<int>(key[s]);
        }
    }
    __syncthreads();  // the centroids' space is the sort's from here

    // stable LSD radix sort of (key, id), kRadixBits a pass: count each
    // digit a warp (shared atomics), scan the counts digit-major, then every
    // item goes to its digit's offset in position order (a digit's lanes in
    // a step by digit_peers, the step's leader taking their offsets)
    for (int shift = 0; shift < 3 * kMBits; shift += kRadixBits) {
        for (int q = threadIdx.x; q < kSortCounters; q += kSortThreads)
            cnt[q] = 0u;
        __syncthreads();
#pragma unroll
        for (int s = 0; s < kSortItems; ++s) {
            const int p = first + 32 * s;
            if (s < ipt && p < n)
                atomicAdd(cnt + counter((key[s] >> shift) & (kRadix - 1),
                                        warp),
                          1u);
        }
        __syncthreads();
        scan_counters(cnt, warp_sum);
        __syncthreads();
#pragma unroll
        for (int s = 0; s < kSortItems; ++s) {
            if (s >= ipt) break;
            const int p = first + 32 * s;
            const unsigned d = (key[s] >> shift) & (kRadix - 1);
            const unsigned peers =
                digit_peers(__ballot_sync(0xffffffffu, p < n), d);
            const int leader = __ffs(peers) - 1;
            unsigned at = 0u;
            if (p < n && lane == leader)
                at = atomicAdd(cnt + counter(d, warp), __popc(peers));
            at = __shfl_sync(0xffffffffu, at, leader & 31) +
                 __popc(peers & ((1u << lane) - 1u));
            if (p < n) {
                keys[at] = key[s];
                ids[at] = id[s];
            }
            __syncwarp();
        }
        __syncthreads();
#pragma unroll
        for (int s = 0; s < kSortItems; ++s) {
            const int p = first + 32 * s;
            if (s < ipt && p < n) {
                key[s] = keys[p];
                id[s] = ids[p];
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int s = 0; s < kSortItems; ++s) {
        const int p = first + 32 * s;
        if (s < ipt && p < n) order[p] = id[s];
    }
}

struct MortonArgs {
    const float* __restrict__ v0;
    const float* __restrict__ v1;
    const float* __restrict__ v2;
    int* __restrict__ codes;
    float* partial;  // (gridDim.x, 6) scratch: each block's bounds
    int n;
};

// morton_codes: one cooperative launch over the whole card.  Each block
// bounds its share of the centroids, a grid sync, every block reduces the
// blocks' bounds, then the codes a tile of kCodeThreads triangles at a time
// (the tile's floats read coalesced into shared memory, a code a thread).
__global__ void __launch_bounds__(kCodeThreads)
morton_codes_kernel(const __grid_constant__ MortonArgs a) {
    __shared__ float red[6 * 32];
    __shared__ float bounds[6];
    __shared__ float tile[3 * kCodeThreads];
    cg::grid_group grid = cg::this_grid();
    const int stride = gridDim.x * kCodeThreads;
    float lo[3] = {INFINITY, INFINITY, INFINITY};
    float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int f = blockIdx.x * kCodeThreads + threadIdx.x; f < 3 * a.n;
         f += stride)
        grow(lo, hi, f % 3,
             centroid(__ldg(a.v0 + f), __ldg(a.v1 + f), __ldg(a.v2 + f)));
    block_bounds(lo, hi, red, bounds);
    if (threadIdx.x < 6) a.partial[6 * blockIdx.x + threadIdx.x] =
        bounds[threadIdx.x];
    grid.sync();
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        lo[k] = INFINITY;
        hi[k] = -INFINITY;
    }
    for (int b = threadIdx.x; b < gridDim.x; b += kCodeThreads) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            lo[k] = fminf(lo[k], __ldcg(a.partial + 6 * b + k));
            hi[k] = fmaxf(hi[k], __ldcg(a.partial + 6 * b + 3 + k));
        }
    }
    block_bounds(lo, hi, red, bounds);
    for (int t0 = blockIdx.x * kCodeThreads; t0 < a.n; t0 += stride) {
        for (int j = threadIdx.x; j < 3 * kCodeThreads; j += kCodeThreads) {
            const int f = 3 * t0 + j;
            if (f < 3 * a.n)
                tile[j] = centroid(__ldg(a.v0 + f), __ldg(a.v1 + f),
                                   __ldg(a.v2 + f));
        }
        __syncthreads();
        const int t = t0 + threadIdx.x;
        if (t < a.n)
            a.codes[t] =
                static_cast<int>(morton_code(tile + 3 * threadIdx.x, bounds));
        __syncthreads();
    }
}

size_t sort_shared_bytes(int n) {
    const size_t cent = 12 * static_cast<size_t>(n);
    const size_t sort =
        4 * (kSortCounters + 2 * static_cast<size_t>(n));
    return cent > sort ? cent : sort;
}

}  // namespace

extern "C" {

// refit: one cooperative launch.  Exactly one of ``slot_tri`` and
// (``rank``, ``order``) is given.  ``tri_rows`` and the nine mirror planes
// point at the plan's offsets; ``node_rows`` is the whole table, the plan's
// nodes at ``node_off``; ``scratch`` holds (n_slots / 8 + n_nodes) x 6
// floats.  ``max_level`` is the plan's largest level (nodes).
int ptrt_refit(const float* v0, const float* v1, const float* v2, int n_tris,
               const int* slot_tri, const int* rank, const int* order,
               int n_slots, float* tri_rows, float* v0x, float* v0y,
               float* v0z, float* e1x, float* e1y, float* e1z, float* e2x,
               float* e2y, float* e2z, float* node_rows, int node_off,
               int blk_off, const int* level_nodes, const int* level_starts,
               int n_levels, int max_level, float* scratch, void* stream) {
    if ((slot_tri == nullptr) == (rank == nullptr || order == nullptr) ||
        n_slots % kLeaf != 0 || n_levels < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_slots <= 0) return static_cast<int>(cudaGetLastError());
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
                &per_sm[dev], refit_kernel, kThreads, 0);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    RefitArgs a = {};
    a.v0 = v0;
    a.v1 = v1;
    a.v2 = v2;
    a.slot_tri = slot_tri;
    a.rank = rank;
    a.order = order;
    a.tri_rows = tri_rows;
    float* m[9] = {v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z};
    for (int k = 0; k < 9; ++k) a.mirror[k] = m[k];
    a.node_rows = node_rows;
    a.level_nodes = level_nodes;
    a.level_starts = level_starts;
    a.blk_box = scratch;
    a.node_box = scratch + 6 * static_cast<size_t>(n_slots / kLeaf);
    a.n_tris = n_tris;
    a.n_slots = n_slots;
    a.n_levels = n_levels;
    a.node_off = node_off;
    a.blk_off = blk_off;
    // the grid the card holds at once, at most what the largest phase needs
    const int work = n_slots > 8 * max_level ? n_slots : 8 * max_level;
    const int need = (work + kThreads - 1) / kThreads;
    const int most = sms[dev] * (per_sm[dev] > 0 ? per_sm[dev] : 1);
    const int grid = need < most ? need : most;
    void* params[] = {&a};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(refit_kernel), dim3(grid),
        dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream)));
}

// morton_sort: ``order`` (n,) int32, the triangles sorted by the Morton
// code of their centroids (ties by index), and, where ``codes`` is not
// null, the codes (n,) int32; at most kSortMax triangles.
int ptrt_morton_sort(const float* v0, const float* v1, const float* v2, int n,
                     int* order, int* codes, void* stream) {
    if (n > kSortMax || order == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n <= 0) return static_cast<int>(cudaGetLastError());
    static bool allowed[kMaxDevices];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess && (dev < 0 || dev >= kMaxDevices))
        e = cudaErrorInvalidDevice;
    if (e == cudaSuccess && !allowed[dev]) {
        e = cudaFuncSetAttribute(morton_sort_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(sort_shared_bytes(kSortMax)));
        allowed[dev] = e == cudaSuccess;
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    morton_sort_kernel<<<1, kSortThreads, sort_shared_bytes(n),
                         static_cast<cudaStream_t>(stream)>>>(v0, v1, v2, n,
                                                              order, codes);
    return static_cast<int>(cudaGetLastError());
}

int ptrt_morton_sort_max() { return kSortMax; }

// morton_codes: (n,) int32 codes of the triangles' centroids in their
// bounds, one cooperative launch of at most ``scratch_blocks`` blocks;
// ``scratch`` holds 6 floats a block.
int ptrt_morton_codes(const float* v0, const float* v1, const float* v2,
                      int n, int* codes, float* scratch, int scratch_blocks,
                      void* stream) {
    if (scratch_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (n <= 0) return static_cast<int>(cudaGetLastError());
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
                &per_sm[dev], morton_codes_kernel, kCodeThreads, 0);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    MortonArgs a = {v0, v1, v2, codes, scratch, n};
    // the grid the card holds at once, at most a tile a block
    const int need = (n + kCodeThreads - 1) / kCodeThreads;
    int grid = sms[dev] * (per_sm[dev] > 0 ? per_sm[dev] : 1);
    grid = need < grid ? need : grid;
    grid = scratch_blocks < grid ? scratch_blocks : grid;
    void* params[] = {&a};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(morton_codes_kernel), dim3(grid),
        dim3(kCodeThreads), params, 0, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
