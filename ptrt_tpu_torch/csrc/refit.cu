// K5: the device refit of a dynamic mesh's BVH (refit) and the Morton codes
// of its Morton-sorted refill (morton).
//
// Replaces: ptrt_tpu/geometry/refit.py refit_apply (:110) and the codes and
// centroid bounds of ptrt_tpu/geometry/lbvh.py morton_order (:41-71,
// morton_codes), which XLA compiles into gathers, a scatter and one fusion
// per tree level.  The sort between the two stays torch.sort, as the
// reference leaves it to jax.lax.sort.
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
//  * morton is one block of 1024 threads: the centroids' bounds by a block
//    reduction, then the codes.  A mesh of a few thousand triangles (the
//    LBVH meshes of the games) is one launch's latency.
//
// Exactness: min and max are exact in any order and the triangle rows are
// copies and differences, so the tables equal the plain version's (and the
// reference's) bit for bit, up to the sign of a zero bound.  Built with
// -fmad=false, like the plain torch version's separate roundings.  The
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
constexpr int kMortonThreads = 1024;
constexpr int kMaxDevices = 64;
constexpr int kMBits = 10;           // lbvh.MBITS

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

__device__ __forceinline__ float centroid(const float* v0, const float* v1,
                                          const float* v2, int t, int k) {
    const float a = v0[3 * t + k], b = v1[3 * t + k], c = v2[3 * t + k];
    return (fminf(fminf(a, b), c) + fmaxf(fmaxf(a, b), c)) * 0.5f;
}

__global__ void __launch_bounds__(kMortonThreads)
morton_kernel(const float* __restrict__ v0, const float* __restrict__ v1,
              const float* __restrict__ v2, int n, int* __restrict__ codes) {
    __shared__ float red[2][3][kMortonThreads / 32];
    __shared__ float bounds[2][3];
    float lo[3] = {INFINITY, INFINITY, INFINITY};
    float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int t = threadIdx.x; t < n; t += kMortonThreads) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const float c = centroid(v0, v1, v2, t, k);
            lo[k] = fminf(lo[k], c);
            hi[k] = fmaxf(hi[k], c);
        }
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        for (int off = 16; off > 0; off >>= 1) {
            lo[k] = fminf(lo[k], __shfl_xor_sync(0xffffffffu, lo[k], off));
            hi[k] = fmaxf(hi[k], __shfl_xor_sync(0xffffffffu, hi[k], off));
        }
        if (lane == 0) {
            red[0][k][warp] = lo[k];
            red[1][k][warp] = hi[k];
        }
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            float l = red[0][k][lane], h = red[1][k][lane];
            for (int off = 16; off > 0; off >>= 1) {
                l = fminf(l, __shfl_xor_sync(0xffffffffu, l, off));
                h = fmaxf(h, __shfl_xor_sync(0xffffffffu, h, off));
            }
            if (lane == 0) {
                bounds[0][k] = l;
                bounds[1][k] = h;
            }
        }
    }
    __syncthreads();
    const int m = (1 << kMBits) - 1;
    float base[3], span[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        base[k] = bounds[0][k];
        span[k] = fmaxf(bounds[1][k] - bounds[0][k], 1e-12f);
    }
    for (int t = threadIdx.x; t < n; t += kMortonThreads) {
        int q[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const float f = (centroid(v0, v1, v2, t, k) - base[k]) / span[k];
            const int v = static_cast<int>(f * static_cast<float>(m));
            q[k] = v < 0 ? 0 : (v > m ? m : v);
        }
        int code = 0;
#pragma unroll
        for (int b = 0; b < kMBits; ++b)
            code |= (((q[0] >> b) & 1) << (3 * b)) |
                    (((q[1] >> b) & 1) << (3 * b + 1)) |
                    (((q[2] >> b) & 1) << (3 * b + 2));
        codes[t] = code;
    }
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

// morton: (n,) int32 codes of the triangles' centroids in their bounds.
int ptrt_morton(const float* v0, const float* v1, const float* v2, int n,
                int* codes, void* stream) {
    if (n <= 0) return static_cast<int>(cudaGetLastError());
    morton_kernel<<<1, kMortonThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(v0, v1, v2, n,
                                                         codes);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
