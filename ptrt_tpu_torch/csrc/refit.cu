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
//  * refit is an ordinary launch, eight threads a leaf block, no grid
//    barrier.  It starts with the slot phase: a thread a leaf slot gathers
//    its triangle (the plan's slot map, or order[rank] for the Morton
//    refill, so lbvh_slot_map's gather folds in here), writes its nine
//    fields of the triangle row and its v0 / e1 / e2 mirrors, and the eight
//    slots of a block reduce the block's box with shuffles.  The lane that
//    owns a block writes its box and adds one to its node's counter with an
//    acq_rel atomic (release: its box before the count; acquire: the boxes
//    of the arrivals counted before it); the group whose arrival completes
//    the node's used slots works the node, resets the counter and climbs to
//    the parent (Karras-style), the parent's plan entries asked for while
//    the node's boxes load.  A node is worked by eight threads, a thread a
//    slot, so its 48 box floats are written by neighbouring threads, its
//    slots' boxes (the block boxes or the children's node boxes) read side
//    by side, and its own box reduced with shuffles for its parent.  A
//    node's child base and leaf base come from its own row (offset in a
//    merged set), so it indexes the merged tables directly.  Up to 2^18
//    slots (a grid of 1,024 blocks) the climb stops below the top, the
//    levels of depth <= 2 (at most 73 nodes): each block fences its boxes
//    and counts itself done, and the last block to finish works the top
//    level by level in shared memory, where a level costs a
//    __syncthreads(), not a counter's round trip through L2; past that the
//    arrivals climb to the root, since on a larger grid the blocks that
//    wait to count themselves done measured slower.  The plan gives each
//    node's parent and each leaf block's node (cut at the top), each node's
//    used slots, and each top slot's source (a leaf block, a node below the
//    top or a top node); the counters are the plan's, zero between refits
//    (a plan is refitted on one stream at a time: the tables, scratch and
//    counters it writes are its own).  A node without a used slot (an empty
//    mesh's root) never gets an arrival: the plan lists such nodes below
//    the top, and a group of the first phase writes each and arrives at its
//    parent.  The first design, one cooperative launch with a grid sync a
//    level, had ~561 blocks sync six times for the heightfield while 8
//    threads worked the top levels.  Measured on an H100, queued, in turns
//    with it (PERF.md): 130,050 triangles ~0.014 ms against 0.020, 8,192
//    ~0.011 against 0.016, 1,001 ~0.0067 against 0.0093, over an empty
//    launch's ~0.002.  A single block of 1,024 threads walking the levels
//    with __syncthreads() between them lost to it at every size measured,
//    1,001 triangles (0.0088-0.0095 ms) to 1,045,506 (3.95 ms), one SM's
//    slot rounds outlasting the climb, so it is not kept.
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
// reference's) bit for bit, up to the sign of a zero bound, in any order
// of arrival; the codes are the plain version's arithmetic, and a stable
// sort has one answer.  Built with -fmad=false, like the plain torch
// version's separate roundings.  The boxes one block writes and another
// reads go through L2 (__ldcg, after an acquire or a fence): the read-only
// path is not coherent within a launch.

#include <cooperative_groups.h>
#include <cuda/atomic>
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
// refit's top: the levels of depth <= 2, at most 1 + 8 + 64
// nodes of an 8-wide tree
constexpr int kTopLevels = 3;
constexpr int kTopMax = 73;
constexpr int kTopRegs = (8 * kTopMax + 255) / 256;  // slots a thread
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
    // the tree seen from below (node ids local to the plan)
    const int* __restrict__ parent;    // (N,) -1 for the root
    const int* __restrict__ blk_node;  // (B,) a leaf block's node, -1 none
    const int* __restrict__ used;      // (N,) used slots a node
    const int* __restrict__ empty;     // (E,) nodes without a used slot
    int* counter;                      // (N,) arrivals, 0 between refits
    float* blk_box;                    // (B, 6) scratch: min xyz, max xyz
    float* node_box;                   // (N, 6) scratch
    float* root_lo;                    // (3,) the root's box, or null
    float* root_hi;
    // the top (the nodes of depth <= 2; none past the
    // plan's size limit), worked by the last block to finish: each top
    // node's id and, a slot, where its box is
    // (kind << 30 | index: 0 unused, 1 a leaf block, 2 a node below the
    // top, 3 a top node), deepest level first; the top levels' starts
    const int* __restrict__ top_ids;   // (n_top,)
    const int* __restrict__ top_src;   // (n_top, 8)
    int* done;                         // blocks finished, 0 between refits
    int top_starts[kTopLevels + 1];
    int n_top, n_top_levels;
    int n_tris, n_slots, n_empty, node_off, blk_off;
};

// The triangle of leaf slot s (-1 for a pad or a lane past the last
// slot): the plan's map, or order[rank] for the Morton refill.
__device__ __forceinline__ int slot_triangle(const RefitArgs& a, int s,
                                             bool live) {
    if (!live) return -1;
    if (a.slot_tri != nullptr) return a.slot_tri[s];
    const int rk = a.rank[s];
    return rk >= 0 ? a.order[rk] : -1;
}

// Triangle ``tri``'s vertices, x y z of v0, v1, v2 (zeros for a pad).
__device__ __forceinline__ void slot_vertices(const RefitArgs& a, int tri,
                                              float p[9]) {
    const bool pad = tri < 0 || tri >= a.n_tris;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        p[k] = pad ? 0.0f : a.v0[3 * tri + k];
        p[3 + k] = pad ? 0.0f : a.v1[3 * tri + k];
        p[6 + k] = pad ? 0.0f : a.v2[3 * tri + k];
    }
}

// Leaf slot s (``live``: s < n_slots) with its triangle's vertices: its
// nine fields of the triangle row and its mirrors written; ``lo`` / ``hi``
// the box of its block, reduced over the block's eight slots, which are
// eight neighbouring lanes of one warp (pads and lanes past the last slot
// at +-kBig).  Every lane of the warp calls it.
__device__ __forceinline__ void slot_write(const RefitArgs& a, int s,
                                           bool live, int tri,
                                           const float p[9], float lo[3],
                                           float hi[3]) {
    const bool pad = tri < 0 || tri >= a.n_tris;
    const int blk = s / kLeaf, j = s - blk * kLeaf;
    float* row = a.tri_rows + static_cast<size_t>(blk) * kTriRow;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        const float p0 = p[k], p1 = p[3 + k], p2 = p[6 + k];
        const float e1 = p1 - p0, e2 = p2 - p0;
        if (live) {
            row[(0 + k) * kLeaf + j] = p0;
            row[(3 + k) * kLeaf + j] = e1;
            row[(6 + k) * kLeaf + j] = e2;
            a.mirror[k][s] = p0;
            a.mirror[3 + k][s] = e1;
            a.mirror[6 + k][s] = e2;
        }
        lo[k] = pad ? kBig : fminf(fminf(p0, p1), p2);
        hi[k] = pad ? -kBig : fmaxf(fmaxf(p0, p1), p2);
    }
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
}

// A node's float-encoded ints (row columns 48-51: child base, leaf base,
// leaf mask, internal mask), decoded by value.  The kernels never write
// these columns, so the read-only path serves them.
struct NodeMeta {
    int cba, lb;
    uint32_t lmask, imask;
};

__device__ __forceinline__ NodeMeta node_meta(const RefitArgs& a, int x) {
    const float4 m = __ldg(reinterpret_cast<const float4*>(
        a.node_rows + static_cast<size_t>(a.node_off + x) * kNodeRow + 48));
    return NodeMeta{static_cast<int>(m.x), static_cast<int>(m.y),
                    static_cast<uint32_t>(static_cast<int>(m.z)),
                    static_cast<uint32_t>(static_cast<int>(m.w))};
}

// Slot s of node x (local; ``live``: this lane's group works a node; ``m``
// its metadata): the row's slot bounds written, (0, -1) where unused;
// ``lo`` / ``hi`` the node's box, the min / max over its eight slots with
// unused slots at +-kBig (so a node without children gets the inverted
// +-kBig box, as the reference), reduced over the node's eight
// neighbouring lanes; the slot boxes other blocks wrote read through L2.
// Every lane of the warp calls it.
__device__ __forceinline__ void refit_node(const RefitArgs& a, bool live,
                                           int x, const NodeMeta& m, int s,
                                           float lo[3], float hi[3]) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        lo[k] = kBig;
        hi[k] = -kBig;
    }
    if (live) {
        float* row = a.node_rows + static_cast<size_t>(a.node_off + x) *
                                       kNodeRow;
        const bool leaf = (m.lmask >> s) & 1u;
        const bool used = leaf || ((m.imask >> s) & 1u);
        if (used) {
            const float* box =
                leaf ? a.blk_box + 6 * (m.lb + s - a.blk_off)
                     : a.node_box + 6 * (m.cba + s - a.node_off);
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
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            lo[k] = fminf(lo[k], __shfl_xor_sync(0xffffffffu, lo[k], off, 8));
            hi[k] = fmaxf(hi[k], __shfl_xor_sync(0xffffffffu, hi[k], off, 8));
        }
    }
}

// Node x's box into the scratch, and into the root outputs for the root.
__device__ __forceinline__ void put_node_box(const RefitArgs& a, int x,
                                             const float lo[3],
                                             const float hi[3]) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        a.node_box[6 * x + k] = lo[k];
        a.node_box[6 * x + 3 + k] = hi[k];
    }
    if (x == 0 && a.root_lo != nullptr) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            a.root_lo[k] = lo[k];
            a.root_hi[k] = hi[k];
        }
    }
}

// What a group climbing to node x reads of the plan, asked for ahead of
// the node's arrival count so the loads overlap the atomic.
struct Climb {
    int x, used, parent;
    NodeMeta m;
};

__device__ __forceinline__ Climb climb_to(const RefitArgs& a, int x) {
    Climb c{x, 0, -1, NodeMeta{0, 0, 0u, 0u}};
    if (x >= 0) {
        c.used = __ldg(a.used + x);
        c.parent = __ldg(a.parent + x);
        c.m = node_meta(a, x);
    }
    return c;
}

// refit's last phase (a plan with a top): every block counts itself done
// (the lanes that wrote boxes, a group's first, fence them first); the last block to finish works the top levels in shared memory,
// a __syncthreads() between them, and resets the block count.  Every block
// asks for the top's plan entries before its count, so the last block has
// them when it learns it is last.
__device__ __forceinline__ void finish_top(const RefitArgs& a) {
    static_assert(kThreads >= kTopMax, "a thread a top node's id");
    __shared__ int src_s[8 * kTopMax];
    __shared__ int ids_s[kTopMax];
    __shared__ float box_s[6 * kTopMax];
    __shared__ int last_s;
    int src_r[kTopRegs];
#pragma unroll
    for (int k = 0; k < kTopRegs; ++k) {
        const int q = k * kThreads + threadIdx.x;
        src_r[k] = q < 8 * a.n_top ? __ldg(a.top_src + q) : 0;
    }
    const int id_r =
        threadIdx.x < a.n_top ? __ldg(a.top_ids + threadIdx.x) : 0;
    // a group's first lane wrote its boxes: them before the block's count
    if (threadIdx.x % kLeaf == 0) __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
        last_s = atomicAdd(a.done, 1) == static_cast<int>(gridDim.x) - 1;
    __syncthreads();
    if (!last_s) return;
    __threadfence();  // the other blocks' boxes, after their counts
    if (threadIdx.x == 0) a.done[0] = 0;  // every block counted
#pragma unroll
    for (int k = 0; k < kTopRegs; ++k) {
        const int q = k * kThreads + threadIdx.x;
        if (q < 8 * a.n_top) src_s[q] = src_r[k];
    }
    if (threadIdx.x < a.n_top) ids_s[threadIdx.x] = id_r;
    __syncthreads();
    for (int l = 0; l < a.n_top_levels; ++l) {
        const int begin = a.top_starts[l];
        const int span = (a.top_starts[l + 1] - begin) * 8;
        for (int q0 = 0; q0 < span; q0 += kThreads) {
            const int q = q0 + threadIdx.x;
            const bool live = q < span;
            const int j = begin + q / 8, s = q % 8;
            float lo[3] = {kBig, kBig, kBig}, hi[3] = {-kBig, -kBig, -kBig};
            if (live) {
                const uint32_t src = static_cast<uint32_t>(src_s[8 * j + s]);
                const uint32_t kind = src >> 30;
                const int at = static_cast<int>(src & 0x3fffffffu);
                if (kind == 3u) {
#pragma unroll
                    for (int k = 0; k < 3; ++k) {
                        lo[k] = box_s[6 * at + k];
                        hi[k] = box_s[6 * at + 3 + k];
                    }
                } else if (kind != 0u) {
                    const float* box =
                        (kind == 1u ? a.blk_box : a.node_box) + 6 * at;
#pragma unroll
                    for (int k = 0; k < 3; ++k) {
                        lo[k] = __ldcg(box + k);
                        hi[k] = __ldcg(box + 3 + k);
                    }
                }
                float* row = a.node_rows +
                             static_cast<size_t>(a.node_off + ids_s[j]) *
                                 kNodeRow;
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    row[k * 8 + s] = kind != 0u ? lo[k] : 0.0f;
                    row[24 + k * 8 + s] = kind != 0u ? hi[k] : -1.0f;
                }
            }
#pragma unroll
            for (int off = 1; off < 8; off <<= 1) {
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    lo[k] = fminf(lo[k],
                                  __shfl_xor_sync(0xffffffffu, lo[k], off, 8));
                    hi[k] = fmaxf(hi[k],
                                  __shfl_xor_sync(0xffffffffu, hi[k], off, 8));
                }
            }
            if (live && s == 0) {
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    box_s[6 * j + k] = lo[k];
                    box_s[6 * j + 3 + k] = hi[k];
                }
                if (ids_s[j] == 0 && a.root_lo != nullptr) {
#pragma unroll
                    for (int k = 0; k < 3; ++k) {
                        a.root_lo[k] = lo[k];
                        a.root_hi[k] = hi[k];
                    }
                }
            }
        }
        __syncthreads();  // the next level reads this one's boxes
    }
}

// refit: a group of eight lanes a leaf block (then a node without a used
// slot), a lane a slot.  The group's leader writes the box and counts its
// arrival at the node with an acq_rel atomic: the release puts its box in
// L2 before any group can see the count, the acquire of the count that
// completes the node orders the boxes of the arrivals before it ahead of
// that group's reads, passed on to its other lanes by __syncwarp(); the
// group works the node, resets its counter and climbs (the parent's plan
// entries asked for while the node's slot boxes load).  The loop runs
// while any group of the warp climbs, so every lane takes part in the
// shuffles and the barrier.  Eight blocks a SM keep it at 32 registers
// (unbounded, 40 and six blocks: 0.084 against 0.081 ms at 1,045,506
// triangles on an H100).
__global__ void __launch_bounds__(kThreads, 8)
refit_kernel(const __grid_constant__ RefitArgs a) {
    const int q = blockIdx.x * kThreads + threadIdx.x;
    const int item = q / kLeaf, s = q % kLeaf;
    const int blocks = a.n_slots / kLeaf;
    const bool live = q < a.n_slots;
    float p[9], lo[3], hi[3];
    const int tri = slot_triangle(a, q, live);
    slot_vertices(a, tri, p);
    slot_write(a, q, live, tri, p, lo, hi);
    int x = -1;  // the node this group arrives at
    if (item < blocks) {
        if (s == 0) {
#pragma unroll
            for (int k = 0; k < 3; ++k) {
                a.blk_box[6 * item + k] = lo[k];
                a.blk_box[6 * item + 3 + k] = hi[k];
            }
        }
        x = __ldg(a.blk_node + item);
    } else if (item < blocks + a.n_empty) {
        // a node without a used slot: (0, -1) slots, the +-kBig box (lo /
        // hi hold it: this group's lanes hold no slot)
        const int e = __ldg(a.empty + item - blocks);
        float* row = a.node_rows + static_cast<size_t>(a.node_off + e) *
                                       kNodeRow;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            row[k * 8 + s] = 0.0f;
            row[24 + k * 8 + s] = -1.0f;
        }
        if (s == 0) put_node_box(a, e, lo, hi);
        x = __ldg(a.parent + e);
    }
    Climb c = climb_to(a, x);
    bool climbing = x >= 0;
    while (__any_sync(0xffffffffu, climbing)) {
        int last = 0;
        if (climbing && s == 0) {
            cuda::atomic_ref<int, cuda::thread_scope_device> count(
                a.counter[c.x]);
            last = count.fetch_add(1, cuda::memory_order_acq_rel) ==
                   c.used - 1;
        }
        climbing = __shfl_sync(0xffffffffu, last, 0, kLeaf) != 0;
        __syncwarp();  // the leader's acquire, before its group's reads
        const Climb up = climb_to(a, climbing ? c.parent : -1);
        refit_node(a, climbing, c.x, c.m, s, lo, hi);
        if (climbing && s == 0) {
            a.counter[c.x] = 0;  // every arrival counted: the next refit's
            put_node_box(a, c.x, lo, hi);
        }
        c = up;
        climbing = c.x >= 0;
    }
    if (a.n_top > 0) finish_top(a);
}

// An empty kernel: the floor of a launch, timed beside the small kernels'
// bounds (measurement only).
__global__ void empty_kernel() {}

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

// refit.  Exactly one of ``slot_tri`` and (``rank``, ``order``) is given.
// ``tri_rows`` and the nine mirror planes point at the plan's offsets;
// ``node_rows`` is the whole table, the plan's ``n_nodes`` nodes at
// ``node_off``; ``scratch`` holds (n_slots / 8 + n_nodes) x 6 floats;
// ``root_lo`` / ``root_hi`` (3,) each or null.  ``parent`` and
// ``blk_node`` are cut at the top (-1 where the parent is a top node);
// ``used`` each node's used slots; ``empty`` the ``n_empty`` nodes below
// the top without one; ``counter`` each node's arrivals and ``done`` the
// blocks finished (zero on entry and on return); ``top_ids`` the ``n_top``
// top nodes with their slots' sources ``top_src`` and the
// ``n_top_levels`` + 1 host ints ``top_starts``.
int ptrt_refit(const float* v0, const float* v1, const float* v2, int n_tris,
               const int* slot_tri, const int* rank, const int* order,
               int n_slots, float* tri_rows, float* v0x, float* v0y,
               float* v0z, float* e1x, float* e1y, float* e1z, float* e2x,
               float* e2y, float* e2z, float* node_rows, int node_off,
               int blk_off, int n_nodes, const int* parent,
               const int* blk_node, const int* used, const int* empty,
               int n_empty, int* counter, const int* top_ids,
               const int* top_src, int n_top, const int* top_starts,
               int n_top_levels, int* done, float* scratch, float* root_lo,
               float* root_hi, void* stream) {
    if ((slot_tri == nullptr) == (rank == nullptr || order == nullptr) ||
        n_slots < 0 || n_slots % kLeaf != 0 || n_nodes < 1 || n_empty < 0 ||
        (root_lo == nullptr) != (root_hi == nullptr) || n_top < 0 ||
        n_top > kTopMax || n_top_levels < 0 || n_top_levels > kTopLevels)
        return static_cast<int>(cudaErrorInvalidValue);
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
    a.parent = parent;
    a.blk_node = blk_node;
    a.used = used;
    a.empty = empty;
    a.counter = counter;
    a.top_ids = top_ids;
    a.top_src = top_src;
    a.done = done;
    for (int l = 0; l <= n_top_levels; ++l) a.top_starts[l] = top_starts[l];
    a.n_top = n_top;
    a.n_top_levels = n_top_levels;
    a.blk_box = scratch;
    a.node_box = scratch + 6 * static_cast<size_t>(n_slots / kLeaf);
    a.root_lo = root_lo;
    a.root_hi = root_hi;
    a.n_tris = n_tris;
    a.n_slots = n_slots;
    a.n_empty = n_empty;
    a.node_off = node_off;
    a.blk_off = blk_off;
    const long long items = n_slots / kLeaf + static_cast<long long>(n_empty);
    if (items > 0) {
        const long long grid = (kLeaf * items + kThreads - 1) / kThreads;
        refit_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
    }
    return static_cast<int>(cudaGetLastError());
}

// refit's registers, local-memory bytes a thread, threads a block, resident
// blocks a SM and (static) shared bytes a block.
int ptrt_refit_info(int* regs, int* local_bytes, int* threads, int* per_sm,
                    int* shared_bytes) {
    const void* kernel = reinterpret_cast<const void*>(refit_kernel);
    cudaFuncAttributes attr = {};
    cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                          kThreads, 0);
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    *threads = kThreads;
    *shared_bytes = static_cast<int>(attr.sharedSizeBytes);
    return static_cast<int>(e);
}

// One launch of an empty kernel (the floor a small kernel's time stands
// on; measurement only).
int ptrt_empty_launch(void* stream) {
    empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
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
