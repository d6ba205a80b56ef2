// K1 closest_hit and K2 any_hit: per-ray 8-wide BVH walks for Hopper.
//
// Replaces: ptrt_tpu/render/traverse.py:intersect_closest (K1) and
// traverse.py:intersect_any (K2) on a flat SceneGeometry — the XLA
// lock-step mask-stack walks (_walk_closest_raw / _any_state with
// _fetch_node8, _slab8, _descend, _fetch_leaf, _mt_test) and their
// compaction ladders, which exist to work around TPU gather costs.
//
// What bounds it on the card: dependent, data-driven loads.  Each visited
// node is one 256-byte row (52 used floats read as 13 float4 loads, and for
// K1 the ray octant's order word), each visited leaf one 320-byte triangle
// row; the next address depends on the slab test of the previous row, so a
// warp waits on load latency and diverges as its rays take different
// paths.  The 12.6 MB node table of the 1M-triangle bench scene fits the
// 50 MB L2; its triangle rows (~53 MB) do not.  No tiles: wgmma and TMA
// have no work.  The levers are the nodes a ray visits, the warps in flight
// to hide the latency, and how long a warp waits for its slowest ray.
//
// What this design does about it (each part kept because it measured
// faster at 2,073,600 rays on an H100; see PERF.md):
//  * near-first descent (K1): the ray's octant picks one of the row's eight
//    precomputed child orders (columns 52:60); the internal children's hit
//    mask is permuted into rank space and popped lowest rank first, so the
//    nearest subtree shrinks t before farther siblings are slab-tested
//    (the reference's _descend with ``octant``).  K2 keeps slot order: any
//    hit ends it, as in the reference's unordered any-hit walk;
//  * persistent warps: the grid fills the card once (SMs x resident
//    blocks), and each warp takes its next 32 rays with one atomicAdd on
//    the call's own counter (4 bytes the wrapper allocates for each call,
//    zeroed here on the stream before the launch, so launches on other
//    streams never share it), so a warp never waits for the other warps
//    of its block and no block is scheduled after the first wave.  Refilling single finished lanes at
//    once, or once fewer than 8, 16 or 24 lanes walk, measured slower: the
//    lanes of a warp then walk unrelated rays and stop sharing node rows;
//  * occupancy: __launch_bounds__ holds K1 to 7 and K2 to 9 resident
//    blocks a SM (7 and 9 warps a scheduler, no spills), each faster than
//    fewer blocks with more registers or more blocks with spills (K1 at 8
//    blocks spills 100 bytes a thread);
//  * each thread's stack of 8-byte entries (child base; order word << 8 |
//    mask), a node's remaining siblings in one entry.  It cannot overflow:
//    the wrapper refuses a tree whose depth bound exceeds kMaxStack, so no
//    push is ever dropped; a trap in the loop instead made the compiler
//    give up reconverging the warp each node (2.2-2.6x slower on an H100).
//    Its first entries in shared memory measured no faster than the
//    local-memory stack, which L1 holds; nor did leaf rows read as float4;
//  * leaves tested as soon as their box is hit (t shrinks early);
//  * a device count (the counted instantiations, the RT frame's glass
//    pass): ``n`` is the rays' capacity and a previous kernel wrote how
//    many of them are real (``count_scale * *count``, the glass pass's
//    2G rays or its lights' 2G shadow rays each).  Each warp reads the
//    count once, before its first fetch, and stops at the lesser, so a
//    frame captured into a CUDA graph sizes the pass on the card: no
//    read to the host, and a pass with none does nothing.  The host-count
//    instantiations are the same code with the limit n.
//
// Semantics match the reference bit for bit where the arithmetic allows:
// _safe_inv's signed 1e-12, slab test t_enter = max(0, ..) <= t_exit =
// min(t_bound, ..), Möller–Trumbore with _MT_EPS = 1e-9, inclusive
// barycentric epsilon 1e-6, T_MIN < t < t_max with t_max shrinking as hits
// come in, and table ints decoded by float->int VALUE conversion (never a
// bitcast).  Lanes with t_max <= 0 (or not alive) are dead and return a
// miss, with every output written.  The build uses no fast-math; nvcc's
// default FMA contraction can still move a grazing ray across an edge,
// which the callers' tolerances allow.  Which of two triangles at exactly
// the same t wins depends on the visit order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLeaf = 8;              // LEAF_SIZE (geometry/bvh.py)
constexpr int kTriRow = 10 * kLeaf;   // tri_rows width
constexpr int kNodeRow = 64;          // node_rows width
constexpr int kOrderCol = 52;         // first per-octant order column
constexpr int kMaxStack = 64;         // must be >= SceneGeometry.stack_depth
constexpr float kTMin = 1e-4f;        // traverse.T_MIN
constexpr float kTMax = 1e30f;        // traverse.T_MAX: a live lane's t_max
constexpr float kMtEps = 1e-9f;       // traverse._MT_EPS
constexpr float kBaryLo = -1e-6f;     // -beps
constexpr float kBaryHi = 1.000001f;  // 1 + beps
constexpr int kThreads = 128;
constexpr int kK1Blocks = 7;          // resident blocks a SM (launch bounds)
constexpr int kK2Blocks = 9;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kMaxDevices = 64;

struct Ray {
    float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// Everything a walk reads and writes.  K1 takes rays with either a t_max
// plane or an alive plane (exactly one is non-null) and writes t, u, v,
// slot, mesh; K2 takes t_max and writes one byte a ray.  ``next_ray`` is
// the work counter (zero at launch); ``counts`` (counting walks only)
// receives the nodes visited and triangles tested; ``count`` (counted
// walks only) holds the real rays' number over ``count_scale``.
struct WalkArgs {
    const float* __restrict__ nodes;
    const float* __restrict__ tris;
    const float* __restrict__ ox;
    const float* __restrict__ oy;
    const float* __restrict__ oz;
    const float* __restrict__ dx;
    const float* __restrict__ dy;
    const float* __restrict__ dz;
    const float* __restrict__ t_max;
    const uint8_t* __restrict__ alive;
    float* __restrict__ t_out;
    float* __restrict__ u_out;
    float* __restrict__ v_out;
    int* __restrict__ slot_out;
    int* __restrict__ mesh_out;
    uint8_t* __restrict__ hit_out;
    unsigned* next_ray;
    unsigned long long* counts;
    int n_nodes, n_blocks, n;
    const int* count;
    int count_scale;
};

__device__ __forceinline__ float safe_inv(float c) {
    const float s = c >= 0.0f ? 1.0f : -1.0f;
    return 1.0f / (c + s * 1e-12f);
}

// Möller–Trumbore against triangle j of a leaf row (field-major layout:
// v0x v0y v0z e1x e1y e1z e2x e2y e2z packed_id, kLeaf floats each).
__device__ __forceinline__ bool mt_test(const float* __restrict__ row, int j,
                                        const Ray& r, float t_max, float& t,
                                        float& u, float& v) {
    const float v0x = __ldg(row + 0 * kLeaf + j);
    const float v0y = __ldg(row + 1 * kLeaf + j);
    const float v0z = __ldg(row + 2 * kLeaf + j);
    const float e1x = __ldg(row + 3 * kLeaf + j);
    const float e1y = __ldg(row + 4 * kLeaf + j);
    const float e1z = __ldg(row + 5 * kLeaf + j);
    const float e2x = __ldg(row + 6 * kLeaf + j);
    const float e2y = __ldg(row + 7 * kLeaf + j);
    const float e2z = __ldg(row + 8 * kLeaf + j);
    const float hx = r.dy * e2z - r.dz * e2y;
    const float hy = r.dz * e2x - r.dx * e2z;
    const float hz = r.dx * e2y - r.dy * e2x;
    const float a = e1x * hx + e1y * hy + e1z * hz;
    const bool valid = fabsf(a) > kMtEps;
    const float f = 1.0f / (valid ? a : 1.0f);
    const float sx = r.ox - v0x, sy = r.oy - v0y, sz = r.oz - v0z;
    u = f * (sx * hx + sy * hy + sz * hz);
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
    t = f * (e2x * qx + e2y * qy + e2z * qz);
    return valid && u >= kBaryLo && u <= kBaryHi && v >= kBaryLo &&
           u + v <= kBaryHi && t > kTMin && t < t_max;
}

// Slab-test the eight child boxes of one node row against (0, t_bound];
// returns the hit bitmask (used slots only) and the row's metadata.
__device__ __forceinline__ uint32_t visit_node(const float4* __restrict__ row,
                                               const Ray& r, float t_bound,
                                               int& cba, int& lb,
                                               uint32_t& lmask,
                                               uint32_t& imask) {
    float4 q[13];
#pragma unroll
    for (int k = 0; k < 13; ++k) q[k] = __ldg(row + k);
    const float lo_x[8] = {q[0].x, q[0].y, q[0].z, q[0].w,
                           q[1].x, q[1].y, q[1].z, q[1].w};
    const float lo_y[8] = {q[2].x, q[2].y, q[2].z, q[2].w,
                           q[3].x, q[3].y, q[3].z, q[3].w};
    const float lo_z[8] = {q[4].x, q[4].y, q[4].z, q[4].w,
                           q[5].x, q[5].y, q[5].z, q[5].w};
    const float hi_x[8] = {q[6].x, q[6].y, q[6].z, q[6].w,
                           q[7].x, q[7].y, q[7].z, q[7].w};
    const float hi_y[8] = {q[8].x, q[8].y, q[8].z, q[8].w,
                           q[9].x, q[9].y, q[9].z, q[9].w};
    const float hi_z[8] = {q[10].x, q[10].y, q[10].z, q[10].w,
                           q[11].x, q[11].y, q[11].z, q[11].w};
    // metadata: exact small-float VALUES, decoded by value conversion
    cba = static_cast<int>(q[12].x);
    lb = static_cast<int>(q[12].y);
    lmask = static_cast<uint32_t>(static_cast<int>(q[12].z));
    imask = static_cast<uint32_t>(static_cast<int>(q[12].w));
    uint32_t hit = 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        float t0 = (lo_x[k] - r.ox) * r.ix, t1 = (hi_x[k] - r.ox) * r.ix;
        float te = fmaxf(0.0f, fminf(t0, t1));
        float tx = fminf(t_bound, fmaxf(t0, t1));
        t0 = (lo_y[k] - r.oy) * r.iy;
        t1 = (hi_y[k] - r.oy) * r.iy;
        te = fmaxf(te, fminf(t0, t1));
        tx = fminf(tx, fmaxf(t0, t1));
        t0 = (lo_z[k] - r.oz) * r.iz;
        t1 = (hi_z[k] - r.oz) * r.iz;
        te = fmaxf(te, fminf(t0, t1));
        tx = fminf(tx, fmaxf(t0, t1));
        hit |= (te <= tx ? 1u : 0u) << k;
    }
    return hit & (lmask | imask);
}

// Slot-space bitmask -> rank space under an order word: bit k of the
// result is bit ((ord >> 3k) & 7) of ``m``.
__device__ __forceinline__ uint32_t to_rank(uint32_t m, uint32_t ord) {
    uint32_t out = 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k)
        out |= ((m >> ((ord >> (3 * k)) & 7u)) & 1u) << k;
    return out;
}

// One ray's walk.  Closest (kAny = false): t shrinks to the nearest hit,
// best receives its tri slot (block * kLeaf + j).  Any (kAny = true):
// returns true on the first hit of an opaque triangle.  The current entry
// (base, mask, ord) holds the children ``base + slot`` still to visit; in
// near-first order ``mask`` is in rank space and ``ord`` the parent row's
// order word (rank k -> slot (ord >> 3k) & 7), in slot order ``ord`` is 0.
// ``tally`` (nodes, triangles) is null unless kCount.  The walk starts at
// node ``root`` (0 for a flat geometry; an instance's root in a merged set).
template <bool kAny, bool kOrdered, bool kCount>
__device__ bool walk(const float* __restrict__ nodes, int n_nodes,
                     const float* __restrict__ tris, int n_blocks,
                     const Ray& r, float& t, int& best, int& best_mesh,
                     float& best_u, float& best_v,
                     unsigned long long* tally, int root = 0) {
    uint2 stack[kMaxStack];
    const int oct = (r.dx < 0.0f ? 1 : 0) | (r.dy < 0.0f ? 2 : 0) |
                    (r.dz < 0.0f ? 4 : 0);
    int sp = 0;
    int base = root;  // the root is node root = base + slot 0
    uint32_t mask = 1u, ord = 0u;
    while (true) {
        if (mask == 0u) {
            if (sp == 0) break;
            const uint2 e = stack[--sp];
            base = static_cast<int>(e.x);
            mask = e.y & 0xffu;
            ord = e.y >> 8;
        }
        const int rank = __ffs(mask) - 1;
        mask &= mask - 1u;
        const int node =
            base + (kOrdered ? static_cast<int>((ord >> (3 * rank)) & 7u)
                             : rank);
        if (static_cast<unsigned>(node) >= static_cast<unsigned>(n_nodes))
            continue;
        const float* row = nodes + static_cast<size_t>(node) * kNodeRow;
        const uint32_t word =
            kOrdered ? static_cast<uint32_t>(
                           static_cast<int>(__ldg(row + kOrderCol + oct)))
                     : 0u;
        int cba, lb;
        uint32_t lmask, imask;
        const uint32_t hit =
            visit_node(reinterpret_cast<const float4*>(row), r, t, cba, lb,
                       lmask, imask);
        if (kCount) ++tally[0];
        uint32_t leaves = hit & lmask;
        while (leaves) {
            const int blk = lb + __ffs(leaves) - 1;
            leaves &= leaves - 1u;
            if (static_cast<unsigned>(blk) >= static_cast<unsigned>(n_blocks))
                continue;
            const float* tri = tris + static_cast<size_t>(blk) * kTriRow;
#pragma unroll
            for (int j = 0; j < kLeaf; ++j) {
                const int packed = static_cast<int>(__ldg(tri + 9 * kLeaf + j));
                const int mesh = packed >> 1;  // pad ids stay negative
                if (mesh < 0) continue;
                if (kAny && (packed & 1) == 0) continue;  // not an occluder
                if (kCount) ++tally[1];
                float tt, uu, vv;
                if (!mt_test(tri, j, r, t, tt, uu, vv)) continue;
                if (kAny) return true;
                t = tt;
                best = blk * kLeaf + j;
                best_mesh = mesh;
                best_u = uu;
                best_v = vv;
            }
        }
        const uint32_t ints = hit & imask;
        if (ints) {
            if (mask)  // sp < kMaxStack: the wrapper checks the tree depth
                stack[sp++] = make_uint2(static_cast<unsigned>(base),
                                         (ord << 8) | mask);
            base = cba;
            mask = kOrdered ? to_rank(ints, word) : ints;
            ord = word;
        }
    }
    return false;
}

// The persistent warps: each warp takes the next 32 ray indices with one
// atomicAdd, walks them one a lane, and writes every answer once, at its
// ray's own index, until the rays are gone.
// kCounted: the rays are the first count_scale * *count of the n.
template <bool kAny, bool kOrdered, bool kCount, bool kLive = false,
          bool kCounted = false>
__device__ __forceinline__ void walk_rays(const WalkArgs& a) {
    const int lane = threadIdx.x & 31;
    unsigned long long tally[2] = {0ull, 0ull};
    int limit = a.n;
    if (kCounted) {
        const long long m = static_cast<long long>(a.count_scale) *
                            max(__ldg(a.count), 0);
        limit = m < limit ? static_cast<int>(m) : limit;
    }
    while (true) {
        unsigned first = 0u;
        if (lane == 0) first = atomicAdd(a.next_ray, 32u);
        first = __shfl_sync(kAll, first, 0);
        if (first >= static_cast<unsigned>(limit)) break;
        const int i = static_cast<int>(first) + lane;
        if (i < limit) {
            float t = kLive ? (a.alive[i] ? kTMax : -1.0f) : a.t_max[i];
            int best = -1, best_mesh = -1;
            float bu = 0.0f, bv = 0.0f;
            bool hit = false;
            if (t > 0.0f) {
                Ray r;
                r.ox = a.ox[i];
                r.oy = a.oy[i];
                r.oz = a.oz[i];
                r.dx = a.dx[i];
                r.dy = a.dy[i];
                r.dz = a.dz[i];
                r.ix = safe_inv(r.dx);
                r.iy = safe_inv(r.dy);
                r.iz = safe_inv(r.dz);
                hit = walk<kAny, kOrdered, kCount>(
                    a.nodes, a.n_nodes, a.tris, a.n_blocks, r, t, best,
                    best_mesh, bu, bv, kCount ? tally : nullptr);
            }
            if (kAny) {
                a.hit_out[i] = hit ? 1 : 0;
            } else {
                a.t_out[i] = t;
                a.u_out[i] = bu;
                a.v_out[i] = bv;
                a.slot_out[i] = best;
                a.mesh_out[i] = best_mesh;
            }
        }
        __syncwarp();
    }
    if (kCount) {
        atomicAdd(a.counts, tally[0]);
        atomicAdd(a.counts + 1, tally[1]);
    }
}

// The main path's walks (K1 near-first, K2 in slot order), and the walks
// with a tally for measurement.
template <bool kLive>
__global__ void __launch_bounds__(kThreads, kK1Blocks)
closest_hit_kernel(WalkArgs a) {
    walk_rays<false, true, false, kLive>(a);
}

__global__ void __launch_bounds__(kThreads, kK2Blocks)
any_hit_kernel(WalkArgs a) {
    walk_rays<true, false, false>(a);
}

template <bool kAny, bool kOrdered>
__global__ void __launch_bounds__(kThreads, kAny ? kK2Blocks : kK1Blocks)
walk_counts_kernel(WalkArgs a) {
    walk_rays<kAny, kOrdered, true>(a);
}

// K1 and K2 on a device count (the RT frame's glass pass)
__global__ void __launch_bounds__(kThreads, kK1Blocks)
closest_hit_kernel_counted(WalkArgs a) {
    walk_rays<false, true, false, false, true>(a);
}

__global__ void __launch_bounds__(kThreads, kK2Blocks)
any_hit_kernel_counted(WalkArgs a) {
    walk_rays<true, false, false, false, true>(a);
}

using Kernel = void (*)(WalkArgs);
// K1 on a t_max plane, K2, the counting walks in the order of
// ptrt_walk_counts' ``walk``, K1 on an alive plane, then K1 and K2 on a
// device count
constexpr int kKernels = 8;
const Kernel kWalks[kKernels] = {closest_hit_kernel<false>, any_hit_kernel,
                                 walk_counts_kernel<false, true>,
                                 walk_counts_kernel<false, false>,
                                 walk_counts_kernel<true, false>,
                                 closest_hit_kernel<true>,
                                 closest_hit_kernel_counted,
                                 any_hit_kernel_counted};

// Blocks of walk ``k`` that one SM holds at once, per device, asked once.
cudaError_t blocks_per_sm(int k, int dev, int* per_sm) {
    static int cache[kKernels][kMaxDevices];
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (cache[k][dev] == 0) {
        int got = 0;
        const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &got, kWalks[k], kThreads, 0);
        if (e != cudaSuccess) return e;
        cache[k][dev] = got > 0 ? got : 1;
    }
    *per_sm = cache[k][dev];
    return cudaSuccess;
}

int launch(int k, const WalkArgs& a, void* stream) {
    if (a.n <= 0) return static_cast<int>(cudaGetLastError());
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = blocks_per_sm(k, dev, &per_sm);
    if (e == cudaSuccess)
        e = cudaMemsetAsync(a.next_ray, 0, sizeof(unsigned), st);
    if (e == cudaSuccess && a.counts != nullptr)
        e = cudaMemsetAsync(a.counts, 0, 2 * sizeof(unsigned long long), st);
    if (e != cudaSuccess) return static_cast<int>(e);
    // the grid fills the card once, or covers the rays if they are fewer
    const int need = (a.n + kThreads - 1) / kThreads;
    const int grid = sms * per_sm < need ? sms * per_sm : need;
    kWalks[k]<<<grid, kThreads, 0, st>>>(a);
    return static_cast<int>(cudaGetLastError());
}

WalkArgs walk_args(const float* nodes, int n_nodes, const float* tris,
                   int n_blocks, const float* ox, const float* oy,
                   const float* oz, const float* dx, const float* dy,
                   const float* dz, const float* t_max, int n,
                   unsigned* next_ray) {
    WalkArgs a = {};
    a.nodes = nodes;
    a.n_nodes = n_nodes;
    a.tris = tris;
    a.n_blocks = n_blocks;
    a.ox = ox;
    a.oy = oy;
    a.oz = oz;
    a.dx = dx;
    a.dy = dy;
    a.dz = dz;
    a.t_max = t_max;
    a.n = n;
    a.next_ray = next_ray;
    return a;
}

// -- K4: the instance walks ----------------------------------------------------
//
// Replaces: ptrt_tpu/render/traverse.py _instances_closest_batched (:986)
// and _instances_any_batched (:1041), with _inst_hit_words (:897),
// _words_lsb_iid (:937), _mat_affine / _mat_linear (:958-970) and
// _reconstruct_hit (:833): the dense slab test of every ray against every
// instance's world AABB into bitmask words, then rounds of (ray, instance)
// items, lowest instance id first, moved into the instance's frame and
// walked from the instance's root through the merged tables.
//
// What bounds them on the card: the same dependent loads as K1 and K2 for
// the rays that enter an instance's box, and the boxes a ray tests.  The
// reference's dense test (instances are tens, a broadcast beats a tree on a
// TPU) costs one thread a ray 6 shared loads and ~20 operations for every
// instance box: ~200 boxes a ray in the dynamic scene, most of them far
// from the ray, issue-bound at 22-37x the walk bound (PERF.md).
//
// What this design does: one thread a ray, the persistent warps of K1 (a
// counter of its own for each call).  A ray descends a small tree over the
// instance boxes (geometry/tlas.py: nodes of kTlasWidth children, each
// child a (lo, ref) and (hi, valid) float4 pair, built on the host with the
// boxes).  The tree finds exactly the flat test's
// instances: a leaf child is the instance's box verbatim, tested with the
// flat test's arithmetic against the static pass's t (the reference tests
// the boxes once, against that t), and an inner box is the exact min / max
// of its children's bounds, which passes whenever a child passes (the
// rounding of (b - o) * inv is monotone in b).  Closest collects them into
// a bitmask of instance ids (a per-thread slice of shared memory, a word
// of 32 ids at a time) and visits them lowest id first, as the reference's
// words do, so an exact tie between instances goes to the lower id and a
// tie with the static pass keeps the static record; each visit moves the
// ray into the instance's frame (o_l = M o + m3, d_l = M d in _mat_affine's
// order with no contraction, so the local rays equal the plain version's;
// the direction is not renormalised, so t is shared between the frames)
// and walks it from its root bounded by the current t.  A hit strictly
// nearer than that bound replaces the record.  Any-hit needs no order: it
// walks each instance as the descent finds it and stops at its first
// occluder.  K4 runs after K1 (K2) as its own launch, over the same
// wavefront, and updates K1's record (K2's plane) in place: a scene with
// no dynamic mesh launches no K4.  The any-hit walk skips lanes already
// occluded or with t_max <= 0.
//
// Any set the tables encode (at most kMaxInstances: an id k is the exact
// float -1 - k in the tree), by one of three kernels chosen by the set's
// size before the launch:
//  * staged (kStaged): where the tree, the instances' world->local rows (3
//    float4) and roots of a set of at most kWindow instances fit a block's
//    shared memory with the kernel still resident kK4Blocks (closest) /
//    kK4AnyBlocks (any) a SM, a block stages them once and reads them from
//    shared memory;
//  * one window: any other set of at most kWindow instances is read from
//    global memory through the read-only path (__ldg), by the same code;
//  * windows (kLarge, sets past kWindow ids): read likewise, and the
//    candidate words hold kWindow ids, so closest visits its candidates in
//    windows.  A window starts at the lowest candidate id not yet visited;
//    its descent (against the static pass's t, as every descent) collects
//    the candidates whose id lies in the window, lowest id first, and notes
//    the lowest id past it, where the next window starts.  The visits are
//    thus the reference's order, and a ray descends once for each window
//    that holds a candidate.  Any-hit has no windows: the windows kernel
//    takes each of its sets not staged.
// Measured on an H100 (PERF.md): staging is 3-7% faster while it keeps
// those blocks and 7-27% slower once it costs one (the dynamic scene's 194
// instances, 22 KB, stay staged); on 1M rays at 320 and 512 instances the
// one-window kernel is 6% and 4% faster than the windows kernel for
// closest and level with it for any.
// The descent's stack cannot overflow: a tree of kWindow instances, or of
// kMaxInstances with the deeper stack, is the deepest (static_assert).
// Measured and left out (PERF.md): a warp-uniform descent (a node
// visited when any lane passes its box, every lane reading the same node)
// was no faster on camera and bounce rays and slower on shadow rays; a tree
// 8 wide tests more boxes than 4 wide and was 3-5% slower; the child loop
// unrolled, by nvcc or into a mask of passing children, was 1-3% slower.

// resident blocks a SM (launch bounds), each the fastest measured on the
// dynamic scene's wavefronts: closest at 7 (72 registers, no spills) beat 5,
// 6 and 8 (6 and 8 spill), any at 8 beat 7 and 9 (PERF.md)
constexpr int kK4Blocks = 7;
constexpr int kK4AnyBlocks = 8;
constexpr int kTlasWidth = 4;  // children a node: tlas.TLAS_WIDTH
constexpr int kWindow = 512;    // instance ids a closest descent collects
constexpr int kMaxInstances = 16777216;  // 2^24: ids whose -1 - k is exact
constexpr int kTlasStack = 16;  // node indices a descent holds, <= kWindow
constexpr int kTlasStackDeep = 34;  // the same for any set (kLarge)
constexpr int kMatF4 = 6;       // float4s in an instance's 24-float row

// The most node indices a depth-first descent of a tree over n instances
// holds at once (tlas.tlas_stack_bound): each level below the root pushes
// at most kTlasWidth and pops one.
constexpr int tlas_stack_bound(int n, int levels = 1) {
    return n <= kTlasWidth
               ? (kTlasWidth - 1) * (levels - 1) + 1
               : tlas_stack_bound((n + kTlasWidth - 1) / kTlasWidth,
                                  levels + 1);
}
static_assert(tlas_stack_bound(kWindow) <= kTlasStack,
              "the descent stack must hold the deepest tree of a window");
static_assert(tlas_stack_bound(kMaxInstances) <= kTlasStackDeep,
              "the deep descent stack must hold the deepest tree");

// Everything an instance walk reads and writes.  ``w`` holds the merged
// tables, the world rays and, for closest, K1's record (t, u, v, slot,
// mesh: read and updated in place) or, for any, t_max.
struct InstArgs {
    WalkArgs w;
    const float4* __restrict__ mats;  // (I, 24): rows 0:12 world->local
    const float4* __restrict__ tlas;  // (nodes, kTlasWidth) child pairs
    const int* __restrict__ roots;    // (I,)
    int* __restrict__ inst_out;       // closest: the winning instance or -1
    uint8_t* __restrict__ hit_io;     // any: K2's plane, ORed in place
    int n_inst, tlas_nodes;
};

// A read of the set's tables: shared memory where the block staged them,
// else the read-only path.
template <bool kStaged, typename T>
__device__ __forceinline__ T set_load(const T* p) {
    if (kStaged) return *p;
    return __ldg(p);
}

// The flat test of one box (lo.xyz, hi.xyz) against (0, t_bound]: the
// reference's _inst_hit_words arithmetic.
__device__ __forceinline__ bool box_slab(const float4 lo, const float4 hi,
                                         const Ray& r, float t_bound) {
    float te = 0.0f, tx = t_bound;
    float t0 = (lo.x - r.ox) * r.ix, t1 = (hi.x - r.ox) * r.ix;
    te = fmaxf(te, fminf(t0, t1));
    tx = fminf(tx, fmaxf(t0, t1));
    t0 = (lo.y - r.oy) * r.iy;
    t1 = (hi.y - r.oy) * r.iy;
    te = fmaxf(te, fminf(t0, t1));
    tx = fminf(tx, fmaxf(t0, t1));
    t0 = (lo.z - r.oz) * r.iz;
    t1 = (hi.z - r.oz) * r.iz;
    te = fmaxf(te, fminf(t0, t1));
    tx = fminf(tx, fmaxf(t0, t1));
    return te <= tx;
}

// The ray in an instance's frame: _mat_affine / _mat_linear, each product
// and sum rounded on its own, left to right.
template <bool kStaged>
__device__ __forceinline__ Ray local_ray(const float4* __restrict__ rows,
                                         const Ray& r) {
    const float4 a = set_load<kStaged>(rows), b = set_load<kStaged>(rows + 1),
                 c = set_load<kStaged>(rows + 2);
    const float m[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                         b.z, b.w, c.x, c.y, c.z, c.w};
    Ray l;
    l.ox = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[0], r.ox),
                                         __fmul_rn(m[1], r.oy)),
                               __fmul_rn(m[2], r.oz)), m[3]);
    l.oy = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[4], r.ox),
                                         __fmul_rn(m[5], r.oy)),
                               __fmul_rn(m[6], r.oz)), m[7]);
    l.oz = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[8], r.ox),
                                         __fmul_rn(m[9], r.oy)),
                               __fmul_rn(m[10], r.oz)), m[11]);
    l.dx = __fadd_rn(__fadd_rn(__fmul_rn(m[0], r.dx), __fmul_rn(m[1], r.dy)),
                     __fmul_rn(m[2], r.dz));
    l.dy = __fadd_rn(__fadd_rn(__fmul_rn(m[4], r.dx), __fmul_rn(m[5], r.dy)),
                     __fmul_rn(m[6], r.dz));
    l.dz = __fadd_rn(__fadd_rn(__fmul_rn(m[8], r.dx), __fmul_rn(m[9], r.dy)),
                     __fmul_rn(m[10], r.dz));
    l.ix = safe_inv(l.dx);
    l.iy = safe_inv(l.dy);
    l.iz = safe_inv(l.dz);
    return l;
}

// Depth-first descent of the tree: ``found(k)`` for each instance k whose
// box the ray enters within t_bound, in the tree's order; a true return
// ends the descent.  A node's children are its kTlasWidth rows from
// ``tree + 2 * kTlasWidth * node``; ``ref`` (lo.w) is a child node's index,
// or -1 - k for instance k, both exact float values.
template <bool kStaged, int kStack, typename Found>
__device__ __forceinline__ void descend(const float4* __restrict__ tree,
                                        const Ray& r, float t_bound,
                                        Found found) {
    int stack[kStack];
    int sp = 0, node = 0;
    while (true) {
        const float4* const row = tree + 2 * kTlasWidth * node;
#pragma unroll 1  // unrolled (by nvcc, or into a mask): 1-3% slower
        for (int c = 0; c < kTlasWidth; ++c) {
            const float4 lo = set_load<kStaged>(row + 2 * c),
                         hi = set_load<kStaged>(row + 2 * c + 1);
            if (hi.w == 0.0f || !box_slab(lo, hi, r, t_bound)) continue;
            const int ref = static_cast<int>(lo.w);
            if (ref >= 0)
                stack[sp++] = ref;  // sp < kStack: the static_asserts
            else if (found(-1 - ref))
                return;
        }
        if (sp == 0) return;
        node = stack[--sp];
    }
}

template <bool kAny, bool kStaged, bool kLarge>
__device__ __forceinline__ void instance_rays(const InstArgs& a) {
    static_assert(!(kStaged && kLarge), "a staged set is one window");
    // staged: the tree, then each instance's world->local rows (3 float4),
    // the roots; then (closest) each thread's candidate words, word-major
    extern __shared__ float4 staged[];
    constexpr int kRowF4 = kStaged ? 3 : kMatF4;
    constexpr int kStack = kLarge ? kTlasStackDeep : kTlasStack;
    const int tree_f4 = 2 * kTlasWidth * a.tlas_nodes;
    const int stage_f4 = kStaged ? tree_f4 + 3 * a.n_inst : 0;
    const float4* const tree = kStaged ? staged : a.tlas;
    const float4* const rows = kStaged ? staged + tree_f4 : a.mats;
    const int* const roots =
        kStaged ? reinterpret_cast<const int*>(staged + stage_f4) : a.roots;
    unsigned* const words = reinterpret_cast<unsigned*>(staged + stage_f4) +
                            (kStaged ? a.n_inst : 0) + threadIdx.x;
    if (kStaged) {
        float4* const s_rows = staged + tree_f4;
        int* const s_roots = reinterpret_cast<int*>(staged + stage_f4);
        for (int q = threadIdx.x; q < tree_f4; q += blockDim.x)
            staged[q] = a.tlas[q];
        for (int q = threadIdx.x; q < 3 * a.n_inst; q += blockDim.x) {
            const int k = q / 3;
            s_rows[q] = a.mats[kMatF4 * k + q - 3 * k];
        }
        for (int k = threadIdx.x; k < a.n_inst; k += blockDim.x)
            s_roots[k] = a.roots[k];
        __syncthreads();
    }
    const int n_words = kLarge ? kWindow / 32 : (a.n_inst + 31) >> 5;
    const WalkArgs& w = a.w;
    const int lane = threadIdx.x & 31;
    while (true) {
        unsigned first = 0u;
        if (lane == 0) first = atomicAdd(w.next_ray, 32u);
        first = __shfl_sync(kAll, first, 0);
        if (first >= static_cast<unsigned>(w.n)) break;
        const int i = static_cast<int>(first) + lane;
        if (i < w.n) {
            float t = kAny ? w.t_max[i] : w.t_out[i];
            const bool todo = t > 0.0f && (!kAny || a.hit_io[i] == 0);
            int inst = -1;
            if (todo) {
                Ray r;
                r.ox = w.ox[i];
                r.oy = w.oy[i];
                r.oz = w.oz[i];
                r.dx = w.dx[i];
                r.dy = w.dy[i];
                r.dz = w.dz[i];
                r.ix = safe_inv(r.dx);
                r.iy = safe_inv(r.dy);
                r.iz = safe_inv(r.dz);
                if (kAny) {
                    descend<kStaged, kStack>(tree, r, t, [&](int k) {
                        const Ray l = local_ray<kStaged>(rows + kRowF4 * k, r);
                        int slot = -1, mesh = -1;
                        float uu = 0.0f, vv = 0.0f;
                        if (!walk<true, false, false>(
                                w.nodes, w.n_nodes, w.tris, w.n_blocks, l, t,
                                slot, mesh, uu, vv, nullptr,
                                set_load<kStaged>(roots + k)))
                            return false;
                        inst = k;
                        return true;
                    });
                } else {
                    // the boxes are tested against the static pass's t, in
                    // every window
                    const float t_box = t;
                    int low = 0;  // the window's lowest id
                    do {
                        int next = a.n_inst;  // the lowest id past it
                        for (int q = 0; q < n_words; ++q)
                            words[q * kThreads] = 0u;
                        descend<kStaged, kStack>(tree, r, t_box, [&](int k) {
                            const int off = kLarge ? k - low : k;
                            if (kLarge && off >= kWindow) {
                                next = min(next, k);
                            } else if (!kLarge || off >= 0) {
                                words[(off >> 5) * kThreads] |= 1u
                                                                << (off & 31);
                            }
                            return false;
                        });
                        // the window's candidates lowest id first, each
                        // walked bounded by the current t; a nearer hit is
                        // written at once (the record is K1's until then),
                        // so nothing of it stays live across the next walk
                        for (int q = 0; q < n_words; ++q) {
                            unsigned m;
                            while ((m = words[q * kThreads]) != 0u) {
                                words[q * kThreads] = m & (m - 1u);
                                const int k = low + 32 * q + __ffs(m) - 1;
                                const Ray l =
                                    local_ray<kStaged>(rows + kRowF4 * k, r);
                                int slot = -1, mesh = -1;
                                float uu = 0.0f, vv = 0.0f;
                                walk<false, true, false>(
                                    w.nodes, w.n_nodes, w.tris, w.n_blocks, l,
                                    t, slot, mesh, uu, vv, nullptr,
                                    set_load<kStaged>(roots + k));
                                if (slot >= 0) {  // strictly nearer
                                    inst = k;
                                    w.t_out[i] = t;
                                    w.u_out[i] = uu;
                                    w.v_out[i] = vv;
                                    w.slot_out[i] = slot;
                                    w.mesh_out[i] = mesh;
                                }
                            }
                        }
                        low = next;
                    } while (kLarge && low < a.n_inst);
                }
            }
            if (kAny) {
                if (inst >= 0) a.hit_io[i] = 1;
            } else {
                a.inst_out[i] = inst;
            }
        }
        __syncwarp();
    }
}

template <bool kStaged, bool kLarge>
__global__ void __launch_bounds__(kThreads, kK4Blocks)
instances_closest_kernel(const __grid_constant__ InstArgs a) {
    instance_rays<false, kStaged, kLarge>(a);
}

template <bool kStaged, bool kLarge>
__global__ void __launch_bounds__(kThreads, kK4AnyBlocks)
instances_any_kernel(const __grid_constant__ InstArgs a) {
    instance_rays<true, kStaged, kLarge>(a);
}

// The K4 kernels, [any][path]: path 0 a set of at most kWindow instances
// read from global memory, 1 the same staged, 2 a larger set (for any-hit,
// every set not staged).
const void* const kInstKernels[2][3] = {
    {reinterpret_cast<const void*>(instances_closest_kernel<false, false>),
     reinterpret_cast<const void*>(instances_closest_kernel<true, false>),
     reinterpret_cast<const void*>(instances_closest_kernel<false, true>)},
    {reinterpret_cast<const void*>(instances_any_kernel<false, true>),
     reinterpret_cast<const void*>(instances_any_kernel<true, false>),
     reinterpret_cast<const void*>(instances_any_kernel<false, true>)}};

size_t inst_shared_bytes(bool any, bool staged, bool large, int n_inst,
                         int tlas_nodes) {
    const size_t n = static_cast<size_t>(n_inst);
    const size_t words = any ? 0 : (large ? kWindow / 32 : (n + 31) >> 5);
    const size_t set =
        staged ? sizeof(float4) * (2 * kTlasWidth *
                                       static_cast<size_t>(tlas_nodes) +
                                   3 * n) +
                     sizeof(int) * n
               : 0;
    return set + sizeof(unsigned) * kThreads * words;
}

// The K4 kernel for this set: staged where the set has at most kWindow ids
// and the staged kernel keeps its launch bounds' blocks a SM (which takes
// well under 48 KB, so no launch opts in to more), else one window or
// windows by the set's size; and its shared bytes.
cudaError_t inst_kernel(bool any, int n_inst, int tlas_nodes,
                        const void** fn, size_t* smem, bool* staged) {
    const bool large = n_inst > kWindow;
    *staged = false;
    const size_t stage_bytes =
        inst_shared_bytes(any, true, false, n_inst, tlas_nodes);
    if (!large && stage_bytes <= (48u << 10)) {
        int per_sm = 0;
        const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kInstKernels[any][1], kThreads, stage_bytes);
        if (e != cudaSuccess) return e;
        *staged = per_sm >= (any ? kK4AnyBlocks : kK4Blocks);
    }
    *fn = kInstKernels[any][large ? 2 : (*staged ? 1 : 0)];
    *smem = inst_shared_bytes(any, *staged, large, n_inst, tlas_nodes);
    return cudaSuccess;
}

int launch_instances(bool any, const InstArgs& a, void* stream) {
    if (a.n_inst > kMaxInstances || (a.tlas_nodes < 1 && a.n_inst > 0))
        return static_cast<int>(cudaErrorInvalidValue);
    if (a.w.n <= 0 || a.n_inst <= 0)
        return static_cast<int>(cudaGetLastError());
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const void* fn = nullptr;
    size_t smem = 0;
    bool staged = false;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e =
        inst_kernel(any, a.n_inst, a.tlas_nodes, &fn, &smem, &staged);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                          kThreads, smem);
    if (e == cudaSuccess)
        e = cudaMemsetAsync(a.w.next_ray, 0, sizeof(unsigned), st);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) per_sm = 1;
    const int need = (a.w.n + kThreads - 1) / kThreads;
    const int grid = sms * per_sm < need ? sms * per_sm : need;
    InstArgs args = a;
    void* params[] = {&args};
    return static_cast<int>(
        cudaLaunchKernel(fn, dim3(grid), dim3(kThreads), params, smem, st));
}

InstArgs inst_args(const float* mats, const float* tlas, int tlas_nodes,
                   const int* roots, int n_inst) {
    InstArgs a = {};
    a.mats = reinterpret_cast<const float4*>(mats);
    a.tlas = reinterpret_cast<const float4*>(tlas);
    a.tlas_nodes = tlas_nodes;
    a.roots = roots;
    a.n_inst = n_inst;
    return a;
}

}  // namespace

extern "C" {

int ptrt_max_stack() { return kMaxStack; }

const char* ptrt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1.  Exactly one of ``t_max`` and ``alive`` (a torch.bool plane) is
// non-null; a live lane walks with t_max = 1e30, a dead one returns t = -1.
// ``next_ray`` is 4 bytes of device scratch, zeroed here on the stream.
int ptrt_closest_hit(const float* nodes, int n_nodes, const float* tris,
                     int n_blocks, const float* ox, const float* oy,
                     const float* oz, const float* dx, const float* dy,
                     const float* dz, const float* t_max,
                     const uint8_t* alive, int n, float* t_out, float* u_out,
                     float* v_out, int* slot_out, int* mesh_out,
                     unsigned* next_ray, void* stream) {
    if ((t_max == nullptr) == (alive == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    WalkArgs a = walk_args(nodes, n_nodes, tris, n_blocks, ox, oy, oz, dx, dy,
                           dz, t_max, n, next_ray);
    a.alive = alive;
    a.t_out = t_out;
    a.u_out = u_out;
    a.v_out = v_out;
    a.slot_out = slot_out;
    a.mesh_out = mesh_out;
    return launch(alive ? 5 : 0, a, stream);
}

// K1 on a t_max plane of ``n`` rays' room, of which the first
// ``count_scale * *count`` are walked (``count``: an int the card holds,
// written by an earlier launch on the stream); the others are left
// unwritten.
int ptrt_closest_hit_counted(const float* nodes, int n_nodes,
                             const float* tris, int n_blocks, const float* ox,
                             const float* oy, const float* oz,
                             const float* dx, const float* dy,
                             const float* dz, const float* t_max, int n,
                             const int* count, int count_scale, float* t_out,
                             float* u_out, float* v_out, int* slot_out,
                             int* mesh_out, unsigned* next_ray,
                             void* stream) {
    if (t_max == nullptr || count == nullptr || count_scale < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    WalkArgs a = walk_args(nodes, n_nodes, tris, n_blocks, ox, oy, oz, dx, dy,
                           dz, t_max, n, next_ray);
    a.count = count;
    a.count_scale = count_scale;
    a.t_out = t_out;
    a.u_out = u_out;
    a.v_out = v_out;
    a.slot_out = slot_out;
    a.mesh_out = mesh_out;
    return launch(6, a, stream);
}

// K2: one byte a ray (a torch.bool plane), 1 when an opaque triangle lies
// in (T_MIN, t_max).
int ptrt_any_hit(const float* nodes, int n_nodes, const float* tris,
                 int n_blocks, const float* ox, const float* oy,
                 const float* oz, const float* dx, const float* dy,
                 const float* dz, const float* t_max, int n, uint8_t* hit_out,
                 unsigned* next_ray, void* stream) {
    if (t_max == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    WalkArgs a = walk_args(nodes, n_nodes, tris, n_blocks, ox, oy, oz, dx, dy,
                           dz, t_max, n, next_ray);
    a.hit_out = hit_out;
    return launch(1, a, stream);
}

// K2 on a device count, as ptrt_closest_hit_counted.
int ptrt_any_hit_counted(const float* nodes, int n_nodes, const float* tris,
                         int n_blocks, const float* ox, const float* oy,
                         const float* oz, const float* dx, const float* dy,
                         const float* dz, const float* t_max, int n,
                         const int* count, int count_scale, uint8_t* hit_out,
                         unsigned* next_ray, void* stream) {
    if (t_max == nullptr || count == nullptr || count_scale < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    WalkArgs a = walk_args(nodes, n_nodes, tris, n_blocks, ox, oy, oz, dx, dy,
                           dz, t_max, n, next_ray);
    a.count = count;
    a.count_scale = count_scale;
    a.hit_out = hit_out;
    return launch(7, a, stream);
}

// The walks with a tally, for measurement only: ``walk`` 0 is K1 in
// near-first order, 1 K1 in slot order, 2 K2.  Writes the same answers as
// the walk (K1: t, u, v, slot, mesh; K2: hit_out) and the nodes visited
// and triangles tested over all rays into counts[0] and counts[1] (zeroed
// here first).
int ptrt_walk_counts(int walk, const float* nodes, int n_nodes,
                     const float* tris, int n_blocks, const float* ox,
                     const float* oy, const float* oz, const float* dx,
                     const float* dy, const float* dz, const float* t_max,
                     int n, float* t_out, float* u_out, float* v_out,
                     int* slot_out, int* mesh_out, uint8_t* hit_out,
                     unsigned* next_ray, unsigned long long* counts,
                     void* stream) {
    if (t_max == nullptr || counts == nullptr || walk < 0 || walk > 2)
        return static_cast<int>(cudaErrorInvalidValue);
    WalkArgs a = walk_args(nodes, n_nodes, tris, n_blocks, ox, oy, oz, dx, dy,
                           dz, t_max, n, next_ray);
    a.t_out = t_out;
    a.u_out = u_out;
    a.v_out = v_out;
    a.slot_out = slot_out;
    a.mesh_out = mesh_out;
    a.hit_out = hit_out;
    a.counts = counts;
    return launch(2 + walk, a, stream);
}

// K4 closest: after K1 on the same rays.  ``t_io`` .. ``mesh_io`` hold K1's
// record and are updated in place where an instance hit is nearer;
// ``inst_out`` receives the winning instance (-1: the static pass's record
// or nothing).  The tables are the merged instance set's; ``mats`` (I, 24)
// and ``tlas`` (tlas_nodes, kTlasWidth, 8) 16-byte aligned.
int ptrt_instances_closest(const float* nodes, int n_nodes, const float* tris,
                           int n_blocks, const float* ox, const float* oy,
                           const float* oz, const float* dx, const float* dy,
                           const float* dz, int n, float* t_io, float* u_io,
                           float* v_io, int* slot_io, int* mesh_io,
                           int* inst_out, const float* mats,
                           const float* tlas, int tlas_nodes,
                           const int* roots, int n_inst, unsigned* next_ray,
                           void* stream) {
    InstArgs a = inst_args(mats, tlas, tlas_nodes, roots, n_inst);
    a.w = walk_args(nodes, n_nodes, tris, n_blocks, ox, oy, oz, dx, dy, dz,
                    nullptr, n, next_ray);
    a.w.t_out = t_io;
    a.w.u_out = u_io;
    a.w.v_out = v_io;
    a.w.slot_out = slot_io;
    a.w.mesh_out = mesh_io;
    a.inst_out = inst_out;
    return launch_instances(false, a, stream);
}

// K4 any: after K2 on the same shadow rays; ``hit_io`` (K2's plane) gets 1
// where a lane not yet occluded, with t_max > 0, meets an opaque triangle of
// an instance in (T_MIN, t_max).
int ptrt_instances_any(const float* nodes, int n_nodes, const float* tris,
                       int n_blocks, const float* ox, const float* oy,
                       const float* oz, const float* dx, const float* dy,
                       const float* dz, const float* t_max, int n,
                       uint8_t* hit_io, const float* mats, const float* tlas,
                       int tlas_nodes, const int* roots, int n_inst,
                       unsigned* next_ray, void* stream) {
    if (t_max == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    InstArgs a = inst_args(mats, tlas, tlas_nodes, roots, n_inst);
    a.w = walk_args(nodes, n_nodes, tris, n_blocks, ox, oy, oz, dx, dy, dz,
                    t_max, n, next_ray);
    a.hit_io = hit_io;
    return launch_instances(true, a, stream);
}

// The most instances a set may hold: an id is the exact float -1 - k.
int ptrt_max_instances() { return kMaxInstances; }

// Registers, local-memory bytes a thread, resident blocks a SM and whether
// the set is staged, for K4 (``walk`` 0 closest, 1 any) on a set of
// ``n_inst`` instances with a tree of ``tlas_nodes`` nodes.
int ptrt_instances_info(int walk, int n_inst, int tlas_nodes, int* regs,
                        int* local_bytes, int* per_sm, int* staged) {
    if (walk < 0 || walk > 1 || n_inst < 1 || n_inst > kMaxInstances)
        return static_cast<int>(cudaErrorInvalidValue);
    const void* fn = nullptr;
    size_t smem = 0;
    bool is_staged = false;
    cudaError_t e =
        inst_kernel(walk == 1, n_inst, tlas_nodes, &fn, &smem, &is_staged);
    cudaFuncAttributes attr = {};
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn,
                                                          kThreads, smem);
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    *staged = is_staged ? 1 : 0;
    return static_cast<int>(e);
}

// Registers, local-memory bytes a thread and resident blocks a SM of the
// main-path walks: ``walk`` 0 is K1 on an alive plane (the bounce loop's),
// 1 K1 on a t_max plane, 2 K2, 3 K1 and 4 K2 on a device count.
int ptrt_walk_info(int walk, int* regs, int* local_bytes, int* per_sm) {
    if (walk < 0 || walk > 4) return static_cast<int>(cudaErrorInvalidValue);
    const int k = walk == 0 ? 5 : walk <= 2 ? walk - 1 : walk + 3;
    cudaFuncAttributes attr = {};
    cudaError_t e = cudaFuncGetAttributes(&attr, kWalks[k]);
    int dev = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = blocks_per_sm(k, dev, per_sm);
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    return static_cast<int>(e);
}

}  // extern "C"
