// K1 closest_hit and K2 any_hit: per-ray 8-wide BVH walks for Hopper.
//
// Replaces: ptrt_tpu/render/traverse.py:intersect_closest (K1) and
// traverse.py:intersect_any (K2) on a flat SceneGeometry — the XLA
// lock-step mask-stack walks (_walk_closest_raw / _any_state with
// _fetch_node8, _slab8, _descend, _fetch_leaf, _mt_test) and their
// compaction ladders, which exist to work around TPU gather costs.
//
// What bounds it on the card: dependent, data-driven loads.  Each visited
// node is one 256-byte row (52 used floats read as 13 float4 loads), each
// visited leaf one 320-byte triangle row; the next address depends on the
// slab test of the previous row, so a warp waits on memory latency and
// diverges as its rays take different paths.  The node and triangle
// tables of the 1M-triangle bench scene (~100 MB) exceed the 50 MB L2.
//
// What this design does about it: one thread per ray (no lock-step: a
// finished ray frees its lane at once), a short per-thread stack of
// (child_base, pending_slot_mask) entries so one entry covers up to eight
// siblings, all eight child boxes tested from one node row, and leaves of a
// node tested as soon as their box is hit so t shrinks early.  Ordered
// (near-first) descent, cp.async/TMA staging, persistent threads and
// wavefront compaction are later work.
//
// Semantics match the reference bit for bit where the arithmetic allows:
// _safe_inv's signed 1e-12, slab test t_enter = max(0, ..) <= t_exit =
// min(t_bound, ..), Möller–Trumbore with _MT_EPS = 1e-9, inclusive
// barycentric epsilon 1e-6, T_MIN < t < t_max with t_max shrinking as hits
// come in, and table ints decoded by float->int VALUE conversion (never a
// bitcast).  Lanes with t_max <= 0 are dead and return a miss.  The build
// uses no fast-math; nvcc's default FMA contraction can still move a
// grazing ray across an edge, which the callers' tolerances allow.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLeaf = 8;              // LEAF_SIZE (geometry/bvh.py)
constexpr int kTriRow = 10 * kLeaf;   // tri_rows width
constexpr int kNodeRow = 64;          // node_rows width
constexpr int kMaxStack = 64;         // must be >= SceneGeometry.stack_depth
constexpr float kTMin = 1e-4f;        // traverse.T_MIN
constexpr float kMtEps = 1e-9f;       // traverse._MT_EPS
constexpr float kBaryLo = -1e-6f;     // -beps
constexpr float kBaryHi = 1.000001f;  // 1 + beps
constexpr int kThreads = 128;

struct Ray {
    float ox, oy, oz, dx, dy, dz, ix, iy, iz;
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
// returns the hit bitmask and the row's metadata.
__device__ __forceinline__ uint32_t visit_node(const float* __restrict__ nodes,
                                               int node, const Ray& r,
                                               float t_bound, int& cba, int& lb,
                                               uint32_t& lmask,
                                               uint32_t& imask) {
    const float4* row = reinterpret_cast<const float4*>(
        nodes + static_cast<size_t>(node) * kNodeRow);
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

// The walk.  Closest (kAny = false): t shrinks to the nearest hit, best
// receives its tri slot (block * kLeaf + j).  Any (kAny = true): returns
// true on the first hit of an opaque triangle.
template <bool kAny>
__device__ bool walk(const float* __restrict__ nodes, int n_nodes,
                     const float* __restrict__ tris, int n_blocks,
                     const Ray& r, float& t, int& best, int& best_mesh,
                     float& best_u, float& best_v) {
    int stack_base[kMaxStack];
    uint32_t stack_mask[kMaxStack];
    int sp = 0;
    int base = 0;       // the root is node 0 = base 0 + slot 0
    uint32_t mask = 1u;
    while (true) {
        if (mask == 0u) {
            if (sp == 0) break;
            --sp;
            base = stack_base[sp];
            mask = stack_mask[sp];
        }
        const int node = base + __ffs(mask) - 1;
        mask &= mask - 1u;
        if (static_cast<unsigned>(node) >= static_cast<unsigned>(n_nodes))
            continue;
        int cba, lb;
        uint32_t lmask, imask;
        const uint32_t hit = visit_node(nodes, node, r, t, cba, lb, lmask,
                                        imask);
        uint32_t leaves = hit & lmask;
        while (leaves) {
            const int blk = lb + __ffs(leaves) - 1;
            leaves &= leaves - 1u;
            if (static_cast<unsigned>(blk) >= static_cast<unsigned>(n_blocks))
                continue;
            const float* row = tris + static_cast<size_t>(blk) * kTriRow;
#pragma unroll
            for (int j = 0; j < kLeaf; ++j) {
                const int packed = static_cast<int>(__ldg(row + 9 * kLeaf + j));
                const int mesh = packed >> 1;  // pad ids stay negative
                if (mesh < 0) continue;
                if (kAny && (packed & 1) == 0) continue;  // not an occluder
                float tt, uu, vv;
                if (!mt_test(row, j, r, t, tt, uu, vv)) continue;
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
            if (mask && sp < kMaxStack) {
                stack_base[sp] = base;
                stack_mask[sp] = mask;
                ++sp;
            }
            base = cba;
            mask = ints;
        }
    }
    return false;
}

__device__ __forceinline__ Ray load_ray(const float* ox, const float* oy,
                                        const float* oz, const float* dx,
                                        const float* dy, const float* dz,
                                        int i) {
    Ray r;
    r.ox = ox[i];
    r.oy = oy[i];
    r.oz = oz[i];
    r.dx = dx[i];
    r.dy = dy[i];
    r.dz = dz[i];
    r.ix = safe_inv(r.dx);
    r.iy = safe_inv(r.dy);
    r.iz = safe_inv(r.dz);
    return r;
}

__global__ void __launch_bounds__(kThreads)
closest_hit_kernel(const float* __restrict__ nodes, int n_nodes,
                   const float* __restrict__ tris, int n_blocks,
                   const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ oz, const float* __restrict__ dx,
                   const float* __restrict__ dy, const float* __restrict__ dz,
                   const float* __restrict__ t_max, int n,
                   float* __restrict__ t_out, float* __restrict__ u_out,
                   float* __restrict__ v_out, int* __restrict__ slot_out,
                   int* __restrict__ mesh_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float t = t_max[i];
    int best = -1, best_mesh = -1;
    float bu = 0.0f, bv = 0.0f;
    if (t > 0.0f) {
        const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
        walk<false>(nodes, n_nodes, tris, n_blocks, r, t, best, best_mesh,
                    bu, bv);
    }
    t_out[i] = t;
    u_out[i] = bu;
    v_out[i] = bv;
    slot_out[i] = best;
    mesh_out[i] = best_mesh;
}

__global__ void __launch_bounds__(kThreads)
any_hit_kernel(const float* __restrict__ nodes, int n_nodes,
               const float* __restrict__ tris, int n_blocks,
               const float* __restrict__ ox, const float* __restrict__ oy,
               const float* __restrict__ oz, const float* __restrict__ dx,
               const float* __restrict__ dy, const float* __restrict__ dz,
               const float* __restrict__ t_max, int n,
               uint8_t* __restrict__ hit_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    float t = t_max[i];
    bool hit = false;
    if (t > 0.0f) {
        const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
        int best, best_mesh;
        float bu, bv;
        hit = walk<true>(nodes, n_nodes, tris, n_blocks, r, t, best,
                         best_mesh, bu, bv);
    }
    hit_out[i] = hit ? 1 : 0;
}

inline int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

int ptrt_max_stack() { return kMaxStack; }

const char* ptrt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int ptrt_closest_hit(const float* nodes, int n_nodes, const float* tris,
                     int n_blocks, const float* ox, const float* oy,
                     const float* oz, const float* dx, const float* dy,
                     const float* dz, const float* t_max, int n, float* t_out,
                     float* u_out, float* v_out, int* slot_out, int* mesh_out,
                     void* stream) {
    if (n > 0) {
        closest_hit_kernel<<<blocks_for(n), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
            nodes, n_nodes, tris, n_blocks, ox, oy, oz, dx, dy, dz, t_max, n,
            t_out, u_out, v_out, slot_out, mesh_out);
    }
    return static_cast<int>(cudaGetLastError());
}

int ptrt_any_hit(const float* nodes, int n_nodes, const float* tris,
                 int n_blocks, const float* ox, const float* oy,
                 const float* oz, const float* dx, const float* dy,
                 const float* dz, const float* t_max, int n, uint8_t* hit_out,
                 void* stream) {
    if (n > 0) {
        any_hit_kernel<<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
            nodes, n_nodes, tris, n_blocks, ox, oy, oz, dx, dy, dz, t_max, n,
            hit_out);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
