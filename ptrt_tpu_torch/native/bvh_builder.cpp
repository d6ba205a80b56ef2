// Native BVH builder for ptrt_tpu.
//
// C++ implementation of the median-split BVH build (the same heuristic as
// ptrt_tpu/geometry/bvh.py: split at the median of triangle centroids on the
// longest axis — the reference engine builds the same tree on CPU,
// mesh.cuh:403-492 / RTmesh.cuh:472-551).  Emits the flattened skip-pointer
// layout directly: DFS order, left child = i+1, skip = miss successor,
// leaves padded to a fixed block of LEAF_SIZE triangle slots.
//
// Exposed as a C ABI for ctypes; no Python.h dependency.
//
// Build: g++ -O3 -march=native -fPIC -shared bvh_builder.cpp -o libptrtnative.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct BuildCtx {
    const float *tmin;  // (n,3)
    const float *tmax;  // (n,3)
    const float *cent;  // (n,3)
    int leaf_size;

    std::vector<float> bmin, bmax;
    std::vector<int32_t> leaf_first, skip;
    std::vector<int64_t> order;
    std::vector<int32_t> left_child, right_child;
};

struct Box {
    float mn[3] = {3.4e38f, 3.4e38f, 3.4e38f};
    float mx[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
    void grow(const float *lo, const float *hi) {
        for (int a = 0; a < 3; ++a) {
            mn[a] = std::min(mn[a], lo[a]);
            mx[a] = std::max(mx[a], hi[a]);
        }
    }
    void grow(const Box &b) { grow(b.mn, b.mx); }
    float half_area() const {
        const float dx = std::max(0.0f, mx[0] - mn[0]);
        const float dy = std::max(0.0f, mx[1] - mn[1]);
        const float dz = std::max(0.0f, mx[2] - mn[2]);
        return dx * dy + dy * dz + dz * dx;
    }
};

constexpr int SAH_BINS = 16;

int build_node(BuildCtx &ctx, int64_t *idx, int64_t count) {
    const int node_id = static_cast<int>(ctx.leaf_first.size());
    Box nb;
    for (int64_t i = 0; i < count; ++i)
        nb.grow(ctx.tmin + idx[i] * 3, ctx.tmax + idx[i] * 3);
    ctx.bmin.insert(ctx.bmin.end(), nb.mn, nb.mn + 3);
    ctx.bmax.insert(ctx.bmax.end(), nb.mx, nb.mx + 3);
    ctx.leaf_first.push_back(-1);
    ctx.skip.push_back(-1);
    ctx.left_child.push_back(-1);
    ctx.right_child.push_back(-1);

    if (count <= ctx.leaf_size) {
        const int64_t first = static_cast<int64_t>(ctx.order.size());
        for (int64_t i = 0; i < count; ++i) ctx.order.push_back(idx[i]);
        for (int64_t i = count; i < ctx.leaf_size; ++i) ctx.order.push_back(-1);
        ctx.leaf_first[node_id] = static_cast<int32_t>(first);
        return node_id;
    }

    // centroid bounds
    float cmn[3] = {3.4e38f, 3.4e38f, 3.4e38f};
    float cmx[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
    for (int64_t i = 0; i < count; ++i) {
        const float *c = ctx.cent + idx[i] * 3;
        for (int a = 0; a < 3; ++a) {
            cmn[a] = std::min(cmn[a], c[a]);
            cmx[a] = std::max(cmx[a], c[a]);
        }
    }

    // binned SAH over all three axes; fall back to median split when
    // degenerate.  SAH trees sharply reduce worst-case node visits, which
    // is what the lock-step vector traversal pays for.
    int best_axis = -1, best_bin = -1;
    float best_cost = 3.4e38f;
    float inv_ext[3];
    for (int a = 0; a < 3; ++a) {
        const float e = cmx[a] - cmn[a];
        inv_ext[a] = e > 1e-12f ? 1.0f / e : 0.0f;
    }
    for (int axis = 0; axis < 3; ++axis) {
        if (inv_ext[axis] == 0.0f) continue;
        Box bins[SAH_BINS];
        int64_t bcount[SAH_BINS] = {0};
        for (int64_t i = 0; i < count; ++i) {
            const float c = ctx.cent[idx[i] * 3 + axis];
            int b = static_cast<int>((c - cmn[axis]) * inv_ext[axis]
                                     * SAH_BINS);
            b = std::min(std::max(b, 0), SAH_BINS - 1);
            bins[b].grow(ctx.tmin + idx[i] * 3, ctx.tmax + idx[i] * 3);
            bcount[b]++;
        }
        Box right_acc[SAH_BINS];
        Box acc;
        int64_t rcount[SAH_BINS] = {0};
        int64_t rc = 0;
        for (int b = SAH_BINS - 1; b >= 1; --b) {
            acc.grow(bins[b]);
            rc += bcount[b];
            right_acc[b] = acc;
            rcount[b] = rc;
        }
        Box lbox;
        int64_t lc = 0;
        for (int b = 0; b < SAH_BINS - 1; ++b) {
            lbox.grow(bins[b]);
            lc += bcount[b];
            if (lc == 0 || rcount[b + 1] == 0) continue;
            const float cost = lbox.half_area() * lc
                               + right_acc[b + 1].half_area() * rcount[b + 1];
            if (cost < best_cost) {
                best_cost = cost;
                best_axis = axis;
                best_bin = b;
            }
        }
    }

    int64_t half = -1;
    if (best_axis >= 0) {
        const float split =
            cmn[best_axis]
            + (best_bin + 1) * (cmx[best_axis] - cmn[best_axis]) / SAH_BINS;
        int64_t *mid = std::partition(
            idx, idx + count, [&](int64_t t) {
                return ctx.cent[t * 3 + best_axis] < split;
            });
        half = mid - idx;
        if (half == 0 || half == count) half = -1;  // degenerate partition
    }
    if (half < 0) {
        // median fallback on longest centroid axis
        int axis = 0;
        float beste = cmx[0] - cmn[0];
        for (int a = 1; a < 3; ++a) {
            if (cmx[a] - cmn[a] > beste) {
                beste = cmx[a] - cmn[a];
                axis = a;
            }
        }
        half = count / 2;
        std::nth_element(idx, idx + half, idx + count,
                         [&](int64_t a, int64_t b) {
                             return ctx.cent[a * 3 + axis]
                                    < ctx.cent[b * 3 + axis];
                         });
    }

    const int lid = build_node(ctx, idx, half);
    const int rid = build_node(ctx, idx + half, count - half);
    ctx.left_child[node_id] = lid;
    ctx.right_child[node_id] = rid;
    return node_id;
}

void assign_skip(BuildCtx &ctx, int root, int after) {
    // iterative DFS; skip = next node after my subtree
    std::vector<std::pair<int, int>> stack;
    stack.emplace_back(root, after);
    while (!stack.empty()) {
        auto [nid, aft] = stack.back();
        stack.pop_back();
        ctx.skip[nid] = aft;
        const int lid = ctx.left_child[nid];
        if (lid >= 0) {
            const int rid = ctx.right_child[nid];
            stack.emplace_back(rid, aft);
            stack.emplace_back(lid, rid);
        }
    }
}

BuildCtx *g_last = nullptr;

// ---------------------------------------------------------------------------
// 8-wide BVH: binary SAH tree collapsed to branching factor 8.
//
// Wide layout contract (consumed by ptrt_tpu/geometry/bvh8.py and the
// lock-step mask-stack traversal in render/traverse.py):
//   * each wide node's LEAF children occupy slots [0, leaf_count) and their
//     triangle blocks are CONTIGUOUS rows [leaf_base, leaf_base+leaf_count)
//     of the tri-row table (so tri row = leaf_base + slot);
//   * each wide node's INTERNAL children occupy slots
//     [leaf_count, leaf_count+int_count) and are CONTIGUOUS wide-node ids
//     [child_base, child_base+int_count) (so node id = child_base + slot -
//     leaf_count — a single (base, slot) addressing scheme per table, which
//     is what lets traversal keep only a (base, bitmask) pair per stack
//     entry instead of 8 child pointers).
// ---------------------------------------------------------------------------

struct Wide8Ctx {
    std::vector<float> slot_bmin, slot_bmax;  // (nw, 8, 3)
    std::vector<int32_t> child_base, leaf_base;
    std::vector<int32_t> leaf_count, int_count;
    std::vector<int64_t> order;  // tri slots in wide leaf-block layout
    int32_t max_depth = 0;
};

Wide8Ctx *g_wide = nullptr;

void emit_wide(const BuildCtx &bin, Wide8Ctx &w, int wide_id, int bin_node,
               int leaf_size, int depth) {
    w.max_depth = std::max(w.max_depth, depth);
    // gather up to 8 subtree roots under bin_node, greedily expanding the
    // internal member with the largest surface area (classic BVH8 collapse)
    int members[8];
    int count = 0;
    if (bin.left_child[bin_node] < 0) {
        members[count++] = bin_node;  // degenerate: root itself is a leaf
    } else {
        members[count++] = bin.left_child[bin_node];
        members[count++] = bin.right_child[bin_node];
        while (count < 8) {
            int best = -1;
            float best_area = -1.0f;
            for (int i = 0; i < count; ++i) {
                const int m = members[i];
                if (bin.left_child[m] < 0) continue;  // leaf
                Box b;
                b.grow(&bin.bmin[m * 3], &bin.bmax[m * 3]);
                const float area = b.half_area();
                if (area > best_area) {
                    best_area = area;
                    best = i;
                }
            }
            if (best < 0) break;  // all leaves
            const int m = members[best];
            members[best] = bin.left_child[m];
            members[count++] = bin.right_child[m];
        }
    }

    // order: leaves first (slots 0..nl-1), internals after
    int leaves[8], internals[8];
    int nl = 0, ni = 0;
    for (int i = 0; i < count; ++i) {
        if (bin.left_child[members[i]] < 0) leaves[nl++] = members[i];
        else internals[ni++] = members[i];
    }

    const int32_t lbase =
        static_cast<int32_t>(w.order.size() / leaf_size);
    for (int i = 0; i < nl; ++i) {
        const int32_t first = bin.leaf_first[leaves[i]];
        for (int k = 0; k < leaf_size; ++k)
            w.order.push_back(bin.order[first + k]);
    }
    // reserve ni contiguous wide ids for internal children
    const int32_t cbase = static_cast<int32_t>(w.child_base.size());
    for (int i = 0; i < ni; ++i) {
        w.slot_bmin.insert(w.slot_bmin.end(), 24, 0.0f);
        w.slot_bmax.insert(w.slot_bmax.end(), 24, -1.0f);
        w.child_base.push_back(0);
        w.leaf_base.push_back(0);
        w.leaf_count.push_back(0);
        w.int_count.push_back(0);
    }

    // fill this node's slots
    float *bmn = &w.slot_bmin[static_cast<size_t>(wide_id) * 24];
    float *bmx = &w.slot_bmax[static_cast<size_t>(wide_id) * 24];
    for (int s = 0; s < 8; ++s) {
        const int m = s < nl ? leaves[s]
                             : (s < nl + ni ? internals[s - nl] : -1);
        for (int a = 0; a < 3; ++a) {
            bmn[s * 3 + a] = m >= 0 ? bin.bmin[m * 3 + a] : 0.0f;
            bmx[s * 3 + a] = m >= 0 ? bin.bmax[m * 3 + a] : -1.0f;
        }
    }
    w.child_base[wide_id] = cbase;
    w.leaf_base[wide_id] = lbase;
    w.leaf_count[wide_id] = nl;
    w.int_count[wide_id] = ni;

    for (int i = 0; i < ni; ++i)
        emit_wide(bin, w, cbase + i, internals[i], leaf_size, depth + 1);
}

}  // namespace

extern "C" {

// Builds the BVH. Returns number of nodes; call ptrt_bvh_fetch to copy out.
// order_len receives the padded triangle-slot count.
int64_t ptrt_bvh_build(const float *tmin, const float *tmax, const float *cent,
                       int64_t n, int32_t leaf_size, int64_t *order_len) {
    delete g_last;
    g_last = new BuildCtx();
    g_last->tmin = tmin;
    g_last->tmax = tmax;
    g_last->cent = cent;
    g_last->leaf_size = leaf_size;

    std::vector<int64_t> idx(n);
    for (int64_t i = 0; i < n; ++i) idx[i] = i;
    if (n > 0) {
        build_node(*g_last, idx.data(), n);
        assign_skip(*g_last, 0, static_cast<int>(g_last->leaf_first.size()));
    }
    *order_len = static_cast<int64_t>(g_last->order.size());
    return static_cast<int64_t>(g_last->leaf_first.size());
}

// Builds the 8-wide BVH (binary SAH collapsed).  Returns the number of wide
// nodes (>= 1); order_len receives the padded tri-slot count in wide layout,
// max_depth the deepest wide-node level (for traversal stack sizing).
int64_t ptrt_bvh8_build(const float *tmin, const float *tmax,
                        const float *cent, int64_t n, int32_t leaf_size,
                        int64_t *order_len, int32_t *max_depth) {
    delete g_last;
    g_last = new BuildCtx();
    g_last->tmin = tmin;
    g_last->tmax = tmax;
    g_last->cent = cent;
    g_last->leaf_size = leaf_size;

    delete g_wide;
    g_wide = new Wide8Ctx();

    if (n > 0) {
        std::vector<int64_t> idx(n);
        for (int64_t i = 0; i < n; ++i) idx[i] = i;
        build_node(*g_last, idx.data(), n);
        // wide root at id 0
        g_wide->slot_bmin.assign(24, 0.0f);
        g_wide->slot_bmax.assign(24, -1.0f);
        g_wide->child_base.assign(1, 0);
        g_wide->leaf_base.assign(1, 0);
        g_wide->leaf_count.assign(1, 0);
        g_wide->int_count.assign(1, 0);
        emit_wide(*g_last, *g_wide, 0, 0, leaf_size, 1);
    } else {
        // empty scene: one childless wide root + one degenerate tri block
        g_wide->slot_bmin.assign(24, 0.0f);
        g_wide->slot_bmax.assign(24, -1.0f);
        g_wide->child_base.assign(1, 0);
        g_wide->leaf_base.assign(1, 0);
        g_wide->leaf_count.assign(1, 0);
        g_wide->int_count.assign(1, 0);
        g_wide->order.assign(leaf_size, -1);
        g_wide->max_depth = 1;
    }
    delete g_last;
    g_last = nullptr;
    *order_len = static_cast<int64_t>(g_wide->order.size());
    *max_depth = g_wide->max_depth;
    return static_cast<int64_t>(g_wide->child_base.size());
}

void ptrt_bvh8_fetch(float *slot_bmin, float *slot_bmax, int32_t *child_base,
                     int32_t *leaf_base, int32_t *leaf_count,
                     int32_t *int_count, int64_t *order) {
    if (!g_wide) return;
    std::memcpy(slot_bmin, g_wide->slot_bmin.data(),
                g_wide->slot_bmin.size() * sizeof(float));
    std::memcpy(slot_bmax, g_wide->slot_bmax.data(),
                g_wide->slot_bmax.size() * sizeof(float));
    std::memcpy(child_base, g_wide->child_base.data(),
                g_wide->child_base.size() * sizeof(int32_t));
    std::memcpy(leaf_base, g_wide->leaf_base.data(),
                g_wide->leaf_base.size() * sizeof(int32_t));
    std::memcpy(leaf_count, g_wide->leaf_count.data(),
                g_wide->leaf_count.size() * sizeof(int32_t));
    std::memcpy(int_count, g_wide->int_count.data(),
                g_wide->int_count.size() * sizeof(int32_t));
    std::memcpy(order, g_wide->order.data(),
                g_wide->order.size() * sizeof(int64_t));
    delete g_wide;
    g_wide = nullptr;
}

void ptrt_bvh_fetch(float *bmin, float *bmax, int32_t *leaf_first,
                    int32_t *skip, int64_t *order) {
    if (!g_last) return;
    std::memcpy(bmin, g_last->bmin.data(), g_last->bmin.size() * sizeof(float));
    std::memcpy(bmax, g_last->bmax.data(), g_last->bmax.size() * sizeof(float));
    std::memcpy(leaf_first, g_last->leaf_first.data(),
                g_last->leaf_first.size() * sizeof(int32_t));
    std::memcpy(skip, g_last->skip.data(),
                g_last->skip.size() * sizeof(int32_t));
    std::memcpy(order, g_last->order.data(),
                g_last->order.size() * sizeof(int64_t));
    delete g_last;
    g_last = nullptr;
}

}  // extern "C"
