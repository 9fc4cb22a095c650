// Binned-SAH BVH builder (native component).
//
// The reference delegates acceleration-structure construction to Embree
// (rtcCommitScene with RTC_BUILD_QUALITY_HIGH, src/scene.cpp:20-27). This
// is the from-scratch replacement: a standard 16-bin surface-area-
// heuristic top-down builder producing the *threaded* (preorder +
// skip-link) node layout the device traversal consumes directly.
//
// Exposed as a C ABI for ctypes; a numpy Morton/median builder
// (lajolla_tpu/ops/bvh.py) is the fallback when this library isn't
// compiled.
//
// Build: make -C csrc   (produces libbvh.so)

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
    Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
    Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
    void grow(const AABB &o) {
        lo = vmin(lo, o.lo);
        hi = vmax(hi, o.hi);
    }
    void grow(const Vec3 &p) {
        lo = vmin(lo, p);
        hi = vmax(hi, p);
    }
    float area() const {
        float dx = std::max(hi.x - lo.x, 0.f);
        float dy = std::max(hi.y - lo.y, 0.f);
        float dz = std::max(hi.z - lo.z, 0.f);
        return 2.f * (dx * dy + dy * dz + dz * dx);
    }
};

struct BuildNode {
    AABB box;
    int32_t start = 0, count = 0;  // leaf: range in prim order
    int32_t left = -1, right = -1;
};

constexpr int NUM_BINS = 16;

struct Builder {
    const float *lo;  // (T,3)
    const float *hi;
    int32_t T;
    int leaf_size;
    std::vector<int32_t> prim;       // permutation
    std::vector<AABB> prim_box;
    std::vector<Vec3> centroid;
    std::vector<BuildNode> nodes;

    int32_t build(int32_t start, int32_t count, int depth = 0) {
        BuildNode node;
        for (int32_t i = start; i < start + count; i++)
            node.box.grow(prim_box[prim[i]]);
        node.start = start;
        node.count = count;
        int32_t my_id = (int32_t)nodes.size();
        nodes.push_back(node);

        if (count <= leaf_size) return my_id;
        bool force_median = depth > 60;  // bound recursion depth

        // centroid bounds
        AABB cb;
        for (int32_t i = start; i < start + count; i++)
            cb.grow(centroid[prim[i]]);

        // pick best axis/bin by SAH over 16 bins
        float best_cost = FLT_MAX;
        int best_axis = -1, best_bin = -1;
        for (int axis = 0; axis < 3; axis++) {
            float cmin = axis == 0 ? cb.lo.x : axis == 1 ? cb.lo.y : cb.lo.z;
            float cmax = axis == 0 ? cb.hi.x : axis == 1 ? cb.hi.y : cb.hi.z;
            if (cmax - cmin < 1e-12f) continue;
            float scale = NUM_BINS / (cmax - cmin);
            AABB bins[NUM_BINS];
            int32_t bin_count[NUM_BINS] = {0};
            for (int32_t i = start; i < start + count; i++) {
                const Vec3 &c = centroid[prim[i]];
                float v = axis == 0 ? c.x : axis == 1 ? c.y : c.z;
                int b = std::min(NUM_BINS - 1,
                                 (int)((v - cmin) * scale));
                bins[b].grow(prim_box[prim[i]]);
                bin_count[b]++;
            }
            AABB right_acc;
            float right_area[NUM_BINS];
            int32_t right_cnt[NUM_BINS];
            int32_t acc_cnt = 0;
            for (int b = NUM_BINS - 1; b > 0; b--) {
                right_acc.grow(bins[b]);
                acc_cnt += bin_count[b];
                right_area[b] = right_acc.area();
                right_cnt[b] = acc_cnt;
            }
            AABB left_acc;
            int32_t left_cnt = 0;
            for (int b = 0; b < NUM_BINS - 1; b++) {
                left_acc.grow(bins[b]);
                left_cnt += bin_count[b];
                if (left_cnt == 0 || left_cnt == count) continue;
                float cost = left_acc.area() * left_cnt +
                             right_area[b + 1] * right_cnt[b + 1];
                if (cost < best_cost) {
                    best_cost = cost;
                    best_axis = axis;
                    best_bin = b;
                }
            }
        }

        int32_t mid;
        if (best_axis < 0 || force_median) {
            mid = start + count / 2;  // degenerate: median split
        } else {
            float cmin = best_axis == 0 ? cb.lo.x
                        : best_axis == 1 ? cb.lo.y : cb.lo.z;
            float cmax = best_axis == 0 ? cb.hi.x
                        : best_axis == 1 ? cb.hi.y : cb.hi.z;
            float scale = NUM_BINS / (cmax - cmin);
            auto side = [&](int32_t p) {
                const Vec3 &c = centroid[p];
                float v = best_axis == 0 ? c.x : best_axis == 1 ? c.y : c.z;
                int b = std::min(NUM_BINS - 1, (int)((v - cmin) * scale));
                return b <= best_bin;
            };
            int32_t *first = prim.data() + start;
            int32_t *last = prim.data() + start + count;
            int32_t *m = std::partition(first, last, side);
            mid = (int32_t)(m - prim.data());
            if (mid == start || mid == start + count)
                mid = start + count / 2;
        }

        int32_t l = build(start, mid - start, depth + 1);
        int32_t r = build(mid, start + count - mid, depth + 1);
        nodes[my_id].left = l;
        nodes[my_id].right = r;
        nodes[my_id].count = 0;
        return my_id;
    }
};

// preorder threading
static void thread_nodes(const std::vector<BuildNode> &nodes, int32_t root,
                         float *out_lo, float *out_hi, int32_t *out_first,
                         int32_t *out_count, int32_t *out_skip,
                         int32_t n_nodes) {
    // iterative preorder with explicit (node, skip) stack
    std::vector<std::pair<int32_t, int32_t>> stack;
    stack.push_back({root, n_nodes});
    int32_t idx = 0;
    while (!stack.empty()) {
        auto [n, skip] = stack.back();
        stack.pop_back();
        const BuildNode &node = nodes[n];
        out_lo[idx * 3 + 0] = node.box.lo.x;
        out_lo[idx * 3 + 1] = node.box.lo.y;
        out_lo[idx * 3 + 2] = node.box.lo.z;
        out_hi[idx * 3 + 0] = node.box.hi.x;
        out_hi[idx * 3 + 1] = node.box.hi.y;
        out_hi[idx * 3 + 2] = node.box.hi.z;
        out_skip[idx] = skip;
        if (node.count > 0) {
            out_first[idx] = node.start;
            out_count[idx] = node.count;
        } else {
            out_first[idx] = idx + 1;  // preorder: left child follows
            out_count[idx] = 0;
            // push right with parent's skip, then left with skip = right's
            // preorder index (unknown yet). Handle by two-pass: compute
            // subtree sizes.
            // Simpler: recompute using subtree size stored in out_first of
            // right... we instead push with placeholder and fix below.
            stack.push_back({node.right, skip});
            stack.push_back({node.left, -1});  // placeholder, fixed after
        }
        idx++;
    }
    // Fix left-child skip links: a left child's skip is its right sibling's
    // preorder index. Recompute via subtree sizes.
    // subtree size in preorder = (skip - index) when skip was correct; for
    // placeholder (-1) entries we derive: left child at index i has parent
    // skip semantics: its subtree spans [i, j) where j = sibling index.
    // We recompute all skips with a second pass over the preorder layout:
    // out_count/out_first give structure.
    std::vector<int32_t> size(n_nodes, 1);
    for (int32_t i = n_nodes - 1; i >= 0; i--) {
        if (out_count[i] == 0) {
            int32_t l = i + 1;
            int32_t r = l + size[l];
            size[i] = 1 + size[l] + size[r];
        }
    }
    std::vector<std::pair<int32_t, int32_t>> st2;
    st2.push_back({0, n_nodes});
    while (!st2.empty()) {
        auto [i, skip] = st2.back();
        st2.pop_back();
        out_skip[i] = skip;
        if (out_count[i] == 0) {
            int32_t l = i + 1;
            int32_t r = l + size[l];
            st2.push_back({r, skip});
            st2.push_back({l, r});
        }
    }
}

}  // namespace

extern "C" {

// Returns number of nodes; fills prim (T), and node arrays sized by a
// prior call contract: caller passes buffers of capacity 2*T.
int32_t bvh_build_sah(const float *tri_lo, const float *tri_hi, int32_t T,
                      int32_t leaf_size, int32_t *prim_out, float *lo_out,
                      float *hi_out, int32_t *first_out, int32_t *count_out,
                      int32_t *skip_out) {
    Builder b;
    b.lo = tri_lo;
    b.hi = tri_hi;
    b.T = T;
    b.leaf_size = leaf_size;
    b.prim.resize(T);
    b.prim_box.resize(T);
    b.centroid.resize(T);
    for (int32_t i = 0; i < T; i++) {
        b.prim[i] = i;
        AABB box;
        box.lo = {tri_lo[i * 3], tri_lo[i * 3 + 1], tri_lo[i * 3 + 2]};
        box.hi = {tri_hi[i * 3], tri_hi[i * 3 + 1], tri_hi[i * 3 + 2]};
        b.prim_box[i] = box;
        b.centroid[i] = {(box.lo.x + box.hi.x) * 0.5f,
                         (box.lo.y + box.hi.y) * 0.5f,
                         (box.lo.z + box.hi.z) * 0.5f};
    }
    b.nodes.reserve(2 * T);
    b.build(0, T);
    int32_t n = (int32_t)b.nodes.size();
    thread_nodes(b.nodes, 0, lo_out, hi_out, first_out, count_out, skip_out,
                 n);
    std::memcpy(prim_out, b.prim.data(), sizeof(int32_t) * T);
    return n;
}

}  // extern "C"
