// Binned-SAH BVH build on the host (C++), emitting the skip-link FlatBVH
// layout: a copy of the SAH section of tpurt/native/src/tpurt_native.cpp,
// so that the port builds the same trees without importing tpurt.
//
// Build: see tpurt_torch/native/__init__.py
// (g++ -O3 -march=native -std=c++17 -shared -fPIC, into tpurt_torch/_build).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// -------------------------------------------------------------- SAH build --

namespace {

constexpr int kBins = 16;

struct BuildCtx {
    const float* amin;
    const float* amax;
    std::vector<float> cent;   // (n,3)
    int32_t* order;
    int max_leaf;
    // output arrays (capacity 2n)
    float* node_min;
    float* node_max;
    int32_t* entry;
    int32_t* skip;
    int32_t* first;
    int32_t* count;
    std::vector<int32_t> subtree_end;
    int32_t n_nodes = 0;
};

static inline float half_area(const float* mn, const float* mx) {
    float dx = std::max(mx[0] - mn[0], 0.0f);
    float dy = std::max(mx[1] - mn[1], 0.0f);
    float dz = std::max(mx[2] - mn[2], 0.0f);
    return dx * dy + dy * dz + dz * dx;
}

static void build_range(BuildCtx& c, int32_t lo, int32_t hi) {
    int32_t node = c.n_nodes++;
    float bmin[3] = {3e38f, 3e38f, 3e38f};
    float bmax[3] = {-3e38f, -3e38f, -3e38f};
    float cmin[3] = {3e38f, 3e38f, 3e38f};
    float cmax[3] = {-3e38f, -3e38f, -3e38f};
    for (int32_t i = lo; i < hi; i++) {
        int32_t t = c.order[i];
        for (int k = 0; k < 3; k++) {
            bmin[k] = std::min(bmin[k], c.amin[t * 3 + k]);
            bmax[k] = std::max(bmax[k], c.amax[t * 3 + k]);
            cmin[k] = std::min(cmin[k], c.cent[t * 3 + k]);
            cmax[k] = std::max(cmax[k], c.cent[t * 3 + k]);
        }
    }
    std::memcpy(c.node_min + node * 3, bmin, 12);
    std::memcpy(c.node_max + node * 3, bmax, 12);
    c.entry[node] = -1;
    c.first[node] = -1;
    c.count[node] = 0;
    c.subtree_end.push_back(0);

    int32_t n = hi - lo;
    if (n <= c.max_leaf) {
        c.first[node] = lo;
        c.count[node] = n;
        c.subtree_end[node] = c.n_nodes;
        return;
    }

    // widest centroid axis
    int axis = 0;
    float ext[3];
    for (int k = 0; k < 3; k++) ext[k] = cmax[k] - cmin[k];
    if (ext[1] > ext[axis]) axis = 1;
    if (ext[2] > ext[axis]) axis = 2;

    int32_t mid = -1;
    if (ext[axis] > 1e-12f) {
        // binned SAH sweep
        float bin_min[kBins][3], bin_max[kBins][3];
        int32_t bin_cnt[kBins] = {0};
        for (int b = 0; b < kBins; b++)
            for (int k = 0; k < 3; k++) { bin_min[b][k] = 3e38f; bin_max[b][k] = -3e38f; }
        float scale = kBins / ext[axis];
        auto bin_of = [&](int32_t t) {
            int b = (int)((c.cent[t * 3 + axis] - cmin[axis]) * scale);
            return std::min(std::max(b, 0), kBins - 1);
        };
        for (int32_t i = lo; i < hi; i++) {
            int32_t t = c.order[i];
            int b = bin_of(t);
            bin_cnt[b]++;
            for (int k = 0; k < 3; k++) {
                bin_min[b][k] = std::min(bin_min[b][k], c.amin[t * 3 + k]);
                bin_max[b][k] = std::max(bin_max[b][k], c.amax[t * 3 + k]);
            }
        }
        // suffix sweep
        float rmin[kBins][3], rmax[kBins][3];
        int32_t rcnt[kBins];
        for (int k = 0; k < 3; k++) { rmin[kBins - 1][k] = bin_min[kBins - 1][k]; rmax[kBins - 1][k] = bin_max[kBins - 1][k]; }
        rcnt[kBins - 1] = bin_cnt[kBins - 1];
        for (int b = kBins - 2; b >= 0; b--) {
            rcnt[b] = rcnt[b + 1] + bin_cnt[b];
            for (int k = 0; k < 3; k++) {
                rmin[b][k] = std::min(bin_min[b][k], rmin[b + 1][k]);
                rmax[b][k] = std::max(bin_max[b][k], rmax[b + 1][k]);
            }
        }
        // prefix sweep + cost
        float lmin[3] = {3e38f, 3e38f, 3e38f}, lmax[3] = {-3e38f, -3e38f, -3e38f};
        int32_t lcnt = 0;
        float best_cost = 3e38f;
        int best_split = -1;
        for (int b = 0; b < kBins - 1; b++) {
            lcnt += bin_cnt[b];
            for (int k = 0; k < 3; k++) {
                lmin[k] = std::min(lmin[k], bin_min[b][k]);
                lmax[k] = std::max(lmax[k], bin_max[b][k]);
            }
            if (lcnt == 0 || rcnt[b + 1] == 0) continue;
            float cost = half_area(lmin, lmax) * lcnt
                         + half_area(rmin[b + 1], rmax[b + 1]) * rcnt[b + 1];
            if (cost < best_cost) { best_cost = cost; best_split = b; }
        }
        if (best_split >= 0) {
            auto pred = [&](int32_t t) { return bin_of(t) <= best_split; };
            int32_t* beg = c.order + lo;
            int32_t* end = c.order + hi;
            int32_t* m = std::partition(beg, end, pred);
            mid = lo + (int32_t)(m - beg);
            if (mid == lo || mid == hi) mid = -1;
        }
    }
    if (mid < 0) {
        // median split on widest axis
        std::nth_element(c.order + lo, c.order + lo + n / 2, c.order + hi,
                         [&](int32_t a, int32_t b) {
                             return c.cent[a * 3 + axis] < c.cent[b * 3 + axis];
                         });
        mid = lo + n / 2;
    }
    c.entry[node] = c.n_nodes;
    build_range(c, lo, mid);
    build_range(c, mid, hi);
    c.subtree_end[node] = c.n_nodes;
}

}  // namespace

// Binned-SAH build over n item AABBs. Output buffers must hold 2n entries
// (3*2n floats for node_min/node_max). Returns the node count.
int32_t tpurt_build_sah(const float* amin, const float* amax, int32_t n,
                        int32_t max_leaf, float* node_min, float* node_max,
                        int32_t* entry, int32_t* skip, int32_t* first,
                        int32_t* count, int32_t* order) {
    if (n <= 0) return 0;
    BuildCtx c;
    c.amin = amin;
    c.amax = amax;
    c.cent.resize((size_t)n * 3);
    for (int64_t i = 0; i < n; i++)
        for (int k = 0; k < 3; k++)
            c.cent[i * 3 + k] = 0.5f * (amin[i * 3 + k] + amax[i * 3 + k]);
    for (int32_t i = 0; i < n; i++) order[i] = i;
    c.order = order;
    c.max_leaf = max_leaf;
    c.node_min = node_min;
    c.node_max = node_max;
    c.entry = entry;
    c.skip = skip;
    c.first = first;
    c.count = count;
    c.subtree_end.reserve((size_t)2 * n);
    build_range(c, 0, n);
    for (int32_t i = 0; i < c.n_nodes; i++)
        skip[i] = (c.subtree_end[i] == c.n_nodes) ? -1 : c.subtree_end[i];
    return c.n_nodes;
}

}  // extern "C"
