// Native binned-SAH BVH builder.
//
// The host-side hot spot of scene compilation: the reference builds its
// BVH in C (src/render/bvh.c bvh_construct, SAH binning bvh.c:1329/1572/
// 1231); this is the same algorithm re-written for the skip-link flat
// layout that the wavefront traversal consumes (lucille_tpu/accel/bvh.py
// documents the layout).  Exposed through a plain C ABI for ctypes; the
// NumPy builder remains as a pure-Python fallback with identical output
// semantics (tests assert both produce valid, equivalent trees).
//
// Build:  g++ -O3 -march=native -shared -fPIC -o libbvh.so bvh_builder.cpp
// (lucille_tpu.native compiles this on demand and caches the .so)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int NBINS = 16;

struct Vec3 {
    float x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct BBox {
    Vec3 mn{1e30f, 1e30f, 1e30f};
    Vec3 mx{-1e30f, -1e30f, -1e30f};
    void grow(const BBox &o) {
        mn = vmin(mn, o.mn);
        mx = vmax(mx, o.mx);
    }
    void grow(const Vec3 &p) {
        mn = vmin(mn, p);
        mx = vmax(mx, p);
    }
    float area() const {
        float dx = std::max(mx.x - mn.x, 0.f);
        float dy = std::max(mx.y - mn.y, 0.f);
        float dz = std::max(mx.z - mn.z, 0.f);
        return dx * dy + dy * dz + dz * dx;
    }
};

struct Builder {
    const float *v0, *v1, *v2;
    int leaf_size;
    std::vector<BBox> tbox;
    std::vector<Vec3> centroid;
    // outputs
    std::vector<float> bbmin, bbmax;
    std::vector<int> skip, first, count;
    std::vector<int64_t> order;
    int out_pos = 0;

    int emit(const BBox &b, int f, int c) {
        bbmin.push_back(b.mn.x);
        bbmin.push_back(b.mn.y);
        bbmin.push_back(b.mn.z);
        bbmax.push_back(b.mx.x);
        bbmax.push_back(b.mx.y);
        bbmax.push_back(b.mx.z);
        skip.push_back(-1);
        first.push_back(f);
        count.push_back(c);
        return (int)count.size() - 1;
    }

    // returns node index; fills subtree recursively (explicit stack not
    // needed: depth is O(log n) for SAH/median splits)
    int build(std::vector<int64_t> &idx, int lo, int hi) {
        BBox bounds;
        for (int i = lo; i < hi; i++) bounds.grow(tbox[idx[i]]);
        int n = hi - lo;
        if (n <= leaf_size) {
            int node = emit(bounds, out_pos, n);
            for (int i = lo; i < hi; i++) order[out_pos++] = idx[i];
            return node;
        }

        // centroid bounds + widest axis
        BBox cb;
        for (int i = lo; i < hi; i++) cb.grow(centroid[idx[i]]);
        float ext[3] = {cb.mx.x - cb.mn.x, cb.mx.y - cb.mn.y,
                        cb.mx.z - cb.mn.z};
        int axis = 0;
        if (ext[1] > ext[axis]) axis = 1;
        if (ext[2] > ext[axis]) axis = 2;

        int mid = -1;
        if (ext[axis] > 1e-12f) {
            // binned SAH (bvh.c bin_triangle_edge / find_cut_from_bin)
            float cmin = axis == 0 ? cb.mn.x : (axis == 1 ? cb.mn.y : cb.mn.z);
            float scale = NBINS * (1.0f - 1e-6f) / ext[axis];
            int cnt[NBINS] = {0};
            BBox bins[NBINS];
            auto bin_of = [&](int64_t t) {
                const Vec3 &c = centroid[t];
                float v = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
                int b = (int)((v - cmin) * scale);
                return std::min(std::max(b, 0), NBINS - 1);
            };
            for (int i = lo; i < hi; i++) {
                int b = bin_of(idx[i]);
                cnt[b]++;
                bins[b].grow(tbox[idx[i]]);
            }
            // prefix/suffix sweep
            float la[NBINS], ra[NBINS];
            int lc[NBINS], rc[NBINS];
            {
                BBox acc;
                int c = 0;
                for (int b = 0; b < NBINS; b++) {
                    acc.grow(bins[b]);
                    c += cnt[b];
                    la[b] = acc.area();
                    lc[b] = c;
                }
            }
            {
                BBox acc;
                int c = 0;
                for (int b = NBINS - 1; b >= 0; b--) {
                    acc.grow(bins[b]);
                    c += cnt[b];
                    ra[b] = acc.area();
                    rc[b] = c;
                }
            }
            float best = 1e30f;
            int bestk = -1;
            for (int k = 0; k < NBINS - 1; k++) {
                if (lc[k] == 0 || rc[k + 1] == 0) continue;
                float cost = la[k] * lc[k] + ra[k + 1] * rc[k + 1];
                if (cost < best) {
                    best = cost;
                    bestk = k;
                }
            }
            if (bestk >= 0) {
                auto it = std::partition(
                    idx.begin() + lo, idx.begin() + hi,
                    [&](int64_t t) { return bin_of(t) <= bestk; });
                mid = (int)(it - idx.begin());
                if (mid == lo || mid == hi) mid = -1;
            }
        }
        if (mid < 0) {
            // median fallback on the widest axis
            mid = lo + n / 2;
            std::nth_element(
                idx.begin() + lo, idx.begin() + mid, idx.begin() + hi,
                [&](int64_t a, int64_t b) {
                    const Vec3 &ca = centroid[a];
                    const Vec3 &cb2 = centroid[b];
                    float va = axis == 0 ? ca.x : (axis == 1 ? ca.y : ca.z);
                    float vb = axis == 0 ? cb2.x : (axis == 1 ? cb2.y : cb2.z);
                    return va < vb;
                });
        }

        int node = emit(bounds, 0, 0);
        build(idx, lo, mid);
        build(idx, mid, hi);
        return node;
    }
};

}  // namespace

extern "C" {

// Returns the number of nodes written, or -1 on error.  Output buffers
// must hold at least 2*n_tris nodes (bbmin/bbmax: 3 floats per node).
int lucille_build_bvh(const float *v0, const float *v1, const float *v2,
                      int64_t n_tris, int leaf_size, float *bbmin_out,
                      float *bbmax_out, int32_t *skip_out, int32_t *first_out,
                      int32_t *count_out, int64_t *order_out) {
    if (n_tris <= 0 || leaf_size <= 0) return -1;
    Builder b;
    b.v0 = v0;
    b.v1 = v1;
    b.v2 = v2;
    b.leaf_size = leaf_size;
    b.tbox.resize(n_tris);
    b.centroid.resize(n_tris);
    for (int64_t i = 0; i < n_tris; i++) {
        Vec3 a{v0[3 * i], v0[3 * i + 1], v0[3 * i + 2]};
        Vec3 c{v1[3 * i], v1[3 * i + 1], v1[3 * i + 2]};
        Vec3 d{v2[3 * i], v2[3 * i + 1], v2[3 * i + 2]};
        BBox box;
        box.grow(a);
        box.grow(c);
        box.grow(d);
        b.tbox[i] = box;
        b.centroid[i] = {0.5f * (box.mn.x + box.mx.x),
                         0.5f * (box.mn.y + box.mx.y),
                         0.5f * (box.mn.z + box.mx.z)};
    }
    b.order.resize(n_tris);
    std::vector<int64_t> idx(n_tris);
    for (int64_t i = 0; i < n_tris; i++) idx[i] = i;
    b.build(idx, 0, (int)n_tris);

    int m = (int)b.count.size();
    // patch skip links: end[i] = index just past i's subtree (DFS order)
    std::vector<int32_t> end(m);
    for (int i = m - 1; i >= 0; i--) {
        if (b.count[i] > 0) {
            end[i] = i + 1;
        } else {
            int left = i + 1;
            int right = end[left];
            end[i] = end[right];
        }
    }
    std::memcpy(bbmin_out, b.bbmin.data(), sizeof(float) * 3 * m);
    std::memcpy(bbmax_out, b.bbmax.data(), sizeof(float) * 3 * m);
    std::memcpy(first_out, b.first.data(), sizeof(int32_t) * m);
    std::memcpy(count_out, b.count.data(), sizeof(int32_t) * m);
    std::memcpy(order_out, b.order.data(), sizeof(int64_t) * n_tris);
    for (int i = 0; i < m; i++) skip_out[i] = end[i];
    return m;
}
}
