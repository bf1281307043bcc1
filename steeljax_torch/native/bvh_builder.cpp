// SBVH / binned-SAH BVH builder (C++, exposed via ctypes).
//
// The TPU-native replacement for the Vulkan driver's
// vkBuildAccelerationStructuresKHR with ePreferFastTrace (reference:
// AccelerationStructureManager.cpp:8-17, 62-126) — the one large native
// component the reference got for free.  The driver's fast-trace builds
// are spatial-split (SBVH-class) trees; this builder implements
// Stich-style spatial splits (chopped binning + reference splitting)
// on top of all-axis 16-bin object SAH.  Produces the explicit-node
// format consumed by steeljax.accel:
//
//   nodes[i] = { min.xyz, max.xyz, meta0, meta1 }  (8 floats)
//     internal: meta0 = left child index (right = left + 1), meta1 = 0
//     leaf:     meta0 = first REFERENCE slot, meta1 = reference count
//
// Indices are stored as exact float values (counts < 2^24).  Output is
// a REFERENCE list (refs_out maps output slots to input triangle ids):
// with spatial splits a triangle may appear in several leaves, so the
// list is a gather map, not a permutation — duplicated ids carry
// identical geometry/attributes, and every consumer downstream
// (apply_permutation, pack_tris, shade records) gathers by slot.
// Leaf reference ranges are contiguous by construction (leaves append
// to the output list in creation order).
//
// Spatial splits are attempted when the best object split's child
// overlap exceeds alpha * root surface area (Stich et al. 2009); total
// duplication is bounded by ref_capacity — once the budget is spent,
// straddling references fall back to centroid placement (no split).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
    float operator[](int a) const { return a == 0 ? x : (a == 1 ? y : z); }
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct Box {
    Vec3 lo{3e38f, 3e38f, 3e38f};
    Vec3 hi{-3e38f, -3e38f, -3e38f};
    void grow(const Box& other) {
        lo = vmin(lo, other.lo);
        hi = vmax(hi, other.hi);
    }
    void grow(const Vec3& p) {
        lo = vmin(lo, p);
        hi = vmax(hi, p);
    }
    bool valid() const {
        return lo.x <= hi.x && lo.y <= hi.y && lo.z <= hi.z;
    }
    Box intersect(const Box& o) const {
        return {vmax(lo, o.lo), vmin(hi, o.hi)};
    }
    float half_area() const {
        float dx = std::max(hi.x - lo.x, 0.f);
        float dy = std::max(hi.y - lo.y, 0.f);
        float dz = std::max(hi.z - lo.z, 0.f);
        return dx * dy + dy * dz + dz * dx;
    }
    Vec3 centroid() const {
        return {(lo.x + hi.x) * 0.5f, (lo.y + hi.y) * 0.5f,
                (lo.z + hi.z) * 0.5f};
    }
};

// A build reference: a (possibly clipped) occurrence of a triangle.
struct Ref {
    Box box;
    int64_t id;
};

constexpr int kBins = 16;
constexpr float kBig = 3e38f;

// Bounding box of triangle `id` clipped to axis-slab [lo, hi], further
// intersected with `limit` (the reference's own box — references that
// were already split must not regrow past their half-space).
// Sutherland-Hodgman on the triangle polygon against the two planes.
Box clip_tri_slab(const float* tri, int axis, float lo, float hi,
                  const Box& limit) {
    float poly[8][3], next[8][3];
    int n = 3;
    for (int i = 0; i < 3; ++i)
        for (int c = 0; c < 3; ++c) poly[i][c] = tri[i * 3 + c];
    // Clip against axis >= lo, then axis <= hi.
    for (int pass = 0; pass < 2; ++pass) {
        float plane = pass == 0 ? lo : hi;
        float sign = pass == 0 ? 1.f : -1.f;
        int m = 0;
        for (int i = 0; i < n; ++i) {
            const float* a = poly[i];
            const float* b = poly[(i + 1) % n];
            float da = sign * (a[axis] - plane);
            float db = sign * (b[axis] - plane);
            if (da >= 0.f) {
                for (int c = 0; c < 3; ++c) next[m][c] = a[c];
                ++m;
            }
            if ((da >= 0.f) != (db >= 0.f)) {
                float t = da / (da - db);
                for (int c = 0; c < 3; ++c)
                    next[m][c] = a[c] + t * (b[c] - a[c]);
                ++m;
            }
        }
        n = m;
        for (int i = 0; i < n; ++i)
            for (int c = 0; c < 3; ++c) poly[i][c] = next[i][c];
        if (n == 0) break;
    }
    Box out;
    if (n == 0) return out;  // invalid (empty) box
    for (int i = 0; i < n; ++i)
        out.grow(Vec3{poly[i][0], poly[i][1], poly[i][2]});
    return out.intersect(limit);
}

struct Builder {
    const float* tris;  // (T, 9) vertex positions, for clipping
    std::vector<float> nodes;      // 8 floats per node
    std::vector<int64_t> out_refs; // leaf-contiguous reference list
    int max_leaf;
    float alpha;          // spatial-split overlap threshold (<=0: off)
    float root_area = 1.f;
    int64_t ref_budget;   // max extra references from splitting
    int64_t extra_refs = 0;

    int alloc_node() {
        nodes.resize(nodes.size() + 8, 0.f);
        return static_cast<int>(nodes.size() / 8) - 1;
    }

    void write_node(int idx, const Box& box, float m0, float m1) {
        float* n = &nodes[idx * 8];
        n[0] = box.lo.x; n[1] = box.lo.y; n[2] = box.lo.z;
        n[3] = box.hi.x; n[4] = box.hi.y; n[5] = box.hi.z;
        n[6] = m0; n[7] = m1;
    }

    // Best object split over all 3 axes.  Returns cost (kBig if none);
    // fills axis/bin and the two child boxes for the overlap test, plus
    // the centroid-bounds scale used to re-bin during partition.
    float object_split(const std::vector<Ref>& refs, const Box& cbounds,
                       int* axis_out, int* bin_out, float* lo_out,
                       float* scale_out, Box* lbox, Box* rbox) {
        float best = kBig;
        int64_t count = refs.size();
        for (int axis = 0; axis < 3; ++axis) {
            float lo = cbounds.lo[axis];
            float extent = cbounds.hi[axis] - lo;
            if (extent < 1e-12f) continue;
            float scale = kBins / extent;
            Box bin_box[kBins];
            int64_t bin_count[kBins] = {0};
            for (const Ref& r : refs) {
                float c = r.box.centroid()[axis];
                int b = std::min(std::max(int((c - lo) * scale), 0),
                                 kBins - 1);
                bin_box[b].grow(r.box);
                bin_count[b]++;
            }
            Box right_acc[kBins];
            Box acc;
            for (int b = kBins - 1; b > 0; --b) {
                acc.grow(bin_box[b]);
                right_acc[b] = acc;
            }
            Box left_acc;
            int64_t left_n = 0;
            for (int b = 0; b < kBins - 1; ++b) {
                left_acc.grow(bin_box[b]);
                left_n += bin_count[b];
                int64_t right_n = count - left_n;
                if (left_n == 0 || right_n == 0) continue;
                float cost = left_acc.half_area() * left_n
                           + right_acc[b + 1].half_area() * right_n;
                if (cost < best) {
                    best = cost;
                    *axis_out = axis;
                    *bin_out = b;
                    *lo_out = lo;
                    *scale_out = scale;
                    *lbox = left_acc;
                    *rbox = right_acc[b + 1];
                }
            }
        }
        return best;
    }

    // Best spatial split on the widest axis of `bounds` via chopped
    // binning (Stich et al. 2009 §4.2).  Returns cost (kBig if none);
    // fills axis + plane position.
    float spatial_split(const std::vector<Ref>& refs, const Box& bounds,
                        int* axis_out, float* plane_out) {
        float ex = bounds.hi.x - bounds.lo.x;
        float ey = bounds.hi.y - bounds.lo.y;
        float ez = bounds.hi.z - bounds.lo.z;
        int axis = (ex > ey && ex > ez) ? 0 : (ey > ez ? 1 : 2);
        float lo = bounds.lo[axis];
        float extent = bounds.hi[axis] - lo;
        if (extent < 1e-12f) return kBig;
        float scale = kBins / extent;
        float inv_scale = extent / kBins;

        Box bin_box[kBins];
        int64_t entry[kBins] = {0}, exit_[kBins] = {0};
        for (const Ref& r : refs) {
            int b0 = std::min(std::max(
                int((r.box.lo[axis] - lo) * scale), 0), kBins - 1);
            int b1 = std::min(std::max(
                int((r.box.hi[axis] - lo) * scale), 0), kBins - 1);
            entry[b0]++;
            exit_[b1]++;
            if (b0 == b1) {
                bin_box[b0].grow(r.box);
            } else {
                for (int b = b0; b <= b1; ++b) {
                    Box clipped = clip_tri_slab(
                        tris + r.id * 9, axis, lo + b * inv_scale,
                        lo + (b + 1) * inv_scale, r.box);
                    if (clipped.valid()) bin_box[b].grow(clipped);
                }
            }
        }
        Box right_acc[kBins];
        Box acc;
        for (int b = kBins - 1; b > 0; --b) {
            acc.grow(bin_box[b]);
            right_acc[b] = acc;
        }
        Box left_acc;
        int64_t nl = 0, nr = refs.size();
        float best = kBig;
        for (int b = 0; b < kBins - 1; ++b) {
            left_acc.grow(bin_box[b]);
            nl += entry[b];
            nr -= exit_[b];
            if (nl == 0 || nr == 0) continue;
            float cost = left_acc.half_area() * nl
                       + right_acc[b + 1].half_area() * nr;
            if (cost < best) {
                best = cost;
                *axis_out = axis;
                *plane_out = lo + (b + 1) * inv_scale;
            }
        }
        return best;
    }

    // Build `refs` into node `idx`; returns subtree depth.  Consumes
    // (clears) `refs` before recursing so peak memory stays O(n log n).
    int build(int idx, std::vector<Ref> refs) {
        Box bounds, cbounds;
        for (const Ref& r : refs) {
            bounds.grow(r.box);
            cbounds.grow(r.box.centroid());
        }
        int64_t count = refs.size();
        if (count <= max_leaf) {
            int64_t first = out_refs.size();
            for (const Ref& r : refs) out_refs.push_back(r.id);
            write_node(idx, bounds, float(first), float(count));
            return 1;
        }

        int o_axis = -1, o_bin = -1;
        float o_lo = 0.f, o_scale = 0.f;
        Box o_lbox, o_rbox;
        float c_obj = object_split(refs, cbounds, &o_axis, &o_bin, &o_lo,
                                   &o_scale, &o_lbox, &o_rbox);

        int s_axis = -1;
        float s_plane = 0.f;
        float c_spatial = kBig;
        if (alpha > 0.f && c_obj < kBig && extra_refs < ref_budget) {
            Box overlap = o_lbox.intersect(o_rbox);
            if (overlap.valid()
                && overlap.half_area() > alpha * root_area) {
                c_spatial = spatial_split(refs, bounds, &s_axis, &s_plane);
            }
        }

        std::vector<Ref> left, right;
        left.reserve(count / 2 + 8);
        right.reserve(count / 2 + 8);

        if (c_spatial < c_obj) {
            for (const Ref& r : refs) {
                if (r.box.hi[s_axis] <= s_plane) {
                    left.push_back(r);
                } else if (r.box.lo[s_axis] >= s_plane) {
                    right.push_back(r);
                } else if (extra_refs < ref_budget) {
                    Box lb = clip_tri_slab(tris + r.id * 9, s_axis,
                                           -kBig, s_plane, r.box);
                    Box rb = clip_tri_slab(tris + r.id * 9, s_axis,
                                           s_plane, kBig, r.box);
                    if (lb.valid() && rb.valid()) {
                        left.push_back({lb, r.id});
                        right.push_back({rb, r.id});
                        ++extra_refs;
                    } else if (lb.valid()) {
                        left.push_back({lb, r.id});
                    } else if (rb.valid()) {
                        right.push_back({rb, r.id});
                    } else {  // fully degenerate: place by centroid
                        (r.box.centroid()[s_axis] < s_plane ? left : right)
                            .push_back(r);
                    }
                } else {  // duplication budget spent: no split
                    (r.box.centroid()[s_axis] < s_plane ? left : right)
                        .push_back(r);
                }
            }
            if (left.empty() || right.empty()) {
                left.clear();
                right.clear();
                c_spatial = kBig;  // degenerate: fall through to object
            }
        }

        if (!(c_spatial < c_obj) || (left.empty() && right.empty())) {
            if (c_obj < kBig) {
                for (const Ref& r : refs) {
                    float c = r.box.centroid()[o_axis];
                    int b = std::min(std::max(
                        int((c - o_lo) * o_scale), 0), kBins - 1);
                    (b <= o_bin ? left : right).push_back(r);
                }
            }
            if (left.empty() || right.empty()) {
                // Degenerate centroid cloud: median split.
                left.clear();
                right.clear();
                std::nth_element(
                    refs.begin(), refs.begin() + count / 2, refs.end(),
                    [](const Ref& a, const Ref& b) {
                        return a.box.centroid().x < b.box.centroid().x;
                    });
                left.assign(refs.begin(), refs.begin() + count / 2);
                right.assign(refs.begin() + count / 2, refs.end());
            }
        }
        refs.clear();
        refs.shrink_to_fit();

        int left_idx = alloc_node();
        int right_idx = alloc_node();  // right == left + 1
        write_node(idx, bounds, float(left_idx), 0.f);
        int dl = build(left_idx, std::move(left));
        int dr = build(right_idx, std::move(right));
        return 1 + std::max(dl, dr);
    }
};

}  // namespace

extern "C" {

// SBVH build.  `spatial_alpha` <= 0 disables spatial splits (pure
// all-axis binned object SAH).  refs_out must hold ref_capacity slots;
// actual output count (*ref_count_out) <= ref_capacity is enforced by
// the duplication budget.  nodes_out holds node_capacity * 8 floats.
// Returns 0 on success, 2 on node-capacity overflow.
int steeljax_build_sbvh(const float* tris, int64_t tri_count, int max_leaf,
                        float spatial_alpha,
                        float* nodes_out, int64_t node_capacity,
                        int64_t* refs_out, int64_t ref_capacity,
                        int64_t* node_count_out, int64_t* ref_count_out,
                        int* depth_out) {
    if (tri_count <= 0 || ref_capacity < tri_count) return 1;
    Builder b;
    b.tris = tris;
    b.max_leaf = max_leaf;
    b.alpha = spatial_alpha;
    b.ref_budget = ref_capacity - tri_count;
    b.out_refs.reserve(ref_capacity);

    std::vector<Ref> refs(tri_count);
    Box root_bounds;
    for (int64_t i = 0; i < tri_count; ++i) {
        const float* t = tris + i * 9;
        Ref& r = refs[i];
        r.box.grow(Vec3{t[0], t[1], t[2]});
        r.box.grow(Vec3{t[3], t[4], t[5]});
        r.box.grow(Vec3{t[6], t[7], t[8]});
        r.id = i;
        root_bounds.grow(r.box);
    }
    b.root_area = std::max(root_bounds.half_area(), 1e-20f);
    b.nodes.reserve(
        std::min<int64_t>(node_capacity, 2 * ref_capacity) * 8);

    int root = b.alloc_node();
    int depth = b.build(root, std::move(refs));
    int64_t node_count = static_cast<int64_t>(b.nodes.size() / 8);
    if (node_count > node_capacity) return 2;
    if (static_cast<int64_t>(b.out_refs.size()) > ref_capacity) return 3;
    std::memcpy(nodes_out, b.nodes.data(), b.nodes.size() * sizeof(float));
    std::memcpy(refs_out, b.out_refs.data(),
                b.out_refs.size() * sizeof(int64_t));
    *node_count_out = node_count;
    *ref_count_out = static_cast<int64_t>(b.out_refs.size());
    *depth_out = depth;
    return 0;
}

// Legacy entry (object-only, returns a strict permutation): kept for
// callers that require a permutation; delegates to the SBVH builder
// with spatial splits off (ref_capacity == tri_count => pure SAH).
int steeljax_build_bvh(const float* tris, int64_t tri_count, int max_leaf,
                       float* nodes_out, int64_t node_capacity,
                       int64_t* perm_out, int64_t* node_count_out,
                       int* depth_out) {
    int64_t ref_count = 0;
    return steeljax_build_sbvh(tris, tri_count, max_leaf, 0.f,
                               nodes_out, node_capacity, perm_out,
                               tri_count, node_count_out, &ref_count,
                               depth_out);
}

}  // extern "C"
