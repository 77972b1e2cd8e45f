// Native binned-SAH BVH builder.
//
// Same array contract as raytracingrenderer_tpu/geometry/bvh.py (flat
// depth-first nodes, left child = i+1, `right` = right-child index or -1
// for leaves) — the Python builder is the reference implementation and
// test oracle; this one exists because scene loads for the big scenes
// (bathroom: ~331k triangles, SURVEY.md §2.8) are host-latency bound.
// Mirrors the capability of the reference's BVHNode::build
// (RTBase/Geometry.h:325-398) but with real binned SAH
// instead of sort-per-split.
//
// Build: make -C native   (produces build/libbvh.so; loaded via ctypes)

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxBins = 128;  // bvh_build_q() upper bound
constexpr float kTraverseCost = 1.0f;
constexpr float kTriangleCost = 2.0f;

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
  Vec3 lo{FLT_MAX, FLT_MAX, FLT_MAX};
  Vec3 hi{-FLT_MAX, -FLT_MAX, -FLT_MAX};
  void extend(const AABB& o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
};

struct Builder {
  const float* verts;  // (T, 9)
  int max_leaf;
  int bins = 16;
  bool all_axes = false;  // sweep every axis's bins, take the global best
  std::vector<AABB> tri_box;
  std::vector<Vec3> centroid;
  std::vector<int> order;
  // output node arrays
  std::vector<float> lo, hi;
  std::vector<int> right, start, count;

  int emit(const AABB& b, int r, int s, int c) {
    lo.insert(lo.end(), {b.lo.x, b.lo.y, b.lo.z});
    hi.insert(hi.end(), {b.hi.x, b.hi.y, b.hi.z});
    right.push_back(r);
    start.push_back(s);
    count.push_back(c);
    return static_cast<int>(right.size()) - 1;
  }

  // Build the subtree over order[first, first+n); returns node index.
  int build(int first, int n) {
    AABB bounds;
    Vec3 cmin{FLT_MAX, FLT_MAX, FLT_MAX};
    Vec3 cmax{-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int i = 0; i < n; ++i) {
      int t = order[first + i];
      bounds.extend(tri_box[t]);
      cmin = vmin(cmin, centroid[t]);
      cmax = vmax(cmax, centroid[t]);
    }
    if (n <= max_leaf) return emit(bounds, -1, first, n);

    float ext[3] = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
    float cmin_v[3] = {cmin.x, cmin.y, cmin.z};
    int big = 0;
    if (ext[1] > ext[big]) big = 1;
    if (ext[2] > ext[big]) big = 2;
    // Sweep candidate split axes (just the largest centroid axis by
    // default; all three when all_axes — round 5: -32% global SAH on
    // bathroom, -16% on-chip incoherent traversal,
    // scripts/probe_build_quality.py / probe_build_ab.py).
    const int a0 = all_axes ? 0 : big, a1 = all_axes ? 2 : big;
    int best_axis = -1, best_bin = -1;
    float best_cost = FLT_MAX;
    float inv_root = 1.0f / std::max(bounds.area(), 1e-30f);
    auto cent_of = [&](int t, int axis) {
      return axis == 0 ? centroid[t].x
                       : (axis == 1 ? centroid[t].y : centroid[t].z);
    };
    for (int axis = a0; axis <= a1; ++axis) {
      if (ext[axis] < 1e-12f) continue;
      float inv = bins / ext[axis];
      AABB bin_box[kMaxBins];
      int bin_cnt[kMaxBins] = {0};
      for (int i = 0; i < n; ++i) {
        int t = order[first + i];
        int b = static_cast<int>((cent_of(t, axis) - cmin_v[axis]) * inv);
        b = std::min(std::max(b, 0), bins - 1);
        bin_box[b].extend(tri_box[t]);
        bin_cnt[b]++;
      }
      // prefix/suffix sweeps
      float l_area[kMaxBins - 1], r_area[kMaxBins - 1];
      int l_cnt[kMaxBins - 1], r_cnt[kMaxBins - 1];
      AABB acc;
      int cnt = 0;
      for (int b = 0; b < bins - 1; ++b) {
        acc.extend(bin_box[b]);
        cnt += bin_cnt[b];
        l_area[b] = acc.area();
        l_cnt[b] = cnt;
      }
      acc = AABB();
      cnt = 0;
      for (int b = bins - 1; b >= 1; --b) {
        acc.extend(bin_box[b]);
        cnt += bin_cnt[b];
        r_area[b - 1] = acc.area();
        r_cnt[b - 1] = cnt;
      }
      for (int b = 0; b < bins - 1; ++b) {
        if (l_cnt[b] == 0 || r_cnt[b] == 0) continue;
        float cost = kTraverseCost +
                     kTriangleCost *
                         (l_area[b] * l_cnt[b] + r_area[b] * r_cnt[b]) *
                         inv_root;
        if (cost < best_cost) {
          best_cost = cost;
          best_axis = axis;
          best_bin = b;
        }
      }
    }
    int mid;
    if (best_axis < 0) {
      mid = first + n / 2;  // degenerate: even split
    } else if (best_cost >= kTriangleCost * n && n <= max_leaf) {
      return emit(bounds, -1, first, n);  // leaf cheaper than split
    } else {
      float inv = bins / ext[best_axis];
      float c0 = cmin_v[best_axis];
      auto it = std::partition(
          order.begin() + first, order.begin() + first + n, [&](int t) {
            int b = static_cast<int>((cent_of(t, best_axis) - c0) * inv);
            return std::min(std::max(b, 0), bins - 1) <= best_bin;
          });
      mid = static_cast<int>(it - order.begin());
      if (mid == first || mid == first + n) mid = first + n / 2;
    }
    int node = emit(bounds, 0, 0, 0);  // patched below
    build(first, mid - first);
    int r = build(mid, first + n - mid);
    right[node] = r;
    return node;
  }
};

}  // namespace

extern "C" {

// Returns the node count (<= 2*t_count); caller allocates outputs with
// capacity 2*t_count (nodes) and t_count (order).  bins in [2,128];
// all_axes != 0 sweeps every axis's bins and takes the global best.
int bvh_build_q(const float* tri_verts, int t_count, int max_leaf,
                int bins, int all_axes,
                float* out_lo, float* out_hi, int* out_right,
                int* out_start, int* out_count, int* out_order) {
  if (t_count <= 0) return 0;
  Builder b;
  b.verts = tri_verts;
  b.max_leaf = max_leaf;
  b.bins = std::min(std::max(bins, 2), kMaxBins);
  b.all_axes = all_axes != 0;
  b.tri_box.resize(t_count);
  b.centroid.resize(t_count);
  b.order.resize(t_count);
  for (int t = 0; t < t_count; ++t) {
    const float* v = tri_verts + 9 * t;
    Vec3 p0{v[0], v[1], v[2]}, p1{v[3], v[4], v[5]}, p2{v[6], v[7], v[8]};
    b.tri_box[t].lo = vmin(vmin(p0, p1), p2);
    b.tri_box[t].hi = vmax(vmax(p0, p1), p2);
    b.centroid[t] = {(p0.x + p1.x + p2.x) / 3.f, (p0.y + p1.y + p2.y) / 3.f,
                     (p0.z + p1.z + p2.z) / 3.f};
    b.order[t] = t;
  }
  int n_tri = t_count;
  b.lo.reserve(6 * n_tri);
  b.hi.reserve(6 * n_tri);
  b.build(0, n_tri);
  int n_nodes = static_cast<int>(b.right.size());
  std::memcpy(out_lo, b.lo.data(), sizeof(float) * 3 * n_nodes);
  std::memcpy(out_hi, b.hi.data(), sizeof(float) * 3 * n_nodes);
  std::memcpy(out_right, b.right.data(), sizeof(int) * n_nodes);
  std::memcpy(out_start, b.start.data(), sizeof(int) * n_nodes);
  std::memcpy(out_count, b.count.data(), sizeof(int) * n_nodes);
  std::memcpy(out_order, b.order.data(), sizeof(int) * n_tri);
  return n_nodes;
}

// Walker/Vose alias-table construction for O(1) discrete sampling on
// device (one gather + one compare per sample, where an inverse-CDF
// search takes ~log2(N) dependent gathers).  `p` must be a
// normalized probability vector of length n.  Outputs: prob[i] in [0,1]
// and alias[i] (an index), such that sampling j ~ U{0..n-1}, r ~ U[0,1)
// and picking j if r < prob[j] else alias[j] reproduces p exactly.
void alias_build(const double* p, int n, float* out_prob, int* out_alias) {
  std::vector<double> scaled(n);
  std::vector<int> small_idx, large_idx;
  small_idx.reserve(n);
  large_idx.reserve(n);
  for (int i = 0; i < n; ++i) {
    scaled[i] = p[i] * n;
    out_alias[i] = i;
    if (scaled[i] < 1.0) small_idx.push_back(i);
    else large_idx.push_back(i);
  }
  while (!small_idx.empty() && !large_idx.empty()) {
    int s = small_idx.back(); small_idx.pop_back();
    int l = large_idx.back(); large_idx.pop_back();
    out_prob[s] = static_cast<float>(scaled[s]);
    out_alias[s] = l;
    scaled[l] = (scaled[l] + scaled[s]) - 1.0;
    if (scaled[l] < 1.0) small_idx.push_back(l);
    else large_idx.push_back(l);
  }
  while (!large_idx.empty()) {
    out_prob[large_idx.back()] = 1.0f;
    large_idx.pop_back();
  }
  while (!small_idx.empty()) {  // numerical stragglers
    out_prob[small_idx.back()] = 1.0f;
    small_idx.pop_back();
  }
}
}
