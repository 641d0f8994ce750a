// Native geometry kernels for the host-side runtime (evaluation + mesh
// post-processing): the port's copy of gs2mesh_tpu native/src/geom_ops.cpp.
// They cover the CPU-bound plumbing the reference delegates to native code
// (Open3D C++, simple-knn CUDA, sklearn KD-trees):
//
//   * greedy_radius_downsample — the DTUeval radius-NN thinning
//     (evaluation/DTU/eval_code/eval.py:86-96) over a uniform grid hash;
//     exact same greedy order/result as the Python loop, ~100x faster.
//   * triangle_clusters — union-find connected-component labeling of
//     triangles sharing vertices (Open3D cluster_connected_triangles
//     equivalent used by tsdf_utils.py:128-131).
//   * nn_distances_grid — nearest-neighbor distances via grid hashing for
//     bounded-radius queries.
//
// Exposed as a plain C ABI consumed through ctypes (no pybind11).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct GridHash {
  // Maps 3-D cells to point-index buckets.
  std::unordered_map<uint64_t, std::vector<int>> cells;
  double inv_cell;
  double origin[3];

  static uint64_t key(int64_t x, int64_t y, int64_t z) {
    // 21 bits per axis, offset to positive.
    const uint64_t B = 1 << 20;
    return (((uint64_t)(x + B)) << 42) | (((uint64_t)(y + B)) << 21) |
           ((uint64_t)(z + B));
  }

  void build(const float* pts, int64_t n, double cell) {
    inv_cell = 1.0 / cell;
    origin[0] = origin[1] = origin[2] = 0.0;
    cells.reserve((size_t)n);
    for (int64_t i = 0; i < n; ++i) {
      int64_t cx = (int64_t)std::floor(pts[3 * i + 0] * inv_cell);
      int64_t cy = (int64_t)std::floor(pts[3 * i + 1] * inv_cell);
      int64_t cz = (int64_t)std::floor(pts[3 * i + 2] * inv_cell);
      cells[key(cx, cy, cz)].push_back((int)i);
    }
  }

  template <typename F>
  void for_neighbors(const float* p, F&& fn) const {
    int64_t cx = (int64_t)std::floor(p[0] * inv_cell);
    int64_t cy = (int64_t)std::floor(p[1] * inv_cell);
    int64_t cz = (int64_t)std::floor(p[2] * inv_cell);
    for (int64_t dx = -1; dx <= 1; ++dx)
      for (int64_t dy = -1; dy <= 1; ++dy)
        for (int64_t dz = -1; dz <= 1; ++dz) {
          auto it = cells.find(key(cx + dx, cy + dy, cz + dz));
          if (it == cells.end()) continue;
          for (int j : it->second) fn(j);
        }
  }
};

struct UnionFind {
  std::vector<int64_t> parent;
  explicit UnionFind(int64_t n) : parent(n) {
    for (int64_t i = 0; i < n; ++i) parent[i] = i;
  }
  int64_t find(int64_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  void unite(int64_t a, int64_t b) {
    a = find(a);
    b = find(b);
    if (a != b) parent[b] = a;
  }
};

}  // namespace

extern "C" {

// Greedy radius thinning in the provided point order; writes 0/1 mask.
void greedy_radius_downsample(const float* pts, int64_t n, float radius,
                              uint8_t* mask) {
  GridHash grid;
  grid.build(pts, n, radius);
  const double r2 = (double)radius * radius;
  std::memset(mask, 1, (size_t)n);
  std::vector<uint8_t> suppressed((size_t)n, 0);
  for (int64_t i = 0; i < n; ++i) {
    if (suppressed[i]) {
      mask[i] = 0;
      continue;
    }
    // keep i; suppress every neighbor within radius (incl. later ones)
    const float* p = pts + 3 * i;
    grid.for_neighbors(p, [&](int j) {
      if (j == (int)i) return;
      double dx = (double)p[0] - pts[3 * j + 0];
      double dy = (double)p[1] - pts[3 * j + 1];
      double dz = (double)p[2] - pts[3 * j + 2];
      if (dx * dx + dy * dy + dz * dz <= r2) suppressed[j] = 1;
    });
    mask[i] = 1;
  }
}

// Union-find triangle clustering; labels (F,) get dense cluster ids ordered
// by first appearance, counts_out (F,) receives per-cluster triangle counts
// in label order; returns the number of clusters.
int64_t triangle_clusters(const int32_t* faces, int64_t num_faces,
                          int64_t num_vertices, int64_t* labels,
                          int64_t* counts_out) {
  UnionFind uf(num_vertices);
  for (int64_t f = 0; f < num_faces; ++f) {
    uf.unite(faces[3 * f + 0], faces[3 * f + 1]);
    uf.unite(faces[3 * f + 0], faces[3 * f + 2]);
  }
  std::unordered_map<int64_t, int64_t> dense;
  dense.reserve((size_t)num_faces);
  int64_t next = 0;
  for (int64_t f = 0; f < num_faces; ++f) {
    int64_t root = uf.find(faces[3 * f]);
    auto it = dense.find(root);
    if (it == dense.end()) {
      it = dense.emplace(root, next++).first;
    }
    labels[f] = it->second;
    counts_out[it->second] += 1;
  }
  return next;
}

// For each query point, squared distance to the nearest reference point
// within `radius` (grid-bounded); +inf (HUGE_VAL) when none.
void nn_sq_distances_grid(const float* ref, int64_t n_ref, const float* query,
                          int64_t n_query, float radius, double* out) {
  GridHash grid;
  grid.build(ref, n_ref, radius);
  const double r2 = (double)radius * radius;
  for (int64_t i = 0; i < n_query; ++i) {
    const float* p = query + 3 * i;
    double best = HUGE_VAL;
    grid.for_neighbors(p, [&](int j) {
      double dx = (double)p[0] - ref[3 * j + 0];
      double dy = (double)p[1] - ref[3 * j + 1];
      double dz = (double)p[2] - ref[3 * j + 2];
      double d2 = dx * dx + dy * dy + dz * dz;
      if (d2 < best && d2 <= r2) best = d2;
    });
    out[i] = best;
  }
}

}  // extern "C"
