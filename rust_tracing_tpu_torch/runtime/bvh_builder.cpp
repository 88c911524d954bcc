// Native BVH builder: flattened skip-link layout for array traversal.
//
// C++ counterpart of the reference's native (Rust) BVH construction
// (reference: src/bvh.rs:31-66 — random split axis, sort by bbox min,
// median split) emitting the same DFS-preorder skip-link arrays as
// models/bvh.py. Used through ctypes for large scenes where the Python
// builder's per-node overhead dominates scene compile time.
//
// Layout contract (must match models/bvh.py::FlatBVH):
//   node i: [node_min, node_max] AABB;
//   skip[i]: node index to jump to when the box misses (subtree end);
//   prim_type[i]: -1 internal, 0 sphere, 1 quad; prim_idx[i]: SoA index.
//   Total nodes = 2n - 1 for n primitives (1-prim leaves).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Builder {
  const double* box_min;
  const double* box_max;
  const int32_t* prim_type;
  const int32_t* prim_idx;
  double* node_min;
  double* node_max;
  int32_t* skip;
  int32_t* out_type;
  int32_t* out_idx;
  int32_t next_node = 0;
  uint64_t rng_state;

  // xorshift64* — deterministic split-axis stream per seed
  uint32_t rand_axis() {
    uint64_t x = rng_state;
    x ^= x >> 12;
    x ^= x << 25;
    x ^= x >> 27;
    rng_state = x;
    return static_cast<uint32_t>((x * 0x2545F4914F6CDD1DULL) >> 61) % 3;
  }

  int32_t emit(const double lo[3], const double hi[3], int32_t ptype,
               int32_t pidx) {
    int32_t id = next_node++;
    std::memcpy(node_min + 3 * id, lo, 3 * sizeof(double));
    std::memcpy(node_max + 3 * id, hi, 3 * sizeof(double));
    skip[id] = -1;
    out_type[id] = ptype;
    out_idx[id] = pidx;
    return id;
  }

  void build(std::vector<int32_t>& order, size_t lo, size_t hi) {
    const size_t n = hi - lo;
    if (n == 1) {
      const int32_t p = order[lo];
      emit(box_min + 3 * p, box_max + 3 * p, prim_type[p], prim_idx[p]);
      return;
    }
    double bmin[3] = {1e300, 1e300, 1e300};
    double bmax[3] = {-1e300, -1e300, -1e300};
    for (size_t k = lo; k < hi; ++k) {
      const int32_t p = order[k];
      for (int c = 0; c < 3; ++c) {
        bmin[c] = std::min(bmin[c], box_min[3 * p + c]);
        bmax[c] = std::max(bmax[c], box_max[3 * p + c]);
      }
    }
    const int32_t me = emit(bmin, bmax, -1, -1);
    const uint32_t axis = rand_axis();
    std::stable_sort(order.begin() + lo, order.begin() + hi,
                     [&](int32_t a, int32_t b) {
                       return box_min[3 * a + axis] < box_min[3 * b + axis];
                     });
    const size_t half = n / 2;
    build(order, lo, lo + half);
    build(order, lo + half, hi);
    skip[me] = next_node;
  }
};

}  // namespace

extern "C" {

// Returns the number of nodes written (2n-1), or -1 on bad input.
int32_t rt_build_bvh(int32_t n, const double* box_min, const double* box_max,
                     const int32_t* prim_type, const int32_t* prim_idx,
                     uint64_t seed, double* node_min, double* node_max,
                     int32_t* skip, int32_t* out_type, int32_t* out_idx) {
  if (n <= 0) return -1;
  Builder b{box_min, box_max, prim_type, prim_idx,
            node_min, node_max, skip, out_type, out_idx};
  b.rng_state = seed * 0x9E3779B97F4A7C15ULL + 0xDEADBEEFCAFEBABEULL;
  std::vector<int32_t> order(n);
  for (int32_t i = 0; i < n; ++i) order[i] = i;
  b.build(order, 0, static_cast<size_t>(n));
  const int32_t total = b.next_node;
  // leaves / unset skips fall through to the next node
  for (int32_t i = 0; i < total; ++i)
    if (skip[i] < 0) skip[i] = i + 1;
  return total;
}

}  // extern "C"
