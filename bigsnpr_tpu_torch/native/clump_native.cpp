// Greedy LD clumping in rank order over a conflict graph, in O(m + E).
//
// The JAX package decides keep / prune by a fixed point on the conflict
// graph (bigsnpr_tpu/ops/clumping.py::_greedy_fixed_point): a variant is
// decided once all its higher-priority neighbours are, kept iff none of
// them was kept. That is the sequential greedy of the reference
// (src/clumping.cpp): walk the variants in rank order, keep one iff no
// already-kept higher-priority neighbour conflicts with it. Here that walk
// is done directly: the higher-priority neighbours of every variant in CSR
// form (two counting passes over the edges), then one pass in rank order.
// The keep set is the fixed point's exactly; the cost is linear where each
// round of the fixed point passes over every edge.
//
// C interface for ctypes. Returns 0 on success, 1 if an edge joins a
// variant to itself (the fixed point stalls on it), 2 if an index or a
// rank is out of range or the ranks are not a permutation.

#include <cstdint>
#include <vector>

extern "C" int clump_greedy(int64_t m, const int64_t* rank, int64_t E,
                            const int64_t* ei, const int64_t* ej,
                            uint8_t* keep) {
  std::vector<int64_t> order(m, -1);
  for (int64_t j = 0; j < m; ++j) {
    const int64_t r = rank[j];
    if (r < 0 || r >= m || order[r] != -1) return 2;
    order[r] = j;
  }
  std::vector<int64_t> start(m + 1, 0);
  for (int64_t e = 0; e < E; ++e) {
    const int64_t a = ei[e], b = ej[e];
    if (a < 0 || a >= m || b < 0 || b >= m) return 2;
    if (a == b) return 1;
    ++start[(rank[a] > rank[b] ? a : b) + 1];   // the lower-priority end
  }
  for (int64_t j = 0; j < m; ++j) start[j + 1] += start[j];
  std::vector<int64_t> fill(start.begin(), start.end() - 1);
  std::vector<int64_t> higher(E > 0 ? E : 1);
  for (int64_t e = 0; e < E; ++e) {
    const int64_t a = ei[e], b = ej[e];
    const bool a_hi = rank[a] < rank[b];
    higher[fill[a_hi ? b : a]++] = a_hi ? a : b;
  }
  for (int64_t r = 0; r < m; ++r) {
    const int64_t j = order[r];
    uint8_t k = 1;
    for (int64_t q = start[j]; q < start[j + 1]; ++q) {
      if (keep[higher[q]]) {
        k = 0;
        break;
      }
    }
    keep[j] = k;
  }
  return 0;
}
