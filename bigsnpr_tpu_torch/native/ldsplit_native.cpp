// Native snp_ldsplit table construction + DP (C ABI, loaded via ctypes).
//
// The reference implements this in C++ too (src/split-LD.cpp:16-145):
// get_L builds suffix sums of squared correlations, get_C the DP cost
// tables. The Python fallback in ops/splitld.py is exact but
// interpreter-bound at chromosome scale (per-column loops); these
// kernels reproduce it bit-for-bit (same f32 rounding of E, same f64
// cost arithmetic, same lexicographic (cost, cost2, larger-col)
// tie-breaks) at C++/OpenMP speed.
//
// A copy of bigsnpr_tpu/native/ldsplit_native.cpp for the PyTorch port,
// built with g++ at first use by bigsnpr_tpu_torch/ops/cuda_build.py.
//
// Pipeline (driven from bigsnpr_tpu_torch/ops/splitld.py):
//   1. ldsplit_suffix:   per-column suffix sums of transformed r^2
//   2. ldsplit_entries:  block-cost entries E(row, col) with window /
//                        position / max-cost truncation (count + fill)
//   3. ldsplit_group_rows: counting-sort entries by row (for the DP)
//   4. ldsplit_dp:       the min-cost path tables (C1 row 0 + best)

#include <cstdint>
#include <cstring>
#include <cmath>
#include <limits>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {
const double kInf = std::numeric_limits<double>::infinity();

// L(i, j) = suffix sum of column i at first entry row >= j.
inline double L_lookup(const int64_t* indptr, const int64_t* indices,
                       const double* suff, int64_t i, int64_t j) {
  int64_t lo = indptr[i], hi = indptr[i + 1];
  // binary search for first entry with row >= j
  while (lo < hi) {
    int64_t mid = (lo + hi) / 2;
    if (indices[mid] < j) lo = mid + 1; else hi = mid;
  }
  if (lo == indptr[i + 1]) return 0.0;
  return suff[lo];
}
}  // namespace

extern "C" {

// Per-column suffix sums of transformed r^2 over the strict lower part
// (row > col): r2 < thr_r2 -> 0, r2 > max_r2 -> inf (reference get_L,
// src/split-LD.cpp:16-61). `lower` is CSC with rows ascending per col.
int ldsplit_suffix(const int64_t* indptr, const int64_t* indices,
                   const double* data, int64_t m,
                   double thr_r2, double max_r2, double* suff) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
  for (int64_t col = 0; col < m; col++) {
    double acc = 0.0;
    for (int64_t e = indptr[col + 1] - 1; e >= indptr[col]; e--) {
      if (indices[e] > col) {
        double r2 = data[e] * data[e];
        if (r2 < thr_r2) r2 = 0.0;
        else if (r2 > max_r2) r2 = kInf;
        acc += r2;
      }
      suff[e] = acc;
    }
  }
  return 0;
}

// Block-cost entries: for each col, walk row = col, col-1, ... within
// the max_size window, position constraint pos[row] >= pos[col] - 1,
// accumulating E = sum_i L(i, col+1); stop past max_cost; emit rows
// with block size >= min_size (reference get_C entry loop,
// src/split-LD.cpp:80-113). E is rounded to f32 like the reference's
// float arma::sp_mat storage.
// count_only: fill col_counts only. Otherwise col_offsets gives each
// column's write start in out_{rows,cols,E}.
int ldsplit_entries(const int64_t* indptr, const int64_t* indices,
                    const double* suff, int64_t m,
                    int64_t min_size, int64_t max_size, double max_cost,
                    const double* pos_scaled,
                    int count_only, int64_t* col_counts,
                    const int64_t* col_offsets,
                    int32_t* out_rows, int32_t* out_cols, float* out_E) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 16)
#endif
  for (int64_t col = 0; col < m; col++) {
    int64_t window = (max_size < col + 1) ? max_size : (col + 1);
    double acc = 0.0;
    int64_t cnt = 0;
    int64_t base = count_only ? 0 : col_offsets[col];
    double pos_min = pos_scaled[col] - 1.0;
    for (int64_t s = 1; s <= window; s++) {
      int64_t row = col - s + 1;
      if (pos_scaled[row] < pos_min) break;
      acc += L_lookup(indptr, indices, suff, row, col + 1);
      if (acc > max_cost) break;  // covers +inf (forbidden pairs)
      if (s >= min_size) {
        if (!count_only) {
          out_rows[base + cnt] = (int32_t)row;
          out_cols[base + cnt] = (int32_t)col;
          out_E[base + cnt] = (float)acc;
        }
        cnt++;
      }
    }
    col_counts[col] = cnt;
  }
  return 0;
}

// Counting-sort entries by row -> (row_ptr, cols2, E2).
int ldsplit_group_rows(const int32_t* rows, const int32_t* cols,
                       const float* E, int64_t nnz, int64_t m,
                       int64_t* row_ptr, int32_t* cols2, float* E2) {
  std::memset(row_ptr, 0, (m + 1) * sizeof(int64_t));
  for (int64_t e = 0; e < nnz; e++) row_ptr[rows[e] + 1]++;
  for (int64_t r = 0; r < m; r++) row_ptr[r + 1] += row_ptr[r];
  int64_t* cursor = new int64_t[m];
  std::memcpy(cursor, row_ptr, m * sizeof(int64_t));
  for (int64_t e = 0; e < nnz; e++) {
    int64_t p = cursor[rows[e]]++;
    cols2[p] = cols[e];
    E2[p] = E[e];
  }
  delete[] cursor;
  return 0;
}

// DP over k blocks (reference get_C DP, src/split-LD.cpp:115-145).
// Entries grouped by row. Outputs: C1_row0[k] = C1[0, k] and
// best (m x max_K int32 row-major, -1 for NA). Tie-breaks: min cost1,
// then min cost2 (sum of squared sizes), then larger col.
int ldsplit_dp(const int64_t* row_ptr, const int32_t* cols,
               const float* E, int64_t m,
               int64_t min_size, int64_t max_size, int64_t max_K,
               double max_cost, const double* pos_scaled,
               double* C1_row0, int32_t* best) {
  double* C1prev = new double[m];
  double* C2prev = new double[m];
  double* C1cur = new double[m];
  double* C2cur = new double[m];
  for (int64_t i = 0; i < m; i++) C1prev[i] = C2prev[i] = kInf;
  for (int64_t k = 0; k < max_K; k++) C1_row0[k] = kInf;

  // k = 0: single final block [row, m-1]
  double pos_min = pos_scaled[m - 1] - 1.0;
  for (int64_t size = min_size; size <= max_size; size++) {
    int64_t row = m - size;
    if (row < 0 || pos_scaled[row] < pos_min) break;
    best[row * max_K + 0] = (int32_t)m;
    C1prev[row] = 0.0;
    C2prev[row] = (double)size * (double)size;
  }
  C1_row0[0] = C1prev[0];

  for (int64_t k = 1; k < max_K; k++) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 256)
#endif
    for (int64_t row = 0; row < m; row++) {
      double b1 = kInf, b2 = kInf;
      int32_t bcol = -2;
      for (int64_t e = row_ptr[row]; e < row_ptr[row + 1]; e++) {
        int32_t col = cols[e];
        if ((int64_t)col + 1 >= m) continue;  // C1prev[m] == inf
        double c1p = C1prev[col + 1];
        if (!(c1p < kInf)) continue;
        double c1 = (double)E[e] + c1p;
        double sq = (double)(col - row + 1) * (double)(col - row + 1);
        double c2 = sq + C2prev[col + 1];
        if (c1 < b1 || (c1 == b1 && (c2 < b2 || (c2 == b2 && col > bcol)))) {
          b1 = c1;
          b2 = c2;
          bcol = col;
        }
      }
      C1cur[row] = b1;
      C2cur[row] = b2;
      if (b1 < kInf) best[row * max_K + k] = bcol + 1;
    }
    C1_row0[k] = C1cur[0];
    std::swap(C1prev, C1cur);
    std::swap(C2prev, C2cur);
    if (C1_row0[k] > max_cost && C1_row0[k] > C1_row0[k - 1]) break;
  }

  delete[] C1prev;
  delete[] C2prev;
  delete[] C1cur;
  delete[] C2cur;
  return 0;
}

}  // extern "C"
