// One lockstep LDpred2 Gibbs sweep over every LD block and every chain,
// for sm_90a (H100), with a plain C interface for ctypes.
//
// Replaces the TPU kernels K3 `_sweep_kernel` (bigsnpr_tpu/pgs/
// gibbs_pallas.py:37), K4 `_sweep_kernel_mc` (:171) and K5
// `_sweep_kernel_v3` (:302). The three compute one function; their split
// into one chain / chain-batched / width-paneled versions, with the j % 8
// row pre-shift and the lane padding of the bands, exists only for the
// TPU's VMEM budget and Mosaic's alignment rules. Here one kernel takes
// every block of every bucket in one launch, from per-block offset tables.
//
// Per block b and chain c, rows j = 0..rows_b-1 run in order:
//   dotprod = dp[j + W];  res = bh - shrink (dotprod - cb);  C3 = C2 res
//   postp = 1 / (1 + inv_odd_p sqrt1pC1 exp(-C3^2 / C4 / 2))
//   samp = C3 + z sqrt(C4)
//   sampled = postp > u  &&  !(sparse && postp < p)  &&  !(no_jump && samp cb < 0)
//   new_beta = sampled ? samp : 0;  diff = new_beta - cb
//   dp[j .. j + 2W] += diff * band[j, :]
//   h2_inc += diff (2 dps + diff);  gap += sampled ? samp^2 : 0
// with dps = shrink dotprod + (1 - shrink) cb, and outputs
// [new_beta, sampled, postp, C3 postp, dps] written at the variant's
// global index (postp and C3 postp are 0 where the sparse skip fires).
//
// Design (a simple kernel that is right first):
// - one CTA per (LD block, chain tile); each chain's dp for the block
//   (rows + 2W values) lives in dynamic shared memory for the whole sweep;
// - one thread per chain takes the scalar step of the row; the row's
//   2W + 1 band values are read from global memory once per CTA and
//   applied to every chain of the tile; __syncthreads() brackets the AXPY;
// - the next row's band values and per-chain inputs are loaded into
//   registers while the current row runs, so the dependent chain of rows
//   does not wait on global memory;
// - h2_inc and gap are summed per (chain, block) in row order and written
//   as partials; the caller adds the blocks in a fixed order. No float
//   atomics, so launches repeat bit for bit. Built with --fmad=false, the
//   arithmetic rounds as the plain torch twin's separate operations do.
//
// Bound: each chain tile reads the block's band once (bytes), but the
// rows of a block are a chain of dependent steps, so the longest block's
// rows x one step's latency bounds the sweep at these sizes.
//
// The lassosum mode (LASSO = true; entries lassosum_sweep_f32/_f64) runs
// one deterministic lassosum2 coordinate-descent sweep with the same
// skeleton, for the JAX package's `lassosum_cd_blocked`
// (bigsnpr_tpu/pgs/gibbs_blocked.py:1427, XLA there, not Pallas) under its
// vmap over the grid: a "chain" is a grid point (lambda, delta). Per row,
// with lam = pf lambda and dp1 = pf delta + 1:
//   u = bh - (dp[j + W] - cb);  nm = u > 0 ? u - lam : u + lam
//   new = (u nm > 0 ? nm / dp1 : 0) if |u| > lam, else 0
//   shift = new - cb;  dp[j .. j + 2W] += shift * band[j, :]
//   gap += new^2 and df += 1 where new != 0;  maxshift = max(|shift|)
// new is written in place over cb. In float32 the dp update is a fused
// multiply-add (__fmaf_rn), the rounding of the JAX package's CPU
// programs, which contract it inside their scans; in float64 it rounds
// twice, as the rest of the file does under --fmad=false. dp1 rounds twice
// in both (the JAX package computes it outside the scan, uncontracted). A
// grid point whose `active` flag is 0
// (converged or stopped) is left as it is: shift 0, nothing written, its
// partials 0. gap, df and maxshift are per (grid point, block) partials in
// row order, reduced by the caller in block order; no atomics.
//
// The global-dp mode (GDP = true; the entries' `gdp` argument) is the same
// sweep for a block whose dp (rows + 2W values a chain) does not fit in
// shared memory: the unblocked samplers, whose one block holds every
// variant (the JAX package's `_sweep_gibbs` and `lassosum_cd`'s
// `sweep_step`, bigsnpr_tpu/pgs/gibbs.py:28-72, 373-389, XLA lax.scans
// there, not Pallas). Each chain's dp stays in its global arena and is
// updated there in place; the __syncthreads() around the AXPY order the
// CTA's global accesses as they order its shared ones. The caller spreads
// the chains over CTAs (one a CTA), since one block now holds every row.
// At 100,000 variants and W = 500, 30 chains' dp is 12 MB and stays in the
// 50 MB L2; a row's dependent chain now waits on L2 instead of shared
// memory, so the rows x one step's latency bound a sweep, as above.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KMAX = 8;  // band columns a thread holds per row

template <typename T>
struct SweepArgs {
  const T* band;             // flat band arena: block b at blk_band[b], rows x (2W+1)
  const int64_t* blk_band;   // (nblk,) element offset of the block's band
  const int64_t* blk_dp;     // (nblk,) element offset of the block's dp
  const int64_t* blk_gidx;   // (nblk,) offset of the block's slot -> variant table
  const int32_t* blk_rows;   // (nblk,) rows to run
  const int32_t* blk_W;      // (nblk,) half-width W; dp length rows_pad + 2W
  const int32_t* blk_L;      // (nblk,) dp length of the block
  const int32_t* gidx;       // flat slot -> global variant (-1 = pad slot)
  T* dp;                     // (NC, dp_stride), updated in place
  int64_t dp_stride;
  const T* cb;               // (NC, m) current betas
  const T* bh;               // (m,) scaled marginal effects
  const T* C2;               // (NC, m)
  const T* C4;               // (NC, m)
  const T* s1;               // (NC, m) sqrt(1 + C1)
  const T* u;                // (NC, m) uniforms
  const T* z;                // (NC, m) normals
  int64_t m;
  const T* inv_odd_p;        // (NC,)
  const T* p;                // (NC,)
  const uint8_t* sparse;     // (NC,)
  T shrink;
  int no_jump;
  T* out_beta;               // (NC, m)
  uint8_t* out_causal;       // (NC, m)
  T* out_postp;              // (NC, m)
  T* out_binc;               // (NC, m)
  T* out_dps;                // (NC, m)
  T* part_h2;                // (NC, nblk)
  T* part_gap;               // (NC, nblk)
  // lassosum mode
  const T* pf;               // (m,) penalty factors
  const T* lam;              // (NC,) lambda of each grid point
  const T* delta;            // (NC,) delta of each grid point
  const uint8_t* active;     // (NC,) grid points still running
  int32_t* part_df;          // (NC, nblk)
  T* part_ms;                // (NC, nblk)
  int nblk;
  int NC;
  int nct;                   // chains per CTA
  int Ls;                    // shared-memory stride of one chain's dp
};

template <typename T>
struct RowIn {
  T bh, c2, c4, s1, u, z, cb;
  int64_t g;
};

template <typename T>
__device__ __forceinline__ RowIn<T> load_row(const SweepArgs<T>& a,
                                             const int32_t* gidx, int j,
                                             int c) {
  RowIn<T> r;
  r.g = gidx[j];
  if (r.g >= 0) {
    const int64_t o = (int64_t)c * a.m + r.g;
    r.bh = a.bh[r.g];
    r.c2 = a.C2[o];
    r.c4 = a.C4[o];
    r.s1 = a.s1[o];
    r.u = a.u[o];
    r.z = a.z[o];
    r.cb = a.cb[o];
  } else {  // pad slot: inert (never sampled, diff 0)
    r.bh = T(0); r.c2 = T(0); r.c4 = T(1); r.s1 = T(1);
    r.u = T(2); r.z = T(0); r.cb = T(0);
  }
  return r;
}

// a * b + c as the lassosum mode rounds it (ops/gibbs_kernels.py::_mul_add)
__device__ __forceinline__ float lasso_mul_add(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double lasso_mul_add(double a, double b,
                                                double c) {
  return c + a * b;
}

// lassosum mode: one row's inputs; pad slots are inert (bh 0, lam 1,
// dp1 1, cb 0), the JAX package's fill values
template <typename T>
struct LassoIn {
  T bh, lam, dp1, cb;
  int64_t g;
};

template <typename T>
__device__ __forceinline__ LassoIn<T> load_lasso_row(const SweepArgs<T>& a,
                                                     const int32_t* gidx,
                                                     int j, int c, T lam_c,
                                                     T delta_c) {
  LassoIn<T> r;
  r.g = gidx[j];
  if (r.g >= 0) {
    const T pf = a.pf[r.g];
    r.bh = a.bh[r.g];
    r.lam = pf * lam_c;
    r.dp1 = pf * delta_c + T(1);
    r.cb = a.cb[(int64_t)c * a.m + r.g];
  } else {
    r.bh = T(0); r.lam = T(1); r.dp1 = T(1); r.cb = T(0);
  }
  return r;
}

template <typename T, bool LASSO>
struct RowOf {
  using type = RowIn<T>;
};
template <typename T>
struct RowOf<T, true> {
  using type = LassoIn<T>;
};

template <typename T, bool LASSO>
__device__ __forceinline__ typename RowOf<T, LASSO>::type load_in(
    const SweepArgs<T>& a, const int32_t* gidx, int j, int c, T lam_c,
    T delta_c) {
  if constexpr (LASSO) {
    return load_lasso_row(a, gidx, j, c, lam_c, delta_c);
  } else {
    return load_row(a, gidx, j, c);
  }
}

__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }

template <typename T, bool LASSO, bool GDP>
__global__ void gibbs_sweep_kernel(SweepArgs<T> a) {
  const int b = blockIdx.x;
  const int c0 = blockIdx.y * a.nct;
  const int nct = min(a.nct, a.NC - c0);
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int rows = a.blk_rows[b];
  const int W = a.blk_W[b];
  const int wk = 2 * W + 1;
  const int L = a.blk_L[b];
  const T* band = a.band + a.blk_band[b];
  const int32_t* gidx = a.gidx + a.blk_gidx[b];
  const int64_t dp_off = a.blk_dp[b];

  // each chain's dp for the block: in shared memory (nct x Ls), or in
  // place in the global arena in the global-dp mode
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const dp_g = a.dp + (int64_t)c0 * a.dp_stride + dp_off;
  T* const sdp = reinterpret_cast<T*>(smem_raw);
  T* const dpv = GDP ? dp_g : sdp;
  const int64_t ld = GDP ? a.dp_stride : (int64_t)a.Ls;
  T* const sdiff = GDP ? sdp : sdp + (int64_t)a.nct * a.Ls;  // nct

  if (!GDP) {
    for (int t = 0; t < nct; ++t) {
      const T* src = dp_g + (int64_t)t * a.dp_stride;
      for (int i = tid; i < L; i += nthr) sdp[t * a.Ls + i] = src[i];
    }
  }

  const bool scalar = tid < nct;
  const int c = c0 + tid;
  T inv_odd_p = T(0), pc = T(0), lam_c = T(0), delta_c = T(0);
  bool sp = false, live = false;
  if (scalar) {
    if constexpr (LASSO) {
      lam_c = a.lam[c];
      delta_c = a.delta[c];
      live = a.active[c] != 0;
    } else {
      inv_odd_p = a.inv_odd_p[c];
      pc = a.p[c];
      sp = a.sparse[c] != 0;
    }
  }
  const T shrink = a.shrink;
  const T one_m_shrink = T(1) - shrink;
  T h2 = T(0), gap = T(0), ms = T(0);
  int32_t df = 0;

  typename RowOf<T, LASSO>::type cur;
  if (scalar && rows > 0) cur = load_in<T, LASSO>(a, gidx, 0, c, lam_c, delta_c);
  T bcur[KMAX];
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    const int d = tid + k * nthr;
    bcur[k] = (rows > 0 && d < wk) ? band[d] : T(0);
  }
  __syncthreads();

  for (int j = 0; j < rows; ++j) {
    const bool more = j + 1 < rows;
    typename RowOf<T, LASSO>::type nxt;
    if (scalar && more) nxt = load_in<T, LASSO>(a, gidx, j + 1, c, lam_c, delta_c);
    T bnext[KMAX];
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int d = tid + k * nthr;
      bnext[k] = (more && d < wk) ? band[(int64_t)(j + 1) * wk + d] : T(0);
    }

    if constexpr (LASSO) {
      if (scalar) {
        T diff = T(0);
        if (live) {
          const T dotprod = dpv[tid * ld + j + W];
          const T u = cur.bh - (dotprod - cur.cb);
          const T nm = u > T(0) ? u - cur.lam : u + cur.lam;
          T nb = (u * nm > T(0)) ? nm / cur.dp1 : T(0);
          nb = (abs_t(u) > cur.lam) ? nb : T(0);
          diff = nb - cur.cb;
          if (nb != T(0)) {
            gap = gap + nb * nb;
            ++df;
          }
          const T ad = abs_t(diff);
          if (ad > ms || ad != ad) ms = ad;   // NaN sticks, as torch.maximum
          if (cur.g >= 0) a.out_beta[(int64_t)c * a.m + cur.g] = nb;
        }
        sdiff[tid] = diff;
      }
    } else if (scalar) {
      const T dotprod = dpv[tid * ld + j + W];
      const T res = cur.bh - shrink * (dotprod - cur.cb);
      const T C3 = cur.c2 * res;
      const T postp =
          T(1) / (T(1) + inv_odd_p * cur.s1 *
                             exp_t(-C3 * C3 / cur.c4 * T(0.5)));
      const T samp = C3 + cur.z * sqrt_t(cur.c4);
      const bool sparse_skip = sp && (postp < pc);
      const bool jump = a.no_jump && (samp * cur.cb < T(0));
      const bool sampled = (postp > cur.u) && !sparse_skip && !jump;
      const T new_beta = sampled ? samp : T(0);
      const T dps = shrink * dotprod + one_m_shrink * cur.cb;
      const T diff = new_beta - cur.cb;
      sdiff[tid] = diff;
      h2 = h2 + diff * (T(2) * dps + diff);
      gap = gap + (sampled ? samp * samp : T(0));
      if (cur.g >= 0) {
        const int64_t o = (int64_t)c * a.m + cur.g;
        a.out_beta[o] = new_beta;
        a.out_causal[o] = sampled ? 1 : 0;
        a.out_postp[o] = sparse_skip ? T(0) : postp;
        a.out_binc[o] = sparse_skip ? T(0) : C3 * postp;
        a.out_dps[o] = dps;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
      const int d = tid + k * nthr;
      if (d < wk) {
        const T bv = bcur[k];
        for (int t = 0; t < nct; ++t) {
          T* q = dpv + t * ld + j + d;
          if constexpr (LASSO) {
            *q = lasso_mul_add(sdiff[t], bv, *q);
          } else {
            *q = *q + sdiff[t] * bv;
          }
        }
      }
    }
    __syncthreads();
    if (scalar && more) cur = nxt;
#pragma unroll
    for (int k = 0; k < KMAX; ++k) bcur[k] = bnext[k];
  }

  if (!GDP) {
    for (int t = 0; t < nct; ++t) {
      T* dst = dp_g + (int64_t)t * a.dp_stride;
      for (int i = tid; i < L; i += nthr) dst[i] = sdp[t * a.Ls + i];
    }
  }
  if (scalar) {
    const int64_t o = (int64_t)c * a.nblk + b;
    a.part_gap[o] = gap;
    if constexpr (LASSO) {
      a.part_df[o] = df;
      a.part_ms[o] = ms;
    } else {
      a.part_h2[o] = h2;
    }
  }
}

template <typename T, bool LASSO, bool GDP>
int launch_mode(const SweepArgs<T>& a, int threads, void* stream) {
  const size_t smem =
      ((GDP ? 0 : (size_t)a.nct * a.Ls) + (size_t)a.nct) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      gibbs_sweep_kernel<T, LASSO, GDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(a.nblk, (a.NC + a.nct - 1) / a.nct);
  gibbs_sweep_kernel<T, LASSO, GDP>
      <<<grid, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool LASSO>
int launch_args(const SweepArgs<T>& a, int threads, int gdp, void* stream) {
  if (a.nblk <= 0 || a.NC <= 0) return 0;
  if (a.nct < 1 || threads < a.nct || threads > 1024 || threads % 32) {
    return (int)cudaErrorInvalidValue;
  }
  return gdp ? launch_mode<T, LASSO, true>(a, threads, stream)
             : launch_mode<T, LASSO, false>(a, threads, stream);
}

template <typename T>
int launch(const T* band, const int64_t* blk_band, const int64_t* blk_dp,
           const int64_t* blk_gidx, const int32_t* blk_rows,
           const int32_t* blk_W, const int32_t* blk_L, int nblk,
           const int32_t* gidx, T* dp, int64_t dp_stride, const T* cb,
           const T* bh, const T* C2, const T* C4, const T* s1, const T* u,
           const T* z, int64_t m, const T* inv_odd_p, const T* p,
           const uint8_t* sparse, double shrink, int no_jump, T* out_beta,
           uint8_t* out_causal, T* out_postp, T* out_binc, T* out_dps,
           T* part_h2, T* part_gap, int NC, int nct, int Ls, int threads,
           int gdp, void* stream) {
  SweepArgs<T> a{band, blk_band, blk_dp, blk_gidx, blk_rows, blk_W, blk_L,
                 gidx, dp, dp_stride, cb, bh, C2, C4, s1, u, z, m,
                 inv_odd_p, p, sparse, (T)shrink, no_jump, out_beta,
                 out_causal, out_postp, out_binc, out_dps, part_h2, part_gap,
                 nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nblk, NC, nct, Ls};
  return launch_args<T, false>(a, threads, gdp, stream);
}

template <typename T>
int launch_lasso(const T* band, const int64_t* blk_band, const int64_t* blk_dp,
                 const int64_t* blk_gidx, const int32_t* blk_rows,
                 const int32_t* blk_W, const int32_t* blk_L, int nblk,
                 const int32_t* gidx, T* dp, int64_t dp_stride, T* beta,
                 const T* bh, const T* pf, int64_t m, const T* lam,
                 const T* delta, const uint8_t* active, T* part_gap,
                 int32_t* part_df, T* part_ms, int NC, int nct, int Ls,
                 int threads, int gdp, void* stream) {
  SweepArgs<T> a{band, blk_band, blk_dp, blk_gidx, blk_rows, blk_W, blk_L,
                 gidx, dp, dp_stride, beta, bh, nullptr, nullptr, nullptr,
                 nullptr, nullptr, m, nullptr, nullptr, nullptr, T(1), 0,
                 beta, nullptr, nullptr, nullptr, nullptr, nullptr, part_gap,
                 pf, lam, delta, active, part_df, part_ms,
                 nblk, NC, nct, Ls};
  return launch_args<T, true>(a, threads, gdp, stream);
}

}  // namespace

#define SWEEP_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(                                                       \
      const T* band, const int64_t* blk_band, const int64_t* blk_dp,         \
      const int64_t* blk_gidx, const int32_t* blk_rows, const int32_t* blk_W, \
      const int32_t* blk_L, int nblk, const int32_t* gidx, T* dp,            \
      int64_t dp_stride, const T* cb, const T* bh, const T* C2, const T* C4, \
      const T* s1, const T* u, const T* z, int64_t m, const T* inv_odd_p,    \
      const T* p, const uint8_t* sparse, double shrink, int no_jump,         \
      T* out_beta, uint8_t* out_causal, T* out_postp, T* out_binc,           \
      T* out_dps, T* part_h2, T* part_gap, int NC, int nct, int Ls,          \
      int threads, int gdp, void* stream) {                                  \
    return launch<T>(band, blk_band, blk_dp, blk_gidx, blk_rows, blk_W,      \
                     blk_L, nblk, gidx, dp, dp_stride, cb, bh, C2, C4, s1,   \
                     u, z, m, inv_odd_p, p, sparse, shrink, no_jump,         \
                     out_beta, out_causal, out_postp, out_binc, out_dps,     \
                     part_h2, part_gap, NC, nct, Ls, threads, gdp, stream);  \
  }

SWEEP_ENTRY(gibbs_sweep_f32, float)
SWEEP_ENTRY(gibbs_sweep_f64, double)

// the lassosum mode: beta (NC, m) is read as cb and updated in place
#define LASSO_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(                                                       \
      const T* band, const int64_t* blk_band, const int64_t* blk_dp,         \
      const int64_t* blk_gidx, const int32_t* blk_rows, const int32_t* blk_W, \
      const int32_t* blk_L, int nblk, const int32_t* gidx, T* dp,            \
      int64_t dp_stride, T* beta, const T* bh, const T* pf, int64_t m,       \
      const T* lam, const T* delta, const uint8_t* active, T* part_gap,      \
      int32_t* part_df, T* part_ms, int NC, int nct, int Ls, int threads,    \
      int gdp, void* stream) {                                               \
    return launch_lasso<T>(band, blk_band, blk_dp, blk_gidx, blk_rows,       \
                           blk_W, blk_L, nblk, gidx, dp, dp_stride, beta, bh, \
                           pf, m, lam, delta, active, part_gap, part_df,     \
                           part_ms, NC, nct, Ls, threads, gdp, stream);      \
  }

LASSO_ENTRY(lassosum_sweep_f32, float)
LASSO_ENTRY(lassosum_sweep_f64, double)

// the largest dynamic shared memory a block may use on this device
extern "C" int gibbs_sweep_max_smem(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return -1;
  }
  return v;
}
