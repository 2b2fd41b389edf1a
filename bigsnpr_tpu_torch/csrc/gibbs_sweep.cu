// One lockstep LDpred2 Gibbs sweep over every LD block and every chain,
// for sm_90a (H100), with a plain C interface for ctypes.
//
// Replaces the TPU kernels K3 `_sweep_kernel` (bigsnpr_tpu/pgs/
// gibbs_pallas.py:37), K4 `_sweep_kernel_mc` (:171) and K5
// `_sweep_kernel_v3` (:302), the JAX package's XLA sweeps of the blocked
// lassosum2 (`lassosum_cd_blocked`, bigsnpr_tpu/pgs/gibbs_blocked.py:1427)
// and of the unblocked samplers (`_sweep_gibbs` and `lassosum_cd`'s
// `sweep_step`, bigsnpr_tpu/pgs/gibbs.py:28-72, 373-389). They compute one
// function; the TPU's split into one chain / chain-batched /
// width-paneled versions, with the j % 8 row pre-shift and the lane
// padding of the bands, exists only for its VMEM budget and Mosaic's
// alignment rules. Here one kernel, `gibbs_ring_kernel`, takes every block
// of every bucket in one launch, from per-block offset tables, whether the
// band is cut into LD blocks or is one block over every variant.
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
// The lassosum mode (LASSO = true; entries lassosum_sweep_f32/_f64) runs
// one deterministic lassosum2 coordinate-descent sweep, a "chain" being a
// grid point (lambda, delta). Per row, with lam = pf lambda and dp1 = pf
// delta + 1:
//   u = bh - (dp[j + W] - cb);  nm = u > 0 ? u - lam : u + lam
//   new = (u nm > 0 ? nm / dp1 : 0) if |u| > lam, else 0
//   shift = new - cb;  dp[j .. j + 2W] += shift * band[j, :]
//   gap += new^2 and df += 1 where new != 0;  maxshift = max(|shift|)
// new is written in place over cb. In float32 the dp update is a fused
// multiply-add (__fmaf_rn), the rounding of the JAX package's CPU
// programs, which contract it inside their scans; in float64 it rounds
// twice, as the rest of the file does under --fmad=false. dp1 rounds twice
// in both (the JAX package computes it outside the scan, uncontracted). A
// grid point whose `active` flag is 0 (converged or stopped) is skipped:
// its dp and beta are not touched, its partials are 0.
//
// Bound. A sweep moves the band once (bytes), but the rows of a block are
// a chain of dependent steps: the longest block's rows x one row's latency
// (the row floor) bounds it, and over all blocks and chains the card's
// issue rate (the (chain, row) pairs' step instructions and the band's
// multiply-adds over 132 SMs x 4 schedulers).
//
// Design. Only 2W + 1 entries of a chain's dp are live at a row: row j
// reads dp[j + W] and updates dp[j .. j + 2W], and no later row of the
// sweep touches dp[j] again. So each chain keeps a ring of its live
// entries in shared memory (`ring` slots, a power of two); device memory
// sees one read and one write of each entry a sweep. Rows go in tiles of
// 32, one a lane. A CTA runs one (block, chain tile): up to NCMAX chains of
// one block, the chain tile the fastest-varying CTA index and the blocks
// in the plan's order (longest first), so that one block's chain tiles run
// together and read its band from L2 after the first; the CTA has
// - a row warp per chain: lane k holds dp[j0 + W + k] in a register; every
//   lane runs the scalar step of its own row on its own entry, so lane i's
//   is row j0 + i's, __shfl_sync broadcasts its diff, and every lane whose
//   entry the row reaches adds diff * band (entries already read included,
//   so an entry leaves the warp complete for the tile). A row's critical
//   path is its scalar step, one shuffle and one multiply and add: no
//   barrier, no memory access but a shared-memory load issued a row
//   ahead. At the tile's end the warp writes its entries back, loads the
//   next tile's 32 entries once the update threads are done with them,
//   applies the tile's diffs to them in row order, recomputes each lane's
//   outputs from the entry it read, and hands the diffs on;
// - 256 update threads, one tile behind, apply the tile's diffs to every
//   other live entry of every chain (a rank-32 update, each entry's updates
//   in row order), each band value loaded once and applied to every chain
//   of the CTA in registers; they write back the entries no later row
//   touches and stream in those the next tile reaches. Entry e belongs to
//   update thread e mod 256 at every tile, so they need no barrier among
//   themselves; they fold each chain's h2 / gap (df / maxshift) partials
//   in row order;
// - a producer warp copies, by bulk copies (TMA) one band row each, the
//   row warps' strips (a row's 64 band values on the diagonal, three
//   buffers, a tile ahead, issued before the band once it has reached the
//   tile before) and the band itself through four stages of 8 rows (a
//   tile) for the update threads (`srw` values a stage row; 0: they read
//   it in place, from L2, where the stages do not fit: float64 beside
//   wide rings).
// Row warps, update threads and producer meet on mbarriers (ready / done a
// tile, full / empty a stage), whose waits trap after ~2^34 cycles instead
// of hanging the card. h2_inc and gap (gap, df, maxshift) are per (chain,
// block) partials in row order, added by the caller in block order: no
// float atomics, so launches repeat bit for bit. Every dp entry gets the
// same multiply and add (fused only in the lassosum mode's float32) in row
// order, and with --fmad=false the arithmetic rounds as the plain torch
// twin's separate operations do: the kernel is bit-equal to its twin. The
// plan (ops/gibbs_kernels.py::plan) picks the ring length, the chains a
// CTA (up to NCMAX = 3 or 7: the instantiation, whose launch bound, 12 or
// 16 warps, sets the registers a thread may use, 168 or 128; the lassosum
// mode takes 3 at most), the stages and the block order; the kernel traps
// on a ring or a stage too short for its block.

#include <cstdint>
#include <cstring>
#include <type_traits>
#include <cuda_runtime.h>

#include "ring.cuh"

namespace {

template <typename T>
struct SweepArgs {
  const T* band;             // flat band arena: block b at blk_band[b], rows x (2W+1)
  const int64_t* blk_band;   // (nblk,) element offset of the block's band
  const int64_t* blk_dp;     // (nblk,) element offset of the block's dp
  const int64_t* blk_gidx;   // (nblk,) offset of the block's slot -> variant table
  const int32_t* blk_rows;   // (nblk,) rows to run
  const int32_t* blk_W;      // (nblk,) half-width W; dp length rows_pad + 2W
  const int32_t* blk_order;  // (nblk,) the blocks in launch order
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
};

// a * b + c as the lassosum mode rounds it (ops/gibbs_kernels.py::_mul_add)
__device__ __forceinline__ float lasso_mul_add(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double lasso_mul_add(double a, double b,
                                                double c) {
  return c + a * b;
}

__device__ __forceinline__ float abs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double abs_t(double x) { return fabs(x); }
__device__ __forceinline__ float exp_t(float x) { return expf(x); }
__device__ __forceinline__ double exp_t(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }

constexpr int RK = 32;        // rows a tile: one a lane of a row warp
constexpr int RNU = 256;      // update threads a CTA
constexpr int RSTRIPS = 3;    // strip buffers of the row warps' band values
// chains a CTA: of the narrow instantiation (11-12 warps, 3 a scheduler:
// 168 registers a thread) and of the wide one (16 warps, 4 a scheduler:
// 128), the most
constexpr int RNARROW = 3;
constexpr int RMAXC = 7;
constexpr int RKE = 4;        // entries an update thread at most (staged band)
constexpr int RSR = 8;        // band rows a stage
constexpr int RSUB = RK / RSR;  // stages a tile
constexpr int RSTAGES = 4;    // band stages: a tile's rows
static_assert(4 + RSTRIPS + 2 * RSTAGES <= 16, "mbarriers fit 128 bytes");

// dynamic shared memory: the mbarriers (128 B), the chains' rings, the
// strip buffers (RK rows of 2 RK + V values, V values a 16-byte chunk), two
// tiles of diffs and partial terms, and (srw > 0) the band stages, RSTAGES
// x RSR rows of srw values, and RK values of slack
// (ops/gibbs_kernels.py's `ring_smem_bytes` is the same formula)
inline size_t ring_smem_bytes(int nct, int S, int sz, int srw) {
  const int V = 16 / sz;
  return 128 + (size_t)nct * S * sz +
         (size_t)RSTRIPS * RK * (2 * RK + V) * sz +
         (size_t)6 * nct * RK * sz +
         (srw > 0 ? ((size_t)RSTAGES * RSR * srw + RK) * sz : 0);
}

// x + d b as the mode rounds it: fused in the lassosum mode's float32
// (lasso_mul_add), two roundings otherwise
template <typename T, bool LASSO>
__device__ __forceinline__ T ring_madd(T d, T b, T x) {
  if constexpr (LASSO) {
    return lasso_mul_add(d, b, x);
  } else {
    return x + d * b;
  }
}

// one bulk copy (TMA) of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(ring::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(ring::smem_u32(bar))
      : "memory");
}

// a shared-memory load the compiler issues where it stands (it would sink
// a plain load into the predicated multiply-add that uses it, and the
// update threads would wait on each one)
__device__ __forceinline__ float lds_now(const float* p) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(ring::smem_u32(p)));
  return v;
}
__device__ __forceinline__ double lds_now(const double* p) {
  double v;
  asm volatile("ld.shared.f64 %0, [%1];\n"
               : "=d"(v)
               : "r"(ring::smem_u32(p)));
  return v;
}

// one value copied from device memory into shared memory by cp.async,
// landed once the thread's cp.async.wait_all returns
template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   ring::smem_u32(dst)),
               "l"(src), "n"((int)sizeof(T))
               : "memory");
}

// N consecutive values from 16-byte aligned shared memory, 16 bytes a load
template <typename T, int N>
__device__ __forceinline__ void lds_vec(const T* p, T (&out)[N]) {
  static_assert((N * sizeof(T)) % 16 == 0, "whole 16-byte chunks");
#pragma unroll
  for (int i = 0; i < (int)(N * sizeof(T) / 16); ++i) {
    const float4 v = reinterpret_cast<const float4*>(p)[i];
    memcpy(&out[i * (16 / sizeof(T))], &v, 16);
  }
}

// The diagonal strip of tile rows j0 .. j0 + RK - 1 (of `nrow` rows) for
// the row warps: band columns W - i .. W - i + 2 RK - 1 of row j0 + i,
// copied from the 16-byte chunk that holds the first into line i (SW
// values), one bulk copy a row by lane i of the producer warp, completing
// on `bar` (the arena's BAND_PAD zeros cover the copies past its end;
// values outside a row's band are never used)
template <typename T>
__device__ __forceinline__ void issue_strip(const T* band_all,
                                            int64_t band_len, int64_t f0,
                                            int W2, int nrow, T* dst,
                                            uint64_t* bar, int lane) {
  constexpr int V = 16 / sizeof(T);
  constexpr int SW = 2 * RK + V;
  if (lane == 0) ring::mbar_expect_tx(bar, nrow * SW * sizeof(T));
  __syncwarp();
  if (lane < nrow) {
    // f0 + i W2 = the flat index of band[j0 + i, W - i]
    const int64_t src = (f0 + (int64_t)lane * W2) & ~(int64_t)(V - 1);
    if (src + SW > band_len) __trap();  // the arena lacks its padding
    bulk_copy(dst + lane * SW, band_all + src, SW * sizeof(T), bar);
  }
}

// A row's inputs as the row warp loads them, a tile ahead, from its
// variant g (prefetched a tile before that): the LDpred2 sweep's inputs,
// or the lassosum mode's bh, pf and cb (lam and dp1 are formed when the
// tile starts). Pad slots (g < 0) are inert (never sampled, diff 0).
template <typename T, bool LASSO>
struct RingIn {
  T bh, c2, c4, s1, u, z, cb;
  int g;
};
template <typename T>
struct RingIn<T, true> {
  T bh, pf, cb;
  int g;
};

template <typename T, bool LASSO>
__device__ __forceinline__ RingIn<T, LASSO> ring_load(const SweepArgs<T>& a,
                                                      int g, int c) {
  RingIn<T, LASSO> r;
  r.g = g;
  const int64_t o = (int64_t)c * a.m + g;
  if constexpr (LASSO) {
    r.bh = g >= 0 ? a.bh[g] : T(0);
    r.pf = g >= 0 ? a.pf[g] : T(0);
    r.cb = g >= 0 ? a.cb[o] : T(0);
  } else {
    r.bh = g >= 0 ? a.bh[g] : T(0);
    r.c2 = g >= 0 ? a.C2[o] : T(0);
    r.c4 = g >= 0 ? a.C4[o] : T(1);
    r.s1 = g >= 0 ? a.s1[o] : T(1);
    r.u = g >= 0 ? a.u[o] : T(2);
    r.z = g >= 0 ? a.z[o] : T(0);
    r.cb = g >= 0 ? a.cb[o] : T(0);
  }
  return r;
}

// The update threads' positions of tile j0: entries j0 + q, q = ut mod
// RNU, q < span = 2W + RK, but the row warp's two tiles (W <= q < W + 2 RK)
// and the entries past the sweep (j0 + q >= Lp). Slot k of a thread is
// q = q0 + k RNU; rows lo .. hi of the tile reach its entry.
struct RingPos {
  int q0, span, W, W2, j0, Lp, nrow;
  __device__ __forceinline__ bool valid(int q) const {
    return q < span && (q < W || q >= W + 2 * RK) && j0 + q < Lp;
  }
  __device__ __forceinline__ int lo(int q) const { return max(0, q - W2); }
  __device__ __forceinline__ int hi(int q) const { return min(nrow - 1, q); }
};

template <typename T, bool LASSO, int NCMAX>
__global__ void __launch_bounds__(32 * NCMAX + RNU + 32)
    gibbs_ring_kernel(SweepArgs<T> a, int S, int srw, int64_t band_len) {
  constexpr int V = 16 / sizeof(T);
  constexpr int SW = 2 * RK + V;
  // CTA -> (block, chain tile): the chain tile varies fastest, the blocks
  // come in the plan's order
  const int ntc = (a.NC + a.nct - 1) / a.nct;
  const int pos = blockIdx.x / ntc;
  const int b = a.blk_order[pos];
  auto ct0 = [&]() { return (int)(blockIdx.x - pos * ntc) * a.nct; };
  const int c0 = ct0();
  const int nct = min(a.nct, a.NC - c0);
  const int tid = threadIdx.x;
  // warps 0 .. a.nct - 1 run the chains' rows, the next RNU / 32 update,
  // the last produces
  const int nrw = 32 * a.nct;
  const int rows = a.blk_rows[b];
  const int W = a.blk_W[b];
  const int W2 = 2 * W;
  const int wk = W2 + 1;
  const int64_t bb = a.blk_band[b];
  const T* band = a.band + bb;
  const int32_t* gidx = a.gidx + a.blk_gidx[b];
  T* const dpg = a.dp + (int64_t)c0 * a.dp_stride + a.blk_dp[b];
  const int Lp = rows > 0 ? rows + W2 : 0;  // the entries the sweep touches
  // tile t reads and writes entries below RK t + A; S >= A + 2 RK keeps
  // every live entry (RK t - 2 RK .. RK t + A) in its own slot
  const int A = W + RK + max(W, RK);
  const int span = W2 + RK;  // tile t touches entries j0 .. j0 + span - 1
  const int ntile = (rows + RK - 1) / RK;
  const int S1 = S - 1;
  // a band stage's line holds a row from the 16-byte chunk of its start;
  // an update thread's entries are q0 + k RNU, k < RKE
  if (A + 2 * RK > S || (srw > 0 && (srw < wk + V - 1 || span > RKE * RNU)))
    __trap();

  // the chains this CTA runs: every one of its tile but the lassosum
  // mode's frozen grid points, which it skips
  uint32_t livem = 0;
  for (int t = 0; t < nct; ++t) {
    if (!LASSO || a.active[c0 + t] != 0) livem |= 1u << t;
  }
  auto live = [&](int cc) { return ((livem >> cc) & 1u) != 0; };
  if (livem == 0) {  // nothing to do
    if (tid < nct) {
      const int64_t o = (int64_t)(c0 + tid) * a.nblk + b;
      a.part_gap[o] = T(0);
      if constexpr (LASSO) {
        a.part_df[o] = 0;
        a.part_ms[o] = T(0);
      } else {
        a.part_h2[o] = T(0);
      }
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* const ready = reinterpret_cast<uint64_t*>(smem_raw);  // [2]
  uint64_t* const done = ready + 2;                                 // [2]
  uint64_t* const sfull = ready + 4;                          // [RSTRIPS]
  uint64_t* const bfull = sfull + RSTRIPS;                    // [RSTAGES]
  uint64_t* const bempty = bfull + RSTAGES;                   // [RSTAGES]
  T* const ring = reinterpret_cast<T*>(smem_raw + 128);  // [a.nct][S]
  T* const strip = ring + (size_t)a.nct * S;             // [3][RK][SW]
  T* const sd = strip + RSTRIPS * RK * SW;               // [2][a.nct][RK]
  T* const sc1 = sd + 2 * a.nct * RK;
  T* const sc2 = sc1 + 2 * a.nct * RK;
  T* const sbs = sc2 + 2 * a.nct * RK;             // [RSTAGES][RSR][srw]

  if (tid == 0) {
    for (int k = 0; k < 2; ++k) {
      ring::mbar_init(ready + k, 32 * __popc(livem));
      ring::mbar_init(done + k, RNU);
    }
    for (int k = 0; k < RSTRIPS; ++k) ring::mbar_init(sfull + k, 1);
    for (int k = 0; k < RSTAGES; ++k) {
      ring::mbar_init(bfull + k, 1);
      ring::mbar_init(bempty + k, RNU / 32);
    }
    ring::fence_mbarrier_init();
  }
  if (tid >= nrw && tid < nrw + RNU) {  // the first window: entries < A
    const int n0 = min(A, Lp);
    for (int c = 0; c < nct; ++c) {
      if (!live(c)) continue;
      for (int e = tid - nrw; e < n0; e += RNU) {
        ring[c * S + e] = dpg[(int64_t)c * a.dp_stride + e];
      }
    }
  }
  __syncthreads();
  // flat index of band[j0, W] of tile 0; + j0 wk for tile j0 / RK
  const int64_t f00 = bb + W;

  if (tid >= nrw + RNU) {
    // ---- the producer warp: strips and band stages, by bulk copies -------
    // The strip of tile u goes to buffer u mod 3 once the row warps have
    // left tile u - 3 (ready(u - 2) follows). Band rows RSR h .. RSR h +
    // RSR - 1 go to stage h mod RSTAGES once the update threads have left
    // the stage's rows a tile before them.
    const int lane = tid & 31;
    auto strip_of = [&](int u) {
      issue_strip(a.band, band_len, f00 + (int64_t)u * RK * wk, W2,
                  min(RK, rows - u * RK), strip + (u % RSTRIPS) * RK * SW,
                  sfull + u % RSTRIPS, lane);
    };
    for (int u = 0; u < min(2, ntile); ++u) strip_of(u);
    const int nst = srw > 0 ? RSUB * ntile : 0;
    for (int u = 2, h = 0; u < ntile || h < nst;) {
      // the next strip first once the band has reached the tile before
      // the row warps' last (the stages wait on the update threads, a tile
      // behind; the strips only on the row warps)
      if (u < ntile && (h >= nst || h >= RSUB * (u - 1))) {
        ring::mbar_wait(ready + ((u - 2) & 1), ((u - 2) >> 1) & 1);
        strip_of(u++);
        continue;
      }
      const int s = h % RSTAGES;
      if (h >= RSTAGES) ring::mbar_wait(bempty + s, ((h / RSTAGES) - 1) & 1);
      const int j = RSR * h + lane;  // this lane's row
      int64_t src = 0;
      uint32_t bytes = 0;
      if (lane < RSR && j < rows) {
        const int64_t f = bb + (int64_t)j * wk;   // flat index of band[j, 0]
        src = f & ~(int64_t)(V - 1);
        bytes = (uint32_t)(((f + wk - src + V - 1) / V) * 16);
        if (src + (int64_t)(bytes / sizeof(T)) > band_len) __trap();
      }
      uint32_t total = bytes;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        total += __shfl_xor_sync(0xffffffffu, total, o);
      if (lane == 0) ring::mbar_expect_tx(bfull + s, total);
      __syncwarp();
      if (bytes) {
        bulk_copy(sbs + (s * RSR + lane) * srw, a.band + src, bytes,
                  bfull + s);
      }
      ++h;
    }
  } else if (tid < nrw) {
    // ---- a row warp: chain c0 + w --------------------------------------
    const int w = tid >> 5, lane = tid & 31;
    if (w < nct && live(w) && ntile > 0) {
      const int c = c0 + w;
      T* const rc = ring + w * S;
      T iop = T(0), pc = T(0), lam_c = T(0), delta_c = T(0);
      bool sp = false;
      if constexpr (LASSO) {
        lam_c = a.lam[c];
        delta_c = a.delta[c];
      } else {
        iop = a.inv_odd_p[c];
        pc = a.p[c];
        sp = a.sparse[c] != 0;
      }
      const T shrink = a.shrink;
      const T one_m_shrink = T(1) - shrink;
      // lane k's rows: j0 + k of this tile (in), the next (g1), the one
      // after (g2, loaded a tile before its inputs)
      int g1 = RK + lane < rows ? gidx[RK + lane] : -1;
      RingIn<T, LASSO> in =
          ring_load<T, LASSO>(a, lane < rows ? gidx[lane] : -1, c);
      T cur = W + lane < Lp ? rc[(W + lane) & S1] : T(0);

      for (int t = 0; t < ntile; ++t) {
        const int j0 = t * RK;
        const int nrow = min(RK, rows - j0);
        const bool more = t + 1 < ntile;
        const int64_t f0 = f00 + (int64_t)j0 * wk;
        const int g2 = j0 + 2 * RK + lane < rows ? gidx[j0 + 2 * RK + lane]
                                                 : -1;
        const RingIn<T, LASSO> nxt = ring_load<T, LASSO>(a, g1, c);
        ring::mbar_wait(sfull + t % RSTRIPS, (t / RSTRIPS) & 1);
        const T* st = strip + (t % RSTRIPS) * RK * SW;
        const int off0 = (int)(f0 & (V - 1));

        // lane k's own row (j0 + k): its step's inputs
        T iops1 = T(0), zs = T(0), lam = T(1), dp1 = T(1);
        if constexpr (LASSO) {
          if (in.g >= 0) {
            lam = in.pf * lam_c;
            dp1 = in.pf * delta_c + T(1);
          }
        } else {
          iops1 = iop * in.s1;
          zs = in.z * sqrt_t(in.c4);
        }
        // the step of row j0 + k from its entry dp[j0 + k + W] = dot: the
        // diff, or with `out` every output and partial term
        T o_beta = T(0), o_postp = T(0), o_binc = T(0), o_dps = T(0);
        T o_c1 = T(0), o_c2 = T(0);
        bool o_samp = false;
        auto step = [&](T dot, auto out) -> T {
          constexpr bool OUT = decltype(out)::value;
          if constexpr (LASSO) {  // no branch: the division runs always
            const T u = in.bh - (dot - in.cb);
            const T nm = u > T(0) ? u - lam : u + lam;
            const T qd = nm / dp1;
            T nb = (u * nm > T(0)) ? qd : T(0);
            nb = (abs_t(u) > lam) ? nb : T(0);
            if constexpr (OUT) o_c1 = nb;
            return nb - in.cb;
          } else {
            const T res = in.bh - shrink * (dot - in.cb);
            const T C3 = in.c2 * res;
            const T postp =
                T(1) / (T(1) + iops1 * exp_t(-C3 * C3 / in.c4 * T(0.5)));
            const T samp = C3 + zs;
            const bool sparse_skip = sp && (postp < pc);
            const bool jump = a.no_jump && (samp * in.cb < T(0));
            const bool sampled = (postp > in.u) && !sparse_skip && !jump;
            const T new_beta = sampled ? samp : T(0);
            const T diff = new_beta - in.cb;
            if constexpr (OUT) {
              const T dps = shrink * dot + one_m_shrink * in.cb;
              o_c1 = diff * (T(2) * dps + diff);
              o_c2 = sampled ? samp * samp : T(0);
              o_beta = new_beta;
              o_samp = sampled;
              o_postp = sparse_skip ? T(0) : postp;
              o_binc = sparse_skip ? T(0) : C3 * postp;
              o_dps = dps;
            }
            return diff;
          }
        };
        // row j0 + i: every lane runs the step on its own entry and row;
        // lane i's entry holds dp[j0 + i + W] complete up to this row, so
        // its step is the row's, and its diff goes to every lane
        T my_dot = T(0), my_diff = T(0);
        auto row = [&](int i) {
          const T b = st[i * SW + ((off0 + i * W2) & (V - 1)) + lane];
          const bool reach = (unsigned)(W + lane - i) <= (unsigned)W2;
          const T diff = step(cur, std::false_type{});
          my_dot = lane == i ? cur : my_dot;
          my_diff = lane == i ? diff : my_diff;
          const T d = __shfl_sync(0xffffffffu, diff, i);
          if (reach) cur = ring_madd<T, LASSO>(d, b, cur);
        };
        if (nrow == RK) {
#pragma unroll
          for (int i = 0; i < RK; ++i) row(i);
        } else {
#pragma unroll 1
          for (int i = 0; i < nrow; ++i) row(i);
        }

        // this tile's entries are complete for it: back to the ring
        const int e = j0 + W + lane;
        if (e < Lp) rc[e & S1] = cur;
        // the next tile's entries, once the update threads have applied
        // every earlier tile to them, then this tile's diffs in row order;
        // beside it each lane's row's outputs, from the entry it read
        if (t >= 1) ring::mbar_wait(done + ((t - 1) & 1), ((t - 1) >> 1) & 1);
        const int en = j0 + RK + W + lane;
        T nx = en < Lp ? rc[en & S1] : T(0);
        auto next = [&](int i) {  // column W + RK + lane - i of row j0 + i
          const T b = st[i * SW + ((off0 + i * W2) & (V - 1)) + RK + lane];
          const T d = __shfl_sync(0xffffffffu, my_diff, i);
          if (lane - i <= W - RK) nx = ring_madd<T, LASSO>(d, b, nx);
        };
        if (nrow == RK) {
#pragma unroll
          for (int i = 0; i < RK; ++i) next(i);
        } else {
#pragma unroll 1
          for (int i = 0; i < nrow; ++i) next(i);
        }
        step(my_dot, std::true_type{});
        if (!more && en < Lp) rc[en & S1] = nx;
        // the tile's diffs and partial terms, for the update threads
        const int sb = (t & 1) * a.nct * RK + w * RK + lane;
        sd[sb] = lane < nrow ? my_diff : T(0);
        sc1[sb] = o_c1;
        sc2[sb] = o_c2;
        ring::mbar_arrive(ready + (t & 1));
        if (lane < nrow && in.g >= 0) {
          const int64_t o = (int64_t)c * a.m + in.g;
          if constexpr (LASSO) {
            a.out_beta[o] = o_c1;
          } else {
            a.out_beta[o] = o_beta;
            a.out_causal[o] = o_samp ? 1 : 0;
            a.out_postp[o] = o_postp;
            a.out_binc[o] = o_binc;
            a.out_dps[o] = o_dps;
          }
        }
        cur = nx;
        in = nxt;
        g1 = g2;
      }
    }
  } else {
    // ---- the update threads ---------------------------------------------
    const int ut = tid - nrw;
    T h2 = T(0), gap = T(0), ms = T(0);
    int32_t df = 0;
    const bool live_u = ut < nct && live(ut);
    auto pos_of = [&](int t) {
      const int j0 = t * RK;
      return RingPos{(ut - j0) & (RNU - 1), span, W, W2, j0, Lp,
                     min(RK, rows - j0)};
    };
    const int lane_u = ut & 31;
    for (int t = 0; t < ntile; ++t) {
      const RingPos P = pos_of(t);
      const int j0 = P.j0, nrow = P.nrow;
      // stream in the entries that tile t + 1 reaches first: their slots
      // held entries written back a tile ago, and no row of this tile
      // reaches them (the copies land before the arrival on done)
      const int e_in = j0 + A + ((ut - (j0 + A)) & (RNU - 1));
      if (e_in < j0 + A + RK && e_in < Lp) {
        for (int cc = 0; cc < nct; ++cc) {
          if (live(cc)) {
            cp_async_elem(ring + cc * S + (e_in & S1),
                          dpg + (int64_t)cc * a.dp_stride + e_in);
          }
        }
      }
      ring::mbar_wait(ready + (t & 1), (t >> 1) & 1);
      const T* sdt = sd + (t & 1) * a.nct * RK;
      if (live_u) {  // chain ut's partials, in row order
        const T* c1 = sc1 + (t & 1) * a.nct * RK + ut * RK;
        const T* c2 = sc2 + (t & 1) * a.nct * RK + ut * RK;
        for (int i = 0; i < nrow; ++i) {
          if constexpr (LASSO) {
            const T nb = c1[i];
            if (nb != T(0)) {
              gap = gap + nb * nb;
              ++df;
            }
            const T ad = abs_t(sdt[ut * RK + i]);
            if (ad > ms || ad != ad) ms = ad;  // NaN sticks
          } else {
            h2 = h2 + c1[i];
            gap = gap + c2[i];
          }
        }
      }
      // every entry the tile reaches but the row warp's two tiles: the
      // tile's diffs in row order
      if (srw > 0) {
        // staged: the thread's entries j0 + q0 + k RNU advance together,
        // row by row; each stage's band values are read once and applied
        // to every chain
        uint32_t mk[RKE];  // rows of the tile that reach entry k
        int qk[RKE];       // its position (0 for an entry it does not have)
#pragma unroll
        for (int k = 0; k < RKE; ++k) {
          const int q = P.q0 + k * RNU;
          const int lo = P.lo(q), hi = P.hi(q);
          mk[k] = (P.valid(q) && hi >= lo) ? (2u << hi) - (1u << lo) : 0u;
          qk[k] = mk[k] ? q : 0;
        }
        // band[j0 + i, c] is at line i mod RSR of its stage, (fi + c), fi
        // the row start's place in its 16-byte chunk
        const int f0m = (int)((bb + (int64_t)j0 * wk) & (V - 1));
        const int wkm = wk & (V - 1);
#pragma unroll
        for (int sub = 0; sub < RSUB; ++sub) {
          const int h = RSUB * t + sub;
          ring::mbar_wait(bfull + h % RSTAGES, (h / RSTAGES) & 1);
          const T* const sb = sbs + (h % RSTAGES) * RSR * srw;
          T bv[RSR][RKE];  // the stage's band values, loaded first
#pragma unroll
          for (int r = 0; r < RSR; ++r) {
            const int i = RSR * sub + r;
            const T* const line =
                sb + r * srw + ((f0m + i * wkm) & (V - 1)) - i;
#pragma unroll
            for (int k = 0; k < RKE; ++k) bv[r][k] = lds_now(line + qk[k]);
          }
          for (int cc = 0; cc < nct; ++cc) {
            if (!live(cc)) continue;
            T* const rcc = ring + cc * S;
            T d[RSR];
            lds_vec(sdt + cc * RK + RSR * sub, d);
            T x[RKE];
#pragma unroll
            for (int k = 0; k < RKE; ++k) {
              x[k] = mk[k] ? rcc[(j0 + qk[k]) & S1] : T(0);
            }
#pragma unroll
            for (int r = 0; r < RSR; ++r) {
              const int i = RSR * sub + r;
#pragma unroll
              for (int k = 0; k < RKE; ++k) {
                if (mk[k] & (1u << i)) {
                  x[k] = ring_madd<T, LASSO>(d[r], bv[r][k], x[k]);
                }
              }
            }
#pragma unroll
            for (int k = 0; k < RKE; ++k) {
              if (mk[k]) rcc[(j0 + qk[k]) & S1] = x[k];
            }
          }
          __syncwarp();  // the warp is done with the stage: free it
          if (lane_u == 0) ring::mbar_arrive(bempty + h % RSTAGES);
        }
      } else {
        // in place: two entries at a time (slots k and k + 1), in two
        // halves of the tile's rows, each half's 16 band values an entry
        // loaded first and applied to every chain
        constexpr int RH = RK / 2;
        const T* const bt = band + (int64_t)j0 * wk;
        for (int k = 0; P.q0 + k * RNU < span; k += 2) {
          const int q = P.q0 + k * RNU, qb = q + RNU;
          const bool va = P.valid(q), vb = P.valid(qb);
          if (!va && !vb) continue;
          const int loa = P.lo(q), hia = P.hi(q);
          const int lob = P.lo(qb), hib = P.hi(qb);
          auto update = [&](auto all_rows) {  // both entries, rows 0 .. RK - 1
            constexpr bool ALL = decltype(all_rows)::value;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              T ba[RH], bv[RH];
#pragma unroll
              for (int r = 0; r < RH; ++r) {  // band[j0 + i, q - i]
                const int i = RH * hf + r;
                const bool ra = ALL || (va && i >= loa && i <= hia);
                const bool rb = ALL || (vb && i >= lob && i <= hib);
                ba[r] = ra ? bt[(int64_t)i * W2 + q] : T(0);
                bv[r] = rb ? bt[(int64_t)i * W2 + qb] : T(0);
              }
              for (int cc = 0; cc < nct; ++cc) {
                if (!live(cc)) continue;
                T* const rcc = ring + cc * S;
                const T* dc = sdt + cc * RK + RH * hf;
                T xa = va ? rcc[(j0 + q) & S1] : T(0);
                T xb = vb ? rcc[(j0 + qb) & S1] : T(0);
#pragma unroll
                for (int g = 0; g < RH; g += RSR) {
                  T d[RSR];
                  lds_vec(dc + g, d);
#pragma unroll
                  for (int r = 0; r < RSR; ++r) {
                    const int i = RH * hf + g + r;
                    if (ALL || (va && i >= loa && i <= hia)) {
                      xa = ring_madd<T, LASSO>(d[r], ba[g + r], xa);
                    }
                    if (ALL || (vb && i >= lob && i <= hib)) {
                      xb = ring_madd<T, LASSO>(d[r], bv[g + r], xb);
                    }
                  }
                }
                if (va) rcc[(j0 + q) & S1] = xa;
                if (vb) rcc[(j0 + qb) & S1] = xb;
              }
            }
          };
          if (va && vb && loa == 0 && lob == 0 && hia == RK - 1 &&
              hib == RK - 1) {
            update(std::true_type{});
          } else {
            update(std::false_type{});
          }
        }
      }
      if (t >= 1) {  // entries j0 - RK .. j0 - 1: no later row touches them
        const int e = j0 - RK + ((ut - (j0 - RK)) & (RNU - 1));
        if (e < j0 && e < Lp) {
          for (int cc = 0; cc < nct; ++cc) {
            if (live(cc)) {
              dpg[(int64_t)cc * a.dp_stride + e] = ring[cc * S + (e & S1)];
            }
          }
        }
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      ring::mbar_arrive(done + (t & 1));
    }
    if (ntile > 0) {  // the last window's entries
      const int lo = (ntile - 1) * RK;
      for (int e = lo + ((ut - lo) & (RNU - 1)); e < Lp; e += RNU) {
        for (int cc = 0; cc < nct; ++cc) {
          if (live(cc)) {
            dpg[(int64_t)cc * a.dp_stride + e] = ring[cc * S + (e & S1)];
          }
        }
      }
    }
    if (ut < nct) {
      // the block and first chain loaded anew (volatile), not held in
      // registers across the sweep
      const int bo = *(volatile const int32_t*)(a.blk_order + pos);
      const int64_t o = (int64_t)(ct0() + ut) * a.nblk + bo;
      a.part_gap[o] = gap;
      if constexpr (LASSO) {
        a.part_df[o] = df;
        a.part_ms[o] = ms;
      } else {
        a.part_h2[o] = h2;
      }
    }
  }
}

// one launch of the NCMAX instantiation: a CTA for every (block, chain
// tile), threads = 32 chains a CTA + 256 update threads + a producer warp
template <typename T, bool LASSO, int NCMAX>
int launch_ring(const SweepArgs<T>& a, int ring, int srw, int64_t band_len,
                void* stream) {
  const size_t smem = ring_smem_bytes(a.nct, ring, sizeof(T), srw);
  cudaError_t err = cudaFuncSetAttribute(
      gibbs_ring_kernel<T, LASSO, NCMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ntc = (a.NC + a.nct - 1) / a.nct;
  gibbs_ring_kernel<T, LASSO, NCMAX>
      <<<a.nblk * ntc, 32 * a.nct + RNU + 32, smem,
         (cudaStream_t)stream>>>(a, ring, srw, band_len);
  return (int)cudaGetLastError();
}

// `ring` slots a chain (a power of two, at least 256), band stages of
// `srw` values a row (0: the update threads read the band in place); the
// instantiation is the narrow one up to RNARROW chains a CTA, and always
// for the lassosum mode (at the wide one's 128 registers its float32 code
// spills)
template <typename T, bool LASSO>
int launch_args(const SweepArgs<T>& a, int threads, int ring, int srw,
                int64_t band_len, void* stream) {
  if (a.nblk <= 0 || a.NC <= 0) return 0;
  const int nct = a.nct;
  if (nct < 1 || nct > (LASSO ? RNARROW : RMAXC) ||
      threads != 32 * nct + RNU + 32 || ring < RNU ||
      (ring & (ring - 1)) != 0 || srw < 0 || srw % (16 / (int)sizeof(T))) {
    return (int)cudaErrorInvalidValue;
  }
  if constexpr (LASSO) {
    return launch_ring<T, LASSO, RNARROW>(a, ring, srw, band_len, stream);
  } else {
    return nct <= RNARROW
               ? launch_ring<T, LASSO, RNARROW>(a, ring, srw, band_len,
                                                stream)
               : launch_ring<T, LASSO, RMAXC>(a, ring, srw, band_len, stream);
  }
}

template <typename T>
int launch(const T* band, const int64_t* blk_band, const int64_t* blk_dp,
           const int64_t* blk_gidx, const int32_t* blk_rows,
           const int32_t* blk_W, const int32_t* blk_order, int nblk,
           const int32_t* gidx, T* dp, int64_t dp_stride, const T* cb,
           const T* bh, const T* C2, const T* C4, const T* s1, const T* u,
           const T* z, int64_t m, const T* inv_odd_p, const T* p,
           const uint8_t* sparse, double shrink, int no_jump, T* out_beta,
           uint8_t* out_causal, T* out_postp, T* out_binc, T* out_dps,
           T* part_h2, T* part_gap, int NC, int nct, int threads, int ring,
           int srw, int64_t band_len, void* stream) {
  SweepArgs<T> a{band, blk_band, blk_dp, blk_gidx, blk_rows, blk_W,
                 blk_order, gidx, dp, dp_stride, cb, bh, C2, C4, s1, u, z, m,
                 inv_odd_p, p, sparse, (T)shrink, no_jump, out_beta,
                 out_causal, out_postp, out_binc, out_dps, part_h2, part_gap,
                 nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nblk, NC, nct};
  return launch_args<T, false>(a, threads, ring, srw, band_len, stream);
}

template <typename T>
int launch_lasso(const T* band, const int64_t* blk_band, const int64_t* blk_dp,
                 const int64_t* blk_gidx, const int32_t* blk_rows,
                 const int32_t* blk_W, const int32_t* blk_order, int nblk,
                 const int32_t* gidx, T* dp, int64_t dp_stride, T* beta,
                 const T* bh, const T* pf, int64_t m, const T* lam,
                 const T* delta, const uint8_t* active, T* part_gap,
                 int32_t* part_df, T* part_ms, int NC, int nct, int threads,
                 int ring, int srw, int64_t band_len, void* stream) {
  SweepArgs<T> a{band, blk_band, blk_dp, blk_gidx, blk_rows, blk_W,
                 blk_order, gidx, dp, dp_stride, beta, bh, nullptr, nullptr,
                 nullptr, nullptr, nullptr, m, nullptr, nullptr, nullptr,
                 T(1), 0, beta, nullptr, nullptr, nullptr, nullptr, nullptr,
                 part_gap, pf, lam, delta, active, part_df, part_ms,
                 nblk, NC, nct};
  return launch_args<T, true>(a, threads, ring, srw, band_len, stream);
}

}  // namespace

#define SWEEP_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(                                                       \
      const T* band, const int64_t* blk_band, const int64_t* blk_dp,         \
      const int64_t* blk_gidx, const int32_t* blk_rows, const int32_t* blk_W, \
      const int32_t* blk_order, int nblk, const int32_t* gidx, T* dp,        \
      int64_t dp_stride, const T* cb, const T* bh, const T* C2, const T* C4, \
      const T* s1, const T* u, const T* z, int64_t m, const T* inv_odd_p,    \
      const T* p, const uint8_t* sparse, double shrink, int no_jump,         \
      T* out_beta, uint8_t* out_causal, T* out_postp, T* out_binc,           \
      T* out_dps, T* part_h2, T* part_gap, int NC, int nct, int threads,     \
      int ring, int srw, int64_t band_len, void* stream) {                   \
    return launch<T>(band, blk_band, blk_dp, blk_gidx, blk_rows, blk_W,      \
                     blk_order, nblk, gidx, dp, dp_stride, cb, bh, C2, C4,   \
                     s1, u, z, m, inv_odd_p, p, sparse, shrink, no_jump,     \
                     out_beta, out_causal, out_postp, out_binc, out_dps,     \
                     part_h2, part_gap, NC, nct, threads, ring, srw,         \
                     band_len, stream);                                      \
  }

SWEEP_ENTRY(gibbs_sweep_f32, float)
SWEEP_ENTRY(gibbs_sweep_f64, double)

// the lassosum mode: beta (NC, m) is read as cb and updated in place
#define LASSO_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(                                                       \
      const T* band, const int64_t* blk_band, const int64_t* blk_dp,         \
      const int64_t* blk_gidx, const int32_t* blk_rows, const int32_t* blk_W, \
      const int32_t* blk_order, int nblk, const int32_t* gidx, T* dp,        \
      int64_t dp_stride, T* beta, const T* bh, const T* pf, int64_t m,       \
      const T* lam, const T* delta, const uint8_t* active, T* part_gap,      \
      int32_t* part_df, T* part_ms, int NC, int nct, int threads, int ring,  \
      int srw, int64_t band_len, void* stream) {                             \
    return launch_lasso<T>(band, blk_band, blk_dp, blk_gidx, blk_rows,       \
                           blk_W, blk_order, nblk, gidx, dp, dp_stride, beta, \
                           bh, pf, m, lam, delta, active, part_gap, part_df, \
                           part_ms, NC, nct, threads, ring, srw, band_len,   \
                           stream);                                          \
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
