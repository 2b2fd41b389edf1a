// K1, K2 and K7: the genotype operator on exact bf16 bit planes against
// the float operand split into bf16 terms, with float32 tensor-core
// accumulation, for Hopper (sm_90a). One kernel template,
// plane_wgmma_kernel<PROD, TERMS, BNC>, serves
//   K1        (PROD = false, TERMS = 3) bigsnpr_tpu/ops/pallas_kernels.py
//       _cprod_kernel (entry pallas_cprod, mxu="highest", the port's
//       default):                                                X~^T V
//   K2        (PROD = true, TERMS = 3)  _prod_kernel
//       (entry pallas_prod, mxu="highest"):                      X~ U
//   K7 cprod  (PROD = false, TERMS = 2) _cprod_kernel_split
//       (entry pallas_cprod(mxu="split2")):                      X~^T V
//   K7 prod   (PROD = true, TERMS = 2)  _prod_kernel_split
//       (entry pallas_prod(mxu="split2")):                       X~ U
//
// The algebra (ops/geno_kernels.py has it in torch): the standardized value
// of 2-bit code g with bits b0 (low), b1 is x~ = A - s t - A na, with
// t = b1 + (b0 & b1) in {0,1,2}, na = b0 & ~b1 in {0,1}, A = (2 - c) s.
// t and na are exact in bf16. The operand is split into TERMS bf16 terms,
// hi = bf16(x), then mid = bf16(x - hi) and lo = bf16((x - hi) - mid) (the
// subtractions in f32, every cast round to nearest even): two terms keep
// 16 of x's 24 mantissa bits (K7, the JAX package's split2), three all of
// them (K1, K2). Each product of a plane value and a term is exact in f32;
// the tensor cores accumulate in f32. cprod's operand is V^T (one for both
// planes); prod's are zB = U^T s for the T plane and zA = U^T A for the NA
// plane. K7's result is (sum - pna) A - pt s (cprod) or (sum - pna) - pt
// (prod), per element in that order, with pt, pna the plane sums and sum
// the row sums of V^T (cprod) or zA (prod), as `_split_epilogue_plain`
// forms it. Built with --fmad=false, so the prep and the epilogue round as
// the twins' separate torch ops do.
//
// Three terms (K1, K2) centre their operand. pt and sum each grow like the
// depth when the operand's columns do not average zero (U = 1, all-positive
// weights; K1's GWAS operand [yr | Q], whose intercept column is the
// constant 1/sqrt(n)), while the result grows like its square root: in f32
// the difference loses the result (K2: about 3e-4 of max |float64| at m =
// 100,000). So the T-plane operand is shifted by alpha and the NA-plane
// operand by beta, per column, and every column tile ends in a count
// column of ones whose plane sums are T_i = sum_k t_ik and N_i = sum_k
// na_ik over the depth k, exact integers in f32. In float64, in this order:
//   K2: out = ((sum - alpha T) - beta N) - pna' - pt'
//   K1: out = (((sum - beta N) A - (alpha T) s) - pna' A) - pt' s
// pt', pna' the centred plane sums (about sqrt(depth) in size). K1 takes
// A = (2 - c) s in float64, where the product of two f32 values is exact:
// A rounded to f32 puts its rounding, times a sum that grows like n, in
// the result (6.6e-5 of max |float64| at n = 40,003, V = |N(0,1)| + 1, in
// the CPU twin; 6.8e-7 with A exact). K2 shifts zB - alpha and zA - beta,
// alpha the mean of zB weighted by E t = 2 - c, beta the mean of zA; K1's
// one operand V^T - gamma serves both planes, alpha = beta = gamma the
// mean of V's column over the n samples. Each shift is rounded to bf16, so
// that an entry minus it rounds only where the entry is 2^16 times the
// shift; a mean below 2^-10 of the mean |entry| is taken as 0 (its column
// has nothing to cancel). The sums are in float64.
//
// What bounds it on an H100, at n = 50,000, m = 100,000, l = 20: K7 does
// 2 planes x 2 terms x 20 columns x 2nm = 8.0e11 bf16 operations, 0.81 ms
// at the 989 TFLOP/s dense bf16 peak, K1 and K2 3 terms, 1.2e12 and 1.21
// ms; all read 1.25 GB of packed bytes, 0.37 ms at 3.35 TB/s. So all are
// bound by operations, and the work besides the tensor cores (the decode,
// the pack's loads) has to hide under them.
//
// Design:
// - GEMM shape: rows M (cprod: variants, prod: samples), depth K (cprod:
//   samples, prod: variants), and columns N = TERMS x BNC: a tile of BNC
//   of the operand's l columns, its terms stacked as row blocks of BNC
//   (the JAX kernels' row-stacked hi / lo), so one wgmma a plane and k-step
//   covers every term, and the epilogue adds a column's terms, which sit
//   in the same thread's registers. The tensor cores' f32 sums are taken
//   over one stage (16 k-steps) at a time, each stage's wgmmas starting
//   anew, and added, terms summed, into f32 registers: summed over all
//   100,000 variants in the tensor cores, K2 was 2.7e-5 of max |float64
//   product| off it, and 1e-5 is its limit. A thread holds 2 planes x
//   (N/2 + BNC/2) floats; ptxas gives it at most 168 registers, so N <= 96
//   and BNC <= 40 (N = 112 serialised the wgmmas).
// - A persistent grid, one CTA an SM, walks work items (128-row M tile x
//   BNC-column tile x depth split), the M tile fastest, so the CTAs that
//   run together read the same operand tiles at the same depth (L2).
//   A CTA is two consumer warpgroups (64 rows each) and a producer
//   warpgroup.
// - The producer keeps a ring of `stages` stages of `ksub` 64-deep
//   sub-tiles (the plan takes 4 where two stages fit: a stage's ring
//   traffic costs about as much as its work at 64 deep), with a full and
//   an empty mbarrier a stage. The operand tiles (N rows x 64 bf16 a plane
//   and sub-tile, K-major, 128-byte swizzle, one TMA box a term) come from
//   the prepared operand (planes, TERMS, l_pad, ldk) bf16. The pack has
//   row stride nb, which TMA's 16-byte stride rule refuses: the producer
//   copies the aligned 16-byte chunks that cover each row's bytes of the
//   stage by cp.async (cp.async.mbarrier.arrive signals the stage); the
//   readers recompute a row's offset in its first chunk.
// - No plane tile is ever written: the consumers decode the packed bytes
//   straight into wgmma's A register fragments (m64nNk16, A from
//   registers, B from shared memory). A code indexes its bf16 value with
//   one byte permute a register and plane (prmt on a 4-entry table). Two
//   fixed permutations make every fragment register come from one byte:
//     cprod: within each 64 samples of a sub-tile, thread tg's k-step ks
//       reads byte 4tg + ks (the prep writes the operand's depth in that
//       order, `sigma64`), its low nibble for k columns 2tg, 2tg+1, its
//       high one for 2tg+8, 2tg+9: one 4-byte word a row and sub-tile;
//     prod: fragment rows g and g + 8 of a warp are samples 2g and 2g + 1
//       of its 16, the same nibble of one byte, so a register (two
//       variants of one sample) is two bytes, one a variant row.
//   A warpgroup decodes a sub-tile's four k-steps, issues their wgmmas and
//   waits for them before it decodes the next: ptxas serialises every
//   wgmma of a kernel in which other instructions write a wgmma's input
//   registers while wgmmas run. The two warpgroups overlap each other's
//   decode and tensor-core work.
// - The decoded A of a sub-tile serves every term and plane of the item's
//   column tile: an l of at most 31 (K1, K2, whose tile of 32 ends in its
//   count column) or 40 (K7) is one column tile, so the pack is decoded
//   once. (Wider l takes more tiles, the pack decoded
//   once a tile: the accumulators of all columns do not fit in registers;
//   at the grid PRS's l = 650, 21 tiles, the decode of a sub-tile is ~1/5
//   of its tensor-core work.)
// - The epilogue is fused when the depth is not split: out is written from
//   the f32 sums. Where the plan splits the depth (too few M tiles for
//   the card, or, three terms, a depth past MAX_COUNT_DEPTH = 2^23, whose
//   count column's f32 sums would no longer be exact), each split writes
//   its raw plane sums as its own slice and geno_plane_epilogue adds the
//   slices in split order, the counts in float64. No float atomics
//   anywhere: two launches repeat bit for bit.
// - The operand preparation (geno_plane_prep) is three small kernels: the
//   float64 sums of each 64 depth rows, their sums in order (with the
//   three-term shifts), then zB, zA or V^T, centred for three terms, split
//   into TERMS terms and written padded (zeros past l and past the depth)
//   in the kernel's depth order, the three-term count rows among them.
// - The launch plan (tile width, stage depth, stages, grid, splits) is
//   made in Python (ops/geno_kernels.py::plane_plan); geno_plane_gemm
//   refuses what it cannot run.
//
// Layout: packed is (m, nb) uint8 in true sample order (sample 4b+k in bits
// 2k..2k+1 of byte b), unpadded. Bytes past a row's end and rows past m
// decode to plane values that meet zero operand entries (or fill rows and
// columns that are never written out), so the kernel masks nothing.
//
// C interface for ctypes: every function returns cudaGetLastError() after
// its launches, as an int, or a negative code for a refused plan (-1) or a
// tensor map the CUDA driver would not encode (-2). Launches go to the
// stream passed in.

#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ring.cuh"
#include "wgmma_bf16.cuh"

namespace {

using namespace ring;

__host__ __device__ __forceinline__ int64_t cdiv(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

constexpr int SUB = 64;           // depth of an operand sub-tile: 128 bytes
constexpr int BM = 128;           // rows of a work item (two warpgroups)
constexpr int CONSUMERS = 256;    // two consumer warpgroups
constexpr int PRODUCERS = 128;    // and a producer warpgroup
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int MAX_STAGES = 8;
constexpr int HEAD = 2048;        // barriers and the alignment slack
constexpr int MAX_SMEM = 232448;  // 227 KB a block on sm_90

// A stage is `ksub` (1, 2 or 4) sub-tiles deep. The pack rows it copies:
// cprod the item's 128 variants, 16 ksub bytes each (ksub + 1 aligned
// chunks); prod its 64 ksub variants, 32 bytes each (the item's 128
// samples: 3 chunks). A row's stride keeps the readers' rows on distinct
// shared-memory banks.
__host__ __device__ constexpr int pack_rows(bool prod, int ksub) {
  return prod ? SUB * ksub : BM;
}
__host__ __device__ constexpr int chunks(bool prod, int ksub) {
  return prod ? 3 : ksub + 1;
}
__host__ __device__ constexpr int raw_row(bool prod, int ksub) {
  return prod || ksub < 2 ? 48 : 16 * (ksub + 1);
}

// operand tiles a stage: prod one a plane (zB, zA), cprod one for both;
// a tile is ksub sub-tiles of TERMS x BNC rows of 128 bytes
__host__ __device__ constexpr int b_planes(bool prod) { return prod ? 2 : 1; }

__host__ __device__ constexpr int stage_bytes(bool prod, int terms, int bnc,
                                              int ksub) {
  return b_planes(prod) * ksub * terms * bnc * 128 +
         pack_rows(prod, ksub) * raw_row(prod, ksub);
}

__host__ __device__ constexpr int smem_bytes(bool prod, int terms, int bnc,
                                             int ksub, int stages) {
  return HEAD + stages * stage_bytes(prod, terms, bnc, ksub);
}

// bf16 of the T and NA plane values by 2-bit code, low and high bytes:
// T 0, 0, 1.0 (0x3F80), 2.0 (0x4000); NA 0, 1.0, 0, 0
constexpr uint32_t T_LO = 0x00800000u, T_HI = 0x403F0000u;
constexpr uint32_t N_LO = 0x00008000u, N_HI = 0x00003F00u;

// byte x (codes c0..c3) -> selector bytes (c_i | (c_i + 4) << 4): the low
// half picks the bf16 pair of codes c0, c1, the high half of c2, c3
__device__ __forceinline__ uint32_t code_selectors(uint32_t x) {
  const uint32_t spread = ((x & 0x33u) * 0x1001u & 0x00030003u) |
                          ((x & 0xCCu) * 0x40040u & 0x03000300u);
  return spread * 0x11u + 0x40404040u;
}

// the depth order of cprod's operand within 64 samples: logical column kk
// of k-step ks = kk >> 4 is sample sigma64(kk) (see the design note)
__host__ __device__ __forceinline__ int sigma64(int kk) {
  return 16 * ((kk & 7) >> 1) + 4 * (kk >> 4) + 2 * ((kk >> 3) & 1) +
         (kk & 1);
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

struct Params {
  const uint8_t* packed;  // (m, nb)
  int64_t nb, m, n, l;
  const float* center;    // (m,)
  const float* inv;       // (m,)
  const double* sumv;     // (l,)
  const float* shift;     // (2, l): three terms' alpha and beta, else 0
  float* out;             // (R, l), the depth unsplit
  float* raw;             // (splits, 2, R, l + 1 for three terms' count),
                          // the depth split
  int64_t items;          // m_tiles * n_tiles * splits
  int m_tiles, n_tiles;
  int ktiles, kps;        // stages of depth, and a split's share of them
  int ksub;               // 64-deep sub-tiles a stage
  int stages, splits, l_pad;
};

// PROD = false: cprod (M = variants, K = samples); true: prod (M = samples,
// K = variants). TERMS: bf16 terms of the operand. BNC: the column tile.
template <bool PROD, int TERMS, int BNC>
__global__ void __launch_bounds__(THREADS, 1)
plane_wgmma_kernel(const __grid_constant__ CUtensorMap mapB, const Params p) {
  constexpr bool CENTRED = TERMS == 3;             // K1, K2 (the note)
  constexpr int COLS = BNC - (CENTRED ? 1 : 0);    // l's columns a tile
  constexpr int N = TERMS * BNC;                   // wgmma columns
  constexpr int BP = b_planes(PROD);
  constexpr int B_BYTES = N * 128;                 // a plane's sub-tile
  constexpr int NACC = N / 2;
  constexpr int NMST = BNC / 2;                    // a thread's columns
  const int KS = p.ksub;
  const int STAGE = stage_bytes(PROD, TERMS, BNC, KS);
  const int PR = pack_rows(PROD, KS);
  const int CH = chunks(PROD, KS);
  const int RAW = raw_row(PROD, KS);

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + MAX_STAGES;
  uint8_t* tiles = base + 1024;

  const int S = p.stages;
  const int64_t M = PROD ? p.n : p.m;
  const int64_t per_split = static_cast<int64_t>(p.m_tiles) * p.n_tiles;
  const uint32_t pk_lo =
      static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p.packed)) & 15u;
  const uint32_t nb32 = static_cast<uint32_t>(p.nb);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1 + PRODUCERS);  // TMA arrival + cp.async threads
      mbar_init(empty + s, CONSUMERS / 32);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warpgroup ----
    const int pt = threadIdx.x - CONSUMERS;
    if (pt == 0) prefetch_map(&mapB);
    int s = 0;
    uint32_t ph = 0;
    const uintptr_t end16 =
        (reinterpret_cast<uintptr_t>(p.packed + p.m * p.nb) + 15) &
        ~static_cast<uintptr_t>(15);
    for (int64_t item = blockIdx.x; item < p.items; item += gridDim.x) {
      const int64_t sp = item / per_split, rem = item % per_split;
      const int nt = static_cast<int>(rem / p.m_tiles);
      const int mt = static_cast<int>(rem % p.m_tiles);
      const int r0 = mt * BM, b0r = nt * BNC;
      const int kt0 = static_cast<int>(sp) * p.kps;
      const int kt1 = min(p.ktiles, kt0 + p.kps);
      for (int kt = kt0; kt < kt1; ++kt) {
        mbar_wait(empty + s, ph ^ 1);
        uint8_t* st = tiles + s * STAGE;
        uint8_t* At = st + BP * KS * B_BYTES;
        const int k0 = kt * SUB * KS;
        // pack row j: the stage's bytes (cprod: samples k0.. of variant
        // r0 + r; prod: the item's samples of variant k0 + r) as the
        // aligned chunks that cover them; rows past m and chunks past the
        // pack fill zeros
        const int64_t b0 = PROD ? r0 / 4 : k0 / 4;
        for (int e = pt; e < PR * CH; e += PRODUCERS) {
          const int r = e / CH, w = e % CH;
          const int64_t j = (PROD ? k0 : r0) + r;
          const uintptr_t a =
              j < p.m ? reinterpret_cast<uintptr_t>(p.packed + j * p.nb + b0) &
                            ~static_cast<uintptr_t>(15)
                      : end16;
          const bool in = a + 16 * w < end16;
          cp_async16(At + r * RAW + 16 * w,
                     in ? reinterpret_cast<const void*>(a + 16 * w)
                        : static_cast<const void*>(p.packed),
                     in ? 16u : 0u);
        }
        cp_async_arrive(full + s);
        if (pt == 0) {
          mbar_expect_tx(full + s, BP * KS * B_BYTES);
          // plane pl's sub-tile i: its terms' BNC-row boxes, stacked
          for (int pl = 0; pl < BP; ++pl)
            for (int i = 0; i < KS; ++i)
#pragma unroll
              for (int t = 0; t < TERMS; ++t)
                tma_load(st + (pl * KS + i) * B_BYTES + t * BNC * 128, &mapB,
                         k0 + SUB * i, (pl * TERMS + t) * p.l_pad + b0r,
                         full + s);
        }
        if (++s == S) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = warp >> 2, w = warp & 3;
  const int g = lane >> 2, tg = lane & 3;
  // prod: the byte of this thread's two samples (2g, 2g + 1 of the warp's
  // 16) in the item's 32, and the nibble that holds them
  const int bcol = 16 * wg + 4 * w + (g >> 1);
  const int nsh = 4 * (g & 1);
  float acc[2][NACC];   // the tensor cores' sums over one stage
  float mst[2][NMST];   // the item's sums, terms added, in f32 registers
  int s = 0;
  uint32_t ph = 0;
  for (int64_t item = blockIdx.x; item < p.items; item += gridDim.x) {
    const int64_t sp = item / per_split, rem = item % per_split;
    const int nt = static_cast<int>(rem / p.m_tiles);
    const int mt = static_cast<int>(rem % p.m_tiles);
    const int64_t r0 = static_cast<int64_t>(mt) * BM;
    const int c0 = nt * COLS;
    const int kt0 = static_cast<int>(sp) * p.kps;
    const int kt1 = min(p.ktiles, kt0 + p.kps);
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < NMST; ++e) mst[q][e] = 0.f;
    // cprod: the offsets of this thread's variant rows g, g + 8 in their
    // copied chunks, before the stage's first byte
    uint32_t orow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      orow[h] = pk_lo + static_cast<uint32_t>(r0 + 64 * wg + 16 * w + g + 8 * h) *
                            nb32;
    for (int kt = kt0; kt < kt1; ++kt) {
      mbar_wait(full + s, ph);
      const uint8_t* st = tiles + s * STAGE;
      const uint8_t* At = st + BP * KS * B_BYTES;
      const uint64_t dB = sw128_desc(st);
      const uint32_t k0 = static_cast<uint32_t>(kt) * SUB * KS;
      // prod: offset of the stage's first row in its copied chunks
      const uint32_t o0 = pk_lo + k0 * nb32 + static_cast<uint32_t>(r0 / 4);
      for (int qp = 0; qp < KS; ++qp) {
        // cprod: bytes 4tg.. of sub-tile qp's 16 in rows g, g + 8
        uint32_t wrd[2] = {0u, 0u};
        if (!PROD) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uintptr_t ad = reinterpret_cast<uintptr_t>(
                At + (64 * wg + 16 * w + g + 8 * h) * RAW +
                ((orow[h] + k0 / 4) & 15u) + 16 * qp + 4 * tg);
            const uint32_t* q = reinterpret_cast<const uint32_t*>(
                ad & ~static_cast<uintptr_t>(3));
            wrd[h] =
                __funnelshift_r(q[0], q[1], 8 * static_cast<uint32_t>(ad & 3));
          }
        }
        // the sub-tile's fragments, all decoded before its wgmmas: a
        // register that a wgmma reads must not be written while wgmmas run
        // (ptxas then serialises them all)
        uint32_t a[2][4][4];  // [plane][k-step][register]
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (!PROD) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t u = code_selectors((wrd[h] >> (8 * ks)) & 0xFFu);
              a[0][ks][h] = __byte_perm(T_LO, T_HI, u);
              a[0][ks][2 + h] = __byte_perm(T_LO, T_HI, u >> 16);
              a[1][ks][h] = __byte_perm(N_LO, N_HI, u);
              a[1][ks][2 + h] = __byte_perm(N_LO, N_HI, u >> 16);
            }
          } else {
#pragma unroll
            for (int pp = 0; pp < 2; ++pp) {
              // variant rows v, v + 1 of the stage
              const int v = SUB * qp + 16 * ks + 2 * tg + 8 * pp;
              const uint32_t x0 =
                  At[v * RAW + ((o0 + static_cast<uint32_t>(v) * nb32) & 15u) +
                     bcol];
              const uint32_t x1 =
                  At[(v + 1) * RAW +
                     ((o0 + static_cast<uint32_t>(v + 1) * nb32) & 15u) + bcol];
              const uint32_t c = __byte_perm(x0, x1, 0x0040u) >> nsh;
              const uint32_t s0 = (c & 0x0303u) * 0x11u + 0x4040u;
              const uint32_t s1 = ((c >> 2) & 0x0303u) * 0x11u + 0x4040u;
              a[0][ks][2 * pp] = __byte_perm(T_LO, T_HI, s0);
              a[0][ks][2 * pp + 1] = __byte_perm(T_LO, T_HI, s1);
              a[1][ks][2 * pp] = __byte_perm(N_LO, N_HI, s0);
              a[1][ks][2 * pp + 1] = __byte_perm(N_LO, N_HI, s1);
            }
          }
        }
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int pl = 0; pl < 2; ++pl)
            wgmma_bf16::Op<N>::rs(
                acc[pl], a[pl][ks],
                dB + ((PROD ? pl : 0) * KS + qp) * (B_BYTES >> 4) + 2 * ks,
                qp > 0 || ks > 0);  // the stage's first k-step starts anew
        wgmma_commit();
        // the other warpgroup decodes while these run
        wgmma_wait<0>();
      }
      // the stage's sums into f32 registers, each column's terms added in
      // order: the tensor cores' f32 accumulation drops bits (K2 missed
      // 1e-5 of a float64 product summing 100,000 variants in them); 16
      // k-steps a sum keeps it to a few ulps
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int x = 0; x < NMST; ++x) {
          const int j = x >> 2, r = x & 3;  // x = 4j + 2h + e
          float v = acc[q][4 * j + r];
#pragma unroll
          for (int t = 1; t < TERMS; ++t) v = v + acc[q][4 * (j + t * BNC / 8) + r];
          mst[q][x] = mst[q][x] + v;
        }
      if (lane == 0) mbar_arrive(empty + s);
      if (++s == S) {
        s = 0;
        ph ^= 1;
      }
    }
    // accumulator d[4j + 2h + e]: fragment row g + 8h, column 8j + 2tg + e
    // of this warp's 16 rows (prod's fragment row (g, h) is sample 2g + h);
    // term t of column c is column t BNC + c, in the same thread; mst holds
    // the first term block's layout. The three terms' count column, BNC -
    // 1, is lane tg = 3's, e = 1, j = BNC / 8 - 1 (same g, so same row).
    const int64_t lr = p.l + (CENTRED ? 1 : 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float cnt[2] = {0.f, 0.f};  // three terms: T and N of the row
      if constexpr (CENTRED) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
          cnt[q] = __shfl_sync(0xFFFFFFFFu, mst[q][4 * (BNC / 8 - 1) + 2 * h + 1],
                               lane | 3);
      }
      const int64_t row = r0 + 64 * wg + 16 * w + (PROD ? 2 * g + h : g + 8 * h);
      if (row >= M) continue;
      float Ar = 0.f, sr = 0.f;
      double Ad = 0.0;  // K1: A exact in float64
      if (!PROD && p.splits == 1) {
        sr = p.inv[row];
        Ar = (2.0f - p.center[row]) * sr;
        Ad = (2.0 - static_cast<double>(p.center[row])) * sr;
      }
      float* slice = p.raw + sp * 2 * M * lr;
#pragma unroll
      for (int j = 0; j < BNC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int x = 8 * j + 2 * tg + e;
          const int64_t col = c0 + x;
          if (x >= COLS || col >= p.l) continue;
          const float pt = mst[0][4 * j + 2 * h + e];
          const float pna = mst[1][4 * j + 2 * h + e];
          if (p.splits > 1) {
            slice[row * lr + col] = pt;
            slice[(M + row) * lr + col] = pna;
          } else if constexpr (CENTRED) {
            const double ga = p.shift[col], gb = p.shift[p.l + col];
            double v;
            if constexpr (PROD) {
              v = ((p.sumv[col] - ga * cnt[0]) - gb * cnt[1]) -
                  static_cast<double>(pna) - static_cast<double>(pt);
            } else {
              const double sd = sr;
              v = (((p.sumv[col] - gb * cnt[1]) * Ad - ga * cnt[0] * sd) -
                   static_cast<double>(pna) * Ad) -
                  static_cast<double>(pt) * sd;
            }
            p.out[row * p.l + col] = static_cast<float>(v);
          } else {
            const float sv = static_cast<float>(p.sumv[col]);
            p.out[row * p.l + col] =
                PROD ? (sv - pna) - pt : (sv - pna) * Ar - pt * sr;
          }
        }
      if (CENTRED && p.splits > 1 && nt == 0 && tg == 0) {
        slice[row * lr + p.l] = cnt[0];
        slice[(M + row) * lr + p.l] = cnt[1];
      }
    }
  }
}

// out (R, l) from the raw plane sums of every depth split (splits, 2, R,
// l + three terms' count column), added in split order
template <bool PROD, bool CENTRED>
__global__ void plane_epilogue_kernel(const float* __restrict__ raw,
                                      int splits, int64_t R, int64_t l,
                                      const double* __restrict__ sumv,
                                      const float* __restrict__ shift,
                                      const float* __restrict__ center,
                                      const float* __restrict__ inv,
                                      float* __restrict__ out) {
  const int64_t lr = l + (CENTRED ? 1 : 0), count = R * lr;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       e < R * l; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = e / l, r = e % l, x = i * lr + r;
    float pt = raw[x], pna = raw[count + x];
    for (int sp = 1; sp < splits; ++sp) {
      pt = pt + raw[2 * sp * count + x];
      pna = pna + raw[(2 * sp + 1) * count + x];
    }
    if (CENTRED) {
      // integers, exact in each split (a run of at most MAX_COUNT_DEPTH)
      // and in float64 over the splits, past 2^24
      double T = 0.0, N = 0.0;
      for (int sp = 0; sp < splits; ++sp) {
        T += static_cast<double>(raw[2 * sp * count + i * lr + l]);
        N += static_cast<double>(raw[(2 * sp + 1) * count + i * lr + l]);
      }
      const double ga = shift[r], gb = shift[l + r];
      double v;
      if (PROD) {
        v = ((sumv[r] - ga * T) - gb * N) - static_cast<double>(pna) -
            static_cast<double>(pt);
      } else {
        const double sd = inv[i];
        const double Ad = (2.0 - static_cast<double>(center[i])) * sd;
        v = (((sumv[r] - gb * N) * Ad - ga * T * sd) -
             static_cast<double>(pna) * Ad) -
            static_cast<double>(pt) * sd;
      }
      out[e] = static_cast<float>(v);
    } else if (PROD) {
      out[e] = (static_cast<float>(sumv[r]) - pna) - pt;
    } else {
      const float s = inv[i];
      out[e] = (static_cast<float>(sumv[r]) - pna) * ((2.0f - center[i]) * s) -
               pt * s;
    }
  }
}

// The operand, in three steps over 64 depth rows d of W (depth, l) f32 a
// block. prod scales row d by inv[d] (zB, the T plane's) and by A[d] =
// (2 - c[d]) inv[d] (zA, the NA plane's).
// 1. partial (4, l, blocks) float64: the block's sums of zA, |zB|, |zA|
//    and 2 - c (prod), or of V, |V|, |V| and 1 (cprod: its alpha and beta
//    are then both gamma, the mean of V's column).
template <bool PROD>
__global__ void plane_partial_kernel(const float* __restrict__ W,
                                     int64_t depth, int64_t l,
                                     const float* __restrict__ center,
                                     const float* __restrict__ inv,
                                     double* __restrict__ partial) {
  const int64_t col = blockIdx.y * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (col >= l) return;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * SUB;
  double q[4] = {0.0, 0.0, 0.0, 0.0};
  for (int64_t d = k0; d < k0 + SUB && d < depth; ++d) {
    const float x = W[d * l + col];
    if (PROD) {
      const float s = inv[d];
      const float zb = x * s, za = x * ((2.0f - center[d]) * s);
      q[0] += za;
      q[1] += fabsf(zb);
      q[2] += fabsf(za);
      q[3] += 2.0f - center[d];
    } else {
      q[0] += x;
      q[1] += fabsf(x);
      q[2] += fabsf(x);
      q[3] += 1.0;
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    partial[(k * l + col) * static_cast<int64_t>(gridDim.x) + blockIdx.x] = q[k];
}

// 2. One block a column r: sumv[r] = the sum of its blocks' sums (each
//    thread's share, blocks t, t + 256, ..., added in order, then the
//    threads' in a fixed tree); three terms' shift[r] = alpha and
//    shift[l + r] = beta (see the note), else 0.
template <bool CENTRED>
__global__ void __launch_bounds__(256)
plane_sum_kernel(const double* __restrict__ partial, int64_t blocks,
                 int64_t l, int64_t depth, double* __restrict__ sumv,
                 float* __restrict__ shift) {
  __shared__ double red[4][256];
  const int64_t r = blockIdx.x;
  double q[4] = {0.0, 0.0, 0.0, 0.0};
  for (int64_t b = threadIdx.x; b < blocks; b += 256)
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] += partial[(k * l + r) * blocks + b];
#pragma unroll
  for (int k = 0; k < 4; ++k) red[k][threadIdx.x] = q[k];
  __syncthreads();
  for (unsigned h = 128; h > 0; h >>= 1) {
    if (threadIdx.x < h)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        red[k][threadIdx.x] = red[k][threadIdx.x] + red[k][threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  sumv[r] = red[0][0];
  float alpha = 0.f, beta = 0.f;
  if (CENTRED) {
    const double a0 = red[3][0] > 0.0 ? red[0][0] / red[3][0] : 0.0;
    const double b0 = red[0][0] / static_cast<double>(depth);
    if (fabs(a0) * 1024.0 * depth >= red[1][0])
      alpha = __bfloat162float(__float2bfloat16_rn(static_cast<float>(a0)));
    if (fabs(b0) * 1024.0 * depth >= red[2][0])
      beta = __bfloat162float(__float2bfloat16_rn(static_cast<float>(b0)));
  }
  shift[r] = alpha;
  shift[l + r] = beta;
}

// 3. Bop (planes, TERMS, l_pad, ldk) bf16: each operand row's terms in the
//    kernel's depth order, zero past l and past the depth. Three terms'
//    operand rows come in column tiles of bn: bn - 1 of l's columns,
//    centred by shift, then the count row (1 down the depth).
template <bool PROD, int TERMS>
__global__ void __launch_bounds__(256)
plane_write_kernel(const float* __restrict__ W, int64_t depth, int64_t l,
                   int l_pad, int bn, int64_t ldk,
                   const float* __restrict__ center,
                   const float* __restrict__ inv,
                   const float* __restrict__ shift,
                   uint16_t* __restrict__ Bop) {
  constexpr int NB = PROD ? 2 : 1;
  constexpr bool CENTRED = TERMS == 3;
  __shared__ float tile[NB][64][65];
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * 64;
  const int r0 = blockIdx.y * 64;
  for (int e = threadIdx.x; e < 64 * 64; e += blockDim.x) {
    const int dk = e / 64, c = e % 64;
    const int64_t d = k0 + dk;
    const int r = r0 + c;
    const bool count = CENTRED && r % bn == bn - 1;
    const int64_t col = CENTRED ? (r / bn) * (bn - 1) + r % bn : r;
    float v0 = 0.f, v1 = 0.f;
    if (d < depth && count) {
      v0 = v1 = 1.f;
    } else if (d < depth && col < l) {
      const float x = W[d * l + col];
      if (PROD) {
        const float s = inv[d];
        v0 = x * s;
        v1 = x * ((2.0f - center[d]) * s);
        if (CENTRED) {
          v0 = v0 - shift[col];
          v1 = v1 - shift[l + col];
        }
      } else {
        v0 = CENTRED ? x - shift[col] : x;
      }
    }
    tile[0][dk][c] = v0;
    tile[NB - 1][dk][c] = PROD ? v1 : v0;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < NB * 64 * 64; e += blockDim.x) {
    const int pl = e / 4096, c = (e / 64) % 64, kk = e % 64;
    const int64_t r = r0 + c;
    if (r >= l_pad) continue;
    float x = tile[pl][PROD ? kk : sigma64(kk)][c];
#pragma unroll
    for (int t = 0; t < TERMS; ++t) {
      const __nv_bfloat16 b = __float2bfloat16_rn(x);
      Bop[((pl * TERMS + t) * static_cast<int64_t>(l_pad) + r) * ldk + k0 + kk] =
          __bfloat16_as_ushort(b);
      x = x - __bfloat162float(b);
    }
  }
}

template <bool PROD, int TERMS, int BNC>
int launch_gemm(const CUtensorMap& map, const Params& p, int grid,
                cudaStream_t st) {
  auto kern = plane_wgmma_kernel<PROD, TERMS, BNC>;
  static bool opted_in = false;  // > 48 KB of shared memory, once
  if (!opted_in) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    opted_in = true;
  }
  kern<<<grid, THREADS, smem_bytes(PROD, TERMS, BNC, p.ksub, p.stages), st>>>(
      map, p);
  return static_cast<int>(cudaGetLastError());
}

// the compiled column tiles (ops/geno_kernels.py::PLANE_BNC): TERMS x BNC
// <= 96 wgmma columns a plane, and their registers with the f32 sums
template <bool PROD, int TERMS>
int dispatch_width(int bnc, const CUtensorMap& map, const Params& p, int grid,
                   cudaStream_t st) {
  switch (bnc) {
    case 8: return launch_gemm<PROD, TERMS, 8>(map, p, grid, st);
    case 16: return launch_gemm<PROD, TERMS, 16>(map, p, grid, st);
    case 24: return launch_gemm<PROD, TERMS, 24>(map, p, grid, st);
    case 32: return launch_gemm<PROD, TERMS, 32>(map, p, grid, st);
    default: break;
  }
  if constexpr (TERMS == 2) {
    if (bnc == 40) return launch_gemm<PROD, 2, 40>(map, p, grid, st);
  }
  return -1;
}

bool compiled_width(int terms, int bnc) {
  return bnc % 8 == 0 && bnc >= 8 && bnc <= (terms == 2 ? 40 : 32);
}

// the compiled families: K7 (two terms) and K1, K2 (three), each in both
// directions
bool compiled_family(int terms) { return terms == 2 || terms == 3; }

// l's columns in a column tile of bn operand rows (three terms: the last
// is the count)
int64_t tile_cols(int terms, int bn) { return bn - (terms == 3 ? 1 : 0); }

// the count column's plane sums (at most 2 x the depth of a split run) are
// exact while below 2^24: three terms split a deeper depth into runs of at
// most this (ops/geno_kernels.py::plane_plan), and the epilogue adds the
// runs' counts in float64
constexpr int64_t MAX_COUNT_DEPTH = int64_t{1} << 23;

}  // namespace

extern "C" {

// Bop (planes, terms, l_pad, ldk) bf16, sumv (l,) f64 and shift (2, l) f32
// from W (depth, l) f32: cprod (prod = 0) W = V, one plane, sumv its column
// sums; prod W = U scaled into zB and zA, sumv the column sums of zA; three
// terms (K1, K2) centre them by shift and lay the operand rows out in
// column tiles of bn, each ending in its count row. partial: (4, l, ldk /
// 64) f64 scratch.
int geno_plane_prep(int prod, int terms, const void* W, int64_t depth,
                    int64_t l, int64_t l_pad, int bn, int64_t ldk,
                    const void* center, const void* inv, void* Bop,
                    void* partial, void* sumv, void* shift, void* stream) {
  if (!compiled_family(terms) || depth < 1 || l < 1 || bn < 2 ||
      l_pad % bn != 0 || l_pad / bn * tile_cols(terms, bn) < l ||
      ldk % SUB != 0 || ldk < depth || l_pad > (1 << 30) || l > (1 << 30))
    return -1;
  const auto* w = static_cast<const float*>(W);
  const auto* c = static_cast<const float*>(center);
  const auto* s = static_cast<const float*>(inv);
  auto* b = static_cast<uint16_t*>(Bop);
  auto* pa = static_cast<double*>(partial);
  auto* sv = static_cast<double*>(sumv);
  auto* sh = static_cast<float*>(shift);
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t blocks = ldk / SUB;
  const dim3 pgrid(static_cast<unsigned>(blocks),
                   static_cast<unsigned>(cdiv(l, 128)));
  if (prod) plane_partial_kernel<true><<<pgrid, 128, 0, st>>>(w, depth, l, c, s, pa);
  else plane_partial_kernel<false><<<pgrid, 128, 0, st>>>(w, depth, l, c, s, pa);
  const unsigned sgrid = static_cast<unsigned>(l);
  if (terms == 3)
    plane_sum_kernel<true><<<sgrid, 256, 0, st>>>(pa, blocks, l, depth, sv, sh);
  else
    plane_sum_kernel<false><<<sgrid, 256, 0, st>>>(pa, blocks, l, depth, sv, sh);
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(cdiv(l_pad, 64)));
  const int lp = static_cast<int>(l_pad);
  if (!prod && terms == 2)
    plane_write_kernel<false, 2><<<grid, 256, 0, st>>>(w, depth, l, lp, bn, ldk, c, s, sh, b);
  else if (!prod)
    plane_write_kernel<false, 3><<<grid, 256, 0, st>>>(w, depth, l, lp, bn, ldk, c, s, sh, b);
  else if (terms == 2)
    plane_write_kernel<true, 2><<<grid, 256, 0, st>>>(w, depth, l, lp, bn, ldk, c, s, sh, b);
  else
    plane_write_kernel<true, 3><<<grid, 256, 0, st>>>(w, depth, l, lp, bn, ldk, c, s, sh, b);
  return static_cast<int>(cudaGetLastError());
}

// The GEMM on the plan of ops/geno_kernels.py::plane_plan: column tile bn
// (a compiled width: TERMS x bn wgmma columns, bn of them l's, bn - 1 for
// three terms) x n_tiles, l_pad = bn x n_tiles operand rows a term,
// `stages` ring stages of ksub 64-deep sub-tiles, `grid` persistent CTAs,
// the depth in `splits` runs of kps stages (three terms: each run at most
// MAX_COUNT_DEPTH deep). splits = 1 writes out (R, l) through the fused
// epilogue; splits > 1 the raw plane sums (splits, 2, R, l + 1 for three
// terms' count) for geno_plane_epilogue. Bop, sumv and
// shift as geno_plane_prep writes them, Bop 16-byte aligned (the depth
// past ldk reads as zeros).
int geno_plane_gemm(int prod, int terms, const void* packed, int64_t m,
                    int64_t nb, int64_t n, const void* Bop, int64_t ldk,
                    int64_t l, int64_t l_pad, const void* center,
                    const void* inv, const void* sumv, const void* shift,
                    void* out, void* raw, int bn, int n_tiles, int ksub,
                    int stages, int grid, int kps, int splits, void* stream) {
  const int64_t M = prod ? n : m, K = prod ? m : n;
  const int64_t ktiles = cdiv(K, SUB * static_cast<int64_t>(ksub));
  const int64_t m_tiles = cdiv(M, BM);
  const int64_t cols = tile_cols(terms, bn);
  if (!compiled_family(terms) || !compiled_width(terms, bn) || m < 1 ||
      n < 1 || l < 1 || nb != cdiv(n, 4) ||
      static_cast<int64_t>(n_tiles) * bn != l_pad ||
      static_cast<int64_t>(n_tiles) * cols < l ||
      static_cast<int64_t>(n_tiles - 1) * cols >= l ||
      (terms == 3 &&
       static_cast<int64_t>(kps) * SUB * ksub > MAX_COUNT_DEPTH) ||
      (ksub != 1 && ksub != 2 && ksub != 4) || stages < 2 ||
      stages > MAX_STAGES || kps < 1 || splits < 1 ||
      cdiv(ktiles, kps) != splits || grid < 1 || ktiles > (1 << 30) ||
      m_tiles > (1 << 30) || ldk % SUB != 0 || ldk < K ||
      (prod ? 2 : 1) * terms * l_pad > (1 << 30) ||
      smem_bytes(prod, terms, bn, ksub, stages) > MAX_SMEM ||
      reinterpret_cast<uintptr_t>(Bop) % 16 != 0)
    return -1;
  Params p{};
  p.packed = static_cast<const uint8_t*>(packed);
  p.nb = nb;
  p.m = m;
  p.n = n;
  p.l = l;
  p.center = static_cast<const float*>(center);
  p.inv = static_cast<const float*>(inv);
  p.sumv = static_cast<const double*>(sumv);
  p.shift = static_cast<const float*>(shift);
  p.out = static_cast<float*>(out);
  p.raw = static_cast<float*>(raw);
  p.m_tiles = static_cast<int>(m_tiles);
  p.n_tiles = n_tiles;
  p.items = m_tiles * n_tiles * splits;
  p.ktiles = static_cast<int>(ktiles);
  p.kps = kps;
  p.ksub = ksub;
  p.stages = stages;
  p.splits = splits;
  p.l_pad = static_cast<int>(l_pad);
  CUtensorMap map;
  if (!make_map(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, Bop, ldk,
                (prod ? 2 : 1) * terms * l_pad, 2 * ldk, SUB, bn))
    return -2;
  const int g = static_cast<int>(p.items < grid ? p.items : grid);
  auto st = static_cast<cudaStream_t>(stream);
  if (!prod)
    return terms == 2 ? dispatch_width<false, 2>(bn, map, p, g, st)
                      : dispatch_width<false, 3>(bn, map, p, g, st);
  return terms == 2 ? dispatch_width<true, 2>(bn, map, p, g, st)
                    : dispatch_width<true, 3>(bn, map, p, g, st);
}

// out (R, l) f32 from raw (splits, 2, R, l + 1 for three terms) and the
// epilogue, the splits added in order (pt, pna in f32; three terms' counts
// T, N in float64). cprod: center, inv are the (R,) variant vectors.
int geno_plane_epilogue(int prod, int terms, const void* raw, int splits,
                        int64_t R, int64_t l, const void* sumv,
                        const void* shift, const void* center,
                        const void* inv, void* out, void* stream) {
  const auto* r = static_cast<const float*>(raw);
  const auto* sv = static_cast<const double*>(sumv);
  const auto* sh = static_cast<const float*>(shift);
  const auto* c = static_cast<const float*>(center);
  const auto* s = static_cast<const float*>(inv);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t blocks = cdiv(R * l, 256);
  const unsigned grid = static_cast<unsigned>(blocks < 8192 ? blocks : 8192);
  if (prod && terms == 3)
    plane_epilogue_kernel<true, true><<<grid, 256, 0, st>>>(r, splits, R, l, sv, sh, c, s, o);
  else if (terms == 3)
    plane_epilogue_kernel<false, true><<<grid, 256, 0, st>>>(r, splits, R, l, sv, sh, c, s, o);
  else if (prod)
    plane_epilogue_kernel<true, false><<<grid, 256, 0, st>>>(r, splits, R, l, sv, sh, c, s, o);
  else
    plane_epilogue_kernel<false, false><<<grid, 256, 0, st>>>(r, splits, R, l, sv, sh, c, s, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
