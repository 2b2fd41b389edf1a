// K6 and K8: the genotype operator on exact int8 bit planes, with int32
// tensor-core accumulation, for Hopper (sm_90a).
//
// K6 replaces the JAX package's Pallas TPU kernels of the mxu="int8" scheme
//   bigsnpr_tpu/ops/pallas_kernels.py  _cprod_kernel_i8, _cprod_kernel_i8_nona
//       (entry _pallas_cprod_i8):  raw(m, [T|NA] x 4l) = planes . Q digits
//   bigsnpr_tpu/ops/pallas_kernels.py  _prod_kernel_i8, _prod_kernel_i8_nona
//       (entry _pallas_prod_i8):   raw(n, [T|NA] x 4l) = planes^T . Z digits
// and K8 (MAT = true) those of the mxu="int8m" scheme
//   _cprod_kernel_i8m, _cprod_kernel_i8m_na (entry _pallas_cprod_i8m),
//   _prod_kernel_i8m, _prod_kernel_i8m_na (entry _pallas_prod_i8m),
// the same GEMMs on T (and NA) planes materialized once as int8 arrays
// (m, ldn), true sample order, ldn = n rounded up to 16 and the pad columns
// zero (ops/geno_kernels.py::int8m_planes); and the recombination and
// epilogue that follow them there.
//
// The algebra (ops/geno_kernels.py has it in torch): the standardized value
// of 2-bit code g with bits b0 (low), b1 is x~ = A - s t - A na, with
// t = b1 + (b0 & b1) in {0,1,2}, na = b0 & ~b1 in {0,1}, A = (2 - c) s.
// The float operand is split by the wrapper into 4 radix-128 int8 digit
// rows per column (`int8_planes`), so every product is an exact integer
// sum, accumulated here in int32. The f32 epilogue recombines the digits,
//   comb = ((w0 + w1/128) + w2/128^2) + w3/128^3,
// and gives (sum - comb_na sc_na) A - (comb_t sc_t) s for cprod and
// (sum - comb_na sc_na) - comb_t sc_t for prod, per element in that order.
// Built with --fmad=false, so it rounds as the twin's separate torch ops do.
//
// GEMM shape: rows M (cprod: variants, prod: samples), columns N = 4l digit
// rows, depth K (cprod: samples, prod: variants). The digits are (4l, ldd)
// int8 rows, zero past the contraction length, ldd a multiple of 128.
//
// What bounds it on an H100, at n = 50,000, m = 100,000, l = 20: each plane
// is 2 * 80 * n * m = 8.0e11 int8 operations, 0.40 ms at the 1,979 TOP/s
// dense peak (two planes with NA: 0.81 ms). K6 reads 1.25 GB of packed
// bytes (0.37 ms at 3.35 TB/s): its bound is the operations. K8 reads the
// planes, 5.0 GB a plane (1.49 ms, 2.99 ms with NA): its bound is the bytes.
//
// Design (one template, i8_wgmma_kernel<PROD, NONA, MAT, BN>):
// - A persistent grid, one CTA an SM, walks work items (M tile x BN-column
//   tile x depth split). A CTA is two consumer warpgroups and a producer:
//   one warp for K8 (288 threads, up to 224 registers a thread), a
//   warpgroup for K6 (384 threads, up to 168), so no setmaxnreg is needed
//   for two accumulators of BN/2 registers at BN <= 128. A warpgroup holds
//   one 64-row wgmma tile (M tile 128), or two in an NA-free prod (M tile
//   256: a stage then reads 256 contiguous bytes of each plane row, where
//   K8 prod's 128 left it well below the HBM rate K8 cprod reaches on the
//   same bytes; see i8_variants_probe.py).
// - The producer keeps a ring of `stages` 128-deep stages in flight, with
//   a full and an empty mbarrier a stage. The digit tile (BN rows x 128,
//   K-major, 128-byte swizzle) comes by TMA (a 2-D tensor map on the
//   digits). K8's planes come by TMA too (128 x 128 boxes of the (m, ldn)
//   planes). K6's pack has row stride nb = ceil(n / 4), which TMA's 16-byte
//   stride rule refuses: a producer warpgroup copies each of the 128
//   packed rows' 32 bytes as the three aligned 16-byte chunks that cover
//   them, by cp.async (one thread a row; cp.async.mbarrier.arrive signals
//   the stage), and the reader recomputes a row's offset in its first
//   chunk. (One producer warp of 4-byte cp.asyncs, or one bulk copy a
//   row, set K6's time on an H100, not the tensor cores.)
// - Tensor cores: wgmma.mma_async m64nBNk32 .s32.s8.s8 (wgmma_s8.cuh),
//   B from shared memory. int8 wgmma takes only K-major operands:
//     K8 cprod: the plane tile is K-major already (A from shared memory);
//     K6 cprod: a packed byte is 4 consecutive samples of one variant, one
//       32-bit register of the A fragment, so the consumers decode their
//       fragments straight into registers (A from registers);
//     prod (K6 and K8): the tile is variants x samples, MN-major; each
//       consumer warpgroup turns its samples K-major with 4 x 4 byte
//       transposes (geno_decode::transpose4), 16 variants x 4 samples a
//       thread, one 16-byte store a sample, into a 128-byte-swizzled tile:
//       K6 into two staging tiles used in turn, K8 over the stage's own
//       plane tile once both warpgroups have read it (which keeps K8's
//       ring deep). A stage's transposes overlap the previous stage's
//       wgmma. No sample-major copy of the planes is kept.
// - The accumulators stay in registers for the item's whole depth and are
//   stored once: plain int32 stores into an uninitialized raw buffer, or,
//   when the plan splits the depth (short M), int32 atomicAdds into a
//   zeroed one. Integer sums are exact, so every plan gives the same bits,
//   and K8's raw sums equal K6's. A raw sum is at most 254 K in absolute
//   value: the wrapper refuses K > 8,000,000.
// - The launch plan (tile width, stages, grid, splits) is made in Python
//   (ops/geno_kernels.py::i8_plan); geno_i8_gemm checks it and refuses
//   what it cannot run.
//
// C interface for ctypes: every function returns cudaGetLastError() after
// its launches, as an int, or a negative code for a refused plan (-1) or a
// tensor map the CUDA driver would not encode (-2). Launches go to the stream
// passed in.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "geno_decode.cuh"
#include "ring.cuh"
#include "wgmma_s8.cuh"

namespace {

using geno_decode::cdiv;
using namespace ring;

constexpr int BK = 128;           // depth of one stage, in bytes
constexpr int TILE = 128 * 128;   // bytes of a 128 x 128 int8 tile
constexpr int CONSUMERS = 256;    // two consumer warpgroups
constexpr int MAX_STAGES = 8;
constexpr int HEAD = 2048;        // barriers and the alignment slack
constexpr int MAX_SMEM = 232448;  // 227 KB a block on sm_90

// and the producer: one warp for K8's TMA, a warpgroup for K6's cp.async
__host__ __device__ constexpr int threads(bool mat) {
  return CONSUMERS + (mat ? 32 : 128);
}

// 64-row wgmma tiles a consumer warpgroup holds: two for an NA-free prod
// (a 256-sample item reads 256 contiguous bytes of each plane row, twice
// what a 128-sample item does; the accumulators of two planes would not
// fit), else one
__host__ __device__ constexpr int msub(bool prod, bool nona) {
  return prod && nona ? 2 : 1;
}

// K6: bytes a packed row gives a stage (32 = 128 samples in cprod, BM / 4
// in prod) plus one 16-byte chunk for its misalignment
__host__ __device__ constexpr int raw_row(bool prod, bool nona) {
  return 16 * ((prod ? 32 * msub(prod, nona) : 32) / 16 + 1);
}

__host__ __device__ constexpr int stage_bytes(bool prod, bool nona, bool mat,
                                              int bn) {
  return ((prod && !nona) ? 2 : 1) * bn * BK +
         (mat ? (nona ? 1 : 2) * msub(prod, nona) * TILE
              : 128 * raw_row(prod, nona));
}

// K6 prod transposes into two staging tiles a plane; K8 prod in place
__host__ __device__ constexpr int smem_bytes(bool prod, bool nona, bool mat,
                                             int bn, int stages) {
  return HEAD + stages * stage_bytes(prod, nona, mat, bn) +
         (prod && !mat ? 2 * (nona ? 1 : 2) * msub(prod, nona) * TILE : 0);
}

// barrier of one consumer warpgroup (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// barrier of both consumer warpgroups (id 3)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// ---- the GEMM --------------------------------------------------------------

struct Params {
  const uint8_t* packed;  // K6: (m, nb) pack
  int64_t nb;
  int64_t m, n, N4;
  int32_t* raw;           // (planes, M, N4)
  int64_t items;          // m_tiles * n_tiles * splits
  int m_tiles, n_tiles;
  int ktiles, kps;        // depth tiles, and a split's share of them
  int stages;
  int atomic;             // the depth is split: atomicAdd into zeroed raw
};

// PROD = false: cprod (M = variants, K = samples); true: prod (M = samples,
// K = variants). NONA drops the NA plane. MAT: K8 (A from the materialized
// planes), else K6 (A decoded from the pack). BN: the column tile.
template <bool PROD, bool NONA, bool MAT, int BN>
__global__ void __launch_bounds__(threads(MAT), 1)
i8_wgmma_kernel(const __grid_constant__ CUtensorMap mapT,
                const __grid_constant__ CUtensorMap mapNA,
                const __grid_constant__ CUtensorMap mapDT,
                const __grid_constant__ CUtensorMap mapDNA, const Params p) {
  constexpr int P = NONA ? 1 : 2;                  // planes
  constexpr int BP = (PROD && !NONA) ? 2 : 1;      // digit tiles a stage
  constexpr int MS = msub(PROD, NONA);             // 64-row tiles a warpgroup
  constexpr int BM = 128 * MS;                     // rows of a work item
  constexpr int WROWS = 64 * MS;                   // rows of a warpgroup
  constexpr int B_BYTES = BN * BK;
  constexpr int STAGE = stage_bytes(PROD, NONA, MAT, BN);
  constexpr int RAW = raw_row(PROD, NONA);         // K6: a packed row's bytes
  constexpr int CHUNKS = RAW / 16;
  constexpr bool RS = !PROD && !MAT;               // K6 cprod: A in registers
  constexpr int NACC = BN / 2;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + MAX_STAGES;
  uint8_t* tiles = base + 1024;
  uint8_t* staging = tiles + p.stages * STAGE;     // K6 prod: 2 x P x MS tiles

  const int S = p.stages;
  const int64_t M = PROD ? p.n : p.m;
  const int64_t per_split = static_cast<int64_t>(p.m_tiles) * p.n_tiles;
  const uint32_t pk_lo =
      static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p.packed)) & 15u;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, MAT ? 1 : 1 + 128);  // K6: + cp.async arrivals
      mbar_init(empty + s, CONSUMERS / 32);
    }
    fence_mbarrier_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer ----
    uint32_t it = 0;
    const uintptr_t end16 =
        (reinterpret_cast<uintptr_t>(p.packed + p.m * p.nb) + 15) &
        ~static_cast<uintptr_t>(15);
    for (int64_t item = blockIdx.x; item < p.items; item += gridDim.x) {
      const int64_t sp = item / per_split, rem = item % per_split;
      const int nt = static_cast<int>(rem / p.m_tiles);
      const int mt = static_cast<int>(rem % p.m_tiles);
      const int r0 = mt * BM, c0 = nt * BN;
      const int kt0 = static_cast<int>(sp) * p.kps;
      const int kt1 = min(p.ktiles, kt0 + p.kps);
      for (int kt = kt0; kt < kt1; ++kt, ++it) {
        const int s = static_cast<int>(it % S);
        mbar_wait(empty + s, ((it / S) & 1) ^ 1);
        uint8_t* st = tiles + s * STAGE;
        uint8_t* At = st + BP * B_BYTES;
        const int k0 = kt * BK;
        if (!MAT) {
          // row j0 + r of the pack (r: this thread), the bytes of this
          // stage's samples (cprod) or of the item's (prod): the aligned
          // 16-byte chunks that cover them; chunks past the pack or of rows
          // past m fill zeros
          const int r = threadIdx.x - CONSUMERS;
          const int64_t j = (PROD ? k0 : r0) + r, b0 = PROD ? r0 / 4 : k0 / 4;
          const uintptr_t a =
              j < p.m ? reinterpret_cast<uintptr_t>(p.packed + j * p.nb + b0) &
                            ~static_cast<uintptr_t>(15)
                      : end16;
#pragma unroll
          for (int w = 0; w < CHUNKS; ++w) {
            const bool in = a + 16 * w < end16;
            cp_async16(At + r * RAW + 16 * w,
                       in ? reinterpret_cast<const void*>(a + 16 * w)
                          : static_cast<const void*>(p.packed),
                       in ? 16u : 0u);
          }
          cp_async_arrive(full + s);
        }
        if (threadIdx.x == CONSUMERS) {
          mbar_expect_tx(full + s, MAT ? STAGE : BP * B_BYTES);
          tma_load(st, &mapDT, k0, c0, full + s);
          if (BP == 2) tma_load(st + B_BYTES, &mapDNA, k0, c0, full + s);
          if (MAT) {
            // cprod: variants r0.. x samples k0..; prod: MS boxes of
            // variants k0.. x samples r0 + 128 i..
#pragma unroll
            for (int i = 0; i < MS; ++i) {
              const int x = PROD ? r0 + 128 * i : k0, y = PROD ? k0 : r0;
              tma_load(At + i * TILE, &mapT, x, y, full + s);
              if (!NONA) tma_load(At + (MS + i) * TILE, &mapNA, x, y, full + s);
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  const int wg = warp >> 2, w = warp & 3;
  const int g = lane >> 2, tg = lane & 3;
  // prod's transpose items: variant rows 16u.. x sample quads sw + 16 i of
  // the warpgroup's WROWS samples; the staging offsets of their samples'
  // 16-byte chunks (rows of the MS contiguous 128-row tiles)
  const int u = 2 * w + (lane >> 4), sw = lane & 15;
  int soff[MS][4];
#pragma unroll
  for (int i = 0; i < MS; ++i)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int row = WROWS * wg + 4 * (sw + 16 * i) + x;
      soff[i][x] = (row >> 7) * TILE + sw128(row & 127, 16 * u);
    }
  int acc[P][MS][NACC];
  uint32_t it = 0;
  for (int64_t item = blockIdx.x; item < p.items; item += gridDim.x) {
    const int64_t sp = item / per_split, rem = item % per_split;
    const int nt = static_cast<int>(rem / p.m_tiles);
    const int mt = static_cast<int>(rem % p.m_tiles);
    const int64_t r0 = static_cast<int64_t>(mt) * BM;
    const int64_t c0 = static_cast<int64_t>(nt) * BN;
    const int kt0 = static_cast<int>(sp) * p.kps;
    const int kt1 = min(p.ktiles, kt0 + p.kps);
#pragma unroll
    for (int q = 0; q < P; ++q)
#pragma unroll
      for (int i = 0; i < MS; ++i)
#pragma unroll
        for (int e = 0; e < NACC; ++e) acc[q][i][e] = 0;
    // K6 cprod: this thread's two variant rows, whether they exist, and
    // their byte offsets in the copied chunks (before the stage's b0)
    bool rowok[2];
    uint32_t orow[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t j = r0 + 64 * wg + 16 * w + g + 8 * h;
      rowok[h] = j < p.m;
      orow[h] = (pk_lo + static_cast<uint32_t>(j) *
                             static_cast<uint32_t>(p.nb)) & 15u;
    }
    int pending = -1;  // the stage whose wgmma may still be in flight
    for (int kt = kt0; kt < kt1; ++kt, ++it) {
      const int s = static_cast<int>(it % S);
      mbar_wait(full + s, (it / S) & 1);
      uint8_t* st = tiles + s * STAGE;
      const uint8_t* At = st + BP * B_BYTES;
      const int64_t k0 = static_cast<int64_t>(kt) * BK;
      const uint64_t dB0 = sw128_desc(st);
      const uint64_t dB1 = sw128_desc(st + (BP - 1) * B_BYTES);
      if (RS) {
        // A fragments: byte 8ks + tg (a0, a1) and 8ks + 4 + tg (a2, a3) of
        // rows g and g + 8, each 4 consecutive samples of one variant
        const int64_t b0 = k0 / 4;
        const int lim =
            static_cast<int>(min(p.nb - b0, static_cast<int64_t>(32)));
        uint32_t o[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          o[h] = (orow[h] + static_cast<uint32_t>(b0)) & 15u;
        uint32_t a[P][4][4];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int idx = 8 * ks + 4 * hh + tg;
              const int rl = 64 * wg + 16 * w + g + 8 * h;
              const uint32_t x = At[rl * RAW + o[h] + idx];
              const uint32_t byte = (rowok[h] && idx < lim) ? x : 0u;
              uint32_t t, na;
              geno_decode::decode_byte(byte, t, na);
              a[0][ks][2 * hh + h] = t;
              if (!NONA) a[P - 1][ks][2 * hh + h] = na;
            }
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int q = 0; q < P; ++q)
            wgmma_s8::Op<BN>::rs(acc[q][0], a[q][ks], dB0 + 2 * ks);
        wgmma_commit();
      } else {
        const uint8_t* A = At;
        if (PROD) {
          // turn this warpgroup's samples K-major: an item is variants
          // 16u..16u+15 x 4 samples, 16 words in, 4 x 4 byte transposes,
          // one 16-byte store a sample. K6 writes a staging tile set
          // (double-buffered); K8 writes over the stage's own plane tiles
          // once every thread that reads them has.
          uint8_t* Ab = MAT ? st + BP * B_BYTES
                            : staging + (it & 1) * P * MS * TILE;
          uint32_t t[MS][16], na[MS][16];
#pragma unroll
          for (int i = 0; i < MS; ++i) {
            const int smp = WROWS * wg + 4 * (sw + 16 * i);  // item sample
            if (MAT) {
              const uint8_t* box = At + (smp >> 7) * TILE;
#pragma unroll
              for (int v = 0; v < 16; ++v) {
                const int off = sw128(16 * u + v, smp & 127);
                t[i][v] = *reinterpret_cast<const uint32_t*>(box + off);
                if (!NONA)
                  na[i][v] =
                      *reinterpret_cast<const uint32_t*>(box + MS * TILE + off);
              }
            } else {
              // K6: byte smp / 4 of the item's samples in variant rows
              // k0 + 16u + v, at its row's offset in the copied chunks
              const int64_t j = k0 + 16 * u;
              const int vmax =
                  static_cast<int>(min(p.m - j, static_cast<int64_t>(16)));
              const bool bok = r0 / 4 + smp / 4 < p.nb;
              const uint32_t nb16 = static_cast<uint32_t>(p.nb) & 15u;
              const uint32_t o0 = (pk_lo + static_cast<uint32_t>(j) * nb16 +
                                   static_cast<uint32_t>(r0 / 4)) & 15u;
              const uint8_t* row = At + 16 * u * RAW + smp / 4;
#pragma unroll
              for (int v = 0; v < 16; ++v) {
                const uint32_t x = row[v * RAW +
                                       ((o0 + static_cast<uint32_t>(v) * nb16) &
                                        15u)];
                const uint32_t byte = (bok && v < vmax) ? x : 0u;
                geno_decode::decode_byte(byte, t[i][v], na[i][v]);
              }
            }
          }
          if (MAT) {
            // the plane tiles are read by both warpgroups when MS = 1
            if (MS == 1) consumers_sync();
            else warpgroup_sync(1 + wg);
          }
#pragma unroll
          for (int i = 0; i < MS; ++i)
#pragma unroll
            for (int q = 0; q < P; ++q) {
              uint32_t y[4][4];
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                const uint32_t* x = (q == 0 ? t[i] : na[i]) + 4 * k;
                geno_decode::transpose4(x[0], x[1], x[2], x[3], y[k]);
              }
#pragma unroll
              for (int x = 0; x < 4; ++x)
                *reinterpret_cast<uint4*>(Ab + q * MS * TILE + soff[i][x]) =
                    make_uint4(y[0][x], y[1][x], y[2][x], y[3][x]);
            }
          fence_proxy_async();
          warpgroup_sync(1 + wg);
          A = Ab;
        }
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int q = 0; q < P; ++q)
#pragma unroll
            for (int i = 0; i < MS; ++i)
              wgmma_s8::Op<BN>::ss(
                  acc[q][i],
                  sw128_desc(A + q * MS * TILE + (WROWS * wg + 64 * i) * 128) +
                      2 * ks,
                  (q == 0 ? dB0 : dB1) + 2 * ks);
        wgmma_commit();
      }
      if (RS) {
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(empty + s);
      } else {
        wgmma_wait<1>();
        if (pending >= 0 && lane == 0) mbar_arrive(empty + pending);
        pending = s;
      }
    }
    if (!RS) {
      wgmma_wait<0>();
      if (pending >= 0 && lane == 0) mbar_arrive(empty + pending);
    }
    // accumulator d[4j + 2h + e]: row g + 8h, column 8j + 2tg + e of this
    // warp's 16 rows of 64-row tile i
#pragma unroll
    for (int q = 0; q < P; ++q)
#pragma unroll
      for (int i = 0; i < MS; ++i)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int64_t row = r0 + WROWS * wg + 64 * i + 16 * w + g + 8 * h;
            const int64_t col = c0 + 8 * j + 2 * tg;
            if (row < M && col < p.N4) {
              int32_t* dst = p.raw + (q * M + row) * p.N4 + col;
              const int v0 = acc[q][i][4 * j + 2 * h];
              const int v1 = acc[q][i][4 * j + 2 * h + 1];
              if (p.atomic) {
                atomicAdd(dst, v0);
                atomicAdd(dst + 1, v1);
              } else {
                *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
              }
            }
          }
  }
}

// radix-128 recombination of digit sums w[r], w[l+r], w[2l+r], w[3l+r]
__device__ __forceinline__ float combine(const int32_t* w, int64_t r,
                                         int64_t l) {
  float o = static_cast<float>(w[r]);
  o = o + static_cast<float>(w[l + r]) * 0.0078125f;
  o = o + static_cast<float>(w[2 * l + r]) * 6.103515625e-05f;
  o = o + static_cast<float>(w[3 * l + r]) * 4.76837158203125e-07f;
  return o;
}

template <bool PROD, bool NONA>
__global__ void i8_epilogue_kernel(const int32_t* __restrict__ raw, int64_t R,
                                   int64_t l, const float* __restrict__ sc_t,
                                   const float* __restrict__ sc_na,
                                   const float* __restrict__ sumv,
                                   const float* __restrict__ A,
                                   const float* __restrict__ s,
                                   float* __restrict__ out) {
  const int64_t count = R * l;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       e < count; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = e / l, r = e % l;
    const float pt = combine(raw + i * 4 * l, r, l) * sc_t[r];
    const float pna =
        NONA ? 0.f : combine(raw + (R + i) * 4 * l, r, l) * sc_na[r];
    out[e] = PROD ? (sumv[r] - pna) - pt : (sumv[r] - pna) * A[i] - pt * s[i];
  }
}

template <bool PROD, bool NONA>
void launch_epilogue(const int32_t* raw, int64_t R, int64_t l,
                     const float* sc_t, const float* sc_na, const float* sumv,
                     const float* A, const float* s, float* out,
                     cudaStream_t st) {
  const int64_t blocks = cdiv(R * l, 256);
  i8_epilogue_kernel<PROD, NONA>
      <<<static_cast<unsigned>(blocks < 8192 ? blocks : 8192), 256, 0, st>>>(
          raw, R, l, sc_t, sc_na, sumv, A, s, out);
}

// A 2-D int8 map on rows x inner bytes (row stride `stride`, a multiple of
// 16), boxes of box_rows x 128 bytes under the 128-byte swizzle; reads past
// the edges fill zeros.
bool make_map_u8(CUtensorMap* map, const void* ptr, int64_t inner,
                 int64_t rows, int64_t stride, int box_rows) {
  return ring::make_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, ptr, inner, rows,
                        stride, 128, box_rows);
}

struct Launch {
  Params p;
  CUtensorMap mT, mNA, mDT, mDNA;
  int grid;
};

template <bool PROD, bool NONA, bool MAT, int BN>
int launch_gemm(const Launch& L, cudaStream_t st) {
  auto kern = i8_wgmma_kernel<PROD, NONA, MAT, BN>;
  static bool opted_in = false;  // > 48 KB of shared memory, once
  if (!opted_in) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    opted_in = true;
  }
  const int smem = smem_bytes(PROD, NONA, MAT, BN, L.p.stages);
  kern<<<L.grid, threads(MAT), smem, st>>>(L.mT, L.mNA, L.mDT, L.mDNA, L.p);
  return static_cast<int>(cudaGetLastError());
}

template <bool PROD, bool NONA, bool MAT>
int dispatch_width(int bn, const Launch& L, cudaStream_t st) {
  switch (bn) {
    case 16: return launch_gemm<PROD, NONA, MAT, 16>(L, st);
    case 32: return launch_gemm<PROD, NONA, MAT, 32>(L, st);
    case 48: return launch_gemm<PROD, NONA, MAT, 48>(L, st);
    case 64: return launch_gemm<PROD, NONA, MAT, 64>(L, st);
    case 80: return launch_gemm<PROD, NONA, MAT, 80>(L, st);
    case 96: return launch_gemm<PROD, NONA, MAT, 96>(L, st);
    case 128: return launch_gemm<PROD, NONA, MAT, 128>(L, st);
    default: return -1;
  }
}

template <bool MAT>
int dispatch(int prod, int nona, int bn, const Launch& L, cudaStream_t st) {
  if (prod)
    return nona ? dispatch_width<true, true, MAT>(bn, L, st)
                : dispatch_width<true, false, MAT>(bn, L, st);
  return nona ? dispatch_width<false, true, MAT>(bn, L, st)
              : dispatch_width<false, false, MAT>(bn, L, st);
}

}  // namespace

extern "C" {

// raw (planes, M, N4) int32 = planes x digits, on the plan of
// ops/geno_kernels.py::i8_plan: column tile bn (a compiled width) x
// n_tiles >= N4, `stages` ring stages, `grid` persistent CTAs, the depth in
// `splits` runs of kps 128-deep tiles (splits > 1: raw zeroed, atomicAdd).
// K6 (mat = 0) reads the pack (m, nb); K8 (mat = 1) the planes T, NA (m,
// ldn) int8, 16-byte aligned, ldn a multiple of 16 (NA unread when nona).
// dT: the T plane's digits (4l, ldd); dNA: the NA plane's (prod with NA;
// cprod reuses dT); ldd a multiple of 128, both 16-byte aligned.
int geno_i8_gemm(int prod, int nona, int mat, const void* packed, int64_t nb,
                 const void* T, const void* NA, int64_t ldn, int64_t m,
                 int64_t n, const void* dT, const void* dNA, int64_t ldd,
                 int64_t N4, void* raw, int bn, int n_tiles, int stages,
                 int grid, int kps, int splits, void* stream) {
  const int64_t M = prod ? n : m, K = prod ? m : n;
  const int64_t ktiles = cdiv(K, BK);
  const int64_t m_tiles = cdiv(M, 128 * msub(prod, nona));
  const bool pn = prod && !nona;
  if (m < 1 || n < 1 || N4 < 1 || bn > 128 || bn % 16 != 0 ||
      static_cast<int64_t>(n_tiles) * bn < N4 ||
      static_cast<int64_t>(n_tiles - 1) * bn >= N4 || stages < 2 ||
      stages > MAX_STAGES || kps < 1 || splits < 1 ||
      cdiv(ktiles, kps) != splits || grid < 1 || ktiles > (1 << 30) ||
      m_tiles > (1 << 30) || ldd % BK != 0 || ldd < K ||
      smem_bytes(prod, nona, mat, bn, stages) > MAX_SMEM)
    return -1;
  if (mat && (ldn % 16 != 0 || ldn < n ||
              reinterpret_cast<uintptr_t>(T) % 16 != 0 ||
              (!nona && reinterpret_cast<uintptr_t>(NA) % 16 != 0)))
    return -1;
  if (!mat && nb != cdiv(n, 4)) return -1;
  if (reinterpret_cast<uintptr_t>(dT) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dNA) % 16 != 0)
    return -1;
  Launch L{};
  L.p.packed = static_cast<const uint8_t*>(packed);
  L.p.nb = nb;
  L.p.m = m;
  L.p.n = n;
  L.p.N4 = N4;
  L.p.raw = static_cast<int32_t*>(raw);
  L.p.m_tiles = static_cast<int>(m_tiles);
  L.p.n_tiles = n_tiles;
  L.p.items = m_tiles * n_tiles * splits;
  L.p.ktiles = static_cast<int>(ktiles);
  L.p.kps = kps;
  L.p.stages = stages;
  L.p.atomic = splits > 1;
  L.grid = static_cast<int>(L.p.items < grid ? L.p.items : grid);
  if (!make_map_u8(&L.mDT, dT, ldd, N4, ldd, bn) ||
      !make_map_u8(&L.mDNA, pn ? dNA : dT, ldd, N4, ldd, bn))
    return -2;
  if (mat) {
    if (!make_map_u8(&L.mT, T, ldn, m, ldn, 128) ||
        !make_map_u8(&L.mNA, nona ? T : NA, ldn, m, ldn, 128))
      return -2;
  } else {
    L.mT = L.mDT;
    L.mNA = L.mDT;
  }
  auto st = static_cast<cudaStream_t>(stream);
  return mat ? dispatch<true>(prod, nona, bn, L, st)
             : dispatch<false>(prod, nona, bn, L, st);
}

// out (R, l) f32 from raw (planes, R, 4l): digit recombination and the
// epilogue. cprod: A, s are the (R,) variant vectors; prod: unused.
int geno_i8_epilogue(int prod, int nona, const void* raw, int64_t R,
                     int64_t l, const void* sc_t, const void* sc_na,
                     const void* sumv, const void* A, const void* s,
                     void* out, void* stream) {
  const auto* w = static_cast<const int32_t*>(raw);
  const auto* ft = static_cast<const float*>(sc_t);
  const auto* fn = static_cast<const float*>(sc_na);
  const auto* sv = static_cast<const float*>(sumv);
  const auto* fa = static_cast<const float*>(A);
  const auto* fs = static_cast<const float*>(s);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (prod) {
    if (nona) launch_epilogue<true, true>(w, R, l, ft, fn, sv, fa, fs, o, st);
    else launch_epilogue<true, false>(w, R, l, ft, fn, sv, fa, fs, o, st);
  } else {
    if (nona) launch_epilogue<false, true>(w, R, l, ft, fn, sv, fa, fs, o, st);
    else launch_epilogue<false, false>(w, R, l, ft, fn, sv, fa, fs, o, st);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
