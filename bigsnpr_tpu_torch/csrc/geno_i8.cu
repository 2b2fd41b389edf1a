// K6: the genotype operator on exact int8 bit planes, with int32 tensor-core
// accumulation, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels of the mxu="int8" scheme
//   bigsnpr_tpu/ops/pallas_kernels.py  _cprod_kernel_i8, _cprod_kernel_i8_nona
//       (entry _pallas_cprod_i8):  raw(m, [T|NA] x 4l) = planes . Q digits
//   bigsnpr_tpu/ops/pallas_kernels.py  _prod_kernel_i8, _prod_kernel_i8_nona
//       (entry _pallas_prod_i8):   raw(n, [T|NA] x 4l) = planes^T . Z digits
// and the recombination and epilogue that follow them there.
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
// Layout: packed is (m, nb) uint8 in true sample order (sample 4b+k in bits
// 2k..2k+1 of byte b), unpadded. The digits are (4l, ldd) int8 rows, zero
// past the contraction length and ldd a multiple of BK. Variants >= m and
// bytes >= nb decode as 0; the PLINK pad samples of a partial last byte are
// code 0 (t = na = 0) and meet zero digits anyway.
//
// GEMM shape: rows M (cprod: variants, prod: samples), columns N = 4l digit
// rows, depth K (cprod: samples, prod: variants). A block of 4 warps owns a
// 64-row x 8*NT-column tile; each warp runs mma.sync m16n8k32 s8 x s8 ->
// s32 on 16 rows. Per BK = 128 deep stage, the block decodes its A tile of
// T (and NA) int8 from the packed bytes straight into shared memory (cprod:
// a byte gives 4 consecutive samples of one variant; prod: 4 variants' bytes
// give, after a 4 x 4 byte transpose, 4 variants of each of 4 samples) and
// copies the digit tile in 16-byte loads. Row strides of 144 bytes (36
// words) make the fragment loads conflict-free.
//
// What bounds it on an H100: at n = 50,000, m = 100,000, l = 20 each plane
// is 2 * 80 * n * m = 8.0e11 int8 operations, 0.40 ms at the 1,979 TOP/s
// dense int8 peak (two planes with NA: 0.81 ms), against 1.25 GB of packed
// bytes, 0.37 ms at 3.35 TB/s. This first kernel is simple: mma.sync (not
// wgmma), plain loads (no TMA / cp.async pipeline), one stage in flight;
// the decode and the shared-memory traffic, not the tensor cores, will set
// its time.
//
// Integer sums are exact, so the depth may be split over gridDim.y into
// int32 atomicAdds and the result still repeats bit for bit. A raw sum is
// at most 254 K in absolute value: the wrapper refuses K > 8,000,000.
//
// K8 (MAT = true) replaces the JAX package's Pallas TPU kernels of the
// mxu="int8m" scheme
//   bigsnpr_tpu/ops/pallas_kernels.py  _cprod_kernel_i8m, _cprod_kernel_i8m_na
//       (entry _pallas_cprod_i8m), _prod_kernel_i8m, _prod_kernel_i8m_na
//       (entry _pallas_prod_i8m)
// the same GEMMs on T (and NA) planes materialized once as int8 arrays
// (m, ldn), true sample order, ldn = n rounded up to 16 and the pad columns
// zero (ops/geno_kernels.py::int8m_planes). Only the A tile's source
// differs from K6: cprod copies its 64 variant rows of 128 samples in
// 16-byte loads; prod reads 4 variants x 4 samples a word each (16 threads
// on one variant's 64 consecutive samples) and transposes them with K6's
// 4 x 4 byte transpose, since mma.sync wants both operands K-contiguous and
// the planes are variant-major. Digits, mma, depth splits and epilogue are
// K6's, so the raw int32 sums equal K6's bit for bit. What bounds it: the
// planes' bytes, n m (x 2 with NA), read once: 5.0 (10.0) GB at 50,000 x
// 100,000, 1.49 (2.99) ms at 3.35 TB/s, above the 0.40 (0.81) ms of int8
// operations at l = 20. This first version loads with plain 16- and 4-byte
// loads, one stage in flight.
//
// C interface for ctypes: every function returns cudaGetLastError() after
// its launches, as an int. Launches go to the stream passed in.

#include <cstdint>
#include <cuda_runtime.h>

#include "geno_decode.cuh"

namespace {

using geno_decode::cdiv;

constexpr int THREADS = 128;
constexpr int BM = 64;         // rows of the block tile (4 warps x 16)
constexpr int BK = 128;        // depth of one stage (4 mma k-steps)
constexpr int SROW = BK + 16;  // shared row stride in bytes: 36 words

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A operand: K6 decodes the 2-bit pack (packed, nb); K8 copies the
// materialized planes (T, NA: (m, ldn) int8; NA unread when NONA).
struct ASource {
  const uint8_t* packed;
  int64_t nb;
  const int8_t* T;
  const int8_t* NA;
  int64_t ldn;
};

// K8's A tile from the planes into As[plane][row * SROW + k], zero past m
// and past ldn (the planes are zero on [n, ldn)).
template <bool PROD, bool NONA>
__device__ __forceinline__ void copy_plane_tile(uint8_t (*As)[BM * SROW],
                                                const ASource& src, int64_t m,
                                                int64_t r0, int64_t k0) {
  const int8_t* __restrict__ pT = src.T;
  const int8_t* __restrict__ pNA = src.NA;
  const int64_t ldn = src.ldn;
  if (!PROD) {
    // variants [r0, r0+64) x samples [k0, k0+128), 16 bytes a load
    for (int e = threadIdx.x; e < BM * (BK / 16); e += THREADS) {
      const int r = e / (BK / 16), c16 = e % (BK / 16);
      const int64_t j = r0 + r, s = k0 + 16 * c16;
      uint4 t = make_uint4(0u, 0u, 0u, 0u), na = t;
      if (j < m && s < ldn) {
        t = *reinterpret_cast<const uint4*>(pT + j * ldn + s);
        if (!NONA) na = *reinterpret_cast<const uint4*>(pNA + j * ldn + s);
      }
      *reinterpret_cast<uint4*>(&As[0][r * SROW + 16 * c16]) = t;
      if (!NONA) *reinterpret_cast<uint4*>(&As[1][r * SROW + 16 * c16]) = na;
    }
  } else {
    // samples [r0, r0+64) x variants [k0, k0+128): an item is samples
    // 4sq..4sq+3 of variants 4vq..4vq+3, neighbouring threads on
    // neighbouring sample quads of one variant
    for (int e = threadIdx.x; e < (BM / 4) * (BK / 4); e += THREADS) {
      const int sq = e % (BM / 4), vq = e / (BM / 4);
      const int64_t s = r0 + 4 * sq;
      uint32_t t[4], na[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int64_t j = k0 + 4 * vq + v;
        const bool in = j < m && s < ldn;
        t[v] = in ? *reinterpret_cast<const uint32_t*>(pT + j * ldn + s) : 0u;
        na[v] = (!NONA && in)
                    ? *reinterpret_cast<const uint32_t*>(pNA + j * ldn + s)
                    : 0u;
      }
      uint32_t yt[4], yn[4];
      geno_decode::transpose4(t[0], t[1], t[2], t[3], yt);
      if (!NONA) geno_decode::transpose4(na[0], na[1], na[2], na[3], yn);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        *reinterpret_cast<uint32_t*>(&As[0][(4 * sq + q) * SROW + 4 * vq]) = yt[q];
        if (!NONA)
          *reinterpret_cast<uint32_t*>(&As[1][(4 * sq + q) * SROW + 4 * vq]) = yn[q];
      }
    }
  }
}

// PROD = false: cprod (M = variants, K = samples); true: prod (M = samples,
// K = variants). NONA drops the NA plane. MAT: K8 (A from the materialized
// planes), else K6 (A decoded from the pack). NT = 8-column tiles per block.
template <bool PROD, bool NONA, bool MAT, int NT>
__global__ void __launch_bounds__(THREADS)
i8_gemm_kernel(ASource src, int64_t m, int64_t n,
               const int8_t* __restrict__ dT,
               const int8_t* __restrict__ dNA, int64_t ldd, int64_t N4,
               int32_t* __restrict__ raw, int64_t ktiles_per_split) {
  constexpr int BN = 8 * NT;
  constexpr int PLANES = NONA ? 1 : 2;
  // B tiles: cprod shares one digit tile between the planes
  constexpr int BPLANES = (PROD && !NONA) ? 2 : 1;
  __shared__ __align__(16) uint8_t As[PLANES][BM * SROW];
  __shared__ __align__(16) uint8_t Bs[BPLANES][BN * SROW];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int64_t M = PROD ? n : m;
  const int64_t K = PROD ? m : n;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t c0 = static_cast<int64_t>(blockIdx.z) * BN;
  const int64_t kt0 = static_cast<int64_t>(blockIdx.y) * ktiles_per_split;
  int64_t kt1 = kt0 + ktiles_per_split;
  const int64_t ktiles = cdiv(K, BK);
  if (kt1 > ktiles) kt1 = ktiles;

  int acc[PLANES][NT][4];
#pragma unroll
  for (int p = 0; p < PLANES; ++p)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][j][e] = 0;

  for (int64_t kt = kt0; kt < kt1; ++kt) {
    const int64_t k0 = kt * BK;
    __syncthreads();
    const uint8_t* __restrict__ packed = src.packed;
    const int64_t nb = src.nb;
    if (MAT) {
      copy_plane_tile<PROD, NONA>(As, src, m, r0, k0);
    } else if (!PROD) {
      // A = planes of variants [r0, r0+64) x samples [k0, k0+128):
      // 64 rows x 32 bytes, one byte an item, neighbours on neighbours
      geno_decode::decode_variant_rows<BM, BK / 4, THREADS>(
          packed, m, nb, r0, k0 / 4,
          [&](int r, int cb, uint32_t t, uint32_t na) {
            *reinterpret_cast<uint32_t*>(&As[0][r * SROW + 4 * cb]) = t;
            if (!NONA) *reinterpret_cast<uint32_t*>(&As[PLANES - 1][r * SROW + 4 * cb]) = na;
          });
    } else {
      // A = planes of samples [r0, r0+64) x variants [k0, k0+128)
      geno_decode::decode_sample_rows<BK / 4, BM / 4, THREADS>(
          packed, m, nb, k0, r0 / 4,
          [&](int row, int vq, uint32_t t, uint32_t na) {
            *reinterpret_cast<uint32_t*>(&As[0][row * SROW + 4 * vq]) = t;
            if (!NONA) *reinterpret_cast<uint32_t*>(&As[PLANES - 1][row * SROW + 4 * vq]) = na;
          });
    }
    // digit tiles: rows [c0, c0+BN) x depth [k0, k0+128), 16 bytes a load
    for (int e = tid; e < BN * (BK / 16); e += THREADS) {
      const int r = e / (BK / 16), c16 = e % (BK / 16);
      const int64_t row = c0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u), w = v;
      if (row < N4) {
        v = *reinterpret_cast<const uint4*>(dT + row * ldd + k0 + 16 * c16);
        if (BPLANES == 2)
          w = *reinterpret_cast<const uint4*>(dNA + row * ldd + k0 + 16 * c16);
      }
      *reinterpret_cast<uint4*>(&Bs[0][r * SROW + 16 * c16]) = v;
      if (BPLANES == 2) *reinterpret_cast<uint4*>(&Bs[BPLANES - 1][r * SROW + 16 * c16]) = w;
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      const int kc = ks * 32 + 4 * tg;
      uint32_t a[PLANES][4];
#pragma unroll
      for (int p = 0; p < PLANES; ++p) {
        const uint8_t* base = &As[p][(16 * warp + g) * SROW + kc];
        a[p][0] = *reinterpret_cast<const uint32_t*>(base);
        a[p][1] = *reinterpret_cast<const uint32_t*>(base + 8 * SROW);
        a[p][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[p][3] = *reinterpret_cast<const uint32_t*>(base + 8 * SROW + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint8_t* bb = &Bs[0][(8 * j + g) * SROW + kc];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(bb);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(bb + 16);
        mma_s8(acc[0][j], a[0], b0, b1);
        if (!NONA) {
          if (BPLANES == 2) {
            const uint8_t* bn = &Bs[BPLANES - 1][(8 * j + g) * SROW + kc];
            mma_s8(acc[PLANES - 1][j], a[PLANES - 1],
                   *reinterpret_cast<const uint32_t*>(bn),
                   *reinterpret_cast<const uint32_t*>(bn + 16));
          } else {
            mma_s8(acc[PLANES - 1][j], a[PLANES - 1], b0, b1);
          }
        }
      }
    }
  }

  // C fragment: c0, c1 at row g, columns 2tg, 2tg+1; c2, c3 at row g + 8
  const bool split = gridDim.y > 1;
#pragma unroll
  for (int p = 0; p < PLANES; ++p) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t row = r0 + 16 * warp + g + (e >= 2 ? 8 : 0);
        const int64_t col = c0 + 8 * j + 2 * tg + (e & 1);
        if (row < M && col < N4) {
          int32_t* dst = raw + (p * M + row) * N4 + col;
          if (split) atomicAdd(dst, acc[p][j][e]);
          else *dst = acc[p][j][e];
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

template <bool PROD, bool NONA, bool MAT, int NT>
void launch_gemm(const ASource& src, int64_t m, int64_t n, const int8_t* dT,
                 const int8_t* dNA, int64_t ldd, int64_t N4, int32_t* raw,
                 int splits, cudaStream_t st) {
  const int64_t M = PROD ? n : m, K = PROD ? m : n;
  const int64_t kps = cdiv(cdiv(K, BK), splits);
  const dim3 grid(static_cast<unsigned>(cdiv(M, BM)), splits,
                  static_cast<unsigned>(cdiv(N4, 8 * NT)));
  i8_gemm_kernel<PROD, NONA, MAT, NT><<<grid, THREADS, 0, st>>>(
      src, m, n, dT, dNA, ldd, N4, raw, kps);
}

// 8-column tiles per block: the fewest z-tiles of at most 12, each rounded
// up to a compiled width
int pick_nt(int64_t N4) {
  const int64_t n8 = cdiv(N4, 8);
  const int64_t per = cdiv(n8, cdiv(n8, 12));
  if (per <= 1) return 1;
  if (per <= 2) return 2;
  if (per <= 4) return 4;
  if (per <= 6) return 6;
  if (per <= 8) return 8;
  if (per <= 10) return 10;
  return 12;
}

template <bool PROD, bool NONA, bool MAT>
void dispatch_gemm(const ASource& a, int64_t m, int64_t n, const int8_t* dT,
                   const int8_t* dNA, int64_t ldd, int64_t N4, int32_t* raw,
                   int splits, cudaStream_t st) {
  switch (pick_nt(N4)) {
    case 1: launch_gemm<PROD, NONA, MAT, 1>(a, m, n, dT, dNA, ldd, N4, raw, splits, st); break;
    case 2: launch_gemm<PROD, NONA, MAT, 2>(a, m, n, dT, dNA, ldd, N4, raw, splits, st); break;
    case 4: launch_gemm<PROD, NONA, MAT, 4>(a, m, n, dT, dNA, ldd, N4, raw, splits, st); break;
    case 6: launch_gemm<PROD, NONA, MAT, 6>(a, m, n, dT, dNA, ldd, N4, raw, splits, st); break;
    case 8: launch_gemm<PROD, NONA, MAT, 8>(a, m, n, dT, dNA, ldd, N4, raw, splits, st); break;
    case 10: launch_gemm<PROD, NONA, MAT, 10>(a, m, n, dT, dNA, ldd, N4, raw, splits, st); break;
    default: launch_gemm<PROD, NONA, MAT, 12>(a, m, n, dT, dNA, ldd, N4, raw, splits, st); break;
  }
}

template <bool MAT>
void dispatch_all(int prod, int nona, const ASource& a, int64_t m, int64_t n,
                  const int8_t* dT, const int8_t* dNA, int64_t ldd,
                  int64_t N4, int32_t* raw, int splits, cudaStream_t st) {
  if (prod) {
    if (nona) dispatch_gemm<true, true, MAT>(a, m, n, dT, dNA, ldd, N4, raw, splits, st);
    else dispatch_gemm<true, false, MAT>(a, m, n, dT, dNA, ldd, N4, raw, splits, st);
  } else {
    if (nona) dispatch_gemm<false, true, MAT>(a, m, n, dT, dNA, ldd, N4, raw, splits, st);
    else dispatch_gemm<false, false, MAT>(a, m, n, dT, dNA, ldd, N4, raw, splits, st);
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

}  // namespace

extern "C" {

// Depth splits (gridDim.y) for about 48 blocks per SM, within the number
// of depth tiles; > 1 means the raw buffer must be zeroed before the
// launch. Many short blocks, not one wave of long ones: at 50,000 x
// 100,000, l = 20 on an H100, splitting the depth 4-16 ways cut three of
// the four instantiations by 7-20% against no split, the tail of the last
// wave being the loss. cprod with NA gained nothing from a split and lost
// 2-4%, so it runs unsplit.
int geno_i8_plan(int prod, int nona, int64_t m, int64_t n, int64_t N4,
                 int sms) {
  if (!prod && !nona) return 1;
  const int64_t M = prod ? n : m, K = prod ? m : n;
  const int nt = pick_nt(N4);
  const int64_t blocks = cdiv(M, BM) * cdiv(N4, 8 * nt);
  int64_t s = cdiv(48 * static_cast<int64_t>(sms), blocks);
  const int64_t ktiles = cdiv(K, BK);
  if (s > ktiles) s = ktiles;
  if (s < 1) s = 1;
  if (s > 65535) s = 65535;
  return static_cast<int>(s);
}

// raw (planes, M, N4) int32 = planes x digits. dT: the T plane's digits
// (4l, ldd); dNA: the NA plane's (prod with NA only; cprod reuses dT).
int geno_i8_gemm(int prod, int nona, const void* packed, int64_t m,
                 int64_t nb, int64_t n, const void* dT, const void* dNA,
                 int64_t ldd, int64_t N4, void* raw, int splits,
                 void* stream) {
  const ASource a{static_cast<const uint8_t*>(packed), nb, nullptr, nullptr,
                  0};
  dispatch_all<false>(prod, nona, a, m, n, static_cast<const int8_t*>(dT),
                      static_cast<const int8_t*>(dNA), ldd, N4,
                      static_cast<int32_t*>(raw), splits,
                      static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// K8: raw as geno_i8_gemm, from the materialized planes T and NA (m, ldn)
// int8 (NA unread when nona); ldn a multiple of 16, both 16-byte aligned.
int geno_i8m_gemm(int prod, int nona, const void* T, const void* NA,
                  int64_t m, int64_t n, int64_t ldn, const void* dT,
                  const void* dNA, int64_t ldd, int64_t N4, void* raw,
                  int splits, void* stream) {
  const ASource a{nullptr, 0, static_cast<const int8_t*>(T),
                  static_cast<const int8_t*>(NA), ldn};
  dispatch_all<true>(prod, nona, a, m, n, static_cast<const int8_t*>(dT),
                     static_cast<const int8_t*>(dNA), ldd, N4,
                     static_cast<int32_t*>(raw), splits,
                     static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
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
