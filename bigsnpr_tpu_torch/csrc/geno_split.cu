// K7: the genotype operator on exact bf16 bit planes against the float
// operand split into bf16 hi + lo, with float32 tensor-core accumulation,
// for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels of the mxu="split2" scheme
//   bigsnpr_tpu/ops/pallas_kernels.py  _cprod_kernel_split
//       (entry pallas_cprod(mxu="split2")):  X~^T V
//   bigsnpr_tpu/ops/pallas_kernels.py  _prod_kernel_split
//       (entry pallas_prod(mxu="split2")):   X~ U
//
// The algebra (ops/geno_kernels.py has it in torch): the standardized value
// of 2-bit code g with bits b0 (low), b1 is x~ = A - s t - A na, with
// t = b1 + (b0 & b1) in {0,1,2}, na = b0 & ~b1 in {0,1}, A = (2 - c) s.
// t and na are exact in bf16. The wrapper splits the float operand into
// bf16 hi = bf16(x) and lo = bf16(x - hi) and stacks them as 2l rows
// (cprod: V^T; prod: zB = U^T s and zA = U^T A, split after the scaling).
// Each product of a plane value with a bf16 value is exact in float32; the
// tensor cores accumulate in float32. The GEMM writes the raw sums of every
// depth split as its own slice of a partial buffer (splits, 2 planes, R,
// 2l); the epilogue kernel adds the slices in split order, forms
// pt = hi + lo of the T plane and pna of the NA plane, and gives
// (sum - pna) A - pt s for cprod, (sum - pna) - pt for prod, per element in
// that order, as `_split_epilogue_plain` does. No float atomics anywhere,
// so two launches repeat bit for bit; built with --fmad=false so the
// epilogue rounds as the twin's separate torch ops do.
//
// Layout: packed is (m, nb) uint8 in true sample order (sample 4b+k in bits
// 2k..2k+1 of byte b), unpadded. The operand is (2l, ldo) bf16 rows, zero
// past the contraction length and ldo a multiple of BK. Variants >= m and
// bytes >= nb decode as 0 (t = na = 0); the PLINK pad samples of a partial
// last byte are code 0 and meet zero operand columns.
//
// GEMM shape: rows M (cprod: variants, prod: samples), columns N = 2l
// stacked hi / lo rows, depth K (cprod: samples, prod: variants). A block
// of 4 warps owns a 64-row x 8*NT-column tile; each warp runs mma.sync
// m16n8k16 bf16 x bf16 -> f32 on 16 rows, for both planes. Per BK = 64
// deep stage the block decodes its A tiles of T and NA straight from the
// packed bytes into shared memory as bf16 (cprod: a byte gives 4
// consecutive samples of one variant; prod: 4 variants' bytes give, after
// a 4 x 4 byte transpose, 4 variants of each of 4 samples) and copies the
// operand tile in 16-byte loads. Row strides of 144 bytes (36 words) keep
// the fragment loads conflict-free; the fragments sit at the same byte
// offsets as K6's int8 ones (a 16-deep bf16 step is 32 bytes).
//
// What bounds it on an H100: at n = 50,000, m = 100,000, l = 20 the two
// planes are 2 x 2 x 40 x n x m = 8.0e11 bf16 operations, 0.81 ms at the
// 989 TFLOP/s dense bf16 peak, against 1.25 GB of packed bytes, 0.37 ms at
// 3.35 TB/s. This first kernel is simple: mma.sync (not wgmma), plain loads
// (no TMA / cp.async pipeline), one stage in flight, and a bf16 A tile
// twice the bytes of K6's int8 one; the decode and the shared-memory
// traffic, not the tensor cores, will set its time.
//
// Overflow: every index is int64; the partial buffer holds splits x 2 x
// R x 2l floats (the wrapper allocates it); splits <= 64 and the column
// tiles of gridDim.z stay far below 65,535 for any l the callers pass. The
// float32 sums cannot overflow an integer.
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
constexpr int BK = 64;         // depth of one stage in bf16 values (4 k-steps)
constexpr int BKB = 2 * BK;    // the same in bytes
constexpr int SROW = BKB + 16; // shared row stride in bytes: 36 words

// bf16 bits of v in {0, 1, 2}: 0, 0x3F80 (1.0), 0x4000 (2.0)
__device__ __forceinline__ uint32_t bf16_of(uint32_t v) {
  return v ? 0x3F00u + (v << 7) : 0u;
}

// 4 int8 lanes -> 4 bf16 in two words, lane 0 in the low half of the first
__device__ __forceinline__ uint2 widen(uint32_t x) {
  uint2 r;
  r.x = bf16_of(x & 0xFFu) | (bf16_of((x >> 8) & 0xFFu) << 16);
  r.y = bf16_of((x >> 16) & 0xFFu) | (bf16_of(x >> 24) << 16);
  return r;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// PROD = false: cprod (M = variants, K = samples, one operand for both
// planes); true: prod (M = samples, K = variants, an operand a plane:
// opT = zB for T, opNA = zA for NA). NT = 8-column tiles per block.
template <bool PROD, int NT>
__global__ void __launch_bounds__(THREADS)
split_gemm_kernel(const uint8_t* __restrict__ packed, int64_t m, int64_t nb,
                  int64_t n, const uint16_t* __restrict__ opT,
                  const uint16_t* __restrict__ opNA, int64_t ldo, int64_t N2,
                  float* __restrict__ part, int64_t ktiles_per_split) {
  constexpr int BN = 8 * NT;
  constexpr int BPLANES = PROD ? 2 : 1;
  __shared__ __align__(16) uint8_t As[2][BM * SROW];
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

  float acc[2][NT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][j][e] = 0.f;

  for (int64_t kt = kt0; kt < kt1; ++kt) {
    const int64_t k0 = kt * BK;
    __syncthreads();
    if (!PROD) {
      // A = planes of variants [r0, r0+64) x samples [k0, k0+64): 64 rows
      // x 16 bytes, one byte (4 samples, 8 bytes of bf16 a plane) an item
      geno_decode::decode_variant_rows<BM, BK / 4, THREADS>(
          packed, m, nb, r0, k0 / 4,
          [&](int r, int cb, uint32_t t, uint32_t na) {
            *reinterpret_cast<uint2*>(&As[0][r * SROW + 8 * cb]) = widen(t);
            *reinterpret_cast<uint2*>(&As[1][r * SROW + 8 * cb]) = widen(na);
          });
    } else {
      // A = planes of samples [r0, r0+64) x variants [k0, k0+64)
      geno_decode::decode_sample_rows<BK / 4, BM / 4, THREADS>(
          packed, m, nb, k0, r0 / 4,
          [&](int row, int vq, uint32_t t, uint32_t na) {
            *reinterpret_cast<uint2*>(&As[0][row * SROW + 8 * vq]) = widen(t);
            *reinterpret_cast<uint2*>(&As[1][row * SROW + 8 * vq]) = widen(na);
          });
    }
    // operand tiles: rows [c0, c0+BN) x depth [k0, k0+64), 8 bf16 a load
    for (int e = tid; e < BN * (BKB / 16); e += THREADS) {
      const int r = e / (BKB / 16), c16 = e % (BKB / 16);
      const int64_t row = c0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u), w = v;
      if (row < N2) {
        v = *reinterpret_cast<const uint4*>(opT + row * ldo + k0 + 8 * c16);
        if (PROD)
          w = *reinterpret_cast<const uint4*>(opNA + row * ldo + k0 + 8 * c16);
      }
      *reinterpret_cast<uint4*>(&Bs[0][r * SROW + 16 * c16]) = v;
      if (PROD) *reinterpret_cast<uint4*>(&Bs[BPLANES - 1][r * SROW + 16 * c16]) = w;
    }
    __syncthreads();

#pragma unroll
    for (int ks = 0; ks < BKB / 32; ++ks) {
      const int kc = ks * 32 + 4 * tg;   // bytes: bf16 values 16 ks + 2 tg
      uint32_t a[2][4];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
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
        mma_bf16(acc[0][j], a[0], b0, b1);
        if (PROD) {
          const uint8_t* bn = &Bs[BPLANES - 1][(8 * j + g) * SROW + kc];
          mma_bf16(acc[1][j], a[1], *reinterpret_cast<const uint32_t*>(bn),
                   *reinterpret_cast<const uint32_t*>(bn + 16));
        } else {
          mma_bf16(acc[1][j], a[1], b0, b1);
        }
      }
    }
  }

  // C fragment: c0, c1 at row g, columns 2tg, 2tg+1; c2, c3 at row g + 8.
  // Every block writes its whole tile of its split's slice, so the
  // partial buffer needs no clearing.
  float* slice = part + static_cast<int64_t>(blockIdx.y) * 2 * M * N2;
#pragma unroll
  for (int p = 0; p < 2; ++p) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t row = r0 + 16 * warp + g + (e >= 2 ? 8 : 0);
        const int64_t col = c0 + 8 * j + 2 * tg + (e & 1);
        if (row < M && col < N2) slice[(p * M + row) * N2 + col] = acc[p][j][e];
      }
    }
  }
}

template <bool PROD>
__global__ void split_epilogue_kernel(const float* __restrict__ part,
                                      int splits, int64_t R, int64_t l,
                                      const float* __restrict__ sumv,
                                      const float* __restrict__ A,
                                      const float* __restrict__ s,
                                      float* __restrict__ out) {
  const int64_t count = R * l;
  const int64_t N2 = 2 * l;
  const int64_t plane = R * N2;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       e < count; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i = e / l, r = e % l;
    const float* pt0 = part + i * N2;
    float th = pt0[r], tl = pt0[l + r];
    float nh = pt0[plane + r], nl = pt0[plane + l + r];
    for (int sp = 1; sp < splits; ++sp) {
      const float* q = pt0 + static_cast<int64_t>(sp) * 2 * plane;
      th = th + q[r];
      tl = tl + q[l + r];
      nh = nh + q[plane + r];
      nl = nl + q[plane + l + r];
    }
    const float pt = th + tl;
    const float pna = nh + nl;
    out[e] = PROD ? (sumv[r] - pna) - pt : (sumv[r] - pna) * A[i] - pt * s[i];
  }
}

template <bool PROD, int NT>
void launch_gemm(const uint8_t* packed, int64_t m, int64_t nb, int64_t n,
                 const uint16_t* opT, const uint16_t* opNA, int64_t ldo,
                 int64_t N2, float* part, int splits, cudaStream_t st) {
  const int64_t M = PROD ? n : m, K = PROD ? m : n;
  const int64_t kps = cdiv(cdiv(K, BK), splits);
  const dim3 grid(static_cast<unsigned>(cdiv(M, BM)), splits,
                  static_cast<unsigned>(cdiv(N2, 8 * NT)));
  split_gemm_kernel<PROD, NT><<<grid, THREADS, 0, st>>>(
      packed, m, nb, n, opT, opNA, ldo, N2, part, kps);
}

// 8-column tiles per block: the fewest z-tiles of at most 12, each rounded
// up to a compiled width (l = 12 and l = 20 fill 3 and 5 tiles exactly)
int pick_nt(int64_t N2) {
  const int64_t n8 = cdiv(N2, 8);
  const int64_t per = cdiv(n8, cdiv(n8, 12));
  if (per <= 5) return static_cast<int>(per < 1 ? 1 : per);
  if (per <= 6) return 6;
  if (per <= 8) return 8;
  if (per <= 10) return 10;
  return 12;
}

template <bool PROD>
void dispatch_gemm(const uint8_t* packed, int64_t m, int64_t nb, int64_t n,
                   const uint16_t* opT, const uint16_t* opNA, int64_t ldo,
                   int64_t N2, float* part, int splits, cudaStream_t st) {
  switch (pick_nt(N2)) {
    case 1: launch_gemm<PROD, 1>(packed, m, nb, n, opT, opNA, ldo, N2, part, splits, st); break;
    case 2: launch_gemm<PROD, 2>(packed, m, nb, n, opT, opNA, ldo, N2, part, splits, st); break;
    case 3: launch_gemm<PROD, 3>(packed, m, nb, n, opT, opNA, ldo, N2, part, splits, st); break;
    case 4: launch_gemm<PROD, 4>(packed, m, nb, n, opT, opNA, ldo, N2, part, splits, st); break;
    case 5: launch_gemm<PROD, 5>(packed, m, nb, n, opT, opNA, ldo, N2, part, splits, st); break;
    case 6: launch_gemm<PROD, 6>(packed, m, nb, n, opT, opNA, ldo, N2, part, splits, st); break;
    case 8: launch_gemm<PROD, 8>(packed, m, nb, n, opT, opNA, ldo, N2, part, splits, st); break;
    case 10: launch_gemm<PROD, 10>(packed, m, nb, n, opT, opNA, ldo, N2, part, splits, st); break;
    default: launch_gemm<PROD, 12>(packed, m, nb, n, opT, opNA, ldo, N2, part, splits, st); break;
  }
}

}  // namespace

extern "C" {

// Depth splits (gridDim.y) for about 8 blocks an SM, within the number of
// depth tiles and at most 64: cprod at m = 100,000 fills the card unsplit;
// prod on 20,000-50,000 samples gets 2-4 splits.
int geno_split_plan(int prod, int64_t m, int64_t n, int64_t N2, int sms) {
  const int64_t M = prod ? n : m, K = prod ? m : n;
  const int nt = pick_nt(N2);
  const int64_t blocks = cdiv(M, BM) * cdiv(N2, 8 * nt);
  int64_t s = cdiv(8 * static_cast<int64_t>(sms), blocks);
  const int64_t ktiles = cdiv(K, BK);
  if (s > ktiles) s = ktiles;
  if (s > 64) s = 64;
  if (s < 1) s = 1;
  return static_cast<int>(s);
}

// part (splits, 2, M, N2) f32 = [T; NA] planes x operand, one slice per
// depth split. opT: the T plane's operand (N2, ldo) bf16; opNA: the NA
// plane's (prod only; cprod reuses opT).
int geno_split_gemm(int prod, const void* packed, int64_t m, int64_t nb,
                    int64_t n, const void* opT, const void* opNA, int64_t ldo,
                    int64_t N2, void* part, int splits, void* stream) {
  const auto* pk = static_cast<const uint8_t*>(packed);
  const auto* t = static_cast<const uint16_t*>(opT);
  const auto* a = static_cast<const uint16_t*>(opNA);
  auto* p = static_cast<float*>(part);
  auto st = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (prod) dispatch_gemm<true>(pk, m, nb, n, t, a, ldo, N2, p, splits, st);
  else dispatch_gemm<false>(pk, m, nb, n, t, a, ldo, N2, p, splits, st);
  return static_cast<int>(cudaGetLastError());
}

// out (R, l) f32 from part (splits, 2, R, 2l): the splits added in order,
// hi + lo, and the epilogue. cprod: A, s are the (R,) variant vectors;
// prod: unused.
int geno_split_epilogue(int prod, const void* part, int splits, int64_t R,
                        int64_t l, const void* sumv, const void* A,
                        const void* s, void* out, void* stream) {
  const auto* p = static_cast<const float*>(part);
  const auto* sv = static_cast<const float*>(sumv);
  const auto* fa = static_cast<const float*>(A);
  const auto* fs = static_cast<const float*>(s);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t blocks = cdiv(R * l, 256);
  const unsigned grid = static_cast<unsigned>(blocks < 8192 ? blocks : 8192);
  if (prod) split_epilogue_kernel<true><<<grid, 256, 0, st>>>(p, splits, R, l, sv, fa, fs, o);
  else split_epilogue_kernel<false><<<grid, 256, 0, st>>>(p, splits, R, l, sv, fa, fs, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
