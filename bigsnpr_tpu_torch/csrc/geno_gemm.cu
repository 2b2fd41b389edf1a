// K1: fused 2-bit genotype decode + standardized GEMM for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
//   K1  bigsnpr_tpu/ops/pallas_kernels.py  _cprod_kernel (entry pallas_cprod,
//       mxu="highest"):  out(m, l) = X~^T V,  V (n, l)
// where X~[j, i] = (d - center[j]) * inv[j] for sample i of variant j, the
// dosage d = 2 - ((g + 1) >> 1) of 2-bit PLINK code g, and NA (g == 1) -> 0.
// Its twin K2 (_prod_kernel) runs on exact bf16 bit planes with the
// tensor cores: geno_split.cu.
//
// Layout: packed is (m, nb) uint8, variant-major, in TRUE sample order:
// byte b of a variant row holds samples 4b..4b+3, sample 4b+k in bits
// 2k..2k+1 (the TPU kernels' bit-plane sample permutation is not used).
// Nothing is padded on the device: the kernel masks the ragged edges
// (variants >= m, bytes >= nb, and samples >= n in the partial last byte,
// whose zero pad bits would otherwise decode as dosage 2).
//
// What bounds it on an H100: 2*n*m*l float32 operations (n*m*l FMAs) on
// ceil(n/4)*m packed bytes. At l >= 2 the operations dominate: n = 50,000,
// m = 100,000, l = 20 is 2.0e11 operations, ~3.0 ms at the 67 TFLOP/s
// float32 rate of the CUDA cores, against 1.25 GB of packed bytes, ~0.37
// ms at 3.35 TB/s. So it is compute-bound, and the design aims to keep the
// FMA pipes fed:
//  - each 2-bit code is decoded once per block and used for LT (l-tile)
//    FMAs held in registers (VPT variants x LT columns per thread);
//  - the dense operand's tile sits in shared memory and is read as float4
//    broadcasts (every thread of a warp reads the same address);
//  - the packed tile is staged through shared memory with coalesced byte
//    loads, with an odd row stride in 32-bit words so that the 32 variant
//    rows a warp reads land in 32 distinct banks;
//  - where one pass leaves SMs idle (few variant tiles), the reduction axis
//    is split over gridDim.y into partial sums, added by a second pass in a
//    fixed order: no float atomics, so results repeat bit for bit.
// The tensor-core routes (exact integer planes: geno_split.cu, geno_i8.cu)
// are the later steps past the float32 CUDA-core bound.
//
// C interface for ctypes: every function returns cudaGetLastError() after
// its launches, as an int. Launches go to the stream passed in.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
// K1: packed bytes per staged sample chunk, samples per chunk, and the
// shared-memory row stride in 32-bit words (odd: conflict-free).
constexpr int K1_CB = 32;
constexpr int K1_CS = 4 * K1_CB;
constexpr int K1_ROWW = K1_CB / 4 + 1;

__host__ __device__ __forceinline__ int64_t imin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ float decode(uint32_t g, float c, float s) {
  const float d = 2.f - static_cast<float>((g + 1u) >> 1);
  return g == 1u ? 0.f : (d - c) * s;
}

template <int LT, int VPT>
__global__ void __launch_bounds__(THREADS)
cprod_kernel(const uint8_t* __restrict__ packed, int64_t m, int64_t nb,
             int64_t n, const float* __restrict__ V, int64_t l,
             const float* __restrict__ center, const float* __restrict__ inv,
             float* __restrict__ out, int64_t chunks_per_split) {
  constexpr int TV = THREADS * VPT;
  __shared__ uint32_t tile[TV * K1_ROWW];
  __shared__ __align__(16) float vs[K1_CS * LT];
  uint8_t* tile_b = reinterpret_cast<uint8_t*>(tile);

  const int t = threadIdx.x;
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * TV;
  const int64_t c0 = static_cast<int64_t>(blockIdx.z) * LT;
  const int64_t nchunks = (nb + K1_CB - 1) / K1_CB;
  const int64_t k_begin = blockIdx.y * chunks_per_split;
  const int64_t k_end = imin(nchunks, k_begin + chunks_per_split);
  // partial last byte: keep the real samples' bits, force the pad to NA
  const int rem = static_cast<int>(n & 3);
  const uint32_t keep = (1u << (2 * rem)) - 1u;
  const uint32_t na_fill = 0x55u & ~keep;

  float ctr[VPT], sc[VPT];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int64_t j = v0 + t + k * THREADS;
    ctr[k] = j < m ? center[j] : 0.f;
    sc[k] = j < m ? inv[j] : 0.f;
  }
  float acc[VPT][LT];
#pragma unroll
  for (int k = 0; k < VPT; ++k)
#pragma unroll
    for (int c = 0; c < LT; ++c) acc[k][c] = 0.f;

  for (int64_t kc = k_begin; kc < k_end; ++kc) {
    const int64_t b0 = kc * K1_CB;
    const int64_t s0 = 4 * b0;
    __syncthreads();
    for (int e = t; e < TV * K1_CB; e += THREADS) {
      const int r = e / K1_CB, cb = e % K1_CB;
      const int64_t j = v0 + r, b = b0 + cb;
      uint32_t byte = 0x55u;  // all four samples NA
      if (j < m && b < nb) {
        byte = packed[j * nb + b];
        if (rem && b == nb - 1) byte = (byte & keep) | na_fill;
      }
      tile_b[r * K1_ROWW * 4 + cb] = static_cast<uint8_t>(byte);
    }
    for (int e = t; e < K1_CS * LT; e += THREADS) {
      const int s = e / LT, c = e % LT;
      const int64_t i = s0 + s, cc = c0 + c;
      vs[e] = (i < n && cc < l) ? V[i * l + cc] : 0.f;
    }
    __syncthreads();
    for (int w = 0; w < K1_CB / 4; ++w) {  // 16 samples per 32-bit word
      uint32_t word[VPT];
#pragma unroll
      for (int k = 0; k < VPT; ++k) word[k] = tile[(t + k * THREADS) * K1_ROWW + w];
#pragma unroll 4
      for (int q = 0; q < 16; ++q) {
        float x[VPT];
#pragma unroll
        for (int k = 0; k < VPT; ++k) x[k] = decode((word[k] >> (2 * q)) & 3u, ctr[k], sc[k]);
        const float4* vr = reinterpret_cast<const float4*>(vs + (w * 16 + q) * LT);
#pragma unroll
        for (int c4 = 0; c4 < LT / 4; ++c4) {
          const float4 vv = vr[c4];
#pragma unroll
          for (int k = 0; k < VPT; ++k) {
            acc[k][4 * c4 + 0] = fmaf(x[k], vv.x, acc[k][4 * c4 + 0]);
            acc[k][4 * c4 + 1] = fmaf(x[k], vv.y, acc[k][4 * c4 + 1]);
            acc[k][4 * c4 + 2] = fmaf(x[k], vv.z, acc[k][4 * c4 + 2]);
            acc[k][4 * c4 + 3] = fmaf(x[k], vv.w, acc[k][4 * c4 + 3]);
          }
        }
      }
    }
  }

  float* dst = out + static_cast<int64_t>(blockIdx.y) * m * l;
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int64_t j = v0 + t + k * THREADS;
    if (j >= m) continue;
#pragma unroll
    for (int c = 0; c < LT; ++c)
      if (c0 + c < l) dst[j * l + c0 + c] = acc[k][c];
  }
}

// out[e] = sum over s of part[s][e], in the order s = 0, 1, ...
__global__ void sum_splits(const float* __restrict__ part, int splits,
                           int64_t count, float* __restrict__ out) {
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       e < count; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[k * count + e];
    out[e] = s;
  }
}

// l-tile width: the fewest tiles of at most 32 columns, each rounded up to
// a multiple of 4 (float4) and to one of the compiled widths.
int pick_lt(int64_t l) {
  const int64_t tiles = (l + 31) / 32;
  const int64_t per = (l + tiles - 1) / tiles;
  if (per <= 4) return 4;
  if (per <= 8) return 8;
  if (per <= 16) return 16;
  if (per <= 24) return 24;
  return 32;
}

// K1 variants per thread: at most 64 accumulators per thread.
int k1_vpt(int lt) { return lt >= 24 ? 2 : 4; }

int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// Split count that gives about 8 blocks per SM, within [1, max_splits].
int plan_splits(int64_t blocks, int64_t max_splits, int sms) {
  int64_t s = cdiv(8 * static_cast<int64_t>(sms), blocks);
  s = s < 1 ? 1 : s;
  s = s > max_splits ? max_splits : s;
  return static_cast<int>(s);
}

template <int LT>
void launch_cprod(const uint8_t* packed, int64_t m, int64_t nb, int64_t n,
                  const float* V, int64_t l, const float* center,
                  const float* inv, float* dst, int splits, int64_t cps,
                  cudaStream_t stream) {
  constexpr int VPT = LT >= 24 ? 2 : 4;
  const dim3 grid(static_cast<unsigned>(cdiv(m, THREADS * VPT)), splits,
                  static_cast<unsigned>(cdiv(l, LT)));
  cprod_kernel<LT, VPT><<<grid, THREADS, 0, stream>>>(
      packed, m, nb, n, V, l, center, inv, dst, cps);
}

void launch_sum(const float* part, int splits, int64_t count, float* out,
                cudaStream_t stream) {
  const int64_t blocks = cdiv(count, 256);
  sum_splits<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0,
               stream>>>(part, splits, count, out);
}

}  // namespace

extern "C" {

// Number of partial sums (gridDim.y) the wrapper must allocate for K1;
// 1 means no partial buffer.
int geno_plan(int64_t m, int64_t nb, int64_t l, int sms) {
  const int lt = pick_lt(l);
  const int64_t tiles = cdiv(m, THREADS * k1_vpt(lt));
  return plan_splits(tiles * cdiv(l, lt), cdiv(nb, K1_CB), sms);
}

// K1: out (m, l) = X~^T V for V (n, l). With splits > 1, part holds
// (splits, m, l) partial sums; otherwise part is unused and may be out.
int geno_cprod(const void* packed, int64_t m, int64_t nb, int64_t n,
               const void* V, int64_t l, const void* center, const void* inv,
               void* out, void* part, int splits, void* stream) {
  const auto* pk = static_cast<const uint8_t*>(packed);
  const auto* v = static_cast<const float*>(V);
  const auto* c = static_cast<const float*>(center);
  const auto* s = static_cast<const float*>(inv);
  auto* o = static_cast<float*>(out);
  auto* dst = splits > 1 ? static_cast<float*>(part) : o;
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t cps = cdiv(cdiv(nb, K1_CB), splits);
  switch (pick_lt(l)) {
    case 4: launch_cprod<4>(pk, m, nb, n, v, l, c, s, dst, splits, cps, st); break;
    case 8: launch_cprod<8>(pk, m, nb, n, v, l, c, s, dst, splits, cps, st); break;
    case 16: launch_cprod<16>(pk, m, nb, n, v, l, c, s, dst, splits, cps, st); break;
    case 24: launch_cprod<24>(pk, m, nb, n, v, l, c, s, dst, splits, cps, st); break;
    default: launch_cprod<32>(pk, m, nb, n, v, l, c, s, dst, splits, cps, st); break;
  }
  if (splits > 1) launch_sum(dst, splits, m * l, o, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
