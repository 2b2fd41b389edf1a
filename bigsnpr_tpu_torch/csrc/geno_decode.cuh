// The 2-bit genotype decode shared by the bit-plane kernels K6
// (geno_i8.cu) and K7 (geno_split.cu).
//
// packed is (m, nb) uint8 in true sample order (sample 4b+k in bits
// 2k..2k+1 of byte b). Code g with bits b0 (low), b1 gives the exact
// integer planes t = b1 + (b0 & b1) in {0,1,2} and na = b0 & ~b1 in {0,1}.
// Variants >= m and bytes >= nb decode as code 0 (t = na = 0).
//
// The two tile walks hand each decoded item to `put`, which stores it in
// the kernel's own shared-memory layout (int8 lanes for K6, widened to
// bf16 for K7); a `put` that ignores na lets the compiler drop its work.

#pragma once

#include <cstdint>

namespace geno_decode {

__host__ __device__ __forceinline__ int64_t cdiv(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

// one packed byte -> 4 int8 lanes of t and of na (sample 4b+q in lane q)
__device__ __forceinline__ void decode_byte(uint32_t b, uint32_t& t,
                                            uint32_t& na) {
  const uint32_t w = (b | (b << 6) | (b << 12) | (b << 18)) & 0x03030303u;
  const uint32_t b0 = w & 0x01010101u;
  const uint32_t b1 = (w >> 1) & 0x01010101u;
  const uint32_t u = b0 & b1;
  t = b1 + u;
  na = b0 - u;
}

// rows of a 4 x 4 byte matrix (x0..x3) -> its columns (y0..y3)
__device__ __forceinline__ void transpose4(uint32_t x0, uint32_t x1,
                                           uint32_t x2, uint32_t x3,
                                           uint32_t y[4]) {
  const uint32_t lo01 = __byte_perm(x0, x1, 0x5140);
  const uint32_t hi01 = __byte_perm(x0, x1, 0x7362);
  const uint32_t lo23 = __byte_perm(x2, x3, 0x5140);
  const uint32_t hi23 = __byte_perm(x2, x3, 0x7362);
  y[0] = __byte_perm(lo01, lo23, 0x5410);
  y[1] = __byte_perm(lo01, lo23, 0x7632);
  y[2] = __byte_perm(hi01, hi23, 0x5410);
  y[3] = __byte_perm(hi01, hi23, 0x7632);
}

// The cprod tile: variants [r0, r0 + ROWS) x bytes [b0, b0 + NB) (4 NB
// samples), one byte an item, neighbouring threads on neighbouring bytes.
// put(r, cb, t, na) gets the 4 lanes of byte cb of tile row r.
template <int ROWS, int NB, int THREADS, class Put>
__device__ __forceinline__ void decode_variant_rows(
    const uint8_t* __restrict__ packed, int64_t m, int64_t nb, int64_t r0,
    int64_t b0, Put put) {
  for (int e = threadIdx.x; e < ROWS * NB; e += THREADS) {
    const int r = e / NB, cb = e % NB;
    const int64_t j = r0 + r, b = b0 + cb;
    const uint32_t byte = (j < m && b < nb) ? packed[j * nb + b] : 0u;
    uint32_t t, na;
    decode_byte(byte, t, na);
    put(r, cb, t, na);
  }
}

// The prod tile: samples of bytes [b0, b0 + NB) (4 NB tile rows) x
// variants [k0, k0 + 4 NQ). An item is 4 variants x 1 byte, transposed so
// that put(row, vq, t, na) gets variants 4vq..4vq+3 of tile row (sample)
// `row` in lanes 0..3; neighbouring threads walk the variant quads.
template <int NQ, int NB, int THREADS, class Put>
__device__ __forceinline__ void decode_sample_rows(
    const uint8_t* __restrict__ packed, int64_t m, int64_t nb, int64_t k0,
    int64_t b0, Put put) {
  for (int e = threadIdx.x; e < NQ * NB; e += THREADS) {
    const int vq = e % NQ, cb = e / NQ;
    const int64_t b = b0 + cb;
    uint32_t t[4], na[4];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int64_t j = k0 + 4 * vq + v;
      const uint32_t byte = (j < m && b < nb) ? packed[j * nb + b] : 0u;
      decode_byte(byte, t[v], na[v]);
    }
    uint32_t yt[4], yn[4];
    transpose4(t[0], t[1], t[2], t[3], yt);
    transpose4(na[0], na[1], na[2], na[3], yn);
#pragma unroll
    for (int q = 0; q < 4; ++q) put(4 * cb + q, vq, yt[q], yn[q]);
  }
}

}  // namespace geno_decode
