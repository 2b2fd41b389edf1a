// The 2-bit genotype decode of the int8 bit-plane kernels K6 / K8
// (geno_i8.cu).
//
// packed is (m, nb) uint8 in true sample order (sample 4b+k in bits
// 2k..2k+1 of byte b). Code g with bits b0 (low), b1 gives the exact
// integer planes t = b1 + (b0 & b1) in {0,1,2} and na = b0 & ~b1 in {0,1}.

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

}  // namespace geno_decode
