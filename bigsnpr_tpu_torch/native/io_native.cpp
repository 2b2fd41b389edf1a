// BGEN v1.2 (layout 2, zlib, 8-bit) decode on the host (C ABI, loaded with
// ctypes by bigsnpr_tpu_torch/io/bgen.py).
//
// A copy of the JAX package's bgen_decode_variants
// (bigsnpr_tpu/native/io_native.cpp:50-130; reference
// src/read-bgen.cpp:18-127): a parallel zlib inflate of each variant's
// probability block and its 8-bit decode into dosage codes, with the
// IMPUTE INFO score and the allele frequency accumulated on the fly. The
// port samples hard calls (read_as = "random") on the host with numpy, so
// the copy keeps only the dosage decode. A second entry, bgen_decode_e,
// returns the exact pair sums e = 2 p0 + p1 that snp_prodBGEN multiplies.
//
// zlib's header is not needed: `uncompress` is declared here with its
// documented signature and the library is linked by its soname
// (g++ -O3 -fopenmp -shared -fPIC io_native.cpp -l:libz.so.1), which
// every Python with its zlib module loads.

#include <cmath>
#include <cstdint>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// zlib.h: int uncompress(Bytef *dest, uLongf *destLen, const Bytef *source,
//                        uLong sourceLen); Z_OK == 0
int uncompress(unsigned char* dest, unsigned long* dest_len,
               const unsigned char* source, unsigned long source_len);

// Inflate variant k's probability block into buf (D = 10 + 3 N bytes);
// returns 0, or the zlib error code, or -3 for a block of the wrong size.
static int inflate_block(const uint8_t* file_bytes, int64_t offset,
                         int64_t comp_size, uint8_t* buf, int64_t D) {
  unsigned long D2 = (unsigned long)D;
  int rc = uncompress(buf, &D2, file_bytes + offset,
                      (unsigned long)comp_size);
  if (rc != 0) return rc;
  return D2 == (unsigned long)D ? 0 : -3;
}

// file_bytes: the bytes holding the K variants' compressed blocks;
// offsets[k] points at the start of the compressed genotype block (after
// the variant-id fields) with comp_sizes[k] = C - 4 bytes, N samples.
// ind_row: the n_sub selected samples. Outputs: codes (K, n_sub) uint8
// (dosage codes 207 - round(e * 100 / 255), 3 = missing), info[K], freq[K].
// Returns 0, or the last error of a block.
int bgen_decode_variants(const uint8_t* file_bytes, const int64_t* offsets,
                         const int64_t* comp_sizes, int64_t K, int64_t N,
                         const int64_t* ind_row, int64_t n_sub,
                         uint8_t* codes, double* info, double* freq,
                         int n_threads) {
  const int64_t D = 10 + 3 * N;
  int err = 0;

  // decode LUT: e in 0..510 -> byte code 207 - round(e * 100 / 255)
  uint8_t decode_lut[511];
  for (int e = 0; e <= 510; e++)
    decode_lut[e] = (uint8_t)(207 - (int)std::lround(e * 100.0 / 255.0));

#ifdef _OPENMP
#pragma omp parallel num_threads(n_threads)
#endif
  {
    uint8_t* buf = new uint8_t[D];
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
    for (int64_t k = 0; k < K; k++) {
      int rc = inflate_block(file_bytes, offsets[k], comp_sizes[k], buf, D);
      if (rc != 0) {
#ifdef _OPENMP
#pragma omp atomic write
#endif
        err = rc;
        continue;
      }
      const uint8_t* ploidy = buf + 8;
      const uint8_t* probs = buf + 10 + N;
      uint8_t* out_row = codes + k * n_sub;

      int64_t nona = 0;
      double af = 0, num = 0;
      for (int64_t i = 0; i < n_sub; i++) {
        int64_t g = ind_row[i];
        if (ploidy[g] >= 0x80) {
          out_row[i] = 3;
        } else {
          int p0 = probs[2 * g], p1 = probs[2 * g + 1];
          int e = 2 * p0 + p1;
          double f = 4.0 * p0 + p1;
          nona++;
          af += e;
          num += 255.0 * f - (double)e * e;
          out_row[i] = decode_lut[e];
        }
      }
      double coef = 255.0 * (2 * nona);
      info[k] = (af > 0) ? 1 - num * 2 * nona / (af * (coef - af)) : NAN;
      freq[k] = (nona > 0) ? 1 - af / coef : NAN;
    }
    delete[] buf;
  }
  return err;
}

// The same inflate; e_out (K, n_sub) uint16 gets e = 2 p0 + p1, or 65535
// for a missing genotype (the JAX package's snp_prodBGEN decode,
// bigsnpr_tpu/io/bgen.py:395-403).
int bgen_decode_e(const uint8_t* file_bytes, const int64_t* offsets,
                  const int64_t* comp_sizes, int64_t K, int64_t N,
                  const int64_t* ind_row, int64_t n_sub, uint16_t* e_out,
                  int n_threads) {
  const int64_t D = 10 + 3 * N;
  int err = 0;
#ifdef _OPENMP
#pragma omp parallel num_threads(n_threads)
#endif
  {
    uint8_t* buf = new uint8_t[D];
#ifdef _OPENMP
#pragma omp for schedule(dynamic, 16)
#endif
    for (int64_t k = 0; k < K; k++) {
      int rc = inflate_block(file_bytes, offsets[k], comp_sizes[k], buf, D);
      if (rc != 0) {
#ifdef _OPENMP
#pragma omp atomic write
#endif
        err = rc;
        continue;
      }
      const uint8_t* ploidy = buf + 8;
      const uint8_t* probs = buf + 10 + N;
      uint16_t* out_row = e_out + k * n_sub;
      for (int64_t i = 0; i < n_sub; i++) {
        int64_t g = ind_row[i];
        out_row[i] = ploidy[g] >= 0x80
            ? (uint16_t)65535
            : (uint16_t)(2 * probs[2 * g] + probs[2 * g + 1]);
      }
    }
    delete[] buf;
  }
  return err;
}

}  // extern "C"
