// snp_counts on the card: the (4, m) int32 counts of dosage 0, 1, 2 and NA
// of every variant of a 2-bit pack, in one launch, for sm_90a (H100), with
// a plain C interface for ctypes.
//
// Replaces no TPU kernel: the JAX package's snp_counts
// (bigsnpr_tpu/ops/stats.py:24-59) is jnp, a (block, n) code matrix and
// four compare-and-sum passes a block. The port's plain twin
// (ops/stats.py::counts_plain) does the same in torch; at 488,377 x 200,000
// that moves about a terabyte through device memory in 368 blocks to give
// 3.2 MB of counts.
//
// Bound. Bytes: the pack read once, m x ceil(n / 4) bytes at 3.35 TB/s
// (24.4 GB, 7.3 ms at the PCA cell's shape), and the counts written once.
//
// Design. A warp counts one variant row at a time, and the grid strides
// over the rows, so every variant of the call is in one launch and no
// intermediate touches device memory. A row is ceil(n / 4) bytes with no
// padding, so it starts at any alignment: the bytes up to the first
// 16-byte boundary are read one a lane, the body as 16-byte loads
// (neighbouring lanes on neighbouring addresses, four in flight a lane),
// the bytes after the last boundary one a lane. Codes are counted 16 to a
// 32-bit word with bit arithmetic: with lo = w & 0x55555555 and
// hi = (w >> 1) & 0x55555555,
//   code 3 (dosage 0)  popc(lo & hi)
//   code 2 (dosage 1)  popc(hi) - popc(lo & hi)
//   code 1 (NA)        popc(lo) - popc(lo & hi)
//   code 0 (dosage 2)  n less the other three.
// Two words share their popcounts: the low-bit masks of the second fill the
// odd bits of the first's (popc issues at a quarter of the rate of the
// logic ops). The last byte's pad bits (samples >= n) are masked to 0
// before counting, so pad bits of any value count as nothing. A warp sums
// its lanes with __reduce_add_sync and lane 0 writes the four counts: no
// atomics, the same result every launch.
//
// With row indices (geno_counts_rows: MAX3's cases and controls, clumping,
// autoSVD's rows), a warp reads byte i >> 2 at shift 2 (i & 3) for each
// index of its row, a repeated index counted as often as it appears.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARPS = 8;                 // a CTA: eight warps, a row each
constexpr int THREADS = WARPS * 32;
constexpr uint32_t EVEN = 0x55555555u;   // the low bit of every code

struct Sums {
  int lo = 0, hi = 0, both = 0;          // popc of the low, high, both bits
};

// Codes of two words: w0's bits on the even positions, w1's on the odd.
__device__ __forceinline__ void add_pair(Sums& s, uint32_t w0, uint32_t w1) {
  const uint32_t lo = (w0 & EVEN) | ((w1 << 1) & ~EVEN);
  const uint32_t hi = ((w0 >> 1) & EVEN) | (w1 & ~EVEN);
  s.lo += __popc(lo);
  s.hi += __popc(hi);
  s.both += __popc(lo & hi);
}

__device__ __forceinline__ void add_vec(Sums& s, uint4 v) {
  add_pair(s, v.x, v.y);
  add_pair(s, v.z, v.w);
}

// Lane 0 writes row j's counts of dosage 0, 1, 2 and NA out of k codes.
__device__ __forceinline__ void put(int32_t* out, int64_t m, int64_t j,
                                    int k, int c3, int c2, int c1, int lane) {
  if (lane == 0) {
    out[j] = c3;
    out[m + j] = c2;
    out[2 * m + j] = k - c1 - c2 - c3;
    out[3 * m + j] = c1;
  }
}

__global__ void __launch_bounds__(THREADS)
geno_counts_kernel(const uint8_t* __restrict__ packed, int64_t m, int n,
                   int64_t stride, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * WARPS;
  const int full = n >> 2;               // bytes whose four codes all count
  const int rem = n & 3;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * WARPS +
                   (threadIdx.x >> 5);
       j < m; j += warps) {
    const uint8_t* row = packed + j * stride;
    int head = static_cast<int>(
        (16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15);
    if (head > full) head = full;
    const int nvec = (full - head) >> 4;
    const int body_end = head + (nvec << 4);
    Sums s;
    if (lane < head) add_pair(s, row[lane], 0u);
    if (lane < full - body_end) add_pair(s, row[body_end + lane], 0u);
    if (rem != 0 && lane == 0) {
      add_pair(s, row[full] & ((1u << (2 * rem)) - 1u), 0u);
    }
    const uint4* body = reinterpret_cast<const uint4*>(row + head);
    int v = lane;
    for (; v + 96 < nvec; v += 128) {
      const uint4 a = __ldg(body + v), b = __ldg(body + v + 32);
      const uint4 c = __ldg(body + v + 64), d = __ldg(body + v + 96);
      add_vec(s, a);
      add_vec(s, b);
      add_vec(s, c);
      add_vec(s, d);
    }
    for (; v < nvec; v += 32) add_vec(s, __ldg(body + v));
    const int lo = __reduce_add_sync(0xffffffffu, s.lo);
    const int hi = __reduce_add_sync(0xffffffffu, s.hi);
    const int both = __reduce_add_sync(0xffffffffu, s.both);
    put(out, m, j, n, both, hi - both, lo - both, lane);
  }
}

__global__ void __launch_bounds__(THREADS)
geno_counts_rows_kernel(const uint8_t* __restrict__ packed, int64_t m,
                        int64_t stride, const int32_t* __restrict__ rows,
                        int k, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * WARPS;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * WARPS +
                   (threadIdx.x >> 5);
       j < m; j += warps) {
    const uint8_t* row = packed + j * stride;
    int c1 = 0, c2 = 0, c3 = 0;
    for (int t = lane; t < k; t += 32) {
      const int i = __ldg(rows + t);
      const uint32_t g = (__ldg(row + (i >> 2)) >> ((i & 3) << 1)) & 3u;
      c1 += g == 1u;
      c2 += g == 2u;
      c3 += g == 3u;
    }
    put(out, m, j, k, __reduce_add_sync(0xffffffffu, c3),
        __reduce_add_sync(0xffffffffu, c2),
        __reduce_add_sync(0xffffffffu, c1), lane);
  }
}

// As many CTAs as fit on the card at once, fewer when there are fewer rows.
template <typename K>
int grid_for(K kernel, int64_t m, int sms) {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                    0) != cudaSuccess ||
      per_sm < 1) {
    per_sm = 1;
  }
  const int64_t need = (m + WARPS - 1) / WARPS;
  const int64_t most = static_cast<int64_t>(sms) * per_sm;
  return static_cast<int>(need < most ? need : most);
}

}  // namespace

// C interface for ctypes: each returns cudaGetLastError() after its launch.
// packed (m, stride) uint8 rows of ceil(n / 4) bytes; out (4, m) int32.
extern "C" int geno_counts(const uint8_t* packed, int64_t m, int n,
                           int64_t stride, int32_t* out, int sms,
                           void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  geno_counts_kernel<<<grid_for(geno_counts_kernel, m, sms), THREADS, 0,
                       st>>>(packed, m, n, stride, out);
  return static_cast<int>(cudaGetLastError());
}

// the counts over the k sample indices `rows` (each in [0, n))
extern "C" int geno_counts_rows(const uint8_t* packed, int64_t m,
                                int64_t stride, const int32_t* rows, int k,
                                int32_t* out, int sms, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  geno_counts_rows_kernel<<<grid_for(geno_counts_rows_kernel, m, sms),
                            THREADS, 0, st>>>(packed, m, stride, rows, k,
                                              out);
  return static_cast<int>(cudaGetLastError());
}
