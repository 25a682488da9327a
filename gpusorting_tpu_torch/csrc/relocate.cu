// Range-exchange row relocate for Hopper (sm_90a).
//
// Replaces gpusorting_tpu/ops/rangesweep.py:_relocate_kernel, the Pallas TPU
// kernel of the rangesweep engine's exchange phase.  Contract, on one int32
// plane of K buckets of l_rows rows of 128 elements:
//   for each bucket b and chunk i, copy the source rows
//     src[ctrl[b*K+i] .. + ctrl[2KK+b*K+i])  to  out[ctrl[KK+b*K+i] ..)
//   (the K ranges of a bucket are packed in order from row b*l_rows), then
//   copy its l_rows - ctrl[3KK+b] fringe rows from fringe row b*slab_rows to
//   out row b*l_rows + ctrl[3KK+b].  Every output row is written once.
// The TPU kernel split each range into power-of-two DMA copies (a TPU DMA
// workaround); that mechanism is not part of the contract and is dropped.
//
// Bound: memory.  Each element of the plane is read once and written once,
// 2 * 4 * N bytes: at N = 2^28 that is 2.15 GB, 0.64 ms at the H100 SXM's
// 3.35 TB/s (1.07 ms at the H100 PCIe's 2.0 TB/s).  The control table
// (3K^2+K int32) is small and stays in L1/L2.
//
// Design against that bound: the grid runs over output row tiles, not over
// ranges, so every block moves the same number of bytes however skewed the
// ranges are (one range may hold a whole bucket).  A warp moves one row per
// step, each lane one 16-byte vector, so loads and stores are full
// 512-byte coalesced rows.  A warp finds the source of each of its rows by a
// binary search of the bucket's packed range starts (the plain version's
// searchsorted), and keeps kRowsPerWarp rows in flight before it stores.

#include <cuda_runtime.h>

namespace {

constexpr int kVecPerRow = 32;  // 128 int32 = 32 int4: one per lane
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = 2 * kWarps * kRowsPerWarp;

__global__ void __launch_bounds__(kThreads)
relocate_rows(const int* __restrict__ ctrl, const int4* __restrict__ src,
              const int4* __restrict__ fringe, int4* __restrict__ out,
              int K, int l_rows, int slab_rows, int tiles_per_bucket) {
  const int b = blockIdx.x / tiles_per_bucket;
  const int q0 = (blockIdx.x - b * tiles_per_bucket) * kRowsPerBlock;
  const int q_end = min(q0 + kRowsPerBlock, l_rows);
  const long long KK = (long long)K * K;
  const int* a0 = ctrl + (long long)b * K;
  const int* dst = ctrl + KK + (long long)b * K;
  const int bulk = __ldg(ctrl + 3 * KK + b);
  const long long out_row0 = (long long)b * l_rows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int q = q0 + warp * kRowsPerWarp; q < q_end;
       q += kWarps * kRowsPerWarp) {
    int4 v[kRowsPerWarp];
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      const int r = q + u;
      if (r < q_end) {
        const int4* row;
        if (r < bulk) {
          // last range i whose packed start dst[i] - out_row0 is <= r;
          // dst[0] - out_row0 == 0, so i >= 0, and range i is non-empty
          int lo = 0, hi = K;
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (__ldg(dst + mid) - out_row0 <= r) {
              lo = mid + 1;
            } else {
              hi = mid;
            }
          }
          const int i = lo - 1;
          const long long s =
              __ldg(a0 + i) + (r - (__ldg(dst + i) - out_row0));
          row = src + s * kVecPerRow;
        } else {
          row = fringe + ((long long)b * slab_rows + (r - bulk)) * kVecPerRow;
        }
        v[u] = __ldg(row + lane);
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsPerWarp; ++u) {
      if (q + u < q_end) {
        out[(out_row0 + q + u) * kVecPerRow + lane] = v[u];
      }
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int gst_relocate_rows(const void* ctrl, const void* src,
                                 const void* fringe, void* out, int K,
                                 int l_rows, int slab_rows, void* stream) {
  if (K <= 0 || l_rows <= 0) return (int)cudaErrorInvalidValue;
  const int tiles = (l_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long blocks = (long long)K * tiles;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  relocate_rows<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(ctrl), static_cast<const int4*>(src),
      static_cast<const int4*>(fringe), static_cast<int4*>(out), K, l_rows,
      slab_rows, tiles);
  return (int)cudaGetLastError();
}
