// Exclusive prefix sum of a 1-D int32 vector for Hopper (sm_90a).
//
// Replaces gpusorting_tpu/ops/kernels.py:_scan_kernel, the Pallas TPU kernel
// behind `exclusive_scan`.  Contract: out[i] = x[0] + ... + x[i-1], out[0] =
// 0, for any length, wrapping like int32 (the sums are taken in uint32).
//
// The TPU kernel carries a running sum from one grid step to the next,
// which holds only because a TPU grid runs in order.  A CUDA grid does not,
// so this is reduce-then-scan, three launches:
//   1. reduce: block b writes the sum of its tile of kTile elements;
//   2. spine:  one block scans the block sums in place, chunk by chunk,
//              carrying the running total in a register;
//   3. scan:   block b scans its tile again and adds its scanned base.
//
// Bound: memory.  The vector is read once and written once, 8 bytes per
// element; on the sort's path it is 16 * T elements (T = tiles), 8 MB at
// n = 2^28 with 4096-key tiles, so a few microseconds: the three launches,
// not the bytes, set its time there.  Design against that: nothing beyond
// the three launches; a block scan is one pass of warp shuffles, and each
// thread scans kItems consecutive elements in registers first.

#include <cuda_runtime.h>

#include "radix_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSpineThreads = 1024;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;
constexpr int kSpineTile = kSpineThreads * kItems;

// Scans in[0 .. count) (count <= THREADS * kItems) into out (when out is not
// null) starting from base; returns the tile's sum.  Thread j holds the
// kItems consecutive elements from j * kItems.
template <int THREADS>
__device__ unsigned scan_tile(const int* in, int* out, long long count,
                              unsigned base) {
  unsigned v[kItems];
  unsigned s = 0;
  const long long i0 = (long long)threadIdx.x * kItems;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    v[i] = i0 + i < count ? (unsigned)in[i0 + i] : 0u;
    s += v[i];
  }
  unsigned total;
  unsigned p = gst::block_exclusive<THREADS>(s, &total) + base;
  if (out != nullptr) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (i0 + i < count) out[i0 + i] = (int)p;
      p += v[i];
    }
  }
  return total;
}

__device__ __forceinline__ long long tile_count(long long n, long long b) {
  const long long left = n - b * kTile;
  return left < kTile ? left : kTile;
}

__global__ void __launch_bounds__(kThreads)
reduce_tiles(const int* __restrict__ in, int* __restrict__ sums,
             long long n) {
  const long long b = blockIdx.x;
  const unsigned s =
      scan_tile<kThreads>(in + b * kTile, nullptr, tile_count(n, b), 0u);
  if (threadIdx.x == 0) sums[b] = (int)s;
}

__global__ void __launch_bounds__(kSpineThreads)
scan_spine(int* sums, long long num_blocks) {
  unsigned carry = 0;
  for (long long c = 0; c < num_blocks; c += kSpineTile) {
    const long long left = num_blocks - c;
    carry += scan_tile<kSpineThreads>(sums + c, sums + c,
                                      left < kSpineTile ? left : kSpineTile,
                                      carry);
  }
}

__global__ void __launch_bounds__(kThreads)
scan_tiles(const int* __restrict__ in, int* __restrict__ out,
           const int* __restrict__ sums, long long n) {
  const long long b = blockIdx.x;
  scan_tile<kThreads>(in + b * kTile, out + b * kTile, tile_count(n, b),
                      (unsigned)sums[b]);
}

}  // namespace

// Three launches on `stream`; `sums` is scratch for the block sums, of
// num_sums >= ceil(n / kTile) int32.  Returns the first cudaGetLastError()
// that is not 0, else 0.
extern "C" int gst_exclusive_scan(const void* in, void* out, void* sums,
                                  long long n, long long num_sums,
                                  void* stream) {
  const long long blocks = (n + kTile - 1) / kTile;
  if (n <= 0 || num_sums < blocks) return (int)cudaErrorInvalidValue;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  const int* x = static_cast<const int*>(in);
  int* y = static_cast<int*>(out);
  int* b = static_cast<int*>(sums);
  reduce_tiles<<<(unsigned)blocks, kThreads, 0, s>>>(x, b, n);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  scan_spine<<<1, kSpineThreads, 0, s>>>(b, blocks);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  scan_tiles<<<(unsigned)blocks, kThreads, 0, s>>>(x, y, b, n);
  return (int)cudaGetLastError();
}
