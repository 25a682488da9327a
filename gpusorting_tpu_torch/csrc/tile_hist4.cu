// Per-tile counts of one 4-bit digit (the reduce-then-scan Upsweep) for
// Hopper (sm_90a).
//
// Replaces gpusorting_tpu/ops/kernels.py:_tile_hist4_kernel, the Pallas TPU
// kernel behind `tile_histogram4`.  Contract, on one int32 plane of biased
// key codes (u ^ 0x80000000) cut into tiles of tile_elems elements:
//   out[t * 16 + d] = #{ i in tile t : digit(x[i]) == d },
//   digit(x) = ((uint32)(x ^ 0x80000000) >> shift) & 15.
// The xor restores the u32 code, so the top nibble (shift 28) is right.
//
// Bound: memory.  Each key is read once, 4 bytes, and the (T, 16) counts
// are written once: at n = 2^28 that is 1.07 GB, 0.32 ms at the H100 SXM's
// 3.35 TB/s.
//
// Design against that bound: one block per tile, so the grid has as many
// blocks as tiles and no block waits on another.  Each thread reads 16-byte
// vectors (four keys), neighbouring threads neighbouring vectors, so every
// warp load is a full 512-byte row.  Counting goes to warp-private bins in
// shared memory (shared atomics, never global ones); the block then sums
// its warps' bins and writes its 16 counts.  A tile is a whole number of
// 128-key rows, so it holds whole vectors.

#include <cuda_runtime.h>

#include "radix_common.cuh"

namespace {

using gst::digit_of;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDigits = 16;

__global__ void __launch_bounds__(kThreads)
tile_hist4(const int4* __restrict__ codes, int* __restrict__ out,
           long long tile_vecs, int shift) {
  __shared__ unsigned bins[kWarps][kDigits];
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x < kWarps * kDigits) {
    bins[threadIdx.x / kDigits][threadIdx.x % kDigits] = 0;
  }
  __syncthreads();

  const int4* tile = codes + (long long)blockIdx.x * tile_vecs;
  for (long long v = threadIdx.x; v < tile_vecs; v += kThreads) {
    const int4 q = __ldg(tile + v);
    atomicAdd(&bins[warp][digit_of(q.x, shift)], 1u);
    atomicAdd(&bins[warp][digit_of(q.y, shift)], 1u);
    atomicAdd(&bins[warp][digit_of(q.z, shift)], 1u);
    atomicAdd(&bins[warp][digit_of(q.w, shift)], 1u);
  }
  __syncthreads();

  if (threadIdx.x < kDigits) {
    unsigned s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += bins[w][threadIdx.x];
    out[(long long)blockIdx.x * kDigits + threadIdx.x] = (int)s;
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int gst_tile_hist4(const void* codes, void* out, int num_tiles,
                              long long tile_elems, int shift, void* stream) {
  if (num_tiles <= 0 || tile_elems <= 0 || tile_elems % 4 || shift < 0 ||
      shift > 28) {
    return (int)cudaErrorInvalidValue;
  }
  tile_hist4<<<num_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int4*>(codes), static_cast<int*>(out),
      tile_elems / 4, shift);
  return (int)cudaGetLastError();
}
