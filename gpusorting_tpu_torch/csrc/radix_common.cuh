// Device helpers shared by the radix kernels (tile_hist4.cu,
// exclusive_scan.cu, downsweep.cu).

#pragma once

#include <cuda_runtime.h>

namespace gst {

// The 4-bit digit at `shift` of a biased int32 key code x = u ^ 0x80000000:
// the xor restores the u32 code u, so the top nibble (shift 28) is right.
__device__ __forceinline__ unsigned digit_of(int x, int shift) {
  return (((unsigned)x ^ 0x80000000u) >> shift) & 15u;
}

__device__ __forceinline__ unsigned warp_inclusive(unsigned x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Exclusive scan of one value per thread across a block of THREADS threads
// (uint32, wrapping); *total gets the block's sum.  Every thread must call
// it.  It ends with a barrier, so the caller may call it again.
template <int THREADS>
__device__ unsigned block_exclusive(unsigned s, unsigned* total) {
  constexpr int kWarps = THREADS / 32;
  static_assert(THREADS % 32 == 0 && kWarps <= 32, "block size");
  __shared__ unsigned warp_base[kWarps];
  __shared__ unsigned block_total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned incl = warp_inclusive(s);
  if (lane == 31) warp_base[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned w = lane < kWarps ? warp_base[lane] : 0u;
    const unsigned wi = warp_inclusive(w);
    if (lane < kWarps) warp_base[lane] = wi - w;
    if (lane == kWarps - 1) block_total = wi;
  }
  __syncthreads();
  const unsigned r = warp_base[warp] + incl - s;
  *total = block_total;
  __syncthreads();
  return r;
}

}  // namespace gst
