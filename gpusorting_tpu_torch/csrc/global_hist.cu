// Counts of every 8-bit digit of the key codes in one read (the OneSweep
// GlobalHistogram) for Hopper (sm_90a).
//
// Replaces gpusorting_tpu/ops/kernels.py:_hist_kernel, the Pallas TPU
// kernel behind `global_histogram`.  Contract, on n biased int32 key codes
// x = u ^ 0x80000000 and 1-4 digit positions:
//   out[p * 256 + b] = #{ i < n : (u[i] >> 8p) & 255 == b }.
// The TPU kernel padded the codes to whole tiles with 0xFFFFFFFF and took
// the pad count off bin 255; here the ragged tail is masked instead.
//
// The TPU kernel accumulated one-hot matrix products across a grid that ran
// in order.  Here each block counts a grid-stride share of the codes into
// its own 4 x 256 counters in shared memory (shared atomics), then adds
// them into the zeroed output with global atomics.  Integer additions
// commute, so the result is exact whatever order the blocks run in.
//
// Bound: memory.  Each code is read once, 4 bytes: at n = 2^28, 1.07 GB,
// 0.32 ms at the H100 SXM's 3.35 TB/s.  Threads read 16-byte vectors,
// neighbouring threads neighbouring vectors.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBins = 256;
constexpr int kMaxPasses = 4;
constexpr int kMaxBlocks = 1024;

__device__ __forceinline__ void count(unsigned* bins, int x, int passes) {
  const unsigned u = (unsigned)x ^ 0x80000000u;
#pragma unroll
  for (int p = 0; p < kMaxPasses; ++p) {
    if (p < passes) atomicAdd(&bins[p * kBins + ((u >> (8 * p)) & 255u)], 1u);
  }
}

__global__ void __launch_bounds__(kThreads)
global_hist(const int* __restrict__ codes, long long n, int passes,
            unsigned* __restrict__ out) {
  __shared__ unsigned bins[kMaxPasses * kBins];
  for (int e = threadIdx.x; e < kMaxPasses * kBins; e += kThreads) bins[e] = 0;
  __syncthreads();

  const long long nvec = n >> 2;
  const int4* vecs = reinterpret_cast<const int4*>(codes);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
       v < nvec; v += stride) {
    const int4 q = __ldg(vecs + v);
    count(bins, q.x, passes);
    count(bins, q.y, passes);
    count(bins, q.z, passes);
    count(bins, q.w, passes);
  }
  // the ragged tail: the last n % 4 codes
  if (blockIdx.x == 0 && threadIdx.x < (n & 3)) {
    count(bins, codes[(nvec << 2) + threadIdx.x], passes);
  }
  __syncthreads();

  for (int e = threadIdx.x; e < passes * kBins; e += kThreads) {
    if (bins[e]) atomicAdd(out + e, bins[e]);
  }
}

}  // namespace

// Zeroes the (passes, 256) uint32 output, then launches on `stream`;
// returns the first CUDA error (0 on success).
extern "C" int gst_global_hist(const void* codes, long long n, int passes,
                               void* out, void* stream) {
  if (n < 0 || n >= (1ll << 31) || passes < 1 || passes > kMaxPasses) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err =
      cudaMemsetAsync(out, 0, (size_t)passes * kBins * sizeof(unsigned), s);
  if (err != cudaSuccess || n == 0) return (int)err;
  long long blocks = ((n >> 2) + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  global_hist<<<(int)blocks, kThreads, 0, s>>>(
      static_cast<const int*>(codes), n, passes, static_cast<unsigned*>(out));
  return (int)cudaGetLastError();
}
