// Device helpers shared by the compare-exchange networks: the bitonic
// network's kernels (bitonic.cu) and mergesweep's merge kernels
// (mergesweep.cu).
//
// A compare-exchange orders the pair (lo, hi) of NOPS int32 values, the
// first num_keys forming a lexicographic key (signed order; the others ride
// along), ascending or descending, with the TPU kernels' rule for ties: the
// lower element keeps itself when (lower < upper) equals "ascending", else
// takes the upper; the upper keeps itself when (upper < lower) equals
// "descending", else takes the lower.  (So equal keys with different riders
// both come out as one of them: the callers keep key tuples distinct, or
// pass every plane as a key.)

#pragma once

#include <cuda_runtime.h>

namespace gst {

constexpr int kMaxNetworkOps = 4;

// 1-4 int32 planes and their outputs (the same pointers when in place).
struct Ops {
  const int* in[kMaxNetworkOps];
  int* out[kMaxNetworkOps];
};

// a < b lexicographically over the first num_keys of NOPS values
template <int NOPS>
__device__ __forceinline__ bool lex_lt(const int (&a)[NOPS],
                                       const int (&b)[NOPS], int num_keys) {
#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
    if (q < num_keys) {
      if (a[q] < b[q]) return true;
      if (a[q] > b[q]) return false;
    }
  }
  return false;
}

// The pair's compare-exchange in place on lo[] and hi[].
template <int NOPS>
__device__ __forceinline__ void exchange(int (&lo)[NOPS], int (&hi)[NOPS],
                                         bool ascending, int num_keys) {
  const bool keep_lo = lex_lt<NOPS>(lo, hi, num_keys) == ascending;
  const bool keep_hi = lex_lt<NOPS>(hi, lo, num_keys) != ascending;
#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
    const int a = lo[q];
    const int b = hi[q];
    lo[q] = keep_lo ? a : b;
    hi[q] = keep_hi ? b : a;
  }
}

// The p-th pair of stride j: i with bit j cleared, and i | j.
__device__ __forceinline__ long long pair_low(long long p, long long j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

// One compare-exchange of the pair (lo, hi) of NOPS planes of `len` ints
// each, laid out one after another in shared memory.
template <int NOPS>
__device__ __forceinline__ void exchange_smem(int* smem, int len, int lo,
                                              int hi, bool ascending,
                                              int num_keys) {
  int a[NOPS], b[NOPS];
#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
    a[q] = smem[q * len + lo];
    b[q] = smem[q * len + hi];
  }
  exchange<NOPS>(a, b, ascending, num_keys);
#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
    smem[q * len + lo] = a[q];
    smem[q * len + hi] = b[q];
  }
}

__host__ __device__ inline bool pow2(long long x) {
  return x > 0 && (x & (x - 1)) == 0;
}

}  // namespace gst
