// Device helpers shared by the compare-exchange networks: the bitonic
// network's kernels (bitonic.cu, whose in-tile kernel also runs
// mergesweep's merge tail) and mergesweep's hyper-stage kernel
// (mergesweep.cu).  The register and warp-shuffle stages below serve the
// in-tile kernel of bitonic.cu; the hyper stage runs its own register
// stages on `exchange_regs`.
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

// ---- registers and warp shuffles ---------------------------------------
//
// A thread holds E elements of each of NOPS planes in registers, v[q][e].
// A stage whose stride pairs two of a thread's own elements runs in the
// thread; in bitonic.cu the E elements are either consecutive (e is bits
// 0..2 of the index) or spread over three chosen index bits of a long
// stride.  A stage whose stride pairs lane l with lane l ^ m of a warp
// runs with one shuffle per element and plane.  Both keep the per-element
// rule of `exchange`: an element keeps itself iff lex_lt(self, peer)
// equals "want the minimum", which holds on the low side of an ascending
// pair and the high side of a descending one, so ties with riders come
// out as in the TPU kernels.

// a < b lexicographically over the first num_keys of NOPS values, as
// lex_lt, with no branch: the key planes are folded from the last to the
// first with predicate logic, so data never splits a warp.
template <int NOPS>
__device__ __forceinline__ bool lex_lt_flat(const int (&a)[NOPS],
                                            const int (&b)[NOPS],
                                            int num_keys) {
  bool lt = false;
#pragma unroll
  for (int q = NOPS - 1; q >= 0; --q) {
    const bool here = (a[q] < b[q]) | ((a[q] == b[q]) & lt);
    lt = q < num_keys ? here : lt;
  }
  return lt;
}

// The pair's compare-exchange in registers, `exchange`'s rule with no
// branch.  With one plane every value is its own key, so min and max give
// the rule's bits.
template <int NOPS>
__device__ __forceinline__ void exchange_regs(int (&lo)[NOPS],
                                              int (&hi)[NOPS],
                                              bool ascending, int num_keys) {
  if constexpr (NOPS == 1) {
    const int mn = min(lo[0], hi[0]);
    const int mx = max(lo[0], hi[0]);
    lo[0] = ascending ? mn : mx;
    hi[0] = ascending ? mx : mn;
  } else {
    const bool keep_lo = lex_lt_flat<NOPS>(lo, hi, num_keys) == ascending;
    const bool keep_hi = lex_lt_flat<NOPS>(hi, lo, num_keys) != ascending;
#pragma unroll
    for (int q = 0; q < NOPS; ++q) {
      const int a = lo[q];
      const int b = hi[q];
      lo[q] = keep_lo ? a : b;
      hi[q] = keep_hi ? b : a;
    }
  }
}

// Compare-exchange of the thread's pairs (e, e | J), e & J == 0; the pair
// at e sorts descending iff bit e of `desc` is set.
template <int NOPS, int E, int J>
__device__ __forceinline__ void stage_in_thread(int (&v)[NOPS][E],
                                                unsigned desc, int num_keys) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (e & J) continue;
    int lo[NOPS], hi[NOPS];
#pragma unroll
    for (int q = 0; q < NOPS; ++q) {
      lo[q] = v[q][e];
      hi[q] = v[q][e + J];
    }
    exchange_regs<NOPS>(lo, hi, ((desc >> e) & 1u) == 0, num_keys);
#pragma unroll
    for (int q = 0; q < NOPS; ++q) {
      v[q][e] = lo[q];
      v[q][e + J] = hi[q];
    }
  }
}

// stage_in_thread on register bit r (J = 1 << r) of E = 8 elements.
template <int NOPS>
__device__ __forceinline__ void stage_register_bit(int (&v)[NOPS][8], int r,
                                                   unsigned desc,
                                                   int num_keys) {
  switch (r) {
    case 0:
      stage_in_thread<NOPS, 8, 1>(v, desc, num_keys);
      break;
    case 1:
      stage_in_thread<NOPS, 8, 2>(v, desc, num_keys);
      break;
    default:
      stage_in_thread<NOPS, 8, 4>(v, desc, num_keys);
  }
}

// `desc` of a stage (k) over E = 8 elements whose register bit r sits at
// index bit b_r: a k among those bits flips with the register, any other
// k reads the bit from `index`, where the register bits are 0.
__device__ __forceinline__ unsigned desc_mask(unsigned index, unsigned k,
                                              unsigned m0, unsigned m1,
                                              unsigned m2) {
  return k == m0   ? 0xAAu
         : k == m1 ? 0xCCu
         : k == m2 ? 0xF0u
                   : ((index & k) != 0 ? 0xFFu : 0u);
}

// Stage (j, k) across the lanes named by `mask`, lane l against lane
// l ^ lane_xor: each element reads its peer's planes with one shuffle
// each and decides its own side.  `low` is bit j of the thread's indices
// clear, `ascending` bit k clear (both uniform over its E elements).
template <int NOPS, int E>
__device__ __forceinline__ void stage_shuffle(int (&v)[NOPS][E],
                                              int lane_xor, bool low,
                                              bool ascending, int num_keys,
                                              unsigned mask) {
  const bool want_min = low == ascending;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    int self[NOPS], peer[NOPS];
#pragma unroll
    for (int q = 0; q < NOPS; ++q) {
      self[q] = v[q][e];
      peer[q] = __shfl_xor_sync(mask, self[q], lane_xor);
    }
    if constexpr (NOPS == 1) {
      v[0][e] = want_min ? min(self[0], peer[0]) : max(self[0], peer[0]);
    } else {
      const bool keep = lex_lt_flat<NOPS>(self, peer, num_keys) == want_min;
#pragma unroll
      for (int q = 0; q < NOPS; ++q) v[q][e] = keep ? self[q] : peer[q];
    }
  }
}

__host__ __device__ inline bool pow2(long long x) {
  return x > 0 && (x & (x - 1)) == 0;
}

}  // namespace gst
