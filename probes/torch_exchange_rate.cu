// The card's rate of the networks' register compare-exchange
// (gst::exchange_regs, csrc/network_common.cuh), with no memory traffic
// beside it: each thread holds 16 values of each plane in registers, runs
// `rounds` rounds of a 16-element bitonic merge (strides 8, 4, 2, 1: 32
// exchanges a round) on them and writes one word at the end.  A pair's
// direction is read from a mask that changes every round (as the in-tile
// kernel's `desc` bits are), or is a constant (as in the hyper trip, whose
// block has one direction).  Built and timed by
// probes/torch_hyper_probe.py.

#include <cuda_runtime.h>

#include "../gpusorting_tpu_torch/csrc/network_common.cuh"

namespace {

template <int NOPS, int KEYS, bool CONST_DIR, int J>
__device__ __forceinline__ void rate_stage(int (&v)[NOPS][16],
                                           unsigned mask) {
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    if (e & J) continue;
    int lo[NOPS], hi[NOPS];
#pragma unroll
    for (int q = 0; q < NOPS; ++q) {
      lo[q] = v[q][e];
      hi[q] = v[q][e + J];
    }
    gst::exchange_regs<NOPS>(lo, hi, CONST_DIR || ((mask >> e) & 1u) == 0,
                             KEYS);
#pragma unroll
    for (int q = 0; q < NOPS; ++q) {
      v[q][e] = lo[q];
      v[q][e + J] = hi[q];
    }
  }
}

template <int NOPS, int KEYS, bool CONST_DIR>
__global__ void __launch_bounds__(256) rate(int* out, int rounds,
                                            unsigned seed) {
  const unsigned id = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned x = seed ^ (id * 2654435761u);
  int v[NOPS][16];
#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      x = x * 1664525u + 1013904223u;
      v[q][e] = (int)(q < KEYS ? x >> 28 : x);   // keys with ties
    }
  }
  unsigned mask = x;
  for (int r = 0; r < rounds; ++r) {
    rate_stage<NOPS, KEYS, CONST_DIR, 8>(v, mask);
    rate_stage<NOPS, KEYS, CONST_DIR, 4>(v, mask);
    rate_stage<NOPS, KEYS, CONST_DIR, 2>(v, mask);
    rate_stage<NOPS, KEYS, CONST_DIR, 1>(v, mask);
    mask = mask * 1664525u + 1013904223u;
  }
  int acc = 0;
#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
#pragma unroll
    for (int e = 0; e < 16; ++e) acc ^= v[q][e] * (2 * e + 1);
  }
  out[id] = acc;
}

}  // namespace

// Exchanges a thread runs a round.
extern "C" int gst_rate_exchanges_per_round() { return 32; }

// form 0: 1 plane, runtime direction; 1: 1 plane, constant direction;
// 2: 3 planes (2 keys), runtime direction; 3: 3 planes (2 keys), constant.
// `out` holds blocks * 256 ints.  Returns the first CUDA error.
extern "C" int gst_rate(void* out, int form, int blocks, int rounds,
                        unsigned seed, void* stream) {
  int* o = static_cast<int*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  switch (form) {
    case 0:
      rate<1, 1, false><<<blocks, 256, 0, s>>>(o, rounds, seed);
      break;
    case 1:
      rate<1, 1, true><<<blocks, 256, 0, s>>>(o, rounds, seed);
      break;
    case 2:
      rate<3, 2, false><<<blocks, 256, 0, s>>>(o, rounds, seed);
      break;
    case 3:
      rate<3, 2, true><<<blocks, 256, 0, s>>>(o, rounds, seed);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
