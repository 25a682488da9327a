// The Batcher bitonic sorting network's two kernels for Hopper (sm_90a):
// the compare-exchange stages inside one tile, and one stage across tiles.
//
// Replaces gpusorting_tpu/ops/bitonic.py:_local_stages_kernel and
// _global_stage_kernel, the Pallas TPU kernels of `sort_network_i32`.
// Contract, on 1-4 int32 planes of N elements (N a power of two) whose
// first num_keys planes form a lexicographic key (signed int32 order; the
// others ride along): a stage (j, k), j and k powers of two with j < k,
// compares every pair (i, i ^ j) with i & j == 0.  The pair sorts
// ascending where i & k == 0 and descending elsewhere, with the TPU
// kernels' rule for ties (`gst::exchange`, network_common.cuh, shared with
// mergesweep.cu).
//
//   local_stages  — runs a schedule of (j, k) stages, every j below the
//                   tile of tile_elems elements (a power of two), on each
//                   tile; k may exceed the tile (the merge tail of a level
//                   above it), so the direction comes from the element's
//                   global index.  One block per tile: its num_ops planes
//                   sit in dynamic shared memory (above 48 KB only after
//                   cudaFuncSetAttribute), one __syncthreads() per stage.
//                   It reads its tile whole before it writes, so it may run
//                   in place.
//   global_stage  — one stage with j >= tile_elems.  One thread owns four
//                   consecutive pairs: it reads both sides once, compares
//                   and writes both, so each element is read and written
//                   once per stage (the TPU kernel read every pair twice,
//                   once from each side's block).  It runs in place.
//
// Bound: memory, for both.  Each plane is read once and written once per
// launch, 8 bytes per element per plane: at N = 2^28, 0.641 ms per plane at
// the H100 SXM's 3.35 TB/s.  The in-tile kernel's stages run from shared
// memory; the network as a whole takes (L - t + 1) local launches and
// (L - t)(L - t + 1) / 2 global ones for N = 2^L and a 2^t-element tile.

#include <cuda_runtime.h>

#include "network_common.cuh"

namespace {

using gst::exchange;
using gst::Ops;
using gst::pair_low;
using gst::pow2;

constexpr int kMaxOps = gst::kMaxNetworkOps;
constexpr int kLocalThreads = 1024;
constexpr int kGlobalThreads = 256;

template <int NOPS>
__global__ void __launch_bounds__(kLocalThreads)
local_stages(Ops ops, const int2* __restrict__ sched, int num_stages,
             int num_keys, int tile_elems) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const long long base = (long long)blockIdx.x * tile_elems;
  const int vecs = tile_elems / 4;
#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
    const int4* src = reinterpret_cast<const int4*>(ops.in[q] + base);
    for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
      smem4[q * vecs + v] = __ldg(src + v);
    }
  }
  __syncthreads();

  const int half = tile_elems >> 1;
  for (int s = 0; s < num_stages; ++s) {
    const int2 jk = __ldg(sched + s);
    const int j = jk.x;
    const long long k = (unsigned)jk.y;
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      const int lo = (int)pair_low(p, j);
      gst::exchange_smem<NOPS>(smem, tile_elems, lo, lo | j,
                               ((base + lo) & k) == 0, num_keys);
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
    int4* dst = reinterpret_cast<int4*>(ops.out[q] + base);
    for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
      dst[v] = smem4[q * vecs + v];
    }
  }
}

template <int NOPS>
__global__ void __launch_bounds__(kGlobalThreads)
global_stage(Ops ops, long long quads, long long j, long long k,
             int num_keys) {
  const long long g = (long long)blockIdx.x * kGlobalThreads + threadIdx.x;
  if (g >= quads) return;
  // four consecutive pairs: j >= 4, so their low sides are consecutive
  const long long lo = pair_low(g * 4, j);
  const long long hi = lo + j;
  int4 a4[NOPS], b4[NOPS];
#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
    a4[q] = *reinterpret_cast<const int4*>(ops.out[q] + lo);
    b4[q] = *reinterpret_cast<const int4*>(ops.out[q] + hi);
  }
  const bool ascending = (lo & k) == 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    int a[NOPS], b[NOPS];
#pragma unroll
    for (int q = 0; q < NOPS; ++q) {
      a[q] = reinterpret_cast<const int*>(&a4[q])[e];
      b[q] = reinterpret_cast<const int*>(&b4[q])[e];
    }
    exchange<NOPS>(a, b, ascending, num_keys);
#pragma unroll
    for (int q = 0; q < NOPS; ++q) {
      reinterpret_cast<int*>(&a4[q])[e] = a[q];
      reinterpret_cast<int*>(&b4[q])[e] = b[q];
    }
  }
#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
    *reinterpret_cast<int4*>(ops.out[q] + lo) = a4[q];
    *reinterpret_cast<int4*>(ops.out[q] + hi) = b4[q];
  }
}

template <int NOPS>
int launch_local(const Ops& ops, const int2* sched, int num_stages,
                 int num_keys, int num_tiles, int tile_elems,
                 cudaStream_t s) {
  const size_t smem = (size_t)NOPS * tile_elems * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      local_stages<NOPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads =
      tile_elems / 2 < kLocalThreads ? tile_elems / 2 : kLocalThreads;
  local_stages<NOPS><<<num_tiles, threads, smem, s>>>(ops, sched, num_stages,
                                                       num_keys, tile_elems);
  return (int)cudaGetLastError();
}

template <int NOPS>
int launch_global(const Ops& ops, long long n, long long j, long long k,
                  int num_keys, cudaStream_t s) {
  const long long quads = n / 8;
  const long long blocks = (quads + kGlobalThreads - 1) / kGlobalThreads;
  global_stage<NOPS><<<(unsigned)blocks, kGlobalThreads, 0, s>>>(
      ops, quads, j, k, num_keys);
  return (int)cudaGetLastError();
}

}  // namespace

// The schedule is num_stages (j, k) int32 pairs in device memory, checked
// by the caller (every j a power of two below tile_elems, k a power of two
// above j).  Launches on `stream`; returns the first CUDA error (0 on
// success).  Planes past num_ops are ignored.
extern "C" int gst_local_stages(const void* in0, const void* in1,
                                const void* in2, const void* in3, void* out0,
                                void* out1, void* out2, void* out3,
                                const void* sched, int num_stages,
                                int num_ops, int num_keys, int num_tiles,
                                int tile_elems, void* stream) {
  if (num_ops < 1 || num_ops > kMaxOps || num_keys < 1 ||
      num_keys > num_ops || num_tiles <= 0 || num_stages < 0 ||
      tile_elems < 128 || !pow2(tile_elems)) {
    return (int)cudaErrorInvalidValue;
  }
  Ops ops = {{static_cast<const int*>(in0), static_cast<const int*>(in1),
              static_cast<const int*>(in2), static_cast<const int*>(in3)},
             {static_cast<int*>(out0), static_cast<int*>(out1),
              static_cast<int*>(out2), static_cast<int*>(out3)}};
  const int2* sc = static_cast<const int2*>(sched);
  cudaStream_t s = (cudaStream_t)stream;
  switch (num_ops) {
    case 1:
      return launch_local<1>(ops, sc, num_stages, num_keys, num_tiles,
                             tile_elems, s);
    case 2:
      return launch_local<2>(ops, sc, num_stages, num_keys, num_tiles,
                             tile_elems, s);
    case 3:
      return launch_local<3>(ops, sc, num_stages, num_keys, num_tiles,
                             tile_elems, s);
    default:
      return launch_local<4>(ops, sc, num_stages, num_keys, num_tiles,
                             tile_elems, s);
  }
}

// One stage (j, k) over n elements of each plane, in place.  Launches on
// `stream`; returns the first CUDA error (0 on success).
extern "C" int gst_global_stage(void* p0, void* p1, void* p2, void* p3,
                                int num_ops, int num_keys, long long n,
                                long long j, long long k, void* stream) {
  if (num_ops < 1 || num_ops > kMaxOps || num_keys < 1 ||
      num_keys > num_ops || !pow2(n) || !pow2(j) || !pow2(k) || j < 4 ||
      k <= j || 2 * j > n) {
    return (int)cudaErrorInvalidValue;
  }
  Ops ops = {{static_cast<const int*>(p0), static_cast<const int*>(p1),
              static_cast<const int*>(p2), static_cast<const int*>(p3)},
             {static_cast<int*>(p0), static_cast<int*>(p1),
              static_cast<int*>(p2), static_cast<int*>(p3)}};
  cudaStream_t s = (cudaStream_t)stream;
  switch (num_ops) {
    case 1:
      return launch_global<1>(ops, n, j, k, num_keys, s);
    case 2:
      return launch_global<2>(ops, n, j, k, num_keys, s);
    case 3:
      return launch_global<3>(ops, n, j, k, num_keys, s);
    default:
      return launch_global<4>(ops, n, j, k, num_keys, s);
  }
}
