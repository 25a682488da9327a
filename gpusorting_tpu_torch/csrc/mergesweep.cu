// Mergesweep's hyper-stage kernel for Hopper (sm_90a): a run of the
// strides of at least a tile of one Batcher merge pass in one read and one
// write of each plane.
//
// Replaces gpusorting_tpu/ops/mergesweep.py:_hyper_stage_kernel, a Pallas
// TPU kernel of `_run_merge_pass`.  (Its other kernel, _merge_tail_kernel,
// the strides below the tile, is the network's in-tile kernel of
// bitonic.cu run on the tail's schedule: ops/mergesweep.py:merge_tail.)
// Contract, on 1-4 int32 planes of n elements (n a power of two) whose
// first num_keys planes form a lexicographic key (signed int32 order; the
// others ride along): a merge pass k (a power of two) runs the stages
// j = k/2, k/4, ..., 1 of the bitonic network's level k; a stage compares
// every pair (i, i ^ j) with i & j == 0, ascending where i & k == 0, with
// the tie rule of `gst::exchange` (network_common.cuh, shared with
// bitonic.cu).  The kernel runs in place: a block reads everything it
// writes before it writes.
//
//   hyper_stage  — the consecutive strides j_hi, j_hi/2, ..., j_lo of pass
//                  k, every one at least a tile.  The elements that meet in
//                  those stages form groups of W = 2 j_hi / j_lo members,
//                  j_lo apart: base + m j_lo, m < W, for every base with no
//                  bit in [j_lo, 2 j_hi).  A block gathers W members x
//                  `cols` consecutive bases (cols >= 8, so each gather reads
//                  whole 32-byte sectors) into shared memory, runs the
//                  log2(W) stages there (member m meets m ^ (W >> (s + 1))
//                  at stage s) and writes them back.  k > j_hi, so the
//                  direction is bit k of the base, one per block.  The TPU
//                  kernel took every high stride of a pass in one block of
//                  W x lo_tile rows, which at 2^28 outgrows any on-chip
//                  memory; the caller cuts a pass's high strides into trips
//                  of as many stages as shared memory holds.
//
// Bound: memory.  Each plane is read once and written once per launch, 8
// bytes per element per plane: at n = 2^28, 0.641 ms per plane at the H100
// SXM's 3.35 TB/s.

#include <cuda_runtime.h>

#include "network_common.cuh"

namespace {

using gst::Ops;
using gst::pair_low;
using gst::pow2;

constexpr int kMaxOps = gst::kMaxNetworkOps;
constexpr int kThreads = 1024;

// log_span = log2(2 j_hi), log_w = log2(W), log_cols = log2(cols)
template <int NOPS>
__global__ void __launch_bounds__(kThreads)
hyper_stage(Ops ops, long long k, long long j_lo, int log_j_lo, int log_span,
            int log_w, int log_cols, int num_keys) {
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const int cols = 1 << log_cols;
  const int group = cols << log_w;              // W * cols elements a plane
  const long long q0 = (long long)blockIdx.x << log_cols;
  const long long base =
      ((q0 >> log_j_lo) << log_span) | (q0 & (j_lo - 1));
  const int vcols = cols / 4;
  const int vecs = group / 4;
#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
    const int* src = ops.in[q] + base;
    for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
      const int m = v / vcols;
      const int t4 = v - m * vcols;
      smem4[q * vecs + v] = *reinterpret_cast<const int4*>(
          src + (long long)m * j_lo + 4 * t4);
    }
  }
  __syncthreads();

  const bool ascending = (base & k) == 0;
  const int pairs = group >> 1;
  for (int wj = (1 << log_w) >> 1; wj >= 1; wj >>= 1) {
    for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
      const int mp = p >> log_cols;
      const int t = p & (cols - 1);
      const int lo = ((int)pair_low(mp, wj) << log_cols) | t;
      gst::exchange_smem<NOPS>(smem, group, lo, lo + (wj << log_cols),
                               ascending, num_keys);
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
    int* dst = ops.out[q] + base;
    for (int v = threadIdx.x; v < vecs; v += blockDim.x) {
      const int m = v / vcols;
      const int t4 = v - m * vcols;
      *reinterpret_cast<int4*>(dst + (long long)m * j_lo + 4 * t4) =
          smem4[q * vecs + v];
    }
  }
}

int log2_of(long long x) {
  int r = 0;
  while ((1ll << r) < x) ++r;
  return r;
}

template <int NOPS>
int launch_hyper(const Ops& ops, long long n, long long k, long long j_hi,
                 long long j_lo, int cols, int num_keys, cudaStream_t s) {
  const long long w = 2 * j_hi / j_lo;
  const long long group = w * cols;
  const size_t smem = (size_t)NOPS * group * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      hyper_stage<NOPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = group / 2 < kThreads ? (int)(group / 2) : kThreads;
  hyper_stage<NOPS><<<(unsigned)(n / group), threads, smem, s>>>(
      ops, k, j_lo, log2_of(j_lo), log2_of(2 * j_hi), log2_of(w),
      log2_of(cols), num_keys);
  return (int)cudaGetLastError();
}

Ops in_place(void* p0, void* p1, void* p2, void* p3) {
  return {{static_cast<const int*>(p0), static_cast<const int*>(p1),
           static_cast<const int*>(p2), static_cast<const int*>(p3)},
          {static_cast<int*>(p0), static_cast<int*>(p1),
           static_cast<int*>(p2), static_cast<int*>(p3)}};
}

}  // namespace

// The strides j_hi .. j_lo of merge pass k over n elements of each plane,
// in place, a block gathering cols consecutive bases of W = 2 j_hi / j_lo
// members.  Launches on `stream`; returns the first CUDA error (0 on
// success).  Planes past num_ops are ignored.
extern "C" int gst_hyper_stage(void* p0, void* p1, void* p2, void* p3,
                               int num_ops, int num_keys, long long n,
                               long long k, long long j_hi, long long j_lo,
                               int cols, void* stream) {
  if (num_ops < 1 || num_ops > kMaxOps || num_keys < 1 ||
      num_keys > num_ops || !pow2(n) || !pow2(k) || !pow2(j_hi) ||
      !pow2(j_lo) || !pow2(cols) || cols < 8 || j_lo < cols ||
      j_hi < j_lo || k <= j_hi || 2 * j_hi > n) {
    return (int)cudaErrorInvalidValue;
  }
  const Ops ops = in_place(p0, p1, p2, p3);
  cudaStream_t s = (cudaStream_t)stream;
  switch (num_ops) {
    case 1:
      return launch_hyper<1>(ops, n, k, j_hi, j_lo, cols, num_keys, s);
    case 2:
      return launch_hyper<2>(ops, n, k, j_hi, j_lo, cols, num_keys, s);
    case 3:
      return launch_hyper<3>(ops, n, k, j_hi, j_lo, cols, num_keys, s);
    default:
      return launch_hyper<4>(ops, n, k, j_hi, j_lo, cols, num_keys, s);
  }
}
