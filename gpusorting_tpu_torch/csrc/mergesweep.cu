// Mergesweep's hyper-stage kernel for Hopper (sm_90a): a run of the
// strides of at least a tile of one Batcher merge level in one read and one
// write of each plane.  It carries the above-tile strides of both the
// bitonic network (ops/bitonic.py:sort_network_i32) and mergesweep's merge
// passes (ops/mergesweep.py:_run_merge_pass).
//
// Replaces gpusorting_tpu/ops/mergesweep.py:_hyper_stage_kernel, a Pallas
// TPU kernel of `_run_merge_pass`.  (Its other kernel, _merge_tail_kernel,
// the strides below the tile, is the network's in-tile kernel of
// bitonic.cu run on the tail's schedule: ops/mergesweep.py:merge_tail.)
// Contract, on 1-4 int32 planes of n elements (n a power of two) whose
// first num_keys planes form a lexicographic key (signed int32 order; the
// others ride along): a level k (a power of two) runs the stages
// j = k/2, k/4, ..., 1 of the bitonic network; a stage compares every pair
// (i, i ^ j) with i & j == 0, ascending where i & k == 0, with the tie rule
// of `gst::exchange` (network_common.cuh, shared with bitonic.cu).  The
// kernel runs in place: a block reads everything it writes before it
// writes.
//
//   hyper_stage  — the consecutive strides j_hi, j_hi/2, ..., j_lo of level
//                  k, every one at least a tile.  The elements that meet in
//                  those s stages form groups of W = 2 j_hi / j_lo = 2^s
//                  members, j_lo apart: base + m j_lo, m < W, for every base
//                  with no bit in [j_lo, 2 j_hi); member m meets m ^ 2^b at
//                  the stage of stride j_lo 2^b, top bit first.  One block
//                  takes one group's W members x `cols` consecutive bases
//                  (cols a power of two, 8 <= cols <= j_lo).  k > j_hi, so
//                  the direction is bit k of the base, one per block.
//
// Design: stages in registers, shared memory only between register runs.
// A thread holds E = kItems<NOPS> int4 slots of each plane (4 consecutive
// bases of E members).  Number the group's int4 slots g = m (cols / 4) + c
// (member m, column vector c): a run's e = log2(E) register bits are a
// window [p, p + e) of g's bits, and the thread's index fills the bits
// outside it, lowest first, so neighbouring threads take neighbouring
// 16-byte vectors: a warp reads and writes whole rows of cols * 4 bytes.
// A stage whose member bit lies in the window runs in the thread, on its
// own registers, with no barrier and no shuffle.  The first run loads the
// top e member bits' window from device memory (with fewer than e stages,
// the s member bits and the top column bits); between runs the block
// writes its slots to shared memory at the window's places and, after one
// barrier, reads them back at the next window, the next e member bits down
// (within a run a thread reads and writes only its own slots, so one
// barrier a transpose suffices); the last run stores to device memory.
// A trip of s <= e stages never touches shared memory, s stages take
// ceil(s / e) runs.  The block is as large as its group: W cols / (4 E)
// threads, at most kMaxThreads (128 registers a thread).  The engines size
// every trip's group to the most a block holds (ops/mergesweep.py:
// level_trips: 2^15 elements on one plane, the H100 row's network tile),
// so a trip takes up to 12 stages; such a block's threads keep 16 loads of
// 16 bytes each in flight (128 KB an SM), and probes/torch_hyper_probe.py
// timed the sort's schedule slower with 128- and 256-thread blocks, 2-4 an
// SM.  Groups are independent: no grid order, no global barrier.
//
// Bound: memory.  Each plane is read once and written once per launch, 8
// bytes per element per plane: at n = 2^28, 0.641 ms per plane at the H100
// SXM's 3.35 TB/s.  The shared-memory traffic the design leaves a trip of
// s stages is (ceil(s / e) - 1) transposes of 8 bytes an element a plane
// (one write, one read), against s round trips of the earlier
// shared-memory kernel: at 2^28 on one plane (e = 4) a 7-stage trip makes
// one transpose, 2.1 GB, about 0.065 ms at the SMs' 128 bytes a clock
// (1.98 GHz), a 12-stage trip two; the compares of a stage in registers,
// two min/max a pair, take about 0.016 ms at the measured 8.3 x 10^12
// register exchanges a second (probes/torch_exchange_rate.cu).

#include <cuda_runtime.h>

#include "network_common.cuh"

// int4 slots a thread holds for NOPS planes (ops/mergesweep.py:HYPER_ITEMS):
// 64 registers of values on one or two planes (16 and 8 slots), 96 on
// three, 64 on four; probes/torch_hyper_probe.py --shapes sweeps the one-
// and three-plane counts at build time
#ifndef GST_HYPER_ITEMS1
#define GST_HYPER_ITEMS1 16
#endif
#ifndef GST_HYPER_ITEMS3
#define GST_HYPER_ITEMS3 8
#endif

namespace {

using gst::Ops;
using gst::pow2;

constexpr int kMaxOps = gst::kMaxNetworkOps;
// at most 128 registers a thread (ops/mergesweep.py:HYPER_MAX_THREADS)
constexpr int kMaxThreads = 512;

template <int NOPS>
constexpr int kItems = NOPS == 1   ? GST_HYPER_ITEMS1
                       : NOPS == 2 ? 8
                       : NOPS == 3 ? GST_HYPER_ITEMS3
                                   : 4;

__host__ __device__ constexpr int log2_const(int x) {
  return x <= 1 ? 0 : 1 + log2_const(x / 2);
}

// The group slot of register i under the window [p, p + LOG_E).
template <int LOG_E>
__device__ __forceinline__ unsigned slot_of(unsigned t, unsigned i, int p) {
  return (t & ((1u << p) - 1u)) | (i << p) | ((t >> p) << (p + LOG_E));
}

// Element offset of slot g from the group's base: member g >> lcv, j_lo
// apart; column vector g & (cols / 4 - 1).
__device__ __forceinline__ long long slot_offset(unsigned g, int lcv,
                                                 int log_j_lo) {
  return ((long long)(g >> lcv) << log_j_lo) |
         (long long)((g & ((1u << lcv) - 1u)) << 2);
}

template <int NOPS, int E>
__device__ __forceinline__ void put(int (&v)[NOPS][4 * E], int q, int i,
                                    int4 a) {
  v[q][4 * i] = a.x;
  v[q][4 * i + 1] = a.y;
  v[q][4 * i + 2] = a.z;
  v[q][4 * i + 3] = a.w;
}

template <int NOPS, int E>
__device__ __forceinline__ int4 get(const int (&v)[NOPS][4 * E], int q,
                                    int i) {
  return make_int4(v[q][4 * i], v[q][4 * i + 1], v[q][4 * i + 2],
                   v[q][4 * i + 3]);
}

template <int NOPS, int E, int LOG_E, bool GLOBAL>
__device__ __forceinline__ void load_run(int (&v)[NOPS][4 * E],
                                         const Ops& ops, const int4* smem4,
                                         int slots, long long base, int lcv,
                                         int log_j_lo, int p) {
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const unsigned g = slot_of<LOG_E>(threadIdx.x, i, p);
#pragma unroll
    for (int q = 0; q < NOPS; ++q) {
      put<NOPS, E>(v, q, i,
                   GLOBAL ? *reinterpret_cast<const int4*>(
                                ops.in[q] + base +
                                slot_offset(g, lcv, log_j_lo))
                          : smem4[q * slots + g]);
    }
  }
}

template <int NOPS, int E, int LOG_E, bool GLOBAL>
__device__ __forceinline__ void store_run(const int (&v)[NOPS][4 * E],
                                          const Ops& ops, int4* smem4,
                                          int slots, long long base, int lcv,
                                          int log_j_lo, int p) {
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const unsigned g = slot_of<LOG_E>(threadIdx.x, i, p);
#pragma unroll
    for (int q = 0; q < NOPS; ++q) {
      if constexpr (GLOBAL) {
        *reinterpret_cast<int4*>(ops.out[q] + base +
                                 slot_offset(g, lcv, log_j_lo)) =
            get<NOPS, E>(v, q, i);
      } else {
        smem4[q * slots + g] = get<NOPS, E>(v, q, i);
      }
    }
  }
}

// The stage pairing register i with i + J (i & J == 0), on each of the 4
// columns, in the block's one direction.
template <int NOPS, int KEYS, bool ASC, int E, int J>
__device__ __forceinline__ void reg_stage(int (&v)[NOPS][4 * E],
                                          int num_keys) {
#pragma unroll
  for (int i = 0; i < E; ++i) {
    if (i & J) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int lo[NOPS], hi[NOPS];
#pragma unroll
      for (int q = 0; q < NOPS; ++q) {
        lo[q] = v[q][4 * i + c];
        hi[q] = v[q][4 * (i + J) + c];
      }
      gst::exchange_regs<NOPS>(lo, hi, ASC, KEYS ? KEYS : num_keys);
#pragma unroll
      for (int q = 0; q < NOPS; ++q) {
        v[q][4 * i + c] = lo[q];
        v[q][4 * (i + J) + c] = hi[q];
      }
    }
  }
}

// The stage on register bit r (0 <= r < log2 E).
template <int NOPS, int KEYS, bool ASC, int E>
__device__ __forceinline__ void stage_bit(int (&v)[NOPS][4 * E], int r,
                                          int num_keys) {
  switch (r) {
    case 0:
      reg_stage<NOPS, KEYS, ASC, E, 1>(v, num_keys);
      break;
    case 1:
      if constexpr (E > 2) reg_stage<NOPS, KEYS, ASC, E, 2>(v, num_keys);
      break;
    case 2:
      if constexpr (E > 4) reg_stage<NOPS, KEYS, ASC, E, 4>(v, num_keys);
      break;
    case 3:
      if constexpr (E > 8) reg_stage<NOPS, KEYS, ASC, E, 8>(v, num_keys);
      break;
    default:
      if constexpr (E > 16) reg_stage<NOPS, KEYS, ASC, E, 16>(v, num_keys);
  }
}

// One group's trip: s stages over member bits s-1 .. 0, the group's slots
// numbered by lcv = log2(cols / 4) column bits below the member bits.
template <int NOPS, int KEYS, bool ASC>
__device__ __forceinline__ void trip(const Ops& ops, int4* smem4,
                                     long long base, int log_j_lo, int s,
                                     int lcv, int num_keys) {
  constexpr int E = kItems<NOPS>;
  constexpr int LOG_E = log2_const(E);
  const int slots = 1 << (s + lcv);
  int v[NOPS][4 * E];
  int x = s;                    // member bits [0, x) still to stage
  int p = lcv + s - LOG_E;      // the top e member bits' window
  load_run<NOPS, E, LOG_E, true>(v, ops, smem4, slots, base, lcv, log_j_lo,
                                 p);
  for (;;) {
    const int lo = p > lcv ? p - lcv : 0;
    for (int b = x - 1; b >= lo; --b) {
      stage_bit<NOPS, KEYS, ASC, E>(v, lcv + b - p, num_keys);
    }
    x = lo;
    if (x == 0) break;
    store_run<NOPS, E, LOG_E, false>(v, ops, smem4, slots, base, lcv,
                                     log_j_lo, p);
    __syncthreads();
    p = lcv + (x > LOG_E ? x - LOG_E : 0);
    load_run<NOPS, E, LOG_E, false>(v, ops, smem4, slots, base, lcv,
                                    log_j_lo, p);
  }
  store_run<NOPS, E, LOG_E, true>(v, ops, smem4, slots, base, lcv, log_j_lo,
                                  p);
}

// KEYS, where not 0, is num_keys known at compile time (1, or 2 for a
// (code, index) key), so the lexicographic compares fold to straight
// predicate logic; 0 reads num_keys at run time.
template <int NOPS, int KEYS>
__global__ void __launch_bounds__(kMaxThreads)
hyper_stage(Ops ops, long long k, int log_j_lo, int s, int lcv,
            int num_keys) {
  extern __shared__ int4 smem4[];
  // the group's first base: block b's (b * cols)-th base, counted over the
  // bases, which skip the s member bits above j_lo
  const long long q0 = (long long)blockIdx.x << (lcv + 2);
  const long long base = ((q0 >> log_j_lo) << (log_j_lo + s)) |
                         (q0 & ((1ll << log_j_lo) - 1));
  if ((base & k) == 0) {
    trip<NOPS, KEYS, true>(ops, smem4, base, log_j_lo, s, lcv, num_keys);
  } else {
    trip<NOPS, KEYS, false>(ops, smem4, base, log_j_lo, s, lcv, num_keys);
  }
}

int log2_of(long long x) {
  int r = 0;
  while ((1ll << r) < x) ++r;
  return r;
}

template <int NOPS, int KEYS>
int launch_hyper(const Ops& ops, long long n, long long k, long long j_hi,
                 long long j_lo, int cols, int num_keys, cudaStream_t st) {
  constexpr int LOG_E = log2_const(kItems<NOPS>);
  const int s = log2_of(2 * j_hi / j_lo);
  const int lcv = log2_of(cols / 4);
  const int log_threads = s + lcv - LOG_E;
  if (log_threads < 0 || (1 << log_threads) > kMaxThreads) {
    return (int)cudaErrorInvalidValue;
  }
  // shared memory only where there is a transpose
  const size_t smem = s > LOG_E ? (size_t)NOPS * 16 << (s + lcv) : 0;
  if (smem > 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        hyper_stage<NOPS, KEYS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  hyper_stage<NOPS, KEYS>
      <<<(unsigned)(n >> (s + lcv + 2)), 1 << log_threads, smem, st>>>(
          ops, k, log2_of(j_lo), s, lcv, num_keys);
  return (int)cudaGetLastError();
}

Ops in_place(void* p0, void* p1, void* p2, void* p3) {
  return {{static_cast<const int*>(p0), static_cast<const int*>(p1),
           static_cast<const int*>(p2), static_cast<const int*>(p3)},
          {static_cast<int*>(p0), static_cast<int*>(p1),
           static_cast<int*>(p2), static_cast<int*>(p3)}};
}

}  // namespace

// The strides j_hi .. j_lo of level k over n elements of each plane, in
// place, a block taking cols consecutive bases of W = 2 j_hi / j_lo
// members.  Launches on `stream`; returns the first CUDA error (0 on
// success; cudaErrorInvalidValue for a group outside one block's
// threads).  Planes past num_ops are ignored.
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
      return launch_hyper<1, 1>(ops, n, k, j_hi, j_lo, cols, num_keys, s);
    case 2:
      return num_keys == 1
                 ? launch_hyper<2, 1>(ops, n, k, j_hi, j_lo, cols, num_keys,
                                      s)
                 : launch_hyper<2, 2>(ops, n, k, j_hi, j_lo, cols, num_keys,
                                      s);
    case 3:
      return num_keys == 2
                 ? launch_hyper<3, 2>(ops, n, k, j_hi, j_lo, cols, num_keys,
                                      s)
                 : launch_hyper<3, 0>(ops, n, k, j_hi, j_lo, cols, num_keys,
                                      s);
    default:
      return num_keys == 2
                 ? launch_hyper<4, 2>(ops, n, k, j_hi, j_lo, cols, num_keys,
                                      s)
                 : launch_hyper<4, 0>(ops, n, k, j_hi, j_lo, cols, num_keys,
                                      s);
  }
}
