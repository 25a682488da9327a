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
//                   global index.  One block per tile.  The wrapper splits
//                   the schedule into runs that each stay in registers,
//                   each thread holding kItems (8) elements of every plane:
//                   a warp run (strides below 256) holds 8 consecutive
//                   elements a lane, so strides 1, 2, 4 run in the thread
//                   and 8 .. 128 across the warp with __shfl_xor_sync; a
//                   group run (up to three strides of 256 or more) spreads
//                   a thread's 8 elements over those strides' index bits,
//                   so they run in the thread too.  The first run reads the
//                   input planes, the last writes the outputs, and between
//                   runs the tile waits in dynamic shared memory (above
//                   48 KB only after cudaFuncSetAttribute), one barrier
//                   between two runs and none inside one.  It reads its
//                   tile whole before it writes, so it may run in place:
//                   mergesweep's merge tail (replacing
//                   gpusorting_tpu/ops/mergesweep.py:_merge_tail_kernel) is
//                   this kernel, in place, on the schedule (j, k) for
//                   j = min(k, tile)/2, ..., 1 (ops/mergesweep.py).
//   global_stage  — one stage with j >= tile_elems.  One thread owns four
//                   consecutive pairs: it reads both sides once, compares
//                   and writes both, so each element is read and written
//                   once per stage (the TPU kernel read every pair twice,
//                   once from each side's block).  It runs in place.
//
// Bound: memory for global_stage, each plane read once and written once
// per launch, 8 bytes per element per plane: at N = 2^28, 0.641 ms per
// plane at the H100 SXM's 3.35 TB/s.  The in-tile pass of a 2^15 tile runs
// 120 stages on the same bytes, so its compares bound it (about 1 ms at
// the 32-bit peak).  A stage through shared memory costs a round trip of
// the tile and a barrier, which would set the pass's time, so the design
// keeps stages in registers: the 2^15 in-tile pass is 8 warp runs (92
// stages: 42 in the thread, 50 by shuffles) and 12 group runs (28
// stages), 19 barriers; a 15-stage tail is 3 group runs and one warp run.
// The network's own run patterns (its first 36 stages, a level's last 8,
// three halving strides of one level) are compiled with constant strides,
// and the key count of the main path (1, or 2 for a (code, index) key) is
// a template parameter, so the lexicographic compares are straight
// predicate logic.  The network as a whole takes (L - t + 1) local
// launches and (L - t)(L - t + 1) / 2 global ones for N = 2^L and a
// 2^t-element tile.

#include <cuda_runtime.h>

#include "network_common.cuh"

namespace {

using gst::exchange;
using gst::Ops;
using gst::pair_low;
using gst::pow2;

constexpr int kMaxOps = gst::kMaxNetworkOps;
// the in-tile kernel: kItems elements a thread in registers
// (ops/bitonic.py:WARP_ITEMS), consecutive in a warp run, so a warp spans
// 32 * kItems = 256 elements (WARP_SPAN); a long-stride run spreads them
// over kGroupBits index bits (GROUP_BITS); at most kLocalThreads threads a
// block (LOCAL_THREADS): 1024 for 1-2 planes; 512 for 3-4, whose 24-32
// values a thread (and their peers) need more than the 64 registers a
// thread of a 1024-thread block may have
constexpr int kItems = 8;
constexpr int kGroupBits = 3;
template <int NOPS>
constexpr int kLocalThreads = NOPS <= 2 ? 1024 : 512;
constexpr int kGlobalThreads = 256;

// A run's entry in the run table (ops/bitonic.py:run_table): its stages
// s0 .. s1-1, its kind, and for the merge kinds the one k of its stages.
//   kRunWarp      strides below the warp's span, any order;
//   kRunGroup     at most kGroupBits distinct strides of at least the span;
//   kRunSort256   the stages of levels 2 .. 256 in the network's order
//                 (the in-tile pass's first run), known here at compile
//                 time, so no stage is read from the schedule;
//   kRunMerge     (128, k), (64, k), .., (1, k) with one k >= 256 (a
//                 level's last 8 strides), likewise;
//   kRunGroupMerge (j, k), (j / 2, k), (j / 4, k), j / 4 >= 256, with one
//                 k (three strides of a level above the span), likewise.
constexpr int kRunWarp = 0;
constexpr int kRunGroup = 1;
constexpr int kRunSort256 = 2;
constexpr int kRunMerge = 3;
constexpr int kRunGroupMerge = 4;

// Loads and stores a warp-run chunk: lane l holds the chunk's elements
// 8 l .. 8 l + 7, two 16-byte accesses a plane.  In shared memory the two
// halves go in an order that alternates every four lanes, so each
// quarter-warp's accesses hit eight distinct bank groups.  The plane
// pointers are read from the kernel's parameters at each use, which keeps
// them out of registers.
template <int NOPS, bool GLOBAL>
__device__ __forceinline__ void load_chunk(int (&v)[NOPS][kItems],
                                           const Ops& ops, const int* smem,
                                           unsigned base, int tile_elems,
                                           int off) {
  const int r = (threadIdx.x >> 2) & 1;
#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
    const int4* p = reinterpret_cast<const int4*>(
        (GLOBAL ? ops.in[q] + base : smem + q * tile_elems) + off);
    const int4 a = p[r];
    const int4 b = p[r ^ 1];
    const int4 x = r ? b : a;
    const int4 y = r ? a : b;
    v[q][0] = x.x; v[q][1] = x.y; v[q][2] = x.z; v[q][3] = x.w;
    v[q][4] = y.x; v[q][5] = y.y; v[q][6] = y.z; v[q][7] = y.w;
  }
}

template <int NOPS, bool GLOBAL>
__device__ __forceinline__ void store_chunk(int (&v)[NOPS][kItems],
                                            const Ops& ops, int* smem,
                                            unsigned base, int tile_elems,
                                            int off) {
  const int r = (threadIdx.x >> 2) & 1;
#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
    int4* p = reinterpret_cast<int4*>(
        (GLOBAL ? ops.out[q] + base : smem + q * tile_elems) + off);
    const int4 x = make_int4(v[q][0], v[q][1], v[q][2], v[q][3]);
    const int4 y = make_int4(v[q][4], v[q][5], v[q][6], v[q][7]);
    p[r] = r ? y : x;
    p[r ^ 1] = r ? x : y;
  }
}

// One stage (j, k), j < 256, on a warp-run chunk whose lane holds
// the elements g0 .. g0 + 7 (g0 a multiple of 8): strides 1, 2, 4 in the
// thread, 8 .. 128 by shuffles.  Inlined with constant j and k (the
// compile-time kinds) it folds to straight-line code.
template <int NOPS>
__device__ __forceinline__ void warp_stage(int (&v)[NOPS][kItems],
                                           unsigned g0, unsigned j,
                                           unsigned k, int num_keys,
                                           unsigned mask) {
  if (j < kItems) {
    // k > j: a k below 8 flips inside the thread, any other is g0's
    gst::stage_register_bit<NOPS>(v, j == 1 ? 0 : j == 2 ? 1 : 2,
                                  gst::desc_mask(g0, k, 1u, 2u, 4u),
                                  num_keys);
  } else {
    gst::stage_shuffle<NOPS, kItems>(v, (int)(j / kItems), (g0 & j) == 0,
                                     (g0 & k) == 0, num_keys, mask);
  }
}

// A warp run: each warp walks its 256-element chunks of the tile (a tile
// of 128 is one chunk of 16 lanes), each chunk loaded once into
// registers, taken through every stage of the run with no barrier, and
// stored once.
template <int NOPS, int KIND, bool FROM_GLOBAL, bool TO_GLOBAL>
__device__ __forceinline__ void warp_run(const Ops& ops, int* smem,
                                         unsigned base, int tile_elems,
                                         const int2* __restrict__ sched,
                                         int4 run, int num_keys) {
  const int lanes = blockDim.x < 32 ? blockDim.x : 32;
  const unsigned mask = lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
  const int chunk = lanes * kItems;
  const int warps = (blockDim.x + 31) >> 5;
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x >> 5; c * chunk < tile_elems; c += warps) {
    const int off = c * chunk + lane * kItems;
    int v[NOPS][kItems];
    load_chunk<NOPS, FROM_GLOBAL>(v, ops, smem, base, tile_elems, off);
    const unsigned g0 = base + off;
    if constexpr (KIND == kRunSort256) {
#pragma unroll
      for (int lk = 1; lk <= 8; ++lk) {
#pragma unroll
        for (int lj = lk - 1; lj >= 0; --lj) {
          warp_stage<NOPS>(v, g0, 1u << lj, 1u << lk, num_keys, 0xffffffffu);
        }
      }
    } else if constexpr (KIND == kRunMerge) {
      const unsigned k = (unsigned)run.w;
#pragma unroll
      for (int lj = 7; lj >= 0; --lj) {
        warp_stage<NOPS>(v, g0, 1u << lj, k, num_keys, 0xffffffffu);
      }
    } else {
      for (int s = run.x; s < run.y; ++s) {
        const int2 jk = __ldg(sched + s);
        warp_stage<NOPS>(v, g0, (unsigned)jk.x, (unsigned)jk.y, num_keys,
                         mask);
      }
    }
    store_chunk<NOPS, TO_GLOBAL>(v, ops, smem, base, tile_elems, off);
  }
}

// Inserts a 0 bit at position b of x.
__device__ __forceinline__ unsigned insert_zero(unsigned x, unsigned b) {
  return ((x >> b) << (b + 1)) | (x & ((1u << b) - 1u));
}

// A run of long strides (kRunGroup, kRunGroupMerge).  Its strides' bits,
// padded to kGroupBits with other bits from 5 up to the tile (a tile with
// such a stride has at least 512 elements), become the thread's register
// bits: slot p (thread, thread + blockDim, ...) holds the 8 elements whose
// index is p with those bits inserted, so every stage of the run is a
// register stage.  Bits below 5 stay with the lane, so a warp's 4-byte
// accesses are 32 consecutive words.
template <int NOPS, int KIND, bool FROM_GLOBAL, bool TO_GLOBAL>
__device__ __forceinline__ void group_run(const Ops& ops, int* smem,
                                          unsigned base, int tile_elems,
                                          const int2* __restrict__ sched,
                                          int4 run, int num_keys) {
  unsigned bits = 0;
  if constexpr (KIND == kRunGroupMerge) {
    const unsigned j = (unsigned)__ldg(sched + run.x).x;
    bits = j | (j >> 1) | (j >> 2);
  } else {
    for (int s = run.x; s < run.y; ++s) bits |= (unsigned)__ldg(sched + s).x;
    for (int b = 30 - __clz(tile_elems); __popc(bits) < kGroupBits; --b) {
      bits |= 1u << b;   // bits already in the set stay as they are
    }
  }
  const unsigned m0 = bits & (0u - bits);
  const unsigned m1 = (bits ^ m0) & (0u - (bits ^ m0));
  const unsigned m2 = bits ^ m0 ^ m1;
  const unsigned b0 = __ffs(m0) - 1, b1 = __ffs(m1) - 1, b2 = __ffs(m2) - 1;
  const int slots = tile_elems / kItems;
  for (int p = threadIdx.x; p < slots; p += blockDim.x) {
    const unsigned idx = insert_zero(insert_zero(insert_zero(p, b0), b1), b2);
    int v[NOPS][kItems];
#pragma unroll
    for (int q = 0; q < NOPS; ++q) {
      const int* src =
          (FROM_GLOBAL ? ops.in[q] + base : smem + q * tile_elems) + idx;
#pragma unroll
      for (int e = 0; e < kItems; ++e) {
        v[q][e] = src[(e & 1 ? m0 : 0u) | (e & 2 ? m1 : 0u) |
                      (e & 4 ? m2 : 0u)];
      }
    }
    const unsigned g = base + idx;   // the register bits are 0 here
    if constexpr (KIND == kRunGroupMerge) {
      // k is above the three bits: one direction for the slot
      const unsigned desc = (g & (unsigned)run.w) != 0 ? 0xFFu : 0u;
      gst::stage_in_thread<NOPS, kItems, 4>(v, desc, num_keys);
      gst::stage_in_thread<NOPS, kItems, 2>(v, desc, num_keys);
      gst::stage_in_thread<NOPS, kItems, 1>(v, desc, num_keys);
    } else {
      for (int s = run.x; s < run.y; ++s) {
        const int2 jk = __ldg(sched + s);
        const unsigned j = jk.x;
        gst::stage_register_bit<NOPS>(
            v, j == m0 ? 0 : j == m1 ? 1 : 2,
            gst::desc_mask(g, (unsigned)jk.y, m0, m1, m2), num_keys);
      }
    }
#pragma unroll
    for (int q = 0; q < NOPS; ++q) {
      int* dst = (TO_GLOBAL ? ops.out[q] + base : smem + q * tile_elems) + idx;
#pragma unroll
      for (int e = 0; e < kItems; ++e) {
        dst[(e & 1 ? m0 : 0u) | (e & 2 ? m1 : 0u) | (e & 4 ? m2 : 0u)] =
            v[q][e];
      }
    }
  }
}

template <int NOPS, bool FROM_GLOBAL, bool TO_GLOBAL>
__device__ __forceinline__ void one_run(const Ops& ops, int* smem,
                                        unsigned base, int tile_elems,
                                        const int2* __restrict__ sched,
                                        int4 run, int num_keys) {
  // the network's in-tile pass starts with kRunSort256: compiled for a
  // first run only (elsewhere the generic warp run takes its stages)
  switch (FROM_GLOBAL ? run.z : run.z == kRunSort256 ? kRunWarp : run.z) {
    case kRunSort256:
      if constexpr (FROM_GLOBAL) {
        warp_run<NOPS, kRunSort256, FROM_GLOBAL, TO_GLOBAL>(
            ops, smem, base, tile_elems, sched, run, num_keys);
      }
      break;
    case kRunMerge:
      warp_run<NOPS, kRunMerge, FROM_GLOBAL, TO_GLOBAL>(
          ops, smem, base, tile_elems, sched, run, num_keys);
      break;
    case kRunGroupMerge:
      group_run<NOPS, kRunGroupMerge, FROM_GLOBAL, TO_GLOBAL>(
          ops, smem, base, tile_elems, sched, run, num_keys);
      break;
    case kRunGroup:
      group_run<NOPS, kRunGroup, FROM_GLOBAL, TO_GLOBAL>(
          ops, smem, base, tile_elems, sched, run, num_keys);
      break;
    default:
      warp_run<NOPS, kRunWarp, FROM_GLOBAL, TO_GLOBAL>(
          ops, smem, base, tile_elems, sched, run, num_keys);
  }
}

// One block per tile.  The run table splits the schedule into runs that
// each stay in registers: strides below the warp's span (registers and
// shuffles), or up to kGroupBits long strides (registers, by the group's
// mapping).  The first run reads the input planes, the last writes the
// outputs, and the tile waits in shared memory between runs, with one
// barrier between two runs and none inside one.  A one-run schedule never
// touches shared memory.  Every input element of a tile is read before
// any of its output elements is written, so the kernel may run in place.
//
// KEYS, where not 0, is num_keys known at compile time (the main path's
// 1 key, and 2 for a (code, index) key), so the lexicographic compares
// fold to straight predicate logic; 0 reads num_keys at run time.
template <int NOPS, int KEYS>
__global__ void __launch_bounds__(kLocalThreads<NOPS>)
local_stages(Ops ops, const int2* __restrict__ sched,
             const int4* __restrict__ runs, int num_runs, int num_keys_in,
             int tile_elems) {
  const int num_keys = KEYS ? KEYS : num_keys_in;
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const unsigned base = blockIdx.x * (unsigned)tile_elems;
  if (num_runs <= 1) {   // no stage (a copy) or one run
    const int4 run = num_runs ? __ldg(runs) : make_int4(0, 0, kRunWarp, 0);
    one_run<NOPS, true, true>(ops, smem, base, tile_elems, sched, run,
                              num_keys);
    return;
  }
  one_run<NOPS, true, false>(ops, smem, base, tile_elems, sched,
                             __ldg(runs), num_keys);
  for (int r = 1; r < num_runs - 1; ++r) {
    __syncthreads();
    one_run<NOPS, false, false>(ops, smem, base, tile_elems, sched,
                                __ldg(runs + r), num_keys);
  }
  __syncthreads();
  one_run<NOPS, false, true>(ops, smem, base, tile_elems, sched,
                             __ldg(runs + num_runs - 1), num_keys);
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

template <int NOPS, int KEYS>
int launch_local(const Ops& ops, const int2* sched, const int4* runs,
                 int num_runs, int num_keys, int num_tiles, int tile_elems,
                 cudaStream_t s) {
  const size_t smem = (size_t)NOPS * tile_elems * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      local_stages<NOPS, KEYS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // tile / kItems threads (a tile of 128 is 16 lanes), at most
  // kLocalThreads<NOPS>
  const int threads = tile_elems / kItems < kLocalThreads<NOPS>
                          ? tile_elems / kItems
                          : kLocalThreads<NOPS>;
  local_stages<NOPS, KEYS><<<num_tiles, threads, smem, s>>>(
      ops, sched, runs, num_runs, num_keys, tile_elems);
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
// above j); `runs` is the run table, num_runs (start, end, kind, k) int32
// quadruples in 16-byte aligned device memory that cover the stages in
// order, each a maximal run of strides below the warp's span or a run of
// at most kGroupBits distinct strides of at least the span, its kind
// checked against its stages (ops/bitonic.py:run_table).  Launches
// on `stream`; returns the first CUDA error (0 on success).  Planes past
// num_ops are ignored.
extern "C" int gst_local_stages(const void* in0, const void* in1,
                                const void* in2, const void* in3, void* out0,
                                void* out1, void* out2, void* out3,
                                const void* sched, int num_stages,
                                const void* runs, int num_runs, int num_ops,
                                int num_keys, int num_tiles, int tile_elems,
                                void* stream) {
  if (num_ops < 1 || num_ops > kMaxOps || num_keys < 1 ||
      num_keys > num_ops || num_tiles <= 0 || num_stages < 0 ||
      num_runs < 0 || num_runs > num_stages ||
      (num_stages > 0) != (num_runs > 0) || tile_elems < 128 ||
      !pow2(tile_elems)) {
    return (int)cudaErrorInvalidValue;
  }
  Ops ops = {{static_cast<const int*>(in0), static_cast<const int*>(in1),
              static_cast<const int*>(in2), static_cast<const int*>(in3)},
             {static_cast<int*>(out0), static_cast<int*>(out1),
              static_cast<int*>(out2), static_cast<int*>(out3)}};
  const int2* sc = static_cast<const int2*>(sched);
  const int4* rn = static_cast<const int4*>(runs);
  cudaStream_t s = (cudaStream_t)stream;
  switch (num_ops) {
    case 1:
      return launch_local<1, 1>(ops, sc, rn, num_runs, num_keys, num_tiles,
                                tile_elems, s);
    case 2:
      return num_keys == 1
                 ? launch_local<2, 1>(ops, sc, rn, num_runs, num_keys,
                                      num_tiles, tile_elems, s)
                 : launch_local<2, 2>(ops, sc, rn, num_runs, num_keys,
                                      num_tiles, tile_elems, s);
    case 3:
      return num_keys == 2
                 ? launch_local<3, 2>(ops, sc, rn, num_runs, num_keys,
                                      num_tiles, tile_elems, s)
                 : launch_local<3, 0>(ops, sc, rn, num_runs, num_keys,
                                      num_tiles, tile_elems, s);
    default:
      return num_keys == 2
                 ? launch_local<4, 2>(ops, sc, rn, num_runs, num_keys,
                                      num_tiles, tile_elems, s)
                 : launch_local<4, 0>(ops, sc, rn, num_runs, num_keys,
                                      num_tiles, tile_elems, s);
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
