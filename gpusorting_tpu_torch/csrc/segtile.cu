// The segmented sort's shared-memory tile for Hopper (sm_90a): every
// segment of up to 8192 keys sorted inside one group of threads, all of
// them by one launch.  The port's counterpart of SplitSort's bin kernels
// for segments of at most 8192 (SplitSortRadixFine, an in-shared-memory
// LSD radix sort of 8-bit digits bounded by BITS_TO_SORT that carries the
// payload by index chasing; SplitSort.cuh:228-453,
// SplitSortVariants.cuh:846-1138).
//
// Replaces no TPU kernel.  The JAX package sorts random-length segments by
// two overlapping window sorts or by one sort of the whole buffer keyed by
// (segment id, code); on the card both go through the library's sort over
// int64 keys, with a host plan, elementwise build passes and gathers
// around it.  Here each pair is read once and written once.
//
// Contract, on n raw 32-bit keys of one kind (0 u32, 1 i32, 2 f32) in
// segments given by their exclusive starts (seg_count u32 words, starting
// at 0 and never decreasing; segment b is [starts[b], starts[b + 1]), the
// last one ends at n, a start past n reads as n): within each segment,
// `out` gets the keys in ascending order of the low 8 * passes bits of
// their u32 codes (core/codec.py: u32 as is, i32 with the sign bit flipped,
// f32 with every bit flipped where the sign is set and the sign bit set
// elsewhere), equal ones in input order.  The keys move as raw bits: the
// codes are computed on load and undone on the store.  A payload moves as
// raw bits to where its key goes: one or two planes of 32-bit words, or
// one plane of 64-bit words.  The inputs are only read.
//
// A group of kGroupThreads threads sorts one segment (one warp, eight
// groups a block, for the smallest tile; one block otherwise):
//   load    the segment's keys, once, warp-striped into registers (key x
//           of the group's items items a thread at warp x / (32 items),
//           item (x / 32) % items, lane x % 32, with items the fewest that
//           hold the segment), each key's code beside its 16-bit position
//           in the segment.  The slots past the segment's end hold code
//           0xFFFFFFFF: they rank after every key of the segment in every
//           pass, so they end past it and are never written out.
//   pass p  ranks each key by its digit (code >> 8p) & 255 among its
//           warp's keys by a warp multisplit (8 ballots of the digit's
//           bits, as binning256.cu does), the lowest lane of each digit
//           adding their number to the warp's 256 counters; then the
//           group's threads turn the counters into each digit's start (a
//           thread's digits: the counts of the warps below it, then a scan
//           of the 256 digit totals, one barrier inside) and each key goes,
//           with its position, to its digit's start plus its rank in the
//           shared-memory stage.
//           Item by item, lane by lane follows the stage's order, so each
//           pass is stable, and the next pass loads the stage in the same
//           layout.
//   store   the stage's keys out in order; each payload word read from the
//           segment's own range at its key's position, once.
// The tile (the largest segment a launch takes) is one of five
// instantiations, picked by the caller from the layout's longest segment:
//   256 (a warp x 8 keys, 8 warps a block), 1024 (64 threads x 16),
//   2048 (128 x 16), 4096 (256 x 16), 8192 (512 x 16).
// Each runs 32 warps an SM at up to 64 registers a thread.  A group's
// shared memory is its stage (4 bytes of code and 2 of position a slot)
// and its warps' counters: 64 KB at the 8192 tile, two blocks an SM.  On
// the H100, at 2^26 keys in segments of 1-4096 by 32 bits, 256 x 16 took
// 1.705 ms against 2.224 for 512 x 8 (PERF.md §6).
//
// Bound: memory.  Each key and payload word is read once and written once:
// 16 bytes a (u32, u32) pair, 0.320 ms at n = 2^26 on the H100 SXM's
// 3.35 TB/s; 24 bytes a (u32, 64-bit) pair, 0.481 ms.

#include <cuda_runtime.h>

#include "radix_common.cuh"

namespace {

constexpr int kDigits = 256;
constexpr unsigned kAll = 0xffffffffu;

// One instantiation: kGroupThreads threads sort a segment of at most
// kSize keys, kItems a thread at most; kGroups groups a block.
template <int GT, int ITEMS>
struct Tile {
  static constexpr int kGroupThreads = GT;
  static constexpr int kItems = ITEMS;
  static constexpr int kWarps = GT / 32;
  static constexpr int kSize = GT * ITEMS;
  static constexpr int kGroups = GT == 32 ? 8 : 1;
  static constexpr int kThreads = GT * kGroups;
  static constexpr int kStageBytes = kSize * 4;
  static constexpr int kCountBytes = kWarps * kDigits * 4;
  static constexpr int kPosBytes = kSize * 2;
  static constexpr int kSumBytes = 32;   // the scan's warp totals
  static constexpr int kGroupBytes =
      kStageBytes + kCountBytes + kSumBytes + kPosBytes;
  static constexpr int kSmem = kGroups * kGroupBytes;
  static_assert(GT % 32 == 0 && GT <= 1024, "group size");
  static_assert(kSize <= 65536 && 32 * ITEMS <= 65536, "16-bit positions");
};

// The u32 code of a raw key of kind `kind` (0 u32, 1 i32, 2 f32), and back.
__device__ __forceinline__ unsigned code_of(unsigned raw, int kind) {
  if (kind == 0) return raw;
  if (kind == 1) return raw ^ 0x80000000u;
  return raw ^ ((unsigned)((int)raw >> 31) | 0x80000000u);
}

__device__ __forceinline__ unsigned raw_of(unsigned code, int kind) {
  if (kind == 0) return code;
  if (kind == 1) return code ^ 0x80000000u;
  return code & 0x80000000u ? code ^ 0x80000000u : ~code;
}

// The lanes of the warp whose digit is d: 8 ballots of its bits.
__device__ __forceinline__ unsigned peers_of(unsigned d) {
  unsigned peers = kAll;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned ones = __ballot_sync(kAll, bit);
    peers &= bit ? ones : ~ones;
  }
  return peers;
}

template <int GT>
__device__ __forceinline__ void group_sync() {
  if constexpr (GT == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Turns the group's counters (warp w's count of digit d at w * 256 + d)
// into starts: the count of the group's keys of lower digits plus those of
// digit d in lower warps.  The kScan threads that scan take kPer digits
// each: their warps scan the digit totals, and each thread adds the totals
// of the scanning warps below its own (`sums`, a word a warp), one barrier
// between.  `t` is the thread's index in the group; every thread of the
// group calls it, and it ends with the group's barrier.
template <int GT>
__device__ __forceinline__ void digit_starts(unsigned* counts, unsigned* sums,
                                             int t) {
  constexpr int kWarps = GT / 32;
  constexpr int kScan = GT < kDigits ? GT : kDigits;   // threads that scan
  constexpr int kPer = kDigits / kScan;                 // digits a thread
  constexpr int kScanWarps = kScan / 32;
  unsigned run[kPer];
  unsigned sum = 0;
  if (t < kScan) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int d = t * kPer + j;
      unsigned r = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const unsigned c = counts[w * kDigits + d];
        counts[w * kDigits + d] = r;
        r += c;
      }
      run[j] = r;
      sum += r;
    }
  }
  unsigned base = 0;
  if (t < kScan) {
    const unsigned incl = gst::warp_inclusive(sum);
    base = incl - sum;
    if (kScanWarps > 1 && (t & 31) == 31) sums[t >> 5] = incl;
  }
  if constexpr (kScanWarps > 1) {
    group_sync<GT>();
    if (t < kScan) {
      for (int w = 0; w < (t >> 5); ++w) base += sums[w];
    }
  }
  if (t < kScan) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int d = t * kPer + j;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) counts[w * kDigits + d] += base;
      base += run[j];
    }
  }
  group_sync<GT>();
}

// Sorts segment blockIdx.x * kGroups + group, as the contract says.
// `payload`: 0 none, 1 one plane of 32-bit words (v0 -> o0), 2 two (v1 ->
// o1 too), 3 one plane of 64-bit words (v0 -> o0).
template <int GT, int ITEMS, int MIN_BLOCKS>
__global__ void __launch_bounds__(Tile<GT, ITEMS>::kThreads, MIN_BLOCKS)
segtile(const unsigned* __restrict__ keys, unsigned* __restrict__ out,
        const unsigned* __restrict__ starts, unsigned seg_count, unsigned n,
        const void* __restrict__ v0, void* __restrict__ o0,
        const unsigned* __restrict__ v1, unsigned* __restrict__ o1,
        int payload, int kind, int passes) {
  using T = Tile<GT, ITEMS>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = threadIdx.x / GT;
  const int t = threadIdx.x % GT;
  const int lane = t & 31;
  const int warp = t >> 5;
  const unsigned seg = blockIdx.x * T::kGroups + group;
  // group-uniform exits: a whole block where the group is the block
  if (seg >= seg_count) return;
  const unsigned s = min(starts[seg], n);
  const unsigned e = seg + 1 < seg_count ? min(starts[seg + 1], n) : n;
  if (e <= s) return;
  const unsigned len = e - s;
  if (len > (unsigned)T::kSize) return;   // the caller's tile holds it
  if (len == 1) {
    if (t == 0) {
      out[s] = keys[s];
      if (payload == 3) {
        static_cast<unsigned long long*>(o0)[s] =
            static_cast<const unsigned long long*>(v0)[s];
      } else if (payload) {
        static_cast<unsigned*>(o0)[s] = static_cast<const unsigned*>(v0)[s];
        if (payload == 2) o1[s] = v1[s];
      }
    }
    return;
  }

  unsigned char* gs = smem + group * T::kGroupBytes;
  unsigned* stage = reinterpret_cast<unsigned*>(gs);
  unsigned* counts = reinterpret_cast<unsigned*>(gs + T::kStageBytes);
  unsigned* sums =
      reinterpret_cast<unsigned*>(gs + T::kStageBytes + T::kCountBytes);
  unsigned short* spos = reinterpret_cast<unsigned short*>(
      gs + T::kStageBytes + T::kCountBytes + T::kSumBytes);
  unsigned* wc = counts + warp * kDigits;   // the warp's 256 counters
  const int items = (int)((len + GT - 1) / GT);   // <= ITEMS
  const unsigned first = warp * 32u * items + lane;   // item i: first + 32i

  // the keys, once, into registers: code, and position | rank << 16
  unsigned key[ITEMS];
  unsigned pr[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (i < items) {
      const unsigned x = first + 32u * i;
      key[i] = x < len ? code_of(__ldg(keys + s + x), kind) : kAll;
      pr[i] = x;
    }
  }
  const unsigned below = (1u << lane) - 1u;
  for (int p = 0; p < passes; ++p) {
    const int shift = 8 * p;
    if (p > 0) {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        if (i < items) {
          const unsigned x = first + 32u * i;
          key[i] = stage[x];
          pr[i] = spos[x];
        }
      }
    }
    for (int j = lane; j < kDigits; j += 32) wc[j] = 0;
    __syncwarp();
    // the warp multisplit: each key's rank among its warp's keys of its
    // digit, the lowest lane of each digit adding their number
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (i < items) {
        const unsigned d = (key[i] >> shift) & 255u;
        const unsigned peers = peers_of(d);
        const unsigned rank = __popc(peers & below);
        unsigned before = 0;
        if (rank == 0) before = atomicAdd(wc + d, (unsigned)__popc(peers));
        const unsigned r = __shfl_sync(kAll, before, __ffs(peers) - 1) + rank;
        pr[i] = (pr[i] & 0xFFFFu) | (r << 16);
      }
    }
    group_sync<GT>();
    digit_starts<GT>(counts, sums, t);
    // every key of the group is in registers: the stage is free
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (i < items) {
        const unsigned to = (pr[i] >> 16) + wc[(key[i] >> shift) & 255u];
        stage[to] = key[i];
        spos[to] = (unsigned short)pr[i];
      }
    }
    group_sync<GT>();
  }

  for (unsigned j = t; j < len; j += GT) out[s + j] = raw_of(stage[j], kind);
  if (payload == 3) {
    const unsigned long long* v = static_cast<const unsigned long long*>(v0);
    unsigned long long* o = static_cast<unsigned long long*>(o0);
    for (unsigned j = t; j < len; j += GT) o[s + j] = __ldg(v + s + spos[j]);
  } else if (payload) {
    const unsigned* v = static_cast<const unsigned*>(v0);
    unsigned* o = static_cast<unsigned*>(o0);
    for (unsigned j = t; j < len; j += GT) {
      const unsigned x = s + spos[j];
      o[s + j] = __ldg(v + x);
      if (payload == 2) o1[s + j] = __ldg(v1 + x);
    }
  }
}

template <int GT, int ITEMS, int MIN_BLOCKS>
int enqueue(const unsigned* keys, unsigned* out, const unsigned* starts,
            unsigned seg_count, unsigned n, const void* v0, void* o0,
            const unsigned* v1, unsigned* o1, int payload, int kind,
            int passes, cudaStream_t s) {
  using T = Tile<GT, ITEMS>;
  auto kernel = segtile<GT, ITEMS, MIN_BLOCKS>;
  // above 48 KB a block opts in; the attribute is the function's, on the
  // current device, and costs a runtime call, so it is set once a device
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (T::kSmem > (48 << 10) && !(dev < 64 && opted[dev])) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) opted[dev] = true;
  }
  const unsigned blocks = (seg_count + T::kGroups - 1) / T::kGroups;
  kernel<<<blocks, T::kThreads, T::kSmem, s>>>(keys, out, starts, seg_count,
                                                n, v0, o0, v1, o1, payload,
                                                kind, passes);
  return (int)cudaGetLastError();
}

}  // namespace

// One segmented sort of n raw 32-bit keys (0 < n < 2^31) of kind `kind`
// (0 u32, 1 i32, 2 f32) in seg_count (0 < seg_count < 2^31) segments, by
// the low 8 * passes bits of their codes (1 <= passes <= 4), on `stream`:
// one launch.  `starts` holds the segments' exclusive starts as 32-bit
// words (the contract above: the first 0, none below its predecessor);
// every segment must hold at most `tile` keys, and `tile` must be one of
// 256, 1024, 2048, 4096, 8192 (a longer segment is left unwritten).
// `out` gets n keys.  `payload`: 0 none (v0, o0, v1, o1 unused), 1 one
// plane of n 32-bit words v0 -> o0, 2 two (v1 -> o1 too), 3 one plane of n
// 64-bit words v0 -> o0 (8-byte aligned).  Every buffer is 4-byte aligned,
// and the outputs do not overlap the inputs.  Returns the first CUDA
// error (0 on success).
extern "C" int gst_segtile_sort(const void* keys, void* out,
                                const void* starts, long long seg_count,
                                long long n, const void* v0, void* o0,
                                const void* v1, void* o1, int payload,
                                int kind, int passes, int tile,
                                void* stream) {
  const size_t a = (size_t)keys | (size_t)out | (size_t)starts;
  const size_t va = payload == 3 ? 7u : 3u;
  bool bad = n <= 0 || n >= (1ll << 31) || seg_count <= 0 ||
             seg_count >= (1ll << 31) || kind < 0 || kind > 2 ||
             payload < 0 || payload > 3 || passes < 1 || passes > 4 ||
             (a & 3u);
  if (payload) bad = bad || (((size_t)v0 | (size_t)o0) & va);
  if (payload == 2) bad = bad || (((size_t)v1 | (size_t)o1) & 3u);
  if (bad) return (int)cudaErrorInvalidValue;
  const unsigned* k = static_cast<const unsigned*>(keys);
  unsigned* o = static_cast<unsigned*>(out);
  const unsigned* st = static_cast<const unsigned*>(starts);
  const unsigned* w1 = static_cast<const unsigned*>(v1);
  unsigned* p1 = static_cast<unsigned*>(o1);
  const unsigned S = (unsigned)seg_count, N = (unsigned)n;
  cudaStream_t s = (cudaStream_t)stream;
  switch (tile) {
    case 256:
      return enqueue<32, 8, 4>(k, o, st, S, N, v0, o0, w1, p1, payload,
                               kind, passes, s);
    case 1024:
      return enqueue<64, 16, 16>(k, o, st, S, N, v0, o0, w1, p1, payload,
                                 kind, passes, s);
    case 2048:
      return enqueue<128, 16, 8>(k, o, st, S, N, v0, o0, w1, p1, payload,
                                 kind, passes, s);
    case 4096:
      return enqueue<256, 16, 4>(k, o, st, S, N, v0, o0, w1, p1, payload,
                                 kind, passes, s);
    case 8192:
      return enqueue<512, 16, 2>(k, o, st, S, N, v0, o0, w1, p1, payload,
                                 kind, passes, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
