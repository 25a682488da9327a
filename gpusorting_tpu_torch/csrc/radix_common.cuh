// Device helpers shared by the radix kernels (tile_hist4.cu,
// exclusive_scan.cu, downsweep.cu, downsweep_rows.cu, binning.cu) and the
// stitch kernels (stitch.cu): the chained scan's epoch words and its
// one-warp lookback, cp.async copies, warp and block scans, and the stable
// scatter of one tile.

#pragma once

#include <cuda_runtime.h>

namespace gst {

// ---- the chained scan with decoupled lookback (OneSweep.cu:164-344) ------
//
// Used by exclusive_scan.cu, binning.cu and stitch.cu.  A 64-bit status
// word holds the flag (aggregate or inclusive) and a 30-bit epoch in its
// high half and a full 32-bit sum in its low half.  A word counts only if
// its epoch is the call's, so the words an earlier call left read as
// "nothing published" with no clearing: the wrapper owns one zeroed scratch
// buffer per device and stream (`kernels._scan_scratch`), shared by every
// chained kernel on that stream, and hands each call the next epoch.
constexpr unsigned kEpochMask = (1u << 30) - 1u;
constexpr unsigned kEpochAggregate = 1u << 30;
constexpr unsigned kEpochInclusive = 2u << 30;

__device__ __forceinline__ unsigned long long pack_word(unsigned flag,
                                                        unsigned epoch,
                                                        unsigned sum) {
  return ((unsigned long long)(flag | epoch) << 32) | sum;
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// Whether the word w carries `epoch` (it was published by this call).
__device__ __forceinline__ bool word_ready(unsigned long long w,
                                          unsigned epoch) {
  const unsigned high = (unsigned)(w >> 32);
  return high == (kEpochAggregate | epoch) ||
         high == (kEpochInclusive | epoch);
}

// Spins until the word at p carries `epoch`; returns it.
__device__ __forceinline__ unsigned long long wait_word(
    const unsigned long long* p, unsigned epoch) {
  unsigned long long w;
  do {
    w = load_word(p);
  } while (!word_ready(w, epoch));
  return w;
}

__device__ __forceinline__ bool word_inclusive(unsigned long long w) {
  return ((unsigned)(w >> 32) & ~kEpochMask) == kEpochInclusive;
}

// Run by the 32 lanes of one warp for tile t, whose word is status[t], with
// sum `total`: publishes it as an aggregate (tile 0 at once as an inclusive
// prefix), looks back over its predecessors' words 32 at a time (lane l
// reads tile top - l, so a step is one round trip), summing aggregates up
// to the nearest inclusive prefix, and publishes its own inclusive prefix.
// Returns the sum of tiles 0 .. t-1 in every lane.  Tiles must be handed
// out in the order blocks start (an atomic ticket), so that every tile
// waited on belongs to a block that is already running.
__device__ __forceinline__ unsigned warp_lookback(unsigned long long* status,
                                                  long long t,
                                                  unsigned total,
                                                  unsigned epoch) {
  const int lane = threadIdx.x & 31;
  if (t == 0) {
    if (lane == 0) {
      atomicExch(status, pack_word(kEpochInclusive, epoch, total));
    }
    return 0u;
  }
  if (lane == 0) {
    atomicExch(status + t, pack_word(kEpochAggregate, epoch, total));
  }
  unsigned exclusive = 0;
  for (long long top = t - 1;; top -= 32) {
    // a lane before tile 0 reads as an inclusive 0 (tile 0 always
    // publishes an inclusive prefix, so the window that reaches it stops
    // there anyway)
    const long long k = top - lane;
    bool incl = true;
    unsigned sum = 0;
    if (k >= 0) {
      const unsigned long long w = wait_word(status + k, epoch);
      incl = word_inclusive(w);
      sum = (unsigned)w;
    }
    const unsigned inclusive = __ballot_sync(0xffffffffu, incl);
    // the nearest inclusive prefix ends the walk: sum the lanes up to it
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    unsigned part = lane <= stop ? sum : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, o);
    }
    exclusive += part;
    if (inclusive) break;
  }
  if (lane == 0) {
    atomicExch(status + t,
               pack_word(kEpochInclusive, epoch, exclusive + total));
  }
  return exclusive;
}

// ---- cp.async (binning.cu, stitch.cu) -------------------------------------
//
// Copies from global to shared memory without registers, completed by
// cp_async_wait and a barrier.

// 16 bytes, both addresses 16-byte aligned (cached in L2 only).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// 4 bytes, both addresses 4-byte aligned.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

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

// ---- the stable scatter of one tile (downsweep.cu, downsweep_rows.cu) -----

constexpr int kScatterThreads = 256;   // the block size of its callers
constexpr int kScatterItems = 8;       // consecutive keys per thread
constexpr int kScatterChunk = kScatterThreads * kScatterItems;
constexpr int kMaxPlanes = 3;

// 1-3 int32 planes (plane 0 holds the biased key codes, the others ride)
// and their outputs.
struct Planes {
  const int* in[kMaxPlanes];
  int* out[kMaxPlanes];
};

// One padding word every 32 counters: the scan's threads read 16
// consecutive counters each, and the padding spreads them over the banks.
__device__ __forceinline__ int padded_counter(int e) { return e + (e >> 5); }

// Stable scatter of the tile [base, base + tile_elems) of every plane: the
// element at i with digit d goes to out[cursor[d] + rank(i)], rank(i)
// counting the tile's earlier elements of digit d, and cursor[] (16 ints in
// shared memory) ends advanced past the tile.  The caller fills cursor[]
// before the call; it is first read after a barrier inside.  tile_elems is
// a multiple of kScatterItems.  Every thread of the block must call it.
// The digit is the code's 4 bits at `shift`.
//
// The tile is walked in chunks of kScatterChunk elements.  Thread j loads
// the kScatterItems consecutive elements from j * kScatterItems with
// 16-byte loads and counts their digits in its own column of a (digit,
// thread) counter table; one block scan of that table in digit-major order
// gives every element its stable place in the chunk sorted by digit.  Each
// plane is then shuffled through shared memory into that order and written
// by consecutive threads to consecutive addresses within each digit's run,
// so the scattered writes still coalesce.
template <int NOPS>
__device__ void scatter_tile(const Planes& planes, long long base,
                             long long tile_elems, int shift, int* cursor) {
  constexpr int kThreads = kScatterThreads;
  constexpr int kItems = kScatterItems;
  constexpr int kChunk = kScatterChunk;
  constexpr int kDigits = 16;
  constexpr int kCounters = kDigits * kThreads;
  constexpr int kPerThread = kCounters / kThreads;
  static_assert(kPerThread == kDigits, "each thread scans 16 counters");
  static_assert(NOPS >= 1 && NOPS <= kMaxPlanes, "1-3 planes");

  __shared__ unsigned counters[kCounters + kCounters / 32];
  __shared__ int vals[kChunk];
  __shared__ unsigned char digs[kChunk];
  __shared__ int start[kDigits + 1];

  const int tid = threadIdx.x;
  for (long long c0 = 0; c0 < tile_elems; c0 += kChunk) {
    for (int e = tid; e < kCounters; e += kThreads) {
      counters[padded_counter(e)] = 0;
    }
    __syncthreads();

    // a tile is a whole number of kItems groups: a thread's group is
    // either wholly inside the tile or wholly past its end
    const long long i0 = c0 + (long long)tid * kItems;
    const bool valid = i0 < tile_elems;
    int v[NOPS][kItems];
    unsigned d[kItems];
    unsigned r[kItems];
    if (valid) {
#pragma unroll
      for (int q = 0; q < NOPS; ++q) {
        const int4* src =
            reinterpret_cast<const int4*>(planes.in[q] + base + i0);
        const int4 a = __ldg(src);
        const int4 b = __ldg(src + 1);
        v[q][0] = a.x; v[q][1] = a.y; v[q][2] = a.z; v[q][3] = a.w;
        v[q][4] = b.x; v[q][5] = b.y; v[q][6] = b.z; v[q][7] = b.w;
      }
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        d[it] = digit_of(v[0][it], shift);
        const int e = padded_counter(d[it] * kThreads + tid);
        r[it] = counters[e];
        counters[e] = r[it] + 1;
      }
    }
    __syncthreads();

    // exclusive scan of the counters in (digit, thread) order
    unsigned c[kPerThread];
    unsigned s = 0;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      c[i] = counters[padded_counter(tid * kPerThread + i)];
      s += c[i];
    }
    unsigned total;
    unsigned p = block_exclusive<kThreads>(s, &total);
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      counters[padded_counter(tid * kPerThread + i)] = p;
      p += c[i];
    }
    __syncthreads();

    if (tid < kDigits) start[tid] = counters[padded_counter(tid * kThreads)];
    if (tid == kDigits) start[kDigits] = (int)total;
    int pos[kItems];
    if (valid) {
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        pos[it] = counters[padded_counter(d[it] * kThreads + tid)] + r[it];
        digs[pos[it]] = (unsigned char)d[it];
      }
    }
    __syncthreads();

    const long long left = tile_elems - c0;
    const int chunk_n = left < kChunk ? (int)left : kChunk;
#pragma unroll
    for (int q = 0; q < NOPS; ++q) {
      if (valid) {
#pragma unroll
        for (int it = 0; it < kItems; ++it) vals[pos[it]] = v[q][it];
      }
      __syncthreads();
      int* out = planes.out[q];
      for (int k = tid; k < chunk_n; k += kThreads) {
        const int dd = digs[k];
        out[(long long)cursor[dd] + (k - start[dd])] = vals[k];
      }
      __syncthreads();
    }
    if (tid < kDigits) cursor[tid] += start[tid + 1] - start[tid];
  }
}

}  // namespace gst
