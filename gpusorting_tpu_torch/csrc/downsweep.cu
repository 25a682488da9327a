// Table-driven stable scatter of one radix-16 pass (the reduce-then-scan
// Downsweep) for Hopper (sm_90a).
//
// Replaces gpusorting_tpu/ops/rts.py:_downsweep_kernel, the Pallas TPU
// kernel run by `run_downsweep_chunks`.  Contract, on 1-3 int32 planes
// (plane 0 holds the biased key codes, the others ride) cut into tiles of
// tile_elems elements, with T tiles: for every tile t and element i of t in
// input order, with d = digit(plane0[i]) at `shift`,
//   out[p][table[d * T + t] + rank(i)] = in[p][i]   for every plane p,
// where rank(i) counts the earlier elements of tile t whose digit is d.
// table is the digit-major exclusive scan of the per-tile digit counts, so
// the output is a permutation: every element is written exactly once.  The
// TPU kernel's whole-row writes shared the rows at range edges, which it
// OR-merged into a zeroed buffer (and, on dual-core parts, through a side
// buffer and _edge_fixup_kernel); element writes share nothing, so none of
// that is needed here.
//
// Bound: memory.  Each plane is read once and written once, 8 bytes per
// element per plane, plus the small table: at n = 2^28, 0.64 ms per plane
// at the H100 SXM's 3.35 TB/s.
//
// Design against that bound: one block per tile, walking it in chunks of
// kChunk elements, so blocks never wait on one another.  Thread j loads the
// kItems consecutive elements from j * kItems with 16-byte loads and counts
// their digits in its own column of a (digit, thread) counter table in
// shared memory; one block scan of that table in digit-major order gives
// every element its stable place in the chunk sorted by digit.  Each plane
// is then shuffled through shared memory into that order and written out
// by consecutive threads to consecutive addresses within each digit's run,
// so the scattered writes still coalesce.  A per-digit cursor, seeded from
// the table, carries from chunk to chunk.

#include <cuda_runtime.h>

#include "radix_common.cuh"

namespace {

using gst::digit_of;

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kChunk = kThreads * kItems;
constexpr int kDigits = 16;
constexpr int kCounters = kDigits * kThreads;
constexpr int kPerThread = kCounters / kThreads;
constexpr int kMaxOps = 3;

static_assert(kPerThread == kDigits, "each thread scans 16 counters");

// One padding word every 32 counters: the scan's threads read 16
// consecutive counters each, and the padding spreads them over the banks.
__device__ __forceinline__ int padded(int e) { return e + (e >> 5); }

struct Planes {
  const int* in[kMaxOps];
  int* out[kMaxOps];
};

template <int NOPS>
__global__ void __launch_bounds__(kThreads)
downsweep(Planes planes, const int* __restrict__ table, long long tile_elems,
          int num_tiles, int shift) {
  __shared__ unsigned counters[kCounters + kCounters / 32];
  __shared__ int vals[kChunk];
  __shared__ unsigned char digs[kChunk];
  __shared__ int cursor[kDigits];
  __shared__ int start[kDigits + 1];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < kDigits) cursor[tid] = table[(long long)tid * num_tiles + t];
  const long long base = (long long)t * tile_elems;

  for (long long c0 = 0; c0 < tile_elems; c0 += kChunk) {
    for (int e = tid; e < kCounters; e += kThreads) counters[padded(e)] = 0;
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
        const int e = padded(d[it] * kThreads + tid);
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
      c[i] = counters[padded(tid * kPerThread + i)];
      s += c[i];
    }
    unsigned total;
    unsigned p = gst::block_exclusive<kThreads>(s, &total);
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      counters[padded(tid * kPerThread + i)] = p;
      p += c[i];
    }
    __syncthreads();

    if (tid < kDigits) start[tid] = counters[padded(tid * kThreads)];
    if (tid == kDigits) start[kDigits] = (int)total;
    int pos[kItems];
    if (valid) {
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        pos[it] = counters[padded(d[it] * kThreads + tid)] + r[it];
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

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  Planes
// past num_ops are ignored.
extern "C" int gst_downsweep(const void* in0, const void* in1,
                             const void* in2, void* out0, void* out1,
                             void* out2, const void* table, int num_ops,
                             int num_tiles, long long tile_elems, int shift,
                             void* stream) {
  if (num_ops < 1 || num_ops > kMaxOps || num_tiles <= 0 ||
      tile_elems <= 0 || tile_elems % kItems || shift < 0 || shift > 28) {
    return (int)cudaErrorInvalidValue;
  }
  Planes planes = {{static_cast<const int*>(in0),
                    static_cast<const int*>(in1),
                    static_cast<const int*>(in2)},
                   {static_cast<int*>(out0), static_cast<int*>(out1),
                    static_cast<int*>(out2)}};
  const int* tab = static_cast<const int*>(table);
  cudaStream_t s = (cudaStream_t)stream;
  switch (num_ops) {
    case 1:
      downsweep<1><<<num_tiles, kThreads, 0, s>>>(planes, tab, tile_elems,
                                                  num_tiles, shift);
      break;
    case 2:
      downsweep<2><<<num_tiles, kThreads, 0, s>>>(planes, tab, tile_elems,
                                                  num_tiles, shift);
      break;
    default:
      downsweep<3><<<num_tiles, kThreads, 0, s>>>(planes, tab, tile_elems,
                                                  num_tiles, shift);
      break;
  }
  return (int)cudaGetLastError();
}
