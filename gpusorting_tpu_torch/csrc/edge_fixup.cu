// OR-merge of the row-writing downsweep's partial rows for Hopper (sm_90a).
//
// Replaces gpusorting_tpu/ops/rts.py:_edge_fixup_kernel.  Contract, on 1-3
// int32 output planes of (rows, 128) and T tiles: entry k = (e * 16 + d) *
// T + t of rowtab (2 * 16 * T entries, ops/rts.py:edge_rows of `table`
// and the counts) is the output row of the partial at edge e of tile t's
// digit-d range, or -1 when that partial is absent; table is the
// digit-major (16 * T,) cursor scan, so range m = d * T + t holds the slots
// [table[m], table[m + 1]); for each present entry and each plane q,
//   out[q][rowtab[k]] |= side[((t * NOPS + q) * 16 + d) * 2 + e]
// (128 lanes).  Several entries may name one row.  An entry naming no row
// of the outputs is skipped.
//
// The TPU kernel ran its grid in order on one core, so its read-OR-write
// chains could not race.  Here each named row gets one writer instead.
// The ranges lie in the output in digit-major order, so the ranges that
// share a row are consecutive: the first covers the row's slot 0 and ends
// inside it, so its high partial (edge 1) names the row; each later one
// starts inside the row, and where it holds keys its low partial (edge 0)
// names the row.  The warp of high entry m walks ranges m + 1, m + 2, ...
// while their cursors lie in the row (the table tells a zero-count range,
// which may sit anywhere in the row, from one that starts the next row,
// which rowtab cannot) and ORs the low partials it meets.  The row is
// read once, merged in registers and stored once: no atomic, no order.
//
// Bound: memory.  rowtab and the table are read once (192 bytes a tile),
// the present side rows once, and the rows they name are read and written
// once, 512 bytes a row and plane; at a tile of 32 rows and
// uniform keys about 2^21 entries are present at n = 2^28 (two a range,
// about 2^20 rows named), so about 1 GiB of side rows a plane.
//
// Design: a warp takes kGroup consecutive high entries (one load), and
// for each that names a row, merges that row: the row, its high partial,
// the walk's first window of 32 cursors and the 32 low entries beside them
// are loaded together.  Where a ballot of the cursors finds the walk's end
// in that window (the common case), the low entries naming the row are
// its hits.  Otherwise the row holds more than 32 ranges, most of them
// empty (skewed keys: a digit's empty ranges for later tiles all sit at
// one cursor, perhaps a quarter of a million of them), and a window at a
// time would walk them one round trip each; instead each lane takes 4 of
// the row's slots and finds, by a binary search over table[m + 1 ..] (4
// searches in flight, about log2(16 T) round trips for the whole row), the
// last range starting at or before each slot: a range that starts at its
// slot holds keys, so it is one of the row's low partials.  A row's
// partials are ORed kBatch at a time, their loads issued together.  A
// lane holds 16 bytes of the row a plane: the row and each partial are
// one 16-byte load a lane, the merged row one 16-byte store.  Measured
// (probes/torch_row_form_probe.py --shapes): 4 entries a warp beat 1 by
// up to 1.6x on skewed keys, where most entries are absent, and tie it on
// uniform keys.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDigits = 16;
constexpr int kLanes = 128;
constexpr int kMaxPlanes = 3;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kBatch = 4;   // low partials a warp loads at once
// high entries a warp takes (GST_FIXUP_GROUP may override it at build
// time, as the probe does to compare shapes)
#ifndef GST_FIXUP_GROUP
#define GST_FIXUP_GROUP 4
#endif
constexpr int kGroup = GST_FIXUP_GROUP;
static_assert(kGroup >= 1 && kGroup <= 32 && (kGroup & (kGroup - 1)) == 0,
              "a power of two, at most a warp");

struct Outs {
  int* p[kMaxPlanes];
};

__device__ __forceinline__ void or_into(int4& acc, const int4 v) {
  acc.x |= v.x;
  acc.y |= v.y;
  acc.z |= v.z;
  acc.w |= v.w;
}

// ORs into acc the low partial (edge 0) of range index_of(b) for each set
// bit b of the warp-uniform `hits`, kBatch partials' loads in flight at once.
template <int NOPS, typename IndexOf>
__device__ __forceinline__ void or_lows(int4 (&acc)[NOPS],
                                        const int4* __restrict__ side,
                                        unsigned hits, IndexOf index_of,
                                        int num_tiles, int lane) {
  while (hits) {
    int k[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      k[u] = -1;
      if (hits) {
        k[u] = index_of(__ffs(hits) - 1);
        hits &= hits - 1;
      }
    }
    int4 v[kBatch][NOPS];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int t = k[u] % num_tiles;
      const int d = k[u] / num_tiles;
#pragma unroll
      for (int q = 0; q < NOPS; ++q) {
        const long long srow =
            ((long long)(t * NOPS + q) * kDigits + d) * 2;
        v[u][q] = k[u] >= 0 ? side[srow * (kLanes / 4) + lane]
                            : make_int4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
#pragma unroll
      for (int q = 0; q < NOPS; ++q) or_into(acc[q], v[u][q]);
    }
  }
}

// Merges the row that high entry m names, row (< rows), into place.
template <int NOPS>
__device__ __forceinline__ void fix_row(const Outs& outs,
                                        const int4* __restrict__ side,
                                        const int* __restrict__ rowtab,
                                        const int* __restrict__ table,
                                        int num_tiles, int ranges, int m,
                                        int row, int lane) {
  // the walk's first window, loaded beside the row and its high partial
  const int k = m + 1 + lane;
  const int cursor = k < ranges ? __ldg(table + k) : INT_MAX;
  const int lo = k < ranges ? __ldg(rowtab + k) : -1;
  const int end = (row + 1) * kLanes;
  int4 acc[NOPS];
  {
    const int t = m % num_tiles;
    const int d = m / num_tiles;
#pragma unroll
    for (int q = 0; q < NOPS; ++q) {
      acc[q] = reinterpret_cast<const int4*>(outs.p[q] +
                                             (long long)row * kLanes)[lane];
      const long long srow =
          ((long long)(t * NOPS + q) * kDigits + d) * 2 + 1;
      or_into(acc[q], side[srow * (kLanes / 4) + lane]);
    }
  }
  const bool inside = cursor < end;
  if (__ballot_sync(kAll, inside) != kAll) {
    // the walk ends in its first window
    or_lows<NOPS>(acc, side, __ballot_sync(kAll, inside && lo == row),
                  [m](int b) { return m + 1 + b; }, num_tiles, lane);
  } else {
    // a long walk: the row's slots from the high range's end on, 4 a lane,
    // each found in table[m + 1 ..] by a binary search for the last range
    // starting at or before it; a range that starts at its slot is one of
    // the row's low partials
    const int first = row * kLanes + lane * 4;
    int a[4];
    int at[4];   // table[a[i]]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = m + 1;
      at[i] = __shfl_sync(kAll, cursor, 0);
    }
    for (int span = ranges - (m + 1); span > 1;) {
      const int half = span >> 1;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = __ldg(table + a[i] + half);
        if (c <= first + i) {
          a[i] += half;
          at[i] = c;
        }
      }
      span -= half;
    }
    int rt[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      rt[i] = at[i] == first + i ? __ldg(rowtab + a[i]) : -1;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ai = a[i];
      or_lows<NOPS>(acc, side, __ballot_sync(kAll, rt[i] == row),
                    [ai](int b) { return __shfl_sync(kAll, ai, b); },
                    num_tiles, lane);
    }
  }
#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
    reinterpret_cast<int4*>(outs.p[q] + (long long)row * kLanes)[lane] =
        acc[q];
  }
}

template <int NOPS>
__global__ void __launch_bounds__(kThreads)
edge_fixup(Outs outs, const int4* __restrict__ side,
           const int* __restrict__ rowtab, const int* __restrict__ table,
           int num_tiles, int rows) {
  const int ranges = kDigits * num_tiles;
  const int m0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * kGroup;
  if (m0 >= ranges) return;
  const int lane = threadIdx.x & 31;
  // the group's high entries, one a lane
  const int mine = m0 + (lane & (kGroup - 1));
  const int row_l = mine < ranges ? __ldg(rowtab + ranges + mine) : -1;
  unsigned named = __ballot_sync(
      kAll, lane < kGroup && row_l >= 0 && row_l < rows);
  while (named) {
    const int g = __ffs(named) - 1;
    named &= named - 1;
    fix_row<NOPS>(outs, side, rowtab, table, num_tiles, ranges, m0 + g,
                  __shfl_sync(kAll, row_l, g), lane);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  Planes
// past num_ops are ignored.
extern "C" int gst_edge_fixup(void* out0, void* out1, void* out2,
                              const void* side, const void* rowtab,
                              const void* table, int num_ops, int num_tiles,
                              int rows, void* stream) {
  if (num_ops < 1 || num_ops > kMaxPlanes || num_tiles <= 0 || rows <= 0 ||
      (long long)rows * kLanes >= (1ll << 31) ||
      (long long)num_tiles * kDigits >= (1ll << 31) - 64) {
    return (int)cudaErrorInvalidValue;
  }
  Outs outs = {{static_cast<int*>(out0), static_cast<int*>(out1),
                static_cast<int*>(out2)}};
  const int4* sd = static_cast<const int4*>(side);
  const int* rt = static_cast<const int*>(rowtab);
  const int* tab = static_cast<const int*>(table);
  const long long ranges = (long long)kDigits * num_tiles;
  const long long per_block = (long long)kWarps * kGroup;
  const unsigned blocks = (unsigned)((ranges + per_block - 1) / per_block);
  cudaStream_t s = (cudaStream_t)stream;
  switch (num_ops) {
    case 1:
      edge_fixup<1><<<blocks, kThreads, 0, s>>>(outs, sd, rt, tab,
                                                num_tiles, rows);
      break;
    case 2:
      edge_fixup<2><<<blocks, kThreads, 0, s>>>(outs, sd, rt, tab,
                                                num_tiles, rows);
      break;
    default:
      edge_fixup<3><<<blocks, kThreads, 0, s>>>(outs, sd, rt, tab,
                                                num_tiles, rows);
      break;
  }
  return (int)cudaGetLastError();
}
