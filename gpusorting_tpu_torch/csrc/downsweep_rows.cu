// Row-writing form of the reduce-then-scan Downsweep for Hopper (sm_90a).
//
// Replaces gpusorting_tpu/ops/rts.py:_downsweep_kernel in its parallel=True
// ("Megacore") form, which `run_downsweep_chunks` runs before
// _edge_fixup_kernel.  Contract, on 1-3 int32 planes of (rows, 128) (plane
// 0 holds the biased key codes, the others ride) cut into T tiles of
// tile_rows rows: tile t's elements of digit d (at `shift`), in input
// order, fill the output slots [cur, cur + c) with cur = table[d * T + t]
// and c = counts[t * 16 + d].  Call that slot range the (t, d) range.
//   - Every output row whose 128 slots lie in one range is stored whole.
//     The caller zeroed the outputs; no other output row is touched.
//   - A range that starts mid-row stores its part of its first row to
//     side row ((t * NOPS + q) * 16 + d) * 2 + 0 of plane q, the slots of
//     other ranges zero; a range that ends mid-row, in a row after its
//     first or in its first row when that starts on a row boundary,
//     stores its part of its last row to side row ... * 2 + 1.  Other side
//     rows are left unwritten.  (JAX's lo_cond / hi_cond, rts.py:172-181.)
// csrc/edge_fixup.cu then ORs the side rows into the output rows that
// ops/rts.py:edge_rows names.  Several ranges share a row at their edges,
// so no block may store such a row itself: the side rows are what lets
// blocks run in any order and still give one answer.
//
// Bound: memory.  The pass's own bound is the permutation's, each plane
// read once and written once, 8 bytes per element per plane (0.64 ms per
// plane at n = 2^28 at the H100 SXM's 3.35 TB/s); this form also writes
// each partial row to the side buffer and the fixup reads it back, plus the
// zeroing of the outputs: about 2 + 2 * 128 / tile_rows plane-sizes moved
// beyond the permutation (see PERF.md).
//
// Design: one block per tile.  The tile is ranked stably by digit with the
// shared scatter (`gst::scatter_tile`, radix_common.cuh), whose output
// pointers here are a shared-memory stage of NOPS * tile_rows * 512 bytes
// (dynamic shared memory, opted in above 48 KB) and whose cursors start at
// the tile-local digit offsets, the exclusive scan of counts[t].  The
// staged tile is then written row by row: the block's rows (whole rows and
// partials of all 16 digits) are numbered, and warp w takes rows w, w + 8,
// ...; a lane stores 16 bytes, so a warp stores a 512-byte row at once.

#include <cuda_runtime.h>

#include "radix_common.cuh"

namespace {

using gst::Planes;

constexpr int kThreads = gst::kScatterThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kDigits = 16;
constexpr int kLanes = 128;

template <int NOPS>
__global__ void __launch_bounds__(kThreads)
downsweep_rows(Planes planes, int* __restrict__ side,
               const int* __restrict__ table, const int* __restrict__ counts,
               int num_tiles, int tile_rows, int shift) {
  extern __shared__ int4 stage_words[];
  int* stage = reinterpret_cast<int*>(stage_words);
  __shared__ int cursor[kDigits];   // tile-local, for the scatter
  __shared__ int local[kDigits];    // tile-local start of each digit's run
  __shared__ int cur[kDigits];      // absolute start of each range
  __shared__ int cnt[kDigits];
  __shared__ int first_row[kDigits + 1];   // numbering of the block's rows

  const int t = blockIdx.x;
  const long long tile_elems = (long long)tile_rows * kLanes;
  if (threadIdx.x == 0) {
    int s = 0;
    int jobs = 0;
    for (int d = 0; d < kDigits; ++d) {
      const int c = counts[(long long)t * kDigits + d];
      const int g = table[(long long)d * num_tiles + t];
      local[d] = s;
      cursor[d] = s;
      cur[d] = g;
      cnt[d] = c;
      first_row[d] = jobs;
      s += c;
      if (c > 0) {
        const int hi = g + c;
        const int first_full = (g + kLanes - 1) >> 7;
        const int n_full = max(0, (hi >> 7) - first_full);
        const bool lo = (g & (kLanes - 1)) != 0;
        const bool hi_part = (hi & (kLanes - 1)) != 0 &&
                             (hi >> 7) >= first_full;
        jobs += n_full + (lo ? 1 : 0) + (hi_part ? 1 : 0);
      }
    }
    first_row[kDigits] = jobs;
  }
  // the scatter reads cursor[] only after a barrier of its own
  Planes staged = planes;
#pragma unroll
  for (int q = 0; q < gst::kMaxPlanes; ++q) {
    staged.out[q] = q < NOPS ? stage + q * tile_elems : nullptr;
  }
  gst::scatter_tile<NOPS>(staged, (long long)t * tile_elems, tile_elems,
                          shift, cursor);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int jobs = first_row[kDigits];
  for (int j = warp; j < jobs; j += kWarps) {
    int d = 0;
    while (first_row[d + 1] <= j) ++d;
    const int g = cur[d];
    const int hi = g + cnt[d];
    const int first_full = (g + kLanes - 1) >> 7;
    const int n_full = max(0, (hi >> 7) - first_full);
    const bool lo = (g & (kLanes - 1)) != 0;
    int k = j - first_row[d];
    int row;
    int edge = -1;   // -1: a whole output row
    if (lo && k == 0) {
      row = g >> 7;
      edge = 0;
    } else {
      k -= lo ? 1 : 0;
      if (k < n_full) {
        row = first_full + k;
      } else {
        row = hi >> 7;
        edge = 1;
      }
    }
    const long long p0 = (long long)row * kLanes + lane * 4;
    const long long to_stage = (long long)local[d] - g;
#pragma unroll
    for (int q = 0; q < NOPS; ++q) {
      const int* sq = stage + q * tile_elems;
      int v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long p = p0 + i;
        v[i] = (p >= g && p < hi) ? sq[p + to_stage] : 0;
      }
      int* dst = edge < 0
          ? planes.out[q] + p0
          : side + ((((long long)t * NOPS + q) * kDigits + d) * 2 + edge) *
                       kLanes + lane * 4;
      *reinterpret_cast<int4*>(dst) = make_int4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int NOPS>
int launch(const Planes& planes, int* side, const int* table,
           const int* counts, int num_tiles, int tile_rows, int shift,
           cudaStream_t s) {
  const size_t smem = (size_t)NOPS * tile_rows * kLanes * sizeof(int);
  const cudaError_t rc = cudaFuncSetAttribute(
      downsweep_rows<NOPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  downsweep_rows<NOPS><<<num_tiles, kThreads, smem, s>>>(
      planes, side, table, counts, num_tiles, tile_rows, shift);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns a CUDA error code (0 on success).  Planes
// past num_ops are ignored.  The outputs must be zeroed by the caller.
extern "C" int gst_downsweep_rows(const void* in0, const void* in1,
                                  const void* in2, void* out0, void* out1,
                                  void* out2, void* side, const void* table,
                                  const void* counts, int num_ops,
                                  int num_tiles, int tile_rows, int shift,
                                  void* stream) {
  if (num_ops < 1 || num_ops > gst::kMaxPlanes || num_tiles <= 0 ||
      tile_rows <= 0 || shift < 0 || shift > 28) {
    return (int)cudaErrorInvalidValue;
  }
  Planes planes = {{static_cast<const int*>(in0),
                    static_cast<const int*>(in1),
                    static_cast<const int*>(in2)},
                   {static_cast<int*>(out0), static_cast<int*>(out1),
                    static_cast<int*>(out2)}};
  int* sd = static_cast<int*>(side);
  const int* tab = static_cast<const int*>(table);
  const int* cn = static_cast<const int*>(counts);
  cudaStream_t s = (cudaStream_t)stream;
  switch (num_ops) {
    case 1:
      return launch<1>(planes, sd, tab, cn, num_tiles, tile_rows, shift, s);
    case 2:
      return launch<2>(planes, sd, tab, cn, num_tiles, tile_rows, shift, s);
    default:
      return launch<3>(planes, sd, tab, cn, num_tiles, tile_rows, shift, s);
  }
}
