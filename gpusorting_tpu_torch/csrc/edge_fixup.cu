// OR-merge of the row-writing downsweep's partial rows for Hopper (sm_90a).
//
// Replaces gpusorting_tpu/ops/rts.py:_edge_fixup_kernel.  Contract, on 1-3
// int32 output planes of (rows, 128) and T tiles: entry k = (e * 16 + d) *
// T + t of rowtab (2 * 16 * T entries, ops/rts.py:edge_rows) is the output
// row of the partial at edge e of tile t's digit-d range, or -1 when that
// partial is absent; for each present entry and each plane q,
//   out[q][rowtab[k]] |= side[((t * NOPS + q) * 16 + d) * 2 + e]
// (128 lanes).  Several entries may name one row.  An entry naming no row
// of the outputs is skipped.
//
// The TPU kernel ran its grid in order on one core, so its read-OR-write
// chains could not race.  Here blocks run in any order, so every lane ORs
// with atomicOr; OR commutes and is idempotent on the bits it sets, so the
// result does not depend on the order and is deterministic.  A lane skips
// a zero word (the other ranges' slots of a side row), which changes
// nothing.
//
// Bound: memory.  The present side rows are read once and the rows they
// name are read and written once, 512 bytes a row and plane; at the
// "h100" tile of 32 rows and uniform keys about 2^21 entries are present
// at n = 2^28 (two a range), so about 1 GiB of side rows a plane.
//
// Design: one warp per entry, eight to a block; an absent entry's warp
// returns at once.  A lane loads 16 bytes of the side row and ORs its four
// nonzero words into the output row.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDigits = 16;
constexpr int kLanes = 128;
constexpr int kMaxPlanes = 3;

struct Outs {
  int* p[kMaxPlanes];
};

template <int NOPS>
__global__ void __launch_bounds__(kThreads)
edge_fixup(Outs outs, const int4* __restrict__ side,
           const int* __restrict__ rowtab, int num_tiles, int rows) {
  const long long entries = 2LL * kDigits * num_tiles;
  const long long k = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (k >= entries) return;
  const int row = rowtab[k];
  if (row < 0 || row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long per_edge = (long long)kDigits * num_tiles;
  const int e = (int)(k / per_edge);
  const int d = (int)((k % per_edge) / num_tiles);
  const long long t = k % num_tiles;
#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
    const long long srow = ((t * NOPS + q) * kDigits + d) * 2 + e;
    const int4 v = side[srow * (kLanes / 4) + lane];
    int* dst = outs.p[q] + (long long)row * kLanes + lane * 4;
    if (v.x) atomicOr(dst + 0, v.x);
    if (v.y) atomicOr(dst + 1, v.y);
    if (v.z) atomicOr(dst + 2, v.z);
    if (v.w) atomicOr(dst + 3, v.w);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  Planes
// past num_ops are ignored.
extern "C" int gst_edge_fixup(void* out0, void* out1, void* out2,
                              const void* side, const void* rowtab,
                              int num_ops, int num_tiles, int rows,
                              void* stream) {
  if (num_ops < 1 || num_ops > kMaxPlanes || num_tiles <= 0 || rows <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  Outs outs = {{static_cast<int*>(out0), static_cast<int*>(out1),
                static_cast<int*>(out2)}};
  const int4* sd = static_cast<const int4*>(side);
  const int* rt = static_cast<const int*>(rowtab);
  const long long entries = 2LL * kDigits * num_tiles;
  const unsigned blocks = (unsigned)((entries + kWarps - 1) / kWarps);
  cudaStream_t s = (cudaStream_t)stream;
  switch (num_ops) {
    case 1:
      edge_fixup<1><<<blocks, kThreads, 0, s>>>(outs, sd, rt, num_tiles,
                                                rows);
      break;
    case 2:
      edge_fixup<2><<<blocks, kThreads, 0, s>>>(outs, sd, rt, num_tiles,
                                                rows);
      break;
    default:
      edge_fixup<3><<<blocks, kThreads, 0, s>>>(outs, sd, rt, num_tiles,
                                                rows);
      break;
  }
  return (int)cudaGetLastError();
}
