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
// OR-merged into a zeroed buffer; element writes share nothing, so this
// form needs no merge.  Its dual-core form, which sends the shared rows
// through a side buffer to _edge_fixup_kernel, is downsweep_rows.cu with
// edge_fixup.cu, the pass that GST_MEGACORE=1 selects (ops/rts.py).
//
// Bound: memory.  Each plane is read once and written once, 8 bytes per
// element per plane, plus the small table: at n = 2^28, 0.64 ms per plane
// at the H100 SXM's 3.35 TB/s.
//
// Design against that bound: one block per tile, so blocks never wait on
// one another.  The tile's stable scatter is `gst::scatter_tile`
// (radix_common.cuh, shared with binning.cu): it walks the tile in chunks,
// ranks each chunk by a (digit, thread) counter scan in shared memory and
// writes every digit's run with consecutive threads on consecutive
// addresses; a per-digit cursor, seeded from the table, carries from chunk
// to chunk.

#include <cuda_runtime.h>

#include "radix_common.cuh"

namespace {

using gst::Planes;

constexpr int kThreads = gst::kScatterThreads;
constexpr int kDigits = 16;

template <int NOPS>
__global__ void __launch_bounds__(kThreads)
downsweep(Planes planes, const int* __restrict__ table, long long tile_elems,
          int num_tiles, int shift) {
  __shared__ int cursor[kDigits];
  const int t = blockIdx.x;
  if (threadIdx.x < kDigits) {
    cursor[threadIdx.x] = table[(long long)threadIdx.x * num_tiles + t];
  }
  gst::scatter_tile<NOPS>(planes, (long long)t * tile_elems, tile_elems,
                          shift, cursor);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  Planes
// past num_ops are ignored.
extern "C" int gst_downsweep(const void* in0, const void* in1,
                             const void* in2, void* out0, void* out1,
                             void* out2, const void* table, int num_ops,
                             int num_tiles, long long tile_elems, int shift,
                             void* stream) {
  if (num_ops < 1 || num_ops > gst::kMaxPlanes || num_tiles <= 0 ||
      tile_elems <= 0 || tile_elems % gst::kScatterItems || shift < 0 ||
      shift > 28) {
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
