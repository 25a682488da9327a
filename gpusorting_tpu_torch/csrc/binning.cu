// One stable LSD radix-16 pass in a single launch (the OneSweep
// DigitBinningPass) for Hopper (sm_90a).
//
// Replaces gpusorting_tpu/ops/radix16.py:_binning_kernel, the Pallas TPU
// kernel built by `_build_pass` (and `_build_pass_with_skip`).  Contract,
// on 1-3 int32 planes (plane 0 the biased key codes, the others ride) cut
// into T tiles of tile_elems elements, a 4-bit digit at `shift` and 16
// starting cursors: for every element i in input order, with d its digit,
//   out[p][cursors[d] + #{ earlier elements of digit d }] = in[p][i],
// and cursors_out[d] = cursors[d] + #{ elements of digit d }.  In the
// digit-plane form (the counterpart of `_build_pass(external_sp=True)`,
// splitsweep's 16-bucket partition) each element's digit is read from an
// int32 plane laid out like the inputs, values in [0, 16), instead of
// taken from its code; the outputs may then have more rows than the inputs
// (16 row-aligned bucket regions).  The TPU kernel's `flush_write` has no
// counterpart: it plain-wrote the partial row of a region no other stream
// shared, and here no row is shared at all.  Run over the
// whole array with cursors = the global digit bases, that is one stable
// pass.  A pass cut into tile ranges is one launch per range, all writing
// into the same output buffers, each starting from the previous range's
// cursors_out (the counterpart of the TPU kernel's resumable segments,
// which alias their outputs across calls).  The TPU kernel streamed whole
// 128-lane rows, so it carried each digit's partial row across tiles and
// flushed it with a read-modify-OR at the end; every element is written at
// its own address here, so no row is shared and no carry exists.
//
// The TPU grid ran its tiles in order and carried the cursors from one to
// the next.  A CUDA grid has no order, so the carry becomes a chained scan
// with decoupled lookback (OneSweep.cu:164-344): each block takes its tile
// from an atomic counter, so every tile it waits on belongs to a block that
// has already started; it counts its tile's 16 digits and publishes each as
// an aggregate in a (T, 16) array of status words, a 2-bit flag over a
// 30-bit count (so the range holds fewer than 2^30 elements); it then walks
// back over its predecessors' words, summing aggregates, until it meets an
// inclusive prefix (tile 0 publishes its count as one at once), and
// publishes its own inclusive prefix (`gst::chained_exclusive`, one call
// per digit).  The status words and the tile counter are zeroed before
// every launch.  The tile's stable scatter is `gst::scatter_tile`
// (radix_common.cuh), shared with downsweep.cu.
//
// Bound: memory.  Each plane is read once and written once, 8 bytes per
// element per plane (the status words are 64 bytes a tile): at n = 2^28,
// 0.641 ms per plane at the H100 SXM's 3.35 TB/s; the digit-plane form
// also reads the digit plane once, 4 bytes per element.  Plane 0 (or the
// digit plane) is read twice, once to count and once to scatter; the second
// read of a 16 KB tile mostly hits L2.

#include <cuda_runtime.h>

#include "radix_common.cuh"

namespace {

using gst::digit_of;
using gst::Planes;

constexpr int kThreads = gst::kScatterThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kDigits = 16;

template <int NOPS, bool DIGITS>
__global__ void __launch_bounds__(kThreads)
binning(Planes planes, const int* __restrict__ digits,
        const int* __restrict__ cursors_in, int* __restrict__ cursors_out,
        unsigned* status, unsigned* next_tile, long long tile_elems,
        int num_tiles, int shift) {
  __shared__ int tile_id;
  __shared__ unsigned bins[kWarps][kDigits];
  __shared__ int cursor[kDigits];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  if (tid == 0) tile_id = (int)atomicAdd(next_tile, 1u);
  if (tid < kWarps * kDigits) bins[tid / kDigits][tid % kDigits] = 0;
  __syncthreads();

  const int t = tile_id;
  const long long base = (long long)t * tile_elems;
  const int4* src = reinterpret_cast<const int4*>(
      (DIGITS ? digits : planes.in[0]) + base);
  for (long long v = tid; v < tile_elems / 4; v += kThreads) {
    const int4 q = __ldg(src + v);
    if (DIGITS) {
      atomicAdd(&bins[warp][q.x], 1u);
      atomicAdd(&bins[warp][q.y], 1u);
      atomicAdd(&bins[warp][q.z], 1u);
      atomicAdd(&bins[warp][q.w], 1u);
    } else {
      atomicAdd(&bins[warp][digit_of(q.x, shift)], 1u);
      atomicAdd(&bins[warp][digit_of(q.y, shift)], 1u);
      atomicAdd(&bins[warp][digit_of(q.z, shift)], 1u);
      atomicAdd(&bins[warp][digit_of(q.w, shift)], 1u);
    }
  }
  __syncthreads();

  if (tid < kDigits) {
    unsigned count = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) count += bins[w][tid];
    const unsigned exclusive =
        gst::chained_exclusive(status + tid, t, kDigits, count);
    cursor[tid] = cursors_in[tid] + (int)exclusive;
    if (t == num_tiles - 1) {
      cursors_out[tid] = cursors_in[tid] + (int)(exclusive + count);
    }
  }
  gst::scatter_tile<NOPS, DIGITS>(planes, base, tile_elems, shift, cursor,
                                  digits);
}

template <int NOPS>
void launch(const Planes& planes, const int* digits, const int* cin,
            int* cout, unsigned* status, unsigned* next_tile,
            long long tile_elems, int num_tiles, int shift, cudaStream_t s) {
  if (digits) {
    binning<NOPS, true><<<num_tiles, kThreads, 0, s>>>(
        planes, digits, cin, cout, status, next_tile, tile_elems, num_tiles,
        shift);
  } else {
    binning<NOPS, false><<<num_tiles, kThreads, 0, s>>>(
        planes, digits, cin, cout, status, next_tile, tile_elems, num_tiles,
        shift);
  }
}

}  // namespace

// Zeroes `scratch` (num_tiles * 16 status words and the tile counter, all
// uint32), then launches on `stream`; returns the first CUDA error (0 on
// success).  Planes past num_ops are ignored; `digits` is null unless the
// digits come from a plane.
extern "C" int gst_binning(const void* in0, const void* in1, const void* in2,
                           void* out0, void* out1, void* out2,
                           const void* digits, const void* cursors_in,
                           void* cursors_out,
                           void* scratch, int num_ops, int num_tiles,
                           long long tile_elems, int shift, void* stream) {
  if (num_ops < 1 || num_ops > gst::kMaxPlanes || num_tiles <= 0 ||
      tile_elems <= 0 || tile_elems % gst::kScatterItems ||
      (long long)num_tiles * tile_elems >= (1ll << 30) || shift < 0 ||
      shift > 28) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  unsigned* status = static_cast<unsigned*>(scratch);
  cudaError_t err = cudaMemsetAsync(
      status, 0, ((size_t)num_tiles * kDigits + 1) * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  Planes planes = {{static_cast<const int*>(in0),
                    static_cast<const int*>(in1),
                    static_cast<const int*>(in2)},
                   {static_cast<int*>(out0), static_cast<int*>(out1),
                    static_cast<int*>(out2)}};
  const int* cin = static_cast<const int*>(cursors_in);
  int* cout = static_cast<int*>(cursors_out);
  unsigned* next_tile = status + (size_t)num_tiles * kDigits;
  const int* dg = static_cast<const int*>(digits);
  switch (num_ops) {
    case 1:
      launch<1>(planes, dg, cin, cout, status, next_tile, tile_elems,
                num_tiles, shift, s);
      break;
    case 2:
      launch<2>(planes, dg, cin, cout, status, next_tile, tile_elems,
                num_tiles, shift, s);
      break;
    default:
      launch<3>(planes, dg, cin, cout, status, next_tile, tile_elems,
                num_tiles, shift, s);
      break;
  }
  return (int)cudaGetLastError();
}
