// Exclusive prefix sum of a 1-D int32 vector for Hopper (sm_90a).
//
// Replaces gpusorting_tpu/ops/kernels.py:_scan_kernel, the Pallas TPU kernel
// behind `exclusive_scan`.  Contract: out[i] = x[0] + ... + x[i-1], out[0] =
// 0, for any length, wrapping like int32 (the sums are taken in uint32).
//
// Bound: memory.  The vector is read once and written once, 8 bytes per
// element; on the sort's path it is 16 * T elements (T = tiles), 8 MB at
// n = 2^28 with 4096-key tiles, 2.5 us at 3.35 TB/s, about one launch's
// latency.  So the design spends nothing beyond one launch: no second pass
// over the data, no spine block, no memset.
//
// The TPU kernel carries a running sum from one grid step to the next,
// which holds only because a TPU grid runs in order.  A CUDA grid does not,
// so this is a single-pass chained scan with decoupled lookback, one
// launch.  Each block:
//   1. draws its tile from an atomic ticket, so every tile it waits on
//      belongs to a block that started before it (no deadlock, however
//      many blocks the grid has);
//   2. loads its tile of kTile elements once into registers (16-byte loads
//      for a whole tile) and reduces it with a block scan;
//   3. has one warp publish the tile's sum as an aggregate and look back
//      over its predecessors' status words 32 at a time, one round trip a
//      step, until it meets an inclusive prefix, then publish its own
//      inclusive prefix (`gst::warp_lookback`, radix_common.cuh, which
//      stitch.cu shares);
//   4. writes its tile's exclusive scan from the registers.
//
// A status word is 64 bits: the flag and a 30-bit epoch in the high half,
// the full 32-bit sum in the low half, since the values span the whole
// int32 range (`gst::pack_word`).  A word counts only if its epoch is the
// call's, so words left by an earlier call read as "nothing published"
// with no clearing: the wrapper owns one zeroed scratch buffer per device
// and stream, shared with the binning pass and the stitch kernels, and
// hands each call the next epoch.  The ticket is the first word of the
// scratch; the block that draws the last ticket sets it back to 0 for the
// stream's next call.

#include <cuda_runtime.h>

#include "radix_common.cuh"

namespace {

using gst::kEpochMask;

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;

__global__ void __launch_bounds__(kThreads)
chained_scan(const int* __restrict__ in, int* __restrict__ out, long long n,
             unsigned* ticket, unsigned long long* status, unsigned epoch,
             unsigned num_tiles) {
  __shared__ unsigned s_tile;
  __shared__ unsigned s_base;
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(ticket, 1u);
    if (t == num_tiles - 1) *ticket = 0u;   // every ticket is drawn
    s_tile = t;
  }
  __syncthreads();
  const long long t = s_tile;
  const long long first = t * kTile + (long long)threadIdx.x * kItems;
  const long long left = n - t * kTile;
  const bool whole = left >= kTile;

  unsigned v[kItems];
  if (whole) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(in + first));
    const int4 b = __ldg(reinterpret_cast<const int4*>(in + first) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      v[i] = first + i < n ? (unsigned)__ldg(in + first + i) : 0u;
    }
  }
  unsigned s = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) s += v[i];
  unsigned total;
  unsigned p = gst::block_exclusive<kThreads>(s, &total);
  if (threadIdx.x < 32) {
    const unsigned base = gst::warp_lookback(status, t, total, epoch);
    if (threadIdx.x == 0) s_base = base;
  }
  __syncthreads();
  p += s_base;

  unsigned w[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    w[i] = p;
    p += v[i];
  }
  if (whole) {
    int4* dst = reinterpret_cast<int4*>(out + first);
    dst[0] = make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
    dst[1] = make_int4((int)w[4], (int)w[5], (int)w[6], (int)w[7]);
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (first + i < n) out[first + i] = (int)w[i];
    }
  }
}

}  // namespace

// One launch on `stream`.  `scratch` is the caller's zeroed buffer for
// this device and stream: a ticket word (8 bytes) then one 64-bit status
// word per tile, of scratch_tiles >= ceil(n / kTile) tiles; `epoch`, in
// [1, 2^30), must differ from every epoch the buffer has seen since it was
// last zeroed.  Returns the first CUDA error (0 on success).
extern "C" int gst_exclusive_scan(const void* in, void* out, long long n,
                                  void* scratch, long long scratch_tiles,
                                  unsigned epoch, void* stream) {
  const long long tiles = (n + kTile - 1) / kTile;
  if (n <= 0 || scratch_tiles < tiles || epoch == 0 || epoch > kEpochMask) {
    return (int)cudaErrorInvalidValue;
  }
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  chained_scan<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(in), static_cast<int*>(out), n,
      reinterpret_cast<unsigned*>(words), words + 1, epoch,
      (unsigned)tiles);
  return (int)cudaGetLastError();
}
