// One stable LSD radix-16 pass in a single launch (the OneSweep
// DigitBinningPass, OneSweep.cu:164-344) for Hopper (sm_90a).
//
// Replaces gpusorting_tpu/ops/radix16.py:_binning_kernel, the Pallas TPU
// kernel built by `_build_pass` (and `_build_pass_with_skip`).  Contract,
// on 1-3 int32 planes of n elements (plane 0 the biased key codes, the
// others ride), a 4-bit digit at `shift` and 16 starting cursors: for every
// element i in input order, with d its digit,
//   out[p][cursors[d] + #{ earlier elements of digit d }] = in[p][i],
// and cursors_out[d] = cursors[d] + #{ elements of digit d }.  In the
// digit-plane form (the counterpart of `_build_pass(external_sp=True)`,
// splitsweep's 16-bucket partition) each element's digit is read from an
// int32 plane laid out like the inputs, values in [0, 16), instead of
// taken from its code; the outputs may then have more rows than the inputs
// (16 row-aligned bucket regions).  The TPU kernel's `flush_write` has no
// counterpart: it plain-wrote the partial row of a region no other stream
// shared, and here no row is shared at all.  Run over the whole array with
// cursors = the global digit bases, that is one stable pass.  A pass cut
// into ranges is one launch per range, all writing into the same output
// buffers, each starting from the previous range's cursors_out (the
// counterpart of the TPU kernel's resumable segments, which alias their
// outputs across calls).  The TPU kernel streamed whole 128-lane rows, so
// it carried each digit's partial row across tiles and flushed it with a
// read-modify-OR at the end; every element is written at its own address
// here, so no row is shared and no carry exists.
//
// The TPU grid ran its tiles in order and carried the cursors from one to
// the next.  A CUDA grid has no order, so the carry becomes a chained scan
// with decoupled lookback over the kernel's own partitions of kPart
// elements (the wrapper's tile only cuts `segments=` ranges; the last
// partition of a launch is ragged and masked).  Each block:
//   1. draws its partition from an atomic ticket, so every partition it
//      waits on belongs to a block that is already running;
//   2. starts copying the rider planes (all but plane 0; all in the
//      digit-plane form) into shared memory in input order, 16 bytes a
//      copy with cp.async, so they arrive while it ranks and cost no
//      registers;
//   3. reads the digit carrier (plane 0, or the digit plane) ONCE into
//      registers, warp-striped: item i of lane l is element 32 i + l of the
//      warp's kItems * 32 elements (each load a warp's 128 consecutive
//      bytes), so ranking item by item, lane by lane, follows the input
//      order, the stability the contract needs (16-byte loads would put
//      four consecutive elements in one lane and break it);
//   4. ranks each item by a warp multisplit: four __ballot_sync of the
//      digit's bits give the lanes that share it, the __popc of those below
//      the lane its rank; each lane keeps the warp's running count of the
//      digit (lane & 15) in a register, so no counter table and no shared
//      atomic exists;
//   5. scans 16 digits x warps once: each warp's offset within a digit,
//      the partition's 16 counts and its digit starts; publishes the counts
//      as aggregates at once, before any write;
//   6. places the carrier in digit order in a shared staging buffer, and
//      beside each slot its source element where riders follow; then one
//      warp looks back for all 16 digits at once: its lanes read (digit,
//      predecessor) words, 2 kLook predecessors x 16 digits a step in one
//      round trip, summed with one shuffle; it publishes the inclusive
//      prefixes;
//   7. writes the partition out in digit order, the carrier from the
//      staging buffer and each rider from its copy through the slot's
//      source: consecutive threads on consecutive addresses within each
//      digit's run.
// The status words are 64 bits with a per-call epoch (`gst::pack_word`,
// radix_common.cuh, as in exclusive_scan.cu): the wrapper owns one zeroed
// scratch buffer per device and stream, so no launch clears anything; the
// ticket is its first word, set back to 0 by the block that draws the last
// ticket.
//
// Bound: memory.  Each plane is read once and written once, 8 bytes per
// element per plane (the status words are 128 bytes a partition): at
// n = 2^28, 0.641 ms per plane at the H100 SXM's 3.35 TB/s; the digit-plane
// form also reads the digit plane once, 4 bytes per element.

#include <cuda_runtime.h>

#include "radix_common.cuh"

namespace {

using gst::digit_of;
using gst::Planes;

// the partition: kThreads threads x kItems items (GST_BINNING_* may
// override them at build time, as the probe does to compare shapes)
#ifndef GST_BINNING_THREADS
#define GST_BINNING_THREADS 256
#endif
#ifndef GST_BINNING_ITEMS
#define GST_BINNING_ITEMS 16
#endif
constexpr int kThreads = GST_BINNING_THREADS;
constexpr int kItems = GST_BINNING_ITEMS;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpSpan = 32 * kItems;
constexpr int kPart = kThreads * kItems;
constexpr int kDigits = 16;
// the lookback warp's words a lane a step: 2 * kLook predecessors a step
constexpr int kLook = 4;
constexpr unsigned kAll = 0xffffffffu;
static_assert(kThreads % 32 == 0 && kWarps >= 1 && kWarps <= 32,
              "block size");
static_assert(kPart % 4 == 0 && kPart <= 65536, "16-bit slot sources");

// Dynamic shared memory of one block: the staged carrier, the riders in
// input order, and each staged slot's source element (16 bits).
template <int RIDERS>
constexpr size_t smem_bytes() {
  return (size_t)kPart * 4 + (size_t)RIDERS * kPart * 4 +
         (RIDERS ? (size_t)kPart * 2 : 0);
}

// Warp 0 of partition `part` (> 0): looks back for all 16 digits at once
// and returns, in lanes d and d + 16, digit d's count in partitions
// 0 .. part-1.  Lane l reads digit l & 15 of partitions top - (l >> 4)
// - 2 q, q < kLook, so a step covers 2 kLook predecessors for every digit
// in one round trip; a digit stops at its nearest inclusive prefix
// (partition 0 always publishes one; a partition before it reads as an
// inclusive 0).
__device__ unsigned lookback(const unsigned long long* status,
                             unsigned part, unsigned epoch) {
  const int lane = threadIdx.x & 31;
  const int dl = lane & 15;
  const int h = lane >> 4;
  constexpr int kNone = 2 * kLook;
  unsigned exclusive = 0;
  bool done = false;
  for (long long top = (long long)part - 1;; top -= 2 * kLook) {
    unsigned long long w[kLook];
#pragma unroll
    for (int q = 0; q < kLook; ++q) {
      const long long k = top - h - 2 * q;
      w[q] = !done && k >= 0
                 ? gst::load_word(status + k * kDigits + dl)
                 : gst::pack_word(gst::kEpochInclusive, epoch, 0u);
    }
#pragma unroll
    for (int q = 0; q < kLook; ++q) {   // all loads in flight, then waits
      if (!gst::word_ready(w[q], epoch)) {
        w[q] = gst::wait_word(status + (top - h - 2 * q) * kDigits + dl,
                              epoch);
      }
    }
    int stop = kNone;   // the nearest inclusive prefix, 2 q + h
#pragma unroll
    for (int q = kLook - 1; q >= 0; --q) {
      if (gst::word_inclusive(w[q])) stop = 2 * q + h;
    }
    stop = min(stop, __shfl_xor_sync(kAll, stop, 16));
    unsigned sum = 0;
#pragma unroll
    for (int q = 0; q < kLook; ++q) {
      if (2 * q + h <= stop) sum += (unsigned)w[q];
    }
    sum += __shfl_xor_sync(kAll, sum, 16);
    if (!done) {
      exclusive += sum;
      done = stop < kNone;
    }
    if (__all_sync(kAll, done)) break;
  }
  return exclusive;
}

template <int NOPS, bool DIGITS>
__global__ void __launch_bounds__(kThreads)
binning(Planes planes, const int* __restrict__ digits,
        const int* __restrict__ cursors_in, int* __restrict__ cursors_out,
        unsigned* ticket, unsigned long long* status, unsigned epoch,
        unsigned num_parts, int n, int shift) {
  // the planes that ride: all but plane 0, or all in the digit-plane form
  constexpr int kRiders = DIGITS ? NOPS : NOPS - 1;
  constexpr int kFirstRider = DIGITS ? 0 : 1;
  extern __shared__ int4 smem4[];
  int* buf = reinterpret_cast<int*>(smem4);
  int* rid = buf + kPart;                    // kRiders x kPart
  unsigned short* src_of =
      reinterpret_cast<unsigned short*>(rid + kRiders * kPart);
  __shared__ unsigned warp_base[kWarps][kDigits];
  __shared__ int s_start[kDigits];
  __shared__ int s_adj[kDigits];
  __shared__ unsigned s_part;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid == 0) {
    const unsigned t = atomicAdd(ticket, 1u);
    if (t == num_parts - 1) *ticket = 0u;   // every ticket is drawn
    s_part = t;
  }
  __syncthreads();
  const unsigned part = s_part;
  const int base = (int)part * kPart;
  const int left = n - base;                // > 0, a multiple of 128
  const bool whole = left >= kPart;
  const int count_here = whole ? kPart : left;
  const int first = warp * kWarpSpan + lane;   // item i: first + 32 i

  // 2. the riders, in input order, into shared memory with no registers
#pragma unroll
  for (int q = 0; q < kRiders; ++q) {
    const int* src = planes.in[kFirstRider + q] + base;
    for (int c = tid * 4; c < count_here; c += kThreads * 4) {
      gst::cp_async16(rid + q * kPart + c, src + c);
    }
  }

  // 3. the digit carrier, once, warp-striped, into registers
  const int* carrier = (DIGITS ? digits : planes.in[0]) + base;
  int v[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int e = first + 32 * i;
    v[i] = whole || e < left ? __ldg(carrier + e) : 0;
  }

  // 4. the warp multisplit; `count` is the warp's count so far of digit
  // lane & 15, `pos` the rank of each item among its warp's equal digits
  int pos[kItems];
  unsigned count = 0;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned d = DIGITS ? (unsigned)v[i] : digit_of(v[i], shift);
    // a ragged partition's invalid items are a suffix of the lanes: they
    // never sit below a valid lane, so only the counts mask them
    const unsigned valid =
        whole ? kAll : __ballot_sync(kAll, first + 32 * i < left);
    unsigned same = kAll;   // lanes whose digit is d
    unsigned mine = valid;  // lanes whose digit is lane & 15
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const unsigned bit = __ballot_sync(kAll, (d >> b) & 1u);
      same &= (d >> b) & 1u ? bit : ~bit;
      mine &= (lane >> b) & 1 ? bit : ~bit;
    }
    pos[i] = (int)(__shfl_sync(kAll, count, (int)d) + __popc(same & below));
    count += __popc(mine);
  }
  if (lane < kDigits) warp_base[warp][lane] = count;
  __syncthreads();

  // 5. each warp's offset within a digit, the partition's counts and
  // digit starts; the counts published at once
  unsigned total = 0;   // lanes d and d + 16 of warp 0: digit d's count
  const int dl = lane & 15;
  if (warp == 0) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned c = warp_base[w][dl];
      __syncwarp();
      if (lane < kDigits) warp_base[w][dl] = total;
      total += c;
    }
    if (lane < kDigits) {
      atomicExch(status + (size_t)part * kDigits + lane,
                 gst::pack_word(part == 0 ? gst::kEpochInclusive
                                          : gst::kEpochAggregate,
                                epoch, total));
    }
    unsigned incl = total;
#pragma unroll
    for (int o = 1; o < kDigits; o <<= 1) {
      const unsigned y = __shfl_up_sync(kAll, incl, o);
      if (dl >= o) incl += y;
    }
    if (lane < kDigits) s_start[lane] = (int)(incl - total);
  }
  __syncthreads();

  // 6. every warp stages its carrier in digit order (and where riders
  // follow, each slot's source element); then warp 0 looks back
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int e = first + 32 * i;
    if (whole || e < left) {
      const unsigned d = DIGITS ? (unsigned)v[i] : digit_of(v[i], shift);
      const int slot = pos[i] + s_start[d] + (int)warp_base[warp][d];
      buf[slot] = v[i];
      if (kRiders) src_of[slot] = (unsigned short)e;
    }
  }
  if (warp == 0) {
    const unsigned exclusive = part ? lookback(status, part, epoch) : 0u;
    if (part && lane < kDigits) {
      atomicExch(status + (size_t)part * kDigits + lane,
                 gst::pack_word(gst::kEpochInclusive, epoch,
                                exclusive + total));
    }
    if (lane < kDigits) {
      const int cur = cursors_in[lane] + (int)exclusive;
      s_adj[lane] = cur - s_start[lane];
      if (part == num_parts - 1) cursors_out[lane] = cur + (int)total;
    }
  }
  if (kRiders) gst::cp_async_wait();
  __syncthreads();

  // 7. the partition out in digit order: consecutive threads on
  // consecutive addresses within each digit's run
#pragma unroll 4
  for (int k = tid; k < count_here; k += kThreads) {
    const int x = buf[k];
    const int dst = s_adj[DIGITS ? x : (int)digit_of(x, shift)] + k;
    if (!DIGITS) planes.out[0][dst] = x;
    if (kRiders) {
      const int e = src_of[k];
#pragma unroll
      for (int q = 0; q < kRiders; ++q) {
        planes.out[kFirstRider + q][dst] = rid[q * kPart + e];
      }
    }
  }
}

template <int NOPS, bool DIGITS>
int launch_one(const Planes& planes, const int* digits, const int* cin,
               int* cout, unsigned* ticket, unsigned long long* status,
               unsigned epoch, unsigned parts, int n, int shift,
               cudaStream_t s) {
  constexpr size_t smem = smem_bytes<DIGITS ? NOPS : NOPS - 1>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        binning<NOPS, DIGITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  binning<NOPS, DIGITS><<<parts, kThreads, smem, s>>>(
      planes, digits, cin, cout, ticket, status, epoch, parts, n, shift);
  return (int)cudaGetLastError();
}

template <int NOPS>
int launch(const Planes& planes, const int* digits, const int* cin,
           int* cout, unsigned* ticket, unsigned long long* status,
           unsigned epoch, unsigned parts, int n, int shift,
           cudaStream_t s) {
  return digits ? launch_one<NOPS, true>(planes, digits, cin, cout, ticket,
                                         status, epoch, parts, n, shift, s)
                : launch_one<NOPS, false>(planes, digits, cin, cout, ticket,
                                          status, epoch, parts, n, shift, s);
}

}  // namespace

// Elements a partition (the status words the caller provides: 16 a
// partition).
extern "C" int gst_binning_partition() { return kPart; }

// One launch on `stream` over n elements (a multiple of 4; the planes
// 16-byte aligned).  `scratch` is the caller's zeroed buffer for this
// device and stream: a ticket word (8 bytes) then 64-bit status words,
// scratch_words >= 16 * ceil(n / kPart) of them; `epoch`, in [1, 2^30),
// must differ from every epoch the buffer has seen since it was last
// zeroed.  Planes past num_ops are ignored; `digits` is null unless the
// digits come from a plane.  Returns the first CUDA error (0 on success).
extern "C" int gst_binning(const void* in0, const void* in1, const void* in2,
                           void* out0, void* out1, void* out2,
                           const void* digits, const void* cursors_in,
                           void* cursors_out, void* scratch,
                           long long scratch_words, unsigned epoch,
                           int num_ops, long long n, int shift,
                           void* stream) {
  const long long parts = (n + kPart - 1) / kPart;
  if (num_ops < 1 || num_ops > gst::kMaxPlanes || n <= 0 || n % 4 ||
      n >= (1ll << 30) || shift < 0 || shift > 28 ||
      scratch_words < parts * kDigits || epoch == 0 ||
      epoch > gst::kEpochMask) {
    return (int)cudaErrorInvalidValue;
  }
  Planes planes = {{static_cast<const int*>(in0),
                    static_cast<const int*>(in1),
                    static_cast<const int*>(in2)},
                   {static_cast<int*>(out0), static_cast<int*>(out1),
                    static_cast<int*>(out2)}};
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  unsigned* ticket = reinterpret_cast<unsigned*>(words);
  const int* cin = static_cast<const int*>(cursors_in);
  int* cout = static_cast<int*>(cursors_out);
  const int* dg = static_cast<const int*>(digits);
  cudaStream_t s = (cudaStream_t)stream;
  switch (num_ops) {
    case 1:
      return launch<1>(planes, dg, cin, cout, ticket, words + 1, epoch,
                       (unsigned)parts, (int)n, shift, s);
    case 2:
      return launch<2>(planes, dg, cin, cout, ticket, words + 1, epoch,
                       (unsigned)parts, (int)n, shift, s);
    default:
      return launch<3>(planes, dg, cin, cout, ticket, words + 1, epoch,
                       (unsigned)parts, (int)n, shift, s);
  }
}
