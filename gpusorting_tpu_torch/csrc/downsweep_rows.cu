// Row-writing form of the reduce-then-scan Downsweep for Hopper (sm_90a).
//
// Replaces gpusorting_tpu/ops/rts.py:_downsweep_kernel in its parallel=True
// ("Megacore") form, which `run_downsweep_chunks` runs before
// _edge_fixup_kernel.  Contract, on 1-3 int32 planes of (rows, 128) (plane
// 0 holds the biased key codes, the others ride) cut into T tiles of
// tile_rows rows: tile t's elements of digit d (at `shift`), in input
// order, fill the output slots [cur, cur + c) with cur = table[d * T + t]
// and c = counts[t * 16 + d].  Call that slot range the (t, d) range.
//   - Every output row whose 128 slots lie in one range is stored whole;
//     every other output row is stored as zeros.  Each output row is
//     stored once, so the outputs need no clearing beforehand.
//   - A range that starts mid-row stores its part of its first row to
//     side row ((t * NOPS + q) * 16 + d) * 2 + 0 of plane q, the slots of
//     other ranges zero; a range that ends mid-row, in a row after its
//     first or in its first row when that starts on a row boundary,
//     stores its part of its last row to side row ... * 2 + 1.  Other side
//     rows are left unwritten.  (JAX's lo_cond / hi_cond, rts.py:172-181.)
// csrc/edge_fixup.cu then ORs the side rows into the output rows that
// ops/rts.py:edge_rows names.  Several ranges share a row at their edges,
// so no block may store such a row's data itself: the side rows are what
// lets blocks run in any order and still give one answer.  The zeros of
// such a row come from the one range that covers its slot 0, which always
// has its high partial there (it starts at or before the row and ends
// inside it); the ranges cover every slot (ops/rts.py:pad_tiles pads the
// last tile), so every output row has exactly one writer.
//
// Bound: memory.  The pass's own bound is the permutation's, each plane
// read once and written once, 8 bytes per element per plane (0.64 ms per
// plane at n = 2^28 at the H100 SXM's 3.35 TB/s); this form also writes
// each partial row to the side buffer, and the fixup reads it back (see
// PERF.md).
//
// Design: one block per tile, each plane staged in shared memory in turn.
//   1. The 16 ranges' stage offsets: digit d's run starts at the first
//      slot at or after the previous run's end that is congruent to its
//      global cursor mod 128, so at most 127 slots of padding a digit and
//      a stage of (tile_rows + kPadRows) * 128 ints.  Stage row srow[d] + k
//      then holds output row (cur >> 7) + k, lane for lane.
//   2. Plane 0 is read once, warp-striped in chunks of kChunk (item i of
//      lane l is element 32 i + l of the warp's span, so ranking item by
//      item, lane by lane, follows the input order), and ranked by a warp
//      multisplit: four __ballot_sync of the digit's bits give the lanes
//      that share it, the __popc of those below the lane its rank; each
//      lane keeps the warp's running count of digit lane & 15.  One warp
//      scans the 16 digits x warps counts into each warp's stage cursor.
//      Each key goes straight to its padded stage slot, and where riders
//      follow, the slot is kept as 16 bits a source element.
//   3. Each output row of the tile's ranges is one job of a numbered list
//      (first_row[d] numbers digit d's rows; a 4-step search finds a
//      job's digit).  A warp takes a job and moves one 512-byte stage row:
//      one aligned 16-byte shared load and one 16-byte store a lane, with
//      no bank conflicts; a partial masks the lanes of other ranges.
//   4. Each rider plane is read in input order with 16-byte loads and
//      placed by the kept slots into the same stage, after a barrier, and
//      its rows go out as in 3.
// Shared memory a block: the stage, 24 KB at 32 rows and 72 KB at 128
// rows, and with riders 2 bytes an element for the slots (8 KB and
// 32 KB), whatever the number of planes.  The registers are sized for 4
// blocks an SM (64 a thread): at 32 rows 4 blocks an SM on 1-3 planes,
// at 128 rows 3 on 1 plane and 2 on 2-3 (shared memory bounds them); with
// registers for 1 block (91 a thread) 2 or 3 an SM ran 1.3-1.4x slower
// on 1 plane (probes/torch_row_form_probe.py --shapes).

#include <cuda_runtime.h>

#include "radix_common.cuh"

namespace {

using gst::digit_of;
using gst::Planes;

// the ranking chunk's items a thread and the blocks an SM the registers
// are sized for (GST_ROWS_* may override them at build time, as the probe
// does to compare shapes)
#ifndef GST_ROWS_ITEMS
#define GST_ROWS_ITEMS 16
#endif
#ifndef GST_ROWS_MIN_BLOCKS
#define GST_ROWS_MIN_BLOCKS 4
#endif
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = GST_ROWS_ITEMS;
constexpr int kWarpSpan = 32 * kItems;
constexpr int kChunk = kThreads * kItems;
constexpr int kDigits = 16;
constexpr int kLanes = 128;
// stage rows past the tile's: 16 digits' padding of at most 127 slots
constexpr int kPadRows = 16;
constexpr unsigned kAll = 0xffffffffu;

size_t smem_bytes(int num_ops, int tile_rows) {
  const size_t stage = (size_t)(tile_rows + kPadRows) * kLanes * 4;
  return stage + (num_ops > 1 ? (size_t)tile_rows * kLanes * 2 : 0);
}

template <int NOPS>
__global__ void __launch_bounds__(kThreads, GST_ROWS_MIN_BLOCKS)
downsweep_rows(Planes planes, int* __restrict__ side,
               const int* __restrict__ table, const int* __restrict__ counts,
               int num_tiles, int tile_rows, int shift) {
  extern __shared__ int4 smem4[];
  int* stage = reinterpret_cast<int*>(smem4);
  const int4* stage4 = smem4;
  unsigned short* slot_of = reinterpret_cast<unsigned short*>(
      stage + (tile_rows + kPadRows) * kLanes);
  __shared__ int cursor[kDigits];          // next stage slot of each run
  __shared__ int cur[kDigits];             // global start of each range
  __shared__ int hi_of[kDigits];           // global end of each range
  __shared__ int srow[kDigits];            // stage row of its first row
  __shared__ int first_row[kDigits + 1];   // numbering of the block's rows
  __shared__ int warp_base[kWarps][kDigits];

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int dl = lane & 15;
  const int tile_elems = tile_rows * kLanes;
  const long long base = (long long)t * tile_elems;

  // 1. the ranges, their rows and their padded stage offsets
  if (warp == 0) {
    const int c = counts[(long long)t * kDigits + dl];
    const int g = table[(long long)dl * num_tiles + t];
    const int nrows = c > 0 ? ((g + c - 1) >> 7) - (g >> 7) + 1 : 0;
    int incl = nrows;
#pragma unroll
    for (int o = 1; o < kDigits; o <<= 1) {
      const int y = __shfl_up_sync(kAll, incl, o, kDigits);
      if (dl >= o) incl += y;
    }
    int start = 0;   // lane d: digit d's stage offset
    int p = 0;
#pragma unroll
    for (int d = 0; d < kDigits; ++d) {
      const int cd = __shfl_sync(kAll, c, d);
      const int s = p + ((__shfl_sync(kAll, g, d) - p) & (kLanes - 1));
      if (dl == d) start = s;
      if (cd > 0) p = s + cd;
    }
    if (lane < kDigits) {
      cur[lane] = g;
      hi_of[lane] = g + c;
      cursor[lane] = start;
      srow[lane] = start >> 7;
      first_row[lane] = incl - nrows;
      if (lane == kDigits - 1) first_row[kDigits] = incl;
    }
  }
  __syncthreads();

  // 2. plane 0 ranked by warp multisplit, chunk by chunk, into the stage
  const unsigned below = (1u << lane) - 1u;
  const int* keys = planes.in[0] + base;
  for (int c0 = 0; c0 < tile_elems; c0 += kChunk) {
    // a multiple of 128, so a warp's item is wholly in or wholly out
    const int left = tile_elems - c0;
    const int first = warp * kWarpSpan + lane;
    int v[kItems];
    int pos[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = first + 32 * i;
      v[i] = e < left ? __ldg(keys + c0 + e) : 0;
    }
    unsigned count = 0;   // the warp's count so far of digit lane & 15
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (warp * kWarpSpan + 32 * i < left) {
        const unsigned d = digit_of(v[i], shift);
        unsigned same = kAll;   // lanes whose digit is d
        unsigned mine = kAll;   // lanes whose digit is lane & 15
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const unsigned bit = __ballot_sync(kAll, (d >> b) & 1u);
          same &= (d >> b) & 1u ? bit : ~bit;
          mine &= (lane >> b) & 1 ? bit : ~bit;
        }
        pos[i] = (int)(__shfl_sync(kAll, count, (int)d) +
                       __popc(same & below));
        count += __popc(mine);
      }
    }
    __syncwarp();   // the warp's lanes are done reading its warp_base row
    if (lane < kDigits) warp_base[warp][lane] = (int)count;
    __syncthreads();
    // each warp's stage cursor of each digit; the runs' cursors advanced
    if (warp == 0) {
      int run = cursor[dl];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int cw = warp_base[w][dl];
        __syncwarp();
        if (lane < kDigits) warp_base[w][dl] = run;
        run += cw;
      }
      if (lane < kDigits) cursor[lane] = run;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int e = first + 32 * i;
      if (e < left) {
        const int slot = warp_base[warp][digit_of(v[i], shift)] + pos[i];
        stage[slot] = v[i];
        if (NOPS > 1) slot_of[c0 + e] = (unsigned short)slot;
      }
    }
  }
  __syncthreads();

  const int jobs = first_row[kDigits];
#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
    if (q > 0) {
      // 4. rider q placed through the kept slots
      __syncthreads();   // the previous plane's rows are out
      const int* src = planes.in[q] + base;
#pragma unroll 4
      for (int e = tid * 4; e < tile_elems; e += kThreads * 4) {
        const int4 x = __ldg(reinterpret_cast<const int4*>(src + e));
        const uint2 s = *reinterpret_cast<const uint2*>(slot_of + e);
        stage[s.x & 0xffffu] = x.x;
        stage[s.x >> 16] = x.y;
        stage[s.y & 0xffffu] = x.z;
        stage[s.y >> 16] = x.w;
      }
      __syncthreads();
    }
    // 3. the plane's rows: whole rows to the output, partials to their
    // side rows, and zeros to the rows whose slot 0 a high partial holds
    int* out = planes.out[q];
    for (int j = warp; j < jobs; j += kWarps) {
      int d = 0;
#pragma unroll
      for (int s = kDigits / 2; s > 0; s >>= 1) {
        if (first_row[d + s] <= j) d += s;
      }
      const int k = j - first_row[d];
      const int g = cur[d];
      const int hi = hi_of[d];
      const int row = (g >> 7) + k;
      int4 v = stage4[(srow[d] + k) * (kLanes / 4) + lane];
      int4* dst = reinterpret_cast<int4*>(out + (long long)row * kLanes) +
                  lane;
      const bool lo = k == 0 && (g & (kLanes - 1)) != 0;
      const bool hi_part = !lo && row == (hi - 1) >> 7 &&
                           (hi & (kLanes - 1)) != 0;
      if (!lo && !hi_part) {
        *dst = v;
        continue;
      }
      const int p = row * kLanes + lane * 4;
      v.x = p >= g && p < hi ? v.x : 0;
      v.y = p + 1 >= g && p + 1 < hi ? v.y : 0;
      v.z = p + 2 >= g && p + 2 < hi ? v.z : 0;
      v.w = p + 3 >= g && p + 3 < hi ? v.w : 0;
      const long long srow_out =
          (((long long)t * NOPS + q) * kDigits + d) * 2 + (lo ? 0 : 1);
      reinterpret_cast<int4*>(side + srow_out * kLanes)[lane] = v;
      if (hi_part) *dst = make_int4(0, 0, 0, 0);
    }
  }
}

template <int NOPS>
int launch(const Planes& planes, int* side, const int* table,
           const int* counts, int num_tiles, int tile_rows, int shift,
           cudaStream_t s) {
  const size_t smem = smem_bytes(NOPS, tile_rows);
  const cudaError_t rc = cudaFuncSetAttribute(
      downsweep_rows<NOPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  downsweep_rows<NOPS><<<num_tiles, kThreads, smem, s>>>(
      planes, side, table, counts, num_tiles, tile_rows, shift);
  return (int)cudaGetLastError();
}

}  // namespace

// The dynamic shared memory a block of num_ops planes and tile_rows rows
// takes (ops/rts.py:rows_stage_bytes mirrors it) and the blocks an SM then
// holds; returns a CUDA error code (0 on success).
extern "C" int gst_downsweep_rows_occupancy(int num_ops, int tile_rows,
                                            long long* smem, int* blocks) {
  if (num_ops < 1 || num_ops > gst::kMaxPlanes || tile_rows <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  *smem = (long long)smem_bytes(num_ops, tile_rows);
  const void* fn = num_ops == 1   ? (const void*)downsweep_rows<1>
                   : num_ops == 2 ? (const void*)downsweep_rows<2>
                                  : (const void*)downsweep_rows<3>;
  cudaError_t rc = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (rc != cudaSuccess) return (int)rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads,
                                                     (size_t)*smem);
  return (int)rc;
}

// Launches on `stream`; returns a CUDA error code (0 on success).  Planes
// past num_ops are ignored.  The outputs need no clearing.  With riders
// the stage's slots must fit 16 bits: tile_rows + 16 <= 512.
extern "C" int gst_downsweep_rows(const void* in0, const void* in1,
                                  const void* in2, void* out0, void* out1,
                                  void* out2, void* side, const void* table,
                                  const void* counts, int num_ops,
                                  int num_tiles, int tile_rows, int shift,
                                  void* stream) {
  if (num_ops < 1 || num_ops > gst::kMaxPlanes || num_tiles <= 0 ||
      tile_rows <= 0 || shift < 0 || shift > 28 ||
      (num_ops > 1 && (tile_rows + kPadRows) * kLanes > 65536)) {
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
