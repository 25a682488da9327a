// Stable stream compaction and its inverse, expansion, of 1-4 int32 planes
// moved by one byte mask, for Hopper (sm_90a).
//
// Replaces gpusorting_tpu/ops/stitch.py:_compact_kernel (built by
// `_build_compact`, behind `compact` and `compact_ops`) and
// gpusorting_tpu/ops/stitch.py:_expand_kernel (built by `_build_expand`,
// behind `expand_ops`).  Contracts, for a mask of n bytes (nonzero = set)
// and rank(i) = #{ set positions before i }:
//   compact: out[p][rank(i)] = in[p][i] for every set i, and *count = the
//            number set; out[p][count ..] is left as it was;
//   expand:  out[p][i] = (rank(i) < len[p] ? src[p][rank(i)] : 0) for
//            every set i, and 0 elsewhere (a stream shorter than the set
//            count reads as zero-padded, as the JAX wrapper pads it).
//
// The TPU kernels pack each 128-lane row, place the rows with banded
// one-hot int8 matmuls on the MXU and stream whole rows; compact carries a
// write cursor and a partial row, expand a read cursor, from one grid step
// to the next, which holds only because a TPU grid runs in order.  The
// matmuls, the carry row and the interpret-mode `static_writes` branch are
// TPU devices, not part of the contract.  A CUDA grid has no order, so both
// kernels here are "rank every set element by its global exclusive prefix,
// then move it", in one launch each:
//   - a block takes its tile of kTile elements from an atomic counter;
//     thread j holds elements j + k * kThreads (k < kItems), so every load
//     and store of a warp is one contiguous run;
//   - it ranks the tile's mask with a warp ballot and __popc per item and
//     one block scan of the (item, warp) counts;
//   - it carries the tile's base across tiles with the chained scan with
//     decoupled lookback of binning.cu (`gst::chained_exclusive`): a 2-bit
//     flag over a 30-bit count per tile, so n < 2^30;
//   - compact gathers the tile's selected elements into shared memory in
//     rank order and writes them out as one contiguous run at the base;
//     expand reads the tile's run of the stream, src[base .. base + count),
//     into shared memory and writes every element of the tile from there.
//
// Bound: memory.  compact reads the mask and every plane once and writes
// count elements per plane: n (1 + 4 P) + 4 P count bytes; expand reads the
// mask and count elements per stream and writes every plane once:
// n + 4 P count + 4 P n bytes.  At n = 2^28, P = 1, half set, that is
// 1.88 GB, 0.56 ms at the H100 SXM's 3.35 TB/s, for either.  A warp's load
// of a plane is predicated per element but still fetches whole sectors, so
// compact reads every plane in full at any density.

#include <cuda_runtime.h>

#include "radix_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;   // 4096 elements a tile
constexpr int kMaxPlanes = 4;

struct StitchPlanes {
  const int* in[kMaxPlanes];
  int* out[kMaxPlanes];
  long long in_len[kMaxPlanes];   // expand: each stream's length
};

// Ranks the set elements of the tile at tile_base.  ballot[k] is the
// warp's ballot of item k; base[k * kWarps + warp] ends as the tile-local
// rank of the first set element of that (item, warp) run, the runs taken in
// element order.  Returns the tile's set count.  Every thread must call it;
// it ends with a barrier.
__device__ unsigned rank_tile(const unsigned char* __restrict__ mask,
                              long long n, long long tile_base,
                              unsigned (&ballot)[kItems], unsigned* base) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = tile_base + (long long)k * kThreads + tid;
    const bool set = i < n && mask[i] != 0;
    ballot[k] = __ballot_sync(0xffffffffu, set);
    if (lane == 0) base[k * kWarps + warp] = __popc(ballot[k]);
  }
  __syncthreads();
  static_assert(kItems * kWarps <= kThreads, "one run count a thread");
  const unsigned c = tid < kItems * kWarps ? base[tid] : 0u;
  unsigned total;
  const unsigned ex = gst::block_exclusive<kThreads>(c, &total);
  if (tid < kItems * kWarps) base[tid] = ex;
  __syncthreads();
  return total;
}

// The tile's global base (the set count of all earlier tiles), through the
// lookback; thread 0 walks, every thread gets it.  The block that holds the
// last tile writes the whole count to *count_out when it is not null.
__device__ long long tile_base_rank(unsigned* status, int t, int num_tiles,
                                    unsigned total, int* count_out) {
  __shared__ unsigned prefix;
  if (threadIdx.x == 0) {
    prefix = gst::chained_exclusive(status, t, 1, total);
    if (count_out != nullptr && t == num_tiles - 1) {
      *count_out = (int)(prefix + total);
    }
  }
  __syncthreads();
  return (long long)prefix;
}

template <int NOPS>
__global__ void __launch_bounds__(kThreads)
compact(StitchPlanes planes, const unsigned char* __restrict__ mask,
        long long n, int* count_out, unsigned* status, unsigned* next_tile,
        int num_tiles) {
  __shared__ int tile_id;
  __shared__ unsigned base[kItems * kWarps];
  __shared__ int vals[kTile];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const unsigned below = (1u << (tid & 31)) - 1u;
  if (tid == 0) tile_id = (int)atomicAdd(next_tile, 1u);
  __syncthreads();
  const int t = tile_id;
  const long long tile_base = (long long)t * kTile;
  unsigned ballot[kItems];
  const unsigned total = rank_tile(mask, n, tile_base, ballot, base);
  const long long dst = tile_base_rank(status, t, num_tiles, total, count_out);
#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
    const int* in = planes.in[q] + tile_base;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if ((ballot[k] >> (tid & 31)) & 1u) {
        vals[base[k * kWarps + warp] + __popc(ballot[k] & below)] =
            __ldg(in + k * kThreads + tid);
      }
    }
    __syncthreads();
    int* out = planes.out[q] + dst;
    for (int j = tid; j < (int)total; j += kThreads) out[j] = vals[j];
    __syncthreads();
  }
}

template <int NOPS>
__global__ void __launch_bounds__(kThreads)
expand(StitchPlanes planes, const unsigned char* __restrict__ mask,
       long long n, unsigned* status, unsigned* next_tile, int num_tiles) {
  __shared__ int tile_id;
  __shared__ unsigned base[kItems * kWarps];
  __shared__ int vals[kTile];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const unsigned below = (1u << (tid & 31)) - 1u;
  if (tid == 0) tile_id = (int)atomicAdd(next_tile, 1u);
  __syncthreads();
  const int t = tile_id;
  const long long tile_base = (long long)t * kTile;
  unsigned ballot[kItems];
  const unsigned total = rank_tile(mask, n, tile_base, ballot, base);
  const long long src0 = tile_base_rank(status, t, num_tiles, total, nullptr);
#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
    const int* src = planes.in[q];
    const long long len = planes.in_len[q];
    for (int j = tid; j < (int)total; j += kThreads) {
      const long long r = src0 + j;
      vals[j] = r < len ? __ldg(src + r) : 0;
    }
    __syncthreads();
    int* out = planes.out[q];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long i = tile_base + (long long)k * kThreads + tid;
      if (i < n) {
        out[i] = ((ballot[k] >> (tid & 31)) & 1u)
                     ? vals[base[k * kWarps + warp] +
                            __popc(ballot[k] & below)]
                     : 0;
      }
    }
    __syncthreads();
  }
}

// Checks the shape arguments and zeroes the status words and the tile
// counter (num_tiles + 1 uint32 of `scratch`).
int prepare(long long n, int num_ops, int num_tiles, void* scratch,
            cudaStream_t s) {
  if (n <= 0 || n >= (1ll << 30) || num_ops < 1 || num_ops > kMaxPlanes ||
      (long long)num_tiles != (n + kTile - 1) / kTile) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaMemsetAsync(scratch, 0,
                              ((size_t)num_tiles + 1) * sizeof(unsigned), s);
}

}  // namespace

// compact: in_p/out_p for p < num_ops (the rest ignored), `mask` n bytes,
// `count_out` one int32, `scratch` num_tiles + 1 uint32 with num_tiles =
// ceil(n / 4096).  Launches on `stream`; returns the first CUDA error (0 on
// success).
extern "C" int gst_compact(const void* in0, const void* in1, const void* in2,
                           const void* in3, void* out0, void* out1,
                           void* out2, void* out3, const void* mask,
                           long long n, void* count_out, void* scratch,
                           int num_ops, int num_tiles, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = prepare(n, num_ops, num_tiles, scratch, s);
  if (rc != 0) return rc;
  StitchPlanes planes = {
      {static_cast<const int*>(in0), static_cast<const int*>(in1),
       static_cast<const int*>(in2), static_cast<const int*>(in3)},
      {static_cast<int*>(out0), static_cast<int*>(out1),
       static_cast<int*>(out2), static_cast<int*>(out3)},
      {0, 0, 0, 0}};
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  int* cnt = static_cast<int*>(count_out);
  unsigned* status = static_cast<unsigned*>(scratch);
  unsigned* next_tile = status + num_tiles;
  switch (num_ops) {
    case 1:
      compact<1><<<num_tiles, kThreads, 0, s>>>(planes, m, n, cnt, status,
                                                next_tile, num_tiles);
      break;
    case 2:
      compact<2><<<num_tiles, kThreads, 0, s>>>(planes, m, n, cnt, status,
                                                next_tile, num_tiles);
      break;
    case 3:
      compact<3><<<num_tiles, kThreads, 0, s>>>(planes, m, n, cnt, status,
                                                next_tile, num_tiles);
      break;
    default:
      compact<4><<<num_tiles, kThreads, 0, s>>>(planes, m, n, cnt, status,
                                                next_tile, num_tiles);
      break;
  }
  return (int)cudaGetLastError();
}

// expand: src_p of len_p elements and out_p of n for p < num_ops, `mask` n
// bytes, `scratch` as for gst_compact.  Launches on `stream`; returns the
// first CUDA error (0 on success).
extern "C" int gst_expand(const void* src0, const void* src1,
                          const void* src2, const void* src3, long long len0,
                          long long len1, long long len2, long long len3,
                          void* out0, void* out1, void* out2, void* out3,
                          const void* mask, long long n, void* scratch,
                          int num_ops, int num_tiles, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rc = prepare(n, num_ops, num_tiles, scratch, s);
  if (rc != 0) return rc;
  StitchPlanes planes = {
      {static_cast<const int*>(src0), static_cast<const int*>(src1),
       static_cast<const int*>(src2), static_cast<const int*>(src3)},
      {static_cast<int*>(out0), static_cast<int*>(out1),
       static_cast<int*>(out2), static_cast<int*>(out3)},
      {len0, len1, len2, len3}};
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  unsigned* status = static_cast<unsigned*>(scratch);
  unsigned* next_tile = status + num_tiles;
  switch (num_ops) {
    case 1:
      expand<1><<<num_tiles, kThreads, 0, s>>>(planes, m, n, status,
                                               next_tile, num_tiles);
      break;
    case 2:
      expand<2><<<num_tiles, kThreads, 0, s>>>(planes, m, n, status,
                                               next_tile, num_tiles);
      break;
    case 3:
      expand<3><<<num_tiles, kThreads, 0, s>>>(planes, m, n, status,
                                               next_tile, num_tiles);
      break;
    default:
      expand<4><<<num_tiles, kThreads, 0, s>>>(planes, m, n, status,
                                               next_tile, num_tiles);
      break;
  }
  return (int)cudaGetLastError();
}
