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
// kernels here rank every set element by its global exclusive prefix, a
// chained scan with decoupled lookback over tiles of kTile elements, and
// then move it, in one launch each.
//
// Bound: memory.  compact reads the mask and every plane once and writes
// count elements per plane: n (1 + 4 P) + 4 P count bytes; expand reads the
// mask and count elements per stream and writes every plane once:
// n + 4 P count + 4 P n bytes.  At n = 2^28, P = 1, half set, that is
// 1.88 GB, 0.56 ms at the H100 SXM's 3.35 TB/s, for either.  So a tile's
// bytes take a few microseconds, and what bounds a tile is its chain of
// latencies: the ticket, the mask's load, the lookback's round trips, the
// planes' loads.  The design keeps that chain short and overlaps it:
//   1. a block draws its tile from an atomic ticket in the scratch that
//      exclusive_scan.cu and binning.cu share (`kernels._scan_scratch`):
//      64-bit status words with a per-call epoch, so no launch clears
//      anything, and every tile waited on belongs to a running block;
//   2. thread j ranks the kItems consecutive elements from j * kItems: it
//      reads their mask bytes as 16-byte loads (a mask at any byte offset
//      is read on the aligned-down address and shifted, the bytes outside
//      [0, n) read per byte, so nothing outside the mask is touched) into
//      a bit per element; a __popc, a warp scan and a scan of the warps'
//      counts give each element its rank in input order;
//   3. compact only: before the lookback, every plane's tile is copied
//      into shared memory in input order by 16-byte cp.async (a plane at
//      any 4-byte offset by its aligned-down chunks, the edge chunks by
//      4-byte copies); a 16-element run whose mask is all unset is not
//      copied, so a sparse mask reads little of the planes;
//   4. one warp publishes the tile's count and looks back over 32
//      predecessors a step in one round trip (`gst::warp_lookback`,
//      radix_common.cuh, shared with exclusive_scan.cu);
//   5. compact places each selected element's source index at its rank in
//      shared memory while the lookback runs, then writes all planes as
//      one contiguous run at the tile's base between one pair of barriers;
//      expand copies each stream's run src[base .. base + count) into
//      shared memory by cp.async (edges by 4-byte copies, zero past
//      len[p]) and writes every element of the tile, four consecutive
//      elements a thread with one 16-byte store (the outputs are the
//      wrapper's own, 16-byte aligned).
// The block that holds the last tile writes *count.

#include <cuda_runtime.h>

#include <cstdint>

#include "radix_common.cuh"

namespace {

// the tile: kThreads threads x kItems elements (GST_STITCH_* may override
// them at build time, as probes/torch_stitch_probe.py does to compare
// shapes; 128 x 16 beat 256 x 16 on compact, most on 3 planes, where a
// 57 KB staging buffer leaves 256-thread blocks 3 a SM)
#ifndef GST_STITCH_THREADS
#define GST_STITCH_THREADS 128
#endif
#ifndef GST_STITCH_ITEMS
#define GST_STITCH_ITEMS 16
#endif
constexpr int kThreads = GST_STITCH_THREADS;
constexpr int kItems = GST_STITCH_ITEMS;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kItems;
constexpr int kQuads = kItems / 4;     // 4-element chunks a thread moves
constexpr int kWarpChunks = 8 * kItems;   // a warp's span in chunks
constexpr int kSlots = kTile + 4;      // a staged plane: the tile + a shift
constexpr int kMaxPlanes = 4;
constexpr unsigned kAll = 0xffffffffu;
static_assert(kThreads % 32 == 0 && kWarps >= 1 && kWarps <= 32,
              "block size");
static_assert(kItems == 16 || kItems == 32, "16 or 32 elements a thread");
static_assert(kTile <= 65536, "16-bit source indices");

struct StitchPlanes {
  const int* in[kMaxPlanes];
  int* out[kMaxPlanes];
  long long in_len[kMaxPlanes];   // expand: each stream's length
};

// The bits of a 32-bit word's nonzero bytes: bit b for byte b.
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// The set bits of the 16 mask bytes at the 16-byte aligned p, bit b for
// p[b]; bytes outside [lo, hi) read as unset and are not loaded.
__device__ __forceinline__ unsigned chunk_bits(const unsigned char* p,
                                               const unsigned char* lo,
                                               const unsigned char* hi) {
  if (p >= lo && p + 16 <= hi) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    return nonzero_bytes(v.x) | nonzero_bytes(v.y) << 4 |
           nonzero_bytes(v.z) << 8 | nonzero_bytes(v.w) << 12;
  }
  unsigned bits = 0;
  for (int b = 0; b < 16; ++b) {
    if (p + b >= lo && p + b < hi && __ldg(p + b) != 0) bits |= 1u << b;
  }
  return bits;
}

// The mask bits of this thread's kItems elements i0 .. i0 + kItems - 1
// (bit j for i0 + j; 0 past n), read as 16-byte chunks from the
// aligned-down address: a mask at byte offset a needs the next thread's
// first chunk too, which a shuffle brings (the warp's last lane loads it).
// Every lane of the warp must call it.
__device__ __forceinline__ unsigned thread_bits(const unsigned char* mask,
                                                long long n, long long i0) {
  const unsigned a = (unsigned)(reinterpret_cast<uintptr_t>(mask) & 15u);
  const unsigned char* p = mask + i0 - a;
  const unsigned char* end = mask + n;
  unsigned long long w = 0;
#pragma unroll
  for (int c = 0; c < kItems / 16; ++c) {
    w |= (unsigned long long)chunk_bits(p + 16 * c, mask, end) << (16 * c);
  }
  if (a != 0) {   // the same in every thread
    const unsigned last =
        (threadIdx.x & 31) == 31 ? chunk_bits(p + kItems, mask, end) : 0u;
    const unsigned next = __shfl_down_sync(kAll, (unsigned)w & 0xffffu, 1);
    w |= (unsigned long long)((threadIdx.x & 31) == 31 ? last : next)
         << kItems;
    w >>= a;
  }
  return (unsigned)(w & ((1ull << kItems) - 1ull));
}

// Draws the block's tile from the ticket; the block that draws the last
// one sets it back to 0 for the stream's next call.  Ends with a barrier.
__device__ __forceinline__ unsigned draw_tile(unsigned* ticket,
                                              unsigned num_tiles) {
  __shared__ unsigned s_tile;
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(ticket, 1u);
    if (t == num_tiles - 1) *ticket = 0u;   // every ticket is drawn
    s_tile = t;
  }
  __syncthreads();
  return s_tile;
}

// The tile's count in every thread and, in *pre, the tile-local rank of
// this thread's first element: a warp scan of the per-thread counts, then
// each warp scans the kWarps warp counts itself.  Every thread must call
// it; it holds one barrier.
__device__ __forceinline__ unsigned rank_tile(unsigned bits, unsigned* pre) {
  __shared__ unsigned s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned cnt = __popc(bits);
  const unsigned incl = gst::warp_inclusive(cnt);
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  const unsigned wc = lane < kWarps ? s_warp[lane] : 0u;
  const unsigned wi = gst::warp_inclusive(wc);
  *pre = __shfl_sync(kAll, wi - wc, warp) + incl - cnt;
  return __shfl_sync(kAll, wi, kWarps - 1);
}

// The 4-byte shift of a 4-byte aligned pointer from 16-byte alignment.
__device__ __forceinline__ int shift_of(const int* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) >> 2) & 3u);
}

// Copies the 4 elements src[g .. g + 4) to dst by cp.async: one 16-byte
// copy where all lie in [0, len) (src + g is then 16-byte aligned), else
// one 4-byte copy for each that does.
__device__ __forceinline__ void copy_chunk(int* dst, const int* src,
                                           long long g, long long len) {
  if (g >= 0 && g + 4 <= len) {
    gst::cp_async16(dst, src + g);
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (g + m >= 0 && g + m < len) gst::cp_async4(dst + m, src + g + m);
    }
  }
}

template <int NOPS>
constexpr size_t compact_smem() {
  return (size_t)NOPS * kSlots * 4 + (size_t)kTile * 2;
}

template <int NOPS>
constexpr size_t expand_smem() {
  return (size_t)NOPS * kSlots * 4;
}

template <int NOPS>
__global__ void __launch_bounds__(kThreads)
compact(StitchPlanes planes, const unsigned char* __restrict__ mask,
        long long n, int* count_out, unsigned* ticket,
        unsigned long long* status, unsigned epoch, unsigned num_tiles) {
  extern __shared__ int4 smem4[];
  // each plane's tile in input order, element e at slot e + its shift;
  // then the source element of each rank
  int* staged = reinterpret_cast<int*>(smem4);
  unsigned short* src_of =
      reinterpret_cast<unsigned short*>(staged + NOPS * kSlots);
  __shared__ unsigned s_base;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned t = draw_tile(ticket, num_tiles);
  const long long tile0 = (long long)t * kTile;
  const unsigned bits = thread_bits(mask, n, tile0 + (long long)kItems * tid);

  // 3. every plane's tile into shared memory before the lookback.  Lane l
  // of warp w copies the chunks 8 kItems w + l + 32 m; chunk J holds the
  // tile's elements 4 J - shift .. 4 J - shift + 3, so a plane whose shift
  // is not 0 needs one chunk more, the last warp's.  A chunk is skipped
  // when the lanes that own its elements have none set (a chunk reaching
  // into the previous warp is always copied).
  const unsigned any = __ballot_sync(kAll, bits != 0u);
#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
    const int* in = planes.in[q];
    const int sh = shift_of(in);
    int* dst = staged + q * kSlots;
#pragma unroll
    for (int m = 0; m <= kQuads; ++m) {
      const int jl = lane + 32 * m;
      if (m == kQuads && !(jl == kWarpChunks && sh && warp == kWarps - 1)) {
        continue;
      }
      const int e = 4 * jl - sh;   // in the warp's span
      const int lo = e >= 0 ? e / kItems : -1;
      const int hi = (e + 3) / kItems;
      const bool need = (lo < 0 && warp > 0) ||
                        (lo >= 0 && ((any >> lo) & 1u)) ||
                        (hi < 32 && ((any >> hi) & 1u));
      if (need) {
        const int chunk = kWarpChunks * warp + jl;
        copy_chunk(dst + 4 * chunk, in, tile0 + 4 * chunk - sh, n);
      }
    }
  }

  // 2. ranks; 4. warp 0 looks back while the others place their sources
  unsigned pre;
  const unsigned total = rank_tile(bits, &pre);
  if (warp == 0) {
    const unsigned base = gst::warp_lookback(status, t, total, epoch);
    if (lane == 0) {
      s_base = base;
      if (count_out != nullptr && t == num_tiles - 1) {
        *count_out = (int)(base + total);
      }
    }
  }
  const int e0 = kItems * tid;
  unsigned r = pre;
  for (unsigned b = bits; b != 0u; b &= b - 1u) {
    src_of[r++] = (unsigned short)(e0 + __ffs(b) - 1);
  }
  gst::cp_async_wait();
  __syncthreads();

  // 5. every plane as one contiguous run at the tile's base
  const long long base = s_base;
  for (int k = tid; k < (int)total; k += kThreads) {
    const int e = src_of[k];
#pragma unroll
    for (int q = 0; q < NOPS; ++q) {
      planes.out[q][base + k] =
          staged[q * kSlots + e + shift_of(planes.in[q])];
    }
  }
}

template <int NOPS>
__global__ void __launch_bounds__(kThreads)
expand(StitchPlanes planes, const unsigned char* __restrict__ mask,
       long long n, unsigned* ticket, unsigned long long* status,
       unsigned epoch, unsigned num_tiles) {
  extern __shared__ int4 smem4[];
  int* run = reinterpret_cast<int*>(smem4);   // each stream's run, shifted
  __shared__ unsigned s_bits[kThreads];
  __shared__ unsigned s_pre[kThreads];
  __shared__ unsigned s_base;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned t = draw_tile(ticket, num_tiles);
  const long long tile0 = (long long)t * kTile;
  const unsigned bits = thread_bits(mask, n, tile0 + (long long)kItems * tid);
  unsigned pre;
  const unsigned total = rank_tile(bits, &pre);
  s_bits[tid] = bits;
  s_pre[tid] = pre;
  if (warp == 0) {
    const unsigned base = gst::warp_lookback(status, t, total, epoch);
    if (lane == 0) s_base = base;
  }
  __syncthreads();

  // each stream's run src[base .. base + total), clipped to its length,
  // from its aligned-down chunks: rank r at slot r + shift
  const long long base = s_base;
#pragma unroll
  for (int q = 0; q < NOPS; ++q) {
    const int* src = planes.in[q];
    const long long len = planes.in_len[q];
    if (base >= len) continue;
    const long long want = len - base < total ? len - base : total;
    const int sh = shift_of(src + base);
    const int chunks = (int)((want + sh + 3) >> 2);
    for (int c = tid; c < chunks; c += kThreads) {
      copy_chunk(run + q * kSlots + 4 * c, src, base - sh + 4 * c, len);
    }
  }
  gst::cp_async_wait();
  __syncthreads();

  // every element of the tile: thread j writes the 4 elements of chunks
  // j + kThreads k, each with one 16-byte store
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    const int c = tid + kThreads * k;
    const long long i = tile0 + 4 * c;
    if (i >= n) break;
    const int owner = (4 * c) / kItems;
    const int off = (4 * c) % kItems;
    const unsigned ob = s_bits[owner];
    const unsigned quad = (ob >> off) & 15u;
    const unsigned r0 = s_pre[owner] + __popc(ob & ((1u << off) - 1u));
#pragma unroll
    for (int q = 0; q < NOPS; ++q) {
      const long long len = planes.in_len[q];
      const int* slots = run + q * kSlots + shift_of(planes.in[q] + base);
      int v[4];
      unsigned r = r0;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        v[m] = 0;
        if ((quad >> m) & 1u) {
          if (base + r < len) v[m] = slots[r];
          ++r;
        }
      }
      int* out = planes.out[q] + i;
      if (i + 4 <= n) {
        *reinterpret_cast<int4*>(out) = make_int4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (i + m < n) out[m] = v[m];
        }
      }
    }
  }
}

// Checks the shape arguments; the tile count through *tiles.
int check_args(long long n, int num_ops, long long scratch_words,
               unsigned epoch, unsigned* tiles) {
  if (n <= 0 || n >= (1ll << 30) || num_ops < 1 || num_ops > kMaxPlanes ||
      epoch == 0 || epoch > gst::kEpochMask) {
    return (int)cudaErrorInvalidValue;
  }
  const long long t = (n + kTile - 1) / kTile;
  if (scratch_words < t) return (int)cudaErrorInvalidValue;
  *tiles = (unsigned)t;
  return 0;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, size_t smem, unsigned tiles, cudaStream_t s,
           Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<tiles, kThreads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

// Elements a tile (the status words a call needs: one a tile).
extern "C" int gst_stitch_tile() { return kTile; }

// compact: in_p/out_p for p < num_ops (the rest ignored; 4-byte aligned),
// `mask` n bytes at any address, `count_out` one int32.  `scratch` is the
// caller's zeroed buffer for this device and stream: a ticket word (8
// bytes) then 64-bit status words, scratch_words >= ceil(n / kTile) of
// them; `epoch`, in [1, 2^30), must differ from every epoch the buffer has
// seen since it was last zeroed.  Launches on `stream`; returns the first
// CUDA error (0 on success).
extern "C" int gst_compact(const void* in0, const void* in1, const void* in2,
                           const void* in3, void* out0, void* out1,
                           void* out2, void* out3, const void* mask,
                           long long n, void* count_out, void* scratch,
                           long long scratch_words, unsigned epoch,
                           int num_ops, void* stream) {
  unsigned tiles = 0;
  const int rc = check_args(n, num_ops, scratch_words, epoch, &tiles);
  if (rc != 0) return rc;
  StitchPlanes planes = {
      {static_cast<const int*>(in0), static_cast<const int*>(in1),
       static_cast<const int*>(in2), static_cast<const int*>(in3)},
      {static_cast<int*>(out0), static_cast<int*>(out1),
       static_cast<int*>(out2), static_cast<int*>(out3)},
      {0, 0, 0, 0}};
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  int* cnt = static_cast<int*>(count_out);
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  unsigned* ticket = reinterpret_cast<unsigned*>(words);
  cudaStream_t s = (cudaStream_t)stream;
  switch (num_ops) {
    case 1:
      return launch(compact<1>, compact_smem<1>(), tiles, s, planes, m, n,
                    cnt, ticket, words + 1, epoch, tiles);
    case 2:
      return launch(compact<2>, compact_smem<2>(), tiles, s, planes, m, n,
                    cnt, ticket, words + 1, epoch, tiles);
    case 3:
      return launch(compact<3>, compact_smem<3>(), tiles, s, planes, m, n,
                    cnt, ticket, words + 1, epoch, tiles);
    default:
      return launch(compact<4>, compact_smem<4>(), tiles, s, planes, m, n,
                    cnt, ticket, words + 1, epoch, tiles);
  }
}

// expand: src_p of len_p elements (4-byte aligned) and out_p of n (16-byte
// aligned) for p < num_ops, `mask` n bytes at any address, `scratch`,
// `scratch_words` and `epoch` as for gst_compact.  Launches on `stream`;
// returns the first CUDA error (0 on success).
extern "C" int gst_expand(const void* src0, const void* src1,
                          const void* src2, const void* src3, long long len0,
                          long long len1, long long len2, long long len3,
                          void* out0, void* out1, void* out2, void* out3,
                          const void* mask, long long n, void* scratch,
                          long long scratch_words, unsigned epoch,
                          int num_ops, void* stream) {
  unsigned tiles = 0;
  const int rc = check_args(n, num_ops, scratch_words, epoch, &tiles);
  if (rc != 0) return rc;
  void* outs[kMaxPlanes] = {out0, out1, out2, out3};
  for (int q = 0; q < num_ops; ++q) {
    if (reinterpret_cast<uintptr_t>(outs[q]) & 15u) {
      return (int)cudaErrorMisalignedAddress;
    }
  }
  StitchPlanes planes = {
      {static_cast<const int*>(src0), static_cast<const int*>(src1),
       static_cast<const int*>(src2), static_cast<const int*>(src3)},
      {static_cast<int*>(out0), static_cast<int*>(out1),
       static_cast<int*>(out2), static_cast<int*>(out3)},
      {len0, len1, len2, len3}};
  const unsigned char* m = static_cast<const unsigned char*>(mask);
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  unsigned* ticket = reinterpret_cast<unsigned*>(words);
  cudaStream_t s = (cudaStream_t)stream;
  switch (num_ops) {
    case 1:
      return launch(expand<1>, expand_smem<1>(), tiles, s, planes, m, n,
                    ticket, words + 1, epoch, tiles);
    case 2:
      return launch(expand<2>, expand_smem<2>(), tiles, s, planes, m, n,
                    ticket, words + 1, epoch, tiles);
    case 3:
      return launch(expand<3>, expand_smem<3>(), tiles, s, planes, m, n,
                    ticket, words + 1, epoch, tiles);
    default:
      return launch(expand<4>, expand_smem<4>(), tiles, s, planes, m, n,
                    ticket, words + 1, epoch, tiles);
  }
}
