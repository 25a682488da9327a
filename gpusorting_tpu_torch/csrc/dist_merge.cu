// The distributed sort's merge of the runs a rank received, for Hopper
// (sm_90a): one stable D-way merge that writes the padded block.
//
// Replaces no TPU kernel.  The JAX package's _exchange_and_merge
// (gpusorting_tpu/parallel/dist_sort.py) merges what a rank received with
// one local sort of every received slot by (code, global index).  On the
// card that was an int64 (code, index) composite over all D x cap slots,
// masked tails included, CUB's 64-bit onesweep with an int64 index, the
// composite split apart, the payload gathered by the permutation and each
// plane padded to pad_to by a concatenation: about 90 ms of the 172 ms a
// call at 4 ranks x 2^28 pairs.  Here the runs are merged as what they are,
// D sorted runs, and each output slot is written once.
//
// Contract.  Planes o < num_ops (1-3 int32 planes; plane 0 the biased codes,
// compared as signed int32): element j of source s's run lies at
//   in[o] + (j / cw) * cs[o] + s * rs[o] + j % cw
// (the collective exchange's (chunks, D, cw) blocks, or with cw = cap the
// ring's (D, cap) rows of any row stride).  Run s is sorted by code, equal
// codes in increasing global index, and its valid prefix is
// len[s] = clamp(rc[s], 0, cap); the slots past it are never read.  Every
// global index of source s lies below every one of source s + 1, so the
// (code, global index) order of the valid elements is the stable merge of
// the runs by code, equal codes taken from the lower source first.
// out[o][0 .. total) gets the valid elements of plane o in that order
// (total = sum of len), out[o][total .. pad_to) the fill fill[o].  rc stays
// on the device: nothing here waits for the host.
//
// Bound: memory.  Each valid element is read once (12 bytes a pair with
// its global index) and each of the pad_to output slots written once, fills
// included: at 4 ranks x 2^28 pairs, 2^28 valid elements of the 2^30-slot
// block a rank, 3.2 GB read and 12.9 GB written, 4.8 ms on the H100 SXM's
// 3.35 TB/s.  Design against that:
//   * merge path over output tiles of kTile slots.  A first launch finds,
//     for each tile boundary k, how many elements of each run come before
//     it: the code v of the k-th element by a bisection over the int32
//     codes, each step counting the elements <= mid in every run by binary
//     searches within the run's bracket (the runs' probes in lockstep, so
//     their loads are in flight together) and narrowing the range to the
//     least and greatest codes left in the brackets, until those are one
//     code; then the elements equal to v split in source order.  That is
//     exact and stable under long runs of one key (Zipf's key 1 is a
//     quarter of the cell's keys, and a boundary inside it ends at the
//     first step);
//   * one block a tile, over the whole pad_to range.  A tile below the
//     valid total stages its D slices' codes in shared memory (coalesced
//     loads) and ranks each element: its place in its own slice, plus, for
//     each other slice, the count of that slice's elements the stable
//     merge of the two puts before it (codes <= its code in a lower
//     source, < it in a higher one).  The D (D - 1) / 2 pairwise merges
//     share the block's threads evenly; each thread finds its start on
//     its pair's merge path by one binary search, walks its share in
//     order and adds each count to the element's rank (shared-memory
//     atomics).  A binary search per element and slice instead took
//     11.19 ms against 8.82 at the cell's shape on uniform codes, and 7.22
//     against 6.89 on 16 codes (H100).  Each plane then goes through a
//     shared-memory tile in output order, out with 16-byte streaming
//     stores; a plane's loads are issued before the barrier that frees the
//     tile, so they overlap the last plane's stores.  A tile past the total
//     writes fills only;
//   * the valid total is read from rc by every block and every partition
//     thread; the grids come from the static pad_to.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kMaxOps = 3;
constexpr int kMaxRuns = 32;
constexpr int kTile = 4096;
constexpr int kThreads = 512;
constexpr int kItems = kTile / kThreads;
constexpr int kPartThreads = 128;
constexpr int kMaxPairs = kMaxRuns * (kMaxRuns - 1) / 2;

struct Runs {
  const int* ptr[kMaxOps];
  long long cs[kMaxOps];   // chunk stride
  long long rs[kMaxOps];   // source (row) stride
};

struct Outs {
  int* ptr[kMaxOps];
  int fill[kMaxOps];
};

// The layout of one run: j / cw by a shift where cw is a power of two.
struct Chunking {
  unsigned cw;
  int shift;   // log2(cw), or -1
};

// Element j of source s's run in plane O.
template <int O>
__device__ __forceinline__ int run_at(const Runs& r, Chunking ch, int s,
                                      unsigned j) {
  const unsigned c = ch.shift >= 0 ? j >> ch.shift : j / ch.cw;
  return __ldg(r.ptr[O] + (long long)c * r.cs[O] + (long long)s * r.rs[O] +
               (j - c * ch.cw));
}

// len[t] = clamp(rc[t], 0, cap): the run's valid prefix.
__device__ __forceinline__ unsigned valid_len(const int* rc, int t,
                                              unsigned cap) {
  const int v = __ldg(rc + t);
  return v <= 0 ? 0u : min((unsigned)v, cap);
}

// part[p * d + t] = the number of run t's elements among the first
// min(p * kTile, total) of the merged order, for p < npoints.  R >= d runs
// are held in registers (unrolled, so the arrays stay there).
template <int R>
__global__ void __launch_bounds__(kPartThreads)
merge_partition(Runs runs, const int* __restrict__ rc, int d, unsigned cap,
                Chunking ch, long long npoints, unsigned* __restrict__ part) {
  const long long p = (long long)blockIdx.x * kPartThreads + threadIdx.x;
  if (p >= npoints) return;
  unsigned lo[R], hi[R];
  long long total = 0;
#pragma unroll
  for (int t = 0; t < R; ++t) {
    hi[t] = t < d ? valid_len(rc, t, cap) : 0u;
    lo[t] = 0;
    total += hi[t];
  }
  unsigned* out = part + p * d;
  const long long k = min(p * kTile, total);
  if (k == total) {
#pragma unroll
    for (int t = 0; t < R; ++t)
      if (t < d) out[t] = hi[t];
    return;
  }
  // invariant: the k-th element is one of the bracketed elements, run t's
  // [lo[t], hi[t]): every element before a bracket comes before it, every
  // one after a bracket after it
  for (;;) {
    // the bracketed codes' least and greatest: the value range narrows to
    // codes that are there, and ends when they are one code
    long long least = LLONG_MAX, most = LLONG_MIN;
#pragma unroll
    for (int t = 0; t < R; ++t) {
      if (lo[t] < hi[t]) {
        least = min(least, (long long)run_at<0>(runs, ch, t, lo[t]));
        most = max(most, (long long)run_at<0>(runs, ch, t, hi[t] - 1));
      }
    }
    if (least == most) break;
    const int mid = (int)(least + ((most - least - 1) >> 1));
    unsigned a[R], b[R];
#pragma unroll
    for (int t = 0; t < R; ++t) {
      a[t] = lo[t];
      b[t] = hi[t];
    }
    // a[t] = run t's count of codes <= mid, searched within [lo, hi]
    bool more = true;
    while (more) {
      more = false;
#pragma unroll
      for (int t = 0; t < R; ++t) {
        if (a[t] < b[t]) {
          const unsigned m = a[t] + ((b[t] - a[t]) >> 1);
          if (run_at<0>(runs, ch, t, m) <= mid) {
            a[t] = m + 1;
          } else {
            b[t] = m;
          }
          more = true;
        }
      }
    }
    long long le = 0;
#pragma unroll
    for (int t = 0; t < R; ++t) le += a[t];
    if (le > k) {
#pragma unroll
      for (int t = 0; t < R; ++t) hi[t] = a[t];
    } else {
#pragma unroll
      for (int t = 0; t < R; ++t) lo[t] = a[t];
    }
  }
  // every bracketed code is the k-th element's: the elements before the
  // brackets come first, then the rest of the k from the brackets, lower
  // sources first
  long long rest = k;
#pragma unroll
  for (int t = 0; t < R; ++t) rest -= lo[t];
#pragma unroll
  for (int t = 0; t < R; ++t) {
    if (t < d) {
      const unsigned take = (unsigned)min(rest, (long long)(hi[t] - lo[t]));
      out[t] = lo[t] + take;
      rest -= take;
    }
  }
}

// Pair p of the slices (u < t), numbered by t, then u.
__device__ __forceinline__ void pair_of(int p, int& u, int& t) {
  t = 1;
  while (t * (t + 1) / 2 <= p) ++t;
  u = p - t * (t - 1) / 2;
}

// Adds to rank[i] (shared memory), for each tile element i and each other
// slice, the count of that slice's elements that the stable merge of the
// two slices puts before i (ties to the lower source).  The pairs' merges
// are (d - 1) * nv outputs in all, pair p's [pw[p], pw[p + 1]); each thread
// takes an even share, finds where it starts on its first pair's merge path
// by one binary search, and walks the share in order.
__device__ __forceinline__ void add_cross_ranks(const int* sc, int* rank,
                                                const int* s_off, int* pw,
                                                int d, int nv) {
  const int pairs = d * (d - 1) / 2;
  const int work = (d - 1) * nv;
  for (int p = threadIdx.x; p <= pairs; p += kThreads) {
    if (p == pairs) {
      pw[p] = work;
      continue;
    }
    // the outputs of the pairs before (u, t): each (u', t') with t' < t,
    // then each (u', t) with u' < u
    int u, t;
    pair_of(p, u, t);
    int w = s_off[u] + u * (s_off[t + 1] - s_off[t]);
    for (int x = 1; x < t; ++x) w += s_off[x] + x * (s_off[x + 1] - s_off[x]);
    pw[p] = w;
  }
  __syncthreads();
  const int per = (work + kThreads - 1) / kThreads;
  int g = min((int)threadIdx.x * per, work);
  const int gend = min(g + per, work);
  int p = 0;   // the last pair that starts at or before g
  for (int h = pairs > 0 ? 1 << (31 - __clz(pairs)) : 0; h > 0; h >>= 1) {
    if (p + h < pairs && pw[p + h] <= g) p += h;
  }
  for (; g < gend; ++p) {
    int u, t;
    pair_of(p, u, t);
    const int* a_run = sc + s_off[u];
    const int la = s_off[u + 1] - s_off[u];
    const int* b_run = sc + s_off[t];
    const int lb = s_off[t + 1] - s_off[t];
    const int d0 = g - pw[p];
    const int steps = min(gend, pw[p + 1]) - g;
    g += steps;
    if (la == 0 || lb == 0) continue;
    // the merge path's split at output d0: a from slice u, d0 - a from t
    int lo = max(0, d0 - lb), hi = min(d0, la);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (a_run[mid] <= b_run[d0 - 1 - mid]) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    int a = lo, b = d0 - lo;
    int ha = a < la ? a_run[a] : 0, hb = b < lb ? b_run[b] : 0;
    for (int q = steps; q > 0; --q) {
      if (b == lb || (a < la && ha <= hb)) {
        if (b) atomicAdd(rank + s_off[u] + a, b);
        if (++a < la) ha = a_run[a];
      } else {
        if (a) atomicAdd(rank + s_off[t] + b, a);
        if (++b < lb) hb = b_run[b];
      }
    }
  }
}

// The slice of tile position i: s_off[t] <= i < s_off[t + 1].
__device__ __forceinline__ int slice_of(const int* s_off, int d, int i) {
  int t = 0;
  while (t + 1 < d && s_off[t + 1] <= i) ++t;
  return t;
}

// Plane O of the tile: its valid elements (staged in `so` in output
// order) and then the fill, 16 bytes a store.
template <int O>
__device__ __forceinline__ void store_tile(const Outs& outs, long long t0,
                                           int tlen, int nv, const int* so) {
  int* dst = outs.ptr[O] + t0;
  const int fill = outs.fill[O];
  const int nvec = tlen >> 2;
  for (int q = threadIdx.x; q < nvec; q += kThreads) {
    const int e = q * 4;
    int4 v;
    if (e + 4 <= nv) {
      v = reinterpret_cast<const int4*>(so)[q];
    } else {
      v.x = e < nv ? so[e] : fill;
      v.y = e + 1 < nv ? so[e + 1] : fill;
      v.z = e + 2 < nv ? so[e + 2] : fill;
      v.w = e + 3 < nv ? so[e + 3] : fill;
    }
    __stcs(reinterpret_cast<int4*>(dst) + q, v);
  }
  for (int e = nvec * 4 + threadIdx.x; e < tlen; e += kThreads) {
    dst[e] = e < nv ? so[e] : fill;
  }
}

// Plane O (O >= 1) of a tile whose ranks are known: each element read from
// its run, placed at its rank, stored.
template <int O>
__device__ __forceinline__ void move_plane(const Runs& runs, const Outs& outs,
                                           Chunking ch, int d, long long t0,
                                           int tlen, int nv, const int* s_off,
                                           const unsigned* s_start,
                                           const int (&rank)[kItems],
                                           int* so) {
  int v[kItems];
  if (nv > 0) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < nv) {
        const int t = slice_of(s_off, d, i);
        v[k] = run_at<O>(runs, ch, t, s_start[t] + (unsigned)(i - s_off[t]));
      }
    }
  }
  __syncthreads();   // the last plane's stores have read `so`
  if (nv > 0) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (threadIdx.x + k * kThreads < nv) so[rank[k]] = v[k];
    }
  }
  __syncthreads();
  store_tile<O>(outs, t0, tlen, nv, so);
}

__global__ void __launch_bounds__(kThreads)
merge_tiles(Runs runs, Outs outs, int num_ops, const int* __restrict__ rc,
            int d, unsigned cap, Chunking ch, long long pad_to,
            const unsigned* __restrict__ part) {
  __shared__ __align__(16) int sc[kTile];   // the slices' codes
  __shared__ __align__(16) int so[kTile];   // a plane in output order
  __shared__ unsigned s_start[kMaxRuns];
  __shared__ int s_off[kMaxRuns + 1];
  __shared__ int pw[kMaxPairs + 1];   // the pairs' merge outputs
  const long long t0 = (long long)blockIdx.x * kTile;
  const int tlen = (int)min((long long)kTile, pad_to - t0);
  long long total = 0;
  for (int t = 0; t < d; ++t) total += valid_len(rc, t, cap);
  const int nv = (int)min(max(total - t0, 0LL), (long long)tlen);
  int rank[kItems];
  if (nv > 0) {
    if (threadIdx.x == 0) {
      int off = 0;
      for (int t = 0; t < d; ++t) {
        const unsigned a = part[(long long)blockIdx.x * d + t];
        const unsigned b = part[((long long)blockIdx.x + 1) * d + t];
        s_start[t] = a;
        s_off[t] = off;
        off += (int)(b - a);
      }
      s_off[d] = off;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < nv) {
        const int t = slice_of(s_off, d, i);
        sc[i] = run_at<0>(runs, ch, t, s_start[t] + (unsigned)(i - s_off[t]));
      }
    }
    __syncthreads();
    // each element's rank, accumulated in `so`: its place in its own
    // slice, then the other slices' counts before it
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < nv) so[i] = i - s_off[slice_of(s_off, d, i)];
    }
    __syncthreads();
    add_cross_ranks(sc, so, s_off, pw, d, nv);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < nv) rank[k] = so[i];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < nv) so[rank[k]] = sc[i];
    }
    __syncthreads();
  }
  store_tile<0>(outs, t0, tlen, nv, so);
  if (num_ops > 1) {
    move_plane<1>(runs, outs, ch, d, t0, tlen, nv, s_off, s_start, rank, so);
  }
  if (num_ops > 2) {
    move_plane<2>(runs, outs, ch, d, t0, tlen, nv, s_off, s_start, rank, so);
  }
}

template <int R>
cudaError_t launch_partition(const Runs& runs, const int* rc, int d,
                             unsigned cap, Chunking ch, long long npoints,
                             unsigned* part, cudaStream_t stream) {
  const long long blocks = (npoints + kPartThreads - 1) / kPartThreads;
  merge_partition<R><<<(unsigned)blocks, kPartThreads, 0, stream>>>(
      runs, rc, d, cap, ch, npoints, part);
  return cudaGetLastError();
}

}  // namespace

// Output slots a merge block writes: the caller sizes `part` by it.
extern "C" int gst_merge_tile() { return kTile; }

// The merge of d (1 <= d <= 32) received runs on `stream`: two launches,
// the partition and the merge.  in0..in2 the planes (num_ops of them, 4-byte
// aligned, unit stride along a chunk), cs* and rs* their chunk and source
// strides in elements, cw the chunk width (cap a multiple of it); out0..out2
// pad_to words each (16-byte aligned), f0..f2 the fills; rc (d,) int32 on
// the device; cap < 2^32 and d * cap <= pad_to; part the caller's buffer of
// (ceil(pad_to / gst_merge_tile()) + 1) * d words.  Returns the first CUDA
// error (0 on success).
extern "C" int gst_merge_runs(const void* in0, const void* in1,
                              const void* in2, long long cs0, long long cs1,
                              long long cs2, long long rs0, long long rs1,
                              long long rs2, void* out0, void* out1,
                              void* out2, int f0, int f1, int f2, int num_ops,
                              const void* rc, int d, long long cap,
                              long long cw, long long pad_to, void* part,
                              void* stream) {
  if (num_ops < 1 || num_ops > kMaxOps || d < 1 || d > kMaxRuns || cw < 1 ||
      cap < cw || cap % cw != 0 || cap > 0xFFFFFFFFLL ||
      pad_to < (long long)d * cap) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles = (pad_to + kTile - 1) / kTile;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  Runs runs = {{static_cast<const int*>(in0), static_cast<const int*>(in1),
                static_cast<const int*>(in2)},
               {cs0, cs1, cs2},
               {rs0, rs1, rs2}};
  Outs outs = {{static_cast<int*>(out0), static_cast<int*>(out1),
                static_cast<int*>(out2)},
               {f0, f1, f2}};
  Chunking ch = {(unsigned)cw, -1};
  if ((cw & (cw - 1)) == 0) {
    ch.shift = 0;
    while ((1LL << ch.shift) < cw) ++ch.shift;
  }
  const int* counts = static_cast<const int*>(rc);
  unsigned* table = static_cast<unsigned*>(part);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (d <= 4) {
    err = launch_partition<4>(runs, counts, d, (unsigned)cap, ch, tiles + 1,
                              table, s);
  } else if (d <= 8) {
    err = launch_partition<8>(runs, counts, d, (unsigned)cap, ch, tiles + 1,
                              table, s);
  } else if (d <= 16) {
    err = launch_partition<16>(runs, counts, d, (unsigned)cap, ch, tiles + 1,
                               table, s);
  } else {
    err = launch_partition<32>(runs, counts, d, (unsigned)cap, ch, tiles + 1,
                               table, s);
  }
  if (err != cudaSuccess) return (int)err;
  merge_tiles<<<(unsigned)tiles, kThreads, 0, s>>>(
      runs, outs, num_ops, counts, d, (unsigned)cap, ch, pad_to, table);
  return (int)cudaGetLastError();
}
