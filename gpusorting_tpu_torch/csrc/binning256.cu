// An LSD radix sort of 32-bit keys with 8-bit digits for Hopper (sm_90a),
// keys only or with one 32-bit payload: one upsweep and four OneSweep
// digit-binning passes (OneSweep.cu:44-344 at 256 digits), all enqueued by
// one call.
//
// Replaces no TPU kernel.  The JAX package's radix engines take 4-bit
// digits (radix16.py, rts.py), eight passes a 32-bit key, and csrc/
// binning.cu keeps that contract.  This is the reference OneSweep's own
// width: 8-bit digits, four passes, the pass count the bench's bound
// assumes (ROADMAP A2).  It serves AUTO's keys-only route on the card
// (ops/radix256.py), where `torch.sort` would run a pairs sort over an
// index it then drops, and AUTO's pairs route with a 32-bit payload, where
// `torch.sort` would sort the keys with an int64 index and a gather would
// then move the payload by it.
//
// Contract, on n raw 32-bit keys of one kind (0 u32, 1 i32, 2 f32): `out`
// gets the keys in ascending order of their u32 codes (core/codec.py: u32
// as is, i32 with the sign bit flipped, f32 with every bit flipped where
// the sign is set and the sign bit set elsewhere), equal codes in input
// order.  The keys move as raw bits: each pass takes its digit from the
// code computed in registers, so no encode or decode pass exists.  `tmp`
// (n words) is the ping-pong buffer; the input is left as it is.  With a
// payload (`kPairs`), `vout` gets the payload words in the keys' order,
// moved as raw bits (any 32-bit type, NaN patterns included), through
// their own ping-pong buffer `vtmp`.
//
//   upsweep  reads the keys once and counts all four digit positions into
//            privatised shared-memory histograms, then adds them into 4 x
//            256 global counts.  The block that finishes last (a counter
//            of finished blocks) takes each position's exclusive digit
//            bases and clears the counts and the counter for the next call,
//            so the counts need no clearing launch.
//   pass p   (shift 8p; keys -> tmp -> out -> tmp -> out) is one chained
//            scan with decoupled lookback over partitions of kPart keys.
//            Each block:
//            1. draws its partition from an atomic ticket, so every
//               partition it waits on belongs to a block already running;
//            2. reads its keys ONCE into registers, warp-striped: item i
//               of lane l is key 32 i + l of the warp's kItems * 32, so
//               ranking item by item, lane by lane follows input order,
//               which keeps the pass stable;
//            3. ranks each key by a warp multisplit: 8 ballots of the
//               digit's bits give the lanes that share it, the popcount of
//               those below a lane its rank, and the lowest of them adds
//               their number to the warp's own 256 counters in shared
//               memory; a key's offset is kept in 16 bits (`__match_any_sync`
//               in place of the ballots took 1.4x the time on the H100);
//            4. sums the warps' counters a digit (each warp's offset within
//               the digit), publishes the partition's 256 counts as
//               aggregates before anything else, and scans them into the
//               partition's digit starts;
//            5. stages its keys in digit order in shared memory, while 256
//               threads look back, one digit each, over the predecessors'
//               status words to the nearest inclusive prefix, and publish
//               the partition's own;
//            6. writes each digit's run from the stage to the digit's base
//               plus the run's global offset: consecutive threads on
//               consecutive addresses.
//            With a payload, as the reference's OneSweep does: the key
//            writes of step 6 keep each staged key's digit (four a
//            register); then each thread loads its payloads (after the
//            ranks, so they hold no registers through them), in the keys'
//            warp-striped layout, stages them at their keys' positions
//            once every key has left the stage, and each digit's run goes
//            to the same global offsets as the keys.  The upsweep reads
//            keys only.
//            The last partition may be ragged: its missing keys rank as
//            digit 255 after every real key, are counted only in the
//            partition that no one looks back at, and are never written,
//            nor are their payloads.
// The status words are 64 bits with a per-call epoch (`gst::pack_word`,
// radix_common.cuh), published by volatile stores: the wrapper owns one
// zeroed scratch buffer per device and stream and hands each pass a fresh
// epoch, so no launch clears the words; the ticket is the buffer's first
// word, set back to 0 by the block that draws the last ticket.  The
// partition is 512 threads x 20 keys, two blocks an SM: on the H100 it beat
// 15-18 keys, 384 or 256 threads, three or four blocks an SM, persistent
// blocks copying the next partition ahead, and digit counts taken before
// the ranks (probes/torch_radix256_probe.py --shapes).  With a payload it is
// 512 threads x 16 pairs, which spills nothing: it beat 12, 14, 15, 18 and
// 20 pairs (20 spills), and loading the payloads before the lookback
// (PERF.md §6).
//
// Bound: memory.  Each pass reads and writes every key once, 8 bytes a key
// (the status words add 4 KB a partition): at n = 2^28 0.641 ms a pass at
// the H100 SXM's 3.35 TB/s, 2.564 ms the four; the upsweep reads 4 bytes a
// key, 0.321 ms.  With a payload a pass moves 16 bytes a pair: 0.320 ms at
// n = 2^26, 1.282 at 2^28.

#include <cuda_runtime.h>

#include "radix_common.cuh"

namespace {

// the pass's partition: kThreads threads x GST_R256_ITEMS keys, or
// GST_R256_PAIRS_ITEMS pairs (GST_R256_* may override them at build time,
// to compare shapes)
#ifndef GST_R256_THREADS
#define GST_R256_THREADS 512
#endif
#ifndef GST_R256_ITEMS
#define GST_R256_ITEMS 20
#endif
#ifndef GST_R256_PAIRS_ITEMS
#define GST_R256_PAIRS_ITEMS 16
#endif
#ifndef GST_R256_MIN_BLOCKS
#define GST_R256_MIN_BLOCKS 2
#endif
constexpr int kThreads = GST_R256_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kDigits = 256;
constexpr int kPasses = 4;
// predecessors a lookback thread reads at once (2 and 8 timed alike)
constexpr int kLook = 4;
constexpr unsigned kAll = 0xffffffffu;
static_assert(kThreads % 32 == 0 && kThreads >= kDigits && kWarps <= 32,
              "block size");
static_assert(kLook >= 1, "lookback");
constexpr int kCounters = kWarps * kDigits;

// A pass's partition, keys only or with a payload: kItems keys a thread,
// kSize a partition; its shared stage, kStage words, holds the warps'
// counters first, then the partition in digit order.
template <bool kPairs>
struct Part {
  static constexpr int kItems = kPairs ? GST_R256_PAIRS_ITEMS
                                       : GST_R256_ITEMS;
  static constexpr int kWarpSpan = 32 * kItems;
  static constexpr int kSize = kThreads * kItems;
  static constexpr int kStage = kSize > kCounters ? kSize : kCounters;
  static_assert(kSize <= 65536, "16-bit offsets");
};

// the upsweep: kUpThreads threads (one a digit in the last block's scans),
// kUpVecs 16-byte loads in flight a thread, kUpCopies histograms a block
// (warp w counts into copy w % kUpCopies; an odd stride puts a bin's copies
// in different banks)
constexpr int kUpThreads = 256;
constexpr int kUpVecs = 4;
constexpr int kUpCopies = 4;
constexpr int kUpBlocksPerSM = 8;
constexpr int kCopyWords = kPasses * kDigits + 1;
static_assert(kUpThreads == kDigits, "one upsweep thread a digit");

// The u32 code of a raw key of kind KIND (0 u32, 1 i32, 2 f32).
template <int KIND>
__device__ __forceinline__ unsigned code_of(unsigned raw) {
  if (KIND == 0) return raw;
  if (KIND == 1) return raw ^ 0x80000000u;
  return raw ^ ((unsigned)((int)raw >> 31) | 0x80000000u);
}

template <int KIND>
__device__ __forceinline__ unsigned digit_of(unsigned raw, int shift) {
  return (code_of<KIND>(raw) >> shift) & 255u;
}

// A thread's N key offsets within the partition (< 2^16), two a register
// (the loops that index them are unrolled, so every index is a constant).
template <int N>
struct Offsets {
  unsigned w[(N + 1) / 2];
  __device__ __forceinline__ unsigned get(int i) const {
    return (w[i >> 1] >> ((i & 1) * 16)) & 0xFFFFu;
  }
  __device__ __forceinline__ void set(int i, unsigned v) {
    w[i >> 1] = i & 1 ? (w[i >> 1] & 0xFFFFu) | (v << 16)
                      : (w[i >> 1] & 0xFFFF0000u) | v;
  }
};

// A thread's N digits (< 256), four a register, set once each in order
// from zero.
template <int N>
struct Digits {
  unsigned w[(N + 3) / 4];
  __device__ __forceinline__ unsigned get(int i) const {
    return (w[i >> 2] >> ((i & 3) * 8)) & 0xFFu;
  }
  __device__ __forceinline__ void set(int i, unsigned v) {
    w[i >> 2] |= v << ((i & 3) * 8);
  }
};

__device__ __forceinline__ void count_code(unsigned* h, unsigned c) {
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    atomicAdd(h + p * kDigits + ((c >> (8 * p)) & 255u), 1u);
  }
}

// Four keys of one 16-byte load; where all four share a position's digit
// (runs of equal keys, low-entropy bytes) one add of 4 replaces four adds
// to one counter.
template <int KIND>
__device__ __forceinline__ void count_vec(unsigned* h, uint4 v) {
  const unsigned a = code_of<KIND>(v.x), b = code_of<KIND>(v.y),
                 c = code_of<KIND>(v.z), d = code_of<KIND>(v.w);
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int s = 8 * p;
    const unsigned da = (a >> s) & 255u, db = (b >> s) & 255u,
                   dc = (c >> s) & 255u, dd = (d >> s) & 255u;
    unsigned* hp = h + p * kDigits;
    if (da == db && da == dc && da == dd) {
      atomicAdd(hp + da, 4u);
    } else {
      atomicAdd(hp + da, 1u);
      atomicAdd(hp + db, 1u);
      atomicAdd(hp + dc, 1u);
      atomicAdd(hp + dd, 1u);
    }
  }
}

// counts: 4 x 256 words, zero on entry (the last block leaves them zero);
// done: the finished-block counter, zero on entry and left zero; bases: the
// 4 x 256 exclusive digit bases out.  The first `head` (< 4) keys are
// counted one by one so that the rest is read as aligned 16-byte vectors.
template <int KIND>
__global__ void __launch_bounds__(kUpThreads)
upsweep(const unsigned* __restrict__ keys, unsigned n, unsigned head,
        unsigned* counts, unsigned* done, unsigned* __restrict__ bases) {
  __shared__ unsigned hist[kUpCopies * kCopyWords];
  __shared__ bool s_last;
  for (int i = threadIdx.x; i < kUpCopies * kCopyWords; i += kUpThreads) {
    hist[i] = 0;
  }
  __syncthreads();
  unsigned* h = hist + ((threadIdx.x >> 5) % kUpCopies) * kCopyWords;

  const uint4* vec = reinterpret_cast<const uint4*>(keys + head);
  const unsigned nvec = (n - head) >> 2;
  const unsigned stride = gridDim.x * kUpThreads;
  unsigned i = blockIdx.x * kUpThreads + threadIdx.x;
  for (; i + (kUpVecs - 1) * stride < nvec; i += kUpVecs * stride) {
    uint4 v[kUpVecs];
#pragma unroll
    for (int q = 0; q < kUpVecs; ++q) v[q] = __ldg(vec + i + q * stride);
#pragma unroll
    for (int q = 0; q < kUpVecs; ++q) count_vec<KIND>(h, v[q]);
  }
  for (; i < nvec; i += stride) count_vec<KIND>(h, __ldg(vec + i));
  if (blockIdx.x == 0) {
    const unsigned tail = (n - head) & 3u;
    if (threadIdx.x < head) count_code(h, code_of<KIND>(keys[threadIdx.x]));
    if (threadIdx.x < tail) {
      count_code(h, code_of<KIND>(keys[head + 4 * nvec + threadIdx.x]));
    }
  }
  __syncthreads();

  for (int b = threadIdx.x; b < kPasses * kDigits; b += kUpThreads) {
    unsigned s = 0;
#pragma unroll
    for (int c = 0; c < kUpCopies; ++c) s += hist[c * kCopyWords + b];
    if (s) atomicAdd(counts + b, s);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  // the last block: every other block's adds are visible; read and clear
  // the counts in one exchange, and scan each position's 256 of them
  __threadfence();
  const int t = threadIdx.x;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const unsigned c = atomicExch(counts + p * kDigits + t, 0u);
    unsigned total;
    bases[p * kDigits + t] = gst::block_exclusive<kUpThreads>(c, &total);
  }
  if (t == 0) *done = 0u;
}

// Publishes a status word with a volatile store: the readers poll with
// volatile loads, and a 64-bit store is seen whole.
__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long w) {
  *reinterpret_cast<volatile unsigned long long*>(p) = w;
}

// The lanes of the warp whose digit is d: 8 ballots of its bits.
__device__ __forceinline__ unsigned peers_of(unsigned d) {
  unsigned peers = kAll;
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool bit = (d >> b) & 1u;
    const unsigned ones = __ballot_sync(kAll, bit);
    peers &= bit ? ones : ~ones;
  }
  return peers;
}

// Step 5 for digit `tid` (< 256) of partition `part` > 0: look back over
// the predecessors' words to the nearest inclusive prefix, kLook words in
// flight at once (a partition before 0 reads as an inclusive 0, and
// partition 0 always publishes one, so no walk passes it), and publish the
// partition's own inclusive prefix.  Returns the digit's count in
// partitions 0 .. part-1.
__device__ __forceinline__ unsigned look_back(unsigned long long* status,
                                              unsigned part, unsigned epoch,
                                              unsigned total) {
  const int tid = threadIdx.x;
  unsigned exclusive = 0;
  for (long long top = (long long)part - 1;; top -= kLook) {
    unsigned long long w[kLook];
#pragma unroll
    for (int q = 0; q < kLook; ++q) {
      w[q] = top - q >= 0
                 ? gst::load_word(status + (top - q) * kDigits + tid)
                 : gst::pack_word(gst::kEpochInclusive, epoch, 0u);
    }
    bool found = false;
#pragma unroll
    for (int q = 0; q < kLook; ++q) {   // in order, to the nearest inclusive
      if (!found) {
        if (!gst::word_ready(w[q], epoch)) {
          w[q] = gst::wait_word(status + (top - q) * kDigits + tid, epoch);
        }
        exclusive += (unsigned)w[q];
        found = gst::word_inclusive(w[q]);
      }
    }
    if (found) break;
  }
  publish(status + (size_t)part * kDigits + tid,
          gst::pack_word(gst::kEpochInclusive, epoch, exclusive + total));
  return exclusive;
}

// One stable pass of the 8-bit digit at `shift` over n keys from `in` into
// `out`, a partition a block: key i of digit d goes to bases[d] +
// #{ earlier keys of digit d }.  With kPairs, payload i goes from `vin` to
// the same place in `vout` (both unused without it).
template <int KIND, bool kPairs>
__global__ void __launch_bounds__(kThreads, GST_R256_MIN_BLOCKS)
binning(const unsigned* __restrict__ in, unsigned* __restrict__ out,
        const unsigned* __restrict__ bases, unsigned* ticket,
        unsigned long long* status, unsigned epoch, unsigned num_parts,
        unsigned n, int shift, const unsigned* __restrict__ vin,
        unsigned* __restrict__ vout) {
  constexpr int kItems = Part<kPairs>::kItems;
  constexpr int kWarpSpan = Part<kPairs>::kWarpSpan;
  constexpr int kPart = Part<kPairs>::kSize;
  __shared__ unsigned stage[Part<kPairs>::kStage];
  __shared__ unsigned s_start[kDigits];
  __shared__ unsigned s_adj[kDigits];
  __shared__ unsigned s_part;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  unsigned* wc = stage + warp * kDigits;   // the warp's 256 counters
  for (int i = tid; i < kCounters; i += kThreads) stage[i] = 0;
  if (tid == 0) {
    const unsigned t = atomicAdd(ticket, 1u);
    if (t == num_parts - 1) *ticket = 0u;   // every ticket is drawn
    s_part = t;
  }
  __syncthreads();
  const unsigned part = s_part;
  const unsigned base = part * kPart;
  const unsigned left = n - base;           // > 0
  const bool whole = left >= (unsigned)kPart;
  const unsigned count_here = whole ? kPart : left;
  const unsigned first = warp * kWarpSpan + lane;   // item i: first + 32 i

  // 2. the keys, once, warp-striped, into registers; a missing key of a
  // ragged partition takes digit 255 and ranks after every real key
  unsigned key[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned e = first + 32 * i;
    key[i] = whole || e < left ? __ldg(in + base + e) : 0u;
  }
#define GST_R256_DIGIT(i)                                                 \
  (whole || first + 32 * (i) < left ? digit_of<KIND>(key[i], shift) : 255u)

  // 3. the warp multisplit: each key's rank among its warp's keys of its
  // digit, the lowest lane of each digit adding their number to the
  // warp's counter
  Offsets<kItems> offset = {};
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned d = GST_R256_DIGIT(i);
    const unsigned peers = peers_of(d);
    const unsigned rank = __popc(peers & below);
    unsigned before = 0;
    if (rank == 0) before = atomicAdd(wc + d, (unsigned)__popc(peers));
    offset.set(i, __shfl_sync(kAll, before, __ffs(peers) - 1) + rank);
  }
  __syncthreads();

  // 4. each warp's offset within a digit and the partition's counts, the
  // counts published at once, then the partition's digit starts
  unsigned total = 0;
  if (tid < kDigits) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned c = stage[w * kDigits + tid];
      stage[w * kDigits + tid] = total;
      total += c;
    }
    publish(status + (size_t)part * kDigits + tid,
            gst::pack_word(part == 0 ? gst::kEpochInclusive
                                     : gst::kEpochAggregate,
                           epoch, total));
  }
  unsigned all;
  const unsigned start =
      gst::block_exclusive<kThreads>(tid < kDigits ? total : 0u, &all);
  if (tid < kDigits) s_start[tid] = start;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned d = GST_R256_DIGIT(i);
    offset.set(i, offset.get(i) + wc[d] + s_start[d]);
  }
#undef GST_R256_DIGIT
  __syncthreads();   // every warp has read its counters: the stage is free

  // 5. the keys staged in digit order; 256 threads look back, a digit each
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (whole || first + 32 * i < left) stage[offset.get(i)] = key[i];
  }
  if (tid < kDigits) {
    unsigned exclusive = 0;
    if (part) exclusive = look_back(status, part, epoch, total);
    s_adj[tid] = bases[tid] + exclusive - start;
  }
  __syncthreads();

  // 6. each digit's run out: consecutive threads on consecutive addresses
  if constexpr (!kPairs) {
#pragma unroll 4
    for (unsigned k = tid; k < count_here; k += kThreads) {
      const unsigned x = stage[k];
      out[s_adj[digit_of<KIND>(x, shift)] + k] = x;
    }
  } else {
    Digits<kItems> digit = {};
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const unsigned k = tid + j * kThreads;
      if (k < count_here) {
        const unsigned x = stage[k];
        const unsigned d = digit_of<KIND>(x, shift);
        digit.set(j, d);
        out[s_adj[d] + k] = x;
      }
    }
    // the payloads, once, in the keys' layout, staged at their keys'
    // positions once every key has left the stage
    unsigned val[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const unsigned e = first + 32 * i;
      val[i] = whole || e < left ? __ldg(vin + base + e) : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (whole || first + 32 * i < left) stage[offset.get(i)] = val[i];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const unsigned k = tid + j * kThreads;
      if (k < count_here) vout[s_adj[digit.get(j)] + k] = stage[k];
    }
  }
}

template <int KIND, bool kPairs>
int enqueue(const unsigned* keys, const unsigned* vals, unsigned* out,
            unsigned* vout, unsigned* tmp, unsigned* vtmp, unsigned* counts,
            unsigned* done, unsigned* bases, unsigned* ticket,
            unsigned long long* status, const unsigned* epochs, unsigned n,
            cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  const unsigned misalign = (unsigned)((size_t)keys & 15u) / 4u;
  const unsigned head =
      !misalign ? 0u : 4u - misalign < n ? 4u - misalign : n;
  const unsigned nvec = (n - head) / 4u;
  const unsigned per_block = kUpThreads * kUpVecs;
  const unsigned most = (unsigned)(sms * kUpBlocksPerSM);
  unsigned grid = (nvec + per_block - 1) / per_block;
  grid = grid < 1u ? 1u : grid > most ? most : grid;
  upsweep<KIND><<<grid, kUpThreads, 0, s>>>(keys, n, head, counts, done,
                                            bases);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  constexpr unsigned kPart = Part<kPairs>::kSize;
  const unsigned parts = (n + kPart - 1) / kPart;
  const unsigned* src = keys;
  const unsigned* vsrc = vals;
  unsigned* const dst[kPasses] = {tmp, out, tmp, out};
  unsigned* const vdst[kPasses] = {vtmp, vout, vtmp, vout};
  for (int p = 0; p < kPasses; ++p) {
    binning<KIND, kPairs><<<parts, kThreads, 0, s>>>(
        src, dst[p], bases + p * kDigits, ticket, status, epochs[p], parts,
        n, 8 * p, vsrc, vdst[p]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = dst[p];
    vsrc = vdst[p];
  }
  return 0;
}

// The checks and the launches of both entry points; vals, vout and vtmp
// are null without a payload.
template <bool kPairs>
int sort_any(const void* keys, const void* vals, void* out, void* vout,
             void* tmp, void* vtmp, void* counts, void* scratch,
             long long scratch_words, const unsigned* epochs, int kind,
             long long n, void* stream) {
  constexpr long long kPart = Part<kPairs>::kSize;
  const long long parts = (n + kPart - 1) / kPart;
  bool bad = n <= 0 || n >= (1ll << 31) || kind < 0 || kind > 2 ||
             scratch_words < parts * kDigits || ((size_t)keys & 3u) ||
             ((size_t)vals & 3u);
  for (int p = 0; p < kPasses; ++p) {
    bad = bad || epochs[p] == 0 || epochs[p] > gst::kEpochMask;
  }
  if (bad) return (int)cudaErrorInvalidValue;
  unsigned* c = static_cast<unsigned*>(counts);
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  const unsigned* k = static_cast<const unsigned*>(keys);
  const unsigned* v = static_cast<const unsigned*>(vals);
  unsigned* o = static_cast<unsigned*>(out);
  unsigned* vo = static_cast<unsigned*>(vout);
  unsigned* t = static_cast<unsigned*>(tmp);
  unsigned* vt = static_cast<unsigned*>(vtmp);
  unsigned* ticket = reinterpret_cast<unsigned*>(words);
  unsigned* done = c + kPasses * kDigits;
  unsigned* bases = c + kPasses * kDigits + 4;
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case 0:
      return enqueue<0, kPairs>(k, v, o, vo, t, vt, c, done, bases, ticket,
                                words + 1, epochs, (unsigned)n, s);
    case 1:
      return enqueue<1, kPairs>(k, v, o, vo, t, vt, c, done, bases, ticket,
                                words + 1, epochs, (unsigned)n, s);
    default:
      return enqueue<2, kPairs>(k, v, o, vo, t, vt, c, done, bases, ticket,
                                words + 1, epochs, (unsigned)n, s);
  }
}

}  // namespace

// Keys a partition of a pass (the status words the caller provides: 256 a
// partition), keys only and with a payload.
extern "C" int gst_radix256_partition() { return Part<false>::kSize; }
extern "C" int gst_radix256_pairs_partition() { return Part<true>::kSize; }

// Words of the caller's counts buffer: 4 x 256 counts, the finished-block
// counter, then (16-byte aligned) the 4 x 256 bases.
extern "C" int gst_radix256_counts_words() { return 2 * kPasses * kDigits + 4; }

// One sort of n keys (0 < n < 2^31) of kind `kind` (0 u32, 1 i32, 2 f32) on
// `stream`: the upsweep and four passes, five launches.  `keys`, `out` and
// `tmp` hold n 32-bit words each (`keys` 4-byte aligned; it is only read).
// `counts` is the caller's buffer of gst_radix256_counts_words() words for
// this device and stream, zeroed once when it was made: the upsweep leaves
// its counts zero for the next call.  `scratch` is the caller's zeroed
// buffer for this device and stream: a ticket word (8 bytes) then 64-bit
// status words, scratch_words >= 256 * ceil(n / partition) of them; e0..e3,
// each in [1, 2^30), must differ from each other and from every epoch the
// buffer has seen since it was last zeroed.  Returns the first CUDA error
// (0 on success).
extern "C" int gst_radix256_sort(const void* keys, void* out, void* tmp,
                                 void* counts, void* scratch,
                                 long long scratch_words, unsigned e0,
                                 unsigned e1, unsigned e2, unsigned e3,
                                 int kind, long long n, void* stream) {
  const unsigned epochs[kPasses] = {e0, e1, e2, e3};
  return sort_any<false>(keys, nullptr, out, nullptr, tmp, nullptr, counts,
                         scratch, scratch_words, epochs, kind, n, stream);
}

// The same sort carrying one 32-bit payload word a key: `vals` (4-byte
// aligned; only read), `vout` and `vtmp` hold n words each, and `vout`
// gets the payloads in the order `out` gets their keys.  Five launches, as
// gst_radix256_sort; the status words are 256 a partition of
// gst_radix256_pairs_partition() pairs.
extern "C" int gst_radix256_sort_pairs(const void* keys, const void* vals,
                                       void* out, void* vout, void* tmp,
                                       void* vtmp, void* counts,
                                       void* scratch,
                                       long long scratch_words, unsigned e0,
                                       unsigned e1, unsigned e2, unsigned e3,
                                       int kind, long long n, void* stream) {
  const unsigned epochs[kPasses] = {e0, e1, e2, e3};
  return sort_any<true>(keys, vals, out, vout, tmp, vtmp, counts, scratch,
                        scratch_words, epochs, kind, n, stream);
}
