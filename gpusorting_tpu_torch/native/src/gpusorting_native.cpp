// Host runtime in C++ for gpusorting_tpu_torch, built with g++ at first use
// (gpusorting_tpu_torch/native/__init__.py) and called over a plain C ABI
// with ctypes.
//
// Port of gpusorting_tpu/native/src/gpusorting_native.cpp, the equivalent
// of the reference's C++ host framework (GPUSortingD3D12/GPUSortBase.h,
// Utils.h, UtilityKernels.h):
//
//   * the hybrid Tausworthe-LCG PRNG fill with Thearling-Smith entropy
//     reduction, bit-exact with core/prng.py's hybrid_taus_bits
//     (reference: Shaders/Utility.hlsl:57-117, UtilityKernels.cuh:53-117)
//   * O(n) order and pair-stability validators for large-array oracle
//     checks without a host sort (reference: Utility.hlsl:147-231 Validate)
//   * an LSD radix sort (keys, pairs) as a host reference oracle, the role
//     CUB plays for the reference (CubDispatcher.cuh)
//
// Threading: OpenMP where the compiler has it.

#include <cstddef>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// PRNG (bit-exact mirror of core/prng.py)
// ---------------------------------------------------------------------------

static inline uint32_t taus_step(uint32_t z, int s1, int s2, int s3,
                                 uint32_t m) {
  uint32_t b = ((z << s1) ^ z) >> s2;
  return ((z & m) << s3) ^ b;
}

static inline uint32_t hybrid_draw(uint32_t* z) {
  z[0] = taus_step(z[0], 13, 19, 12, 4294967294u);
  z[1] = taus_step(z[1], 2, 25, 4, 4294967288u);
  z[2] = taus_step(z[2], 3, 11, 17, 4294967280u);
  z[3] = z[3] * 1664525u + 1013904223u;
  return z[0] ^ z[1] ^ z[2] ^ z[3];
}

// out[i] = AND of (and_count+1) draws from the per-element stream, after
// `warmup` discarded draws; seeding matches prng.hybrid_taus_bits exactly.
void hybrid_taus_fill(uint32_t* out, int64_t n, uint32_t seed, int and_count,
                      int warmup) {
  const uint32_t s = (seed << 1) | 1u;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; ++i) {
    const uint32_t idx = (uint32_t)i;
    uint32_t z[4] = {
        (idx * 4u + 0u) * s + 0x9E3779B9u,
        (idx * 4u + 1u) * s + 0x85EBCA6Bu,
        (idx * 4u + 2u) * s + 0xC2B2AE35u,
        (idx * 4u + 3u) * s + 0x27D4EB2Fu,
    };
    for (int w = 0; w < warmup; ++w) (void)hybrid_draw(z);
    uint32_t t = 0xFFFFFFFFu;
    for (int d = 0; d < and_count + 1; ++d) t &= hybrid_draw(z);
    out[i] = t;
  }
}

// ---------------------------------------------------------------------------
// Validators (reference: Utility.hlsl Validate, an adjacent-pair order
// check; the pairs form also checks payload order, which with payload ==
// key checks stability and the payload's permutation)
// ---------------------------------------------------------------------------

int64_t count_order_violations_u32(const uint32_t* keys, int64_t n,
                                   int descending) {
  int64_t errs = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) reduction(+ : errs)
#endif
  for (int64_t i = 1; i < n; ++i) {
    if (descending ? (keys[i - 1] < keys[i]) : (keys[i - 1] > keys[i]))
      ++errs;
  }
  return errs;
}

int64_t count_pair_violations_u32(const uint32_t* keys,
                                  const uint32_t* payload, int64_t n,
                                  int descending) {
  int64_t errs = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) reduction(+ : errs)
#endif
  for (int64_t i = 1; i < n; ++i) {
    bool bad = descending ? (keys[i - 1] < keys[i]) : (keys[i - 1] > keys[i]);
    bool badp = descending ? (payload[i - 1] < payload[i])
                           : (payload[i - 1] > payload[i]);
    if (bad || badp) ++errs;
  }
  return errs;
}

// Segmented order check: offsets are the seg_count exclusive-prefix starts;
// the last segment ends at n.
int64_t count_segmented_violations_u32(const uint32_t* keys,
                                       const uint32_t* offsets,
                                       int64_t seg_count, int64_t n) {
  int64_t errs = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64) reduction(+ : errs)
#endif
  for (int64_t s = 0; s < seg_count; ++s) {
    int64_t lo = offsets[s];
    int64_t hi = (s + 1 < seg_count) ? (int64_t)offsets[s + 1] : n;
    for (int64_t i = lo + 1; i < hi; ++i)
      if (keys[i - 1] > keys[i]) ++errs;
  }
  return errs;
}

// ---------------------------------------------------------------------------
// Host LSD radix sort (8-bit digits x 4 passes), stable.
// ---------------------------------------------------------------------------

void lsd_radix_sort_u32(uint32_t* keys, int64_t n) {
  std::vector<uint32_t> tmp((size_t)n);
  uint32_t* src = keys;
  uint32_t* dst = tmp.data();
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = pass * 8;
    int64_t hist[257] = {0};
    for (int64_t i = 0; i < n; ++i) ++hist[((src[i] >> shift) & 255u) + 1];
    for (int d = 0; d < 256; ++d) hist[d + 1] += hist[d];
    for (int64_t i = 0; i < n; ++i)
      dst[hist[(src[i] >> shift) & 255u]++] = src[i];
    uint32_t* t = src;
    src = dst;
    dst = t;
  }
  // 4 passes, an even number of swaps: the result is back in keys
}

void lsd_radix_sort_pairs_u32(uint32_t* keys, uint32_t* payload, int64_t n) {
  std::vector<uint32_t> tk((size_t)n), tv((size_t)n);
  uint32_t* sk = keys;
  uint32_t* sv = payload;
  uint32_t* dk = tk.data();
  uint32_t* dv = tv.data();
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = pass * 8;
    int64_t hist[257] = {0};
    for (int64_t i = 0; i < n; ++i) ++hist[((sk[i] >> shift) & 255u) + 1];
    for (int d = 0; d < 256; ++d) hist[d + 1] += hist[d];
    for (int64_t i = 0; i < n; ++i) {
      int64_t p = hist[(sk[i] >> shift) & 255u]++;
      dk[p] = sk[i];
      dv[p] = sv[i];
    }
    uint32_t* t;
    t = sk; sk = dk; dk = t;
    t = sv; sv = dv; dv = t;
  }
}

int native_abi_version() { return 1; }

}  // extern "C"
