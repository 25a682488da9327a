"""Test-input generators: hybrid Tausworthe PRNG + Thearling–Smith entropy.

Port of `gpusorting_tpu/core/prng.py:28-111`, bit-exact with it for the same
(n, seed, and_count) (reference: Shaders/Utility.hlsl:57-117; CUDA
UtilityKernels.cuh:53-117):
  - per element, four PRNG lanes are seeded from the element slot and the
    run seed: z_k = (slot*4 + k) * seed
  - each draw advances three Tausworthe generators and one LCG and XORs
    them (GPU Gems 3 ch. 37, Lee Howes & David Thomas)
  - entropy reduction ANDs (and_count + 1) successive draws.

torch has no usable uint32 arithmetic, so the lanes are int64 tensors that
hold u32 values: every shift and product is masked back to 32 bits, and
products with a 32-bit constant are split in 16-bit halves so that no
intermediate leaves int64's range.  Generation runs in chunks to bound the
int64 temporaries.

The functions here create data: they take `device=` (default "cuda") and
raise where that device is a CUDA card torch cannot see.  The segmented
fixtures (prng.py:115-161 of the JAX package) return offsets as an int32
tensor on the device with the segment count as an int; the segment
lengths come from the same numpy draws as JAX's, so the offsets are
bit-exact with its.
"""

from __future__ import annotations

import numpy as np
import torch

from . import codec
from .config import EntropyPreset

_M32 = 0xFFFFFFFF
_CHUNK = 1 << 22


def require_device(device: torch.device | str) -> torch.device:
    """The device as given; raises for a CUDA device when torch sees no
    card (data is never made on the CPU in its place)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False")
    return dev


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for u32 values a (int64) and a u32 constant c."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _taus_step(z, s1, s2, s3, m):
    b = (((z << s1) & _M32) ^ z) >> s2
    return (((z & m) << s3) & _M32) ^ b


def _hybrid_taus_draw(z1, z2, z3, z4):
    """One draw: advance all four lanes, return (value, new state)."""
    z1 = _taus_step(z1, 13, 19, 12, 4294967294)
    z2 = _taus_step(z2, 2, 25, 4, 4294967288)
    z3 = _taus_step(z3, 3, 11, 17, 4294967280)
    z4 = (z4 * 1664525 + 1013904223) & _M32
    return z1 ^ z2 ^ z3 ^ z4, (z1, z2, z3, z4)


def _taus_chunk(start: int, count: int, seed: int, and_count: int,
                warmup: int, device: torch.device) -> torch.Tensor:
    idx = torch.arange(start, start + count, dtype=torch.int64,
                       device=device)
    state = tuple(
        (_mul_u32((idx * 4 + k) & _M32, seed) + c) & _M32
        for k, c in enumerate((0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35,
                               0x27D4EB2F)))
    for _ in range(warmup):
        _, state = _hybrid_taus_draw(*state)
    t = None
    for _ in range(and_count + 1):
        v, state = _hybrid_taus_draw(*state)
        t = v if t is None else t & v
    return codec.wrap_int32(t)


def hybrid_taus_bits(n: int, seed: int, and_count: int = 0, warmup: int = 2,
                     device: torch.device | str = "cuda") -> torch.Tensor:
    """n uint32 values with the given entropy reduction (torch.uint32).

    ``warmup`` extra draws decorrelate the affine seeding.
    """
    dev = require_device(device)
    # (seed << 1) | 1 is odd and injective on 31 bits, so nearby seeds
    # (the reference uses seed = i + baseSeed per iteration) stay distinct
    s = int((np.uint32(seed) << np.uint32(1)) | np.uint32(1))
    out = torch.empty((n,), dtype=torch.int32, device=dev)
    for start in range(0, n, _CHUNK):
        count = min(_CHUNK, n - start)
        out[start:start + count] = _taus_chunk(start, count, s, and_count,
                                               warmup, dev)
    return out.view(torch.uint32)


def make_test_keys(n: int, seed: int, key_dtype: torch.dtype = torch.uint32,
                   entropy: EntropyPreset = EntropyPreset.E100,
                   device: torch.device | str = "cuda") -> torch.Tensor:
    """InitSortInput analog (Utility.hlsl:82-117): random bits as keys."""
    return hybrid_taus_bits(n, seed, entropy.and_count,
                            device=device).view(key_dtype)


def make_test_pairs(n: int, seed: int, key_dtype: torch.dtype = torch.uint32,
                    payload_dtype: torch.dtype = torch.uint32,
                    entropy: EntropyPreset = EntropyPreset.E100,
                    device: torch.device | str = "cuda"):
    """Keys plus a payload with the same bit pattern — the reference's
    stability oracle (Utility.hlsl:147-231, pairs branch).  A 64-bit
    payload holds the key's u32 bits as its value."""
    bits = hybrid_taus_bits(n, seed, entropy.and_count, device=device)
    keys = bits.view(key_dtype)
    if payload_dtype.itemsize == 8:
        wide = bits.view(torch.int32).to(torch.int64) & _M32
        if payload_dtype == torch.float64:
            return keys, wide.to(torch.float64)
        return keys, wide.view(payload_dtype)
    return keys, bits.view(payload_dtype)


def make_descending_keys(n: int, dtype: torch.dtype = torch.uint32,
                         device: torch.device | str = "cuda"
                         ) -> torch.Tensor:
    """InitDescending analog (UtilityKernels.cuh:36-40): n-1, n-2, ..., 0."""
    dev = require_device(device)
    t = (n - 1 - torch.arange(n, dtype=torch.int64, device=dev)) & _M32
    return codec.wrap_int32(t).view(dtype)


# ---- segmented-sort fixtures (UtilityKernels.cuh:121-400) -----------------


def _offsets(starts: np.ndarray, device: torch.device) -> torch.Tensor:
    """int64 segment starts -> the int32 offsets tensor (u32 bits)."""
    return codec.wrap_int32(torch.from_numpy(starts.astype(np.int64))).to(
        device)


def make_fixed_segments(total_length: int, seg_length: int,
                        device: torch.device | str = "cuda"):
    """Equal-length segments covering total_length (UtilityKernels.cuh
    :121-135): (offsets, seg_count), offsets the exclusive-prefix starts."""
    if seg_length <= 0:
        raise ValueError("seg_length must be positive")
    dev = require_device(device)
    seg_count = max(1, total_length // seg_length)
    starts = np.arange(seg_count, dtype=np.int64) * seg_length
    return _offsets(starts, dev), seg_count


def make_random_segments(total_length: int, max_seg_length: int, seed: int,
                         device: torch.device | str = "cuda"):
    """Random segment lengths in [1, max_seg_length] under a global budget
    (UtilityKernels.cuh:340-400), the last one cut to fill it exactly.

    The JAX package draws one `randint` at a time from
    `RandomState(uint32(seed))`; a draw of many at once gives the same
    sequence, so the lengths are drawn in batches and cut where the budget
    fills (draws past that point are discarded with the generator)."""
    dev = require_device(device)
    rng = np.random.RandomState(np.uint32(seed))
    lens, used = [], 0
    while used < total_length:
        batch = 2 * (total_length - used) // (max_seg_length + 1) + 64
        drawn = rng.randint(1, max_seg_length + 1, size=batch)
        ends = used + np.cumsum(drawn)
        k = int(np.searchsorted(ends, total_length, side="left"))
        if k < batch:                       # the budget fills at draw k
            drawn = drawn[:k + 1].copy()
            drawn[k] -= int(ends[k]) - total_length
        lens.append(drawn)
        used += int(drawn.sum())
    lens = np.concatenate(lens) if lens else np.zeros(0, np.int64)
    starts = np.zeros(len(lens), dtype=np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    return _offsets(starts & _M32, dev), len(lens)


def make_masked_random_values(n: int, bits_to_sort: int, seed: int,
                              device: torch.device | str = "cuda"
                              ) -> torch.Tensor:
    """Random u32 keys masked to bits_to_sort bits (UtilityKernels.cuh
    :170-248), torch.uint32."""
    bits = hybrid_taus_bits(n, seed, device=device)
    if bits_to_sort >= 32:
        return bits
    return (bits.view(torch.int32) & ((1 << bits_to_sort) - 1)).view(
        torch.uint32)


def make_unique_shuffled(n: int, seed: int,
                         device: torch.device | str = "cuda"
                         ) -> torch.Tensor:
    """A shuffle of 0..n-1 (UtilityKernels.cuh:251-324 unique-value
    fixtures), torch.uint32.  `torch.randperm` under a CPU generator seeded
    from `seed`: the same on every device, but not the JAX package's
    `jax.random.permutation` order."""
    dev = require_device(device)
    g = torch.Generator().manual_seed(seed)
    perm = torch.randperm(n, generator=g).to(torch.int32)
    return perm.to(dev).view(torch.uint32)
