"""The benchmark's inputs: frozen copies of the reference's generators and
the pool of inputs one run cycles through.

The generators are copies, in plain torch and numpy, of the port's
`core/prng.py` `hybrid_taus_bits` and `make_random_segments`, kept here so
that a change to the program cannot change the data it is judged on.  A
CPU test holds them bit for bit against the port's at small sizes.

  - keys: the reference's hybrid Tausworthe generator with the
    Thearling-Smith entropy AND (Utility.hlsl:57-117,
    UtilityKernels.cuh:53-117): per element four lanes seeded from the
    slot and the seed, three Tausworthe steps and one LCG XORed per draw,
    (and_count + 1) draws ANDed.  u32 values are carried in int64 and
    masked back to 32 bits after every shift and product.
  - segment lengths: uniform in [1, max_len] under a global budget, the
    last one cut to fill it (UtilityKernels.cuh:340-400), drawn from
    `numpy.random.RandomState(seed)` in batches.
  - Zipf keys (`"keys": "zipf"` in a traffic file): the distribution of
    `numpy.random.zipf(exponent)` clipped to [1, max_key], drawn by
    inverse CDF from the same generator's u32 draws.  The CDF's first
    2^20 steps are integer thresholds on the draws, worked out once on
    the host, so the common keys are exact on any device; the rest come
    from the tail's closed form (Euler-Maclaurin), in float64.

A traffic file (traffic/<name>.json) gives the sizes; `make_pool` draws
`pool` distinct inputs from the run's seed, input j from seed + j as the
reference's harness regenerates input i from seed i + seed.  Over several
ranks, input j is one global array drawn from seed + j: rank r holds its
positions r*n .. (r+1)*n - 1, keys drawn at those slots, and a payload
that is each element's global position.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

M32 = 0xFFFFFFFF
_CHUNK = 1 << 22

ENTROPY_AND_COUNT = {"E100": 0, "E081": 1, "E054": 2, "E033": 3, "E020": 4}

KEY_DTYPES = {"uint32": torch.uint32, "int32": torch.int32,
              "float32": torch.float32}
PAYLOAD_DTYPES = {"uint32": torch.uint32, "int32": torch.int32,
                  "uint64": torch.uint64, "int64": torch.int64}


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for u32 values a (int64) and a u32 constant c,
    the constant split in 16-bit halves so no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & M32


def _taus_step(z, s1, s2, s3, m):
    b = (((z << s1) & M32) ^ z) >> s2
    return (((z & m) << s3) & M32) ^ b


def _draw(z1, z2, z3, z4):
    z1 = _taus_step(z1, 13, 19, 12, 4294967294)
    z2 = _taus_step(z2, 2, 25, 4, 4294967288)
    z3 = _taus_step(z3, 3, 11, 17, 4294967280)
    z4 = (z4 * 1664525 + 1013904223) & M32
    return z1 ^ z2 ^ z3 ^ z4, (z1, z2, z3, z4)


def _to_int32(t: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 values -> int32 with the same low 32 bits."""
    return (((t & M32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def hybrid_taus_bits(n: int, seed: int, and_count: int = 0, warmup: int = 2,
                     device: torch.device | str = "cuda",
                     first: int = 0) -> torch.Tensor:
    """n u32 draws (a torch.uint32 tensor on `device`), those of the slots
    first .. first + n - 1."""
    s = int((np.uint32(seed & M32) << np.uint32(1)) | np.uint32(1))
    out = torch.empty((n,), dtype=torch.int32, device=device)
    for start in range(0, n, _CHUNK):
        count = min(_CHUNK, n - start)
        idx = torch.arange(first + start, first + start + count,
                           dtype=torch.int64, device=device)
        state = tuple(
            (_mul_u32((idx * 4 + k) & M32, s) + c) & M32
            for k, c in enumerate((0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35,
                                   0x27D4EB2F)))
        for _ in range(warmup):
            _, state = _draw(*state)
        t = None
        for _ in range(and_count + 1):
            v, state = _draw(*state)
            t = v if t is None else t & v
        out[start:start + count] = _to_int32(t)
    return out.view(torch.uint32)


ZIPF_TABLE = 1 << 20     # keys 1 .. ZIPF_TABLE by integer thresholds


def _zeta_tail(s: float, k: int) -> float:
    """sum_{i > k} i^-s by Euler-Maclaurin (exact to float64 for k of
    2^20)."""
    return (k ** (1 - s) / (s - 1) - k ** -s / 2 + s * k ** (-s - 1) / 12
            - s * (s + 1) * (s + 2) * k ** (-s - 3) / 720)


@functools.cache
def zipf_thresholds(s: float) -> tuple[np.ndarray, float]:
    """(c, zeta): c[k - 1] = the least u32 draw b with (b + 0.5) / 2^32 >
    P(K <= k) for Zipf(s), k = 1 .. ZIPF_TABLE, so K = 1 + #{c <= b}
    while b < c[-1]; zeta = zeta(s)."""
    terms = np.arange(1, ZIPF_TABLE + 1, dtype=np.float64) ** -s
    head = np.cumsum(terms)
    zeta = float(head[-1]) + _zeta_tail(s, ZIPF_TABLE)
    c = np.floor(head / zeta * 2.0 ** 32 - 0.5).astype(np.int64) + 1
    return c, zeta


def zipf_keys(n: int, seed: int, exponent: float, max_key: int,
              device: torch.device | str = "cuda",
              first: int = 0) -> torch.Tensor:
    """n Zipf(exponent) keys clipped to [1, max_key] (a torch.uint32
    tensor), those of the slots first .. first + n - 1: each the inverse
    CDF of the slot's u32 draw b, at u = (b + 0.5) / 2^32."""
    c, zeta = zipf_thresholds(float(exponent))
    table = torch.from_numpy(c).to(device)
    bits = hybrid_taus_bits(n, seed, device=device, first=first)
    out = torch.empty((n,), dtype=torch.int32, device=device)
    for start in range(0, n, _CHUNK):
        b = bits[start:start + _CHUNK].view(torch.int32).to(torch.int64) & M32
        key = torch.searchsorted(table, b, right=True) + 1
        # past the table: the least k with P(K > k) <= 1 - u, where
        # P(K > k) = (k + 1/2)^(1 - s) / ((s - 1) zeta) to float64
        surv = (2.0 ** 32 - 0.5 - b.to(torch.float64)) / 2.0 ** 32
        x = (surv * (zeta * (exponent - 1))) ** (-1.0 / (exponent - 1))
        tail = torch.ceil(x - 0.5).clamp_(ZIPF_TABLE + 1, 2.0 ** 32)
        key = torch.where(key > ZIPF_TABLE, tail.to(torch.int64), key)
        out[start:start + key.shape[0]] = key.clamp_(1, max_key).to(
            torch.int32)
    return out.view(torch.uint32)


def random_segment_starts(total: int, max_len: int, seed: int) -> np.ndarray:
    """Exclusive-prefix starts (int64) of random lengths in [1, max_len]
    that fill `total` exactly; one RandomState draw at a time gives the
    same lengths as the batches drawn here."""
    rng = np.random.RandomState(np.uint32(seed & M32))
    lens, used = [], 0
    while used < total:
        batch = 2 * (total - used) // (max_len + 1) + 64
        drawn = rng.randint(1, max_len + 1, size=batch)
        ends = used + np.cumsum(drawn)
        k = int(np.searchsorted(ends, total, side="left"))
        if k < batch:                       # the budget fills at draw k
            drawn = drawn[:k + 1].copy()
            drawn[k] -= int(ends[k]) - total
        lens.append(drawn)
        used += int(drawn.sum())
    lens = np.concatenate(lens) if lens else np.zeros(0, np.int64)
    starts = np.zeros(len(lens), dtype=np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    return starts


@dataclasses.dataclass
class Input:
    """One input of the pool, on the device, and what the reference and the
    work count need of it."""

    keys: torch.Tensor
    values: torch.Tensor | None = None
    offsets: torch.Tensor | None = None     # int32 exclusive starts
    starts: np.ndarray | None = None         # the same starts, host int64

    @property
    def n(self) -> int:
        return int(self.keys.shape[0])

    @property
    def seg_count(self) -> int:
        return 0 if self.starts is None else int(self.starts.shape[0])


def make_input(config: dict, traffic: dict, seed: int,
               device: torch.device, rank: int = 0) -> Input:
    """One input drawn from `seed`: keys (masked to `key_bits`), the
    layout's segments, and an index payload (each value its element's
    position, so a swapped or unstable pair shows) where the mode has
    values.  Rank r's input is positions r*n .. (r+1)*n - 1 of the global
    array of that seed: its keys are drawn at those slots and its payload
    is each element's global position."""
    n = int(traffic["n"])
    first = rank * n
    if traffic.get("keys") == "zipf":
        bits = zipf_keys(n, seed, float(traffic["exponent"]),
                         int(traffic["max_key"]), device=device, first=first)
    else:
        bits = hybrid_taus_bits(n, seed,
                                ENTROPY_AND_COUNT[traffic["entropy"]],
                                device=device, first=first)
    key_bits = int(traffic.get("key_bits", 32))
    if key_bits < 32:
        bits = (bits.view(torch.int32) & ((1 << key_bits) - 1)).view(
            torch.uint32)
    inp = Input(keys=bits.view(KEY_DTYPES[config["key_dtype"]]))
    if traffic["mode"] == "pairs":
        vdt = PAYLOAD_DTYPES[config["payload_dtype"]]
        carrier = torch.int64 if vdt.itemsize == 8 else torch.int32
        inp.values = torch.arange(first, first + n, dtype=carrier,
                                  device=device).view(vdt)
    layout = traffic["layout"]
    if layout == "flat":
        return inp
    if layout == "random_segments":
        starts = random_segment_starts(n, int(traffic["max_len"]), seed)
    elif layout == "fixed_segments":
        L = int(traffic["seg_len"])
        starts = np.arange(n // L, dtype=np.int64) * L
    else:
        raise ValueError(f"unknown layout {layout!r}")
    inp.starts = starts
    inp.offsets = torch.from_numpy(starts.astype(np.int32)).to(device)
    return inp


def make_pool(config: dict, traffic: dict, seed: int,
              device: torch.device, rank: int = 0) -> list[Input]:
    """`traffic["pool"]` distinct inputs, input j from seed + j (rank
    `rank`'s part of it)."""
    return [make_input(config, traffic, (seed + j) & M32, device, rank)
            for j in range(int(traffic["pool"]))]
