"""The plain reference that decides `correct`, in numpy on the host.

It imports nothing of the program and takes nothing the program made: the
keys, payloads and segment starts are the benchmark's own (inputs.py), and
the program's outputs are read only to be judged.

Every configuration shares one meaning: within each segment (the whole
buffer when there are none) the elements are ordered by their key's u32
code, ties kept in input order (stable), and descending is the reverse of
the stable ascending result.  The codes are the reference's order-keeping
bijections (SortCommon.hlsl, Herf's radix tricks): u32 as is, i32 with the
sign bit flipped, f32 with every bit flipped when the sign is set and the
sign bit set otherwise.  The stable order is one numpy sort of a unique
u64 composite (segment, code, position in segment), so no stable argsort
is needed.

The control breaks one guarantee each configuration states, that all 32
key bits are sorted: it orders by the top `sort_bits` = 16 bits, stably, as
a sort that skips its low digit passes would.

A distributed call (`judge_runs`) is judged in plain torch on whatever
device holds its runs, in blocks: 2^30 pairs take minutes in numpy on a
host.  Each rank's valid prefix, joined in rank order, must hold every
input pair once in the global stable order.  The payload is each
element's unique global position, so three O(n) checks say so without a
sort: the (code, payload) pairs strictly increase, each code is the
code of the input key at its payload's position, and the counts sum to
the input's length.  A pair out of order, a key that left its payload,
an element lost or doubled, and equal keys out of input order each
break one of them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

CONTROL_SORT_BITS = 16

# Each number compared and its limit.  Every comparison is exact.
LIMITS = {"calls_checked": ("min", 1), "failed_calls": ("max", 0),
          "keys_wrong": ("max", 0), "values_wrong": ("max", 0),
          "perm_wrong": ("max", 0),
          # a distributed call: the ranks' counts against the input's
          # length, and the elements the program reports it dropped
          "count_sum_off": ("max", 0), "overflow": ("max", 0)}

M32 = 0xFFFFFFFF


@dataclasses.dataclass
class HostInput:
    """An input as the reference sees it: raw bit patterns on the host."""

    key_bits: np.ndarray               # uint32
    key_dtype: str
    values: np.ndarray | None = None   # the payload's bits, uint32 or uint64
    starts: np.ndarray | None = None   # int64 exclusive segment starts


def codes(key_bits: np.ndarray, key_dtype: str) -> np.ndarray:
    """u32 codes whose unsigned order is the key type's order."""
    b = key_bits.astype(np.uint32, copy=False)
    if key_dtype == "uint32":
        return b
    if key_dtype == "int32":
        return b ^ np.uint32(0x80000000)
    if key_dtype == "float32":
        neg = (b >> np.uint32(31)).astype(bool)
        return np.where(neg, ~b, b | np.uint32(0x80000000))
    raise ValueError(f"unknown key dtype {key_dtype!r}")


def _bits_for(x: int) -> int:
    return max(1, int(x - 1).bit_length())


def stable_order(c: np.ndarray, starts: np.ndarray | None,
                 sort_bits: int = 32) -> np.ndarray:
    """The stable permutation (int64) that orders codes `c` by their top
    `sort_bits` bits within each segment."""
    n = c.shape[0]
    key = (c >> np.uint32(32 - sort_bits)).astype(np.uint64)
    if starts is None:
        first = np.zeros(n, dtype=np.int64)
        seg_bits, pos_bits = 0, _bits_for(n)
    else:
        lens = np.diff(np.append(starts, n))
        first = np.repeat(starts, lens)          # each element's segment start
        seg_bits = _bits_for(starts.shape[0])
        pos_bits = _bits_for(int(lens.max()) if lens.size else 1)
    pos = np.arange(n, dtype=np.int64)
    pos -= first
    if seg_bits + sort_bits + pos_bits > 64:
        raise ValueError("the (segment, key, position) composite needs more "
                         "than 64 bits")
    comp = key << np.uint64(pos_bits)
    comp |= pos.astype(np.uint64)
    if starts is not None:
        comp |= np.repeat(np.arange(starts.shape[0], dtype=np.uint64)
                          << np.uint64(sort_bits + pos_bits), lens)
    comp.sort()
    # segments keep their places, so element i's segment start is first[i]
    return first + (comp & np.uint64((1 << pos_bits) - 1)).astype(np.int64)


def expected(inp: HostInput, mode: str, descending: bool = False,
             sort_bits: int = 32) -> dict[str, np.ndarray]:
    """What a correct call returns, by output name: `keys` as codes,
    `values` as bits, `perm` as int64."""
    c = codes(inp.key_bits, inp.key_dtype)
    if mode == "keys" and sort_bits == 32 and inp.starts is None:
        out = {"keys": np.sort(c)}
    else:
        perm = stable_order(c, inp.starts, sort_bits)
        out = {"keys": c[perm]}
        if mode == "pairs":
            out["values"] = inp.values[perm]
        elif mode == "argsort":
            out = {"perm": perm}
    if descending:
        out = {k: v[::-1] for k, v in out.items()}
    return out


def judge(out: dict[str, np.ndarray], inp: HostInput,
          exp: dict[str, np.ndarray]) -> dict[str, int]:
    """Positions wrong in each output: the program's outputs (raw bits,
    `perm` as integers) against `expected`."""
    counts = {}
    for name, want in exp.items():
        got = out.get(name)
        if name == "keys" and got is not None:
            got = codes(got, inp.key_dtype)
        if got is None or got.shape != want.shape:
            counts[f"{name}_wrong"] = int(want.shape[0])
            continue
        if name == "perm":
            got = got.astype(np.int64)
        counts[f"{name}_wrong"] = int(np.count_nonzero(got != want))
    return counts


def control(inp: HostInput, mode: str, descending: bool = False
            ) -> dict[str, np.ndarray]:
    """The control's outputs: the reference at `CONTROL_SORT_BITS` key bits,
    keys returned as raw bits like the program's."""
    exp = expected(inp, mode, descending, CONTROL_SORT_BITS)
    if "keys" in exp:
        exp["keys"] = _bits_from_codes(exp["keys"], inp.key_dtype)
    return exp


def _bits_from_codes(c: np.ndarray, key_dtype: str) -> np.ndarray:
    if key_dtype == "uint32":
        return c
    if key_dtype == "int32":
        return c ^ np.uint32(0x80000000)
    neg = ~(c >> np.uint32(31)).astype(bool)
    return np.where(neg, ~c, c & np.uint32(0x7FFFFFFF))


def _u32(t: torch.Tensor) -> torch.Tensor:
    """u32 bits (any 4-byte dtype) -> int64 values 0 .. 2^32 - 1."""
    return t.view(torch.int32).to(torch.int64) & M32


def codes_of(bits: torch.Tensor, key_dtype: str) -> torch.Tensor:
    """`codes` in torch: int64 u32 values -> int64 codes."""
    if key_dtype == "uint32":
        return bits
    if key_dtype == "int32":
        return bits ^ 0x80000000
    if key_dtype == "float32":
        return torch.where(bits >> 31 != 0, bits ^ M32, bits | 0x80000000)
    raise ValueError(f"unknown key dtype {key_dtype!r}")


def judge_runs(codes: torch.Tensor, values: torch.Tensor, counts: list[int],
               held: list[int], overflow: int, in_keys: torch.Tensor,
               key_dtype: str, block: int = 1 << 26) -> dict[str, int]:
    """The numbers wrong in a distributed call.

    codes, values  the ranks' valid prefixes joined in rank order (u32
                   codes and payload bits, any 4-byte dtype)
    counts         each rank's `count`; held: the elements its blocks hold
                   of it (its count cut to the block's length)
    overflow       the elements the program says it dropped
    in_keys        the global input's key bits, position p at p; the
                   payload of the element at p is p"""
    n = in_keys.shape[0]
    m = codes.shape[0]
    in_bits = in_keys.view(torch.int32)   # the card indexes no uint32
    keys_wrong = values_wrong = 0
    for a in range(0, m, block):
        c = _u32(codes[a:a + block + 1])      # one past: the next pair
        v = _u32(values[a:a + block + 1])
        own = min(block, m - a)
        cv, vv = c[:own], v[:own]
        out = vv >= n
        want = codes_of(_u32(in_bits[vv.clamp(max=n - 1)]), key_dtype)
        keys_wrong += int(out.sum()) + int(((want != cv) & ~out).sum())
        keys_wrong += int((c[:-1] > c[1:]).sum())
        values_wrong += int(((c[:-1] == c[1:]) & (v[:-1] >= v[1:])).sum())
    return {"keys_wrong": keys_wrong, "values_wrong": values_wrong,
            "count_sum_off": abs(sum(counts) - n)
            + sum(c - h for c, h in zip(counts, held)),
            "overflow": int(overflow)}


def control_order(keys: torch.Tensor, key_dtype: str,
                  sort_bits: int = CONTROL_SORT_BITS,
                  block: int = 1 << 26) -> torch.Tensor:
    """The control of a distributed call: the permutation (int64) that
    puts the global input's key bits in their stable order by the top
    `sort_bits` bits of the codes, in plain torch."""
    top = torch.empty(keys.shape, dtype=torch.int32, device=keys.device)
    for a in range(0, keys.shape[0], block):
        top[a:a + block] = codes_of(_u32(keys[a:a + block]), key_dtype) >> (
            32 - sort_bits)
    return torch.sort(top, stable=True).indices


def tally(judged: list[dict[str, int]], failed: int):
    """(correct, checks, calls with a wrong number) of the judged calls
    and the calls that failed."""
    counts = {"calls_checked": len(judged), "failed_calls": failed}
    for wrong in judged:
        for name, v in wrong.items():
            counts[name] = counts.get(name, 0) + v
    correct, checks = verdict(counts)
    return correct, checks, sum(any(w.values()) for w in judged)


def verdict(counts: dict[str, int]) -> tuple[bool, dict]:
    """(every limit held, {name: {"value", "min"|"max"}}) for the numbers
    a run compared."""
    ok, checks = True, {}
    for name, value in counts.items():
        side, limit = LIMITS[name]
        checks[name] = {"value": value, side: limit}
        ok &= value >= limit if side == "min" else value <= limit
    return ok, checks
