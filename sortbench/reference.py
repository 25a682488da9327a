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
"""

from __future__ import annotations

import dataclasses

import numpy as np

CONTROL_SORT_BITS = 16

# Each number compared and its limit.  Every comparison is exact.
LIMITS = {"calls_checked": ("min", 1), "failed_calls": ("max", 0),
          "keys_wrong": ("max", 0), "values_wrong": ("max", 0),
          "perm_wrong": ("max", 0)}


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


def verdict(counts: dict[str, int]) -> tuple[bool, dict]:
    """(every limit held, {name: {"value", "min"|"max"}}) for the numbers
    a run compared."""
    ok, checks = True, {}
    for name, value in counts.items():
        side, limit = LIMITS[name]
        checks[name] = {"value": value, side: limit}
        ok &= value >= limit if side == "min" else value <= limit
    return ok, checks
