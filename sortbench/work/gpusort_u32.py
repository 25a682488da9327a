"""Bytes one call of gpusort_u32 must move: each input byte read once and
each output byte written once, whatever the implementation reads again.

keys: u32 keys in and out, 8 bytes a key; pairs: a u32 payload too, 16;
argsort: keys in and an int32 permutation out, 8.
"""

_PER_KEY = {"keys": 8, "pairs": 16, "argsort": 8}


def bytes_per_call(mode: str, n: int, seg_count: int) -> int:
    return _PER_KEY[mode] * n
