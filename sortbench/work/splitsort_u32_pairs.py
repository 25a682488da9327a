"""Bytes one call of splitsort_u32_pairs must move: each input byte read
once and each output byte written once, whatever the implementation reads
again.

pairs: u32 keys and u32 payloads in and out, 16 bytes a key, and the int32
segment offsets read, 4 bytes a segment; keys only: 8 bytes a key and the
offsets.
"""

_PER_KEY = {"keys": 8, "pairs": 16}


def bytes_per_call(mode: str, n: int, seg_count: int) -> int:
    return _PER_KEY[mode] * n + 4 * seg_count
