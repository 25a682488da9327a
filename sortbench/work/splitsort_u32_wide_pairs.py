"""Bytes one call of splitsort_u32_wide_pairs must move: each input byte
read once and each output byte written once, whatever the implementation
reads again.

pairs: u32 keys and 64-bit payloads in and out, 24 bytes a key, and the
int32 segment offsets read, 4 bytes a segment.
"""

_PER_KEY = {"pairs": 24}


def bytes_per_call(mode: str, n: int, seg_count: int) -> int:
    return _PER_KEY[mode] * n + 4 * seg_count
