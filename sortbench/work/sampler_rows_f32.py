"""Bytes one call of sampler_rows_f32 must move: each input byte read once
and each output byte written once, whatever the implementation reads
again.

pairs: f32 keys and u32 indices in and out, 16 bytes a pair, and the int32
row offsets read, 4 bytes a row; keys only: 8 bytes a key and the offsets.
"""

_PER_KEY = {"keys": 8, "pairs": 16}


def bytes_per_call(mode: str, n: int, seg_count: int) -> int:
    return _PER_KEY[mode] * n + 4 * seg_count
