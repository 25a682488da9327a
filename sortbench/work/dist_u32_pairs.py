"""Bytes one rank's part of a call of dist_u32_pairs must move: its u32
keys and u32 payloads read once, and as many pairs of the sorted result
written once, 16 bytes a key, whatever the exchange and the merge move
between and on the cards.
"""

_PER_KEY = {"pairs": 16}


def bytes_per_call(mode: str, n: int, seg_count: int) -> int:
    return _PER_KEY[mode] * n
