"""A plain segmented pair sort in plain PyTorch: a second oracle for the
segmented configurations, beside the numpy judge (reference.py).

It imports neither JAX nor the program, and runs on the CPU or on a card.
Within each segment the pairs are ordered by their u32 key, ties kept in
input order (stable), by a method unlike the program's single composite
sort: two stable `torch.sort`s composed, least significant key first (LSD
over two keys).  The first orders every element by its key; the second
orders that sequence by segment id, and being stable it keeps the key
order inside each segment.

Keys are u32 (any 4-byte dtype holding their bits); payloads are moved by
their bits and come back in their own dtype.  Segments are int64
exclusive starts, the first 0, as the benchmark's layouts draw them.
`sort_pairs_blocked` cuts the buffer into blocks of whole segments, so
that 2^26 pairs fit a card's memory beside the program's.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def _carrier(t: torch.Tensor) -> torch.Tensor:
    """A signed view of the same bits, which every device can index."""
    return t.view({4: torch.int32, 8: torch.int64}[t.dtype.itemsize])


def sort_pairs(key_bits: torch.Tensor, values: torch.Tensor,
               starts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(keys, values) with every segment sorted stably by its u32 keys."""
    n = key_bits.shape[0]
    key = _carrier(key_bits).to(torch.int64) & M32
    by_key = torch.sort(key, stable=True).indices
    first = starts.to(torch.int64)
    lens = torch.diff(first, append=first.new_tensor([n]))
    seg = torch.repeat_interleave(
        torch.arange(first.shape[0], device=key.device), lens)
    perm = by_key[torch.sort(seg[by_key], stable=True).indices]
    return (_carrier(key_bits)[perm].view(key_bits.dtype),
            _carrier(values)[perm].view(values.dtype))


def block_bounds(starts: np.ndarray, n: int, block: int) -> list[int]:
    """Cuts 0 = b_0 < b_1 < ... = n at segment starts, each block at most
    `block` elements long, a segment longer than that alone."""
    bounds = [0]
    while bounds[-1] < n:
        a = bounds[-1]
        if n - a <= block:
            bounds.append(n)
            break
        j = int(np.searchsorted(starts, a + block, side="right")) - 1
        b = int(starts[j])
        if b <= a:               # the segment at a runs past a + block
            b = int(starts[j + 1]) if j + 1 < starts.shape[0] else n
        bounds.append(b)
    return bounds


def sort_pairs_blocked(key_bits: torch.Tensor, values: torch.Tensor,
                       starts: np.ndarray, block: int = 1 << 24
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """`sort_pairs` a block of whole segments at a time (`starts` on the
    host, int64); the blocks' results joined."""
    n = key_bits.shape[0]
    keys_out, values_out = [], []
    bounds = block_bounds(starts, n, block)
    for a, b in zip(bounds[:-1], bounds[1:]):
        lo, hi = np.searchsorted(starts, [a, b], side="left")
        local = torch.from_numpy(starts[lo:hi] - a).to(key_bits.device)
        k, v = sort_pairs(key_bits[a:b], values[a:b], local)
        keys_out.append(_carrier(k))
        values_out.append(_carrier(v))
    return (torch.cat(keys_out).view(key_bits.dtype),
            torch.cat(values_out).view(values.dtype))
