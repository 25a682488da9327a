"""A plain per-row sort of f32 keys with a payload, in plain PyTorch: the
second oracle of the sampler's configuration (rows of logits and their
indices), beside the numpy judge (reference.py).

It imports neither JAX nor the program, and runs on the CPU or on a card.
Each key is ordered by its f32 code, worked out from its bits: every bit
flipped where the sign bit is set, else the sign bit set.  That is the
order `reference.codes` states, so -0.0 comes before +0.0, NaNs with the
sign set come before -inf, NaNs without it after +inf, each group ordered
by its bits (`torch.sort` on floats puts every NaN last).  Within each row
the pairs are ordered stably by that code, by a method unlike the
program's batched row sort: one stable `torch.sort` of the flat int64 key
(row << 32 | code), the payload moved by its bits.

Rows are int64 exclusive starts, the first 0, as the benchmark's layouts
draw them, and may differ in length.  `sort_rows_blocked` sorts a block of
whole rows at a time, so that 33M pairs fit a card's memory beside the
program's.
"""

from __future__ import annotations

import numpy as np
import torch

from sortbench.plain_segsort import _carrier, block_bounds

M32 = 0xFFFFFFFF


def f32_codes(key_bits: torch.Tensor) -> torch.Tensor:
    """The u32 codes (as int64) whose unsigned order is the f32 order of
    keys given by their bits (any 4-byte dtype)."""
    b = _carrier(key_bits).to(torch.int64) & M32
    return torch.where(b >> 31 != 0, b ^ M32, b | 0x80000000)


def sort_rows(key_bits: torch.Tensor, values: torch.Tensor,
              starts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(keys, values) with every row sorted stably by its keys' f32
    codes."""
    n = key_bits.shape[0]
    first = starts.to(torch.int64)
    lens = torch.diff(first, append=first.new_tensor([n]))
    row = torch.repeat_interleave(
        torch.arange(first.shape[0], device=key_bits.device), lens)
    perm = torch.sort((row << 32) | f32_codes(key_bits), stable=True).indices
    return (_carrier(key_bits)[perm].view(key_bits.dtype),
            _carrier(values)[perm].view(values.dtype))


def sort_rows_blocked(key_bits: torch.Tensor, values: torch.Tensor,
                      starts: np.ndarray, block: int = 1 << 24
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """`sort_rows` a block of whole rows at a time (`starts` on the host,
    int64); the blocks' results joined."""
    n = key_bits.shape[0]
    keys_out, values_out = [], []
    bounds = block_bounds(starts, n, block)
    for a, b in zip(bounds[:-1], bounds[1:]):
        lo, hi = np.searchsorted(starts, [a, b], side="left")
        local = torch.from_numpy(starts[lo:hi] - a).to(key_bits.device)
        k, v = sort_rows(key_bits[a:b], values[a:b], local)
        keys_out.append(_carrier(k))
        values_out.append(_carrier(v))
    return (torch.cat(keys_out).view(key_bits.dtype),
            torch.cat(values_out).view(values.dtype))
