"""The segmented sort of 16-bit keys with 64-bit payloads
(SplitSortPairs<16, double>) against the plain PyTorch oracle
(sortbench/plain_segsort.py: two stable sorts composed, not the port's
composite), bit for bit, on the CPU with the H100's routing row
installed, so that the CPU takes the card's route: the composite, in its
one-u32-key branch while seg_bits + 16 <= 32 and its int64 branch past
that.  A float64 payload of NaNs, signed zeros and infinities gives the
bits of its uint64 pattern, and equal keys keep their input order.
"""

import numpy as np
import pytest
import torch

import gpusorting_tpu_torch as gstt
from gpusorting_tpu_torch.core import config
from gpusorting_tpu_torch.utils import trace
from sortbench import plain_segsort

# special float64 bit patterns: quiet and signalling NaNs with payloads,
# a negative NaN, -0.0, +0.0, +inf, -inf, the least subnormal
SPECIALS = np.array([0x7FF8000000000001, 0x7FF0000000000F00,
                     0xFFF8000000000000, 0x8000000000000000, 0,
                     0x7FF0000000000000, 0xFFF0000000000000, 1],
                    dtype=np.uint64)


@pytest.fixture
def h100_row():
    config.set_routing_override(config._ROUTING_TABLE["h100"])
    yield
    config.clear_routing_override()


def _layout(seg_count, max_len, seed):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, max_len + 1, size=seg_count)
    starts = np.zeros(seg_count, np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    n = int(lens.sum())
    # half the keys from 8 values across the 16 bits, so segments tie
    keys = rng.randint(0, 1 << 16, size=n)
    few = rng.rand(n) < 0.5
    keys[few] = rng.choice([0, 1, 0x00FF, 0x0100, 0x7FFF, 0x8000, 0xFFFE,
                            0xFFFF], size=int(few.sum()))
    return starts, torch.from_numpy(keys.astype(np.int32)).view(torch.uint32)


def _bits(t):
    return t.view(torch.int64 if t.dtype.itemsize == 8 else torch.int32)


# (segment count, longest segment, the branch: seg_bits + 16 is 31, 32, 33)
CASES = [(10000, 6, "u32"), (20000, 4, "u32"), (40000, 3, "i64")]


@pytest.mark.parametrize("seg_count,max_len,branch", CASES,
                         ids=[f"{s}_segments" for s, _, _ in CASES])
def test_bounded_bits_wide_payloads_match_the_plain_sort(
        h100_row, seg_count, max_len, branch):
    starts, keys = _layout(seg_count, max_len, seg_count)
    n = keys.shape[0]
    offs = torch.from_numpy(starts.astype(np.int32))
    index = torch.arange(n, dtype=torch.int64).view(torch.uint64)

    def call(values):
        return gstt.split_sort_pairs(offs, keys, values, seg_count, n,
                                     bits_to_sort=16)
    trace.reset()
    k, v = call(index)
    got = trace.counts()
    other = {"u32": "i64", "i64": "u32"}[branch]
    assert got["engine.composite"] == got[f"composite.{branch}"] == 1
    assert got.get(f"composite.{other}", 0) == 0
    assert got["payload.split"] == got["payload.join"] == 1
    pk, pv = plain_segsort.sort_pairs(keys, index, torch.from_numpy(starts))
    assert torch.equal(_bits(k), _bits(pk))
    assert torch.equal(_bits(v), _bits(pv))
    # equal keys of a segment keep their input order
    seg = np.repeat(np.arange(seg_count), np.diff(np.append(starts, n)))
    kk, vv = _bits(k).numpy(), _bits(v).numpy()
    tie = (kk[:-1] == kk[1:]) & (seg[:-1] == seg[1:])
    assert tie.any() and (vv[:-1][tie] < vv[1:][tie]).all()
    # a float64 payload moves as its bits, whatever they are
    pattern = np.arange(n, dtype=np.float64).view(np.uint64).copy()
    pattern[::97] = SPECIALS[np.arange(pattern[::97].shape[0])
                             % SPECIALS.shape[0]]
    as_u64 = torch.from_numpy(pattern.view(np.int64)).view(torch.uint64)
    as_f64 = torch.from_numpy(pattern.view(np.float64))
    k64, v64 = call(as_f64)
    ku, vu = call(as_u64)
    assert v64.dtype == torch.float64 and vu.dtype == torch.uint64
    assert torch.equal(_bits(k64), _bits(k)) and torch.equal(_bits(ku),
                                                             _bits(k))
    assert torch.equal(_bits(v64), _bits(vu))
    _, pu = plain_segsort.sort_pairs(keys, as_u64, torch.from_numpy(starts))
    assert torch.equal(_bits(vu), _bits(pu))
