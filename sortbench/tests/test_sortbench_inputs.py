"""The benchmark's frozen generators against the port's, bit for bit."""

import numpy as np
import pytest
import torch

from gpusorting_tpu_torch.core import config, prng
from sortbench import inputs


@pytest.mark.parametrize("n,seed,preset", [
    (1, 0, "E100"), (4099, 10, "E100"), (5000, 2**31 + 17, "E020"),
    (777, 4294967295, "E054"), ((1 << 22) + 5, 3, "E081")])
def test_keys_match_the_port(n, seed, preset):
    mine = inputs.hybrid_taus_bits(n, seed, inputs.ENTROPY_AND_COUNT[preset],
                                   device="cpu")
    theirs = prng.make_test_keys(n, seed & 0xFFFFFFFF, torch.uint32,
                                 config.EntropyPreset[preset], device="cpu")
    assert torch.equal(mine.view(torch.int32), theirs.view(torch.int32))


@pytest.mark.parametrize("total,max_len,seed", [
    (1000, 4, 1), (20000, 32, 7), (50000, 4096, 2**31 + 3), (4096, 4096, 0)])
def test_segments_match_the_port(total, max_len, seed):
    starts = inputs.random_segment_starts(total, max_len, seed)
    offs, count = prng.make_random_segments(total, max_len,
                                            seed & 0xFFFFFFFF, device="cpu")
    assert count == starts.shape[0]
    assert np.array_equal(offs.numpy().astype(np.int64), starts)
    lens = np.diff(np.append(starts, total))
    assert lens.min() >= 1 and lens.max() <= max_len


def test_pool_inputs_differ_and_repeat():
    cfg = {"key_dtype": "uint32", "payload_dtype": "uint32"}
    traffic = {"mode": "pairs", "layout": "random_segments", "n": 3000,
               "max_len": 32, "entropy": "E100", "pool": 3}
    a = inputs.make_pool(cfg, traffic, 99, torch.device("cpu"))
    b = inputs.make_pool(cfg, traffic, 99, torch.device("cpu"))
    assert len(a) == 3
    for x, y in zip(a, b):
        assert torch.equal(x.keys.view(torch.int32), y.keys.view(torch.int32))
        assert np.array_equal(x.starts, y.starts)
        assert torch.equal(x.values.view(torch.int32),
                           torch.arange(3000, dtype=torch.int32))
    assert not torch.equal(a[0].keys.view(torch.int32),
                           a[1].keys.view(torch.int32))


ZIPF_MAX = (1 << 28) - 1


def _zipf(n, seed, first=0):
    return inputs.zipf_keys(n, seed, 1.3, ZIPF_MAX, device="cpu",
                            first=first).view(torch.int32).numpy()


def test_zipf_keys_follow_the_pmf():
    """The first 8 keys' shares at 2^20 draws lie within 5 standard errors
    of Zipf(1.3)'s pmf (1 / zeta(1.3) = 0.2543 for the key 1)."""
    n = 1 << 20
    keys = _zipf(n, 2**31 + 99)
    zeta = 3.9319492118  # zeta(1.3)
    assert inputs.zipf_thresholds(1.3)[1] == pytest.approx(zeta, rel=1e-9)
    for k in range(1, 9):
        p = k ** -1.3 / zeta
        share = float(np.mean(keys == k))
        assert abs(share - p) < 5 * (p * (1 - p) / n) ** 0.5, (k, share, p)
    # the tail past the table and the clipped top, by the closed form
    tail = (inputs.ZIPF_TABLE + 0.5) ** -0.3 / (0.3 * zeta)
    share = float(np.mean(keys > inputs.ZIPF_TABLE))
    assert abs(share - tail) < 5 * (tail / n) ** 0.5
    top = (ZIPF_MAX - 0.5) ** -0.3 / (0.3 * zeta)
    assert abs(float(np.mean(keys == ZIPF_MAX)) - top) < 5 * (top / n) ** 0.5


def test_zipf_keys_stay_in_range_and_repeat():
    a = _zipf(300000, 4294967295)
    assert a.min() >= 1 and a.max() <= ZIPF_MAX   # none 0, none >= 2^28
    assert np.array_equal(a, _zipf(300000, 4294967295))
    assert not np.array_equal(a, _zipf(300000, 4294967294))


def test_a_ranks_keys_are_its_slots_of_the_global_array():
    n, seed = 5000, 2**31 + 5
    whole = _zipf(4 * n, seed)
    for r in range(4):
        assert np.array_equal(_zipf(n, seed, first=r * n),
                              whole[r * n:(r + 1) * n])
    bits = inputs.hybrid_taus_bits(3 * n, seed, device="cpu")
    part = inputs.hybrid_taus_bits(n, seed, device="cpu", first=2 * n)
    assert torch.equal(part.view(torch.int32), bits[2 * n:].view(torch.int32))


def test_a_ranks_pool_carries_global_positions():
    cfg = {"key_dtype": "uint32", "payload_dtype": "uint32"}
    traffic = {"mode": "pairs", "layout": "flat", "n": 3000, "keys": "zipf",
               "exponent": 1.3, "max_key": ZIPF_MAX, "pool": 2}
    whole = inputs.make_input(cfg, {**traffic, "n": 4 * 3000}, 77 + 1,
                              torch.device("cpu"))
    pool = inputs.make_pool(cfg, traffic, 77, torch.device("cpu"), rank=2)
    x = pool[1]
    assert torch.equal(x.values.view(torch.int32),
                       torch.arange(6000, 9000, dtype=torch.int32))
    assert torch.equal(x.keys.view(torch.int32),
                       whole.keys.view(torch.int32)[6000:9000])
