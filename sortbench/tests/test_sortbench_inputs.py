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
