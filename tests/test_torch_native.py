"""Port parity for the host runtime in C++ (gpusorting_tpu_torch/native/)
against gpusorting_tpu.native, bit for bit, on the same numpy inputs.

Every case of tests/test_native.py runs through both libraries: the PRNG
fill at 9 (seed, and_count) pairs, the radix sorts, the pair sort's
stability, the validators and the 10^6 consistency case.  The fill is
also held against the port's own generator (core/prng.hybrid_taus_bits),
and the port's functions take CPU tensors and give tensors back.  The
library is built with g++ at first use; wherever g++ exists it must build,
since the port has no numpy stand-in to fall back on.
"""

import shutil

import numpy as np
import pytest
import torch

from gpusorting_tpu import native as jnative
from gpusorting_tpu_torch import native
from gpusorting_tpu_torch.core import prng


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _u32(n, seed, high=2**32):
    rng = np.random.RandomState(seed)
    return rng.randint(0, high, size=n, dtype=np.uint64).astype(np.uint32)


def test_available_wherever_gpp_exists():
    assert shutil.which("g++"), "g++ is missing: the library cannot build"
    assert native.available()
    assert jnative.available()
    assert native._target(native.FLAGS + (native.OPENMP,)).exists() or \
        native._target(native.FLAGS).exists()
    assert native.SOURCE.parent.parent.parent.name == "gpusorting_tpu_torch"


@pytest.mark.parametrize("seed", [1, 10, 12345])
@pytest.mark.parametrize("and_count", [0, 2, 4])
def test_prng_bit_exact_with_jax_and_port(seed, and_count):
    n = 4096
    ours = native.fill_hybrid_taus(n, seed, and_count)
    assert ours.dtype == np.uint32 and ours.shape == (n,)
    np.testing.assert_array_equal(ours,
                                  jnative.fill_hybrid_taus(n, seed, and_count))
    port = prng.hybrid_taus_bits(n, seed, and_count, device="cpu")
    np.testing.assert_array_equal(ours.view(np.int32),
                                  port.view(torch.int32).numpy())


def test_prng_warmup_and_odd_length():
    for warmup in (0, 1, 5):
        np.testing.assert_array_equal(
            native.fill_hybrid_taus(1001, 7, 1, warmup),
            jnative.fill_hybrid_taus(1001, 7, 1, warmup))
    np.testing.assert_array_equal(native.fill_hybrid_taus(0, 3), [])


def test_radix_sort_matches_jax():
    x = _u32(100_000, 0)
    got = native.radix_sort(x)
    np.testing.assert_array_equal(got, jnative.radix_sort(x))
    np.testing.assert_array_equal(got, np.sort(x))
    assert not np.shares_memory(got, x)


def test_radix_sort_pairs_stable_matches_jax():
    k = _u32(50_000, 1, high=16)          # heavy duplicates
    v = np.arange(50_000, dtype=np.uint32)
    sk, sv = native.radix_sort_pairs(k, v)
    jk, jv = jnative.radix_sort_pairs(k, v)
    np.testing.assert_array_equal(sk, jk)
    np.testing.assert_array_equal(sv, jv)
    order = np.argsort(k, kind="stable")
    np.testing.assert_array_equal(sk, k[order])
    np.testing.assert_array_equal(sv, v[order])


def test_validators_match_jax():
    k = np.array([1, 2, 2, 3, 1, 5], dtype=np.uint32)
    v = np.array([0, 1, 2, 3, 4, 5], dtype=np.uint32)
    offs = np.array([0, 3], dtype=np.uint32)
    for fn, args, want in (
            ("count_order_violations", (k,), 1),
            ("count_order_violations", (np.sort(k),), 0),
            ("count_pair_violations", (np.sort(k), v), 0),
            ("count_pair_violations", (k, v), 1),
            ("count_segmented_violations", (k, offs), 1)):
        assert getattr(native, fn)(*args) == want
        assert getattr(native, fn)(*args) == getattr(jnative, fn)(*args)
    rev = k[::-1].copy()
    assert native.count_order_violations(rev, descending=True) == 1 == \
        jnative.count_order_violations(rev, descending=True)
    assert native.count_pair_violations(rev, v[::-1].copy(),
                                        descending=True) == \
        jnative.count_pair_violations(rev, v[::-1].copy(), descending=True)


def test_validator_large_consistency():
    x = _u32(1_000_000, 2)
    s = native.radix_sort(x)
    np.testing.assert_array_equal(s, jnative.radix_sort(x))
    assert native.count_order_violations(s) == 0
    assert native.count_order_violations(x) == \
        jnative.count_order_violations(x) > 0
    offs = np.arange(0, 1_000_000, 977, dtype=np.uint32)
    assert native.count_segmented_violations(x, offs) == \
        jnative.count_segmented_violations(x, offs) > 0


def test_tensors_in_tensors_out():
    x = _u32(10_000, 3)
    t = torch.from_numpy(x.view(np.int32)).view(torch.uint32)
    got = native.radix_sort(t)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint32
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  np.sort(x).view(np.int32))
    k = _u32(10_000, 4, high=8)
    kt = torch.from_numpy(k.view(np.int32))        # an int32 carrier
    vt = torch.arange(10_000, dtype=torch.int32)
    sk, sv = native.radix_sort_pairs(kt, vt)
    jk, jv = jnative.radix_sort_pairs(k, np.arange(10_000, dtype=np.uint32))
    assert sk.dtype == sv.dtype == torch.uint32
    np.testing.assert_array_equal(sk.view(torch.int32).numpy(),
                                  jk.view(np.int32))
    np.testing.assert_array_equal(sv.view(torch.int32).numpy(),
                                  jv.view(np.int32))
    assert native.count_order_violations(t) == \
        jnative.count_order_violations(x)
    assert native.count_order_violations(t[::2]) == \
        jnative.count_order_violations(x[::2].copy())
    assert native.count_segmented_violations(
        t, torch.tensor([0, 5000], dtype=torch.int32)) == \
        jnative.count_segmented_violations(x, np.array([0, 5000], np.uint32))


def test_device_and_width_refusals():
    off_host = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="host"):
        native.radix_sort(off_host)
    with pytest.raises(ValueError, match="host"):
        native.count_segmented_violations(torch.zeros(8, dtype=torch.int32),
                                          off_host)
    with pytest.raises(TypeError, match="4-byte"):
        native.radix_sort(np.zeros(8, np.int64))
    with pytest.raises(TypeError, match="4-byte"):
        native.count_order_violations(torch.zeros(8, dtype=torch.int16))
    with pytest.raises(ValueError, match="shape"):
        native.radix_sort_pairs(np.zeros(8, np.uint32), np.zeros(7, np.uint32))
