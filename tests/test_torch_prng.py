"""Port parity: gpusorting_tpu_torch.core.prng is bit-exact with the JAX
package's generator for the same (n, seed, and_count)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpusorting_tpu.core import prng as jprng
from gpusorting_tpu_torch.core import prng
from gpusorting_tpu_torch.core.config import EntropyPreset


@pytest.mark.parametrize("and_count", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 7, 2**32 - 1])
def test_hybrid_taus_bits_bit_exact(seed, and_count):
    n = 3001
    want = np.asarray(jprng.hybrid_taus_bits(n, seed, and_count))
    got = prng.hybrid_taus_bits(n, seed, and_count, device="cpu")
    assert got.dtype == torch.uint32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_chunked_generation_matches_one_chunk(monkeypatch):
    n = 5000
    want = np.asarray(jprng.hybrid_taus_bits(n, 3, 1))
    monkeypatch.setattr(prng, "_CHUNK", 777)
    got = prng.hybrid_taus_bits(n, 3, 1, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("tdtype,jdtype", [
    (torch.uint32, jnp.uint32), (torch.int32, jnp.int32),
    (torch.float32, jnp.float32)])
@pytest.mark.parametrize("entropy", [EntropyPreset.E100, EntropyPreset.E020])
def test_make_test_keys_and_pairs(tdtype, jdtype, entropy):
    from gpusorting_tpu.core.config import EntropyPreset as JE

    n, seed = 2048, 17
    je = JE(int(entropy))
    want = np.asarray(jprng.make_test_keys(n, seed, jdtype, je))
    got = prng.make_test_keys(n, seed, tdtype, entropy, device="cpu")
    assert got.dtype == tdtype
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  want.view(np.int32))
    jk, jv = jprng.make_test_pairs(n, seed, jdtype, jnp.uint32, je)
    tk, tv = prng.make_test_pairs(n, seed, tdtype, torch.uint32, entropy,
                                  device="cpu")
    np.testing.assert_array_equal(tk.view(torch.int32).numpy(),
                                  np.asarray(jk).view(np.int32))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("pdtype", [torch.int64, torch.float64])
def test_make_test_pairs_wide_payload_holds_key_bits(pdtype):
    n = 999
    bits = np.asarray(jprng.hybrid_taus_bits(n, 8, 0))
    k, v = prng.make_test_pairs(n, 8, torch.uint32, pdtype, device="cpu")
    assert v.dtype == pdtype
    np.testing.assert_array_equal(k.numpy(), bits)
    np.testing.assert_array_equal(v.to(torch.int64).numpy(),
                                  bits.astype(np.int64))


@pytest.mark.parametrize("tdtype,jdtype", [
    (torch.uint32, jnp.uint32), (torch.int32, jnp.int32)])
def test_make_descending_keys(tdtype, jdtype):
    want = np.asarray(jprng.make_descending_keys(1500, jdtype))
    got = prng.make_descending_keys(1500, tdtype, device="cpu")
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  want.view(np.int32))


@pytest.mark.parametrize("total,max_len,seed", [
    (1, 4, 0), (4096, 4, 1), (10_000, 1000, 2**32 - 1), (1 << 14, 1 << 18, 7),
    (0, 16, 3)])
def test_make_random_segments_bit_exact(total, max_len, seed):
    """The batched draws give JAX's one-at-a-time lengths."""
    want, wcount = jprng.make_random_segments(total, max_len, seed)
    got, count = prng.make_random_segments(total, max_len, seed,
                                           device="cpu")
    assert got.dtype == torch.int32 and count == wcount == got.shape[0]
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))


@pytest.mark.parametrize("total,seg_length", [(4096, 32), (1000, 7),
                                              (10, 64)])
def test_make_fixed_segments_bit_exact(total, seg_length):
    want, wcount = jprng.make_fixed_segments(total, seg_length)
    got, count = prng.make_fixed_segments(total, seg_length, device="cpu")
    assert got.dtype == torch.int32 and count == wcount
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want))
    with pytest.raises(ValueError, match="positive"):
        prng.make_fixed_segments(total, 0, device="cpu")


@pytest.mark.parametrize("bits", [4, 12, 31, 32])
def test_make_masked_random_values_bit_exact(bits):
    want = np.asarray(jprng.make_masked_random_values(3001, bits, 9))
    got = prng.make_masked_random_values(3001, bits, 9, device="cpu")
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.view(torch.int32).numpy().view(
        np.uint32), want)


def test_make_unique_shuffled_is_a_seeded_permutation():
    """Not JAX's order (torch.randperm): a permutation of 0..n-1, the same
    for the same seed."""
    a = prng.make_unique_shuffled(5000, 4, device="cpu")
    assert a.dtype == torch.uint32
    ai = a.view(torch.int32)
    assert torch.equal(torch.sort(ai).values, torch.arange(5000,
                                                           dtype=torch.int32))
    assert torch.equal(ai, prng.make_unique_shuffled(5000, 4,
                                                     device="cpu").view(
                                                         torch.int32))


def test_cuda_default_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        prng.hybrid_taus_bits(16, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        prng.make_descending_keys(16)
