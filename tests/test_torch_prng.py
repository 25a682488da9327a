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


def test_cuda_default_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="cuda"):
        prng.hybrid_taus_bits(16, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        prng.make_descending_keys(16)
