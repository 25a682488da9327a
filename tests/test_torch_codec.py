"""Port parity: gpusorting_tpu_torch.core.codec against gpusorting_tpu's codec.

The same numpy inputs go through both packages; outputs are compared bit
for bit.  Float inputs carry NaNs of both signs (with payload bits), ±0,
±inf, denormals and the extremes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpusorting_tpu.core import codec as jcodec
from gpusorting_tpu_torch.core import codec
from gpusorting_tpu_torch.core.config import KeyType

_SPECIAL_F32_BITS = np.array([
    0x00000000, 0x80000000,              # +0, -0
    0x7F800000, 0xFF800000,              # +inf, -inf
    0x7FC00000, 0xFFC00000,              # quiet NaNs of both signs
    0x7F800001, 0xFFFFFFFF, 0x7FFFFFFF,  # signalling / payload NaNs
    0x00000001, 0x80000001,              # denormals
    0x7F7FFFFF, 0xFF7FFFFF,              # +-max
    0x3F800000, 0xBF800000,              # +-1
], dtype=np.uint32)


def _bits(n=4000, seed=5):
    rng = np.random.default_rng(seed)
    return np.concatenate([_SPECIAL_F32_BITS,
                           rng.integers(0, 2**32, n, dtype=np.uint32)])


_NP = {KeyType.UINT32: np.uint32, KeyType.INT32: np.int32,
       KeyType.FLOAT32: np.float32}


@pytest.mark.parametrize("kt", list(KeyType))
def test_encode_matches_jax(kt):
    keys = _bits().view(_NP[kt])
    want = np.asarray(jcodec.encode_keys(jnp.asarray(keys)))
    got = codec.encode_keys(torch.from_numpy(keys.copy()))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    # the biased carrier is the code with its top bit flipped
    np.testing.assert_array_equal(
        codec.encode_biased(torch.from_numpy(keys.copy())).numpy(),
        (want ^ np.uint32(0x80000000)).view(np.int32))


@pytest.mark.parametrize("kt", list(KeyType))
def test_round_trips(kt):
    keys = _bits(seed=9).view(_NP[kt])
    t = torch.from_numpy(keys.copy())
    back = codec.decode_keys(codec.encode_keys(t), kt)
    assert back.dtype == kt.dtype
    np.testing.assert_array_equal(back.view(torch.int32).numpy(),
                                  keys.view(np.int32))
    back = codec.decode_biased(codec.encode_biased(t), kt)
    np.testing.assert_array_equal(back.view(torch.int32).numpy(),
                                  keys.view(np.int32))
    jback = np.asarray(jcodec.decode_keys(jcodec.encode_keys(
        jnp.asarray(keys)), getattr(jcodec.KeyType, kt.name)))
    np.testing.assert_array_equal(jback.view(np.int32), keys.view(np.int32))


@pytest.mark.parametrize("kt", list(KeyType))
def test_biased_signed_order_is_code_order(kt):
    keys = _bits(seed=11).view(_NP[kt])
    codes = np.asarray(jcodec.encode_keys(jnp.asarray(keys)))
    carrier = codec.encode_biased(torch.from_numpy(keys.copy()))
    np.testing.assert_array_equal(
        np.argsort(codes, kind="stable"),
        torch.sort(carrier, stable=True).indices.numpy())


def test_float_special_placement():
    """-NaN < -inf < -max < -1 < -0 < +0 < 1 < max < +inf < +NaN."""
    order = np.array([0xFFC00000, 0xFF800000, 0xFF7FFFFF, 0xBF800000,
                      0x80000000, 0x00000000, 0x3F800000, 0x7F7FFFFF,
                      0x7F800000, 0x7FC00000], np.uint32)
    perm = np.random.default_rng(1).permutation(order.size)
    t = torch.from_numpy(order[perm].view(np.float32).copy())
    got = torch.sort(codec.encode_biased(t)).values
    np.testing.assert_array_equal(
        codec.decode_biased(got, KeyType.FLOAT32).view(torch.int32).numpy(),
        order.view(np.int32))


@pytest.mark.parametrize("dtype,carrier", [
    (torch.uint32, torch.int32), (torch.int32, torch.int32),
    (torch.float32, torch.int32), (torch.int64, torch.int64),
    (torch.uint64, torch.int64), (torch.float64, torch.int64)])
def test_payload_bits_round_trip(dtype, carrier):
    raw = np.random.default_rng(2).integers(0, 2**63, 500, dtype=np.int64)
    src = torch.from_numpy(raw).view(torch.int32)[:500] if (
        dtype.itemsize == 4) else torch.from_numpy(raw)
    values = src.view(dtype)
    bits = codec.payload_to_bits(values)
    assert bits.dtype == carrier
    back = codec.bits_to_payload(bits, dtype)
    assert back.dtype == dtype
    assert torch.equal(back.view(carrier), src.view(carrier))


def test_wide_split_join_matches_jax_planes():
    w = np.random.default_rng(4).integers(0, 2**63, 777, dtype=np.int64)
    lo, hi = codec.split_wide(torch.from_numpy(w))
    np.testing.assert_array_equal(lo.view(torch.uint32).numpy(),
                                  (w & 0xFFFFFFFF).astype(np.uint32))
    np.testing.assert_array_equal(hi.view(torch.uint32).numpy(),
                                  (w >> 32).astype(np.uint32))
    assert torch.equal(codec.join_wide(lo, hi), torch.from_numpy(w))


def test_unsupported_dtypes_raise():
    with pytest.raises(TypeError):
        codec.encode_keys(torch.zeros(3, dtype=torch.int16))
    with pytest.raises(TypeError):
        codec.payload_to_bits(torch.zeros(3, dtype=torch.int8))
    with pytest.raises(TypeError):
        codec.decode_biased(torch.zeros(3, dtype=torch.int64),
                            KeyType.INT32)
