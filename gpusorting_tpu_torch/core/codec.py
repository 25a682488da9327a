"""Order-preserving key bijections into uint32 radix space, and the
sign-biased int32 carrier the port sorts.

Port of `gpusorting_tpu/core/codec.py` (reference: SortCommon.hlsl:134-154,
Herf's "Radix Tricks"):

  float32 -> u32 : flip all bits if the sign bit is set, else set the sign bit
  int32   -> u32 : xor 0x80000000
  uint32  -> u32 : identity

NaNs take the places the codes give them (negative NaNs below -inf,
positive NaNs above +inf); -0.0 sorts just below +0.0.

torch's `uint32` has no `>>`, `<`, `max`, `flip` or `searchsorted`, so the
engines carry each code u as the BIASED int32 `u ^ 0x80000000` (numerically
u - 2^31): signed order of the carrier is u32 order of the code, and the
u32 sentinel 0xFFFFFFFF becomes `SENTINEL` = 0x7FFFFFFF.  `encode_keys` /
`decode_keys` keep the JAX package's u32 codes for callers that want them;
the engines use `encode_biased` / `decode_biased`, which each take one pass.
"""

from __future__ import annotations

import torch

from .config import KeyType

SENTINEL = 0x7FFFFFFF          # biased carrier of the u32 code 0xFFFFFFFF
SIGN = -0x80000000            # int32 with only the sign bit set
_LOW31 = 0x7FFFFFFF


def key_type_of(keys: torch.Tensor) -> KeyType:
    dt = keys.dtype
    if dt == torch.uint32:
        return KeyType.UINT32
    if dt == torch.int32:
        return KeyType.INT32
    if dt == torch.float32:
        return KeyType.FLOAT32
    raise TypeError(f"unsupported key dtype {dt}")


def encode_biased(keys: torch.Tensor) -> torch.Tensor:
    """Keys -> biased int32 carrier: signed order == the key type's order."""
    kt = key_type_of(keys)
    if kt == KeyType.UINT32:
        return keys.view(torch.int32) ^ SIGN
    if kt == KeyType.INT32:
        return keys                  # (k ^ 0x80000000) ^ 0x80000000 == k
    i = keys.view(torch.int32)
    # negative floats flip their 31 magnitude bits; the sign bit stays
    return i ^ ((i >> 31) & _LOW31)


def decode_biased(carrier: torch.Tensor, key_type: KeyType) -> torch.Tensor:
    """Inverse of :func:`encode_biased`."""
    if carrier.dtype != torch.int32:
        raise TypeError(f"carrier must be int32, got {carrier.dtype}")
    if key_type == KeyType.UINT32:
        return (carrier ^ SIGN).view(torch.uint32)
    if key_type == KeyType.INT32:
        return carrier
    if key_type == KeyType.FLOAT32:
        # the float transform is an involution on the carrier (the xor mask
        # never touches the sign bit)
        return (carrier ^ ((carrier >> 31) & _LOW31)).view(torch.float32)
    raise TypeError(f"unsupported key type {key_type}")


def bias(codes: torch.Tensor) -> torch.Tensor:
    """u32 codes -> biased int32 carrier."""
    return codes.view(torch.int32) ^ SIGN


def unbias(carrier: torch.Tensor) -> torch.Tensor:
    """Biased int32 carrier -> u32 codes."""
    return (carrier ^ SIGN).view(torch.uint32)


def wrap_int32(t: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 with its low 32 bits (int32 wrapping)."""
    return (((t & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def encode_keys(keys: torch.Tensor) -> torch.Tensor:
    """Map keys to uint32 codes so unsigned order == the key type's order
    (bit-identical to the JAX package's codes)."""
    return unbias(encode_biased(keys))


def decode_keys(codes: torch.Tensor, key_type: KeyType) -> torch.Tensor:
    """Inverse of :func:`encode_keys` (reference: UintToFloat/UintToInt)."""
    return decode_biased(bias(codes), key_type)


# Payloads are moved, never compared: carry them by bit pattern.
_PAYLOAD_BITS = {
    torch.uint32: torch.int32,
    torch.int32: torch.int32,
    torch.float32: torch.int32,
    torch.uint64: torch.int64,
    torch.int64: torch.int64,
    torch.float64: torch.int64,
}


def payload_to_bits(values: torch.Tensor) -> torch.Tensor:
    """Bitcast a payload to its signed carrier (int32 or int64)."""
    carrier = _PAYLOAD_BITS.get(values.dtype)
    if carrier is None:
        raise TypeError(f"unsupported payload dtype {values.dtype}")
    return values.view(carrier)


def bits_to_payload(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return bits.view(dtype)


def split_wide(bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int64 carrier -> (lo, hi) int32 planes (little-endian halves)."""
    halves = bits.view(torch.int32).view(-1, 2)
    return halves[:, 0].contiguous(), halves[:, 1].contiguous()


def join_wide(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(lo, hi) int32 planes -> int64 carrier."""
    return torch.stack((lo, hi), dim=-1).view(torch.int64).view(-1)
