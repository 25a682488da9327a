"""On-device output validation — the test oracle.

Port of `gpusorting_tpu/utils/validate.py` (reference mechanisms, SURVEY.md
§4): an adjacent-pair order check counting violations (Utility.hlsl:147-231;
UtilityKernels.cuh:403-479); the pairs check of payload order, which with
payload == key bits verifies stability and the permutation; segmented order;
bit identity against an independent oracle.  Each check reduces on the
tensor's device to a 0-d int64 count.
"""

from __future__ import annotations

import torch

from ..core import codec
from ..core.config import Order


def _code_order_violations(codes: torch.Tensor, order: Order
                           ) -> torch.Tensor:
    if codes.shape[0] < 2:
        return torch.zeros((), dtype=torch.int64, device=codes.device)
    a, b = codes[:-1], codes[1:]
    bad = (a > b) if order == Order.ASCENDING else (a < b)
    return bad.sum()


def count_order_violations(keys: torch.Tensor,
                           order: Order = Order.ASCENDING) -> torch.Tensor:
    """Validate-kernel analog: number of adjacent out-of-order pairs."""
    return _code_order_violations(codec.encode_biased(keys), order)


def count_pair_violations(keys: torch.Tensor, values: torch.Tensor,
                          order: Order = Order.ASCENDING) -> torch.Tensor:
    """Key order + payload order (the stability oracle).

    Requires the fixture convention payload == key bits (a 64-bit payload
    holds them as its value).  The payload is compared in the KEY's order
    through the key codec (Utility.hlsl:163-192)."""
    errs = _code_order_violations(codec.encode_biased(keys), order)
    if values.dtype in (torch.int64, torch.uint64, torch.float64):
        wide = values.to(torch.int64) if values.is_floating_point() else (
            values.view(torch.int64))
        vbits = codec.split_wide(wide)[0]
    else:
        vbits = codec.payload_to_bits(values)
    vcodes = codec.encode_biased(vbits.view(keys.dtype))
    return errs + _code_order_violations(vcodes, order)


def count_segmented_violations(seg_offsets: torch.Tensor, keys: torch.Tensor,
                               order: Order = Order.ASCENDING
                               ) -> torch.Tensor:
    """Order check that resets at segment boundaries."""
    n = keys.shape[0]
    if n < 2:
        return torch.zeros((), dtype=torch.int64, device=keys.device)
    codes = codec.encode_biased(keys)
    a, b = codes[:-1], codes[1:]
    bad = (a > b) if order == Order.ASCENDING else (a < b)
    off = seg_offsets
    if off.dtype == torch.uint32:
        off = off.view(torch.int32)
    off = off.to(torch.int64) & 0xFFFFFFFF
    starts = torch.zeros((n,), dtype=torch.bool, device=keys.device)
    starts[off[off < n]] = True
    return (bad & ~starts[1:]).sum()


def identical(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Count of element-wise mismatches by bit pattern (CUB-identity
    analog; float NaNs compare equal to themselves)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        raise ValueError(f"shape/dtype mismatch: {a.dtype}{tuple(a.shape)} "
                         f"vs {b.dtype}{tuple(b.shape)}")
    if a.dtype.itemsize == 4:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype.itemsize == 8:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return (a != b).sum()
