"""`Backend.PALLAS` dispatch — the engine-family router.

Port of `gpusorting_tpu/ops/radix.py`.  The JAX package's variant map
(reference README.md:5-15 families -> engines):

  "device_radix"             -> reduce-then-scan (ops/rts.py)       ported
  "ffx"                      -> 5-stage FFX pipeline (ops/ffx.py)   ported
  "onesweep"/"forward_sweep" -> Batcher network (ops/bitonic.py)
  "radix16"                  -> fused single-binning-pass LSD
  "emulated_deadlocking"     -> radix16 in adversarial segments
  "splitsweep", "mergesweep" -> their own modules

A variant whose engine is not ported raises NotImplementedError naming its
ROADMAP item; it never falls through to another engine.  Every engine
sorts the same biased key codes, so outputs are bit-exact across engines
and with the flat `torch.sort`.
"""

from __future__ import annotations

import torch

from ..core import codec
from ..core.config import Order
from . import ffx, rts
from .flat_sort import _flip

_NETWORK = "ops/bitonic.py, ROADMAP.md Queue 1 #9 and Queue 2 #10-#11"
_RADIX16 = "ops/radix16.py, ROADMAP.md Queue 1 #7 and Queue 2 #2, #5"
_NOT_PORTED = {
    "onesweep": _NETWORK,
    "forward_sweep": _NETWORK,
    "radix16": _RADIX16,
    "emulated_deadlocking": _RADIX16,
    "splitsweep": "ops/splitsweep.py, ROADMAP.md Queue 1 #8",
    "mergesweep": "ops/mergesweep.py, ROADMAP.md Queue 1 #9 and Queue 2 "
                  "#12-#13",
}
PORTED = ("device_radix", "ffx")


def _require_ported(variant: str) -> None:
    if variant not in PORTED:
        # the JAX router sends any other name to the network
        raise NotImplementedError(
            f"variant {variant!r} is not ported yet: "
            f"{_NOT_PORTED.get(variant, _NETWORK)}")


def sort_codes_with_rides(codes: torch.Tensor, rides: tuple, variant: str,
                          tile_rows: int | None = None):
    """Stable sort of biased int32 codes with int32 ride planes (1 ride = a
    32-bit payload, 2 = a 64-bit payload's lo/hi) through the named engine.
    Returns (sorted_codes, *permuted_rides).  "ffx" ignores `tile_rows`."""
    _require_ported(variant)
    if variant == "device_radix":
        if tile_rows is None:
            tile_rows = rts.default_tile_rows(codes.device, pairs=True)
        return rts._sort_rts((codes,) + rides, tile_rows)
    return ffx._sort_ffx((codes,) + rides)


def sort(keys: torch.Tensor, order: Order = Order.ASCENDING,
         variant: str = "onesweep", tile_rows: int | None = None
         ) -> torch.Tensor:
    """Key sort through the named engine; `tile_rows` overrides the tuning
    row's radix tile ("ffx" keeps its fixed tile)."""
    _require_ported(variant)
    codes = codec.encode_biased(keys)
    if variant == "device_radix":
        sc = rts.sort_codes_rts(codes, tile_rows=tile_rows)
    else:
        sc = ffx.sort_codes_ffx(codes)
    return codec.decode_biased(_flip(sc, order), codec.key_type_of(keys))


def sort_pairs(keys: torch.Tensor, values: torch.Tensor,
               order: Order = Order.ASCENDING, variant: str = "onesweep",
               tile_rows: int | None = None):
    """Stable pair sort through the named engine; a 64-bit payload rides as
    lo/hi int32 planes."""
    _require_ported(variant)
    bits = codec.payload_to_bits(values)
    codes = codec.encode_biased(keys)
    if bits.dtype == torch.int64:
        sc, slo, shi = sort_codes_with_rides(codes, codec.split_wide(bits),
                                             variant, tile_rows)
        sbits = codec.join_wide(slo, shi)
    else:
        sc, sbits = sort_codes_with_rides(codes, (bits,), variant, tile_rows)
    return (codec.decode_biased(_flip(sc, order), codec.key_type_of(keys)),
            codec.bits_to_payload(_flip(sbits, order), values.dtype))


def sort_pairs_wide(keys: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                    order: Order = Order.ASCENDING,
                    variant: str = "onesweep",
                    tile_rows: int | None = None):
    """Stable pair sort with a two-plane (lo, hi) 64-bit payload through
    the named engine (3 planes)."""
    _require_ported(variant)
    sc, slo, shi = sort_codes_with_rides(
        codec.encode_biased(keys), (lo.view(torch.int32),
                                    hi.view(torch.int32)),
        variant, tile_rows)
    return (codec.decode_biased(_flip(sc, order), codec.key_type_of(keys)),
            _flip(slo, order).view(lo.dtype),
            _flip(shi, order).view(hi.dtype))
