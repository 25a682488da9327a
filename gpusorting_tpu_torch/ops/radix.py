"""`Backend.PALLAS` dispatch — the engine-family router.

Port of `gpusorting_tpu/ops/radix.py`.  The JAX package's variant map
(reference README.md:5-15 families -> engines):

  "onesweep"/"forward_sweep" -> Batcher network (ops/bitonic.py), the
                                default; any other unknown name too
  "radix16"                  -> fused single-binning-pass LSD
                                (ops/radix16.py)
  "emulated_deadlocking"     -> radix16 in adversarial tile-range segments
  "device_radix"             -> reduce-then-scan (ops/rts.py)
  "ffx"                      -> 5-stage FFX pipeline (ops/ffx.py)
  "splitsweep"               -> 16-way splitter partition, then bucket
                                sorts (ops/splitsweep.py)
  "mergesweep"               -> segment sorts, then Batcher merge passes
                                (ops/mergesweep.py)

Every engine sorts the same biased key codes, so outputs are bit-exact
across engines and with the flat `torch.sort`.
"""

from __future__ import annotations

import torch

from ..core import codec
from ..core.config import DeviceInfo, Order, auto_engine
from . import bitonic, ffx, mergesweep, radix16, rts, splitsweep
from .flat_sort import _flip


def is_native(info: DeviceInfo | None = None) -> bool:
    """True when AUTO's route at the headline size (2^28 keys, the bench
    script's) on this device runs a hand-written kernel, that is when
    `auto_engine(2^28, info=info)` is not the flat `torch.sort` ("xla").

    Port of `gpusorting_tpu/ops/radix.py:is_native`, whose True meant
    AUTO's flagship route ran a Pallas stage on the TPU.  On the card's
    measured row (core/config.py "h100", measured on an NVIDIA H100 80GB
    HBM3 at 700.00 W) AUTO sends 2^28 keys to the 8-bit-digit radix sort
    (ops/radix256.py), whose kernels are hand-written, so this is True
    there; elsewhere it is True only under a row or a routing override
    that sends 2^28 keys to rangesweep (its relocate kernel) or radix256.
    Always False off a CUDA card."""
    return auto_engine(1 << 28, info=info) != "xla"


PORTED = ("device_radix", "ffx", "onesweep", "forward_sweep", "radix16",
          "emulated_deadlocking", "splitsweep", "mergesweep")


def _tile(tile_rows: int | None, codes: torch.Tensor, pairs: bool) -> int:
    if tile_rows is None:
        return rts.default_tile_rows(codes.device, pairs=pairs)
    return tile_rows


def _sort_codes(codes: torch.Tensor, variant: str, tile_rows: int | None):
    if variant == "device_radix":
        return rts.sort_codes_rts(codes, tile_rows=tile_rows)
    if variant == "radix16":
        return radix16.sort_codes_radix16(codes, tile_rows=tile_rows)
    if variant == "ffx":
        return ffx.sort_codes_ffx(codes)
    if variant == "emulated_deadlocking":
        tr = _tile(tile_rows, codes, pairs=False)
        return radix16.sort_codes_radix16(
            codes, tile_rows=tr,
            segments=radix16.adversarial_segments(codes.shape[0], tr))
    if variant == "splitsweep":
        return splitsweep.sort_codes_splitsweep(codes, tile_rows=tile_rows)
    if variant == "mergesweep":
        return mergesweep.sort_codes(codes)
    return bitonic.sort_codes(codes)


def sort_codes_with_rides(codes: torch.Tensor, rides: tuple, variant: str,
                          tile_rows: int | None = None):
    """Stable sort of biased int32 codes with int32 ride planes (1 ride = a
    32-bit payload, 2 = a 64-bit payload's lo/hi) through the named engine.
    Returns (sorted_codes, *permuted_rides).  "ffx", "mergesweep" and the
    network ignore `tile_rows`; "splitsweep" defaults it to the keys' radix
    tile, as in JAX."""
    if variant == "device_radix":
        return rts._sort_rts((codes,) + rides,
                             _tile(tile_rows, codes, pairs=True))
    if variant == "radix16":
        return radix16._sort_radix16((codes,) + rides,
                                     _tile(tile_rows, codes, pairs=True))
    if variant == "ffx":
        return ffx._sort_ffx((codes,) + rides)
    if variant == "emulated_deadlocking":
        tr = _tile(tile_rows, codes, pairs=True)
        return radix16._sort_radix16(
            (codes,) + rides, tr,
            segments=radix16.adversarial_segments(codes.shape[0], tr))
    if variant == "splitsweep":
        return splitsweep.sort_stable_with_splitsweep(codes, *rides,
                                                      tile_rows=tile_rows)
    if variant == "mergesweep":
        return mergesweep.sort_codes_stable_with(codes, *rides)
    return bitonic.sort_codes_stable_with(codes, *rides)


def sort(keys: torch.Tensor, order: Order = Order.ASCENDING,
         variant: str = "onesweep", tile_rows: int | None = None
         ) -> torch.Tensor:
    """Key sort through the named engine; `tile_rows` overrides the tuning
    row's radix tile ("ffx" keeps its fixed tile, the network sizes its
    own)."""
    sc = _sort_codes(codec.encode_biased(keys), variant, tile_rows)
    return codec.decode_biased(_flip(sc, order), codec.key_type_of(keys))


def sort_pairs(keys: torch.Tensor, values: torch.Tensor,
               order: Order = Order.ASCENDING, variant: str = "onesweep",
               tile_rows: int | None = None):
    """Stable pair sort through the named engine; a 64-bit payload rides as
    lo/hi int32 planes."""
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
    the named engine (3 planes; the network adds its index plane)."""
    sc, slo, shi = sort_codes_with_rides(
        codec.encode_biased(keys), (lo.view(torch.int32),
                                    hi.view(torch.int32)),
        variant, tile_rows)
    return (codec.decode_biased(_flip(sc, order), codec.key_type_of(keys)),
            _flip(slo, order).view(lo.dtype),
            _flip(shi, order).view(hi.dtype))
