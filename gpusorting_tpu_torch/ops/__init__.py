"""Public sort ops with backend dispatch.

Port of `gpusorting_tpu/ops/__init__.py`.  Every entry point computes on
the device of the tensor it is given.  `backend=AUTO` asks
`core.config.auto_engine` for that device and size: on a CUDA card with a
routing row, sorts at or above the row's thresholds run the range-exchange
engine (ops/rangesweep.py, whose exchange is the hand-written relocate
kernel) or, keys only and pairs with a 32-bit payload, the 8-bit-digit
radix sort (ops/radix256.py, its upsweep and four passes hand-written
kernels); everything else runs the flat `torch.sort` (ops/flat_sort.py).
`backend=PALLAS` runs the engine family named by `variant=` (ops/radix.py):
"onesweep" (the default) and "forward_sweep" the bitonic network, whose
in-tile stages and above-tile hyper trips are hand-written kernels;
"radix16" the fused radix-16 engine (global histogram and one binning pass
per digit, both kernels) and "emulated_deadlocking" the same in
adversarial tile-range segments; "device_radix" and "ffx" the
reduce-then-scan engines (Upsweep, scan and downsweep kernels);
"splitsweep" a 16-way splitter partition (the binning kernel in its
digit-plane form, then bucket sorts and the compact kernel); "mergesweep"
segment sorts and Batcher merge passes (merge-tail kernel, and hyper-stage
trips above the tile, or one global-stage kernel a stride under
GST_MERGESWEEP_HYPER=0, which governs the network's levels too).
`tile_rows=` overrides the radix tile.  All sort the same biased key codes
(core.codec), so outputs are bit-identical across routes.  AUTO's choice
is the span `dispatch.route`; the route a call runs is the span
`engine.flat`, `engine.rangesweep`, `engine.radix256` or
`engine.pallas.<variant>`
(utils/trace.py).
"""

from __future__ import annotations

import torch

from ..core import codec
from ..core.config import (Backend, Mode, Order, auto_engine,
                           get_device_info, get_routing_parameters)
from ..utils.trace import span
from . import flat_sort, radix, radix256, rangesweep
from .flat_sort import _flip


def _check_lengths(keys, *others):
    """Friendly shape errors (the reference asserts sizes, GPUSortBase.cs)."""
    if keys.ndim != 1:
        raise ValueError(f"keys must be 1-D, got shape {tuple(keys.shape)}")
    for o in others:
        if o.shape != keys.shape:
            raise ValueError(f"payload shape {tuple(o.shape)} != keys shape "
                             f"{tuple(keys.shape)}")


def _route(keys: torch.Tensor, backend: Backend, mode: Mode = Mode.KEYS_ONLY,
           payload_bits: int = 32, index_payload: bool = False) -> str:
    """The engine AUTO sends this sort to ("xla", the flat sort, for every
    other backend)."""
    with span("dispatch.route"):
        if backend != Backend.AUTO:
            return "xla"
        return auto_engine(keys.shape[0], mode, payload_bits=payload_bits,
                           info=get_device_info(keys.device),
                           index_payload=index_payload)


def sort(keys: torch.Tensor, order: Order = Order.ASCENDING,
         backend: Backend = Backend.AUTO, variant: str = "onesweep",
         tile_rows: int | None = None) -> torch.Tensor:
    """Sort a 1-D tensor of uint32/int32/float32 keys.

    variant and tile_rows select the PALLAS engine family and its tile;
    the other backends ignore them."""
    _check_lengths(keys)
    if backend == Backend.PALLAS:
        with span("engine.pallas." + variant):
            return radix.sort(keys, order=order, variant=variant,
                              tile_rows=tile_rows)
    route = _route(keys, backend)
    if route == "rangesweep":
        with span("engine.rangesweep"):
            sc = rangesweep.sort_codes_rangesweep(codec.encode_biased(keys))
            return codec.decode_biased(_flip(sc, order),
                                       codec.key_type_of(keys))
    if route == "radix256":
        with span("engine.radix256"):
            out = radix256.sort(keys)
            # torch's uint32 has no flip: reverse the bits as int32
            return _flip(out.view(torch.int32), order).view(keys.dtype)
    with span("engine.flat"):
        return flat_sort.sort_keys(keys, order=order)


def sort_pairs_wide(keys: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                    order: Order = Order.ASCENDING,
                    backend: Backend = Backend.AUTO,
                    variant: str = "onesweep",
                    tile_rows: int | None = None):
    """Stable pair sort with a 64-bit payload given as two 32-bit planes
    (lo, hi); AUTO's 4-plane route and the PALLAS engines move the planes
    as they are."""
    _check_lengths(keys, lo, hi)
    if lo.dtype.itemsize != 4 or hi.dtype.itemsize != 4:
        raise TypeError(f"lo/hi planes must be 32-bit, got {lo.dtype}, "
                        f"{hi.dtype}")
    if backend == Backend.PALLAS:
        with span("engine.pallas." + variant):
            return radix.sort_pairs_wide(keys, lo, hi, order=order,
                                         variant=variant, tile_rows=tile_rows)
    if _route(keys, backend, Mode.PAIRS, payload_bits=64) == "rangesweep":
        with span("engine.rangesweep"):
            r = get_routing_parameters(get_device_info(keys.device))
            sc, slo, shi = rangesweep.sort_pairs_rangesweep_planes(
                codec.encode_biased(keys),
                (lo.view(torch.int32), hi.view(torch.int32)),
                seg_elems=r.rangesweep_seg_elems_pairs_wide)
            return (codec.decode_biased(_flip(sc, order),
                                        codec.key_type_of(keys)),
                    _flip(slo, order).view(lo.dtype),
                    _flip(shi, order).view(hi.dtype))
    with span("engine.flat"):
        return flat_sort.sort_pairs_wide(keys, lo, hi, order=order)


def sort_batched(keys: torch.Tensor, values: torch.Tensor | None = None,
                 order: Order = Order.ASCENDING,
                 backend: Backend = Backend.AUTO,
                 variant: str = "onesweep", tile_rows: int | None = None):
    """Sort each row of a 2-D (batch, L) tensor independently; stable per
    row, descending = per-row reverse of the ascending result.  PALLAS runs
    each row through the named engine."""
    if keys.ndim != 2:
        raise ValueError(
            f"sort_batched takes a 2-D tensor, got {tuple(keys.shape)}")
    if values is not None and values.shape != keys.shape:
        raise ValueError(f"payload shape {tuple(values.shape)} != keys "
                         f"shape {tuple(keys.shape)}")
    if backend == Backend.PALLAS:
        with span("engine.pallas." + variant):
            if values is None:
                return torch.stack([radix.sort(r, order=order,
                                               variant=variant,
                                               tile_rows=tile_rows)
                                    for r in keys])
            rows = [radix.sort_pairs(k, v, order=order, variant=variant,
                                     tile_rows=tile_rows)
                    for k, v in zip(keys, values)]
            return (torch.stack([k for k, _ in rows]),
                    torch.stack([v for _, v in rows]))
    with span("engine.flat"):
        return flat_sort.sort_batched(keys, values, order=order)


def argsort(keys: torch.Tensor, order: Order = Order.ASCENDING,
            backend: Backend = Backend.AUTO, variant: str = "onesweep",
            tile_rows: int | None = None, return_keys: bool = False):
    """Stable argsort: the int32 permutation that sorts `keys` (the
    reference's pair sort with an index payload, GPUSortBase.h
    CreateTestInput).  Descending is the reverse of the ascending
    permutation; return_keys=True also returns the sorted keys."""
    _check_lengths(keys)
    if _route(keys, backend, Mode.PAIRS,
              index_payload=True) == "rangesweep":
        with span("engine.rangesweep"):
            sc, perm = rangesweep.argsort_rangesweep(
                codec.encode_biased(keys))
            perm = _flip(perm, order)
            if return_keys:
                return (codec.decode_biased(_flip(sc, order),
                                            codec.key_type_of(keys)), perm)
            return perm
    idx = torch.arange(keys.shape[0], dtype=torch.int32, device=keys.device)
    k, perm = sort_pairs(keys, idx, order=order, backend=backend,
                         variant=variant, tile_rows=tile_rows)
    return (k, perm) if return_keys else perm


def sort_pairs(keys: torch.Tensor, values: torch.Tensor,
               order: Order = Order.ASCENDING,
               backend: Backend = Backend.AUTO, variant: str = "onesweep",
               tile_rows: int | None = None):
    """Stable sort of (keys, payload) pairs; the payload is moved by its bit
    pattern.  A 64-bit payload (int64, uint64 or float64) rides as lo/hi
    int32 planes and routes by its own threshold; a 32-bit one may take the
    8-bit-digit radix sort's pairs form on AUTO."""
    _check_lengths(keys, values)
    if backend == Backend.PALLAS:
        with span("engine.pallas." + variant):
            return radix.sort_pairs(keys, values, order=order,
                                    variant=variant, tile_rows=tile_rows)
    bits = codec.payload_to_bits(values)
    pbits = 64 if bits.dtype == torch.int64 else 32
    route = _route(keys, backend, Mode.PAIRS, payload_bits=pbits)
    if route == "radix256":
        with span("engine.radix256"):
            sk, sb = radix256.sort_pairs(keys, bits)
            return (_flip(sk.view(torch.int32), order).view(keys.dtype),
                    codec.bits_to_payload(_flip(sb, order), values.dtype))
    if route == "rangesweep":
        with span("engine.rangesweep"):
            sc, sb = rangesweep.sort_pairs_rangesweep(
                codec.encode_biased(keys), bits)
            return (codec.decode_biased(_flip(sc, order),
                                        codec.key_type_of(keys)),
                    codec.bits_to_payload(_flip(sb, order), values.dtype))
    with span("engine.flat"):
        return flat_sort.sort_pairs(keys, values, order=order)
