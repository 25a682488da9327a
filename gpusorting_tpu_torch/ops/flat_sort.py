"""Flat library-sort path: the portable baseline and cross-engine oracle.

Port of `gpusorting_tpu/ops/xla_sort.py` (named for XLA there, where the
role is `jax.lax.sort`).  Here the library sort is `torch.sort` — CUB on
CUDA, the reference's own oracle (SplitSortTests.cuh:527-566) — over the
biased int32 key carriers of `core.codec`, so the order (NaN placement
included) is identical to every other engine's.

The JAX package pads sorts to size buckets to share TPU compile caches and
maps giant rows through per-row sorts for VMEM residency; neither applies
to torch, and the outputs are the same without them.
"""

from __future__ import annotations

import torch

from ..core import codec
from ..core.config import Order
from ..utils.trace import readback

_M32 = 0xFFFFFFFF


def sort_all_keys_unstable(keys: torch.Tensor, dim: int = -1
                           ) -> torch.Tensor:
    """Unstable sort, legal only where instability cannot be observed.

    THE INVARIANT (do not call this unless it holds): the tensor sorted is
    the whole comparator key and nothing rides along — bare codes, or a
    composite whose low half is a unique index.  Equal elements are then
    bit-identical, so any order among them yields the same output.
    """
    return torch.sort(keys, dim=dim, stable=False).values


def sort_keys_u32(codes: torch.Tensor) -> torch.Tensor:
    """Ascending sort of biased int32 key codes (equal codes are
    indistinguishable, so the unstable sort is exact)."""
    return sort_all_keys_unstable(codes)


def sort_pairs_u32(codes: torch.Tensor, payload_bits: torch.Tensor):
    """Stable ascending sort of (biased code, payload carrier) pairs."""
    sc, perm = torch.sort(codes, stable=True)
    return sc, payload_bits[perm]


def _flip(t: torch.Tensor, order: Order, dim: int = 0) -> torch.Tensor:
    return torch.flip(t, dims=(dim,)) if order == Order.DESCENDING else t


def sort_keys(keys: torch.Tensor, order: Order = Order.ASCENDING
              ) -> torch.Tensor:
    """Sort typed keys (u32/i32/f32).  Descending is the element-wise
    reverse of the ascending result (SortCommon.hlsl `DescendingIndex`)."""
    kt = codec.key_type_of(keys)
    sc = sort_keys_u32(codec.encode_biased(keys))
    return codec.decode_biased(_flip(sc, order), kt)


def sort_pairs(keys: torch.Tensor, values: torch.Tensor,
               order: Order = Order.ASCENDING):
    """Sort typed (key, payload) pairs, stable, payload moved by bits."""
    kt = codec.key_type_of(keys)
    sc, sb = sort_pairs_u32(codec.encode_biased(keys),
                            codec.payload_to_bits(values))
    return (codec.decode_biased(_flip(sc, order), kt),
            codec.bits_to_payload(_flip(sb, order), values.dtype))


def sort_pairs_wide(keys: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                    order: Order = Order.ASCENDING):
    """Stable pair sort with a 64-bit payload carried as two 32-bit planes
    (the reference's 64-bit payloads, SplitSort.cuh:702)."""
    kt = codec.key_type_of(keys)
    sc, perm = torch.sort(codec.encode_biased(keys), stable=True)
    slo = lo.view(torch.int32)[perm]
    shi = hi.view(torch.int32)[perm]
    return (codec.decode_biased(_flip(sc, order), kt),
            _flip(slo, order).view(lo.dtype),
            _flip(shi, order).view(hi.dtype))


def sort_batched(keys: torch.Tensor, values: torch.Tensor | None = None,
                 order: Order = Order.ASCENDING):
    """Sort each row of a 2-D (S, L) array independently (stable per row);
    descending is the per-row reverse of the ascending result.  One batched
    `torch.sort` serves every row length (the JAX package's mapped-row
    route past `map_rows_min` is a TPU VMEM-residency device)."""
    kt = codec.key_type_of(keys)
    codes = codec.encode_biased(keys)
    if values is None:
        sk = sort_all_keys_unstable(codes, dim=1)
        return codec.decode_biased(_flip(sk, order, 1), kt)
    sk, perm = torch.sort(codes, dim=1, stable=True)
    sb = torch.gather(codec.payload_to_bits(values), 1, perm)
    return (codec.decode_biased(_flip(sk, order, 1), kt),
            codec.bits_to_payload(_flip(sb, order, 1), values.dtype))


def segment_ids_from_offsets(seg_offsets: torch.Tensor, n: int
                             ) -> torch.Tensor:
    """Per-element u32 segment id (int64 values) from exclusive-prefix
    starts: ones scattered at the starts (starts >= n dropped), summed."""
    off = seg_offsets
    if off.dtype == torch.uint32:
        off = off.view(torch.int32)
    off = off.to(torch.int64) & _M32
    with readback("segment_mask", off):    # the count of kept starts
        off = off[off < n]
    marks = torch.zeros((n,), dtype=torch.int64, device=off.device)
    marks.index_add_(0, off, torch.ones_like(off))
    return (torch.cumsum(marks, 0) - 1) & _M32


def segmented_sort_pairs(seg_offsets: torch.Tensor, keys: torch.Tensor,
                         values: torch.Tensor | None,
                         total_length: int | None = None):
    """Segmented stable sort (the CUB DeviceSegmentedSort oracle analog):
    one sort of the composite (segment id, key code) — the reference's
    large-segment trick (SplitSortLarge.cuh:1198-1289)."""
    n = keys.shape[0] if total_length is None else total_length
    seg = segment_ids_from_offsets(seg_offsets, n)
    kt = codec.key_type_of(keys)
    codes = codec.encode_biased(keys)
    # int64 (seg - 2^31, code as unsigned low half): signed order is the
    # lexicographic (segment, code) order
    seg_b = (seg - 0x80000000).to(torch.int32)
    comp = codec.join_wide(codes ^ codec.SIGN, seg_b)
    if values is None:
        sc = codec.split_wide(sort_all_keys_unstable(comp))[0]
        return codec.decode_biased(sc ^ codec.SIGN, kt)
    scomp, perm = torch.sort(comp, stable=True)
    sc = codec.split_wide(scomp)[0] ^ codec.SIGN
    sb = codec.payload_to_bits(values)[perm]
    return (codec.decode_biased(sc, kt),
            codec.bits_to_payload(sb, values.dtype))
