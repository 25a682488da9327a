"""Splitsweep — a 16-way splitter partition, then a sort of each bucket.

Port of `gpusorting_tpu/ops/splitsweep.py`.  Codes are the biased int32
carriers of `core.codec`; the sentinel 0xFFFFFFFF is INT32_MAX there.

  1. splitters: a hashed sample of (code, position) pairs, sorted; its 15
     quantiles.  The position tiebreak makes the splitters a total order,
     so duplicate-heavy inputs still split into balanced buckets.
  2. bucketize: each element's bucket is the number of splitters at or
     below its (code, position).
  3. partition: one binning pass in its digit-plane form
     (`radix16.binning_pass(digits=)`, kernel `csrc/binning.cu`) places
     each bucket, in input order, into its own row-aligned region of
     `cap_rows` rows.
  4. gaps: the slots of a region past its bucket's count become sentinels.
  5. sub-sorts: one batched `torch.sort` of the 16 regions (the JAX package
     sorts there with `lax.sort`, outside any kernel), or `sub_sort` on each
     region (the two-level form).
  6. assembly: `stitch.compact_ops` (kernel `csrc/stitch.cu`) drops the gaps.

Bucket capacity is fixed (slack over n/16).  A sample whose largest bucket
overflows its region takes the exact flat sort instead, as in JAX; that
test reads the 16 counts to the host, one of the call's two
synchronisations (the other is the binning pass's range check of the
bucket plane).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import codec
from . import radix16, rts, stitch

LANES = radix16.LANES
NBUCKETS = radix16.NBUCKETS
SENTINEL = codec.SENTINEL      # biased 0xFFFFFFFF
_HASH = 2654435761             # the sample's multiplicative hash


def _sample_splitters(codes: torch.Tensor, pos: torch.Tensor,
                      oversample: int):
    """15 splitters (codes, positions) from a hashed sample of m positions,
    `(i * 2654435761 mod 2^32) mod n`, sorted by (code, position)."""
    n = codes.shape[0]
    m = min(n, max(NBUCKETS * oversample, min(65536, n // 256)))
    # the JAX package wraps this product in uint32; int64 with a mask does
    # the same without torch's uint32 arithmetic
    sidx = ((torch.arange(m, dtype=torch.int64, device=codes.device) * _HASH)
            & 0xFFFFFFFF) % n
    key = (codes[sidx].to(torch.int64) << 32) | pos[sidx].to(torch.int64)
    skey = torch.sort(key).values
    idx = (torch.arange(1, NBUCKETS, device=codes.device) * m) // NBUCKETS
    spl = skey[idx]
    return (spl >> 32).to(torch.int32), (spl & 0xFFFFFFFF).to(torch.int32)


def _bucketize(codes: torch.Tensor, pos: torch.Tensor, spl_c: torch.Tensor,
               spl_p: torch.Tensor) -> torch.Tensor:
    """Bucket id in [0, 16) (int32) = the number of splitters (c, p) with
    (c, p) <= (code, position); signed order of the biased codes is u32
    order, and positions are non-negative."""
    key = (codes.to(torch.int64) << 32) | pos.to(torch.int64)
    spl = (spl_c.to(torch.int64) << 32) | spl_p.to(torch.int64)
    return torch.searchsorted(spl, key, right=True).to(torch.int32)


def _cap_rows(rows: int, slack: float) -> int:
    """Rows of each bucket region: ceil(rows * slack / 16), rounded up to 8
    rows, with JAX's float arithmetic."""
    return -(-int(np.ceil(rows * slack / NBUCKETS)) // 8) * 8


def _partition_16(planes, bucket: torch.Tensor, cap_rows: int,
                  tile_rows: int):
    """Place every (rows, 128) plane's elements into 16 row-aligned regions
    of cap_rows rows, bucket d from row d * cap_rows, in input order (one
    digit-plane binning pass).  The slots past each bucket's count are
    unspecified."""
    dev = planes[0].device
    bases = (torch.arange(NBUCKETS, dtype=torch.int32, device=dev)
             * (cap_rows * LANES))
    out = [torch.empty((NBUCKETS * cap_rows, LANES), dtype=torch.int32,
                       device=dev) for _ in planes]
    outs, _ = radix16.binning_pass(list(planes), bases, 0, tile_rows, out,
                                   digits=bucket)
    return outs


def _prepare(codes, rides, tile_rows, oversample, slack):
    """Pad to whole tiles (codes with the sentinel, rides with 0; 16-byte
    aligned planes), then the splitters, buckets, counts and region size."""
    if tile_rows is None:
        tile_rows = rts.default_tile_rows(codes.device)
    planes, _ = rts.pad_tiles((codes,) + tuple(rides), tile_rows)
    rows = planes[0].shape[0]
    flat = planes[0].view(-1)
    pos = torch.arange(rows * LANES, dtype=torch.int32, device=codes.device)
    spl_c, spl_p = _sample_splitters(flat, pos, oversample)
    bucket = _bucketize(flat, pos, spl_c, spl_p)
    counts = torch.bincount(bucket, minlength=NBUCKETS).to(torch.int32)
    cap_rows = _cap_rows(rows, slack)
    # the call's one synchronisation: an overflowing bucket takes the
    # exact flat sort
    overflow = bool(counts.max() > cap_rows * LANES)
    return planes, bucket.view(rows, LANES), counts, cap_rows, tile_rows, \
        overflow


def _valid(counts: torch.Tensor, cap: int) -> torch.Tensor:
    """(16, cap) bool: slot i of region d holds one of bucket d's elements."""
    return (torch.arange(cap, device=counts.device)[None, :]
            < counts[:, None])


def sort_codes_splitsweep(codes: torch.Tensor, tile_rows: int | None = None,
                          oversample: int = 64, slack: float = 1.35,
                          sub_sort=None) -> torch.Tensor:
    """Keys-only ascending sort of biased int32 codes via the 16-way
    splitter partition.

    `sub_sort(flat_codes) -> sorted flat_codes` sorts each bucket region
    (default: one batched `torch.sort` of all 16); pass a wrapped
    `sort_codes_splitsweep` for a second partition level."""
    n = codes.shape[0]
    planes, bucket, counts, cap_rows, tile_rows, overflow = _prepare(
        codes, (), tile_rows, oversample, slack)
    if overflow:
        return torch.sort(planes[0].reshape(-1)).values[:n]
    (out,) = _partition_16(planes, bucket, cap_rows, tile_rows)
    cap = cap_rows * LANES
    valid = _valid(counts, cap)
    regions = torch.where(valid, out.view(NBUCKETS, cap), SENTINEL)
    if sub_sort is None:
        regions = torch.sort(regions, dim=1).values
    else:
        regions = torch.stack([sub_sort(r) for r in regions])
    (packed,), _ = stitch.compact_ops((regions.reshape(-1),),
                                      valid.reshape(-1))
    return packed[:n]


def sort_stable_with_splitsweep(codes: torch.Tensor, *ride: torch.Tensor,
                                tile_rows: int | None = None,
                                oversample: int = 64, slack: float = 1.35):
    """Stable ascending sort of biased int32 codes with int32 ride planes
    (1 = a 32-bit payload, 2 = a 64-bit payload's lo/hi) via the splitter
    partition.  Returns (sorted_codes, *permuted_rides), bit-exact with
    `torch.sort(codes, stable=True)` applied to every plane.

    The partition keeps each bucket's input order, and each region's sort
    is stable over codes whose gaps are sentinels past every real element,
    so equal codes keep their order and real 0xFFFFFFFF codes come before
    the gaps (JAX sorts by (code, in-region index); the same order)."""
    n = codes.shape[0]
    planes, bucket, counts, cap_rows, tile_rows, overflow = _prepare(
        codes, ride, tile_rows, oversample, slack)
    if overflow:
        perm = torch.sort(planes[0].reshape(-1), stable=True).indices[:n]
        return tuple(p.reshape(-1)[perm] for p in planes)
    outs = _partition_16(planes, bucket, cap_rows, tile_rows)
    cap = cap_rows * LANES
    valid = _valid(counts, cap)
    kreg = torch.where(valid, outs[0].view(NBUCKETS, cap), SENTINEL)
    skeys, perm = torch.sort(kreg, dim=1, stable=True)
    sorted_regions = [skeys] + [torch.gather(o.view(NBUCKETS, cap), 1, perm)
                                for o in outs[1:]]
    packed, _ = stitch.compact_ops(
        tuple(r.reshape(-1) for r in sorted_regions), valid.reshape(-1))
    return tuple(p[:n] for p in packed)


def sort_pairs_splitsweep(codes: torch.Tensor, payload: torch.Tensor,
                          tile_rows: int | None = None, oversample: int = 64,
                          slack: float = 1.35):
    """Stable pair sort via the splitter partition (the one-ride form of
    `sort_stable_with_splitsweep`)."""
    return sort_stable_with_splitsweep(codes, payload, tile_rows=tile_rows,
                                       oversample=oversample, slack=slack)
