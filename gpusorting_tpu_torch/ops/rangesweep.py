"""Rangesweep — exact-splitter range exchange over pre-sorted chunks.

Port of `gpusorting_tpu/ops/rangesweep.py`, the engine AUTO runs at the
flagship sizes.  Codes are the biased int32 carriers of `core.codec`.

  1. pad to N = K*L with the sentinel and sort the K chunks of length L
     (one batched `torch.sort` over the (K, L) view).
  2. EXACT balanced cuts: a 32-step bisection in u32 value space finds,
     per boundary, the value whose equal run straddles global rank
     (b+1)*L; the run is split by count in chunk order, so every bucket
     holds exactly L elements for any distribution.  At K >= 64 the
     bisection runs against a <= 3K-row head-window slab per boundary
     (`_exact_cuts_hier`).  Both forms give bit-identical cuts.
  3. range exchange: each (chunk, bucket) range is contiguous in its
     sorted chunk.  Whole 128-element rows move through the hand-written
     relocate kernel (`ops.relocate`, replacing the Pallas
     `_relocate_kernel`); the <= 127-element fringes at range edges are
     packed densely per bucket by one small batched sort, so that
     bulk_rows*128 + fringes == L and the slab fills the rows after the
     bucket's bulk exactly.
  4. sort the K dense buckets again (one batched sort).

The pairs form rides a unique original-index plane and sorts phases 1 and
3 by the int64 composite (code, index), which makes the result exactly the
stable sort (see `sort_pairs_rangesweep`).

Each phase is a function of its own, so that a caller can time the phases
apart (`chip_smoke.py` does).
"""

from __future__ import annotations

import torch

from ..core import codec
from ..core.config import get_device_info, get_routing_parameters
from . import flat_sort, relocate

LANES = 128


def _routing(device: torch.device):
    """The routing row of `device`: its seg lengths are the defaults."""
    return get_routing_parameters(get_device_info(device))


def _biased(v: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> biased int32 carriers (u - 2^31)."""
    return (v - 0x80000000).to(torch.int32)


def _clip(x: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """jnp.clip(x, 0, hi)."""
    return torch.minimum(torch.clamp(x, min=0), hi)


def _bounds(cuts: torch.Tensor, K: int, L: int) -> torch.Tensor:
    dev = cuts.device
    zeros = torch.zeros((K, 1), dtype=torch.int64, device=dev)
    full = torch.full((K, 1), L, dtype=torch.int64, device=dev)
    return torch.cat([zeros, cuts, full], dim=1).to(torch.int32)


def _exact_cuts(x2: torch.Tensor, K: int, L: int,
                return_splitters: bool = False):
    """(K, K+1) int32 per-chunk cut positions making bucket b exactly L.

    x2 holds K sorted chunks of biased codes.  The bisection runs over u32
    values v (int64); each step counts, per chunk, the elements below
    each of the K-1 candidates with one batched `searchsorted`.  The
    splitters come back as biased int32 (K-1,)."""
    x2 = x2.reshape(K, L)
    dev = x2.device
    targets = torch.arange(1, K, dtype=torch.int64, device=dev) * L

    def ranks(vb: torch.Tensor, right: bool) -> torch.Tensor:
        # (K, K-1): per-chunk insertion points of the K-1 candidates
        return torch.searchsorted(x2, vb.expand(K, K - 1).contiguous(),
                                  right=right)

    # v_b = largest value with #{x < v_b} < target_b
    v = torch.zeros((K - 1,), dtype=torch.int64, device=dev)
    for t in range(32):
        vp = v | (1 << (31 - t))
        below = ranks(_biased(vp), False).sum(0)
        v = torch.where(below < targets, vp, v)
    vb = _biased(v)
    c = ranks(vb, False)                             # (K, K-1) below-run
    e = ranks(vb, True) - c                          # run lengths
    deficit = targets - c.sum(0)                     # take from runs
    excl = torch.cumsum(e, 0) - e                    # run mass before chunk
    bounds = _bounds(c + _clip(deficit[None, :] - excl, e), K, L)
    return (bounds, vb) if return_splitters else bounds


def _exact_cuts_hier(x2: torch.Tensor, K: int, L: int,
                     heads: torch.Tensor | None = None,
                     return_splitters: bool = False):
    """(K, K+1) cut positions, bit-identical to `_exact_cuts`, computed
    against a head-window slab so the cost stays flat as K grows.

      1. the row heads (each row's minimum) get a stable argsort; with the
         total order (value, chunk, position) the element of global rank
         b*L lies between the heads of head-rank m-K and m+K (m = b*R).
      2. per boundary, the candidate rows are the 2K rank-window rows plus
         one straddle row per chunk: <= 3K rows, gathered into one slab.
         Rows before the window count 128 each, rows after count 0.
      3. the 32-step bisection counts against the slab only.
      4. the equal run is split in chunk order with window run counts.
    """
    x2 = x2.reshape(K, L)
    dev = x2.device
    R = L // LANES
    KR = K * R
    if heads is None:
        heads = x2[:, ::LANES]
    sid = torch.sort(heads.reshape(-1), stable=True).indices      # (KR,)
    # rnk[i, r] = sorted position of chunk i's row r head (ascending in r)
    rnk = torch.empty_like(sid)
    rnk[sid] = torch.arange(KR, dtype=sid.dtype, device=dev)
    rnk = rnk.reshape(K, R)

    ar = lambda lo, hi: torch.arange(lo, hi, dtype=torch.int64, device=dev)
    m = ar(1, K) * R                                              # (K-1,)
    jlo = torch.clamp(m - K, min=0)
    jhi = torch.clamp(m + K, max=KR)

    # a[i, b] = #heads of chunk i with sorted rank < jlo_b
    a = torch.searchsorted(rnk, jlo.expand(K, K - 1).contiguous())
    base = torch.clamp(a - 1, min=0)                              # full rows

    # slab row ids: 2K rank-window rows + K straddle rows per boundary
    widx = jlo[:, None] + ar(0, 2 * K)[None, :]                   # (K-1, 2K)
    wvalid = widx < jhi[:, None]
    wid = sid[torch.clamp(widx, 0, KR - 1)]
    strad_id = ar(0, K)[None, :] * R + (a.T - 1)                  # (K-1, K)
    svalid = a.T >= 1
    row_ids = torch.cat([wid, strad_id], dim=1)                   # (K-1, 3K)
    valid = torch.cat([wvalid, svalid], dim=1)
    chunk_of = torch.where(valid, torch.div(row_ids, R, rounding_mode="floor"),
                           K)                                     # K = none
    safe_ids = torch.where(valid, row_ids, 0)

    slab = x2.reshape(KR, LANES)[safe_ids.reshape(-1)].reshape(
        K - 1, 3 * K, LANES)
    lane_valid = valid[:, :, None]

    base_total = base.sum(0)                                      # (K-1,)
    targets = ar(1, K) * L

    v = torch.zeros((K - 1,), dtype=torch.int64, device=dev)
    for s in range(32):
        vp = v | (1 << (31 - s))
        w = (lane_valid & (slab < _biased(vp)[:, None, None])).sum((1, 2))
        v = torch.where(base_total * LANES + w < targets, vp, v)
    vb = _biased(v)

    # per-(boundary, chunk) window counts below / equal the splitter
    lt = (lane_valid & (slab < vb[:, None, None])).sum(2)         # (K-1, 3K)
    eq = (lane_valid & (slab == vb[:, None, None])).sum(2)

    def per_chunk(cnt: torch.Tensor) -> torch.Tensor:             # (K, K-1)
        acc = torch.zeros((K - 1, K + 1), dtype=cnt.dtype, device=dev)
        return acc.scatter_add_(1, chunk_of, cnt)[:, :K].T

    c_w, e_w = per_chunk(lt), per_chunk(eq)
    c = base * LANES + c_w
    deficit = targets - c.sum(0)
    excl = torch.cumsum(e_w, 0) - e_w
    bounds = _bounds(c + _clip(deficit[None, :] - excl, e_w), K, L)
    return (bounds, vb) if return_splitters else bounds


# smallest K where the head-window cuts replace the flat bisection (the
# JAX package's value; the flat form's cost grows ~K^2)
_CUTS_HIER_MIN_K = 64


def _cuts(x2: torch.Tensor, K: int, L: int,
          heads: torch.Tensor | None = None,
          return_splitters: bool = False):
    """Cut dispatch by K: the head-window form at K >= _CUTS_HIER_MIN_K,
    else the flat bisection.  return_splitters=True also returns the (K-1,)
    boundary values (biased): v[j] is the value of global rank
    (j+1)*L - 1, bucket j's last."""
    if K >= _CUTS_HIER_MIN_K:
        return _exact_cuts_hier(x2, K, L, heads=heads,
                                return_splitters=return_splitters)
    return _exact_cuts(x2, K, L, return_splitters=return_splitters)


def _exchange_prep(planes: tuple, bounds: torch.Tensor, K: int, L: int):
    """The relocate kernel's control table and the densely packed fringe
    slabs, computed once from the key-plane bounds for every plane.

    Returns (ctrl, fringes): ctrl is the flat int32 vector
    (a0 | dst | nr | bulk), output-major, of length 3K^2 + K — source row,
    destination row and row count of range (bucket b, chunk i) at
    b*K + i, then each bucket's bulk row count; fringes holds one
    (K * 2K, 128) int32 slab per plane.  Only each slab's first
    L - 128*bulk_b elements of bucket b are defined."""
    dev = bounds.device
    rows_total = K * L // LANES
    l_rows = L // LANES
    slab_rows = 2 * K
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)
    b64 = bounds.to(torch.int64)
    i_base = (ar(K) * L)[:, None]                                 # (K,1)
    g_start = b64[:, :-1] + i_base                                # (i,b)
    g_end = b64[:, 1:] + i_base

    a0 = (g_start + LANES - 1) // LANES                           # ceil rows
    a1 = g_end // LANES                                           # floor rows
    nr_bi = torch.clamp(a1 - a0, min=0).T                         # (b,i)
    bulk_rows_b = nr_bi.sum(1)
    dst_bi = (ar(K) * l_rows)[:, None] + (torch.cumsum(nr_bi, 1) - nr_bi)
    ctrl = torch.cat([a0.T.reshape(-1), dst_bi.reshape(-1),
                      nr_bi.reshape(-1), bulk_rows_b]).to(torch.int32)

    # fringes: each range's <= 127-element ends live in exactly two source
    # rows (the partial row before its bulk and the one after)
    lo_end = torch.minimum(a0 * LANES, g_end)
    front = lo_end - g_start                                      # (i,b)
    hi_start = torch.maximum(a1 * LANES, lo_end)
    back = g_end - hi_start
    fr_bi = (front + back).T                                      # (b,i)
    foff_bi = torch.cumsum(fr_bi, 1) - fr_bi                      # exclusive

    row_f = torch.clamp(a0.T - 1, 0, rows_total - 1)              # (b,i)
    row_b = torch.clamp(a1.T, 0, rows_total - 1)
    pair_rows = torch.stack([row_f, row_b], dim=-1).reshape(-1)   # (2KK,)

    # every valid fringe slot gets its unique dense position in the
    # bucket's slab as key, junk a larger one; one batched sort packs it
    s = ar(2 * LANES)[None, None, :]
    front3 = front.T[:, :, None]
    back3 = back.T[:, :, None]
    foff3 = foff_bi[:, :, None]
    jf = s - (g_start.T % LANES)[:, :, None]                      # front rank
    jb = front3 + (s - LANES)                                     # back rank
    key = torch.where(
        (s < LANES) & (jf >= 0) & (jf < front3), foff3 + jf,
        torch.where((s >= LANES) & (s - LANES < back3), foff3 + jb,
                    2 * K * LANES))
    order = torch.sort(key.reshape(K, slab_rows * LANES), dim=1).indices
    fringes = tuple(
        torch.take_along_dim(
            p.reshape(rows_total, LANES)[pair_rows].reshape(
                K, slab_rows * LANES), order, dim=1
        ).reshape(K * slab_rows, LANES)
        for p in planes)
    return ctrl, fringes


def _range_exchange(planes: tuple, bounds: torch.Tensor, K: int, L: int,
                    method: str = "dma") -> tuple:
    """Move each (chunk i, bucket b) range into bucket b's dense region,
    for every int32 plane in `planes` (1 for keys; 2 for argsort: codes +
    index; 3 for pairs; 4 for 64-bit payloads: codes + index + lo + hi).
    One control plan from the key bounds moves every plane.

    method="dma": the relocate kernel (`relocate.relocate`; on a CPU
    tensor its plain version).  method="gather": the plain PyTorch
    version itself, one row gather through the row map.

    Planes come in any chunk-major shape; each result is (K*L/128, 128).
    """
    if method not in ("dma", "gather"):
        raise ValueError(f"unknown method {method!r}")
    rows_total = K * L // LANES
    ctrl, fringes = _exchange_prep(planes, bounds, K, L)
    move = relocate.relocate if method == "dma" else relocate.relocate_plain
    return tuple(move(ctrl, p.reshape(rows_total, LANES), f, K, L // LANES,
                      2 * K)
                 for p, f in zip(planes, fringes))


def _pad(x: torch.Tensor, N: int, fill: int) -> torch.Tensor:
    n = x.shape[0]
    if N == n:
        return x
    return torch.cat([x, torch.full((N - n,), fill, dtype=x.dtype,
                                    device=x.device)])


def _chunks(n: int, L: int) -> int:
    if L % LANES:
        raise ValueError(f"seg_elems must be a multiple of {LANES}, got {L}")
    return -(-n // L)


def _phase_sort_keys(x2: torch.Tensor) -> torch.Tensor:
    """Phases 1 and 3 of the keys engine: sort each row of (K, L) codes."""
    return flat_sort.sort_all_keys_unstable(x2, dim=1)


def _phase_sort_pairs(planes: tuple) -> tuple:
    """Phases 1 and 3 of the pairs engine: sort each row of the (K, L)
    planes (code, index, *payload) by the int64 composite (code, index).
    The composite is unique, so the unstable sort is the stable one."""
    code, idx = planes[0], planes[1]
    K, L = code.shape
    key = codec.join_wide(idx.reshape(-1), code.reshape(-1)).view(K, L)
    if len(planes) == 2:
        sk, perm = flat_sort.sort_all_keys_unstable(key, dim=1), None
    else:
        sk, perm = torch.sort(key, dim=1, stable=False)
    idx_s, code_s = codec.split_wide(sk.reshape(-1))
    return (code_s.view(K, L), idx_s.view(K, L)) + tuple(
        torch.gather(p, 1, perm) for p in planes[2:])


def _phase3_keys(out: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Phase 3 of the keys engine, in place on the exchanged (K, L) buckets.

    Interior bucket b is constant when adjacent splitters are equal
    (v[b-1] == v[b]: its first element is >= the left splitter, its last
    IS the right one); edge buckets are always sorted.  When at least 90%
    of the interior buckets are constant, only the others are sorted (one
    host read of the count decides)."""
    K = out.shape[0]
    if K > 2:
        flags = torch.zeros((K,), dtype=torch.bool, device=out.device)
        flags[1:K - 1] = v[:-1] == v[1:]
        if int(flags[1:K - 1].sum()) >= int(0.9 * (K - 2)):
            keep = torch.nonzero(~flags).squeeze(1)
            out[keep] = _phase_sort_keys(out[keep])
            return out
    return _phase_sort_keys(out)


def sort_codes_rangesweep(codes: torch.Tensor,
                          seg_elems: int | None = None) -> torch.Tensor:
    """Ascending keys-only sort of biased int32 codes via the range
    exchange (unstable: equal codes are interchangeable).  Phase 3 skips
    constant buckets (`_phase3_keys`)."""
    n = codes.shape[0]
    L = seg_elems or _routing(codes.device).rangesweep_seg_elems
    K = _chunks(n, L)
    if n <= L:
        # single chunk: one flat sort IS the algorithm
        return flat_sort.sort_all_keys_unstable(codes)
    x2 = _phase_sort_keys(_pad(codes, K * L, codec.SENTINEL).view(K, L))
    bounds, v = _cuts(x2, K, L, heads=x2[:, ::LANES], return_splitters=True)
    (out,) = _range_exchange((x2,), bounds, K, L)
    return _phase3_keys(out.view(K, L), v).reshape(-1)[:n]


def sort_pairs_rangesweep_planes(codes: torch.Tensor, planes: tuple,
                                 seg_elems: int,
                                 return_index: bool = False):
    """Stable pair sort of biased codes with 0..2 int32 payload planes moved
    by the same permutation (2 planes = a 64-bit payload's lo/hi).
    Returns (sorted_codes, *permuted_planes), bit-exact with the stable
    sort moving each plane.

    return_index=True also returns the int32 original-index plane right
    after the codes: the stable argsort permutation, which the pipeline
    carries anyway.  With planes=() this is the 2-plane argsort path.

    Pads carry the sentinel code and the largest indices, so they sort
    last even beside real 0xFFFFFFFF keys."""
    n = codes.shape[0]
    L = seg_elems
    K = _chunks(n, L)
    if n <= L:
        sc, perm = torch.sort(codes, stable=True)
        out = (sc, perm.to(torch.int32)) + tuple(p[perm] for p in planes)
        return out if return_index else (out[0],) + out[2:]
    N = K * L
    k = _pad(codes, N, codec.SENTINEL)
    planes = tuple(_pad(p, N, 0) for p in planes)
    idx = torch.arange(N, dtype=torch.int32, device=codes.device)

    p1 = _phase_sort_pairs(tuple(p.view(K, L) for p in (k, idx) + planes))
    bounds = _cuts(p1[0], K, L, heads=p1[0][:, ::LANES])
    ex = _range_exchange(p1, bounds, K, L)
    p3 = _phase_sort_pairs(tuple(p.view(K, L) for p in ex))
    tail = 1 if return_index else 2
    return (p3[0].reshape(-1)[:n],) + tuple(
        p.reshape(-1)[:n] for p in p3[tail:])


def sort_pairs_rangesweep(codes: torch.Tensor, bits: torch.Tensor,
                          seg_elems: int | None = None):
    """STABLE (codes, payload carrier) pair sort via the range exchange;
    bit-exact with `torch.sort(codes, stable=True)` moving the payload.

    The keys engine splits straddling equal runs by count, which is legal
    only for interchangeable elements.  Here a unique index plane rides
    along and phases 1 and 3 sort by (code, index): the count-split takes
    each run's elements in chunk order and, within a chunk, in index
    order — global index order — so bucket b receives exactly the
    elements of (code, index)-rank [b*L, (b+1)*L) and phase 3 rebuilds
    the stable order.

    An int64 carrier (64-bit payload) rides as two int32 planes (lo, hi).
    """
    n = codes.shape[0]
    wide = bits.dtype == torch.int64
    r = _routing(codes.device)
    L = seg_elems or (r.rangesweep_seg_elems_pairs_wide if wide
                      else r.rangesweep_seg_elems_pairs)
    if n <= L:
        sc, perm = torch.sort(codes, stable=True)
        return sc, bits[perm]
    if wide:
        k3, slo, shi = sort_pairs_rangesweep_planes(
            codes, codec.split_wide(bits), seg_elems=L)
        return k3, codec.join_wide(slo, shi)
    k3, sv = sort_pairs_rangesweep_planes(codes, (bits,), seg_elems=L)
    return k3, sv


def argsort_rangesweep(codes: torch.Tensor,
                       seg_elems: int | None = None):
    """Stable argsort of biased codes via the 2-plane range exchange:
    (sorted_codes, perm) with perm the int32 stable permutation.  The index
    plane the stable pipeline rides IS the payload, so no third plane."""
    L = seg_elems or _routing(codes.device).rangesweep_seg_elems_index
    return sort_pairs_rangesweep_planes(
        codes, (), seg_elems=L, return_index=True)
