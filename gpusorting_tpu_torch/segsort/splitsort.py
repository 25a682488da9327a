"""SplitSort — the segmented sort (the reference's second product surface).

Port of `gpusorting_tpu/segsort/splitsort.py`.  Reference API
(GPUSortingCUDA/SegSort/SplitSort/SplitSort.cuh:674-934):
    SplitSortAllocateTempMemory(totalSegLength, totalSegCount, tempMem)
    SplitSortPairs<BITS_TO_SORT, V>(segments, sort, values, totalSegCount,
                                    totalSegLength, tempMem)
    SplitSortFreeTempMemory(tempMem)
  segments = exclusive-prefix offsets; BITS_TO_SORT in [4, 32] bounds the
  key bits; payload V in {uint32_t, double}.

Every route sorts each segment stably and gives the same bits; the host
picks one from the offsets, read to the host once per call (or once per
`SegSortPlan`), as the reference reads its segInfo back
(SplitSort.cuh:654-668):
  fixed      — equal lengths L: one batched `torch.sort` over (S, L) rows
               (span `fixed.sort`), the payload planes gathered by its
               int64 permutation (span `fixed.gather`);
  window     — two overlapping window sorts keyed by (segment id, code),
               at offsets 0 and L/2 of windows L = 2 * ceil_pow2(max len):
               `stable3` (an int64 (sid, code) composite, stable, payloads
               riding), `keys2` (the same composite, unstable, keys only) or
               `fused` (bounded bits: one u32 key, window-local segment
               index over the code);
  split      — a small-segment bulk window-sorted in place, the long tail
               compacted out, composite-sorted densely and expanded back
               (`ops/stitch.py`, the kernels of `csrc/stitch.cu`);
  classes    — the same with each power-of-two length class in
               (segsort_bulk_max, segsort_padded_max] extracted and sorted
               as padded rows, and a dense composite tail;
  packed     — strategy="packed": next-fit bins of <= 32 elements gathered
               into rows, sorted and scattered back;
  composite  — one sort of the (segment id, code) composite over the whole
               buffer, through the range-exchange engine where AUTO routes
               its size there;
  tile       — on a CUDA card, a random-length layout whose longest
               segment is at most the routing row's `segsort_tile_max`:
               every segment sorted in shared memory by one launch
               (`segsort/segtile.py`, `csrc/segtile.cu`), decided from
               the offsets' lengths before any window plan is built.
The choice is the span `dispatch.route` (with `dispatch.window_plan`
inside it where the histogram is built), the route taken the span
`engine.<name>` above, the offsets' copy `sync.offsets` (utils/trace.py);
the composite marks its branch and steps (`composite.*`, see
`_composite_multi`).  The tile route takes the raw keys and the payload
as it comes, a 64-bit one as one plane; every other route sorts the
biased int32 carriers of `core.codec` with int32 payload planes, a 64-bit
payload as two (lo, hi), split and joined in the spans `payload.split`
and `payload.join`.

PyTorch runs eagerly and the offsets are always tensors or arrays, never
traced: the JAX package's tracer branches and its jitted `make_segsort_fn`
have no counterpart.  There is no malloc surface either: the temp-memory
calls are shims, and `SplitSorter` holds only the sizes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import codec, config
from ..core.config import KeyType, Mode
from ..ops import flat_sort, rangesweep, stitch
from ..utils.trace import readback, span
from . import segtile

_M32 = 0xFFFFFFFF
_SID_BACK = 0x7FFFFFFF     # window back pads sort after every segment


def _ceil_log2(x: int) -> int:
    return max(1, math.ceil(math.log2(max(2, x))))


def split_sort_allocate_temp_memory(total_seg_length: int,
                                    total_seg_count: int):
    """API-parity shim (reference: SplitSort.cuh:674-690). Returns a handle."""
    return {"total_seg_length": total_seg_length,
            "total_seg_count": total_seg_count}


def split_sort_free_temp_memory(handle) -> None:
    """API-parity shim (reference: SplitSort.cuh:692-697)."""
    del handle


def _check_bounded_bits(bits_to_sort: int, kt: KeyType) -> None:
    """bits_to_sort < 32 bounds the RAW u32 key value (the reference's
    SplitSort keys are uint32_t, SplitSort.cuh:702); i32/f32 keys encode
    with the top bit set, so a bounded composite would truncate them."""
    if bits_to_sort < 32 and kt != KeyType.UINT32:
        raise ValueError(
            "bits_to_sort < 32 applies to uint32 keys only (the reference's "
            f"SplitSort key type); got {kt.name} keys")


def _host_offsets(seg_offsets) -> np.ndarray:
    """The offsets on the host as int64 holding their u32 values: one copy
    from the card for a CUDA tensor."""
    if isinstance(seg_offsets, torch.Tensor):
        t = seg_offsets
        if t.dtype == torch.uint32:
            t = t.view(torch.int32)
        with readback("offsets", t):
            t = t.cpu()
        return t.numpy().astype(np.int64) & _M32
    return np.asarray(seg_offsets).astype(np.int64) & _M32


def _device_offsets(seg_offsets, device: torch.device) -> torch.Tensor:
    if isinstance(seg_offsets, torch.Tensor):
        return seg_offsets.to(device)
    return codec.wrap_int32(torch.from_numpy(_host_offsets(seg_offsets))).to(
        device)


class SegSortPlan:
    """The host-side dispatch plan for one segment layout: fixed-length
    detection, the length histogram, window terms and length-class
    geometry, computed from one host copy of the offsets (the reference's
    segInfo readback, SplitSort.cuh:654-668) and reused by every call that
    passes it.  The plan is keyed to ONE offsets array and total length,
    and the sort functions trust it: a plan built from other offsets
    returns garbage, as the reference's segInfo would."""

    def __init__(self, seg_offsets, total_length: int,
                 total_seg_count: int | None = None):
        offs = _host_offsets(seg_offsets)
        self.offsets = offs
        self.total = int(total_length)
        self.seg_count = int(total_seg_count if total_seg_count is not None
                             else offs.shape[0])
        self.fixed_length = _fixed_length_of(offs, self.total, self.seg_count)
        self.max_len = _ordered_max_len(offs, self.total, self.seg_count)
        self.info = (config.get_device_info(seg_offsets.device)
                     if isinstance(seg_offsets, torch.Tensor) else None)
        self._window_plans: dict = {}

    def window_plan(self, bits_to_sort: int, has_payload: bool):
        """The (cached) _window_dispatch result for one key mode."""
        key = (bits_to_sort, has_payload)
        if key not in self._window_plans:
            with span("dispatch.window_plan"):
                self._window_plans[key] = _window_dispatch(
                    self.offsets, self.total, self.seg_count,
                    bits_to_sort=bits_to_sort, has_payload=has_payload,
                    info=self.info)
        return self._window_plans[key]


def make_segsort_plan(seg_offsets, total_length: int,
                      total_seg_count: int | None = None) -> SegSortPlan:
    """Build the reusable host-side dispatch plan (see SegSortPlan)."""
    return SegSortPlan(seg_offsets, total_length, total_seg_count)


def make_segsort_fn(plan: SegSortPlan, has_payload: bool = True,
                    bits_to_sort: int = 32, strategy: str = "auto"):
    """A segmented sort bound to one plan: fn(seg_offsets, keys[, values])
    (the deferred-dispatch analog of the reference's CommandBuffer
    overloads, OneSweep.cs:297-427).  A plain closure: PyTorch runs
    eagerly, so there is nothing to compile."""
    if has_payload:
        def fn(seg_offsets, keys, values):
            return split_sort_pairs(
                seg_offsets, keys, values, plan.seg_count, plan.total,
                bits_to_sort, strategy=strategy, plan=plan)
    else:
        def fn(seg_offsets, keys):
            return split_sort_keys(
                seg_offsets, keys, plan.seg_count, bits_to_sort,
                strategy=strategy, plan=plan)
    return fn


def _fixed_length_of(offs: np.ndarray, total_length: int, seg_count: int):
    """If every segment of the host offsets has the same length L, L, else
    None."""
    if offs.shape[0] != seg_count or seg_count == 0:
        return None
    if total_length % seg_count:
        return None
    L = total_length // seg_count
    if offs[0] != 0:
        return None
    if not np.array_equal(offs, np.arange(seg_count, dtype=np.int64) * L):
        return None
    return int(L)


def _ordered_max_len(offs: np.ndarray, total_length: int, seg_count: int):
    """The longest segment of host offsets that start at 0 and never
    decrease, one per segment (the layouts the tile route takes); None for
    any other offsets."""
    if seg_count == 0 or offs.shape[0] != seg_count or offs[0] != 0:
        return None
    lens = np.diff(offs, append=total_length)
    if lens.min() < 0:
        return None
    return int(lens.max())


def _takes_tile(max_len, n: int, total: int,
                info: config.DeviceInfo) -> bool:
    """Whether a random-length layout takes the tile route: on a CUDA card,
    with ordered offsets (`_ordered_max_len`) whose segments cover the
    keys, and its longest segment at most the routing row's
    `segsort_tile_max` (0 on every row but the card's)."""
    cap = min(config.get_routing_parameters(info).segsort_tile_max,
              segtile.MAX_TILE)
    return (info.platform == "cuda" and max_len is not None and total == n
            and max_len <= cap)


def _batched_segmented_sort(codes: torch.Tensor, payloads: tuple,
                            seg_count: int, L: int):
    """Fixed-length route: one batched sort of the (S, L) rows (the JAX
    package's mapped-row route for giant rows is a TPU VMEM device)."""
    k2 = codes.view(seg_count, L)
    if not payloads:
        # keys only on bare codes: the all-keys invariant holds
        with span("fixed.sort"):
            sk = flat_sort.sort_all_keys_unstable(k2, dim=1)
        return sk.reshape(-1), ()
    with span("fixed.sort"):
        sk, perm = torch.sort(k2, dim=1, stable=True)
    with span("fixed.gather"):
        ps = tuple(torch.gather(p.view(seg_count, L), 1, perm).reshape(-1)
                   for p in payloads)
    return sk.reshape(-1), ps


def _window_sid_bits(starts: np.ndarray, max_len: int) -> int:
    """Bits for a window-local segment index at the window `max_len`
    implies (both window grids): the most segments intersecting any window,
    those starting in it plus one straddling in."""
    L = max(128, 1 << (max(1, max_len - 1)).bit_length() + 1)
    max_int = 0
    for off in (0, L // 2):
        win = (starts + off) // L
        max_int = max(max_int, int(np.bincount(win).max()) + 1)
    return max(1, int(np.ceil(np.log2(max_int + 2))))


# Length-class split: applied when the small class covers most elements, the
# long tail is small, and the small class's window is much smaller.
_SPLIT_BULK_COVER = 0.75   # min element share the small class must cover
_SPLIT_MAX_TAIL = 0.25     # max element share in the long tail
_SPLIT_MIN_SHRINK = 4      # min window ratio that justifies the split


def _window_dispatch(seg_offsets, total: int, seg_count: int,
                     bits_to_sort: int = 32, has_payload: bool = False,
                     info: config.DeviceInfo | None = None):
    """The host-side dispatch plan off the 14-bucket length histogram (the
    reference's segInfo readback and per-bin launch decision,
    SplitSort.cuh:654-668, SplitSortBinning.cuh:360-438), judged against
    the window cap of the mode that would run (`_pick_window_mode`) under
    the routing row of `info`'s device.

    Returns None (the composite) or a dict:
      {"ml", "sid_bits"}  — the whole-workload window terms (absent when a
                            segment is longer than the last bin), plus
      {"split": {...}}    — the length-class split: the class bound T, the
                            bulk's ml/sid_bits, and the long segments'
                            starts/lens/k (host numpy), or
      {"classes": {...}}  — the multi-class plan (`_build_class_plan`),
                            when the whole window cannot run in this mode,
                            no split applies, and the extracted share is at
                            most `segsort_extract_max_frac`.
    """
    offs = _host_offsets(seg_offsets)
    if seg_count == 0 or offs.shape[0] != seg_count:
        return None
    lens = segment_lengths(offs, total)
    if lens.size == 0 or lens.min() < 0:
        return None
    hist = segment_length_histogram(lens)
    starts = offs.astype(np.int64)
    ml = int(lens.max())
    plan = {}
    if hist["gt_count"] == 0:
        plan["ml"] = ml
        plan["sid_bits"] = _window_sid_bits(starts, ml)

    if seg_count >= 2 and total > 0:
        bin_idx = np.searchsorted(np.asarray(BIN_BOUNDS), lens, side="left")
        w = np.cumsum(np.bincount(bin_idx, weights=lens,
                                  minlength=len(BIN_BOUNDS) + 1))
        covered = np.nonzero(w[:len(BIN_BOUNDS)]
                             >= _SPLIT_BULK_COVER * total)[0]
        if covered.size:
            T = BIN_BOUNDS[int(covered[0])]
            small = lens <= T
            tail_elems = int(lens[~small].sum())
            ml_small = int(lens[small].max()) if small.any() else 0
            # the whole-workload window cannot run in this workload's mode
            infeasible = "ml" not in plan or _pick_window_mode(
                plan["ml"], plan["sid_bits"], bits_to_sort,
                has_payload, info) is None
            shrink_ok = (1 << (max(1, ml - 1)).bit_length()) >= (
                _SPLIT_MIN_SHRINK * (1 << (max(1, ml_small - 1)).bit_length()))
            if (0 < tail_elems <= _SPLIT_MAX_TAIL * total
                    and (infeasible or shrink_ok)):
                plan["split"] = {
                    "T": T,
                    "ml": ml_small,
                    "sid_bits": _window_sid_bits(starts, max(2, ml_small)),
                    "long_starts": starts[~small],
                    "long_lens": lens[~small],
                    "k": tail_elems,
                }

    if "split" not in plan:
        whole_infeasible = ("ml" not in plan or _pick_window_mode(
            plan["ml"], plan["sid_bits"], bits_to_sort, has_payload, info)
            is None)
        if whole_infeasible:
            cp = _build_class_plan(starts, lens, total, bits_to_sort,
                                   has_payload, info)
            if cp is not None:
                extracted = (sum(c["k"] for c in cp["padded"])
                             + (cp["tail"]["k"] if cp["tail"] else 0))
                frac = extracted / max(total, 1)
                if frac <= config.get_routing_parameters(
                        info).segsort_extract_max_frac:
                    plan["classes"] = cp
    return plan or None


def _window_pass(sid, codes, payloads: tuple, L: int, offset: int, n: int,
                 mode: str = "stable3", fuse_bits: int = 0):
    """One batched row sort over L-wide windows starting at -offset, front-
    and back-padded so that pads keep out of every real window:
      stable3 — stable sort of the int64 (sid << 32 | u32 code) composite,
                payloads riding (signed sid: front pads -1, back pads
                0x7FFFFFFF);
      keys2   — the same composite, unstable (keys only: equal elements are
                identical);
      fused   — one u32 key, window-local segment index << fuse_bits | code
                (bounded bits, the SplitSortRadixFine analog,
                SplitSortVariants.cuh:846-1138), sid and code recovered
                afterwards with int64 shifts (torch has no unsigned >>).
    Returns (sid, codes, payloads) of the n real elements."""
    pad_front = offset
    pad_back = (-(n + offset)) % L

    def padf(x, front, back):
        return torch.cat([
            torch.full((pad_front,), front, dtype=x.dtype, device=x.device),
            x, torch.full((pad_back,), back, dtype=x.dtype, device=x.device)])

    sid_p = padf(sid, -1, _SID_BACK)
    codes_p = padf(codes, codec.SIGN, codec.SENTINEL)   # u32 0 and 2^32-1
    rows = sid_p.shape[0] // L
    s2 = sid_p.view(rows, L)
    c2 = codes_p.view(rows, L)
    p2 = tuple(padf(p, 0, 0).view(rows, L) for p in payloads)

    def unpad(r):
        return r.reshape(-1)[pad_front:pad_front + n]

    if mode == "fused":
        base = s2[:, :1].to(torch.int64)      # nondecreasing sids: row min
        loc = (s2.to(torch.int64) - base) & _M32
        ucode = (c2 ^ codec.SIGN).to(torch.int64) & _M32
        fused = ((loc << fuse_bits) | ucode) & _M32
        fused = torch.where(s2 == _SID_BACK, _M32, fused)
        fused = torch.where(s2 == -1, 0, fused)
        key = codec.wrap_int32(fused) ^ codec.SIGN      # biased u32 order
        if p2:
            sk, perm = torch.sort(key, dim=1, stable=True)
            pays = tuple(torch.gather(p, 1, perm) for p in p2)
        else:
            sk, pays = flat_sort.sort_all_keys_unstable(key, dim=1), ()
        f = (sk ^ codec.SIGN).to(torch.int64) & _M32
        code_out = codec.wrap_int32(f & ((1 << fuse_bits) - 1)) ^ codec.SIGN
        sid_out = codec.wrap_int32((f >> fuse_bits) + base)
        return (unpad(sid_out), unpad(code_out),
                tuple(unpad(r) for r in pays))

    comp = codec.join_wide(c2 ^ codec.SIGN, s2).view(rows, L)
    if mode == "keys2":
        sc, pays = flat_sort.sort_all_keys_unstable(comp, dim=1), ()
    else:
        sc, perm = torch.sort(comp, dim=1, stable=True)
        pays = tuple(torch.gather(p, 1, perm) for p in p2)
    lo, hi = codec.split_wide(sc.reshape(-1))
    return unpad(hi), unpad(lo ^ codec.SIGN), tuple(unpad(r) for r in pays)


def _windowed_segmented_sort(seg_offsets, codes, payloads: tuple,
                             seg_count: int, max_len: int,
                             mode: str = "stable3", fuse_bits: int = 0):
    """Random-length segments by two overlapping window sorts at offsets 0
    and L/2, L = 2 * ceil_pow2(max_len): every segment of length <= L/2
    lies wholly inside a window of one grid and is sorted there; the other
    pass leaves a sorted segment as it is.  No data moves between windows
    (the replacement for the reference's 14 per-bin kernels,
    SplitSort.cuh:751-930)."""
    n = codes.shape[0]
    L = max(128, 1 << (max(1, max_len - 1)).bit_length() + 1)
    sid = codec.wrap_int32(flat_sort.segment_ids_from_offsets(seg_offsets, n))
    sid1, c1, p1 = _window_pass(sid, codes, payloads, L, 0, n, mode,
                                fuse_bits)
    _, c2, p2 = _window_pass(sid1, c1, p1, L, L // 2, n, mode, fuse_bits)
    return c2, p2


def _packed_bins_segmented_sort(seg_offsets, offs: np.ndarray, codes,
                                payloads: tuple, seg_count: int, total: int,
                                capacity: int = 32):
    """strategy="packed", the SplitSortBins32 analog
    (SplitSortBinning.cuh:360-438, SplitSortVariants.cuh:386-451):
    next-fit packs consecutive segments into bins of <= capacity elements,
    each a contiguous span; the spans are gathered into (bins, capacity)
    rows, sorted stably by (segment id, code), and scattered back.  `offs`
    are the host offsets, `seg_offsets` the device ones."""
    n = codes.shape[0]
    lens = segment_lengths(offs, total)
    if lens.size and int(lens.max()) > capacity:
        raise ValueError(
            f"packed strategy requires every segment length <= {capacity}")
    bin_ids, nbins = next_fit_bin_packing(lens, capacity)
    if nbins == 0 or n == 0:
        return codes, payloads
    first_seg = np.searchsorted(bin_ids, np.arange(nbins), side="left")
    span_start = offs[first_seg]
    span_end = np.append(span_start[1:], np.int64(total))

    dev = codes.device
    sid = codec.wrap_int32(flat_sort.segment_ids_from_offsets(seg_offsets, n))
    starts = torch.from_numpy(span_start).to(dev)
    ends = torch.from_numpy(span_end).to(dev)
    idx = starts[:, None] + torch.arange(capacity, device=dev)[None, :]
    pad = idx >= ends[:, None]
    safe = idx.clamp(max=n - 1)
    s2 = torch.where(pad, _SID_BACK, sid[safe])
    c2 = torch.where(pad, codec.SENTINEL, codes[safe])
    comp = codec.join_wide(c2 ^ codec.SIGN, s2).view(pad.shape)
    if payloads:
        sc, perm = torch.sort(comp, dim=1, stable=True)
        rows = tuple(torch.gather(torch.where(pad, 0, p[safe]), 1, perm)
                     for p in payloads)
    else:
        # keys only on bare codes: equal (sid, code) elements are identical
        sc, rows = flat_sort.sort_all_keys_unstable(comp, dim=1), ()
    rc = codec.split_wide(sc.reshape(-1))[0] ^ codec.SIGN
    # pads sort to the row ends, so the real elements land back on their
    # spans; pad lanes go to a slot past the end that is cut off
    tgt = torch.where(pad, n, idx).reshape(-1)

    def put(x, r):
        buf = torch.cat([x, x.new_zeros(1)])
        buf.scatter_(0, tgt, r.reshape(-1))
        return buf[:n]

    return put(codes, rc), tuple(put(p, r) for p, r in zip(payloads, rows))


def _low_bits(sorted_comp: torch.Tensor, mask: int) -> torch.Tensor:
    """Biased carriers of the low bits of sorted biased u32 composites."""
    return ((sorted_comp ^ codec.SIGN) & mask) ^ codec.SIGN


def _composite_multi(seg_offsets, codes, payloads: tuple, seg_count: int,
                     bits_to_sort: int):
    """Whole-buffer composite (segment id, key) sort, any payload count
    (SplitSortLarge.cuh:1198-1289); stability keeps the in-segment payload
    order.  When seg_bits + bits_to_sort <= 32 the composite is one u32 key
    (the bits_to_sort lever), which rides the range-exchange engine where
    AUTO routes its size there; otherwise it is the int64 (segment, code)
    key of `flat_sort.segmented_sort_pairs`.  The branch taken is the span
    `composite.u32` or `composite.i64`; inside it `composite.build`
    (segment ids and the composite key), `composite.sort` and, where a
    permutation is applied, `composite.gather` (the codes and the payload
    planes read out by it).  Returns (codes, payloads)."""
    seg_bits = _ceil_log2(seg_count) + 1
    if seg_bits + bits_to_sort <= 32:
        with span("composite.u32"):
            return _composite_u32(seg_offsets, codes, payloads,
                                  bits_to_sort)
    with span("composite.i64"):
        return _composite_i64(seg_offsets, codes, payloads)


def _composite_u32(seg_offsets, codes, payloads: tuple, bits_to_sort: int):
    """`_composite_multi`'s one-u32-key branch."""
    n = codes.shape[0]
    info = config.get_device_info(codes.device)
    with span("composite.build"):
        seg_ids = flat_sort.segment_ids_from_offsets(seg_offsets, n)
        ucode = (codes ^ codec.SIGN).to(torch.int64) & _M32
        comp = codec.wrap_int32(((seg_ids << bits_to_sort) | ucode) & _M32
                                ) ^ codec.SIGN
    mask = (1 << bits_to_sort) - 1
    if not payloads:
        with span("composite.sort"):
            if config.auto_engine(n, info=info) == "rangesweep":
                return _low_bits(rangesweep.sort_codes_rangesweep(comp),
                                 mask), ()
            # (composite, code) as one int64 key: every operand a key
            key = codec.join_wide(codes ^ codec.SIGN, comp)
            sk = flat_sort.sort_all_keys_unstable(key)
            return codec.split_wide(sk)[0] ^ codec.SIGN, ()
    wide = len(payloads) > 1
    if config.auto_engine(n, Mode.PAIRS, payload_bits=64 if wide else 32,
                          info=info) == "rangesweep":
        r = config.get_routing_parameters(info)
        with span("composite.sort"):
            res = rangesweep.sort_pairs_rangesweep_planes(
                comp, tuple(payloads),
                seg_elems=(r.rangesweep_seg_elems_pairs_wide if wide
                           else r.rangesweep_seg_elems_pairs))
            return _low_bits(res[0], mask), tuple(res[1:])
    with span("composite.sort"):
        _, perm = torch.sort(comp, stable=True)
    with span("composite.gather"):
        return codes[perm], tuple(p[perm] for p in payloads)


def _composite_i64(seg_offsets, codes, payloads: tuple):
    """`_composite_multi`'s int64 (segment, code) branch."""
    with span("composite.build"):
        seg_ids = flat_sort.segment_ids_from_offsets(seg_offsets,
                                                     codes.shape[0])
        # (segment - 2^31) in the high half: signed order is (segment, code)
        key = codec.join_wide(codes ^ codec.SIGN,
                              codec.wrap_int32(seg_ids - 0x80000000))
    if not payloads:
        with span("composite.sort"):
            sk = flat_sort.sort_all_keys_unstable(key)
            return codec.split_wide(sk)[0] ^ codec.SIGN, ()
    with span("composite.sort"):
        sk, perm = torch.sort(key, stable=True)
    with span("composite.gather"):
        return (codec.split_wide(sk)[0] ^ codec.SIGN,
                tuple(p[perm] for p in payloads))


def _interval_mask(starts: np.ndarray, lens: np.ndarray, n: int,
                   device: torch.device) -> torch.Tensor:
    """Per-element membership in the host-known, disjoint intervals
    [start, start + len): +1/-1 marks at the bounds, then a running sum.
    A bound at n lands in a slot past the end and is dropped."""
    bounds = np.concatenate([starts, starts + lens]).astype(np.int64)
    delta = np.concatenate([np.ones(len(starts), np.int32),
                            -np.ones(len(starts), np.int32)])
    marks = torch.zeros(n + 1, dtype=torch.int32, device=device)
    marks.index_add_(0, torch.from_numpy(bounds).to(device).clamp(max=n),
                     torch.from_numpy(delta).to(device))
    return torch.cumsum(marks[:n], 0, dtype=torch.int32) > 0


def _dense_tail_composite(codes, payloads: tuple, starts: np.ndarray,
                          lens: np.ndarray, k: int, bits_to_sort: int):
    """Compact the named segments out (one `compact_ops`), composite-sort
    them as their own workload, and expand the result back (one
    `expand_ops`).  Returns (mask, sorted planes expanded back).  Elements
    come from the ORIGINAL planes in input order, so stability holds."""
    dev = codes.device
    mask = _interval_mask(starts, lens, codes.shape[0], dev)
    packed, _ = stitch.compact_ops((codes,) + payloads, mask)
    t_offs = codec.wrap_int32(torch.from_numpy(
        np.concatenate([[0], np.cumsum(lens)])[:-1].astype(np.int64))).to(dev)
    sc_t, ps_t = _composite_multi(t_offs, packed[0][:k],
                                  tuple(p[:k] for p in packed[1:]),
                                  len(lens), bits_to_sort)
    return mask, stitch.expand_ops((sc_t,) + ps_t, mask)


def _padded_rows_class_sort(codes, payloads: tuple, cls: dict, n: int):
    """Sort one extracted length class (lengths in (B/2, B]) as padded rows
    (the reference's per-bin kernel launch, SplitSort.cuh:751-930): compact
    the class out, expand it into (S_c, B) rows whose prefix is one segment
    and whose suffix is sentinel-padded, sort every row at once, and take
    the same two steps back.  Pads are a row suffix, so a stable sort keeps
    real 0xFFFFFFFF keys ahead of them (OneSweep.cu:195-205).  Two
    `compact_ops` and two `expand_ops`; returns (mask, planes expanded
    back)."""
    starts, lens, k, B = cls["starts"], cls["lens"], cls["k"], cls["B"]
    S_c = len(lens)
    dev = codes.device
    mask = _interval_mask(starts, lens, n, dev)
    packed, _ = stitch.compact_ops((codes,) + payloads, mask)
    lens_dev = torch.from_numpy(lens.astype(np.int64)).to(dev)
    maskp = (torch.arange(B, device=dev)[None, :]
             < lens_dev[:, None]).reshape(-1)
    exp = stitch.expand_ops(tuple(p[:k] for p in packed), maskp)
    k2 = torch.where(maskp, exp[0], codec.SENTINEL).view(S_c, B)
    if payloads:
        sk, perm = torch.sort(k2, dim=1, stable=True)
        res = (sk,) + tuple(torch.gather(e.view(S_c, B), 1, perm)
                            for e in exp[1:])
    else:
        # keys only on bare codes: unstable == stable
        res = (flat_sort.sort_all_keys_unstable(k2, dim=1),)
    packed2, _ = stitch.compact_ops(tuple(x.reshape(-1) for x in res),
                                    maskp)
    back = stitch.expand_ops(tuple(p[:k] for p in packed2), mask)
    return mask, back


def _build_class_plan(starts: np.ndarray, lens: np.ndarray, total: int,
                      bits_to_sort: int, has_payload: bool,
                      info: config.DeviceInfo | None = None):
    """The host-side multi-class plan (the executed form of the reference's
    14-bin dispatch, SplitSort.cuh:740-930):
      bulk   — every segment <= segsort_bulk_max window-sorts in place;
      padded — each occupied power-of-two class up to segsort_padded_max is
               extracted and sorted as padded rows;
      tail   — longer segments extract to a dense composite.
    None when there is nothing to split."""
    r = config.get_routing_parameters(info)
    if total <= 0 or lens.size == 0:
        return None
    # power-of-two class bound per segment (min class 2: length-1 segments
    # need no sorting but still belong to the bulk)
    bnd = np.power(2, np.ceil(np.log2(np.maximum(lens, 2)))).astype(np.int64)
    occupied = np.unique(bnd)
    bulk_sel = bnd <= r.segsort_bulk_max
    bulk = None
    if bulk_sel.any():
        ml_b = int(lens[bulk_sel].max())
        bulk = {"ml": ml_b,
                "sid_bits": _window_sid_bits(starts, max(2, ml_b))}
    padded = []
    for B in occupied:
        if B <= r.segsort_bulk_max or B > r.segsort_padded_max:
            continue
        sel = bnd == B
        padded.append({
            "B": int(B),
            "starts": starts[sel],
            "lens": lens[sel],
            "k": int(lens[sel].sum()),
        })
    tail = None
    t_sel = bnd > r.segsort_padded_max
    if t_sel.any():
        tail = {"starts": starts[t_sel], "lens": lens[t_sel],
                "k": int(lens[t_sel].sum())}
    if not padded and (tail is None or bulk is None):
        # every class is bulk-feasible (the whole window would have run),
        # or every segment is tail-class (the plain composite is the same
        # sort without the copies)
        return None
    return {"bulk": bulk, "padded": padded, "tail": tail}


def _multi_class_segmented_sort(seg_offsets, codes, payloads: tuple,
                                seg_count: int, cplan: dict,
                                bits_to_sort: int, has_payload: bool,
                                info: config.DeviceInfo | None = None):
    """Run a _build_class_plan: bulk windows in place, then each padded
    class and the tail, each read from the ORIGINAL planes and written over
    its own spans only."""
    n = codes.shape[0]
    bulk = cplan["bulk"]
    if bulk is not None and bulk["ml"] > 1:
        mode = _pick_window_mode(bulk["ml"], bulk["sid_bits"],
                                 bits_to_sort, has_payload, info)
        if mode is None:
            # the caps choose a mechanism, not correctness: a routing row
            # below segsort_bulk_max must not skip the bulk sort
            mode = "stable3" if has_payload else "keys2"
        out_c, out_p = _windowed_segmented_sort(
            seg_offsets, codes, payloads, seg_count, bulk["ml"], mode=mode,
            fuse_bits=bits_to_sort if mode == "fused" else 0)
    else:
        out_c, out_p = codes, payloads
    for cls in cplan["padded"]:
        mask, srt = _padded_rows_class_sort(codes, payloads, cls, n)
        out_c = torch.where(mask, srt[0], out_c)
        out_p = tuple(torch.where(mask, s, o)
                      for s, o in zip(srt[1:], out_p))
    if cplan["tail"] is not None:
        t = cplan["tail"]
        mask, srt = _dense_tail_composite(codes, payloads, t["starts"],
                                          t["lens"], t["k"], bits_to_sort)
        out_c = torch.where(mask, srt[0], out_c)
        out_p = tuple(torch.where(mask, s, o)
                      for s, o in zip(srt[1:], out_p))
    return out_c, out_p


def _split_class_segmented_sort(seg_offsets, codes, payloads: tuple,
                                seg_count: int, split: dict,
                                mode: str | None, fuse_bits: int,
                                bits_to_sort: int):
    """The length-class split (SplitSortBinning.cuh:360-438,
    SplitSort.cuh:740-930): the bulk window-sorts in place at its own small
    window (long segments ride along within their spans and are overwritten
    afterwards), and the long tail is compacted out, composite-sorted and
    expanded back: one `compact_ops` and one `expand_ops`."""
    if split["ml"] > 1 and mode is not None:
        c_b, p_b = _windowed_segmented_sort(
            seg_offsets, codes, payloads, seg_count, split["ml"],
            mode=mode, fuse_bits=fuse_bits)
    else:
        c_b, p_b = codes, payloads      # a bulk of length <= 1 is sorted
    mask, exp = _dense_tail_composite(
        codes, payloads, split["long_starts"], split["long_lens"],
        split["k"], bits_to_sort)
    out_c = torch.where(mask, exp[0], c_b)
    out_p = tuple(torch.where(mask, e, pb) for e, pb in zip(exp[1:], p_b))
    return out_c, out_p


def _pick_window_mode(ml: int, sid_bits: int, bits_to_sort: int,
                      has_payload: bool,
                      info: config.DeviceInfo | None = None):
    """The window key mode: fused when the bounded-bits key fits, else the
    cheapest exact multi-operand sort under the routing row's window caps;
    None when the cap of that mode is exceeded."""
    r = config.get_routing_parameters(info)
    fusable = sid_bits + bits_to_sort <= 31
    if fusable and ml <= r.window_max_fused:
        return "fused"
    if not has_payload:
        return "keys2" if ml <= r.window_max_keys else None
    return "stable3" if ml <= r.window_max_pairs else None


def _random_length_route(plan, bits_to_sort: int, has_payload: bool,
                         info: config.DeviceInfo | None = None):
    """The route a `_window_dispatch` plan takes: ("split", bulk mode),
    ("classes", None), ("window", mode) or ("composite", None)."""
    if plan:
        split = plan.get("split")
        if split is not None:
            if split["ml"] <= 1:
                return "split", None    # a bulk of length <= 1 is sorted
            bmode = _pick_window_mode(split["ml"], split["sid_bits"],
                                      bits_to_sort, has_payload, info)
            if bmode is not None:
                return "split", bmode
        if "classes" in plan:
            return "classes", None
        if "ml" in plan:
            mode = _pick_window_mode(plan["ml"], plan["sid_bits"],
                                     bits_to_sort, has_payload, info)
            if mode is not None:
                return "window", mode
    return "composite", None


def _check_call(bits_to_sort: int, strategy: str, keys: torch.Tensor,
                planes: tuple) -> KeyType:
    if not 4 <= bits_to_sort <= 32:
        raise ValueError("bits_to_sort must be in [4, 32] (reference contract)")
    if strategy not in ("auto", "packed"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if keys.ndim != 1:
        raise ValueError(f"keys must be 1-D, got shape {tuple(keys.shape)}")
    for p in planes:
        if p.shape != keys.shape:
            raise ValueError(f"payload shape {tuple(p.shape)} != keys shape "
                             f"{tuple(keys.shape)}")
    kt = codec.key_type_of(keys)
    _check_bounded_bits(bits_to_sort, kt)
    return kt


def _segmented_sort(seg_offsets, keys: torch.Tensor, planes: tuple,
                    total_seg_count: int, total: int, bits_to_sort: int,
                    strategy: str, plan: SegSortPlan | None):
    """The route choice shared by the public functions, on raw keys and
    payload bit planes (int32 planes, or one int64 plane).  Returns (sorted
    keys, sorted planes) in the form they came."""
    if plan is not None and (plan.seg_count != total_seg_count
                             or plan.total != total):
        raise ValueError(
            f"plan was built for (seg_count={plan.seg_count}, "
            f"total={plan.total}), this call has ({total_seg_count}, "
            f"{total})")
    offs_dev = _device_offsets(seg_offsets, keys.device)
    offs = plan.offsets if plan is not None else _host_offsets(seg_offsets)
    has_payload = bool(planes)
    info = config.get_device_info(keys.device)
    wp = L = mode = max_len = None
    with span("dispatch.route"):
        if strategy == "packed":
            route = "packed"
        else:
            L = (plan.fixed_length if plan is not None
                 else _fixed_length_of(offs, total, total_seg_count))
            if L is not None and L > 1:
                route = "fixed"
            else:
                max_len = (plan.max_len if plan is not None else
                           _ordered_max_len(offs, total, total_seg_count))
                if _takes_tile(max_len, keys.shape[0], total, info):
                    route = "tile"
                else:
                    if plan is not None:
                        wp = plan.window_plan(bits_to_sort, has_payload)
                    else:
                        with span("dispatch.window_plan"):
                            wp = _window_dispatch(
                                offs, total, total_seg_count,
                                bits_to_sort=bits_to_sort,
                                has_payload=has_payload, info=info)
                    route, mode = _random_length_route(wp, bits_to_sort,
                                                       has_payload, info)
    if route == "tile":
        with span("engine.tile"):
            return segtile.sort(offs_dev, keys, planes, bits_to_sort,
                                max_len=max_len)
    kt = codec.key_type_of(keys)
    codes = codec.encode_biased(keys)
    wide = has_payload and planes[0].dtype == torch.int64
    if wide:
        with span("payload.split"):
            planes = codec.split_wide(planes[0])
    with span("engine." + route):
        sc, ps = _run_route(route, offs_dev, offs, codes, planes,
                            total_seg_count, total, L, wp, mode,
                            bits_to_sort, has_payload, info)
    if wide:
        with span("payload.join"):
            ps = (codec.join_wide(*ps),)
    return codec.decode_biased(sc, kt), ps


def _run_route(route: str, offs_dev, offs: np.ndarray, codes, payloads,
               seg_count: int, total: int, L, wp, mode, bits_to_sort: int,
               has_payload: bool, info):
    """Enqueue a route other than the tile on biased codes and int32
    payload planes; returns (sorted codes, sorted planes)."""
    if route == "packed":
        return _packed_bins_segmented_sort(offs_dev, offs, codes, payloads,
                                           seg_count, total)
    if route == "fixed":
        return _batched_segmented_sort(codes, payloads, seg_count, L)
    fuse_bits = bits_to_sort if mode == "fused" else 0
    if route == "split":
        return _split_class_segmented_sort(
            offs_dev, codes, payloads, seg_count, wp["split"], mode,
            fuse_bits, bits_to_sort)
    if route == "classes":
        return _multi_class_segmented_sort(
            offs_dev, codes, payloads, seg_count, wp["classes"],
            bits_to_sort, has_payload, info)
    if route == "window":
        return _windowed_segmented_sort(offs_dev, codes, payloads, seg_count,
                                        wp["ml"], mode=mode,
                                        fuse_bits=fuse_bits)
    return _composite_multi(offs_dev, codes, payloads, seg_count,
                            bits_to_sort)


def split_sort_pairs(
    seg_offsets,
    keys: torch.Tensor,
    values: torch.Tensor | None,
    total_seg_count: int,
    total_seg_length: int | None = None,
    bits_to_sort: int = 32,
    strategy: str = "auto",
    plan: SegSortPlan | None = None,
):
    """Sort each segment independently, stable within segments.

    Reference: SplitSortPairs<BITS_TO_SORT, V> (SplitSort.cuh:702-934).
    `seg_offsets` are the exclusive-prefix starts (an int32/uint32 tensor,
    or an array); keys are u32/i32/f32; `values=None` is the keys-only
    form; a 64-bit payload rides as one plane on the tile route and as two
    int32 planes on the others.  strategy="packed" forces the next-fit bin
    gather (every segment <= 32 long); "auto" picks a route from the
    offsets.  `plan` (make_segsort_plan) carries that choice and saves the
    offsets' host copy.
    """
    planes = () if values is None else (values,)
    _check_call(bits_to_sort, strategy, keys, planes)
    total = keys.shape[0] if total_seg_length is None else total_seg_length
    if values is not None:
        planes = (codec.payload_to_bits(values.contiguous()),)
    sk, ps = _segmented_sort(seg_offsets, keys.contiguous(), planes,
                             total_seg_count, total, bits_to_sort, strategy,
                             plan)
    if values is None:
        return sk
    return sk, codec.bits_to_payload(ps[0], values.dtype)


def split_sort_pairs_wide(
    seg_offsets,
    keys: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    total_seg_count: int,
    total_seg_length: int | None = None,
    bits_to_sort: int = 32,
    strategy: str = "auto",
    plan: SegSortPlan | None = None,
):
    """Segmented pair sort with a 64-bit payload given as two 32-bit planes
    (lo, hi): the reference's SplitSortPairs<BITS, double> instantiation
    (SplitSort.cuh:702).  Returns (keys, lo, hi)."""
    _check_call(bits_to_sort, strategy, keys, (lo, hi))
    if lo.dtype.itemsize != 4 or hi.dtype.itemsize != 4:
        raise TypeError(f"lo/hi planes must be 32-bit, got {lo.dtype}, "
                        f"{hi.dtype}")
    total = keys.shape[0] if total_seg_length is None else total_seg_length
    sk, (slo, shi) = _segmented_sort(
        seg_offsets, keys.contiguous(), (lo.contiguous().view(torch.int32),
                                         hi.contiguous().view(torch.int32)),
        total_seg_count, total, bits_to_sort, strategy, plan)
    return sk, slo.view(lo.dtype), shi.view(hi.dtype)


def split_sort_keys(
    seg_offsets,
    keys: torch.Tensor,
    total_seg_count: int,
    bits_to_sort: int = 32,
    strategy: str = "auto",
    plan: SegSortPlan | None = None,
):
    """Keys-only segmented sort (see split_sort_pairs)."""
    return split_sort_pairs(
        seg_offsets, keys, None, total_seg_count, None, bits_to_sort,
        strategy=strategy, plan=plan)


# ---------------------------------------------------------------------------
# Binning metadata (reference: SplitSortBinning.cuh — NextFitBinPacking, the
# 14-bucket histogram), computed on the host like the reference's segInfo.
# ---------------------------------------------------------------------------

# Reference bin upper bounds (SplitSort.cuh:740-930): 14 length classes.
BIN_BOUNDS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 6144, 8192,
              16384, 32768, 65536, 131072)


def segment_lengths(seg_offsets, total_length: int) -> np.ndarray:
    """Lengths from the exclusive-prefix offsets array (host-side)."""
    offs = np.asarray(seg_offsets, dtype=np.int64)
    ends = np.append(offs[1:], np.int64(total_length))
    return (ends - offs).astype(np.int64)


def segment_length_histogram(lengths) -> dict:
    """14-bucket histogram and large-segment stats
    (SplitSortBinning.cuh:360-438): {"counts": (14,), "gt_count": int,
    "gt_total_length": int}, counts[i] the segments with
    BIN_BOUNDS[i-1] < len <= BIN_BOUNDS[i]."""
    lengths = np.asarray(lengths, dtype=np.int64)
    gt = lengths > BIN_BOUNDS[-1]
    edges = np.array((0,) + BIN_BOUNDS, dtype=np.int64)
    idx = np.searchsorted(edges, lengths[~gt], side="left")
    counts = np.bincount(np.clip(idx, 1, len(BIN_BOUNDS)) - 1,
                         minlength=len(BIN_BOUNDS))
    return {
        "counts": counts.astype(np.int64),
        "gt_count": int(gt.sum()),
        "gt_total_length": int(lengths[gt].sum()),
    }


def next_fit_bin_packing(lengths, bin_capacity: int = 32):
    """Next-fit packing of <= capacity segments into capacity-sized bins
    (NextFitBinPacking, SplitSortBinning.cuh:360-438), driving
    strategy="packed".  Returns (bin id per segment, bin count); segments
    longer than the capacity get bin id -1.  Next fit is sequential, so
    this is a host loop over plain ints."""
    lengths = np.asarray(lengths, dtype=np.int64)
    bin_ids = []
    fill = bin_capacity + 1  # force a new bin on the first packable segment
    b = -1
    for l in lengths.tolist():
        if l > bin_capacity:
            bin_ids.append(-1)
            continue
        if fill + l > bin_capacity:
            b += 1
            fill = 0
        bin_ids.append(b)
        fill += l
    return np.asarray(bin_ids, dtype=np.int64).reshape(lengths.shape), b + 1


class SplitSorter:
    """Object wrapper owning the temp-memory lifecycle (reference API
    shape)."""

    def __init__(self, total_seg_length: int, total_seg_count: int):
        self._handle = split_sort_allocate_temp_memory(
            total_seg_length, total_seg_count)
        self.total_seg_length = total_seg_length
        self.total_seg_count = total_seg_count

    def sort_pairs(self, seg_offsets, keys, values, bits_to_sort: int = 32,
                   strategy: str = "auto",
                   plan: SegSortPlan | None = None):
        return split_sort_pairs(
            seg_offsets, keys, values, self.total_seg_count,
            self.total_seg_length, bits_to_sort, strategy=strategy,
            plan=plan)

    def sort_keys(self, seg_offsets, keys, bits_to_sort: int = 32,
                  strategy: str = "auto",
                  plan: SegSortPlan | None = None):
        return split_sort_keys(
            seg_offsets, keys, self.total_seg_count, bits_to_sort,
            strategy=strategy, plan=plan)

    def close(self):
        split_sort_free_temp_memory(self._handle)
        self._handle = None
