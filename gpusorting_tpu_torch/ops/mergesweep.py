"""Mergesweep — a sort of each segment, then Batcher merge passes.

Port of `gpusorting_tpu/ops/mergesweep.py`.  For N = 2^p elements (padded
with INT32_MAX), in segments of L = `seg_elems`:

  1. phase 1: one batched `torch.sort` of the N / L segments, odd segments
     descending, so that every pair of neighbours forms a bitonic run (JAX
     maps `lax.sort` over the segments with the keys bit-flipped in the odd
     ones; a library sort either way).  Two keys sort as one int64
     composite; more keys as a chain of stable sorts, last key first.
  2. phase 2: merge passes k = 2L, 4L, ..., N of the bitonic network, each
       - its strides of at least a tile (`run_high_strides`, which the
         network's levels above the tile run too): `hyper_stage` trips
         (kernel `csrc/mergesweep.cu`, replacing `_hyper_stage_kernel`),
         each taking as many consecutive strides in one read and one write
         as a block holds (`level_trips`); or, with the hyper switch off,
         one `bitonic.global_stage` each (JAX calls `_build_global_stage`
         there);
       - its strides below the tile: one `merge_tail` (replacing
         `_merge_tail_kernel`), a launch of the network's in-tile kernel
         (`csrc/bitonic.cu`, `local_stages`' register runs) on the
         schedule (j, k) for j = min(k, tile)/2, ..., 1, in place.

The tile is the network's shared-memory tile for the tensor's device and
operand count (`bitonic.network_tile_rows`); JAX sizes its own by VMEM
(`_tile_rows_for`), and the output does not depend on it.  The hyper switch
is `_USE_HYPER`, read from GST_MERGESWEEP_HYPER at import: on ("1") by
default, where JAX keeps it off for a Mosaic crash that does not apply to
CUDA; "0" runs one global stage a stride.  A trip gathers W = 2^s members
of a group (s stages) x cols consecutive offsets, W * cols elements a
plane, which the kernel holds in its threads' registers and, between
register runs, in shared memory.  The engines size every trip's group to
the most a block holds (`level_trips`: 2^15 elements on one plane, at most
the tile), so a trip takes at most log2(budget / 8) stages: at N = 2^28 on
one plane (12 stages a trip) the last level's 13 high strides take 2 trips
(7 + 6), a keys sort through the network 14 trips and a pairs sort (3
planes, 2^14 elements, 11 stages a trip) 17.
"""

from __future__ import annotations

import functools
import os

import torch

from ..core.config import get_device_info, get_routing_parameters
from ..utils.trace import launch_counter
from . import _nvcc, bitonic

LANES = bitonic.LANES
MAX_OPS = bitonic.MAX_OPS
INT32_MAX = bitonic.INT32_MAX
MIN_COLS = 8           # consecutive offsets a hyper-stage gather reads
SOURCE = _nvcc.CSRC / "mergesweep.cu"
# csrc/mergesweep.cu: int4 slots a thread holds for 1-4 planes (kItems),
# and its most threads a block (kMaxThreads), so a group of W x cols
# elements a plane takes W cols / (4 items) threads, 1 to HYPER_MAX_THREADS
HYPER_ITEMS = {1: 16, 2: 8, 3: 8, 4: 4}
HYPER_MAX_THREADS = 512

_USE_HYPER = os.environ.get("GST_MERGESWEEP_HYPER", "1") == "1"


def _pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


def _check(op, planes, num_keys, k, tile_rows=1):
    bitonic._check_planes(op, planes, num_keys, tile_rows)
    n = planes[0].numel()
    if not _pow2(n) or n > bitonic.MAX_N:
        raise ValueError(f"{op}: {n} elements are not a power of two up to "
                         f"{bitonic.MAX_N}")
    if not _pow2(k) or k < 2 or k > n:
        raise ValueError(f"{op}: pass k={k} is not a power of two in "
                         f"[2, {n}]")


def _check_hyper(planes, num_keys, k, j_hi, j_lo):
    _check("hyper_stage", planes, num_keys, k)
    if (not _pow2(j_lo) or not _pow2(j_hi) or j_lo < MIN_COLS
            or j_hi < j_lo or k <= j_hi):
        raise ValueError(f"hyper_stage: strides {j_hi}..{j_lo} are not a "
                         f"run of pass k={k}")


def _check_cuda(op, planes):
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError(f"{op}: unsupported device {dev}")
    for i, p in enumerate(planes):
        _nvcc.check(op, f"planes[{i}]", p, tuple(planes[0].shape), dev,
                    ref="planes[0]")
    return dev


def _spare(planes) -> list:
    return [p.data_ptr() for p in planes] + [None] * (MAX_OPS - len(planes))


# ---- merge_tail -----------------------------------------------------------


def merge_tail_plain(planes, k: int, tile_rows: int, num_keys: int) -> list:
    """Plain version of `merge_tail`, in place as it is: one
    `bitonic._stage_plain` per stride."""
    _check("merge_tail", planes, num_keys, k, tile_rows)
    flat = [p.reshape(-1) for p in planes]
    j = min(k, tile_rows * LANES) // 2
    while j >= 1:
        flat = bitonic._stage_plain(flat, j, k, num_keys)
        j //= 2
    for p, x in zip(planes, flat):
        p.view(-1).copy_(x)
    return planes


@functools.lru_cache(maxsize=256)
def _tail_table(dev: torch.device, k: int, tile_elems: int) -> tuple:
    """The tail's schedule and run table on `dev`, as
    `bitonic._device_schedule` builds them, once per device, pass and
    tile."""
    sched = bitonic.tail_schedule(tile_elems, k)
    return bitonic._device_schedule(dev, tile_elems, sched.numpy().tobytes())


@launch_counter
def merge_tail(planes, k: int, tile_rows: int, num_keys: int) -> list:
    """The strides j = min(k, tile)/2, ..., 1 of merge pass k on every tile
    of `tile_rows` rows of 1-4 (rows, 128) int32 planes, IN PLACE (the
    engine runs it on buffers it owns).  Returns the planes.

    CUDA planes launch the network's in-tile kernel (`csrc/bitonic.cu`)
    once on `bitonic.tail_schedule(tile, k)`, in place (or raise), counted
    here and not in `bitonic.local_stages.launches`; CPU planes take
    `merge_tail_plain`."""
    _check("merge_tail", planes, num_keys, k, tile_rows)
    if planes[0].device.type == "cpu":
        return merge_tail_plain(planes, k, tile_rows, num_keys)
    dev = _check_cuda("merge_tail", planes)
    tile_elems = tile_rows * LANES
    table, num_stages, num_runs = _tail_table(dev, k, tile_elems)
    ptrs = _spare(planes)
    _nvcc.launch("merge_tail", _nvcc.load(bitonic.SOURCE).gst_local_stages,
                 *ptrs, *ptrs, table.data_ptr() + 16 * num_runs, num_stages,
                 table.data_ptr(), num_runs, len(planes), num_keys,
                 planes[0].shape[0] // tile_rows, tile_elems, device=dev)
    merge_tail.launches += 1
    return planes


# ---- hyper_stage ----------------------------------------------------------


def hyper_stage_plain(planes, k: int, j_hi: int, j_lo: int, num_keys: int,
                      cols: int = MIN_COLS) -> list:
    """Plain version of `hyper_stage`, in place as it is (`cols` only
    shapes the kernel's blocks)."""
    _check_hyper(planes, num_keys, k, j_hi, j_lo)
    flat = [p.reshape(-1) for p in planes]
    j = j_hi
    while j >= j_lo:
        flat = bitonic._stage_plain(flat, j, k, num_keys)
        j //= 2
    for p, x in zip(planes, flat):
        p.view(-1).copy_(x)
    return planes


@launch_counter
def hyper_stage(planes, k: int, j_hi: int, j_lo: int, num_keys: int,
                cols: int = MIN_COLS) -> list:
    """The consecutive strides j_hi, j_hi/2, ..., j_lo of level k over 1-4
    (rows, 128) int32 planes of N = rows * 128 elements, N a power of two,
    IN PLACE, in one read and one write of each plane.  A block takes
    W = 2 j_hi / j_lo members x `cols` consecutive offsets of every plane
    (cols a power of two in [8, j_lo]), in its threads' registers: W cols /
    (4 HYPER_ITEMS[planes]) threads, which on a card must be 1 to
    HYPER_MAX_THREADS.  Returns the planes.

    CUDA planes launch `csrc/mergesweep.cu` once (or raise); CPU planes
    take `hyper_stage_plain`."""
    _check_hyper(planes, num_keys, k, j_hi, j_lo)
    if not _pow2(cols) or not MIN_COLS <= cols <= j_lo:
        raise ValueError(f"hyper_stage: cols={cols} is not a power of two "
                         f"in [{MIN_COLS}, {j_lo}]")
    if planes[0].device.type == "cpu":
        return hyper_stage_plain(planes, k, j_hi, j_lo, num_keys, cols)
    dev = _check_cuda("hyper_stage", planes)
    slots = 2 * j_hi // j_lo * cols // 4
    items = HYPER_ITEMS[len(planes)]
    if not items <= slots <= items * HYPER_MAX_THREADS:
        raise ValueError(f"hyper_stage: a group of {4 * slots} elements a "
                         f"plane is not {4 * items} to "
                         f"{4 * items * HYPER_MAX_THREADS} ({items} int4 a "
                         f"thread, 1 to {HYPER_MAX_THREADS} threads)")
    _nvcc.launch("hyper_stage", _nvcc.load(SOURCE).gst_hyper_stage,
                 *_spare(planes), len(planes), num_keys, planes[0].numel(),
                 k, j_hi, j_lo, cols, device=dev)
    hyper_stage.launches += 1
    return planes


def hyper_trips(k: int, tile_elems: int, budget_elems: int):
    """The (j_hi, j_lo, cols) trips that cover the strides k/2 .. tile_elems
    of level k, top stride first: as few trips as a block of `budget_elems`
    elements a plane allows (W <= budget / 8), the stages split evenly, and
    each trip's cols as large as the budget and j_lo allow."""
    stages = (k // tile_elems).bit_length() - 1
    per_trip = (budget_elems // MIN_COLS).bit_length() - 1
    if per_trip < 1:
        raise ValueError(f"hyper_stage: a block of {budget_elems} elements "
                         "holds no stage")
    trips = -(-stages // per_trip)
    out = []
    j_hi = k // 2
    for t in range(trips):
        s = stages // trips + (1 if t < stages % trips else 0)
        j_lo = j_hi >> (s - 1)
        w = 2 * j_hi // j_lo
        out.append((j_hi, j_lo, min(j_lo, budget_elems // w)))
        j_hi = j_lo // 2
    return out


def level_trips(k: int, tile_elems: int, num_ops: int):
    """The engines' hyper trips of level k's strides k/2 .. tile_elems on
    `num_ops` planes: `hyper_trips` with a budget of the most elements a
    plane one block holds (HYPER_MAX_THREADS threads of HYPER_ITEMS[num_ops]
    int4: 2^15 on one plane, 2^14 on two or three, 2^13 on four, which is
    the H100 row's network tile for each), at most the tile."""
    most = 4 * HYPER_ITEMS[num_ops] * HYPER_MAX_THREADS
    return hyper_trips(k, tile_elems, min(most, tile_elems))


# ---- the engine -----------------------------------------------------------


def run_high_strides(ops, k: int, tile_rows: int, num_keys: int) -> None:
    """The strides k/2 .. tile of level k (k above the tile) on (R, 128)
    int32 planes, in place: `hyper_stage` trips (`level_trips`) or, with
    the hyper switch off, one `bitonic.global_stage` a stride.  Both run
    the same compare-exchanges in the same order.  The network's levels
    above the tile and mergesweep's passes share it."""
    tile_elems = tile_rows * LANES
    if _USE_HYPER:
        for j_hi, j_lo, cols in level_trips(k, tile_elems, len(ops)):
            hyper_stage(ops, k, j_hi, j_lo, num_keys, cols)
        return
    j = k // 2
    while j >= tile_elems:
        bitonic.global_stage(ops, j, k, num_keys, tile_rows)
        j //= 2


def _run_merge_pass(ops, k: int, tile_rows: int, num_keys: int):
    """One merge pass (all strides k/2 .. 1) on (R, 128) int32 planes, in
    place."""
    if k > tile_rows * LANES:
        run_high_strides(ops, k, tile_rows, num_keys)
    return merge_tail(ops, k, tile_rows, num_keys)


def _lex_order(keys) -> torch.Tensor:
    """Row-wise permutation (int64) sorting (S, L) int32 key planes
    lexicographically: one int64 composite for two keys (the first signed,
    the second biased to unsigned), else stable sorts, last key first."""
    if len(keys) == 2:
        comp = (keys[0].to(torch.int64) << 32) | (
            (keys[1].to(torch.int64) & 0xFFFFFFFF) ^ 0x80000000)
        return torch.sort(comp, dim=1).indices
    perm = None
    for key in reversed(keys):
        kk = key if perm is None else torch.gather(key, 1, perm)
        p = torch.sort(kk, dim=1, stable=True).indices
        perm = p if perm is None else torch.gather(perm, 1, p)
    return perm


def _phase1(padded, num_keys: int, K: int, L: int):
    """Sort each of the K segments of L, the odd ones descending (all key
    planes bit-flipped there, as in JAX); returns (R, 128) planes."""
    seg = [x.view(K, L) for x in padded]
    odd = (torch.arange(K, device=padded[0].device) % 2 == 1)[:, None]
    keys = [torch.where(odd, ~x, x) for x in seg[:num_keys]]
    if len(padded) == 1:
        out = [torch.sort(keys[0], dim=1).values]
    else:
        perm = _lex_order(keys)
        out = [torch.gather(x, 1, perm) for x in keys + seg[num_keys:]]
    out = [torch.where(odd, ~y, y) if i < num_keys else y
           for i, y in enumerate(out)]
    return [y.reshape(-1, LANES) for y in out]


def merge_sort_network_i32(operands, num_keys: int,
                           seg_elems: int | None = None):
    """Sort equal-length 1-D int32 operands (1-4) lexicographically by the
    first num_keys (ascending, signed); returns the permuted operands.

    PAD-TIE INVARIANT (as in the JAX package and `bitonic.sort_network_i32`):
    the merge network is unstable and pads EVERY operand with int32 max, so
    when num_keys < len(operands) real key tuples must be strictly below
    the all-max tuple (e.g. a bounded index tiebreak as the last key).
    seg_elems (default: the routing row's `mergesweep_seg_elems`) must be a
    power of two of at least 1024; K == 1 is one flat sort."""
    num_ops = len(operands)
    if not 1 <= num_ops <= MAX_OPS:
        raise ValueError(f"mergesweep takes 1-{MAX_OPS} operands, got "
                         f"{num_ops}")
    if not 1 <= num_keys <= num_ops:
        raise ValueError(f"num_keys must be in [1, {num_ops}], got "
                         f"{num_keys}")
    n = operands[0].shape[0]
    dev = operands[0].device
    for x in operands:
        if x.dtype != torch.int32 or x.shape != (n,):
            raise ValueError(f"operands must be 1-D int32 of length {n}, "
                             f"got {x.dtype}{tuple(x.shape)}")
    N = max(1024, 1 << (n - 1).bit_length())
    if N > bitonic.MAX_N:
        raise ValueError(f"mergesweep sorts at most {bitonic.MAX_N} "
                         f"elements, got {n}")
    L = seg_elems or get_routing_parameters(
        get_device_info(dev)).mergesweep_seg_elems
    if L & (L - 1):
        raise ValueError(f"seg_elems must be a power of two, got {L}")
    L = min(L, N)
    if L < 1024:
        raise ValueError(f"seg_elems must be >= 1024, got {L}")
    K = N // L
    R = N // LANES
    pad = N - n
    padded = [torch.cat([x, torch.full((pad,), INT32_MAX, dtype=torch.int32,
                                       device=dev)]) if pad else x
              for x in operands]
    if K == 1:
        flat = [x.view(1, N) for x in padded]
        if num_ops == 1:
            return (torch.sort(flat[0], dim=1).values.view(N)[:n],)
        perm = _lex_order(flat[:num_keys])
        return tuple(torch.gather(x, 1, perm).view(N)[:n] for x in flat)

    ops = _phase1(padded, num_keys, K, L)
    tile_rows = min(bitonic.network_tile_rows(dev, num_ops), R)
    k = 2 * L
    while k <= N:
        ops = _run_merge_pass(ops, k, tile_rows, num_keys)
        k *= 2
    return tuple(y.reshape(N)[:n] for y in ops)


def sort_codes(codes: torch.Tensor, seg_elems: int | None = None
               ) -> torch.Tensor:
    """Ascending sort of biased int32 codes (keys only) via mergesweep."""
    return merge_sort_network_i32((codes,), num_keys=1,
                                  seg_elems=seg_elems)[0]


def sort_codes_stable_with(codes: torch.Tensor, *ride: torch.Tensor,
                           seg_elems: int | None = None):
    """Stable ascending sort of biased int32 codes with int32 ride planes,
    by an int32 index tiebreak: bit-exact with `torch.sort(codes,
    stable=True)` applied to every plane."""
    idx = torch.arange(codes.shape[0], dtype=torch.int32,
                       device=codes.device)
    out = merge_sort_network_i32((codes, idx) + tuple(ride), num_keys=2,
                                 seg_elems=seg_elems)
    return (out[0],) + out[2:]
