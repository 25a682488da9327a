"""The Batcher bitonic sorting network — the `Backend.PALLAS` default
("onesweep" and "forward_sweep").

Port of `gpusorting_tpu/ops/bitonic.py`.  For N = 2^L elements:

  for level k in 2, 4, ..., N:          # sorted runs of k, alternating
    for stride j in k/2, ..., 1:        # compare-exchange i <-> i ^ j
      the pair (i, i ^ j), i & j == 0, sorts ascending where i & k == 0

  * strides below the tile run in `local_stages` (kernel `csrc/bitonic.cu`,
    replacing the Pallas `_local_stages_kernel`): one block per tile runs a
    (j, k) schedule on the tile's planes — first every level inside the
    tile, later the merge tail of each level above it.  `stage_runs`
    splits the schedule into runs that each stay in registers: strides
    below a warp's WARP_SPAN (each thread holds WARP_ITEMS consecutive
    elements: the short strides in the thread, the rest by warp shuffles),
    or up to GROUP_BITS longer strides (the thread's elements spread over
    their bits).  The tile waits in shared memory between runs, with one
    barrier between two runs;
  * the strides of at least one tile of a level run as hyper trips
    (`mergesweep.run_high_strides`: kernel `csrc/mergesweep.cu`, as many
    consecutive strides a trip as its block holds, in one read and one
    write of each plane); with GST_MERGESWEEP_HYPER=0, as one
    `global_stage` a stride (same source as the in-tile kernel, replacing
    `_global_stage_kernel`) over the whole array.  JAX runs one global
    stage a stride; the compare-exchanges and their order are the same.

The network compares int32 planes lexicographically over the first
`num_keys` and carries the rest.  Key codes are the port's sign-biased
carriers, so signed order is u32 order.  Stability comes from an index
tiebreak (`sort_codes_stable_with`); the network itself is not stable.
The tile is the largest power of two of 128-key rows whose planes fit the
tuning row's `network_smem_bytes`.  A sort of N = 2^L with a 2^t-key tile
launches (L - t + 1) `local_stages` and, for each level k above the tile,
len(mergesweep.level_trips(k, 2^t, planes)) `hyper_stage`; with the hyper
switch off, (L - t)(L - t + 1) / 2 `global_stage` in their place.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.config import get_device_info, get_tuning_parameters
from ..utils.trace import launch_counter
from . import _nvcc

LANES = 128
MAX_OPS = 4
MAX_N = 1 << 30
INT32_MAX = 0x7FFFFFFF
SOURCE = _nvcc.CSRC / "bitonic.cu"
# csrc/bitonic.cu's in-tile kernel: WARP_ITEMS elements a thread in
# registers (kItems), consecutive in a warp run, so a warp spans WARP_SPAN
# elements (32 * kItems); a long-stride run spreads them over GROUP_BITS
# index bits (kGroupBits); at most LOCAL_THREADS[num_ops] threads a block
# (kLocalThreads<NOPS>)
WARP_ITEMS = 8
GROUP_BITS = 3
WARP_SPAN = 32 * WARP_ITEMS
LOCAL_THREADS = {1: 1024, 2: 1024, 3: 512, 4: 512}


def _powers_desc(top: int):
    out = []
    j = top
    while j >= 1:
        out.append(j)
        j //= 2
    return out


def in_tile_schedule(tile_elems: int) -> torch.Tensor:
    """(S, 2) int32 (j, k) stages of every level inside the tile."""
    sched = [(j, k) for k in _powers_desc(tile_elems)[::-1][1:]
             for j in _powers_desc(k // 2)]
    return torch.from_numpy(np.array(sched, np.int32).reshape(-1, 2))


def tail_schedule(tile_elems: int, k: int) -> torch.Tensor:
    """(S, 2) int32 stages of level k's strides below the tile: (j, k) for
    j = min(k, tile_elems)/2, ..., 1 (the network's tails have k above the
    tile; mergesweep's merge tail also runs k below it)."""
    return torch.from_numpy(np.array(
        [(j, k) for j in _powers_desc(min(k, tile_elems) // 2)],
        np.int32).reshape(-1, 2))


def _check_planes(op, planes, num_keys, tile_rows):
    if not 1 <= len(planes) <= MAX_OPS:
        raise ValueError(f"{op} takes 1-{MAX_OPS} planes, got {len(planes)}")
    if not 1 <= num_keys <= len(planes):
        raise ValueError(f"{op}: num_keys must be in [1, {len(planes)}], "
                         f"got {num_keys}")
    rows = planes[0].shape[0]
    if tile_rows < 1 or tile_rows & (tile_rows - 1) or rows % tile_rows:
        raise ValueError(f"{op}: {rows} rows are not whole power-of-two "
                         f"tiles of {tile_rows} rows")
    for p in planes:
        if p.shape != planes[0].shape or p.dtype != torch.int32:
            raise TypeError(f"{op}: planes must be int32 of one shape, got "
                            f"{p.dtype}{tuple(p.shape)}")


def _check_stage(op, j, k, low, high):
    """j a power of two in [low, high), k a power of two above j."""
    if (j < low or j >= high or j & (j - 1) or k <= j or k & (k - 1)
            or k > MAX_N):
        raise ValueError(f"{op}: stage (j={j}, k={k}) is not a stage of "
                         f"strides in [{low}, {high})")


def _lex_lt(a, b, num_keys):
    """a < b lexicographically over the first num_keys planes."""
    lt = a[0] < b[0]
    eq = None
    for t in range(1, num_keys):
        e = a[t - 1] == b[t - 1]
        eq = e if eq is None else eq & e
        lt = lt | (eq & (a[t] < b[t]))
    return lt


def _stage_plain(flat, j: int, k: int, num_keys: int):
    """One stage over flat planes: the pair (i, i ^ j) sorts ascending
    where i & k == 0; the lower side keeps itself when (lower < upper)
    equals ascending, the upper when (upper < lower) equals descending (the
    TPU kernels' rule, which also fixes what ties do)."""
    blocks = flat[0].numel() // (2 * j)
    pairs = [x.view(blocks, 2, j) for x in flat]
    lo = [x[:, 0] for x in pairs]
    hi = [x[:, 1] for x in pairs]
    # k > j, so bit k of i lies in its block's offset blk * 2j
    asc = ((torch.arange(blocks, device=flat[0].device) * (2 * j)) & k) == 0
    asc = asc[:, None]
    keep_lo = _lex_lt(lo, hi, num_keys) == asc
    keep_hi = _lex_lt(hi, lo, num_keys) != asc
    out = []
    for a, b in zip(lo, hi):
        o = torch.empty((blocks, 2, j), dtype=a.dtype, device=a.device)
        o[:, 0] = torch.where(keep_lo, a, b)
        o[:, 1] = torch.where(keep_hi, b, a)
        out.append(o.view(-1))
    return out


# ---- local_stages ---------------------------------------------------------


def local_stages_plain(planes, sched: torch.Tensor, num_keys: int,
                       tile_rows: int) -> list:
    """Plain version: each stage of the schedule over the whole array (a
    stride below the tile keeps every pair inside one tile)."""
    _check_planes("local_stages", planes, num_keys, tile_rows)
    tile_elems = tile_rows * LANES
    flat = [p.reshape(-1) for p in planes]
    for j, k in sched.tolist():
        _check_stage("local_stages", j, k, 1, tile_elems)
        flat = _stage_plain(flat, j, k, num_keys)
    return [f.view(p.shape) for f, p in zip(flat, planes)]


def stage_runs(sched) -> list:
    """Split a (S, 2) (j, k) schedule into the in-tile kernel's runs, each
    of which stays in registers: a maximal run of consecutive stages whose
    strides are all below the warp's span of WARP_SPAN elements (registers
    and shuffles), or a run of consecutive stages whose strides are all at
    least the span and take at most GROUP_BITS distinct values (registers,
    the thread's elements spread over those strides' bits).  Returns
    [(start, end), ...] that cover the stages in order."""
    runs = []
    prev = None
    strides = set()
    for s, (j, _k) in enumerate(np.asarray(sched).reshape(-1, 2).tolist()):
        in_warp = j < WARP_SPAN
        if in_warp == prev and (in_warp or len(strides | {j}) <= GROUP_BITS):
            runs[-1][1] = s + 1
            strides.add(j)
        else:
            runs.append([s, s + 1])
            strides = {j}
        prev = in_warp
    return [tuple(r) for r in runs]


# the run table's kinds (csrc/bitonic.cu kRun*): a generic warp run, a
# generic long-stride run, and the three patterns the network's own
# schedules are made of, which the kernel runs with compile-time strides
RUN_WARP, RUN_GROUP, RUN_SORT256, RUN_MERGE, RUN_GROUP_MERGE = range(5)
_SORT256 = [(j, k) for k in (2, 4, 8, 16, 32, 64, 128, 256)
            for j in _powers_desc(k // 2)]


def run_table(sched) -> np.ndarray:
    """The in-tile kernel's (R, 4) int32 run table: (start, end, kind, k)
    for each run of `stage_runs`; k is the one k of a merge kind's stages,
    else 0."""
    stages = np.asarray(sched).reshape(-1, 2).tolist()
    rows = []
    for a, b in stage_runs(sched):
        run = [tuple(x) for x in stages[a:b]]
        k = run[0][1]
        if run == _SORT256:
            kind, k = RUN_SORT256, 0
        elif run == [(j, k) for j in _powers_desc(WARP_SPAN // 2)]:
            kind = RUN_MERGE
        elif run[0][0] < WARP_SPAN:
            kind, k = RUN_WARP, 0
        elif len(run) == GROUP_BITS and run == [
                (run[0][0] >> i, k) for i in range(GROUP_BITS)]:
            kind = RUN_GROUP_MERGE
        else:
            kind, k = RUN_GROUP, 0
        rows.append((a, b, kind, k))
    return np.array(rows, np.int32).reshape(-1, 4)


@functools.lru_cache(maxsize=256)
def _device_schedule(dev: torch.device, tile_elems: int,
                     sched_bytes: bytes) -> tuple:
    """The schedule (checked) and its run table on `dev`, copied once per
    device, tile and schedule: one flat int32 tensor, the (R, 4) run table
    first (16-byte rows), then the (S, 2) stages.  Returns (tensor, S, R)."""
    sched = np.frombuffer(sched_bytes, np.int32).reshape(-1, 2)
    for j, k in sched.tolist():
        _check_stage("local_stages", j, k, 1, tile_elems)
    runs = run_table(sched)
    table = torch.from_numpy(np.concatenate([runs.reshape(-1),
                                             sched.reshape(-1)])).to(dev)
    return table, sched.shape[0], runs.shape[0]


@launch_counter
def local_stages(planes, sched: torch.Tensor, num_keys: int,
                 tile_rows: int) -> list:
    """Run the (S, 2) int32 (j, k) schedule `sched` (a CPU tensor, checked
    here: every j a power of two below the tile, k a power of two above j)
    on every tile of `tile_rows` rows of 1-4 (rows, 128) int32 planes.
    Returns new planes; the inputs are not written.

    CUDA planes launch `csrc/bitonic.cu` once (or raise): the schedule and
    its run table (`run_table`) go to the card once per device, tile and
    schedule, and stay there.  CPU planes take `local_stages_plain`."""
    _check_planes("local_stages", planes, num_keys, tile_rows)
    if planes[0].device.type == "cpu":
        return local_stages_plain(planes, sched, num_keys, tile_rows)
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError(f"local_stages: unsupported device {dev}")
    rows = planes[0].shape[0]
    tile_elems = tile_rows * LANES
    for i, p in enumerate(planes):
        _nvcc.check("local_stages", f"planes[{i}]", p, (rows, LANES), dev,
                    ref="planes[0]")
    if sched.ndim != 2 or sched.shape[1] != 2 or sched.dtype != torch.int32:
        raise ValueError(f"local_stages: schedule must be (S, 2) int32, got "
                         f"{sched.dtype}{tuple(sched.shape)}")
    if rows * LANES > MAX_N:
        raise ValueError(f"local_stages: {rows * LANES} elements exceed "
                         f"{MAX_N}")
    table, num_stages, num_runs = _device_schedule(
        dev, tile_elems, sched.cpu().contiguous().numpy().tobytes())
    outs = [torch.empty_like(p) for p in planes]
    spare = [0] * (MAX_OPS - len(planes))
    _nvcc.launch("local_stages", _nvcc.load(SOURCE).gst_local_stages,
                 *[p.data_ptr() for p in planes], *spare,
                 *[o.data_ptr() for o in outs], *spare,
                 table.data_ptr() + 16 * num_runs, num_stages,
                 table.data_ptr(), num_runs,
                 len(planes), num_keys, rows // tile_rows, tile_elems,
                 device=dev)
    local_stages.launches += 1
    return outs


# ---- global_stage ---------------------------------------------------------


def global_stage_plain(planes, j: int, k: int, num_keys: int,
                       tile_rows: int) -> list:
    """Plain version of `global_stage`, in place as it is."""
    _check_planes("global_stage", planes, num_keys, tile_rows)
    n = planes[0].numel()
    _check_stage("global_stage", j, k, tile_rows * LANES, n)
    new = _stage_plain([p.reshape(-1) for p in planes], j, k, num_keys)
    for p, x in zip(planes, new):
        p.view(-1).copy_(x)
    return planes


@launch_counter
def global_stage(planes, j: int, k: int, num_keys: int,
                 tile_rows: int) -> list:
    """One stage (j, k) with j of at least one tile over 1-4 (rows, 128)
    int32 planes of N = rows * 128 elements, N a power of two, IN PLACE
    (the network runs it on buffers it allocated, never on a caller's
    input).  Returns the planes.

    CUDA planes launch `csrc/bitonic.cu` once (or raise); CPU planes take
    `global_stage_plain`."""
    _check_planes("global_stage", planes, num_keys, tile_rows)
    n = planes[0].numel()
    _check_stage("global_stage", j, k, tile_rows * LANES, n)
    if planes[0].device.type == "cpu":
        return global_stage_plain(planes, j, k, num_keys, tile_rows)
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError(f"global_stage: unsupported device {dev}")
    rows = planes[0].shape[0]
    for i, p in enumerate(planes):
        _nvcc.check("global_stage", f"planes[{i}]", p, (rows, LANES), dev,
                    ref="planes[0]")
    if n & (n - 1) or n > MAX_N:
        raise ValueError(f"global_stage: {n} elements are not a power of "
                         f"two up to {MAX_N}")
    spare = [0] * (MAX_OPS - len(planes))
    _nvcc.launch("global_stage", _nvcc.load(SOURCE).gst_global_stage,
                 *[p.data_ptr() for p in planes], *spare, len(planes),
                 num_keys, n, j, k, device=dev)
    global_stage.launches += 1
    return planes


# ---- the network ----------------------------------------------------------


def network_tile_rows(device: torch.device, num_ops: int) -> int:
    """The tuning row's network tile for `device` and `num_ops` planes."""
    return get_tuning_parameters(get_device_info(device)).network_tile_rows(
        num_ops)


def sort_network_i32(operands, num_keys: int):
    """Sort equal-length 1-D int32 operands lexicographically by the first
    num_keys (ascending, signed); returns the permuted operands.

    PAD-TIE INVARIANT (as in the JAX package): the network is unstable and
    pads EVERY operand with int32 max to N = max(1024, next power of two).
    When num_keys < len(operands), real key tuples must be strictly below
    the all-max pad tuple, e.g. a bounded index tiebreak as the last key
    (`sort_codes_stable_with`'s idx < n).  Keys-only calls are always safe:
    max-tied elements are interchangeable."""
    num_ops = len(operands)
    n = operands[0].shape[0]
    for x in operands:
        if x.dtype != torch.int32 or x.shape != (n,):
            raise ValueError(f"operands must be 1-D int32 of length {n}, "
                             f"got {x.dtype}{tuple(x.shape)}")
    N = max(1024, 1 << (n - 1).bit_length())
    if N > MAX_N:
        raise ValueError(f"the network sorts at most {MAX_N} elements, "
                         f"got {n}")
    R = N // LANES
    tile_rows = min(network_tile_rows(operands[0].device, num_ops), R)
    tile_elems = tile_rows * LANES
    pad = N - n
    padded = []
    for x in operands:
        if pad:
            x = torch.cat([x, torch.full((pad,), INT32_MAX, dtype=torch.int32,
                                         device=x.device)])
        elif x.data_ptr() % 16:
            x = x.clone(memory_format=torch.contiguous_format)
        padded.append(x.reshape(R, LANES))

    # levels inside a tile: one pass; it writes new planes, so the global
    # stages below run in place on buffers the network owns
    ops = local_stages(padded, in_tile_schedule(tile_elems), num_keys,
                       tile_rows)
    # levels above the tile: the high strides (hyper trips, or global
    # stages with the switch off), then the level's in-tile tail.
    # mergesweep imports this module for its stages and tiles, so it is
    # imported here, at the call, and not at the top
    from . import mergesweep

    k = tile_elems * 2
    while k <= N:
        mergesweep.run_high_strides(ops, k, tile_rows, num_keys)
        ops = local_stages(ops, tail_schedule(tile_elems, k), num_keys,
                           tile_rows)
        k *= 2
    return tuple(y.reshape(N)[:n] for y in ops)


def sort_codes(codes: torch.Tensor) -> torch.Tensor:
    """Ascending sort of biased int32 codes (keys only).  The codes are
    sign-biased already, so the JAX package's `_bias_u32_to_i32` is the
    identity here."""
    return sort_network_i32((codes,), num_keys=1)[0]


def sort_codes_stable_with(codes: torch.Tensor, *ride: torch.Tensor):
    """Stable ascending sort of biased int32 codes; the int32 `ride`
    planes are permuted along.  Stability comes from an int32 index
    tiebreak (a total order), so the output is bit-exact with
    `torch.sort(codes, stable=True)` applied to every plane."""
    idx = torch.arange(codes.shape[0], dtype=torch.int32,
                       device=codes.device)
    out = sort_network_i32((codes, idx) + tuple(ride), num_keys=2)
    return (out[0],) + out[2:]
