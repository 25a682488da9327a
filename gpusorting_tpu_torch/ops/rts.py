"""DeviceRadixSort — the reduce-then-scan radix-16 engine, and the
table-driven downsweep it shares with the FFX engine.

Port of `gpusorting_tpu/ops/rts.py` (reference: DeviceRadixSort.hlsl
Upsweep -> Scan -> Downsweep).  Codes are the biased int32 carriers of
`core.codec`; rides are int32 bit carriers.  8 passes of 4 bits, each:

  Upsweep   — `kernels.tile_histogram4`: per-tile (16,) digit counts.
  Scan      — `kernels.exclusive_scan` over the DIGIT-MAJOR (16 * T,)
              flattening of the counts: one scan gives each (digit, tile)
              its absolute output cursor (global digit base plus the counts
              of the earlier tiles).
  Downsweep — in one of two forms, picked by `config.megacore_parallel`:
              * element form (the default): `downsweep` places every
                element at its own address, stably; one launch of
                `csrc/downsweep.cu` per pass moves all planes (replacing
                the Pallas `_downsweep_kernel`).  No row is shared.
              * row form (GST_MEGACORE=1, JAX's core-split-safe "parallel"
                mode): `downsweep_rows` (`csrc/downsweep_rows.cu`, the same
                Pallas kernel with parallel=True) writes every 128-lane row
                that lies wholly inside one (tile, digit) range as a whole
                row, and each partial row at a range's edge, lane-masked,
                to the tile's own rows of a side buffer, every output row
                stored once (a shared row as zeros); `edge_rows` names the
                output row of each partial, and `edge_fixup`
                (`csrc/edge_fixup.cu`, replacing `_edge_fixup_kernel`)
                merges each shared row's side rows in registers and stores
                it once.  Rows at range edges are shared by several ranges,
                which is what the fixup is for.

Given the table, tiles are independent, so no grid order is needed.  The
TPU artifacts that remain gone in both forms: the SMEM chunking of the
downsweep grid (one launch per pass) and the slack rows past the output.
"""

from __future__ import annotations

import torch

from ..core import codec
from ..core.config import (Mode, get_device_info, get_tuning_parameters,
                           megacore_parallel)
from ..utils.trace import launch_counter
from . import _nvcc, kernels

LANES = kernels.LANES
NBUCKETS = kernels.NBUCKETS
PASSES = 8
MAX_PLANES = 3
SOURCE = _nvcc.CSRC / "downsweep.cu"
ROWS_SOURCE = _nvcc.CSRC / "downsweep_rows.cu"
FIXUP_SOURCE = _nvcc.CSRC / "edge_fixup.cu"
# Dynamic shared memory the row form's block may take: the 227 KB (232,448
# bytes) an H100 block opts in to, less 1 KB for its static arrays.
ROWS_STAGE_BYTES = 232_448 - 1024
# Stage rows past the tile's (csrc/downsweep_rows.cu kPadRows): each
# digit's run starts at a slot congruent to its output cursor mod 128.
STAGE_PAD_ROWS = 16


def default_tile_rows(device: torch.device, pairs: bool = False) -> int:
    """The tuning row's radix tile for `device` (rows of 128 keys)."""
    mode = Mode.PAIRS if pairs else Mode.KEYS_ONLY
    return get_tuning_parameters(get_device_info(device),
                                 mode).radix_tile_rows


def pad_tiles(operands, tile_rows: int):
    """Operands -> (rows, 128) planes padded to a whole number of tiles (at
    least one): the sentinel code in plane 0, zeros in the rides.  Every
    plane starts 16-byte aligned, as the kernels require, also when an
    operand is a view at an odd offset.  Returns (planes, n)."""
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    n = operands[0].shape[0]
    for x in operands:
        if x.dtype != torch.int32 or x.shape != (n,):
            raise ValueError(f"operands must be 1-D int32 of length {n}, "
                             f"got {x.dtype}{tuple(x.shape)}")
    rows = max(tile_rows, -(-n // LANES))
    rows = -(-rows // tile_rows) * tile_rows
    pad = rows * LANES - n
    planes = []
    for i, x in enumerate(operands):
        if pad:
            fill = torch.full((pad,), codec.SENTINEL if i == 0 else 0,
                              dtype=torch.int32, device=x.device)
            x = torch.cat([x, fill])
        elif x.data_ptr() % 16:
            x = x.clone(memory_format=torch.contiguous_format)
        planes.append(x.reshape(rows, LANES))
    return planes, n


# ---- Downsweep ------------------------------------------------------------


def _scatter_plan(codes2d: torch.Tensor, table: torch.Tensor, shift: int,
                  tile_rows: int):
    """(order, dst, group) of the stable scatter: a stable argsort of the
    key t * 16 + digit groups each (tile, digit) range in input order;
    sorted element j of group g = t * 16 + d goes to table[d * T + t] +
    (j - start of g)."""
    x = codes2d.reshape(-1)
    n = x.numel()
    num_tiles = n // (tile_rows * LANES)
    pos = torch.arange(n, device=x.device)
    key = (pos // (tile_rows * LANES)) * NBUCKETS + kernels.digits(x, shift)
    order = torch.argsort(key, stable=True)
    skey = key[order]
    rank = pos - torch.searchsorted(skey, skey)
    dst = (table.to(torch.int64)[(skey % NBUCKETS) * num_tiles
                                 + skey // NBUCKETS] + rank)
    return order, dst, skey


def _scatter(planes, order, dst) -> list:
    outs = []
    for p in planes:
        out = torch.empty_like(p).view(-1)
        out[dst] = p.reshape(-1)[order]
        outs.append(out.view(p.shape))
    return outs


def downsweep_plain(planes, table: torch.Tensor, shift: int,
                    tile_rows: int) -> list:
    """Plain version: every element scattered to its own address
    (`_scatter_plan`)."""
    order, dst, _ = _scatter_plan(planes[0], table, shift, tile_rows)
    return _scatter(planes, order, dst)


@launch_counter
def downsweep(planes, table: torch.Tensor, shift: int,
              tile_rows: int) -> list:
    """One pass's stable scatter of 1-3 (rows, 128) int32 planes (plane 0
    the biased codes) by the digit-major (16 * T,) int32 cursor table.

    CUDA planes launch `csrc/downsweep.cu` once for all planes (or raise);
    CPU planes take `downsweep_plain`."""
    kernels.check_shift(shift)
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"downsweep takes 1-{MAX_PLANES} planes, got "
                         f"{len(planes)}")
    rows = planes[0].shape[0]
    if tile_rows < 1 or rows % tile_rows:
        raise ValueError(f"{rows} rows are not whole tiles of {tile_rows}")
    if planes[0].device.type == "cpu":
        for p in planes:
            kernels.check_int32("downsweep", p)
        return downsweep_plain(planes, table, shift, tile_rows)
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError(f"downsweep: unsupported device {dev}")
    num_tiles = rows // tile_rows
    for i, p in enumerate(planes):
        _nvcc.check("downsweep", f"planes[{i}]", p, (rows, LANES), dev,
                    ref="planes[0]")
    _nvcc.check("downsweep", "table", table, (NBUCKETS * num_tiles,), dev,
                ref="planes[0]")
    if rows * LANES >= 1 << 31:
        raise ValueError(f"downsweep: {rows * LANES} elements exceed int32")
    outs = [torch.empty_like(p) for p in planes]
    spare = [0] * (MAX_PLANES - len(planes))
    _nvcc.launch("downsweep", _nvcc.load(SOURCE).gst_downsweep,
                 *[p.data_ptr() for p in planes], *spare,
                 *[o.data_ptr() for o in outs], *spare, table.data_ptr(),
                 len(planes), num_tiles, tile_rows * LANES, shift,
                 device=dev)
    downsweep.launches += 1
    return outs


# ---- Downsweep, row form, and its edge fixup -------------------------------


def edge_rows(table: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The (2 * 16 * T,) int32 `rowtab`: entry (e * 16 + d) * T + t is the
    output row of the partial row at edge e (0 low, 1 high) of tile t's
    digit-d range, or -1 where that range has no such partial.  A range
    that starts mid-row has a low partial in its first row; one that ends
    mid-row has a high partial in its last row unless that row is its first
    (then the low partial holds it).  Plain tensor code (rts.py:447-456 of
    the JAX package); `table` is the digit-major (16 * T,) cursor scan and
    `counts` the Upsweep's (T, 16) table."""
    num_tiles = counts.shape[0]
    cur = table.view(NBUCKETS, num_tiles)
    tc = counts.T
    hi = cur + tc
    first_full = (cur + (LANES - 1)) >> 7
    lo_row = torch.where((tc > 0) & ((cur & (LANES - 1)) != 0), cur >> 7, -1)
    hi_row = torch.where((tc > 0) & ((hi & (LANES - 1)) != 0)
                         & ((hi >> 7) >= first_full), hi >> 7, -1)
    return torch.stack([lo_row, hi_row]).reshape(-1).to(torch.int32)


def rows_stage_bytes(num_ops: int, tile_rows: int) -> int:
    """Dynamic shared memory of one `downsweep_rows` block: one plane's
    stage, (tile_rows + STAGE_PAD_ROWS) rows of 512 bytes, and with riders
    each element's 16-bit stage slot."""
    stage = (tile_rows + STAGE_PAD_ROWS) * LANES * 4
    return stage + (tile_rows * LANES * 2 if num_ops > 1 else 0)


def side_row(t, o, d, e, num_ops: int):
    """The side-buffer row of tile t's plane-o partial of digit d, edge e."""
    return ((t * num_ops + o) * NBUCKETS + d) * 2 + e


def downsweep_rows_plain(planes, table: torch.Tensor, counts: torch.Tensor,
                         shift: int, tile_rows: int):
    """Plain version of `downsweep_rows`: the element scatter, then each
    output row kept where one range owns all its 128 slots, and each
    present partial (`edge_rows`) copied to its side row with the slots of
    other ranges zeroed.  Absent side rows are zeros, as in JAX."""
    rows = planes[0].shape[0]
    num_tiles = counts.shape[0]
    order, dst, group = _scatter_plan(planes[0], table, shift, tile_rows)
    full = _scatter(planes, order, dst)
    owner = torch.empty_like(group)
    owner[dst] = group
    del order, dst, group
    owner = owner.view(rows, LANES)
    whole = (owner == owner[:, :1]).all(1, keepdim=True)
    outs = [torch.where(whole, f, 0) for f in full]
    # (T, 16, 2) rowtab, one entry per side row of a plane
    rowtab = edge_rows(table, counts).view(2, NBUCKETS, num_tiles).permute(
        2, 1, 0)
    row = rowtab.clamp(min=0).to(torch.int64)
    grp = (torch.arange(num_tiles, device=row.device).view(-1, 1, 1)
           * NBUCKETS + torch.arange(NBUCKETS, device=row.device).view(
               1, -1, 1))
    mine = (owner[row] == grp.unsqueeze(-1)) & (rowtab >= 0).unsqueeze(-1)
    side = torch.stack([torch.where(mine, f[row], 0) for f in full], dim=1)
    return outs, side.reshape(-1, LANES)


@launch_counter
def downsweep_rows(planes, table: torch.Tensor, counts: torch.Tensor,
                   shift: int, tile_rows: int):
    """One pass's row-writing scatter of 1-3 (rows, 128) int32 planes
    (plane 0 the biased codes) by the digit-major (16 * T,) cursor table
    and the Upsweep's (T, 16) counts.  Returns (outs, side):

      outs — the planes with every row that lies wholly inside one
             (tile, digit) range written whole; every other row zero.
      side — (T * num_ops * 16 * 2, 128) int32: row `side_row(t, o, d, e)`
             holds plane o's slots of tile t's digit-d range in the row
             that `edge_rows` names for edge e, zeros in the other slots.
             Rows whose entry is -1 are never read; the kernel leaves them
             unwritten, the plain version zero.

    CUDA planes launch `csrc/downsweep_rows.cu` once for all planes (or
    raise); it stores every output row once, so the outputs come from
    `torch.empty`.  A block's stage, `rows_stage_bytes(num_ops,
    tile_rows)`, must fit `ROWS_STAGE_BYTES` of shared memory.  CPU planes
    take `downsweep_rows_plain`."""
    kernels.check_shift(shift)
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"downsweep_rows takes 1-{MAX_PLANES} planes, got "
                         f"{len(planes)}")
    rows = planes[0].shape[0]
    if tile_rows < 1 or rows % tile_rows:
        raise ValueError(f"{rows} rows are not whole tiles of {tile_rows}")
    num_tiles = rows // tile_rows
    if counts.shape != (num_tiles, NBUCKETS):
        raise ValueError(f"downsweep_rows: counts shape {tuple(counts.shape)}"
                         f" != {(num_tiles, NBUCKETS)}")
    if planes[0].device.type == "cpu":
        for p in planes:
            kernels.check_int32("downsweep_rows", p)
        return downsweep_rows_plain(planes, table, counts, shift, tile_rows)
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError(f"downsweep_rows: unsupported device {dev}")
    for i, p in enumerate(planes):
        _nvcc.check("downsweep_rows", f"planes[{i}]", p, (rows, LANES), dev,
                    ref="planes[0]")
    _nvcc.check("downsweep_rows", "table", table, (NBUCKETS * num_tiles,),
                dev, ref="planes[0]")
    _nvcc.check("downsweep_rows", "counts", counts, (num_tiles, NBUCKETS),
                dev, ref="planes[0]")
    if rows * LANES >= 1 << 31:
        raise ValueError(f"downsweep_rows: {rows * LANES} elements exceed "
                         f"int32")
    stage = rows_stage_bytes(len(planes), tile_rows)
    if stage > ROWS_STAGE_BYTES:
        raise ValueError(f"downsweep_rows: the stage of {len(planes)} "
                         f"planes x {tile_rows} rows takes {stage} bytes of "
                         f"shared memory, over {ROWS_STAGE_BYTES}")
    outs = [torch.empty_like(p) for p in planes]
    side = torch.empty((num_tiles * len(planes) * NBUCKETS * 2, LANES),
                       dtype=torch.int32, device=dev)
    spare = [0] * (MAX_PLANES - len(planes))
    _nvcc.launch("downsweep_rows", _nvcc.load(ROWS_SOURCE).gst_downsweep_rows,
                 *[p.data_ptr() for p in planes], *spare,
                 *[o.data_ptr() for o in outs], *spare, side.data_ptr(),
                 table.data_ptr(), counts.data_ptr(), len(planes),
                 num_tiles, tile_rows, shift, device=dev)
    downsweep_rows.launches += 1
    return outs, side


def edge_fixup_plain(rowtab: torch.Tensor, table: torch.Tensor,
                     side: torch.Tensor, outs) -> list:
    """Plain version of `edge_fixup`, vectorised: the present entries are
    sorted by row and ORed in rounds by their rank within the row, so that
    no round names one row twice.  `table` is not needed here."""
    num_ops = len(outs)
    num_tiles = rowtab.numel() // (2 * NBUCKETS)
    k = torch.nonzero(rowtab >= 0).squeeze(1)
    if k.numel() == 0:
        return outs
    row = rowtab[k].to(torch.int64)
    row, by_row = torch.sort(row, stable=True)
    k = k[by_row]
    rank = (torch.arange(k.numel(), device=k.device)
            - torch.searchsorted(row, row))
    e = k // (NBUCKETS * num_tiles)
    d = (k // num_tiles) % NBUCKETS
    t = k % num_tiles
    for j in range(int(rank.max()) + 1):
        sel = rank == j
        r = row[sel]
        for o, out in enumerate(outs):
            out[r] |= side[side_row(t[sel], o, d[sel], e[sel], num_ops)]
    return outs


@launch_counter
def edge_fixup(rowtab: torch.Tensor, table: torch.Tensor,
               side: torch.Tensor, outs) -> list:
    """OR each present side row into its output row, in place, for each of
    the 1-3 (rows, 128) int32 planes `outs`: entry k = (e * 16 + d) * T + t
    of the (2 * 16 * T,) int32 `rowtab` (`edge_rows(table, counts)`) names
    the row of `side` row `side_row(t, o, d, e)` in plane o, or is -1
    (absent); `table` is the pass's digit-major (16 * T,) cursor scan.
    Several entries may name one row; OR commutes, so the result does not
    depend on their order.  Returns `outs`.

    CUDA planes launch `csrc/edge_fixup.cu` once for all planes (or
    raise): each row that a high entry names gets one warp, which finds
    the row's low entries in `table` and stores the merged row once; it
    skips an entry naming no row of `outs`.  CPU planes take
    `edge_fixup_plain`."""
    if not 1 <= len(outs) <= MAX_PLANES:
        raise ValueError(f"edge_fixup takes 1-{MAX_PLANES} planes, got "
                         f"{len(outs)}")
    entries = rowtab.numel()
    if entries == 0 or entries % (2 * NBUCKETS):
        raise ValueError(f"edge_fixup: rowtab of {entries} entries is not "
                         f"2 * 16 * T")
    num_tiles = entries // (2 * NBUCKETS)
    side_shape = (num_tiles * len(outs) * NBUCKETS * 2, LANES)
    if tuple(side.shape) != side_shape:
        raise ValueError(f"edge_fixup: side shape {tuple(side.shape)} != "
                         f"{side_shape}")
    if tuple(table.shape) != (NBUCKETS * num_tiles,):
        raise ValueError(f"edge_fixup: table shape {tuple(table.shape)} != "
                         f"{(NBUCKETS * num_tiles,)}")
    rows = outs[0].shape[0]
    if outs[0].device.type == "cpu":
        for t in (rowtab, table, side, *outs):
            kernels.check_int32("edge_fixup", t)
        return edge_fixup_plain(rowtab, table, side, outs)
    dev = outs[0].device
    if dev.type != "cuda":
        raise ValueError(f"edge_fixup: unsupported device {dev}")
    for i, o in enumerate(outs):
        _nvcc.check("edge_fixup", f"outs[{i}]", o, (rows, LANES), dev,
                    ref="outs[0]")
    _nvcc.check("edge_fixup", "rowtab", rowtab, (entries,), dev,
                ref="outs[0]", align=4)
    _nvcc.check("edge_fixup", "table", table, (NBUCKETS * num_tiles,), dev,
                ref="outs[0]", align=4)
    _nvcc.check("edge_fixup", "side", side, side_shape, dev, ref="outs[0]")
    if rows * LANES >= 1 << 31:
        raise ValueError(f"edge_fixup: {rows * LANES} elements exceed int32")
    spare = [0] * (MAX_PLANES - len(outs))
    _nvcc.launch("edge_fixup", _nvcc.load(FIXUP_SOURCE).gst_edge_fixup,
                 *[o.data_ptr() for o in outs], *spare, side.data_ptr(),
                 rowtab.data_ptr(), table.data_ptr(), len(outs), num_tiles,
                 rows, device=dev)
    edge_fixup.launches += 1
    return outs


# ---- the engine -----------------------------------------------------------


def rts_pass(planes, shift: int, tile_rows: int,
             parallel: bool = False) -> list:
    """One pass (Upsweep, scan, downsweep) over the (rows, 128) planes at
    `shift`; `parallel` takes the row form and its edge fixup."""
    counts = kernels.tile_histogram4(planes[0], shift, tile_rows)
    table = kernels.exclusive_scan(counts.T.reshape(-1))
    if not parallel:
        return downsweep(planes, table, shift, tile_rows)
    outs, side = downsweep_rows(planes, table, counts, shift, tile_rows)
    return edge_fixup(edge_rows(table, counts), table, side, outs)


def _sort_rts(operands, tile_rows: int, parallel: bool | None = None):
    """Stable 8-pass LSD sort of (codes, *rides), 1-D int32 each (at most
    two rides); returns the sorted tuple.  parallel=None resolves from
    `config.megacore_parallel` for the operands' device: the element form
    unless GST_MEGACORE=1."""
    if parallel is None:
        parallel = megacore_parallel(get_device_info(operands[0].device))
    planes, n = pad_tiles(operands, tile_rows)
    for p in range(PASSES):
        planes = rts_pass(planes, 4 * p, tile_rows, parallel)
    return tuple(y.reshape(-1)[:n] for y in planes)


def sort_codes_rts(codes: torch.Tensor,
                   tile_rows: int | None = None) -> torch.Tensor:
    """Ascending sort of biased int32 codes; the tile defaults to the
    tuning row of the codes' device."""
    if tile_rows is None:
        tile_rows = default_tile_rows(codes.device)
    return _sort_rts((codes,), tile_rows)[0]


def sort_pairs_rts(codes: torch.Tensor, payload: torch.Tensor,
                   tile_rows: int | None = None):
    """Stable pair sort of biased codes and an int32 payload; bit-exact with
    `torch.sort(codes, stable=True)` applied to both."""
    if tile_rows is None:
        tile_rows = default_tile_rows(codes.device, pairs=True)
    return _sort_rts((codes, payload), tile_rows)
