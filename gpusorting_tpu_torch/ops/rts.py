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
  Downsweep — `downsweep`: every tile places its elements at the cursors,
              stably; one launch of `csrc/downsweep.cu` per pass moves all
              planes (replacing the Pallas `_downsweep_kernel`).

Given the table, tiles are independent, so no grid order is needed.  The
TPU artifacts are gone: the SMEM chunking of the downsweep grid, the slack
rows and OR-merged boundary rows of its whole-row writer, and the
dual-core edge fixup (`_edge_fixup_kernel`), which has no work when every
element is written at its own address.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core import codec
from ..core.config import Mode, get_device_info, get_tuning_parameters
from . import _nvcc, kernels

LANES = kernels.LANES
NBUCKETS = kernels.NBUCKETS
PASSES = 8
MAX_PLANES = 3
SOURCE = _nvcc.CSRC / "downsweep.cu"


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


def downsweep_plain(planes, table: torch.Tensor, shift: int,
                    tile_rows: int) -> list:
    """Plain version: a stable argsort of the key t * 16 + digit groups
    each (tile, digit) range in input order; sorted element j of group g
    goes to table[d * T + t] + (j - start of g)."""
    x = planes[0].reshape(-1)
    n = x.numel()
    num_tiles = n // (tile_rows * LANES)
    pos = torch.arange(n, device=x.device)
    key = (pos // (tile_rows * LANES)) * NBUCKETS + kernels.digits(x, shift)
    order = torch.argsort(key, stable=True)
    skey = key[order]
    rank = pos - torch.searchsorted(skey, skey)
    dst = (table.to(torch.int64)[(skey % NBUCKETS) * num_tiles
                                 + skey // NBUCKETS] + rank)
    outs = []
    for p in planes:
        out = torch.empty_like(p).view(-1)
        out[dst] = p.reshape(-1)[order]
        outs.append(out.view(p.shape))
    return outs


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _nvcc.load(SOURCE)
    fn = lib.gst_downsweep
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


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
    _nvcc.launch("downsweep", _library().gst_downsweep,
                 *[p.data_ptr() for p in planes], *spare,
                 *[o.data_ptr() for o in outs], *spare, table.data_ptr(),
                 len(planes), num_tiles, tile_rows * LANES, shift,
                 device=dev)
    downsweep.launches += 1
    return outs


downsweep.launches = 0


# ---- the engine -----------------------------------------------------------


def _sort_rts(operands, tile_rows: int):
    """Stable 8-pass LSD sort of (codes, *rides), 1-D int32 each (at most
    two rides); returns the sorted tuple."""
    planes, n = pad_tiles(operands, tile_rows)
    for p in range(PASSES):
        shift = 4 * p
        counts = kernels.tile_histogram4(planes[0], shift, tile_rows)
        table = kernels.exclusive_scan(counts.T.reshape(-1))
        planes = downsweep(planes, table, shift, tile_rows)
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
