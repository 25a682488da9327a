"""FFX ParallelSort baseline — the 5-stage fixed-tuning radix-16 engine.

Port of `gpusorting_tpu/ops/ffx.py` (reference: FFXParallelSort.cpp:
242-328).  Each of the 8 passes runs five stages with a two-level scan:

  Count        — `kernels.tile_histogram4` at the FIXED tile
                 (`RoutingParameters.ffx_tile_rows`; one tuning for every
                 device is this baseline's identity, so it is not swept)
  CountReduce  — per-block sums of the (T, 16) counts over
                 _TILES_PER_BLOCK tiles (a plain tensor reduction)
  Scan         — `kernels.exclusive_scan` of the digit-major block sums
  ScanAdd      — block-local exclusive tile prefix plus the scanned block
                 base (a plain `cumsum`): the absolute (digit, tile) cursors
  Scatter      — the shared table-driven downsweep (`rts.downsweep`)

Codes are the biased int32 carriers of `core.codec`.  Output is bit-exact
with every other engine.
"""

from __future__ import annotations

import torch

from ..core.config import get_device_info, get_routing_parameters
from . import kernels, rts

_TILES_PER_BLOCK = 32


def count_reduce(counts: torch.Tensor):
    """CountReduce: the (T, 16) tile counts, padded with zero tiles to whole
    blocks of _TILES_PER_BLOCK, -> ((B, _TILES_PER_BLOCK, 16) tile counts,
    the digit-major (16 * B,) block sums that the Scan takes)."""
    pad_t = -counts.shape[0] % _TILES_PER_BLOCK
    if pad_t:
        counts = torch.cat([counts, counts.new_zeros((pad_t, rts.NBUCKETS))])
    tiles = counts.view(-1, _TILES_PER_BLOCK, rts.NBUCKETS)
    return tiles, tiles.sum(dim=1, dtype=torch.int32).T.reshape(-1)


def scan_add(tiles: torch.Tensor, base: torch.Tensor,
             num_tiles: int) -> torch.Tensor:
    """ScanAdd: each tile's block-local exclusive prefix plus its block's
    scanned base -> the digit-major (16 * T,) cursor table of the
    downsweep."""
    within = torch.cumsum(tiles, dim=1, dtype=torch.int32) - tiles
    table = within + base.view(rts.NBUCKETS, -1).T[:, None, :]
    return table.reshape(-1, rts.NBUCKETS)[:num_tiles].T.reshape(-1)


def _sort_ffx(operands):
    """Stable 8-pass LSD sort of (codes, *rides), 1-D int32 each (at most
    two rides), through the five FFX stages."""
    dev = operands[0].device
    tile_rows = get_routing_parameters(get_device_info(dev)).ffx_tile_rows
    planes, n = rts.pad_tiles(operands, tile_rows)
    num_tiles = planes[0].shape[0] // tile_rows
    for p in range(rts.PASSES):
        shift = 4 * p
        counts = kernels.tile_histogram4(planes[0], shift, tile_rows)  # Count
        tiles, sums = count_reduce(counts)
        table = scan_add(tiles, kernels.exclusive_scan(sums), num_tiles)
        planes = rts.downsweep(planes, table, shift, tile_rows)      # Scatter
    return tuple(y.reshape(-1)[:n] for y in planes)


def sort_codes_ffx(codes: torch.Tensor) -> torch.Tensor:
    """Ascending sort of biased int32 codes (fixed tuning)."""
    return _sort_ffx((codes,))[0]


def sort_pairs_ffx(codes: torch.Tensor, payload: torch.Tensor):
    """Stable pair sort of biased codes and an int32 payload."""
    return _sort_ffx((codes, payload))
