"""The fused LSD radix-16 engine: eight passes of 4 bits, each ONE launch
of a stable binning pass (the reference's OneSweep DigitBinningPass,
OneSweep.cu:164-344), after one global histogram for all eight.

Port of `gpusorting_tpu/ops/radix16.py`.  Codes are the biased int32
carriers of `core.codec`; rides are int32 bit carriers.

  bases      — `kernels.global_histogram` counts the four 8-bit digits in
               one read; each 4-bit digit's counts are a marginal of its
               byte's joint counts, and their exclusive sums are the pass's
               digit bases (`_bases_all_passes`).
  pass       — `binning_pass` (kernel `csrc/binning.cu`, replacing the
               Pallas `_binning_kernel`): every element goes to its digit's
               base plus the count of earlier elements of that digit.  The
               TPU carried 16 cursors and each digit's partial 128-lane row
               across a grid that ran in order, and flushed the partial
               rows at the end; here a chained scan with decoupled lookback
               across the kernel's own partitions (not the tile) takes the
               cursors' place, and elements are written at their own
               addresses, so no row is carried.  Its status words live in
               `kernels._scan_scratch`, with a per-call epoch.
  pass skip  — a pass whose digit is the same for every element (its count
               is the padded total) is the identity and is skipped, as in
               JAX; that reads the (8, 16) counts to the host, the sort's
               one synchronisation (the span `sync.digit_counts`).
  segments   — `segments=` cuts every pass into tile ranges, one launch
               (and one epoch) each, all writing into the same output
               buffers and each starting from the previous range's cursors:
               the EmulatedDeadlocking analog, bit-exact with the fused run.
               Segmented runs run every pass, as JAX's do.

  digit plane — `binning_pass(..., digits=)` takes each element's digit
               from an int32 plane instead of its code: the counterpart of
               `_build_pass(external_sp=True, out_rows=...)`, splitsweep's
               16-bucket partition (its bucket ids in place of digits, its
               outputs 16 row-aligned regions, more rows than the input).
               `flush_write` has no counterpart: it plain-wrote the partial
               row of a region no other stream shared, and here every
               element is written at its own address, so no row is shared.

Not ported: the TPU's within-row bitonic pack, run tables, MXU placement
and their `GST_RADIX16_*` switches (mechanism, not contract).  The tile may
be any number of rows (JAX wants a multiple of 128, a TPU placement rule).
"""

from __future__ import annotations

import torch

from ..utils.trace import launch_counter, readback
from . import _nvcc, kernels, rts

LANES = kernels.LANES
NBUCKETS = kernels.NBUCKETS
PASSES = rts.PASSES
MAX_PLANES = rts.MAX_PLANES
SOURCE = _nvcc.CSRC / "binning.cu"


def _bases_all_passes(codes: torch.Tensor):
    """(8, 16) exclusive digit bases and (8, 16) digit counts of 1-D biased
    int32 codes, from one histogram read."""
    joint = kernels.global_histogram(codes, passes=4).view(4, 16, 16)
    counts = []
    for p in range(PASSES):
        # (high nibble, low nibble) of byte p // 2; even passes read the low
        counts.append(joint[p // 2].sum(dim=1 if p % 2 else 0))
    counts = torch.stack(counts).to(torch.int32)
    bases = (torch.cumsum(counts, 1) - counts).to(torch.int32)
    return bases, counts


# ---- the binning pass -----------------------------------------------------


def _check_pass(planes, cursors, shift, tile_rows, out, digits):
    kernels.check_shift(shift)
    if digits is not None and (digits.dtype != torch.int32
                               or digits.shape != planes[0].shape):
        raise ValueError(f"binning_pass: digits must be int32 shaped like "
                         f"the planes {tuple(planes[0].shape)}, got "
                         f"{digits.dtype}{tuple(digits.shape)}")
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"binning_pass takes 1-{MAX_PLANES} planes, got "
                         f"{len(planes)}")
    if tuple(cursors.shape) != (NBUCKETS,):
        raise ValueError(f"binning_pass: cursors shape "
                         f"{tuple(cursors.shape)} != ({NBUCKETS},)")
    if out is not None and len(out) != len(planes):
        raise ValueError(f"binning_pass: {len(out)} outputs for "
                         f"{len(planes)} planes")
    rows = planes[0].shape[0]
    if tile_rows < 1 or rows % tile_rows or rows == 0:
        raise ValueError(f"{rows} rows are not whole tiles of {tile_rows}")
    if digits is not None:
        # the kernel indexes its bins by the digit: one read of the plane
        # and one synchronisation keep a bad plane from reaching it
        lo, hi = torch.aminmax(digits)
        if bool((lo < 0) | (hi >= NBUCKETS)):
            raise ValueError(f"binning_pass: digits must lie in [0, "
                             f"{NBUCKETS}), got [{int(lo)}, {int(hi)}]")


def binning_pass_plain(planes, cursors: torch.Tensor, shift: int,
                       tile_rows: int, out=None, digits=None):
    """Plain version: a stable argsort of the digit; the j-th element of
    digit d goes to cursors[d] + j.  Returns (outs, cursors_out)."""
    _check_pass(planes, cursors, shift, tile_rows, out, digits)
    x = planes[0].reshape(-1)
    d = (kernels.digits(x, shift) if digits is None
         else digits.reshape(-1).to(torch.int64))
    order = torch.argsort(d, stable=True)
    sd = d[order]
    counts = torch.bincount(d, minlength=NBUCKETS)
    first = torch.cumsum(counts, 0) - counts
    dst = (cursors.to(torch.int64)[sd]
           + torch.arange(x.numel(), device=x.device) - first[sd])
    if out is None:
        out = [torch.empty_like(p) for p in planes]
    for p, o in zip(planes, out):
        o.view(-1)[dst] = p.reshape(-1)[order]
    return out, (cursors.to(torch.int64) + counts).to(torch.int32)


@launch_counter
def binning_pass(planes, cursors: torch.Tensor, shift: int, tile_rows: int,
                 out=None, digits=None):
    """One stable pass of the 4-bit digit at `shift` over 1-3 (rows, 128)
    int32 planes (plane 0 the biased codes) of whole tiles: the j-th
    element of digit d goes to cursors[d] + j of every output plane.
    Returns (outs, cursors_out), cursors_out = cursors + the digit counts.

    `out` (default: new planes shaped like the inputs) lets the tile ranges
    of one pass write into the same buffers, each from the last range's
    cursors_out; it may have more rows than the input.  `digits`, an int32
    plane shaped like the inputs with values in [0, 16), gives each
    element's digit in place of its code's (`shift` is then unused; a
    value out of range raises ValueError, on either device).  `tile_rows`
    only checks that the range is whole tiles: the kernel cuts it into its
    own partitions.  CUDA planes launch `csrc/binning.cu` once (or raise);
    CPU planes take `binning_pass_plain`."""
    _check_pass(planes, cursors, shift, tile_rows, out, digits)
    if planes[0].device.type == "cpu":
        for p in list(planes) + list(out or []):
            kernels.check_int32("binning_pass", p)
        return binning_pass_plain(planes, cursors, shift, tile_rows, out,
                                  digits)
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError(f"binning_pass: unsupported device {dev}")
    rows = planes[0].shape[0]
    for i, p in enumerate(planes):
        _nvcc.check("binning_pass", f"planes[{i}]", p, (rows, LANES), dev,
                    ref="planes[0]")
    _nvcc.check("binning_pass", "cursors", cursors, (NBUCKETS,), dev,
                ref="planes[0]")
    if digits is not None:
        _nvcc.check("binning_pass", "digits", digits, (rows, LANES), dev,
                    ref="planes[0]")
    if rows * LANES >= 1 << 30:
        raise ValueError(f"binning_pass: {rows * LANES} elements in one "
                         "launch exceed the 30-bit counts of its status "
                         "words")
    if out is None:
        out = [torch.empty_like(p) for p in planes]
    out_rows = out[0].shape[0]
    for i, o in enumerate(out):
        _nvcc.check("binning_pass", f"out[{i}]", o, (out_rows, LANES), dev,
                    ref="planes[0]")
    if out_rows * LANES >= 1 << 31:
        raise ValueError(f"binning_pass: {out_rows * LANES} output elements "
                         "exceed int32")
    n = rows * LANES
    lib = _nvcc.load(SOURCE)
    parts = -(-n // lib.gst_binning_partition())
    cursors_out = torch.empty_like(cursors)
    # 16 status words a partition in the chained scans' scratch of this
    # device and stream, with the call's epoch: no clearing launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch, epoch = kernels._scan_scratch(dev, stream, parts * NBUCKETS)
    spare = [0] * (MAX_PLANES - len(planes))
    _nvcc.launch("binning_pass", lib.gst_binning,
                 *[p.data_ptr() for p in planes], *spare,
                 *[o.data_ptr() for o in out], *spare,
                 None if digits is None else digits.data_ptr(),
                 cursors.data_ptr(), cursors_out.data_ptr(),
                 scratch.data_ptr(), scratch.numel() - 1, epoch,
                 len(planes), n, shift, device=dev, stream=stream)
    binning_pass.launches += 1
    return out, cursors_out


# ---- the engine -----------------------------------------------------------


def _sort_radix16(operands, tile_rows: int,
                  segments: tuple[int, ...] | None = None):
    """Stable 8-pass LSD sort of (codes, *rides), 1-D int32 each (at most
    two rides); returns the sorted tuple.

    segments: tile-index cut points; each pass then runs as a chain of
    tile-range launches with explicit cursor handoff (the
    EmulatedDeadlocking analog — bit-exact with the fused run)."""
    planes, n = rts.pad_tiles(operands, tile_rows)
    rows = planes[0].shape[0]
    total_tiles = rows // tile_rows
    bases, digit_counts = _bases_all_passes(planes[0].reshape(-1))
    bounds = sorted({0, total_tiles}
                    | {s for s in segments or () if 0 < s < total_tiles})
    if len(bounds) == 2:
        # the sort's one synchronisation: the counts decide the pass skip
        with readback("digit_counts", digit_counts):
            skip = (digit_counts.max(dim=1).values == rows * LANES).tolist()
    for p in range(PASSES):
        shift = 4 * p
        if len(bounds) == 2:
            if not skip[p]:
                planes, _ = binning_pass(planes, bases[p], shift, tile_rows)
            continue
        out, cursors = [torch.empty_like(x) for x in planes], bases[p]
        for a, b in zip(bounds[:-1], bounds[1:]):
            seg = [x[a * tile_rows:b * tile_rows] for x in planes]
            _, cursors = binning_pass(seg, cursors, shift, tile_rows, out)
        planes = out
    return tuple(y.reshape(-1)[:n] for y in planes)


def adversarial_segments(n: int, tile_rows: int = 512) -> tuple[int, ...]:
    """Awkward tile-range cut points for the EmulatedDeadlocking analog:
    right after the first tile, near thirds, and right before the last
    tile (reference intent: EmulatedDeadlocking.hlsl:15-247 forces the
    lookback fallback; here the hazard is a pass split across launches)."""
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    rows = max(tile_rows, -(-n // LANES))
    rows = -(-rows // tile_rows) * tile_rows
    t = rows // tile_rows
    return tuple(sorted({1, t // 3, t // 2, t - 1} - {0}))


def sort_codes_radix16(codes: torch.Tensor, tile_rows: int | None = None,
                       segments: tuple[int, ...] | None = None
                       ) -> torch.Tensor:
    """Full 8-pass LSD radix-16 sort of biased int32 codes (keys only); the
    tile defaults to the tuning row of the codes' device."""
    if tile_rows is None:
        tile_rows = rts.default_tile_rows(codes.device)
    return _sort_radix16((codes,), tile_rows, segments)[0]


def sort_pairs_radix16(codes: torch.Tensor, payload: torch.Tensor,
                       tile_rows: int | None = None,
                       segments: tuple[int, ...] | None = None):
    """Stable pair sort of biased codes and an int32 payload; bit-exact
    with `torch.sort(codes, stable=True)` applied to both."""
    if tile_rows is None:
        tile_rows = rts.default_tile_rows(codes.device, pairs=True)
    return _sort_radix16((codes, payload), tile_rows, segments)
