"""The radix engines' building blocks: the global 8-bit digit counts, the
per-tile 4-bit digit counts (the Upsweep) and the exclusive scan, each a
hand-written CUDA kernel beside its plain PyTorch version.

Port of `gpusorting_tpu/ops/kernels.py`:
  global_histogram <- `_hist_kernel` (kernels.py:62), kernel
                      `csrc/global_hist.cu` (shared-memory counters and
                      global atomics: the TPU kernel's sum across an
                      in-order grid has no CUDA counterpart)
  tile_histogram4  <- `_tile_hist4_kernel` (kernels.py:144), kernel
                      `csrc/tile_hist4.cu`
  exclusive_scan   <- `_scan_kernel` (kernels.py:209), kernel
                      `csrc/exclusive_scan.cu` (one launch of a chained
                      scan with decoupled lookback: the TPU kernel's
                      running sum across an in-order grid has no CUDA
                      counterpart either)

Codes are the port's biased int32 carriers (`core/codec.py`): the digit at
`shift` is `((x ^ 0x80000000) >> shift) & 15`.  Each wrapper launches its
kernel on a CUDA tensor (or raises) and takes the plain version only for a
CPU tensor; `fn.launches` counts the kernel launches, which
`utils.trace.counts()` reads as `launch.kernels.<fn>`.
"""

from __future__ import annotations

import torch

from ..core import codec
from ..utils.trace import launch_counter
from . import _nvcc

LANES = 128
NBUCKETS = 16
GLOBAL_HIST_SOURCE = _nvcc.CSRC / "global_hist.cu"
HIST_SOURCE = _nvcc.CSRC / "tile_hist4.cu"
SCAN_SOURCE = _nvcc.CSRC / "exclusive_scan.cu"
SCAN_TILE = 2048    # elements per block of csrc/exclusive_scan.cu (kTile)


def digits(codes: torch.Tensor, shift: int) -> torch.Tensor:
    """The 4-bit digit at `shift` of biased int32 codes (int64 values); the
    xor restores the u32 code, so shift 28 reads its top nibble."""
    return ((codes ^ codec.SIGN) >> shift).to(torch.int64) & 15


def check_shift(shift: int) -> None:
    if not 0 <= shift <= 28:
        raise ValueError(f"shift must be in [0, 28], got {shift}")


def check_int32(op: str, t: torch.Tensor) -> None:
    """Raise unless `t` is int32: the CPU branch's check (the kernels take
    int32 only, `_nvcc.check` holds them to it, and the plain versions
    follow them)."""
    if t.dtype != torch.int32:
        raise TypeError(f"{op}: expected int32, got {t.dtype}")


# ---- global_histogram -----------------------------------------------------


def global_histogram_plain(codes: torch.Tensor,
                           passes: int = 4) -> torch.Tensor:
    """Plain version: one `index_add_` of ones per digit position."""
    u = codes ^ codec.SIGN           # the u32 codes' bits, as int32
    counts = torch.zeros((passes, 256), dtype=torch.int32,
                         device=codes.device)
    ones = torch.ones_like(u)
    for p in range(passes):
        counts[p].index_add_(0, ((u >> (8 * p)) & 255).to(torch.int64), ones)
    return counts


@launch_counter
def global_histogram(codes: torch.Tensor, passes: int = 4) -> torch.Tensor:
    """(passes, 256) int32 counts of the 8-bit digits 0..passes-1 of 1-D
    biased int32 codes (the digits of the u32 codes), in one read.

    A CUDA tensor launches `csrc/global_hist.cu` (or raises); a CPU tensor
    takes `global_histogram_plain`."""
    if codes.ndim != 1:
        raise ValueError(f"global_histogram takes a 1-D tensor, got "
                         f"{tuple(codes.shape)}")
    if not 1 <= passes <= 4:
        raise ValueError(f"passes must be in [1, 4], got {passes}")
    if codes.device.type == "cpu":
        check_int32("global_histogram", codes)
        return global_histogram_plain(codes, passes)
    if codes.device.type != "cuda":
        raise ValueError(f"global_histogram: unsupported device "
                         f"{codes.device}")
    dev = codes.device
    n = codes.shape[0]
    _nvcc.check("global_histogram", "codes", codes, (n,), dev)
    if n >= 1 << 31:
        raise ValueError(f"global_histogram: {n} codes exceed int32 counts")
    out = torch.empty((passes, 256), dtype=torch.int32, device=dev)
    _nvcc.launch("global_histogram",
                 _nvcc.load(GLOBAL_HIST_SOURCE).gst_global_hist,
                 codes.data_ptr(), n, passes, out.data_ptr(), device=dev)
    global_histogram.launches += 1
    return out


# ---- Upsweep: tile_histogram4 ---------------------------------------------


def tile_histogram4_plain(codes2d: torch.Tensor, shift: int,
                          tile_rows: int) -> torch.Tensor:
    """Plain version: count the key t * 16 + digit with one `index_add_`."""
    num_tiles = codes2d.shape[0] // tile_rows
    key = (torch.arange(codes2d.numel(), device=codes2d.device)
           // (tile_rows * LANES)) * NBUCKETS + digits(codes2d.reshape(-1),
                                                       shift)
    counts = torch.zeros(num_tiles * NBUCKETS, dtype=torch.int32,
                         device=codes2d.device)
    counts.index_add_(0, key, torch.ones_like(key, dtype=torch.int32))
    return counts.view(num_tiles, NBUCKETS)


@launch_counter
def tile_histogram4(codes2d: torch.Tensor, shift: int,
                    tile_rows: int) -> torch.Tensor:
    """(T, 16) int32 counts of the 4-bit digit at `shift` in each tile of
    `tile_rows` rows of a (T * tile_rows, 128) int32 plane of biased codes.

    A CUDA plane launches `csrc/tile_hist4.cu` (or raises); a CPU plane
    takes `tile_histogram4_plain`."""
    check_shift(shift)
    rows = codes2d.shape[0]
    if tile_rows < 1 or rows % tile_rows:
        raise ValueError(f"{rows} rows are not whole tiles of {tile_rows}")
    if codes2d.device.type == "cpu":
        check_int32("tile_histogram4", codes2d)
        return tile_histogram4_plain(codes2d, shift, tile_rows)
    if codes2d.device.type != "cuda":
        raise ValueError(f"tile_histogram4: unsupported device "
                         f"{codes2d.device}")
    dev = codes2d.device
    num_tiles = rows // tile_rows
    _nvcc.check("tile_histogram4", "codes2d", codes2d, (rows, LANES), dev)
    out = torch.empty((num_tiles, NBUCKETS), dtype=torch.int32, device=dev)
    _nvcc.launch("tile_histogram4", _nvcc.load(HIST_SOURCE).gst_tile_hist4,
                 codes2d.data_ptr(), out.data_ptr(), num_tiles,
                 tile_rows * LANES, shift, device=dev)
    tile_histogram4.launches += 1
    return out


# ---- Scan: exclusive_scan -------------------------------------------------


def exclusive_scan_plain(values: torch.Tensor) -> torch.Tensor:
    """Plain version: an int64 running sum less the element, wrapped to
    int32."""
    inclusive = torch.cumsum(values.to(torch.int64), 0)
    return codec.wrap_int32(inclusive - values.to(torch.int64))


# The chained scans' scratch, one per (device, stream): [buffer, epoch].
# Every chained scan uses it: `exclusive_scan` (one status word a tile),
# `radix16.binning_pass` (16 a partition), `stitch.compact_ops` and
# `stitch.expand_ops` (one a tile) and `radix256.sort`/`sort_pairs` (256 a
# partition).  A radix256 call draws it four times, an epoch for each of its
# passes, and gets one buffer back: every draw asks for the same words, and a
# wrap zeroes the buffer in place.  The buffer is an 8-byte ticket and the
# 64-bit status words, zeroed when allocated; each call on the stream, of any
# of these kernels, takes the next epoch, so the words an earlier call left
# never read as this call's, and the buffer is zeroed again only when the
# 30-bit epoch wraps.  Calls on one stream run in order, so they share it;
# calls on two streams never do.  A CUDA graph would replay the epoch it
# captured, and the status words its last replay left would read as ready, so
# no call takes the scratch under capture.
_SCAN_SCRATCH: dict = {}
_SCAN_EPOCHS = (1 << 30) - 1


def _scan_scratch(dev: torch.device, stream: int, words: int) -> tuple:
    """(buffer, epoch) for one call that needs `words` status words on
    `stream` (the current stream's handle).  Raises under CUDA-graph
    capture."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "the chained-scan kernels (exclusive_scan, binning_pass, "
            "compact_ops, expand_ops) cannot be captured in a CUDA graph: "
            "a replay would reuse the captured epoch of their status words")
    key = (dev.index, stream)
    entry = _SCAN_SCRATCH.get(key)
    if entry is None or entry[0].numel() < 1 + words:
        # allocated on `stream` (the current one), which alone uses it
        entry = [torch.zeros(1 + max(words, 1024), dtype=torch.int64,
                             device=dev), 0]
        _SCAN_SCRATCH[key] = entry
    entry[1] += 1
    if entry[1] > _SCAN_EPOCHS:
        entry[0].zero_()
        entry[1] = 1
    return entry[0], entry[1]


@launch_counter
def exclusive_scan(values: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of a 1-D int32 tensor, wrapping like int32.

    A CUDA tensor runs `csrc/exclusive_scan.cu`, one launch of a chained
    scan with decoupled lookback, counted in `exclusive_scan.launches` (or
    raises); a CPU tensor takes `exclusive_scan_plain`."""
    if values.ndim != 1:
        raise ValueError(f"exclusive_scan takes a 1-D tensor, got "
                         f"{tuple(values.shape)}")
    dev = values.device
    if dev.type == "cpu":
        check_int32("exclusive_scan", values)
        return exclusive_scan_plain(values)
    if dev.type != "cuda":
        raise ValueError(f"exclusive_scan: unsupported device {dev}")
    n = values.shape[0]
    _nvcc.check("exclusive_scan", "values", values, (n,), dev)
    out = torch.empty_like(values)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch, epoch = _scan_scratch(dev, stream, -(-n // SCAN_TILE))
    _nvcc.launch("exclusive_scan", _nvcc.load(SCAN_SOURCE).gst_exclusive_scan,
                 values.data_ptr(), out.data_ptr(), n, scratch.data_ptr(),
                 scratch.numel() - 1, epoch, device=dev, stream=stream)
    exclusive_scan.launches += 1
    return out
