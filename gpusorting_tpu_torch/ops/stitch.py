"""Stable stream compaction and expansion: the ragged-stitch primitives of
the segmented sort, each a hand-written CUDA kernel beside its plain
PyTorch version.

Port of `gpusorting_tpu/ops/stitch.py`:
  compact_ops / compact <- `_compact_kernel` (stitch.py:85), kernel
                           `csrc/stitch.cu` `gst_compact`
  expand_ops            <- `_expand_kernel` (stitch.py:324), kernel
                           `csrc/stitch.cu` `gst_expand`

Operands are 1-4 1-D int32 planes (uint32 viewed as int32) moved by one
1-D bool mask.  The TPU kernels carried a write (compact) or read (expand)
cursor across a grid that ran in order; on the card each tile of 2048
elements ranks its mask and takes its base from a chained scan with
decoupled lookback, one launch a call, on the 64-bit status words and the
per-call epoch of `kernels._scan_scratch`, which the scan and the binning
pass share on each stream (no clearing, no allocation a call).  The count
is a 0-d int32 tensor on the mask's device, so no call waits for the card.
Each wrapper launches its kernel on CUDA tensors (or raises) and takes the
plain version only for CPU tensors; `fn.launches` counts the kernel
launches (`utils.trace.counts()` reads it as `launch.stitch.<fn>`).  The mask may start at any byte and each plane at any 4-byte
offset.  n is below 2^30.
"""

from __future__ import annotations

import torch

from ..utils.trace import launch_counter
from . import _nvcc, kernels

SOURCE = _nvcc.CSRC / "stitch.cu"
TILE = 2048            # elements per block of csrc/stitch.cu (kTile)
MAX_PLANES = 4
MAX_ELEMS = 1 << 30    # exclusive: the kernels' limit


def _check(op: str, planes: tuple, mask: torch.Tensor, same_length: bool):
    """The checks both devices share: 1-4 1-D int32 planes, a 1-D bool mask
    below 2^30 elements, and (compact) every plane as long as the mask."""
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"{op} takes 1-{MAX_PLANES} planes, got "
                         f"{len(planes)}")
    if mask.dtype != torch.bool or mask.ndim != 1:
        raise TypeError(f"{op}: mask must be a 1-D bool tensor, got "
                        f"{mask.dtype} of shape {tuple(mask.shape)}")
    if mask.shape[0] >= MAX_ELEMS:
        raise ValueError(f"{op}: {mask.shape[0]} elements; the kernel's "
                         f"30-bit counts take fewer than 2^30")
    for i, p in enumerate(planes):
        if p.dtype != torch.int32 or p.ndim != 1:
            raise TypeError(f"{op}: planes[{i}] must be a 1-D int32 tensor, "
                            f"got {p.dtype} of shape {tuple(p.shape)}")
        if same_length and p.shape != mask.shape:
            raise ValueError(f"{op}: planes[{i}] length {p.shape[0]} != "
                             f"mask length {mask.shape[0]}")


def _check_cuda(op: str, planes: tuple, mask: torch.Tensor) -> None:
    dev = mask.device
    if dev.type != "cuda":
        raise ValueError(f"{op}: unsupported device {dev}")
    _nvcc.check(op, "mask", mask, tuple(mask.shape), dev, ref="mask",
                dtype=torch.bool, align=1)
    for i, p in enumerate(planes):
        _nvcc.check(op, f"planes[{i}]", p, tuple(p.shape), dev, ref="mask",
                    align=4)


def _pointers(tensors) -> list:
    """Data pointers padded with nulls to MAX_PLANES."""
    ptrs = [t.data_ptr() for t in tensors]
    return ptrs + [None] * (MAX_PLANES - len(ptrs))


# ---- compact --------------------------------------------------------------


def _ranks(mask: torch.Tensor) -> torch.Tensor:
    """The exclusive rank of every set position (int64; unset positions
    get the next set position's rank)."""
    return torch.cumsum(mask, 0) - mask.to(torch.int64)


def compact_plain(values: tuple, mask: torch.Tensor):
    """Plain version: the mask's running count gives each set element its
    place, and one index scatter per plane puts it there (unset elements go
    to a slot past the end, then cut off).  The tail past the count is 0."""
    n = mask.shape[0]
    tgt = torch.where(mask, _ranks(mask), n)
    outs = []
    for v in values:
        out = torch.zeros(n + 1, dtype=v.dtype, device=v.device)
        out.scatter_(0, tgt, v)
        outs.append(out[:n])
    return tuple(outs), mask.sum(dtype=torch.int32)


@launch_counter
def compact_ops(values: tuple, mask: torch.Tensor):
    """Dense streams of `v[mask]` for 1-4 1-D int32 planes moved by the same
    bool mask, in input order.  Returns (packed_tuple, count): each packed
    plane is as long as the mask, `packed[p][:count]` are the selected
    elements and the tail is unspecified; count is a 0-d int32 tensor.

    CUDA tensors launch `csrc/stitch.cu` once (or raise); CPU tensors take
    `compact_plain`."""
    values = tuple(values)
    _check("compact_ops", values, mask, same_length=True)
    if mask.device.type == "cpu":
        return compact_plain(values, mask)
    _check_cuda("compact_ops", values, mask)
    dev = mask.device
    n = mask.shape[0]
    outs = tuple(torch.empty_like(v) for v in values)
    if n == 0:
        return outs, torch.zeros((), dtype=torch.int32, device=dev)
    # the count is written by the block of the last tile; the status words
    # are the scan's on this stream, one a tile, with the next epoch
    count = torch.empty((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch, epoch = kernels._scan_scratch(dev, stream, -(-n // TILE))
    _nvcc.launch("compact_ops", _nvcc.load(SOURCE).gst_compact,
                 *_pointers(values), *_pointers(outs), mask.data_ptr(), n,
                 count.data_ptr(), scratch.data_ptr(), scratch.numel() - 1,
                 epoch, len(values), device=dev, stream=stream)
    compact_ops.launches += 1
    return outs, count


def compact(values: torch.Tensor, mask: torch.Tensor):
    """Dense stream of `values[mask]` (order-preserving) for one 1-D int32
    plane: (packed, count), `packed[:count]` the selected elements."""
    packed, count = compact_ops((values,), mask)
    return packed[0], count


# ---- expand ---------------------------------------------------------------


def expand_plain(srcs: tuple, mask: torch.Tensor) -> tuple:
    """Plain version: the mask's running count gives each set position its
    stream index, and one index gather per plane reads it (from the stream
    zero-padded to the mask's length); unset positions get 0."""
    n = mask.shape[0]
    idx = _ranks(mask).clamp(max=max(n - 1, 0))
    outs = []
    for s in srcs:
        padded = torch.zeros(n, dtype=s.dtype, device=s.device)
        m = min(n, s.shape[0])
        padded[:m] = s[:m]
        outs.append(torch.where(mask, padded[idx], 0))
    return tuple(outs)


@launch_counter
def expand_ops(srcs: tuple, mask: torch.Tensor) -> tuple:
    """Place dense streams at the set positions of a bool mask: the inverse
    of `compact_ops`.  For each 1-D int32 plane, `out[i] = src[rank(i)]`
    where `mask[i]` (rank = the number of set positions before i) and 0
    elsewhere.  A stream may be shorter than the mask; a rank past its end
    reads 0.

    CUDA tensors launch `csrc/stitch.cu` once (or raise); CPU tensors take
    `expand_plain`."""
    srcs = tuple(srcs)
    _check("expand_ops", srcs, mask, same_length=False)
    if mask.device.type == "cpu":
        return expand_plain(srcs, mask)
    _check_cuda("expand_ops", srcs, mask)
    dev = mask.device
    n = mask.shape[0]
    outs = tuple(torch.empty(n, dtype=torch.int32, device=dev)
                 for _ in srcs)
    if n == 0:
        return outs
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch, epoch = kernels._scan_scratch(dev, stream, -(-n // TILE))
    lens = [s.shape[0] for s in srcs] + [0] * (MAX_PLANES - len(srcs))
    _nvcc.launch("expand_ops", _nvcc.load(SOURCE).gst_expand,
                 *_pointers(srcs), *lens, *_pointers(outs), mask.data_ptr(), n,
                 scratch.data_ptr(), scratch.numel() - 1, epoch, len(srcs),
                 device=dev, stream=stream)
    expand_ops.launches += 1
    return outs
