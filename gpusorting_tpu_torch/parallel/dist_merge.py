"""The distributed sort's merge of the received runs, with its CUDA kernel
(`csrc/dist_merge.cu`).

Each rank of `distributed_sort` receives D runs, one a source, each sorted
by (code, global index) with a valid prefix of min(rc[s], cap) slots.
Every global index of source s lies below every one of source s + 1, so
the (code, global index) order of the valid elements is the stable merge
of the runs by code, equal codes taken from the lower source first.
`merge_runs` writes that merge, padded with the fills to `pad_to` slots, in
place of the JAX package's one local sort of every received slot by the
int64 composite (`merge_plain`, the plain version).

`merge_runs` launches the kernel on CUDA tensors (or raises) and takes
`merge_plain` of the valid prefixes, then the fills, only for CPU tensors;
`merge_runs.launches` counts the kernel launches, two a call (the
partition and the merge), which `utils.trace.counts()` reads as
`launch.dist_merge.merge_runs`.
"""

from __future__ import annotations

import torch

from ..core import codec
from ..ops import _nvcc
from ..utils.trace import launch_counter

SOURCE = _nvcc.CSRC / "dist_merge.cu"
MAX_PLANES = 3
MAX_SOURCES = 32       # the kernel's runs
MAX_CAP = (1 << 32) - 1   # the kernel's 32-bit positions in a run


def _runs(op: str, planes, rc: torch.Tensor, cap: int, pad_to: int, fills):
    """Check the operands both devices share; return the planes as
    (chunks, D, cw) views (a 2-D (D, cap) plane is one chunk)."""
    planes = [p if p.ndim != 2 else p.unsqueeze(0) for p in planes]
    if not 2 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"{op} takes 2-{MAX_PLANES} planes, got "
                         f"{len(planes)}")
    if len(fills) != len(planes):
        raise ValueError(f"{op}: {len(fills)} fills for {len(planes)} "
                         f"planes")
    if rc.dtype != torch.int32 or rc.ndim != 1:
        raise TypeError(f"{op}: rc must be a 1-D int32 tensor, got "
                        f"{rc.dtype} of shape {tuple(rc.shape)}")
    shape = planes[0].shape
    for i, p in enumerate(planes):
        if p.device != rc.device:
            raise ValueError(f"{op}: planes[{i}] on {p.device}, rc on "
                             f"{rc.device}")
        if p.dtype != torch.int32 or p.ndim != 3 or p.shape != shape:
            raise ValueError(f"{op}: planes[{i}] must be a (chunks, D, cw) "
                             f"or (D, cap) int32 tensor like planes[0] "
                             f"{tuple(shape)}, got {p.dtype} of shape "
                             f"{tuple(p.shape)}")
    chunks, d, cw = shape
    if d != rc.shape[0] or chunks * cw != cap or cap < 1:
        raise ValueError(f"{op}: planes {tuple(shape)} do not hold "
                         f"{rc.shape[0]} runs of cap {cap}")
    if pad_to < d * cap:
        raise ValueError(f"{op}: pad_to {pad_to} < D * cap {d * cap}")
    return planes


def merge_plain(flat) -> list:
    """Plain version of the merge, the JAX package's: sort flat 1-D
    operands (codes, global indices, payloads) by (code, global index) as
    one int64 composite; the payloads follow the permutation.  (A stable
    sort by code alone would leave a masked tail, code SENTINEL with index
    0xFFFFFFFF, ahead of a later source's real max-code keys.)"""
    comp, idx = torch.sort(codec.join_wide(flat[1], flat[0]))
    gidx, codes = codec.split_wide(comp)
    return [codes, gidx] + [p[idx] for p in flat[2:]]


@launch_counter
def merge_runs(planes, rc: torch.Tensor, cap: int, pad_to: int,
               fills) -> list:
    """Merge the D runs a rank received, stably by code, into one padded
    block per plane.

    planes  2-3 int32 tensors: the biased codes, the global indices and
            the payload, each (chunks, D, cw) with chunks * cw = cap
            (chunk c of source s's run is planes[o][c, s]: the collective
            exchange's blocks), or (D, cap) (the ring's rows), any strides
            but a unit one along a chunk
    rc      (D,) int32 counts received; run s's valid prefix is
            min(max(rc[s], 0), cap), and the slots past it are not read
    cap     the cell each run was sent in
    pad_to  slots of each output (>= D * cap)
    fills   one int32 fill per plane

    Returns one (pad_to,) int32 tensor per plane: the valid elements in
    (code, source) order, each run's order kept, then the fill.  CUDA
    tensors launch `csrc/dist_merge.cu` (two launches; or raise); CPU
    tensors take `merge_plain` of the valid prefixes, then the fills."""
    planes = _runs("merge_runs", planes, rc, cap, pad_to, fills)
    if rc.device.type == "cpu":
        lens = rc.clamp(0, cap).tolist()
        flat = [torch.cat([p[:, s, :].reshape(-1)[:n]
                           for s, n in enumerate(lens)]) for p in planes]
        return [torch.cat([x, x.new_full((pad_to - x.shape[0],), f)])
                for x, f in zip(merge_plain(flat), fills)]
    dev = rc.device
    if dev.type != "cuda":
        raise ValueError(f"merge_runs: unsupported device {dev}")
    _nvcc.check("merge_runs", "rc", rc, tuple(rc.shape), dev, ref="rc",
                align=4)
    chunks, d, cw = planes[0].shape
    for i, p in enumerate(planes):
        if p.stride(2) != 1 and cw > 1:
            raise ValueError(f"merge_runs: planes[{i}] chunks must have "
                             f"unit stride")
        if p.data_ptr() % 4:
            raise ValueError(f"merge_runs: planes[{i}] must be 4-byte "
                             f"aligned")
    if d > MAX_SOURCES:
        raise ValueError(f"merge_runs: {d} sources exceed the kernel's "
                         f"{MAX_SOURCES}")
    if cap > MAX_CAP:
        raise ValueError(f"merge_runs: cap {cap} exceeds the kernel's "
                         f"{MAX_CAP}")
    lib = _nvcc.load(SOURCE)
    tiles = -(-pad_to // lib.gst_merge_tile())
    part = torch.empty((tiles + 1) * d, dtype=torch.int32, device=dev)
    outs = [torch.empty(pad_to, dtype=torch.int32, device=dev)
            for _ in planes]
    pad = MAX_PLANES - len(planes)
    _nvcc.launch("merge_runs", lib.gst_merge_runs,
                 *[p.data_ptr() for p in planes], *[None] * pad,
                 *[p.stride(0) for p in planes], *[0] * pad,
                 *[p.stride(1) for p in planes], *[0] * pad,
                 *[o.data_ptr() for o in outs], *[None] * pad,
                 *[int(f) for f in fills], *[0] * pad, len(planes),
                 rc.data_ptr(), d, cap, cw, pad_to, part.data_ptr(),
                 device=dev)
    merge_runs.launches += 2
    return outs
