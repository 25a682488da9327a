"""The distributed sort's exchange on torch.distributed, with its
receive-side masking as a hand-written CUDA kernel (`csrc/exchange_mask.cu`).

Port of `gpusorting_tpu/parallel/remote_exchange.py`.  The Pallas kernel
there (`_exchange_kernel`) is an all-to-all of a (D, num_ops*R, 128) u32
send matrix with a count per (src, dst) cell: every device posts one remote
DMA per destination and masks each arriving block in place (positions at or
past the block's count get 0xFFFFFFFF in operands 0-1 and 0 in payload
operands) while later sources' DMAs are still in flight.  On the card the
two halves part:

  transfer  torch.distributed.  `ring_exchange` keeps the kernel's ring
            order: round k sends to rank+k and receives from rank-k, one
            `batch_isend_irecv` a round (NCCL on CUDA tensors, gloo on CPU
            ones), so each source's block is masked as soon as its round
            lands while later rounds are in flight.  `collective_exchange`
            is the JAX package's "collective" transport: chunks along the
            cell, one async `all_to_all_single` per chunk and operand (NCCL,
            or gloo, which also carries CUDA tensors), each chunk masked as
            soon as it lands.
  masking   `mask_arrivals`, one launch for every operand of a chunk or of
            one source's block.  It reads the counts on the device: no call
            here waits for the card.

Where each has run: both transports on gloo CPU tensors at 8 ranks
(tests/test_torch_dist.py, test_torch_remote_exchange.py); both on NCCL
at one rank on an H100 (chip_smoke.py phase 17, where the ring is the
local copy alone); the collective exchange on gloo CUDA tensors at 4 ranks
on one H100 (phase 18).  The ring over NCCL at more than one rank has not
run: NCCL refuses two ranks on one card, and gloo's point-to-point ops
fail on CUDA tensors, so `require_transport` refuses that pair.

`mask_arrivals` launches the kernel on CUDA tensors (or raises) and takes
`mask_arrivals_plain` only for CPU tensors; `mask_arrivals.launches` counts
the kernel launches (`utils.trace.counts()` reads it as
`launch.remote_exchange.mask_arrivals`).  Planes are int32 (u32 bits viewed as int32); a fill
is the carrier's own value: the JAX package's 0xFFFFFFFF is -1 here, and
the biased code plane of the distributed sort fills with
`core.codec.SENTINEL`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import _nvcc
from ..utils.trace import launch_counter

SOURCE = _nvcc.CSRC / "exchange_mask.cu"
LANES = 128
MAX_PLANES = 4
MAX_SOURCES = 65535    # the kernel's grid rows


def raw_fills(num_ops: int) -> tuple:
    """The JAX kernel's fills on u32 bits: 0xFFFFFFFF (-1 as int32) for
    operands 0 and 1, 0 for the payloads."""
    return tuple(-1 if o < 2 else 0 for o in range(num_ops))


def _window(op: str, planes, rc: torch.Tensor, fills, sources):
    """Check the operands both devices share; return (src0, nsrc)."""
    planes = tuple(planes)
    if not 1 <= len(planes) <= MAX_PLANES:
        raise ValueError(f"{op} takes 1-{MAX_PLANES} planes, got "
                         f"{len(planes)}")
    if len(fills) != len(planes):
        raise ValueError(f"{op}: {len(fills)} fills for {len(planes)} "
                         f"planes")
    if rc.dtype != torch.int32 or rc.ndim != 1:
        raise TypeError(f"{op}: rc must be a 1-D int32 tensor, got "
                        f"{rc.dtype} of shape {tuple(rc.shape)}")
    d = rc.shape[0]
    shape = planes[0].shape
    for i, p in enumerate(planes):
        if p.dtype != torch.int32 or p.ndim != 2 or p.shape != shape:
            raise ValueError(f"{op}: planes[{i}] must be a (D, W) int32 "
                             f"tensor like planes[0] {tuple(shape)}, got "
                             f"{p.dtype} of shape {tuple(p.shape)}")
    if shape[0] != d:
        raise ValueError(f"{op}: planes have {shape[0]} rows, rc {d}")
    if sources is None:
        sources = range(d)
    if not isinstance(sources, range) or sources.step != 1 or not (
            0 <= sources.start <= sources.stop <= d):
        raise ValueError(f"{op}: sources must be a range of step 1 inside "
                         f"[0, {d}), got {sources!r}")
    return sources.start, len(sources)


def mask_arrivals_plain(planes, rc: torch.Tensor, fills, col0: int = 0,
                        sources: range | None = None) -> None:
    """Plain version of `mask_arrivals`: the `torch.where(pos < rc, x,
    fill)` form, written back in place."""
    src0, nsrc = _window("mask_arrivals_plain", planes, rc, fills, sources)
    for plane, fill in zip(planes, fills):
        rows = plane[src0:src0 + nsrc]
        pos = col0 + torch.arange(rows.shape[1], device=rows.device)
        valid = pos[None, :] < rc[src0:src0 + nsrc, None]
        rows.copy_(torch.where(valid, rows, fill))


@launch_counter
def mask_arrivals(planes, rc: torch.Tensor, fills, col0: int = 0,
                  sources: range | None = None) -> None:
    """Mask arrived exchange blocks in place.

    planes   1-4 int32 tensors of shape (D, W), unit stride along a row
             (any row stride): row s holds positions col0 .. col0 + W - 1
             of the block that source s sent (W = the cell for a whole
             block, the chunk's width for one chunk of it)
    rc       (D,) int32 counts received from each source; a count above
             the cell (sender truncation) leaves the whole row valid
    fills    one int32 fill per plane
    sources  a range of sources (step 1) to mask; all D by default

    Sets plane[s, j] = fill where col0 + j >= rc[s].  CUDA tensors launch
    `csrc/exchange_mask.cu` once for every plane (or raise); CPU tensors
    take `mask_arrivals_plain`."""
    planes = tuple(planes)
    src0, nsrc = _window("mask_arrivals", planes, rc, fills, sources)
    if rc.device.type == "cpu":
        mask_arrivals_plain(planes, rc, fills, col0, sources)
        return
    dev = rc.device
    if dev.type != "cuda":
        raise ValueError(f"mask_arrivals: unsupported device {dev}")
    _nvcc.check("mask_arrivals", "rc", rc, tuple(rc.shape), dev, ref="rc",
                align=4)
    width = planes[0].shape[1]
    for i, p in enumerate(planes):
        if p.device != dev:
            raise ValueError(f"mask_arrivals: planes[{i}] on {p.device}, "
                             f"rc on {dev}")
        if p.stride(1) != 1 and width > 1:
            raise ValueError(f"mask_arrivals: planes[{i}] rows must have "
                             f"unit stride")
        if p.data_ptr() % 4:
            raise ValueError(f"mask_arrivals: planes[{i}] must be 4-byte "
                             f"aligned")
    if nsrc > MAX_SOURCES:
        raise ValueError(f"mask_arrivals: {nsrc} sources exceed the "
                         f"kernel's {MAX_SOURCES}")
    if nsrc == 0 or width == 0:
        return
    pad = MAX_PLANES - len(planes)
    _nvcc.launch("mask_arrivals", _nvcc.load(SOURCE).gst_mask_arrivals,
                 *[p.data_ptr() for p in planes], *[None] * pad,
                 *[p.stride(0) for p in planes], *[0] * pad,
                 *[int(f) for f in fills], *[0] * pad, len(planes),
                 rc.data_ptr(), src0, nsrc, width, col0, device=dev)
    mask_arrivals.launches += 1


def require_transport(group, device: torch.device, exchange: str) -> None:
    """Raise unless the group's backend carries tensors of `device` for
    `exchange`: gloo for CPU tensors; NCCL for CUDA tensors, or gloo for
    the collective exchange, whose collectives gloo also runs on CUDA
    tensors.  No tensor is ever moved to suit the group."""
    backend = str(dist.get_backend(group)).lower()
    if device.type == "cpu":
        ok = "gloo" in backend
    elif device.type == "cuda":
        ok = "nccl" in backend or ("gloo" in backend
                                   and exchange == "collective")
    else:
        ok = False
    if not ok:
        raise ValueError(f"the {backend!r} process group cannot carry the "
                         f"{exchange} exchange of {device.type} tensors")


def _peer(group, rank: int) -> int:
    return dist.get_global_rank(group, rank) if (
        group is not None and group is not dist.group.WORLD) else rank


def collective_exchange(send, counts: torch.Tensor, group, fills):
    """Chunked all-to-all of the cell matrices, each chunk masked on
    arrival.

    send    per operand an int32 tensor (chunks, D, cw): chunk c of the
            cell for destination d is send[o][c, d]
    counts  (D,) int32 elements destined to each rank
    Returns (recv, rc): recv like send, recv[o][c, s] chunk c of the cell
    from source s, masked; rc (D,) int32 counts received."""
    rc = torch.empty_like(counts)
    dist.all_to_all_single(rc, counts, group=group)
    recv = [torch.empty_like(s) for s in send]
    chunks, _, cw = send[0].shape
    works = [[dist.all_to_all_single(r[c], s[c], group=group, async_op=True)
              for r, s in zip(recv, send)] for c in range(chunks)]
    for c in range(chunks):
        for w in works[c]:
            w.wait()
        mask_arrivals([r[c] for r in recv], rc, fills, col0=c * cw)
    return recv, rc


def ring_exchange(send, recv, counts: torch.Tensor, group, fills):
    """The Pallas kernel's ring: the own block by a local copy, masked
    first; then round k = 1 .. D-1 sends cell rank+k and receives cell
    rank-k, every round posted up front, and each source's block is masked
    as its round lands.

    send, recv  per operand a (D, cap) int32 tensor (any row stride, each
                row contiguous): send[o][d] goes to rank d, recv[o][s]
                receives source s
    counts      (D,) int32, sent in-band with each cell
    Returns rc, the (D,) int32 counts received (the kernel's second
    output)."""
    d = counts.shape[0]
    me = dist.get_rank(group)
    rc = torch.empty_like(counts)
    rounds = []
    for k in range(1, d):
        dst, src = (me + k) % d, (me - k) % d
        ops = [dist.P2POp(dist.isend, counts[dst:dst + 1], _peer(group, dst),
                          group, tag=0),
               dist.P2POp(dist.irecv, rc[src:src + 1], _peer(group, src),
                          group, tag=0)]
        for o, (s, r) in enumerate(zip(send, recv)):
            ops += [dist.P2POp(dist.isend, s[dst], _peer(group, dst), group,
                               tag=1 + o),
                    dist.P2POp(dist.irecv, r[src], _peer(group, src), group,
                               tag=1 + o)]
        rounds.append((src, dist.batch_isend_irecv(ops)))
    rc[me:me + 1].copy_(counts[me:me + 1])
    for s, r in zip(send, recv):
        r[me].copy_(s[me])
    mask_arrivals(recv, rc, fills, sources=range(me, me + 1))
    for src, works in rounds:
        for w in works:
            w.wait()
        mask_arrivals(recv, rc, fills, sources=range(src, src + 1))
    return rc


def remote_exchange(send: torch.Tensor, counts: torch.Tensor, *, group,
                    num_ops: int):
    """All-to-all + receive-side masking in the Pallas kernel's ring order,
    with its operands (called on every rank of `group`):

      send    (D, num_ops*R, 128) int32 (u32 bits); the rows of operand o
              for destination d are send[d, o*R:(o+1)*R, :]
      counts  (D,) int32: elements destined to each rank (above the cell
              means sender truncation; the whole cell is then valid)

    Returns (data, rc): data (D, num_ops*R, 128) int32, block s the masked
    arrival from source s (0xFFFFFFFF past the count in operands 0 and 1,
    0 in the rest); rc (D,) int32, the counts received."""
    d, orows, lanes = send.shape
    world = dist.get_world_size(group) if d and lanes == LANES and not (
        orows % num_ops) else None
    if d != world:
        raise ValueError(f"bad send shape {tuple(send.shape)} for "
                         f"num_ops={num_ops} on {world} ranks")
    require_transport(group, send.device, "remote_dma")
    cap = orows // num_ops * LANES
    data = torch.empty_like(send)

    def planes(t):
        return [t.view(d, num_ops, cap)[:, o] for o in range(num_ops)]

    rc = ring_exchange(planes(send), planes(data), counts.to(torch.int32),
                       group, raw_fills(num_ops))
    return data, rc
