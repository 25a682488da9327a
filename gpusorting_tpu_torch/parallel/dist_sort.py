"""Distributed sort on torch.distributed: sampled splitters + chunked
all-to-all.

Port of `gpusorting_tpu/parallel/dist_sort.py`, the same design step for
step, held bit for bit against it on the CPU:

  1. every rank takes its part of the GLOBAL strided sample (positions
     p = 0 mod stride, stride = max(1, n // (D * oversample))); one
     all_gather joins them in global-index order, and D-1 (code, global
     index) quantile splitters define one lexicographic range per rank
  2. destination cell counts come before the local sort (they are order-
     independent): the cell maximum's MAX all_reduce is posted before the
     sort is enqueued
  3. each rank stably sorts its shard; destination ranges are then
     contiguous runs, packed into (D, cap) cells by one gather, not masked
  4. the cell capacity is the smallest rung of a static ladder (2x/4x the
     mean cell, then the never-drop shard bound) that holds the global cell
     maximum, read once on the host (JAX picks it on the device with
     lax.switch); outputs are padded to D * the TOP rung whichever rung ran
  5. the cells ride the exchange (parallel/remote_exchange.py): chunked
     `all_to_all_single` ("collective") or the Pallas kernel's ring
     ("remote_dma"), each arrival masked by the CUDA kernel as it lands
  6. each rank merges what it received by (code, global index): JAX's one
     local sort of every received slot; here the stable D-way merge of
     the runs' valid prefixes, padded (parallel/dist_merge.py), which
     gives the same bits

Each rank holds its shard and calls `distributed_sort` with it (torch's
SPMD idiom); the process group takes the place of JAX's Mesh and axis.  The
shard's device is the device the sort runs on: NCCL carries CUDA shards,
gloo CPU shards (and the collective exchange of CUDA shards); no shard is
moved to suit the group.  Keys are u32 / i32 / f32, carried as the port's
biased int32 codes (core/codec.py), payloads 32-bit.  There is no tracer
path: every call runs.

Output convention (JAX's): each rank holds a sorted, left-packed, padded
range plus a valid count; concatenating the valid prefixes in rank order
yields the globally sorted array.  `distributed_sort_gather` materializes
that on every rank (for tests and small n).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..core import codec
from ..core.config import get_device_info
from ..utils.trace import span
from . import dist_merge, remote_exchange

_EXCHANGE_CHUNKS = 4
_GIDX_SENTINEL = -1     # the u32 0xFFFFFFFF as int32
# HBM sizing for the exchange buffers (JAX's constants): the ladder's top
# rung sizes every per-rank buffer at n_dev*cap elements per operand, with
# ~_EXCHANGE_LIVE_COPIES live copies through pack/exchange/merge.
_HBM_BUDGET_FRACTION = 0.25
_EXCHANGE_LIVE_COPIES = 4


def make_mesh(n_devices: int | None = None):
    """The process group of the first `n_devices` ranks (all by default):
    `dist.group.WORLD`, or a new group that every rank must create.

    A new group is returned to its members only once every member has
    connected to it: `new_group` returns on a member as soon as its own
    half of the backend's connections is made (gloo connects a full mesh),
    and a member that then tears the group down, or leaves the default
    group, closes the sockets a slower peer is still connecting through,
    which fails that peer.  So the members pass one barrier on the new
    group; the other ranks only take part in `new_group`."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed.init_process_"
                           "group to have run on every rank")
    world = dist.get_world_size()
    n = n_devices or world
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n} outside [1, {world}]")
    if n == world:
        return dist.group.WORLD
    group = dist.new_group(range(n))
    if dist.get_rank() < n:
        dist.barrier(group=group)
    return group


def _composite(codes: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """int64 (biased code << 32 | u32 global index): signed order is the
    lexicographic (code, global index) order."""
    return codec.join_wide(gidx, codes)


def _gidx(base: int, count: int, device) -> torch.Tensor:
    """Global indices base .. base + count - 1 as int32 (u32 bits)."""
    if base + count <= 1 << 31:
        return torch.arange(base, base + count, dtype=torch.int32,
                            device=device)
    return codec.wrap_int32(torch.arange(base, base + count,
                                         dtype=torch.int64, device=device))


def _splitters_from_sample(sample_codes: torch.Tensor,
                           sample_gidx: torch.Tensor, n_dev: int):
    """(code, global-index) quantile splitters of a sample: biased int32
    codes and int32 (u32 bits) global indices.

    The index tiebreak makes the splitter key a total order, so
    duplicate-heavy keys still split evenly across ranks."""
    comp = torch.sort(_composite(sample_codes, sample_gidx)).values
    m = comp.shape[0]
    idx = (torch.arange(1, n_dev, device=comp.device) * m) // n_dev
    spl_g, spl_c = codec.split_wide(comp[idx])
    return spl_c, spl_g


def _sample_splitters(codes: torch.Tensor, rank: int, n_dev: int,
                      oversample: int, group):
    """JAX's splitters: the global sample codes[::stride], each rank's part
    joined by one all_gather into buffers padded to the longest part.
    Every part's length is arithmetic, so no rank needs another's."""
    n_local = codes.shape[0]
    n = n_local * n_dev
    stride = max(1, n // (n_dev * oversample))
    first = [-(-(r * n_local) // stride) for r in range(n_dev + 1)]
    lens = [first[r + 1] - first[r] for r in range(n_dev)]
    buf = codes.new_zeros(max(lens))
    buf[:lens[rank]] = codes[first[rank] * stride - rank * n_local::stride]
    parts = [torch.empty_like(buf) for _ in range(n_dev)]
    dist.all_gather(parts, buf, group=group)
    sample = torch.cat([p[:m] for p, m in zip(parts, lens)])
    sample_gidx = codec.wrap_int32(torch.arange(0, n, stride,
                                                device=codes.device))
    return _splitters_from_sample(sample, sample_gidx, n_dev)


def _cell_counts(codes, gidx, spl_c, spl_g, n_dev: int) -> torch.Tensor:
    """(D,) int32 counts of local elements destined to each rank.

    Destination = number of splitters <= (code, global index); JAX's D-1
    compare-reductions, each over the shard's int64 composites (a
    searchsorted and a bincount would serialise on the bincount's atomics
    when the keys share a destination).  Order-independent, so callable
    before the local sort."""
    n_local = codes.shape[0]
    dev = codes.device
    if n_local == 0:
        return torch.zeros(n_dev, dtype=torch.int32, device=dev)
    edge = torch.full((1,), n_local, dtype=torch.int64, device=dev)
    if n_dev > 1:
        comp = _composite(codes, gidx)
        above = torch.stack([(comp >= s).sum() for s in
                             _composite(spl_c, spl_g)])
        edge = torch.cat([n_local - above, edge])
    bounds = torch.cat([edge.new_zeros(1), edge])
    return (bounds[1:] - bounds[:-1]).to(torch.int32)


def _local_sort(codes, gidx, pbits):
    """Stable shard sort by (code, global index): the shard's global index
    increases, so a stable sort of the codes gives JAX's num_keys=2
    order."""
    sc, idx = torch.sort(codes, stable=True)
    return [sc, gidx[idx]] + ([] if pbits is None else [pbits[idx]])


def _chunking(cap: int, chunks: int) -> tuple[int, int]:
    """(number of chunks, chunk width): JAX's rule, one chunk unless
    `chunks` divides the cell."""
    return (chunks, cap // chunks) if cap % chunks == 0 else (1, cap)


def _pack(sorted_ops, counts: torch.Tensor, cap: int, n_chunks: int):
    """Per operand the (n_chunks, D, cap / n_chunks) cells: cell d is the
    `cap` elements of the sorted shard from destination d's first element,
    NOT masked (its tail holds the next destination's elements, which the
    receiver masks; past the shard the index is clamped, and the receiver
    masks those positions too).  One gather per operand."""
    n_local = sorted_ops[0].shape[0]
    d = counts.shape[0]
    starts = torch.cumsum(counts, 0, dtype=torch.int64) - counts
    pos = torch.arange(cap, device=counts.device).view(n_chunks, 1, -1)
    idx = (starts.view(1, d, 1) + pos).clamp_(max=n_local - 1)
    return [x[idx] for x in sorted_ops]


def _exchange(send, counts, group, fills, exchange: str):
    """Exchange the packed cells; returns (recv like send, masked; rc)."""
    if exchange == "remote_dma":
        recv = [torch.empty_like(s) for s in send]
        rc = remote_exchange.ring_exchange([s[0] for s in send],
                                           [r[0] for r in recv], counts,
                                           group, fills)
        return recv, rc
    return remote_exchange.collective_exchange(send, counts, group, fills)


def _exchange_and_merge(sorted_ops, counts, cap: int, group, pad_to: int,
                        chunks: int, exchange: str):
    """Pack runs into cells, exchange, merge; pad to pad_to.

    Returns (ops, count, overflow): ops padded to pad_to elements with the
    fills, count this rank's valid elements, overflow the elements every
    rank dropped (the same on every rank)."""
    fills = (codec.SENTINEL, _GIDX_SENTINEL, 0)[:len(sorted_ops)]
    overflow = (counts.to(torch.int64) - cap).clamp_(min=0).sum().view(1)
    dist.all_reduce(overflow, op=dist.ReduceOp.SUM, group=group)
    n_chunks = 1 if exchange == "remote_dma" else _chunking(cap, chunks)[0]
    send = _pack(sorted_ops, counts, cap, n_chunks)
    recv, rc = _exchange(send, counts, group, fills, exchange)
    del send
    with span("dist.merge"):
        out = dist_merge.merge_runs(recv, rc, cap, pad_to, fills)
    del recv
    count = rc.clamp(max=cap).sum(dtype=torch.int64)
    return out, count, overflow.view(())


def _default_max_skew(n: int, n_dev: int, num_ops: int,
                      hbm_bytes: int) -> float | None:
    """Derive the ladder truncation from a device memory budget.

    Keeps the top rung's buffers (~_EXCHANGE_LIVE_COPIES live copies of
    num_ops (n_dev*cap,) 32-bit operands) under _HBM_BUDGET_FRACTION of
    `hbm_bytes`.  Returns None when even the drop-proof full-shard top fits
    (small n keeps the overflow-impossible property); otherwise the
    largest budget-fitting skew, floored at 4.0 so the 2x/4x rungs survive
    and overflow stays a reported-and-retried event.

    `hbm_bytes` is the shard's device's (`DeviceInfo.hbm_bytes`).  A device
    with no known budget (0: the CPU, where JAX assumes 8 GiB) returns None,
    the drop-proof ladder, which is what JAX gives at every test size."""
    if hbm_bytes <= 0:
        return None
    budget = _HBM_BUDGET_FRACTION * hbm_bytes
    mean = max(1, n // (n_dev * n_dev))
    bytes_per_skew = _EXCHANGE_LIVE_COPIES * num_ops * 4 * n_dev * mean
    skew = budget / bytes_per_skew
    if skew >= n_dev:  # full-shard top (skew == n_dev) fits the budget
        return None
    return max(4.0, skew)


def _cap_ladder(n: int, n_dev: int,
                max_skew: float | None = None) -> tuple[int, ...]:
    """Static per-cell capacities: 2x/4x the mean cell, then the shard
    bound (never-drop), all multiples of 128.  `max_skew` truncates the
    ladder at max_skew x the mean cell."""
    mean = max(1, n // (n_dev * n_dev))
    r128 = lambda v: max(128, -(-v // 128) * 128)
    top = n // n_dev
    if max_skew is not None and math.isfinite(max_skew):
        top = min(top, int(max_skew * mean))
    caps = sorted({c for c in (r128(2 * mean), r128(4 * mean), r128(top))
                   if c <= r128(top)})
    return tuple(caps)


def _check_shards(keys, values, group):
    """Raise unless every rank holds a non-empty 1-D shard of one length
    (one all_gather of the lengths); returns n_local."""
    if keys.ndim != 1:
        raise ValueError(f"keys must be 1-D, got shape {tuple(keys.shape)}")
    if values is not None and (values.shape != keys.shape
                               or values.device != keys.device):
        raise ValueError(f"values {tuple(values.shape)} on {values.device} "
                         f"do not match keys {tuple(keys.shape)} on "
                         f"{keys.device}")
    mine = torch.tensor([keys.shape[0]], dtype=torch.int64,
                        device=keys.device)
    lens = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(lens, mine, group=group)
    lens = [int(x) for x in lens]
    if sum(lens) == 0:
        raise ValueError("distributed_sort requires a non-empty array "
                         "(single-device gstt.sort handles n=0)")
    if len(set(lens)) != 1:
        raise ValueError(f"distributed_sort needs shards of one length, got "
                         f"{lens}")
    return lens[0]


def distributed_sort(keys: torch.Tensor, values: torch.Tensor | None = None,
                     group=None, oversample: int = 32,
                     cap_elems: int | None = None,
                     exchange_chunks: int = _EXCHANGE_CHUNKS,
                     max_skew: float | None = None,
                     exchange: str = "collective"):
    """Sort a key (and optional 32-bit payload) array sharded over the
    ranks of `group` (all ranks by default).  Every rank calls it with its
    shard of n / D elements, shard r holding global positions r*n/D ..

    With `cap_elems=None` the per-(src, dst) cell capacity is the smallest
    ladder rung that holds every cell, so dropped elements are impossible
    unless `max_skew` truncates the ladder; an integer `cap_elems` (rounded
    up to a multiple of 128) forces one capacity and reports `overflow`
    instead (see distributed_sort_gather for the retry discipline).  With
    `max_skew=None` the skew is derived from the device's memory
    (_default_max_skew); `max_skew=float("inf")` forces the unbounded
    drop-proof ladder.  `exchange` is "collective" (chunked all-to-all) or
    "remote_dma" (the ring of point-to-point rounds).

    Returns this rank's dict: "codes", "global_index" and "payload_bits"
    (None without a payload) as (D * cap,) uint32 blocks, sorted and padded
    with 0xFFFFFFFF (payload 0) past "count" valid elements; "count" and
    "overflow" (the global number of dropped elements) as 0-d int64
    tensors; "cap" the top rung, "key_type" and the global "n"."""
    if exchange not in ("collective", "remote_dma"):
        raise ValueError(f"unknown exchange {exchange!r}")
    if exchange_chunks < 1:
        raise ValueError(f"exchange_chunks={exchange_chunks} must be >= 1")
    if group is None:
        group = make_mesh()
    n_dev = dist.get_world_size(group)
    rank = dist.get_rank(group)
    dev = keys.device
    remote_exchange.require_transport(group, dev, exchange)
    kt = codec.key_type_of(keys)
    pbits = None if values is None else codec.payload_to_bits(values)
    if pbits is not None and pbits.dtype != torch.int32:
        raise TypeError(f"distributed_sort takes 32-bit payloads, got "
                        f"{values.dtype}")
    n_local = _check_shards(keys, values, group)
    n = n_local * n_dev
    if n >= 1 << 32:
        raise ValueError(f"n={n} exceeds the u32 global index")
    num_ops = 2 if pbits is None else 3

    codes = codec.encode_biased(keys)
    spl_c, spl_g = _sample_splitters(codes, rank, n_dev, oversample, group)
    if cap_elems is None:
        if max_skew is None:
            max_skew = _default_max_skew(n, n_dev, num_ops,
                                         get_device_info(dev).hbm_bytes)
        caps = _cap_ladder(n, n_dev, max_skew)
    else:
        caps = (max(128, -(-int(cap_elems) // 128) * 128),)
    pad_to = n_dev * caps[-1]

    gidx = _gidx(rank * n_local, n_local, dev)
    # 1) cell counts BEFORE the sort, so the rung's collective is posted
    # ahead of it
    counts = _cell_counts(codes, gidx, spl_c, spl_g, n_dev)
    if len(caps) > 1:
        cell_max = counts.max().to(torch.int64).view(1)
        work = dist.all_reduce(cell_max, op=dist.ReduceOp.MAX, group=group,
                               async_op=True)
    # 2) local stable shard sort
    sorted_ops = _local_sort(codes, gidx, pbits)
    del gidx
    # 3) the smallest rung that holds every cell, read once on the host
    cap = caps[0]
    if len(caps) > 1:
        work.wait()
        top = int(cell_max)
        cap = caps[sum(top > c for c in caps[:-1])]
    out, count, overflow = _exchange_and_merge(
        sorted_ops, counts, cap, group, pad_to, exchange_chunks, exchange)
    return {
        "codes": codec.unbias(out[0]),
        "global_index": out[1].view(torch.uint32),
        "payload_bits": out[2].view(torch.uint32) if pbits is not None
        else None,
        "count": count,
        "overflow": overflow,
        "cap": caps[-1],
        "key_type": kt,
        "n": n,
    }


def distributed_sort_gather(keys, values=None, group=None, **kw):
    """Run distributed_sort and materialize the dense global result on
    every rank: (keys, overflow) or ((keys, values), overflow).

    Never returns dropped data: if a fixed `cap_elems` overflows, the cap
    is doubled and the sort re-run (up to 4 times, then the unbounded
    ladder, which cannot drop)."""
    if group is None:
        group = make_mesh()
    attempts = 0
    while True:
        res = distributed_sort(keys, values, group=group, **kw)
        overflow = int(res["overflow"])
        if overflow == 0:
            break
        attempts += 1
        cap = kw.get("cap_elems")
        if cap is None or attempts > 4:
            # the unbounded ladder: its full-shard top rung cannot overflow
            # (max_skew=inf also disables the memory-derived truncation)
            kw["cap_elems"] = None
            kw["max_skew"] = float("inf")
        else:
            kw["cap_elems"] = 2 * cap
    n_dev = dist.get_world_size(group)
    count = res["count"].view(1)
    counts = [torch.empty_like(count) for _ in range(n_dev)]
    dist.all_gather(counts, count, group=group)
    counts = [int(c) for c in counts]

    def dense(block: torch.Tensor) -> torch.Tensor:
        blocks = [torch.empty_like(block) for _ in range(n_dev)]
        dist.all_gather(blocks, block, group=group)
        return torch.cat([b[:c] for b, c in zip(blocks, counts)])

    out_k = codec.decode_keys(dense(res["codes"].view(torch.int32))
                              .view(torch.uint32), res["key_type"])
    if values is None:
        return out_k, overflow
    out_v = codec.bits_to_payload(
        dense(res["payload_bits"].view(torch.int32)), values.dtype)
    return (out_k, out_v), overflow
