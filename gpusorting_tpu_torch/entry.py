"""Entry points of the port, twins of the JAX package's `__graft_entry__`.

    entry(device="cuda")            -> (fn, example_args): the single-card
                                       flagship step, a stable u32 pairs
                                       sort at 2^16 with fixed keys
    dryrun_multichip(n_devices, device="cuda")
                                    -> one distributed step on `n_devices`
                                       spawned ranks at tiny shapes, its
                                       five checks asserted

On the card, from the repo's root (a script on stdin cannot spawn ranks):

    python3 -c "import gpusorting_tpu_torch.entry as e; fn, a = e.entry(); fn(*a)"
    python3 -c "import gpusorting_tpu_torch.entry as e; print(e.dryrun_multichip(1))"

`device="cpu"` runs both on the host, as the tests do.
"""

from __future__ import annotations

import numpy as np
import torch

# seconds for the dry run's ranks to finish once they have joined (the
# spawned tests' deadline)
DRYRUN_TIMEOUT = 240.0
CHECKS = ("pairs_collective", "remote_dma", "all_equal", "cap128_overflow",
          "gather_retry")


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as a uint32 tensor."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32).view(torch.uint32)


def entry(device: torch.device | str = "cuda"):
    """(fn, (keys, values)): `fn(keys, values)` is `gstt.sort_pairs` on
    2^16 u32 keys `(i * 2654435769) ^ 0xDEADBEEF` (mod 2^32) with values
    `i`, made on `device`; "cuda" raises where torch sees no card."""
    import gpusorting_tpu_torch as gstt
    from gpusorting_tpu_torch.core import prng

    dev = prng.require_device(device)
    n = 1 << 16

    def step(keys, values):
        return gstt.sort_pairs(keys, values)

    i = torch.arange(n, dtype=torch.int64, device=dev)
    keys = _u32(((i * 2654435769) & 0xFFFFFFFF) ^ 0xDEADBEEF)
    values = _u32(i)
    return step, (keys, values)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _dryrun_rank(rank: int, world: int, device: str) -> dict:
    """One rank of `dryrun_multichip`: `__graft_entry__.dryrun_multichip`'s
    five checks on this rank's shard, each asserted."""
    import torch.distributed as dist

    from gpusorting_tpu_torch.core import prng
    from gpusorting_tpu_torch.parallel import dist_sort, launch
    from gpusorting_tpu_torch.parallel import remote_exchange as rx

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    group = dist_sort.make_mesh(world)
    n = 128 * world * 8
    n_local = n // world
    sl = slice(rank * n_local, (rank + 1) * n_local)

    def shard(x: torch.Tensor) -> torch.Tensor:
        # the int32 view: torch's uint32 has no indexing
        return x.view(torch.int32)[sl].view(torch.uint32)

    def total(res) -> int:
        count = res["count"].view(1).clone()
        dist.all_reduce(count, group=group)
        return int(count)

    keys = prng.make_test_keys(n, 1, device=dev)
    values = _u32(torch.arange(n, dtype=torch.int64, device=dev))
    ran, refused = [], {}

    launch.step("pairs_collective")
    res = dist_sort.distributed_sort(shard(keys), shard(values), group)
    got = total(res)
    _check(got == n, f"distributed sort dropped elements: {got} != {n}")
    ran.append("pairs_collective")

    # the remote-DMA exchange (the ring of point-to-point rounds) at a
    # fixed cap, one kernel shape; a group that cannot carry it is named
    launch.step("remote_dma")
    try:
        rx.require_transport(group, dev, "remote_dma")
    except ValueError as e:
        refused["remote_dma"] = str(e)
    else:
        res = dist_sort.distributed_sort(
            shard(keys), shard(values), group, cap_elems=n // world,
            exchange="remote_dma")
        got = total(res)
        _check(got == n, f"remote-DMA exchange dropped elements: {got} != "
               f"{n}")
        ran.append("remote_dma")

    # skew stress: all-equal keys put every element in one splitter bucket
    launch.step("all_equal")
    eq = _u32(torch.full((n,), 0xABCD1234, dtype=torch.int64, device=dev))
    res = dist_sort.distributed_sort(shard(eq), group=group)
    got = total(res)
    _check(got == n, f"all-equal skew dropped elements: {got} != {n}")
    ran.append("all_equal")

    # a tiny fixed cap on a skewed input must report its overflow, and
    # distributed_sort_gather's doubling retry must still return the exact
    # sorted multiset
    launch.step("cap128_overflow")
    skew = torch.cat([torch.zeros(n // 2, dtype=torch.int32, device=dev),
                      prng.make_test_keys(n - n // 2, 7, device=dev).view(
                          torch.int32)]).view(torch.uint32)
    res = dist_sort.distributed_sort(shard(skew), group=group, cap_elems=128)
    _check(int(res["overflow"]) > 0,
           "tiny fixed cap on skewed input did not report overflow")
    ran.append("cap128_overflow")

    launch.step("gather_retry")
    out, overflow = dist_sort.distributed_sort_gather(
        shard(skew), group=group, cap_elems=128)
    _check(overflow == 0, "retry ladder ended with unresolved overflow")
    got = out.view(torch.int32).cpu().numpy().view(np.uint32)
    want = np.sort(skew.view(torch.int32).cpu().numpy().view(np.uint32),
                   kind="stable")
    _check(got.shape == want.shape and bool((got == want).all()),
           "overflow-retry result is not the exact sorted multiset")
    ran.append("gather_retry")
    return {"checks": ran, "refused": refused,
            "backend": str(dist.get_backend(group))}


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda"
                     ) -> dict:
    """One distributed sort step on `n_devices` ranks spawned by
    `parallel/launch.run_ranks`, at the JAX dry run's shapes (n = 128 *
    n_devices * 8), with its five checks asserted on every rank: pairs
    over the collective exchange; the remote_dma exchange at `cap_elems =
    n // n_devices`; all-equal keys; a cap of 128 on half-zero keys, which
    must report overflow; and `distributed_sort_gather`'s retry, which must
    give numpy's stable sort exactly.

    On CUDA the ranks form an NCCL group, one card each, where the host
    has a card for every rank; otherwise a gloo group sharing the cards,
    which cannot carry remote_dma's CUDA tensors, so that check is named
    under "refused" with the reason.  On the CPU the group is gloo.

    Returns {"n_devices", "n", "device", "backend", "checks" (the checks
    that ran, in order), "refused" (check -> reason)}; raises where a
    check fails or a rank does not finish within DRYRUN_TIMEOUT seconds."""
    from gpusorting_tpu_torch.core import prng
    from gpusorting_tpu_torch.parallel.launch import run_ranks

    dev = prng.require_device(device)
    backend = "gloo"
    if dev.type == "cuda" and n_devices <= torch.cuda.device_count():
        backend = "nccl"
    res = run_ranks(_dryrun_rank, n_devices, dev.type,
                    timeout=DRYRUN_TIMEOUT, backend=backend)
    _check(all(r == res[0] for r in res),
           f"the ranks disagree on the checks: {res}")
    return {"n_devices": n_devices, "n": 128 * n_devices * 8,
            "device": dev.type, "backend": res[0]["backend"],
            "checks": res[0]["checks"], "refused": res[0]["refused"]}
