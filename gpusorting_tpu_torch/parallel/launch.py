"""Run an SPMD function on several ranks of this host, each in its own
process with a torch.distributed process group set up.

    results = run_ranks(fn, 8, *args, timeout=120.0)

calls `fn(rank, world_size, *args)` in `world_size` spawned processes, each
a rank of one gloo process group (gloo carries CPU tensors, and CUDA
tensors for its collectives, so the ranks may share one card), and
returns their return values in rank order (`backend="nccl"`: an NCCL
group instead, rank r on card r, since NCCL takes one rank a card).
`fn`, its arguments and its results are pickled, so `fn` is a
module-level function of a module the children can import (they
re-import it from scratch: a module that imports it should import
nothing heavy at top level).  The ranks meet through a `file://` store
in a fresh temporary directory, so concurrent calls never collide on a
port.

Every wait is bounded, in two stages that the parent times apart:

  rendezvous  every rank reports when it has started and when it has
              joined the group; all must have joined within JOIN_TIMEOUT
              seconds of the spawn.  If they have not (a rank starved of
              the CPU by a loaded host, or lost before it joined), every
              rank is stopped and all are spawned once more on a fresh
              store: the rendezvous runs nothing of `fn`.  A second failed
              rendezvous raises.
  work        `timeout` seconds from the moment the last rank joined, for
              `fn` on every rank.  It is never retried: a rank that raises
              fails the call with its traceback, and one that hangs fails
              it at the deadline.

A rank whose `fn` returned leaves the group only after one barrier on
it, so no rank closes the connections of a peer still working through
them (a collective, or a new group being connected); the barrier, too,
is bounded by the group's timeout.  The group's own timeout (the
rendezvous and each collective) is the two stages' sum, so a rank
slowed by a loaded host fails no sooner than the parent's deadline
would fail it.  A rank reports how far it got with
`step(what)`; each error of `run_ranks` names every rank's last step and
when it reached it.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

JOIN_TIMEOUT = 120.0
_REPORT = None      # (queue, rank) inside a rank's process, else None


def step(what: str) -> None:
    """Report from inside `fn` that this rank has reached `what`; nothing
    outside a rank of `run_ranks`."""
    if _REPORT is not None:
        results, rank = _REPORT
        results.put(("step", rank, what, time.time()))


def _rank_main(fn, rank: int, world_size: int, init: str, timeout: float,
               threads: int, results, args, backend: str) -> None:
    global _REPORT
    _REPORT = (results, rank)
    step("started")
    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    try:
        kw = {}
        if backend == "nccl":
            kw["device_id"] = torch.device("cuda", rank)
            torch.cuda.set_device(kw["device_id"])
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout), **kw)
        step("joined")
    except Exception:   # reported to the parent, which fails the call
        results.put(("done", rank, False, traceback.format_exc()))
        return
    try:
        results.put(("done", rank, True, fn(rank, world_size, *args)))
        # A rank that leaves the group closes its connections, and a peer
        # still using one (a collective, or connecting to a new group)
        # fails on it; so every rank waits here until all have returned,
        # bounded by the group's timeout.
        dist.barrier()
    except Exception:
        # A rank whose `fn` raised skips the barrier: the parent fails the
        # call and stops every rank.  Its traceback (or a failed barrier's)
        # is flushed to the parent before its connections close, so a peer
        # that then fails on them reports after the cause.
        results.put(("done", rank, False, traceback.format_exc()))
        results.close()
        results.join_thread()
    finally:
        dist.destroy_process_group()


class _Rendezvous(Exception):
    """The ranks did not all join; the spawn may be retried once."""


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def _attempt(ctx, fn, world_size, args, timeout, join_timeout, threads,
             backend):
    """One spawn of every rank; their results in rank order."""
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, init,
                                   join_timeout + timeout, threads, results,
                                   args, backend))
                 for r in range(world_size)]
        t0 = time.time()
        for p in procs:
            p.start()
        last = {r: ("spawned", t0) for r in range(world_size)}
        joined = set()
        got = {}
        deadline = time.monotonic() + join_timeout
        dead_since = None

        def where() -> str:
            return "; ".join(f"rank {r}: {what} at {t - t0:.1f} s"
                             for r, (what, t) in sorted(last.items()))

        try:
            while len(got) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    if len(joined) < world_size:
                        raise _Rendezvous(
                            f"{world_size - len(joined)} of {world_size} "
                            f"ranks had not joined the group after "
                            f"{join_timeout} s ({where()})")
                    raise TimeoutError(
                        f"run_ranks: {world_size - len(got)} of {world_size}"
                        f" ranks still running {timeout} s after the last "
                        f"joined ({where()})")
                try:
                    msg = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    # a rank that exited has flushed what it put; give the
                    # pipe a few seconds before calling it lost
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None]
                    if not dead:
                        dead_since = None
                    elif dead_since is None:
                        dead_since = time.monotonic()
                    elif time.monotonic() - dead_since > 5.0:
                        lost = (f"rank(s) {dead} exited without a result "
                                f"({where()})")
                        if len(joined) < world_size:
                            raise _Rendezvous(lost) from None
                        raise RuntimeError(f"run_ranks: {lost}") from None
                    continue
                if msg[0] == "step":
                    _, rank, what, t = msg
                    last[rank] = (what, t)
                    if what == "joined":
                        joined.add(rank)
                        if len(joined) == world_size:
                            deadline = time.monotonic() + timeout
                    continue
                _, rank, ok, value = msg
                if not ok:
                    if rank not in joined:
                        raise _Rendezvous(f"rank {rank} failed before it "
                                          f"joined the group:\n{value}")
                    raise RuntimeError(f"run_ranks: rank {rank} failed "
                                       f"({where()}):\n{value}")
                got[rank] = value
                last[rank] = ("returned", time.time())
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            _stop(procs)
    return [got[r] for r in range(world_size)]


def run_ranks(fn, world_size: int, *args, timeout: float = 120.0,
              threads: int = 1, backend: str = "gloo") -> list:
    """`fn(rank, world_size, *args)` on `world_size` spawned ranks; their
    results in rank order.  The ranks must all join the group within
    JOIN_TIMEOUT seconds (else they are spawned once more, and then the
    call raises RuntimeError) and return within `timeout` seconds of the
    last one joining.  Raises RuntimeError if a rank fails and TimeoutError
    at the deadline, terminating every child; the error names each rank's
    last step."""
    ctx = mp.get_context("spawn")
    try:
        return _attempt(ctx, fn, world_size, args, timeout, JOIN_TIMEOUT,
                        threads, backend)
    except _Rendezvous as first:
        try:
            return _attempt(ctx, fn, world_size, args, timeout,
                            JOIN_TIMEOUT, threads, backend)
        except _Rendezvous as second:
            raise RuntimeError(f"run_ranks: the rendezvous failed twice: "
                               f"{first}; then {second}") from None
