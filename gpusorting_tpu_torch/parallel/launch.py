"""Run an SPMD function on several ranks of this host, each in its own
process with a torch.distributed process group set up.

    results = run_ranks(fn, 8, *args, timeout=120.0)

calls `fn(rank, world_size, *args)` in `world_size` spawned processes, each
a rank of one gloo process group (gloo carries CPU tensors, and CUDA
tensors for its collectives, so the ranks may share one card), and
returns their return values in rank order.  `fn`, its arguments and its
results are pickled, so `fn` is a module-level function of a module the
children can import (they re-import it from scratch: a module that imports
it should import nothing heavy at top level).  The ranks meet through a
`file://` store in a fresh temporary directory, so concurrent calls never
collide on a port.  Every wait is bounded: the group's timeout (at most
GROUP_TIMEOUT seconds for the rendezvous and for each collective), and a
deadline on the whole run after which every child is terminated and the
call raises.  A rank that raises fails the call with its traceback.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

GROUP_TIMEOUT = 60.0


def _rank_main(fn, rank: int, world_size: int, init: str, timeout: float,
               threads: int, results, args) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    try:
        dist.init_process_group(
            "gloo", init_method=init, rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=min(timeout, GROUP_TIMEOUT)))
        try:
            results.put((rank, True, fn(rank, world_size, *args)))
        finally:
            dist.destroy_process_group()
    except Exception:   # reported to the parent, which fails the call
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world_size: int, *args, timeout: float = 120.0,
              threads: int = 1) -> list:
    """`fn(rank, world_size, *args)` on `world_size` spawned ranks; their
    results in rank order.  Raises RuntimeError if a rank fails and
    TimeoutError after `timeout` seconds, terminating every child."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, init, timeout, threads,
                                   results, args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout
        dead_since = None
        try:
            while len(got) < world_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"run_ranks: {world_size - len(got)} "
                                       f"of {world_size} ranks still running "
                                       f"after {timeout} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    # a rank that exited has flushed its result; give the
                    # pipe a few seconds before calling it lost
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode is not None]
                    if not dead:
                        dead_since = None
                    elif dead_since is None:
                        dead_since = time.monotonic()
                    elif time.monotonic() - dead_since > 5.0:
                        raise RuntimeError(f"run_ranks: rank(s) {dead} exited "
                                           f"without a result") from None
                    continue
                if not ok:
                    raise RuntimeError(f"run_ranks: rank {rank} failed:\n"
                                       f"{value}")
                got[rank] = value
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join(5)
    return [got[r] for r in range(world_size)]
