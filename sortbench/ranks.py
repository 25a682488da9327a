"""A cell over several cards: one process a rank, spawned and watched here.

`run.py` hands a cell whose `chips` is above 1 to `Ranks`, which spawns
`chips` processes before the launcher itself imports torch, so that the
ranks' imports run beside its own.  Rank r (rank.py) runs on `cuda:r` in
one NCCL group (gloo and the CPU where `device_type` is "cpu", as the
tests run it) that meets through a `file://` store in a fresh temporary
directory.  Every rank calls `distributed_sort` on its shard the same
number of times, each call followed by `torch.cuda.synchronize()`.  Rank
0 returns the result, every rank the forbidden modules it loaded, and
the launcher prints the line.

Metrics: `keys_per_s` is every rank's keys of the calls over rank 0's
window on its host clock; `sort_ms_p95` the 95th percentile over the
calls of each call's longest event pair among the ranks; `setup_s` from
the launcher's start (the spawn included) to rank 0's window, both on
the machine's monotonic clock that `time.perf_counter` reads in every
process.  Traced, every rank profiles the same calls; the per-layer
metrics read rank 0's trace, and `device.busy_s` and `window_s` are the
ranks' mean.

Every wait is bounded.  A rank that raises, or a process that dies,
stops every rank, and `wait` raises RankFailure with that rank's
traceback; so does a run still going at its deadline.  This module
imports no torch.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time

from . import spec

# seconds a rank's process may take to exit once it has reported
EXIT_GRACE_S = 30.0


class RankFailure(RuntimeError):
    """A rank raised, died or outlived the run's deadline."""


def _entry(*args) -> None:
    """A rank's process: rank.py, imported only here."""
    from sortbench import rank
    rank.main(*args)


class Ranks:
    """`cell.chips` rank processes running `jobs` ((seed, seconds, traced,
    wrap) each), started at once; `wait` gives (rank 0's results, one a
    job; the forbidden modules any rank loaded, each named with its
    rank).  As a context manager it stops every rank on leaving."""

    def __init__(self, cell: spec.Cell, jobs: list, t_start: float,
                 timeout: float, device_type: str = "cuda",
                 threads: int = 2):
        self.world, self.timeout = cell.chips, timeout
        self.deadline = time.monotonic() + timeout
        ctx = mp.get_context("spawn")
        self._tmp = tempfile.TemporaryDirectory(prefix="sortbench_ranks_")
        init = "file://" + os.path.join(self._tmp.name, "store")
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_entry, daemon=True,
                                  args=(r, self.world, init, device_type,
                                        cell, jobs, t_start, timeout,
                                        threads, self.results))
                      for r in range(self.world)]
        for p in self.procs:
            p.start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def stop(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join(5)
        self._tmp.cleanup()

    def wait(self):
        world, procs = self.world, self.procs
        done, dead_since = {}, None
        while len(done) < world:
            left = self.deadline - time.monotonic()
            if left <= 0:
                raise RankFailure(
                    f"rank(s) {sorted(set(range(world)) - set(done))} "
                    f"still running after {self.timeout:.0f} s")
            try:
                kind, rank, value, bad = self.results.get(
                    timeout=min(left, 1.0))
            except queue.Empty:
                # a process that exited has flushed what it put; give the
                # pipe a few seconds before calling it lost
                lost = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode is not None]
                if not lost:
                    dead_since = None
                elif dead_since is None:
                    dead_since = time.monotonic()
                elif time.monotonic() - dead_since > 5.0:
                    raise RankFailure(
                        f"rank(s) {lost} exited with code(s) "
                        f"{[procs[r].exitcode for r in lost]} and no "
                        f"result") from None
                continue
            if kind == "error":
                # a peer that died first is the cause the error follows
                lost = [r for r, p in enumerate(procs)
                        if r != rank and p.exitcode not in (None, 0)]
                first = (f"rank(s) {lost} exited with code(s) "
                         f"{[procs[r].exitcode for r in lost]}; then "
                         if lost else "")
                raise RankFailure(f"{first}rank {rank} failed:\n{value}")
            done[rank] = (value, bad)
        for p in procs:
            p.join(max(1.0, min(EXIT_GRACE_S,
                                self.deadline - time.monotonic())))
        bad = sorted(f"{m} (rank {r})" for r, (_, b) in done.items()
                     for m in b)
        return done[0][0], bad


def launch(cell: spec.Cell, jobs: list, t_start: float, timeout: float,
           device_type: str = "cuda", threads: int = 2):
    """`Ranks(...).wait()`, every rank stopped after; raises RankFailure
    if a rank fails, a process dies before it reports, or `timeout`
    seconds pass."""
    with Ranks(cell, jobs, t_start, timeout, device_type, threads) as team:
        return team.wait()
