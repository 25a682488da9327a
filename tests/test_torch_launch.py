"""gpusorting_tpu_torch/parallel/launch.py: the spawned ranks' two bounded
stages (the rendezvous, retried once on a fresh store; the work, never
retried), their results in rank order, errors that name each rank's
last step, and a teardown that closes no connection a peer still uses
(with make_mesh's subgroups).  The ranks re-import this module, which
imports nothing of JAX."""

import time

import pytest
import torch
import torch.distributed as dist

from gpusorting_tpu_torch.parallel import dist_sort, launch
from gpusorting_tpu_torch.parallel.launch import run_ranks, step


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _echo(rank, world, tag):
    step(f"echo {tag}")
    x = torch.tensor([rank + 1])
    dist.all_reduce(x)          # the group is up: a collective runs
    return rank, world, tag, int(x)


def _fail_on_one(rank, world):
    step("case before the fault")
    if rank == 1:
        raise ValueError("the fault")
    return rank


def _hang_on_zero(rank, world):
    step("case that hangs" if rank == 0 else "case that returns")
    if rank == 0:
        time.sleep(120)
    return rank


def _mesh_rounds(rank, world, rounds):
    """`rounds` times: every rank makes the subgroup of ranks 0-3, and its
    members tear it down at once; then return straight away."""
    for i in range(rounds):
        step(f"mesh round {i}")
        group = dist_sort.make_mesh(4)
        if rank < 4:
            dist.destroy_process_group(group)
        del group       # the last reference: its connections close now
    return rank


def test_results_in_rank_order():
    got = run_ranks(_echo, 3, "x", timeout=120.0)
    assert got == [(r, 3, "x", 6) for r in range(3)]


def test_failed_rank_names_every_last_step():
    with pytest.raises(RuntimeError) as err:
        run_ranks(_fail_on_one, 2, timeout=120.0)
    msg = str(err.value)
    assert "rank 1 failed" in msg and "ValueError: the fault" in msg
    assert "rank 1: case before the fault" in msg


def test_hung_rank_fails_at_the_work_deadline():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError) as err:
        run_ranks(_hang_on_zero, 2, timeout=3.0)
    msg = str(err.value)
    assert "after the last joined" in msg
    assert "rank 0: case that hangs" in msg
    assert "rank 1: returned" in msg
    assert time.monotonic() - t0 < 110       # not the sleep's 120 s


def test_rendezvous_failing_twice_raises_with_steps(monkeypatch):
    monkeypatch.setattr(launch, "JOIN_TIMEOUT", 0.001)
    with pytest.raises(RuntimeError) as err:
        run_ranks(_echo, 2, "x", timeout=60.0)
    msg = str(err.value)
    assert "rendezvous failed twice" in msg
    assert msg.count("had not joined the group") == 2
    assert "rank 0: spawned at" in msg or "rank 0: started at" in msg


def test_rendezvous_is_retried_once(monkeypatch):
    real = launch._attempt
    calls = []

    def flaky(*args):
        calls.append(args[2])
        if len(calls) == 1:
            raise launch._Rendezvous("rank 1 had not joined")
        return real(*args)

    monkeypatch.setattr(launch, "_attempt", flaky)
    assert run_ranks(_echo, 2, "y", timeout=120.0) == [
        (0, 2, "y", 3), (1, 2, "y", 3)]
    assert calls == [2, 2]


def test_work_failure_is_not_retried(monkeypatch):
    calls = []
    real = launch._attempt

    def counted(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(launch, "_attempt", counted)
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        run_ranks(_fail_on_one, 2, timeout=120.0)
    assert calls == [1]


def test_subgroup_made_and_torn_down_at_once():
    """A member that returns from make_mesh while a peer is still
    connecting to the subgroup, then tears it down (or leaves the default
    group), closes the peer's half-made connection: make_mesh waits for
    every member, and a rank leaves the default group only once every
    rank's function has returned."""
    assert run_ranks(_mesh_rounds, 8, 30, timeout=120.0) == list(range(8))


def test_step_outside_a_rank_does_nothing():
    assert launch._REPORT is None
    step("nothing")
