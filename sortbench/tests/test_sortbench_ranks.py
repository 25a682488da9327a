"""The multi-rank harness on the CPU: four gloo ranks drive the
distributed cell's path at a small n, read `correct` true on the program,
false on the control and on every planted fault, and stop within a bound
when a rank raises, dies or hangs."""

import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest
import torch
import torch.distributed as dist

from sortbench import ranks, spec

CELL = "dist_u32_pairs.4chips"
SEED = 2**31 + 23


def _cell(n=5000, **traffic):
    cell = spec.load_cell(CELL)
    cell.traffic.update(n=n, **traffic)
    return cell


def _launch(jobs, cell=None, timeout=180.0):
    return ranks.launch(cell or _cell(), jobs, time.perf_counter(), timeout,
                        device_type="cpu", threads=1)


# planted faults: (program, x) -> the rank's dict, the timed path broken

def _bits(t):
    return t.view(torch.int32).clone()


def _as_dict(codes, values, count):
    return {"codes": codes.view(torch.uint32),
            "payload_bits": values.view(torch.uint32),
            "count": torch.tensor(count), "overflow": torch.tensor(0)}


def _swapped_across_ranks(program, x):
    """Rank 0's last valid pair and rank 1's first trade places."""
    out = program(x)
    c, v, n = _bits(out["codes"]), _bits(out["payload_bits"]), int(
        out["count"])
    ends = torch.stack([c[0], v[0], c[n - 1], v[n - 1]])
    got = [torch.empty_like(ends) for _ in range(dist.get_world_size())]
    dist.all_gather(got, ends)
    if dist.get_rank() == 0:
        c[n - 1], v[n - 1] = got[1][0], got[1][1]
    elif dist.get_rank() == 1:
        c[0], v[0] = got[0][2], got[0][3]
    return _as_dict(c, v, n)


def _dropped(program, x):
    """Rank 1 loses one element from the middle of its run."""
    out = program(x)
    c, v, n = _bits(out["codes"]), _bits(out["payload_bits"]), int(
        out["count"])
    if dist.get_rank() == 1:
        i = n // 2
        c[i:n - 1], v[i:n - 1] = c[i + 1:n].clone(), v[i + 1:n].clone()
        n -= 1
    return _as_dict(c, v, n)


def _wrong_count(program, x):
    """Rank 2 reports one element more than its run holds."""
    out = program(x)
    n = int(out["count"]) + (dist.get_rank() == 2)
    return _as_dict(_bits(out["codes"]), _bits(out["payload_bits"]), n)


def _unstable_tie(program, x):
    """Two equal keys on rank 0 out of their input order."""
    out = program(x)
    c, v, n = _bits(out["codes"]), _bits(out["payload_bits"]), int(
        out["count"])
    if dist.get_rank() == 0:
        i = int(torch.nonzero(c[:n - 1] == c[1:n])[0])
        v[i], v[i + 1] = v[i + 1].clone(), v[i].clone()
    return _as_dict(c, v, n)


def _unchanged(program, x):
    """The step returns its input as it came."""
    return _as_dict(_bits(x.keys), _bits(x.values), x.n)


def _half(program, x):
    """Half of every shard left out: the program sorts the rest."""
    h = x.n // 2
    return program(dataclasses.replace(x, keys=x.keys[:h],
                                       values=x.values[:h]))


def _no_exchange(program, x):
    """The exchange between ranks left out: each rank sorts its shard."""
    k = x.keys.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    order = torch.sort(k, stable=True).indices
    return _as_dict(x.keys.view(torch.int32)[order],
                    x.values.view(torch.int32)[order], x.n)


def _altered(program, x):
    """One key altered where it is produced, on rank 1."""
    out = program(x)
    c = _bits(out["codes"])
    if dist.get_rank() == 1:
        c[int(out["count"]) // 3] ^= 1
    return _as_dict(c, _bits(out["payload_bits"]), int(out["count"]))


FAULTS = [_swapped_across_ranks, _dropped, _wrong_count, _unstable_tie,
          _unchanged, _half, _no_exchange, _altered]


class _RaiseOn:
    """Rank `rank` raises at its `call`-th call."""

    def __init__(self, rank, call, how="raise"):
        self.rank, self.call, self.how, self.seen = rank, call, how, 0

    def __call__(self, program, x):
        self.seen += 1
        if dist.get_rank() == self.rank and self.seen == self.call:
            if self.how == "die":
                os._exit(7)
            if self.how == "hang":
                time.sleep(3600)
            raise RuntimeError("planted fault in the timed path")
        return program(x)


def _loads_jax(program, x):
    if dist.get_rank() == 1:
        sys.modules.setdefault("jax", type(sys)("jax"))
    return program(x)


@pytest.fixture(scope="module")
def faulty_runs():
    """One launch: a sound run, then every planted fault."""
    jobs = [(SEED, 0.3, False, None)]
    jobs += [(SEED + 1 + i, 0.3, False, f) for i, f in enumerate(FAULTS)]
    results, bad = _launch(jobs)
    assert bad == []
    return dict(zip([None] + FAULTS, results))


@pytest.mark.parametrize("traced", [False, True])
def test_a_gloo_run_of_the_distributed_cell_reads_correct(traced):
    (r,), bad = _launch([(SEED, 0.4, traced, None)])
    assert bad == []
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    assert r["device"] == {"platform": "cpu", "kind": "cpu", "count": 4,
                           "memory_peak_bytes": 0}
    assert r["metrics"] == {}           # no device metric from a CPU run
    checks = r["checks"]
    assert checks["calls_checked"]["value"] >= 1
    for name in ("keys_wrong", "values_wrong", "count_sum_off", "overflow",
                 "failed_calls"):
        assert checks[name] == {"value": 0, "max": 0}
    assert r["run"]["ranks"] == 4 and r["attempted"] == r["run"]["calls"]
    if traced:
        assert r["run"]["traced_calls"] >= 1
    json.loads(json.dumps(r))


def test_the_sound_run_beside_the_faults_reads_correct(faulty_runs):
    assert faulty_runs[None]["correct"] is True


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__[1:])
def test_a_broken_distributed_path_reads_incorrect(faulty_runs, fault):
    r = faulty_runs[fault]
    assert r["correct"] is False and r["failed"] >= 1
    wrong = {k: c["value"] for k, c in r["checks"].items()
             if c["value"] > c.get("max", c["value"])}
    expect = {_swapped_across_ranks: {"values_wrong", "keys_wrong"},
              _dropped: {"count_sum_off"}, _wrong_count: {"count_sum_off"},
              _unstable_tie: {"values_wrong"}, _unchanged: {"keys_wrong"},
              _half: {"count_sum_off"}, _no_exchange: {"keys_wrong"},
              _altered: {"keys_wrong"}}[fault]
    assert expect & set(wrong), r["checks"]


def test_the_distributed_control_reads_incorrect():
    from sortbench import control
    cell = _cell()
    (r,), _ = _launch([(SEED + 40, 0.3, False,
                        control.DistControl(cell.config["key_dtype"]))],
                      cell=cell)
    assert r["correct"] is False
    assert r["checks"]["keys_wrong"]["value"] > 0


@pytest.mark.parametrize("how,bound", [("raise", 60), ("die", 60),
                                       ("hang", 60)])
def test_a_failing_rank_stops_the_run(how, bound):
    t = time.perf_counter()
    with pytest.raises(ranks.RankFailure) as e:
        _launch([(SEED, 0.5, False, _RaiseOn(2, 4, how))],
                timeout=40.0 if how == "hang" else 180.0)
    assert time.perf_counter() - t < bound
    msg = str(e.value)
    assert {"raise": "planted fault in the timed path",
            "die": "exited with code(s) [7]",
            "hang": "still running"}[how] in msg


def test_a_rank_that_loads_a_forbidden_module_is_named():
    (r,), bad = _launch([(SEED, 0.2, False, _loads_jax)])
    assert r["correct"] is True
    assert bad == ["jax (rank 1)"]


def test_the_command_refuses_a_machine_without_four_cards():
    p = subprocess.run(
        [sys.executable, str(spec.HERE / "run.py"), "--workload", CELL,
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=spec.ROOT)
    assert p.returncode == 2
    assert "{" not in p.stdout
