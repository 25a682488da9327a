"""One rank of a cell over several cards, in a process of its own that
ranks.py spawned: it joins the group, runs each job's warm-up, window
and check (`run_rank`), and reports to the launcher through its queue.

A job's inputs are the rank's part of each pool input (inputs.py).  The
warm-up runs the pool twice; rank 0's time a call in the second pass and
the window's seconds fix the number of calls, broadcast once, so every
rank makes the same calls; the window opens after a barrier, and inside
it the ranks exchange nothing but what the program exchanges.  Once it
has closed, every rank hands rank 0 its latencies, its memory peak and,
traced, its device-busy seconds, then each kept call's valid prefix;
rank 0 regenerates the global input from the seed and judges the joined
prefixes (reference.judge_runs).
"""

from __future__ import annotations

import datetime
import gc
import math
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from . import card, entries, inputs, loop, reference, spec, trace


def _forbidden() -> list[str]:
    from sortbench.run import forbidden_modules
    return forbidden_modules()


def gather_runs(out: dict, rank: int, world: int, device: torch.device):
    """Each rank's valid prefix of one call, sent to rank 0.  On rank 0:
    (codes, values, counts, held, overflow) for reference.judge_runs; on
    the others None."""
    codes = out["codes"].view(torch.int32)
    vals = out["payload_bits"].view(torch.int32)
    count = int(out["count"])
    held = max(0, min(count, codes.shape[0], vals.shape[0]))
    meta = torch.tensor([count, held, int(out["overflow"])],
                        dtype=torch.int64, device=device)
    metas = [torch.empty_like(meta) for _ in range(world)]
    dist.all_gather(metas, meta)
    metas = [m.tolist() for m in metas]
    if rank != 0:
        ops = [dist.P2POp(dist.isend, t[:held], 0) for t in (codes, vals)]
        parts = None
    else:
        parts = [[torch.empty(m[1], dtype=torch.int32, device=device)
                  for m in metas[1:]] for _ in range(2)]
        ops = [dist.P2POp(dist.irecv, t, r + 1)
               for r in range(world - 1) for t in (parts[0][r], parts[1][r])]
    ops = [op for op in ops if op.tensor.numel()]
    for w in dist.batch_isend_irecv(ops) if ops else []:
        w.wait()
    if parts is None:
        return None
    return (torch.cat([codes[:held]] + parts[0]),
            torch.cat([vals[:held]] + parts[1]), [m[0] for m in metas],
            [m[1] for m in metas], max(m[2] for m in metas))


def _all(x: list[float], device: torch.device) -> np.ndarray:
    """(world, len(x)) float64: every rank's `x`, on every rank."""
    t = torch.tensor(x, dtype=torch.float64, device=device)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).cpu().numpy()


def run_rank(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float, rank: int, world: int,
             wrap=None, steps: dict | None = None) -> dict | None:
    """One run of a multi-rank cell on this rank; rank 0 returns the
    result line's fields.  `wrap(program, x)` replaces the program's call
    (the control, or a fault in a test); `steps` gathers the seconds from
    `t_start` at which each step of the set-up ended."""
    steps = {} if steps is None else steps
    cuda = device.type == "cuda"
    cfg, traffic = cell.config, cell.traffic
    import gpusorting_tpu_torch as gstt      # the system under test
    program = entries.make_call(gstt, cfg, traffic)
    steps["imported"] = time.perf_counter() - t_start
    call = program if wrap is None else (lambda x: wrap(program, x))
    pool = inputs.make_pool(cfg, traffic, seed, device, rank)
    steps["pool"] = time.perf_counter() - t_start

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    # warm-up: the pool twice, holding checked_calls outputs through each
    # call as the window does; the first pass builds, connects and fills
    # the allocator's cache, the second gives the time a call
    k = int(traffic["checked_calls"])
    held = []
    for _ in range(2):
        t0 = time.perf_counter()
        for x in pool:
            out = call(x)
            sync()
            held = (held + [out])[-k:] if k else []
            del out
        steps.setdefault("warm_pass_1", time.perf_counter() - t_start)
    per_call = max((time.perf_counter() - t0) / len(pool), 1e-6)
    del held
    steps["warm_pass_2"] = time.perf_counter() - t_start

    warm = 3
    active = min(max(math.ceil(min(loop.TRACE_SECONDS, seconds / 3)
                               / per_call), loop.TRACE_CALLS[0]),
                 loop.TRACE_CALLS[1])
    plan = torch.tensor([max(1, math.ceil(seconds / per_call)), active],
                        dtype=torch.int64, device=device)
    dist.broadcast(plan, 0)
    calls, active = plan.tolist()
    keep = {min(calls - 1, int(t / seconds * calls))
            for t in loop.sample_instants(seed, k, seconds)} | {calls - 1}

    prof, span = None, loop._nullspan
    if traced:
        prof = trace.profiler(warm, active)
        span = torch.profiler.record_function
    before = card.sample() if cuda and rank == 0 else None
    kept, lat_ms = {}, []
    ev0 = torch.cuda.Event(enable_timing=True) if cuda else None
    ev1 = torch.cuda.Event(enable_timing=True) if cuda else None
    gc.collect()
    gc.disable()
    dist.barrier()
    setup_s = time.perf_counter() - t_start
    start = time.perf_counter()
    for i in range(calls):
        t = time.perf_counter()
        with span("next_input"):
            x = pool[i % len(pool)]
        with span("call"):
            if cuda:
                ev0.record()
            out = call(x)
            if cuda:
                ev1.record()
        with span("sync"):
            sync()
        lat_ms.append(ev0.elapsed_time(ev1) if cuda
                      else (time.perf_counter() - t) * 1e3)
        if i in keep:
            kept[i] = out
        del out
        if prof is not None:
            prof.step()
    end = time.perf_counter()
    gc.enable()
    after = card.sample() if cuda and rank == 0 else None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    reserved = torch.cuda.max_memory_reserved(device) if cuda else 0

    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    window = None
    busy = [0.0, 0.0]
    if prof is not None:
        events, window = loop.traced_window(prof, cell, pool, warm, active,
                                            calls, kind)
        del prof
        busy = [window.busy_s, window.wall_s]
    n_local = pool[0].n
    del pool
    lat = _all(lat_ms, device).max(axis=0)
    peaks, reserved, busy_s, wall_s = _all([float(peak), float(reserved)]
                                           + busy, device).T

    # the check, once the window has closed and the peaks are read: each
    # kept call's prefixes joined on rank 0 and judged against the global
    # input, regenerated from the seed
    judged, global_keys = [], {}
    for i in sorted(kept):
        runs = gather_runs(kept.pop(i), rank, world, device)
        if rank:
            continue
        j = i % int(traffic["pool"])
        if j not in global_keys:
            global_keys = {j: inputs.make_input(
                cfg, {**traffic, "n": world * n_local},
                (seed + j) & inputs.M32, device).keys}
        judged.append(reference.judge_runs(*runs, global_keys[j],
                                           cfg["key_dtype"]))
        del runs
    del global_keys
    if rank:
        return None

    result = {"attempted": calls}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind,
           "count": world, "memory_peak_bytes": int(peaks.max())}
    metrics = {}
    if window is not None:
        if cuda:
            dev["busy_s"] = float(busy_s.mean())
            dev["window_s"] = float(wall_s.mean())
            metrics = loop.layer_metrics(cell, window, events)
            result["breakdown"] = {"device_ops": window.device_ops,
                                   "idle_gaps": window.idle_gaps}
    elif cuda:
        metrics = loop.end_to_end_metrics(cell, {
            "keys_per_s": calls * world * n_local / (end - start),
            "sort_ms_p95": loop.p95(lat),
            "setup_s": setup_s,
        })
    correct, checks, wrong_calls = reference.tally(judged, 0)
    result.update(correct=correct, failed=wrong_calls, metrics=metrics,
                  device=dev)
    result["card"] = {"before": before, "after": after}
    result["run"] = {"seed": seed, "window_s": end - start, "calls": calls,
                     "setup_s": setup_s, "setup_steps_s": steps,
                     "ranks": world,
                     "memory_peak_bytes_by_rank": [int(p) for p in peaks],
                     "memory_reserved_bytes_by_rank":
                         [int(p) for p in reserved]}
    if window is not None:
        result["run"]["traced_calls"] = window.calls
        result["run"]["busy_s_by_rank"] = [float(b) for b in busy_s]
    result["checks"] = checks
    return result


def main(rank: int, world: int, init: str, device_type: str,
         cell: spec.Cell, jobs: list, t_start: float, timeout: float,
         threads: int, results) -> None:
    """A rank's process: join the group, run every job, report."""
    steps = {"started": time.perf_counter() - t_start}
    # where the launcher is run.py, the process ran it first, from the top
    t_main = getattr(sys.modules.get("__mp_main__"), "T_START", None)
    if t_main is not None:
        steps["interpreter_up"] = t_main - t_start
    try:
        torch.set_num_threads(threads)
        kw = {}
        if device_type == "cuda":
            device = torch.device("cuda", rank)
            torch.cuda.set_device(device)
            kw["device_id"] = device
            backend = "nccl"
        else:
            device, backend = torch.device("cpu"), "gloo"
        # the launcher's deadline comes first: a rank that waits on a
        # lost peer is stopped by it, not by the group's own timeout
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout + 60), **kw)
        steps["joined"] = time.perf_counter() - t_start
        out = [run_rank(cell, seed, seconds, traced, device, t_start, rank,
                        world, wrap, dict(steps))
               for seed, seconds, traced, wrap in jobs]
        bad = _forbidden()
        dist.barrier()
        report = ("done", rank, out if rank == 0 else None, bad)
    except BaseException:   # reported to the launcher, which stops all
        report = ("error", rank, traceback.format_exc(), None)
    # the report is in the launcher's pipe before the group's teardown,
    # which may end the process (or hang, till the launcher stops it)
    results.put(report)
    results.close()
    results.join_thread()
    if dist.is_initialized():
        dist.destroy_process_group()
