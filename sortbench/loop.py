"""One run of one cell: the pool, the warm-up, the closed loop, the check.

The loop has one caller.  Each call takes the next input of the pool
(cycled), calls the program's entry, then `torch.cuda.synchronize()`.  A
call's latency is read from a pair of CUDA events recorded on the stream
just before the call and just after it returns: the stream is empty when
the call starts, so the pair spans the host's time in the call and the
device's work, which a host clock cannot time to better than about half
a millisecond.  The throughput is the keys of every completed call over
the window's seconds on the host clock.

Outputs are judged after the window closes: the calls that first start
after each of `checked_calls` instants drawn from the seed, and the last
call, keep their outputs; the reference (reference.py) recomputes each
from the benchmark's own input.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import math
import sys
import time
import traceback

import numpy as np
import torch

from . import card, entries, inputs, reference, spec, trace

# traced runs: the profiler records this many seconds of calls, and no
# fewer or more calls than these
TRACE_SECONDS = 3.0
TRACE_CALLS = (20, 2000)


def sample_instants(seed: int, k: int, seconds: float) -> list[float]:
    rng = np.random.default_rng(seed % (1 << 64))
    return sorted(float(u) * seconds for u in rng.random(k))


def _nullspan(_name):
    return contextlib.nullcontext()


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float, call=None) -> dict:
    """The result line's fields for one run; `call` replaces the program's
    entry (the control, or a fault in a test)."""
    cuda = device.type == "cuda"
    cfg, traffic = cell.config, cell.traffic
    if call is None:
        import gpusorting_tpu_torch as gstt      # the system under test
        call = entries.make_call(gstt, cfg, traffic)
    pool = inputs.make_pool(cfg, traffic, seed, device)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    # warm-up: every input of the pool once, up to checked_calls + 1
    # outputs held at once, as the window holds them, so the allocator
    # has cached their blocks before it starts
    k = int(traffic["checked_calls"])
    held = []
    t0 = time.perf_counter()
    for x in pool:
        held.append(call(x))
        held = held[-(k + 1):]
        sync()
    per_call = max((time.perf_counter() - t0) / len(pool), 1e-6)
    del held

    prof, span, warm = None, _nullspan, 3
    if traced:
        active = min(max(math.ceil(min(TRACE_SECONDS, seconds / 3)
                                   / per_call), TRACE_CALLS[0]),
                     TRACE_CALLS[1])
        prof = trace.profiler(warm, active)
        span = torch.profiler.record_function

    before = card.sample() if cuda else None
    instants = sample_instants(seed, k, seconds)
    kept, lat_ms = {}, []
    failed = ok_keys = 0
    ev0 = torch.cuda.Event(enable_timing=True) if cuda else None
    ev1 = torch.cuda.Event(enable_timing=True) if cuda else None
    gc.collect()
    gc.disable()
    setup_s = time.perf_counter() - t_start
    i = si = 0
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        t = time.perf_counter()
        if i and t >= deadline:
            break
        with span("next_input"):
            x = pool[i % len(pool)]
        with span("call"):
            if cuda:
                ev0.record()
            try:
                out = call(x)
            except RuntimeError:
                if not failed:
                    traceback.print_exc(file=sys.stderr)
                failed += 1
                out = None
            if cuda:
                ev1.record()
        with span("sync"):
            sync()
        lat_ms.append(ev0.elapsed_time(ev1) if cuda
                      else (time.perf_counter() - t) * 1e3)
        if out is not None:
            ok_keys += x.n
        while si < len(instants) and t - start >= instants[si]:
            si += 1
            if out is not None:
                kept[i] = out
        if prof is not None:
            prof.step()
        i += 1
    end = time.perf_counter()
    gc.enable()
    if out is not None:
        kept[i - 1] = out
    del out
    calls = i
    after = card.sample() if cuda else None
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    result = {"attempted": calls}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    metrics = {}
    window = None
    if prof is not None:
        prof.stop()
        events = trace.events_of(prof)
        del prof
        work = spec.work_module(cfg)
        rec = [pool[j % len(pool)]
               for j in range(warm, min(calls, warm + active))]
        window = trace.reduce(
            events,
            bytes_moved=sum(work.bytes_per_call(traffic["mode"], x.n,
                                                x.seg_count) for x in rec),
            keys=sum(x.n for x in rec),
            peak_bytes_per_s=card.PEAK_BYTES_PER_S.get(dev["kind"]))
        if cuda:
            dev["busy_s"] = window.busy_s
            dev["window_s"] = window.wall_s
            for m in cell.per_layer:
                v = spec.metric_reader(m["name"]).read(window)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            result["breakdown"] = {"device_ops": window.device_ops,
                                   "idle_gaps": window.idle_gaps}
    elif cuda:
        measured = {
            "keys_per_s": ok_keys / (end - start),
            "sort_ms_p95": float(np.sort(lat_ms)[
                max(0, math.ceil(0.95 * len(lat_ms)) - 1)]),
            "setup_s": setup_s,
        }
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": measured[m["name"]],
                                  "unit": m["unit"]}

    # the check, once the window has closed and its peak is read: each
    # kept call's input and outputs copied to the host, then judged in
    # threads of their own (numpy's sorts and gathers release the GIL)
    descending = cfg["order"] == "descending"
    jobs = [(entries.host_input(pool[j % len(pool)], cfg),
             entries.host_outputs(out)) for j, out in sorted(kept.items())]
    kept.clear()

    def judge(job):
        hin, got = job
        return reference.judge(got, hin, reference.expected(
            hin, traffic["mode"], descending))

    with concurrent.futures.ThreadPoolExecutor(max(1, len(jobs))) as ex:
        judged = list(ex.map(judge, jobs))
    del jobs
    counts = {"calls_checked": len(judged), "failed_calls": failed}
    for wrong in judged:
        for name, v in wrong.items():
            counts[name] = counts.get(name, 0) + v
    wrong_calls = sum(any(w.values()) for w in judged)
    correct, checks = reference.verdict(counts)
    result.update(correct=correct, failed=failed + wrong_calls,
                  metrics=metrics, device=dev)
    result["card"] = {"before": before, "after": after}
    result["run"] = {"seed": seed, "window_s": end - start, "calls": calls,
                     "setup_s": setup_s}
    if window is not None:
        result["run"]["traced_calls"] = window.calls
        result["run"]["traced_keys_per_s"] = (
            window.keys / window.wall_s if window.wall_s else None)
    result["checks"] = checks
    return result
