"""The traced run's reduction: from a torch.profiler trace to a window of
calls that the per-layer metrics read.

The loop marks each call's steps with the benchmark's own spans
(`next_input`, `call`, `sync`, as `record_function` annotations).  The
profiler records a run of calls from the window's fourth on, CPU and
CUDA activity, and exports a Chrome trace; this module reads it:

  - the window: from the first recorded span's start to the last one's end
  - busy: the union of device intervals (kernels, copies, memsets) in it
  - kernels: the kernel launches in it
  - device_ops: device seconds by operation name (its first 160 characters)
  - op_intervals: every device operation in it, (start, end, name), in
    microseconds, for readers that take the union of some of them
  - idle_gaps: the seconds with no device operation, by what the host was
    doing at each gap's middle: the benchmark span, and the outermost
    torch operator running then where there was one.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile

import torch

SPANS = ("next_input", "call", "sync")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# device operations are named by the start of their (templated) names,
# enough to tell the library's kernels and functors apart
NAME_CHARS = 160


@dataclasses.dataclass
class Window:
    calls: int
    wall_s: float
    call_host_s: float       # the sum of the `call` spans
    busy_s: float
    kernels: int
    bytes: int               # the bytes the recorded calls must move
    keys: int                # the keys they sorted
    peak_bytes_per_s: float | None
    device_ops: list         # [[name, seconds], ...], largest first
    idle_gaps: list          # [[label, seconds], ...], largest first
    op_intervals: list = dataclasses.field(default_factory=list)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _outermost(intervals):
    """The intervals no other one contains, in order of start."""
    out = []
    for s, e, name in sorted(intervals):
        if out and s < out[-1][1]:
            continue
        out.append((s, e, name))
    return out


def _label(t, starts, items):
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and items[i][1] > t:
        return items[i][2]
    return None


def reduce(events: list[dict], bytes_moved: int, keys: int,
           peak_bytes_per_s: float | None, top: int = 10) -> Window:
    """A Window from Chrome trace events (times in microseconds)."""
    spans, device, ops = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "user_annotation" and name in SPANS:
            spans.append((s, s + d, name))
        elif cat in _DEVICE_CATS:
            device.append((s, s + d, name, cat))
        elif cat == "cpu_op":
            ops.append((s, s + d, name))
    calls = [sp for sp in spans if sp[2] == "call"]
    if not calls:
        return Window(0, 0.0, 0.0, 0.0, 0, bytes_moved, keys,
                      peak_bytes_per_s, [], [])
    w0 = min(sp[0] for sp in spans)
    w1 = max(sp[1] for sp in spans)
    clipped = [(max(s, w0), min(e, w1), name, cat)
               for s, e, name, cat in device if e > w0 and s < w1]
    busy = _merge([(s, e) for s, e, _, _ in clipped])
    by_op = collections.Counter()
    for s, e, name, _ in clipped:
        by_op[name[:NAME_CHARS]] += (e - s) / 1e6
    span_items = sorted(spans)
    span_starts = [sp[0] for sp in span_items]
    top_ops = _outermost(ops)
    op_starts = [o[0] for o in top_ops]
    gaps = collections.Counter()
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        span = _label(mid, span_starts, span_items) or "between_calls"
        op = _label(mid, op_starts, top_ops)
        gaps[f"{span}/{op}" if op else span] += (e - s) / 1e6
    return Window(
        calls=len(calls),
        wall_s=(w1 - w0) / 1e6,
        call_host_s=sum(e - s for s, e, _ in calls) / 1e6,
        busy_s=sum(e - s for s, e in busy) / 1e6,
        kernels=sum(1 for *_, cat in clipped if cat == "kernel"),
        bytes=bytes_moved, keys=keys, peak_bytes_per_s=peak_bytes_per_s,
        device_ops=[[n, v] for n, v in by_op.most_common(top)],
        idle_gaps=[[n, v] for n, v in gaps.most_common(top)],
        op_intervals=[(s, e, name) for s, e, name, _ in clipped])


def profiler(warmup_calls: int, active_calls: int):
    """A started CPU + CUDA profiler that records `active_calls` calls after
    `warmup_calls`; the loop calls its step() after every call."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=acts,
        schedule=torch.profiler.schedule(wait=0, warmup=warmup_calls,
                                         active=active_calls, repeat=1))
    prof.start()
    return prof


def events_of(prof) -> list[dict]:
    """The stopped profiler's Chrome trace events (written to a temporary
    file, read back and deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="sortbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
