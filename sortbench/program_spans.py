"""The program's own spans in a traced window.

The program marks its steps (gpusorting_tpu_torch/utils/trace.py) with
`record_function("gst.<name>")` annotations while a profiler records, so
they are events of the same Chrome trace as the device activity, on one
clock.  `reduce` reads them over the window that `trace.reduce` bounds
(the benchmark's own spans), and leaves that Window as it is:

  program_spans    [[name, ms a call, count a call], ...], top 10 by time
  idle_gaps        trace.reduce's idle gaps, with the innermost program
                   span open at a gap's middle put between the benchmark
                   span and the torch operator
                   (`call/gst.dispatch.window_plan`,
                   `call/gst.engine.composite/aten::index`); where none
                   is open, trace.reduce's own label
  dispatch_s       the outermost `gst.dispatch.*` spans, summed
  syncs            the `gst.sync.*` spans (readbacks that block the host)
  dispatch_idle_s  the device-idle time that an outermost dispatch span
                   overlaps (interval intersection)

A trace with no `gst.` event (a program without spans) gives None, and so
does every metric that reads it.

A metric's `read(window)` receives the reduced Window alone.  `of(window)`
finds the trace's events in the frame of its caller that holds that
window beside them (`loop.run_cell`'s `window` and `events`), reduces
them once, and prints the two lists on standard error.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import sys
import traceback

from . import trace

PREFIX = "gst."


@dataclasses.dataclass
class Spans:
    calls: int
    wall_s: float
    program_spans: list      # [[name, ms a call, count a call], ...]
    idle_gaps: list          # [[label, seconds], ...], largest first
    dispatch_s: float
    syncs: int
    dispatch_idle_s: float


def _innermost(items):
    """t -> the name of the innermost of properly nested (start, end,
    name) intervals that holds t, or None."""
    items = sorted(items, key=lambda x: (x[0], -x[1]))
    parent, stack = [], []
    for i, (s, _, _) in enumerate(items):
        while stack and items[stack[-1]][1] <= s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    starts = [x[0] for x in items]

    def at(t):
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and items[i][1] <= t:
            i = parent[i]
        return items[i][2] if i >= 0 else None
    return at


def _overlap(a, b) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def reduce(events: list[dict], top: int = 10) -> Spans | None:
    """The program's spans over the window of Chrome trace events (times
    in microseconds); None where the trace has no program span or no
    call."""
    bench, device, ops, prog = [], [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "user_annotation" and name in trace.SPANS:
            bench.append((s, s + d, name))
        elif cat == "user_annotation" and name.startswith(PREFIX):
            prog.append((s, s + d, name))
        elif cat in trace._DEVICE_CATS:
            device.append((s, s + d))
        elif cat == "cpu_op":
            ops.append((s, s + d, name))
    calls = sum(1 for b in bench if b[2] == "call")
    if not prog or not calls:
        return None
    # the bounds, busy intervals and labels exactly as trace.reduce has them
    w0 = min(b[0] for b in bench)
    w1 = max(b[1] for b in bench)
    prog = [p for p in prog if w0 <= p[0] and p[1] <= w1]
    busy = trace._merge([(max(s, w0), min(e, w1))
                         for s, e in device if e > w0 and s < w1])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]
    span_items = sorted(bench)
    span_starts = [sp[0] for sp in span_items]
    top_ops = trace._outermost(ops)
    op_starts = [o[0] for o in top_ops]
    in_prog = _innermost(prog)
    gaps = collections.Counter()
    for s, e in idle:
        mid = (s + e) / 2
        label = [trace._label(mid, span_starts, span_items)
                 or "between_calls", in_prog(mid),
                 trace._label(mid, op_starts, top_ops)]
        gaps["/".join(x for x in label if x)] += (e - s) / 1e6
    time_by, count_by = collections.Counter(), collections.Counter()
    for s, e, name in prog:
        time_by[name] += (e - s) / 1e6
        count_by[name] += 1
    dispatch = trace._merge([(s, e) for s, e, _ in trace._outermost(
        [p for p in prog if p[2].startswith(PREFIX + "dispatch.")])])
    return Spans(
        calls=calls, wall_s=(w1 - w0) / 1e6,
        program_spans=[[n, v * 1e3 / calls, count_by[n] / calls]
                       for n, v in time_by.most_common(top)],
        idle_gaps=[[n, v] for n, v in gaps.most_common(top)],
        dispatch_s=sum(e - s for s, e in dispatch) / 1e6,
        syncs=sum(1 for p in prog if p[2].startswith(PREFIX + "sync.")),
        dispatch_idle_s=_overlap(idle, dispatch) / 1e6)


def _events_beside(window):
    f = sys._getframe(2)
    while f is not None:
        loc = f.f_locals
        if loc.get("window") is window and isinstance(loc.get("events"),
                                                      list):
            return loc["events"]
        f = f.f_back
    return None


_last: tuple = (None, None)


def of(window) -> Spans | None:
    """The program's spans of the trace that `window` was reduced from,
    or None; never raises (a fault prints its traceback)."""
    global _last
    if _last[0] is window:
        return _last[1]
    sp = None
    try:
        events = _events_beside(window)
        if events is not None:
            sp = reduce(events)
    except Exception:   # a metric reader must not cost the run its line
        traceback.print_exc(file=sys.stderr)
    _last = (window, sp)
    if sp is not None:
        print(f"sortbench: program_spans {json.dumps(sp.program_spans)}",
              file=sys.stderr)
        print(f"sortbench: idle_gaps with program spans "
              f"{json.dumps(sp.idle_gaps)}", file=sys.stderr)
    return sp
