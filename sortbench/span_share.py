"""The share of a traced window's device-busy time that the program
enqueues inside some of its own spans.

A device operation (kernel, copy, memset) belongs to a span when the host
call that launched it, the CUDA runtime or driver event of the Chrome
trace that carries the same `correlation`, starts inside one of the
span's intervals on the host.  The share is the union of those
operations' intervals, clipped to the window that `trace.reduce` bounds
(the benchmark's own spans), over the window's busy time, in %.  It is
None where no such span lies in the window (a program that marks none)
or the window has no busy time.

A metric's `read(window)` receives the reduced Window alone; the trace's
events are found beside it as program_spans finds them.
"""

from __future__ import annotations

import bisect

from sortbench import program_spans, trace

_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def busy_share(events: list[dict], names, busy_s: float) -> float | None:
    """The share, in %, of `busy_s` seconds taken by device operations
    launched inside the `names` spans of Chrome trace `events` (times in
    microseconds)."""
    bench, marked, launched, device = [], [], {}, []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        cat, name = e.get("cat", ""), e.get("name", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation":
            if name in trace.SPANS:
                bench.append((s, s + d))
            elif name in names:
                marked.append((s, s + d))
        elif cat in _LAUNCH_CATS and corr is not None:
            launched[corr] = s
        elif cat in trace._DEVICE_CATS:
            device.append((s, s + d, corr))
    if not bench or busy_s <= 0:
        return None
    w0 = min(s for s, _ in bench)
    w1 = max(e for _, e in bench)
    marked = trace._merge([iv for iv in marked if w0 <= iv[0] and iv[1] <= w1])
    if not marked:
        return None
    starts = [s for s, _ in marked]

    def inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t < marked[i][1]
    mine = trace._merge([(max(s, w0), min(e, w1)) for s, e, c in device
                         if e > w0 and s < w1 and c in launched
                         and inside(launched[c])])
    return sum(e - s for s, e in mine) / 1e6 / busy_s * 100.0


def share(window, names) -> float | None:
    """`busy_share` of the trace that `window` was reduced from, over its
    busy time; None where its events are not found."""
    events = program_spans._events_beside(window)
    if events is None:
        return None
    return busy_share(events, names, window.busy_s)
