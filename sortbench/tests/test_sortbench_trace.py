"""The program's spans in a traced window (sortbench/program_spans.py) and
the three metrics that read them, on synthetic Chrome traces."""

import dataclasses

import pytest

from sortbench import program_spans, spec, trace

NEW = ("dispatch_host_ms", "host_syncs_per_call", "dispatch_idle_pct")


def _events(program=(), sync=True):
    """test_trace_reduction's two calls, and `program`'s spans: in the
    first call the route choice [3, 7) and the flat engine [8, 55) around
    `aten::sort`; in the second the route choice [102.2, 110) with the
    window plan [102.3, 109) in it, and a readback [112, 113)."""
    ev = []

    def x(cat, name, ts, dur):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur})
    for base in (0.0, 100.0):
        x("user_annotation", "next_input", base, 2)
        x("user_annotation", "call", base + 2, 58)
        x("cpu_op", "aten::sort", base + 10, 40)
        x("cpu_op", "aten::empty", base + 12, 1)
        x("user_annotation", "sync", base + 60, 40)
        x("kernel", "k_sort<int>", base + 30, 50)
        x("gpu_memset", "Memset (Device)", base + 25, 5)
    x("kernel", "outside", 500.0, 10)
    for name, ts, dur in program:
        if sync or ".sync." not in name:
            x("user_annotation", name, ts, dur)
    return ev


PROGRAM = [("gst.dispatch.route", 3.0, 4.0),
           ("gst.engine.flat", 8.0, 47.0),
           ("gst.dispatch.route", 102.2, 7.8),
           ("gst.dispatch.window_plan", 102.3, 6.7),
           ("gst.sync.offsets", 112.0, 1.0),
           ("gst.engine.flat", 600.0, 5.0)]        # after the window


def _reduce(events):
    return trace.reduce(events, bytes_moved=2 * 8 * 1000, keys=2000,
                        peak_bytes_per_s=1e9)


def _read_all(events, window):
    """The new metrics as the loop reads them: `window` beside `events` in
    the caller's frame."""
    return {m: spec.metric_reader(m).read(window) for m in NEW}


def test_program_spans_leave_the_window_as_it_was():
    plain = _reduce(_events())
    marked = _reduce(_events(PROGRAM))
    assert dataclasses.asdict(marked) == dataclasses.asdict(plain)
    assert program_spans.reduce(_events()) is None


def test_labels_breakdown_and_metrics():
    events = _events(PROGRAM)
    window = _reduce(events)
    sp = program_spans.reduce(events)
    assert sp.calls == 2
    gaps = dict(sp.idle_gaps)
    # [0, 25) in the flat engine's aten::sort; [80, 125) inside the window
    # plan (its middle 102.5); [180, 200) in the second sync, as before
    assert gaps == pytest.approx({"call/gst.engine.flat/aten::sort": 25e-6,
                                  "call/gst.dispatch.window_plan": 45e-6,
                                  "sync": 20e-6})
    spans = {n: (ms, c) for n, ms, c in sp.program_spans}
    assert spans["gst.engine.flat"] == pytest.approx((47e-3 / 2, 0.5))
    assert spans["gst.dispatch.route"] == pytest.approx((11.8e-3 / 2, 1.0))
    assert spans["gst.sync.offsets"] == pytest.approx((1e-3 / 2, 0.5))
    assert [n for n, *_ in sp.program_spans][0] == "gst.engine.flat"
    got = _read_all(events, window)
    # outermost dispatch spans only: the window plan is inside a route
    assert got["dispatch_host_ms"] == pytest.approx(11.8e-3 / 2)
    assert got["host_syncs_per_call"] == pytest.approx(0.5)
    # the idle time the dispatch spans overlap: all of [3, 7) (in the gap
    # [0, 25), whose middle 12.5 lies outside it) and [102.2, 110), over
    # the 200 us window
    assert got["dispatch_idle_pct"] == pytest.approx(11.8 / 200 * 100)


def test_no_sync_reads_zero_and_no_program_reads_nothing():
    events = _events(PROGRAM, sync=False)
    window = _reduce(events)
    assert _read_all(events, window)["host_syncs_per_call"] == 0.0
    events = _events()
    window = _reduce(events)
    assert _read_all(events, window) == dict.fromkeys(NEW)
    # the existing metrics read as test_trace_reduction has them
    assert spec.metric_reader("device_idle_pct").read(window) == \
        pytest.approx(45.0)


def test_a_window_without_its_events_reads_nothing():
    window = _reduce(_events(PROGRAM))
    assert all(spec.metric_reader(m).read(window) is None for m in NEW)


def test_a_dispatch_span_over_busy_time_leaves_no_idle():
    # a route choice wholly inside the first call's kernel [30, 80)
    events = _events([("gst.dispatch.route", 40.0, 10.0)])
    window = _reduce(events)
    got = _read_all(events, window)
    assert got["dispatch_idle_pct"] == 0.0
    assert got["dispatch_host_ms"] == pytest.approx(10e-3 / 2)
    assert got["host_syncs_per_call"] == 0.0


def test_collective_pct_reads_the_union_of_nccl_operations():
    from sortbench import trace
    ev = []

    def x(cat, name, ts, dur):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur})
    x("user_annotation", "call", 0.0, 100)
    x("user_annotation", "sync", 100.0, 100)
    x("kernel", "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage)", 10, 40)
    x("kernel", "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage)", 30, 40)
    x("kernel", "mask_arrivals", 60, 20)
    x("kernel", "sort", 120, 30)
    x("kernel", "ncclDevKernel_AllGather", 250, 10)   # after the window
    w = trace.reduce(ev, 1, 1, 3.35e12)
    assert w.busy_s == pytest.approx(100e-6)     # [10, 80) and [120, 150)
    read = spec.metric_reader("collective_pct").read
    assert read(w) == pytest.approx(60.0)         # [10, 70) of 100 us
    quiet = trace.reduce([e for e in ev if "nccl" not in e["name"]], 1, 1,
                         3.35e12)
    assert read(quiet) is None
