"""The segmented configuration with 16 key bits and 64-bit payloads, the
flat pairs cell, the plain PyTorch oracle (plain_segsort.py) and the two
metrics of the segmented composite (span_share.py), on the CPU."""

import json
import time

import numpy as np
import pytest
import torch

from sortbench import (entries, inputs, loop, plain_segsort, reference, spec,
                       trace)

WIDE = "splitsort_u32_wide_pairs.b16_max8192_2p26"
PAIRS = "gpusort_u32.pairs_2p26"
COMPOSITE = ("composite_sort_pct", "payload_move_pct")


def _small(name, **traffic):
    cell = spec.load_cell(name)
    cell.traffic.update(traffic)
    return cell


def test_both_new_cells_load():
    wide, pairs = spec.load_cell(WIDE), spec.load_cell(PAIRS)
    assert wide.chips == pairs.chips == 1
    assert wide.config["name"] == "splitsort_u32_wide_pairs"
    assert wide.config["payload_dtype"] == "uint64"
    assert wide.traffic["key_bits"] == 16
    assert pairs.config["name"] == "gpusort_u32"
    assert pairs.traffic["mode"] == "pairs"
    assert pairs.traffic["layout"] == "flat"
    assert set(COMPOSITE) <= {m["name"] for m in wide.per_layer}
    assert not set(COMPOSITE) & {m["name"] for m in pairs.per_layer}
    assert set(COMPOSITE) <= {m["name"] for m in spec.load_cell(
        "splitsort_u32_pairs.max4096_2p26").per_layer}


@pytest.mark.parametrize("n,segs,want", [
    (1 << 26, 16400, (24 << 26) + 4 * 16400),
    (1000, 3, 24012),
])
def test_wide_pairs_move_24_bytes_a_key_and_4_a_segment(n, segs, want):
    work = spec.work_module({"name": "splitsort_u32_wide_pairs"})
    assert work.bytes_per_call("pairs", n, segs) == want


def _host(seed=2**31 + 5, n=20000, max_len=300):
    cell = _small(WIDE, n=n, max_len=max_len)
    x = inputs.make_input(cell.config, cell.traffic, seed, "cpu")
    return x, entries.host_input(x, cell.config)


def test_the_input_has_16_bit_keys_and_an_index_payload():
    x, hin = _host()
    assert x.values.dtype == torch.uint64
    assert int(hin.key_bits.max()) < 1 << 16
    assert np.array_equal(hin.values, np.arange(x.n, dtype=np.uint64))


def _fault(kind, exp, hin):
    k, v = exp["keys"].copy(), exp["values"].copy()
    n = k.shape[0]
    if kind == "unstable":          # two equal keys of a segment swap values
        seg_end = np.append(hin.starts[1:], n)
        ends = set(int(e) for e in seg_end)
        i = next(i for i in range(n - 1)
                 if k[i] == k[i + 1] and i + 1 not in ends)
        v[i], v[i + 1] = v[i + 1], v[i]
    elif kind == "payload_left":    # a value stays where its input was
        i = next(i for i in range(n) if v[i] != i)
        v[i] = np.uint64(i)
    elif kind == "key_altered":
        k[n // 3] ^= np.uint32(1)
    elif kind == "high_half":       # the payload's upper 32 bits lost
        v[n // 2] &= np.uint64(0xFFFFFFFF)
        v[n // 2] |= np.uint64(1 << 40)
    return {"keys": k, "values": v}


@pytest.mark.parametrize("kind", ["sound", "unstable", "payload_left",
                                  "key_altered", "high_half"])
def test_the_judge_reads_planted_faults(kind):
    _, hin = _host()
    exp = reference.expected(hin, "pairs")
    counts = reference.judge(_fault(kind, exp, hin), hin, exp)
    ok, _ = reference.verdict({"calls_checked": 1, **counts})
    assert ok is (kind == "sound"), counts


@pytest.mark.parametrize("block", [1 << 30, 2000, 299])
def test_plain_segsort_agrees_with_the_judges_order(block):
    x, hin = _host()
    exp = reference.expected(hin, "pairs")
    k, v = plain_segsort.sort_pairs_blocked(x.keys, x.values, x.starts,
                                            block)
    assert k.dtype == torch.uint32 and v.dtype == torch.uint64
    assert np.array_equal(entries.to_host_bits(k), exp["keys"])
    assert np.array_equal(entries.to_host_bits(v), exp["values"])


def test_blocks_hold_whole_segments():
    starts = np.array([0, 5, 7, 30, 31, 32], np.int64)
    assert plain_segsort.block_bounds(starts, 40, 8) == [0, 7, 30, 32, 40]
    assert plain_segsort.block_bounds(starts, 40, 100) == [0, 40]


@pytest.mark.parametrize("name,traffic", [
    (WIDE, {"n": 12000, "max_len": 400, "pool": 2}),
    (PAIRS, {"n": 5000, "pool": 2}),
])
def test_a_cpu_run_of_a_new_cell_is_correct_and_the_control_is_not(
        name, traffic):
    from sortbench import control
    cell = _small(name, **traffic)
    r = loop.run_cell(cell, 2**31 + 77, 0.2, False, torch.device("cpu"),
                      time.perf_counter())
    assert r["correct"] is True, r["checks"]
    json.loads(json.dumps(r))
    r = loop.run_cell(cell, 2**31 + 77, 0.2, False, torch.device("cpu"),
                      time.perf_counter(),
                      call=control.control_call(cell.config, cell.traffic))
    assert r["correct"] is False


# ---- the segmented composite's metrics on synthetic traces -----------------


def _events(spans=(), launches=()):
    """Two calls of 100 us: `call` [2, 60) and `sync` [60, 100) each.
    Device work: kernels [30, 50) and [50, 80) in the first call, [130,
    180) in the second, and a memset [25, 30), launched at 10, 12, 110 and
    8; a kernel after the window.  `spans`: (name, start, dur) marked by
    the program; `launches`: extra (launch ts, kernel start, dur)."""
    ev = []

    def x(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        ev.append(e)
    for base in (0.0, 100.0):
        x("user_annotation", "next_input", base, 2)
        x("user_annotation", "call", base + 2, 58)
        x("user_annotation", "sync", base + 60, 40)
    device = [(10.0, 30.0, 20, "kernel"), (12.0, 50.0, 30, "kernel"),
              (110.0, 130.0, 50, "kernel"), (8.0, 25.0, 5, "gpu_memset")]
    device += [(t, s, d, "kernel") for t, s, d in launches]
    for corr, (t, s, d, cat) in enumerate(device, start=1):
        x("cuda_runtime", "cudaLaunchKernel", t, 1, corr)
        x(cat, f"k{corr}", s, d, corr)
    x("kernel", "outside", 500.0, 10, 99)
    for name, ts, dur in spans:
        x("user_annotation", name, ts, dur)
    return ev


def _read(events):
    window = trace.reduce(events, bytes_moved=1, keys=1,
                          peak_bytes_per_s=1e9)
    return {m: spec.metric_reader(m).read(window) for m in COMPOSITE}


def test_kernels_count_where_their_launch_lies_inside_a_span():
    # busy: [25, 80) and [130, 180), 105 us
    got = _read(_events([("gst.composite.sort", 9.0, 2.0),      # 10 in
                         ("gst.composite.gather", 11.5, 1.0),   # 12 in
                         ("gst.payload.join", 109.0, 0.5)]))    # 110 out
    assert got["composite_sort_pct"] == pytest.approx(20 / 105 * 100)
    assert got["payload_move_pct"] == pytest.approx(30 / 105 * 100)
    got = _read(_events([("gst.payload.split", 7.0, 1.5),       # 8 in
                         ("gst.payload.join", 105.0, 10.0)]))   # 110 in
    assert got["composite_sort_pct"] is None
    assert got["payload_move_pct"] == pytest.approx(55 / 105 * 100)


def test_overlapping_work_counts_once_and_a_span_without_work_reads_0():
    got = _read(_events([("gst.composite.sort", 9.0, 4.0),
                         ("gst.composite.gather", 40.0, 5.0)],
                        launches=[(11.0, 40.0, 30)]))  # [40, 70) over both
    assert got["composite_sort_pct"] == pytest.approx(50 / 105 * 100)
    assert got["payload_move_pct"] == 0.0


def test_no_span_reads_nothing_and_spans_over_all_work_read_100():
    assert _read(_events()) == dict.fromkeys(COMPOSITE)
    # a span after the window is no span of it
    assert _read(_events([("gst.composite.sort", 600.0, 5.0)])) == \
        dict.fromkeys(COMPOSITE)
    got = _read(_events([("gst.composite.sort", 2.0, 58.0),
                         ("gst.composite.sort", 102.0, 58.0)]))
    assert got["composite_sort_pct"] == pytest.approx(100.0)


def test_a_window_without_its_events_reads_nothing():
    window = trace.reduce(_events([("gst.composite.sort", 9.0, 2.0)]), 1, 1,
                          1e9)
    assert all(spec.metric_reader(m).read(window) is None for m in COMPOSITE)
