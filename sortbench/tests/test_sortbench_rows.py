"""The sampler's per-row configuration (256 rows of 129,280 f32 logits and
their indices), the E020 keys cell, the plain per-row oracle
(plain_rows.py) and the fixed-length route's two metrics (span_share.py),
on the CPU."""

import json
import time

import numpy as np
import pytest
import torch

from sortbench import (entries, inputs, loop, plain_rows, reference, spec,
                       trace)

SAMPLER = "sampler_rows_f32.b256_v129280"
E020 = "gpusort_u32.keys_2p28_e020"
FIXED = ("fixed_sort_pct", "fixed_gather_pct")

# f32 bit patterns the f32 transform orders apart from torch.sort on floats:
# NaNs of both signs with payloads, -0.0, +0.0, +-inf, denormals of both
# signs, the extremes, and 1.0 and -1.0
SPECIALS = np.array([0x7FC00000, 0x7F800001, 0xFFC00000, 0xFF800001,
                     0x80000000, 0, 0x7F800000, 0xFF800000, 1, 0x80000001,
                     0x007FFFFF, 0x807FFFFF, 0x7F7FFFFF, 0xFF7FFFFF,
                     0x3F800000, 0xBF800000], dtype=np.uint32)


def _small(name, **traffic):
    cell = spec.load_cell(name)
    cell.traffic.update(traffic)
    return cell


def test_both_new_cells_load():
    rows, e020 = spec.load_cell(SAMPLER), spec.load_cell(E020)
    assert rows.chips == e020.chips == 1
    assert rows.config["name"] == "sampler_rows_f32"
    assert rows.config["key_dtype"] == "float32"
    assert rows.config["payload_dtype"] == "uint32"
    assert rows.config["entry"] == "split_sort"
    assert rows.config["strategy"] == "auto"
    assert rows.config["reduced"] == []
    assert rows.traffic["layout"] == "fixed_segments"
    assert rows.traffic["n"] == 256 * rows.traffic["seg_len"] == 33_095_680
    assert e020.config["name"] == "gpusort_u32"
    assert e020.traffic["mode"] == "keys"
    assert e020.traffic["entropy"] == "E020"
    assert e020.traffic["n"] == 1 << 28
    assert set(FIXED) <= {m["name"] for m in rows.per_layer}
    for name in (E020, "splitsort_u32_pairs.max4096_2p26"):
        assert not set(FIXED) & {m["name"] for m in
                                 spec.load_cell(name).per_layer}


@pytest.mark.parametrize("mode,n,rows,want", [
    ("pairs", 33_095_680, 256, 16 * 33_095_680 + 4 * 256),
    ("pairs", 4000, 4, 64016),
    ("keys", 1000, 1, 8004),
])
def test_a_row_moves_16_bytes_a_pair_and_4_a_row(mode, n, rows, want):
    work = spec.work_module({"name": "sampler_rows_f32"})
    assert work.bytes_per_call(mode, n, rows) == want


def _host(seed=2**31 + 11, seg_len=1000, rows=5):
    cell = _small(SAMPLER, seg_len=seg_len, n=seg_len * rows)
    x = inputs.make_input(cell.config, cell.traffic, seed, "cpu")
    return x, entries.host_input(x, cell.config)


def test_the_input_is_rows_of_f32_bit_patterns_and_an_index_payload():
    x, hin = _host()
    assert x.keys.dtype == torch.float32 and x.values.dtype == torch.uint32
    assert np.array_equal(x.starts, np.arange(5) * 1000)
    assert np.array_equal(hin.values, np.arange(x.n, dtype=np.uint32))


def _with_specials(hin, seed=3):
    """The input with a quarter of its keys drawn from SPECIALS and a
    quarter repeating a few draws, so rows hold NaNs, zeros and ties."""
    rng = np.random.default_rng(seed)
    bits = hin.key_bits.copy()
    n = bits.shape[0]
    pick = rng.random(n)
    bits[pick < 0.25] = rng.choice(SPECIALS, int((pick < 0.25).sum()))
    rep = pick > 0.75
    bits[rep] = rng.choice(bits[:7], int(rep.sum()))
    return reference.HostInput(key_bits=bits, key_dtype="float32",
                               values=hin.values, starts=hin.starts)


@pytest.mark.parametrize("specials", [False, True])
@pytest.mark.parametrize("block", [1 << 30, 2000, 999])
def test_plain_rows_agrees_with_the_judges_order(specials, block):
    _, hin = _host()
    if specials:
        hin = _with_specials(hin)
    exp = reference.expected(hin, "pairs")
    keys = torch.from_numpy(hin.key_bits.view(np.int32)).view(torch.float32)
    vals = torch.from_numpy(hin.values.view(np.int32)).view(torch.uint32)
    k, v = plain_rows.sort_rows_blocked(keys, vals, hin.starts, block)
    assert k.dtype == torch.float32 and v.dtype == torch.uint32
    got = entries.host_outputs({"keys": k, "values": v})
    assert np.array_equal(reference.codes(got["keys"], "float32"),
                          exp["keys"])
    assert np.array_equal(got["values"], exp["values"])


def test_plain_rows_orders_the_specials_by_their_bits():
    keys = torch.from_numpy(SPECIALS.view(np.int32)).view(torch.float32)
    idx = torch.arange(SPECIALS.shape[0], dtype=torch.int32)
    k, v = plain_rows.sort_rows(keys, idx, torch.zeros(1, dtype=torch.int64))
    got = k.view(torch.int32).numpy().view(np.uint32)
    assert list(got[:3]) == [0xFFC00000, 0xFF800001, 0xFF800000]
    assert list(got[-3:]) == [0x7F800000, 0x7F800001, 0x7FC00000]
    # -0.0 before +0.0, between the least denormals of both signs
    assert list(got[6:10]) == [0x80000001, 0x80000000, 0, 1]
    assert torch.equal(keys.view(torch.int32)[v.long()], k.view(torch.int32))


@pytest.mark.parametrize("name,traffic", [
    (SAMPLER, {"seg_len": 3000, "n": 12000, "pool": 2}),
    (E020, {"n": 5000, "pool": 2}),
])
def test_a_cpu_run_of_a_new_cell_is_correct_and_the_control_is_not(
        name, traffic):
    from sortbench import control
    cell = _small(name, **traffic)
    r = loop.run_cell(cell, 2**31 + 91, 0.2, False, torch.device("cpu"),
                      time.perf_counter())
    assert r["correct"] is True, r["checks"]
    json.loads(json.dumps(r))
    r = loop.run_cell(cell, 2**31 + 91, 0.2, False, torch.device("cpu"),
                      time.perf_counter(),
                      call=control.control_call(cell.config, cell.traffic))
    assert r["correct"] is False
    assert r["checks"]["keys_wrong"]["value"] > 0


# ---- the fixed-length route's metrics on synthetic traces ------------------


def _events(spans=()):
    """Two calls of 100 us, `call` [2, 60) and `sync` [60, 100) each;
    kernels [30, 50) and [50, 80) launched at 10 and 12, [130, 180)
    launched at 110, a memset [25, 30) launched at 8.  `spans`: (name,
    start, dur) marked by the program."""
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
    for corr, (t, s, d, cat) in enumerate(device, start=1):
        x("cuda_runtime", "cudaLaunchKernel", t, 1, corr)
        x(cat, f"k{corr}", s, d, corr)
    for name, ts, dur in spans:
        x("user_annotation", name, ts, dur)
    return ev


def _read(events):
    window = trace.reduce(events, bytes_moved=1, keys=1,
                          peak_bytes_per_s=1e9)
    return {m: spec.metric_reader(m).read(window) for m in FIXED}


def test_the_fixed_metrics_read_their_spans_shares():
    # busy: [25, 80) and [130, 180), 105 us
    got = _read(_events([("gst.fixed.sort", 7.0, 4.0),        # 8 and 10 in
                         ("gst.fixed.gather", 11.5, 1.0),     # 12 in
                         ("gst.composite.sort", 109.0, 2.0)]))
    assert got["fixed_sort_pct"] == pytest.approx(25 / 105 * 100)
    assert got["fixed_gather_pct"] == pytest.approx(30 / 105 * 100)
    got = _read(_events([("gst.fixed.sort", 105.0, 10.0)]))   # 110 in
    assert got["fixed_sort_pct"] == pytest.approx(50 / 105 * 100)
    assert got["fixed_gather_pct"] is None


def test_the_fixed_metrics_read_nothing_without_their_spans():
    assert _read(_events()) == dict.fromkeys(FIXED)
    assert _read(_events([("gst.composite.gather", 11.5, 1.0),
                          ("gst.engine.fixed", 2.0, 58.0)])) == \
        dict.fromkeys(FIXED)
    window = trace.reduce(_events([("gst.fixed.sort", 9.0, 2.0)]), 1, 1,
                          1e9)
    assert all(spec.metric_reader(m).read(window) is None for m in FIXED)
