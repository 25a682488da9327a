"""The port's spans and counters (gpusorting_tpu_torch/utils/trace.py).

With no profiler running, no call into the port enters
`torch.profiler.record_function`; under a CPU torch.profiler every route
emits its `gst.engine.*` span and its `gst.dispatch.*` spans, nested as
the module says (no dispatch span holds an engine span); `counts()` shows
one `engine.<route>` a call and `reset()` zeroes every counter; each
kernel wrapper's `fn.launches` is read by `counts()` as
`launch.<module>.<fn>`; the segmented composite counts its branch
(`composite.u32`, `composite.i64`) and its steps once a call, a 64-bit
payload its split and join, and a keys-only sort none of these.  CPU
only: the readbacks (`sync.*`) open spans only for CUDA tensors and are
checked on the card.
"""

from __future__ import annotations

import collections
import contextlib
import importlib
import pathlib
import types

import numpy as np
import pytest
import torch

import gpusorting_tpu_torch as gstt
from gpusorting_tpu_torch import ops
from gpusorting_tpu_torch.core import config
from gpusorting_tpu_torch.ops import mergesweep
from gpusorting_tpu_torch.utils import trace

N = 1 << 10

# caps that send each random-length layout to one route (CPU rows)
SMALL_CAPS = dict(window_max_keys=256, window_max_fused=256,
                  window_max_pairs=256, segsort_bulk_max=128,
                  segsort_padded_max=1024, segsort_extract_max_frac=1.0)
NO_ROUTE = dict(window_max_keys=16, window_max_fused=16, window_max_pairs=16,
                segsort_extract_max_frac=0.0)


def _keys(n=N, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2**31, 2**31, (n,), dtype=torch.int64,
                         generator=g).to(torch.int32).view(torch.uint32)


def _offsets(lens):
    return torch.from_numpy(
        np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32))


def _random_lens(total, max_len, seed):
    rng = np.random.RandomState(seed)
    lens = []
    while sum(lens) < total:
        lens.append(min(int(rng.randint(1, max_len + 1)), total - sum(lens)))
    return lens


def _bimodal_lens():
    """Many short segments and two long ones: the length-class split."""
    lens = _random_lens(N * 8 - 1900, 32, 21)
    return lens[:40] + [1100] + lens[40:] + [800]


def _classes_lens():
    rng = np.random.RandomState(7)
    lens = ([int(x) for x in rng.randint(1, 100, size=40)]
            + [300, 450, 700, 1000] + [2000])
    rng.shuffle(lens)
    return lens


def _seg(lens, strategy="auto", plan=False):
    def call():
        total = int(sum(lens))
        offs = _offsets(lens)
        keys, vals = _keys(total), torch.arange(total, dtype=torch.int32)
        p = gstt.make_segsort_plan(offs, total, len(lens)) if plan else None
        return gstt.split_sort_pairs(offs, keys, vals, len(lens), total,
                                     strategy=strategy, plan=p)
    return call


@contextlib.contextmanager
def _caps(**fields):
    if not fields:
        yield
        return
    config.set_routing_override(config.RoutingParameters(**fields))
    try:
        yield
    finally:
        config.clear_routing_override()


def _pallas(fn, variant, **kw):
    return lambda: fn(_keys(), backend=gstt.Backend.PALLAS, variant=variant,
                      tile_rows=1, **kw)


# (case, call, routing caps, AUTO forced to rangesweep, the engine span,
#  the dispatch spans and their count a call)
CASES = [
    ("sort", lambda: gstt.sort(_keys()), {}, False, "flat",
     {"dispatch.route": 1}),
    ("sort_descending", lambda: gstt.sort(
        _keys(), order=gstt.Order.DESCENDING), {}, False, "flat",
     {"dispatch.route": 1}),
    ("sort_pairs", lambda: gstt.sort_pairs(_keys(), _keys(seed=2)), {}, False,
     "flat", {"dispatch.route": 1}),
    ("argsort", lambda: gstt.argsort(_keys()), {}, False, "flat",
     {"dispatch.route": 2}),
    ("sort_pairs_wide", lambda: gstt.sort_pairs_wide(
        _keys(), _keys(seed=2), _keys(seed=3)), {}, False, "flat",
     {"dispatch.route": 1}),
    ("sort_batched", lambda: gstt.sort_batched(_keys().view(4, -1)), {},
     False, "flat", {}),
    ("sort_rangesweep", lambda: gstt.sort(_keys()), {}, True, "rangesweep",
     {"dispatch.route": 1}),
    ("sort_pairs_rangesweep", lambda: gstt.sort_pairs(_keys(), _keys(seed=2)),
     {}, True, "rangesweep", {"dispatch.route": 1}),
    ("argsort_rangesweep", lambda: gstt.argsort(_keys()), {}, True,
     "rangesweep", {"dispatch.route": 1}),
    ("pallas_radix16", _pallas(gstt.sort, "radix16"), {}, False,
     "pallas.radix16", {}),
    ("pallas_radix16_pairs", lambda: gstt.sort_pairs(
        _keys(), _keys(seed=2), backend=gstt.Backend.PALLAS,
        variant="radix16", tile_rows=1), {}, False, "pallas.radix16", {}),
    ("pallas_device_radix", _pallas(gstt.sort, "device_radix"), {}, False,
     "pallas.device_radix", {}),
    ("pallas_argsort_onesweep", _pallas(gstt.argsort, "onesweep"), {}, False,
     "pallas.onesweep", {"dispatch.route": 1}),
    ("seg_fixed", _seg([32] * 64), {}, False, "fixed", {"dispatch.route": 1}),
    ("seg_window", _seg(_random_lens(N * 4, 200, 5)), {}, False, "window",
     {"dispatch.route": 1, "dispatch.window_plan": 1}),
    ("seg_split", _seg(_bimodal_lens()), {}, False, "split",
     {"dispatch.route": 1, "dispatch.window_plan": 1}),
    ("seg_classes", _seg(_classes_lens()), SMALL_CAPS, False, "classes",
     {"dispatch.route": 1, "dispatch.window_plan": 1}),
    ("seg_packed", _seg(_random_lens(N * 4, 32, 60), strategy="packed"), {},
     False, "packed", {"dispatch.route": 1}),
    ("seg_composite", _seg(_random_lens(N * 4, 1000, 8)), NO_ROUTE, False,
     "composite", {"dispatch.route": 1, "dispatch.window_plan": 1}),
    ("seg_plan", _seg(_random_lens(N * 4, 200, 5), plan=True), {}, False,
     "window", {"dispatch.route": 1, "dispatch.window_plan": 1}),
]
IDS = [c[0] for c in CASES]


@pytest.fixture
def case(request, monkeypatch):
    name, call, caps, rangesweep, engine, dispatch = request.param
    if rangesweep:
        monkeypatch.setattr(ops, "auto_engine",
                            lambda *a, **k: "rangesweep")
    with _caps(**caps):
        yield call, engine, dispatch


def _spans(prof):
    """(name, start, end) of the profiler's `gst.` annotations."""
    return sorted((e.name[len("gst."):], e.time_range.start,
                   e.time_range.end)
                  for e in prof.events() if e.name.startswith("gst."))


@pytest.mark.parametrize("case", CASES, ids=IDS, indirect=True)
def test_no_profiler_no_record_function(case, monkeypatch):
    call, engine, dispatch = case

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    trace.reset()
    call()
    call()
    got = trace.counts()
    assert {k: v for k, v in got.items()
            if k.startswith("engine.")} == {"engine." + engine: 2}
    assert {k: v for k, v in got.items()
            if k.startswith("dispatch.")} == {
        k: 2 * v for k, v in dispatch.items()}
    trace.reset()
    assert not any(trace.counts().values())


@pytest.mark.parametrize("case", CASES, ids=IDS, indirect=True)
def test_spans_under_the_profiler(case):
    call, engine, dispatch = case
    call()                       # any first-call work outside the trace
    trace.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
    spans = _spans(prof)
    names = [s[0] for s in spans]
    engines = [n for n in names if n.startswith("engine.")]
    assert engines == ["engine." + engine]
    assert {n: names.count(n) for n in names
            if n.startswith("dispatch.")} == dispatch
    assert not [n for n in names if n.startswith("sync.")]   # CPU tensors
    # the profiler's spans are the ones the counters counted
    assert collections.Counter(names) == {
        k: v for k, v in trace.counts().items()
        if v and not k.startswith("launch.")}
    engine_spans = [s for s in spans if s[0].startswith("engine.")]
    for name, s, e in spans:
        if name.startswith("dispatch."):
            assert not any(s <= es and ee <= e
                           for _, es, ee in engine_spans), (
                f"{name} holds an engine span")
    if "dispatch.window_plan" in dispatch:
        (_, rs, re_), = [s for s in spans if s[0] == "dispatch.route"]
        (_, ws, we), = [s for s in spans if s[0] == "dispatch.window_plan"]
        assert rs <= ws and we <= re_


def test_a_span_counts_and_marks_only_under_a_profiler():
    trace.reset()
    with trace.span("dispatch.test") as inner:
        assert inner is None
    assert trace.counts()["dispatch.test"] == 1
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace.span("engine.test"):
            torch.zeros(4).add_(1)
    assert [s[0] for s in _spans(prof)] == ["engine.test"]
    assert trace.counts()["engine.test"] == 1
    trace.reset()
    assert "dispatch.test" not in trace.counts()


def test_a_readback_is_a_sync_span_only_on_a_card():
    trace.reset()
    with trace.readback("offsets", torch.zeros(3)):
        pass
    assert "sync.offsets" not in trace.counts()
    with trace.readback("offsets", types.SimpleNamespace(is_cuda=True)):
        pass
    assert trace.counts()["sync.offsets"] == 1
    trace.reset()


def test_a_build_counts_only_when_nvcc_runs(tmp_path, monkeypatch):
    from gpusorting_tpu_torch.ops import _nvcc

    source = tmp_path / "probe_kernel.cu"
    source.write_text("// a kernel\n")
    monkeypatch.setattr(_nvcc, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_nvcc, "_nvcc", lambda: "nvcc")

    def fake_nvcc(cmd, **kw):
        pathlib.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return types.SimpleNamespace(returncode=0, stderr="")
    monkeypatch.setattr(_nvcc.subprocess, "run", fake_nvcc)
    trace.reset()
    _nvcc.build(source)
    _nvcc.build(source)            # the library exists: no nvcc, no count
    assert trace.counts()["build.probe_kernel"] == 1
    trace.reset()


# ---- the segmented composite's branch and steps, the 64-bit payload -------

COMPOSITE_STEPS = ("composite.build", "composite.sort", "composite.gather")


def _wide_seg(bits_to_sort, values=True):
    """A composite-routed (under NO_ROUTE) segmented sort of keys masked to
    `bits_to_sort` bits with a 64-bit index payload, or keys only."""
    lens = _random_lens(N * 4, 1000, 8)
    total = sum(lens)
    offs = _offsets(lens)
    keys = (_keys(total).view(torch.int32)
            & ((1 << bits_to_sort) - 1)).view(torch.uint32)
    vals = torch.arange(total, dtype=torch.int64).view(torch.uint64)
    return lambda: gstt.split_sort_pairs(
        offs, keys, vals if values else None, len(lens), total,
        bits_to_sort=bits_to_sort)


def _marked(counts):
    return {k: v for k, v in counts.items()
            if v and k.startswith(("composite.", "payload."))}


@pytest.mark.parametrize("bits,branch", [(16, "u32"), (32, "i64")])
def test_the_composite_counts_its_branch_and_steps_once_a_call(bits, branch):
    call = _wide_seg(bits)
    with _caps(**NO_ROUTE):
        trace.reset()
        call()
        assert _marked(trace.counts()) == {
            "composite." + branch: 1, "payload.split": 1, "payload.join": 1,
            **dict.fromkeys(COMPOSITE_STEPS, 1)}
        call()
        assert set(_marked(trace.counts()).values()) == {2}
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            call()
    spans = {name: (s, e) for name, s, e in _spans(prof)}
    bs, be = spans["composite." + branch]
    for step in COMPOSITE_STEPS:
        assert bs <= spans[step][0] and spans[step][1] <= be
    es, ee = spans["engine.composite"]
    assert es <= bs and be <= ee
    assert spans["payload.split"][1] <= es and ee <= spans["payload.join"][0]


def test_keys_only_sorts_move_no_payload_count():
    trace.reset()
    gstt.sort(_keys())
    gstt.sort(_keys(1 << 12), order=gstt.Order.DESCENDING)
    assert _marked(trace.counts()) == {}
    with _caps(**NO_ROUTE):
        _wide_seg(16, values=False)()
    assert _marked(trace.counts()) == {
        "composite.u32": 1, "composite.build": 1, "composite.sort": 1}
    trace.reset()


# ---- the kernels' launch counters ------------------------------------------

LAUNCH_COUNTERS = [
    ("kernels", "global_histogram"), ("kernels", "tile_histogram4"),
    ("kernels", "exclusive_scan"), ("rts", "downsweep"),
    ("rts", "downsweep_rows"), ("rts", "edge_fixup"),
    ("radix16", "binning_pass"), ("bitonic", "local_stages"),
    ("bitonic", "global_stage"), ("mergesweep", "merge_tail"),
    ("mergesweep", "hyper_stage"), ("stitch", "compact_ops"),
    ("stitch", "expand_ops"), ("relocate", "relocate"),
    ("remote_exchange", "mask_arrivals"), ("radix256", "sort"),
    ("radix256", "sort_pairs"), ("segtile", "sort"),
    ("dist_merge", "merge_runs"),
]
_PACKAGE = {"remote_exchange": "gpusorting_tpu_torch.parallel",
            "dist_merge": "gpusorting_tpu_torch.parallel",
            "segtile": "gpusorting_tpu_torch.segsort"}


def _wrapper(module, fn):
    mod = importlib.import_module(
        f"{_PACKAGE.get(module, 'gpusorting_tpu_torch.ops')}.{module}")
    return getattr(mod, fn)


def test_every_launch_counter_is_registered():
    for module, fn in LAUNCH_COUNTERS:
        _wrapper(module, fn)
    assert sorted(k for k in trace.counts() if k.startswith("launch.")) == \
        sorted(f"launch.{m}.{f}" for m, f in LAUNCH_COUNTERS)


@pytest.mark.parametrize("module,fn", LAUNCH_COUNTERS,
                         ids=[f"{m}.{f}" for m, f in LAUNCH_COUNTERS])
def test_a_launch_counter_reads_its_wrapper(module, fn):
    wrapper = _wrapper(module, fn)
    name = f"launch.{module}.{fn}"
    trace.reset()
    assert trace.counts()[name] == wrapper.launches == 0
    wrapper.launches += 3          # what three launches on a card add
    assert trace.counts()[name] == 3
    trace.reset()
    assert wrapper.launches == 0


@pytest.mark.parametrize("engine", [
    "radix16", "device_radix", "device_radix_rows", "onesweep",
    "onesweep_global_stages", "split", "rangesweep", "radix256",
    "radix256_pairs"])
def test_plain_paths_agree_with_the_counters(engine, monkeypatch):
    """The engines' plain paths on the CPU launch nothing: every launch
    counter in counts() agrees with its wrapper's `fn.launches` after a
    call that passes through its wrappers."""
    if engine == "device_radix_rows":
        monkeypatch.setenv("GST_MEGACORE", "1")
    if engine == "onesweep_global_stages":
        monkeypatch.setattr(mergesweep, "_USE_HYPER", False)
    trace.reset()
    if engine == "split":
        _seg(_bimodal_lens())()
    elif engine == "rangesweep":
        monkeypatch.setattr(ops, "auto_engine", lambda *a, **k: "rangesweep")
        gstt.sort_pairs(_keys(1 << 16), _keys(1 << 16, seed=2))
    elif engine == "radix256":
        monkeypatch.setattr(ops, "auto_engine", lambda *a, **k: "radix256")
        gstt.sort(_keys(N))
    elif engine == "radix256_pairs":
        monkeypatch.setattr(ops, "auto_engine", lambda *a, **k: "radix256")
        gstt.sort_pairs(_keys(N), _keys(N, seed=2))
    else:
        variant = engine.split("_")[0] if engine.startswith(
            "onesweep") else engine.replace("_rows", "")
        gstt.sort(_keys(1 << 16 if engine.startswith("onesweep") else N),
                  backend=gstt.Backend.PALLAS, variant=variant,
                  tile_rows=None if engine.startswith("onesweep") else 1)
    got = trace.counts()
    for module, fn in LAUNCH_COUNTERS:
        assert got[f"launch.{module}.{fn}"] == _wrapper(module, fn).launches
