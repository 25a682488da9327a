"""A run of the harness on the CPU at tiny sizes: the line it prints, the
faults it must catch, the machine it must refuse, and the modules it must
never load."""

import json
import subprocess
import sys
import time

import pytest
import torch

from sortbench import loop, reference, run, spec, trace

# every traffic file, cut to a size a test holds
CELLS = {
    "gpusort_u32.keys_2p28": {"n": 4000, "pool": 2},
    "gpusort_u32.keys_2p20": {"n": 3000, "pool": 3},
    "splitsort_u32_pairs.max4096_2p26": {"n": 12000, "pool": 2},
    "splitsort_u32_pairs.max32_2p26": {"n": 5000, "pool": 2},
}
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _cell(name):
    config, traffic = name.split(".")
    cell = spec.Cell(
        name=name, chips=1,
        config=json.loads((spec.HERE / "configs" / f"{config}.json")
                          .read_text()),
        traffic=json.loads((spec.HERE / "traffic" / f"{traffic}.json")
                           .read_text()),
        end_to_end=[], per_layer=[])
    cell.traffic.update(CELLS[name])
    return cell


def test_every_cell_of_the_benchmark_loads():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]).read)
        spec.work_module(cell.config)


def _run(name, call=None, traced=False, seed=2**31 + 11):
    return loop.run_cell(_cell(name), seed, 0.3, traced,
                         torch.device("cpu"), time.perf_counter(), call=call)


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("traced", [False, True])
def test_a_cpu_run_prints_a_well_formed_line(name, traced):
    r = _run(name, traced=traced)
    assert KEYS <= set(r) and list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 1
    assert r["metrics"] == {}           # no device metric from a CPU run
    assert r["device"]["platform"] == "cpu"
    assert r["checks"]["calls_checked"]["value"] >= 1
    json.loads(json.dumps(r))


def _program(cell):
    import gpusorting_tpu_torch as gstt
    from sortbench import entries
    return entries.make_call(gstt, cell.config, cell.traffic)


def _unchanged(out, x):
    got = {"keys": x.keys.clone()}
    if "values" in out:
        got["values"] = x.values.clone()
    return got


def _half(out, x):
    """The first half of the input sorted alone, the rest left out."""
    h = x.n // 2
    k = x.keys.clone()
    k[:h] = torch.sort(x.keys[:h].view(torch.int32) ^ -0x80000000
                       ).values.__xor__(-0x80000000).view(x.keys.dtype)
    got = {"keys": k}
    if "values" in out:
        got["values"] = out["values"].clone()
    return got


def _altered(out, x):
    k = out["keys"].clone()
    k.view(torch.int32)[x.n // 3] ^= 1
    return {**out, "keys": k}


@pytest.mark.parametrize("name", sorted(CELLS))
@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
def test_a_broken_path_reads_incorrect(name, fault):
    program = _program(_cell(name))
    r = _run(name, call=lambda x: fault(program(x), x))
    assert r["correct"] is False and r["failed"] >= 1


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_control_reads_incorrect(name):
    from sortbench import control
    cell = _cell(name)
    r = _run(name, call=control.control_call(cell.config, cell.traffic))
    assert r["correct"] is False
    assert reference.CONTROL_SORT_BITS < 32


def test_a_raising_call_counts_as_failed():
    name = "gpusort_u32.keys_2p20"
    program = _program(_cell(name))
    seen = []

    def flaky(x):                # every third call past the warm-up fails
        seen.append(1)
        if len(seen) > CELLS[name]["pool"] and len(seen) % 3 == 0:
            raise RuntimeError("device lost")
        return program(x)
    r = _run(name, call=flaky)
    assert r["correct"] is False
    assert r["checks"]["failed_calls"]["value"] >= 1
    assert r["failed"] >= r["checks"]["failed_calls"]["value"]


def test_the_command_refuses_a_machine_without_a_card():
    p = subprocess.run(
        [sys.executable, str(spec.HERE / "run.py"), "--workload",
         "gpusort_u32.keys_2p20", "--seed", "5", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=spec.ROOT)
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "no CUDA card" in p.stderr


def test_no_forbidden_module_is_loaded():
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(spec.ROOT)!r})\n"
        "import sortbench.run as run\n"
        "from sortbench import loop, spec, control, trace\n"
        "cell = spec.load_cell('splitsort_u32_pairs.max4096_2p26')\n"
        "cell.traffic.update(n=2000, pool=2)\n"
        "loop.run_cell(cell, 3, 0.2, True, torch.device('cpu'),\n"
        "              time.perf_counter())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=spec.ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "gpusorting_tpu_torch" in loaded
    assert not loaded & run.FORBIDDEN


def test_trace_reduction():
    ev = []

    def x(cat, name, ts, dur):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur})
    # two calls, 100 us each, spans next_input / call / sync
    for base in (0.0, 100.0):
        x("user_annotation", "next_input", base, 2)
        x("user_annotation", "call", base + 2, 58)
        x("cpu_op", "aten::sort", base + 10, 40)
        x("cpu_op", "aten::empty", base + 12, 1)   # nested in aten::sort
        x("user_annotation", "sync", base + 60, 40)
        x("kernel", "k_sort<int>", base + 30, 50)
        x("gpu_memset", "Memset (Device)", base + 25, 5)
    x("kernel", "outside", 500.0, 10)              # after the window
    w = trace.reduce(ev, bytes_moved=2 * 8 * 1000, keys=2000,
                     peak_bytes_per_s=1e9)
    assert w.calls == 2
    assert w.wall_s == pytest.approx(200e-6)
    assert w.busy_s == pytest.approx(110e-6)
    assert w.kernels == 2
    assert w.call_host_s == pytest.approx(116e-6)
    assert dict(w.device_ops) == pytest.approx(
        {"k_sort<int>": 100e-6, "Memset (Device)": 10e-6})
    gaps = dict(w.idle_gaps)
    assert sum(gaps.values()) == pytest.approx(90e-6)
    # [0, 25) in aten::sort; [80, 125) in the second call before its
    # sort; [180, 200) in the second sync
    assert gaps == pytest.approx({"call/aten::sort": 25e-6, "call": 45e-6,
                                  "sync": 20e-6})
    mods = {m: spec.metric_reader(m).read(w) for m in (
        "call_host_ms", "sort_roofline", "launches_per_sort",
        "device_idle_pct")}
    assert mods["call_host_ms"] == pytest.approx(0.058)
    assert mods["launches_per_sort"] == 1
    assert mods["device_idle_pct"] == pytest.approx(45.0)
    assert mods["sort_roofline"] == pytest.approx(16e-6 / 110e-6 * 100)
    empty = trace.reduce([e for e in ev if e["cat"] not in (
        "kernel", "gpu_memset")], 1, 1, 1e9)
    assert all(spec.metric_reader(m).read(empty) is None for m in (
        "sort_roofline", "launches_per_sort", "device_idle_pct"))


@pytest.mark.parametrize("name,config,traffic", [
    ("gpusort_u32.keys_2p20", {}, {"mode": "pairs"}),
    ("gpusort_u32.keys_2p20", {}, {"mode": "argsort"}),
    ("gpusort_u32.keys_2p20", {"order": "descending"}, {"mode": "pairs"}),
    ("gpusort_u32.keys_2p20", {"key_dtype": "float32"}, {"mode": "pairs"}),
    ("gpusort_u32.keys_2p20", {"key_dtype": "int32"}, {"entropy": "E020"}),
    ("gpusort_u32.keys_2p20", {"payload_dtype": "uint64"},
     {"mode": "pairs"}),
    ("splitsort_u32_pairs.max32_2p26", {}, {"mode": "keys"}),
    ("splitsort_u32_pairs.max32_2p26", {}, {"key_bits": 16}),
    ("splitsort_u32_pairs.max4096_2p26", {},
     {"layout": "fixed_segments", "seg_len": 40}),
])
def test_the_cells_later_data_can_add(name, config, traffic):
    """Modes, layouts, key types and orders a later cell can ask for by a
    data file alone run correct, and a fault in them reads incorrect."""
    cell = _cell(name)
    cell.config.update(config)
    cell.traffic.update(traffic)
    r = loop.run_cell(cell, 123456789, 0.2, False, torch.device("cpu"),
                      time.perf_counter())
    assert r["correct"] is True, r["checks"]
    program = _program(cell)
    r = loop.run_cell(cell, 123456789, 0.2, False, torch.device("cpu"),
                      time.perf_counter(),
                      call=lambda x: _altered_any(program(x)))
    assert r["correct"] is False


def _altered_any(out):
    name = next(iter(out))
    t = out[name].clone()
    t.view(torch.int32 if t.dtype.itemsize == 4 else torch.int64)[7] ^= 1
    return {**out, name: t}
