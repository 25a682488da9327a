"""Console driver tests (`python -m gpusorting_tpu_torch`), mirroring
tests/test_cli.py, and the bench script (`python -m
gpusorting_tpu_torch.bench`, or run by its path) with the route flag it
prints, `ops/radix.is_native`.

On the CPU the suites run with `--device cpu` on the kernels' plain
versions; `bench`, `autotune` and the bench script time the card, so
there they must refuse, naming the CUDA requirement.  Tiny sizes.
"""

import dataclasses
import json
import pathlib
import subprocess
import sys

import pytest
import torch

import gpusorting_tpu as gst
import gpusorting_tpu_torch as gstt
from gpusorting_tpu.__main__ import main as jmain
from gpusorting_tpu_torch.__main__ import _parse_size, build_parser, main
from gpusorting_tpu_torch.core import config
from gpusorting_tpu_torch.ops import radix
from gpusorting_tpu_torch.utils import timing

_ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops; one intra-op thread
    keeps them fast when several test processes share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_parse_size_forms():
    assert _parse_size("2^12") == 4096
    assert _parse_size("4096") == 4096
    assert _parse_size(" 10^3 ") == 1000


def test_parser_requires_command():
    with pytest.raises(SystemExit):
        build_parser().parse_args([])


def test_cli_info_has_jax_keys(capsys):
    assert main(["info", "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert jmain(["info", "--json"]) == 0
    jout = json.loads(capsys.readouterr().out)
    assert set(out) == set(jout) == {"device", "tuning", "routing"}
    assert set(out["tuning"]) == set(jout["tuning"]) == {"keys_only",
                                                         "pairs"}


def test_cli_test_all_matches_jax(capsys):
    flags = ["--window", "1024", "--stride", "509", "--large", "2^12"]
    assert main(["test", "--device", "cpu"] + flags) == 0
    out = capsys.readouterr().out
    assert jmain(["test"] + flags) == 0
    jout = capsys.readouterr().out
    assert "passed" in out
    assert out.split(": ", 1)[1] == jout.split(": ", 1)[1]   # "4 / 4 passed"


def test_cli_supertest(capsys):
    assert main(["supertest", "--device", "cpu", "--sizes", "64",
                 "129"]) == 0
    assert "36 / 36 passed" in capsys.readouterr().out


def test_cli_segsort_bits(capsys):
    assert main(["segsort", "--device", "cpu", "--total", "2^12",
                 "--maxlen", "16", "--bits", "8"]) == 0
    assert "PASS" in capsys.readouterr().out


def test_cli_dist():
    """Four gloo ranks spawned by run_ranks, held by its deadline, from
    `python -m`, whose module the ranks cannot import by the name
    "__main__"."""
    res = subprocess.run(
        [sys.executable, "-m", "gpusorting_tpu_torch", "dist", "--device",
         "cpu", "--ranks", "4", "--n", "2^12"], capture_output=True,
        text=True, timeout=300, cwd=_ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == ("dist n=4096 devices=4 "
                                  "exchange=collective: PASS (overflow=0)")


def test_cli_dist_refuses_remote_dma_on_the_card(monkeypatch):
    # the refusal comes before any rank starts or any tensor is made
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="gloo"):
        main(["dist", "--exchange", "remote_dma"])


@pytest.mark.parametrize("argv", [
    ["bench", "--n", "2^12", "--batch", "2"],
    ["autotune", "--n", "2^12", "--tiles", "8"],
    ["autotune", "--routing", "--n", "2^12"],
    ["autotune", "--rangesweep", "--n", "2^12"],
])
def test_timing_commands_refuse_the_cpu(argv):
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv + ["--device", "cpu"])


def test_cli_autotune_defaults(monkeypatch, capsys):
    """--rangesweep defaults --n to 2^28 (the JAX driver inherits 2^22),
    the others to 2^22; --tiles to the card's candidates."""
    seen = {}

    def record(name, ret):
        def fn(*a, **kw):
            seen[name] = (a, kw)
            return ret, {}
        return fn

    monkeypatch.setattr(gstt, "autotune_rangesweep",
                        record("rangesweep", gstt.RoutingParameters()))
    monkeypatch.setattr(gstt, "autotune_routing",
                        record("routing", gstt.RoutingParameters()))
    monkeypatch.setattr(gstt, "autotune",
                        record("tiles", gstt.TuningParameters(32)))
    for argv in (["--rangesweep"], ["--routing"], []):
        assert main(["autotune"] + argv) == 0
        json.loads(capsys.readouterr().out)
    assert seen["rangesweep"][1]["n_max"] == 1 << 28
    assert seen["routing"][1]["n"] == 1 << 22
    assert seen["tiles"][1]["n"] == 1 << 22
    assert seen["tiles"][1]["tiles"] == (8, 16, 32, 64, 128)
    assert all(kw["device"] == "cuda" for _, kw in seen.values())


def test_bench_script_refuses_the_cpu():
    res = subprocess.run(
        [sys.executable, "-m", "gpusorting_tpu_torch.bench", "--device",
         "cpu"], capture_output=True, text=True, timeout=120,
        cwd=_ROOT)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "timing needs a CUDA device" in res.stderr


def test_bench_script_runs_by_its_path(tmp_path):
    """Run by its path from another directory, the script gets as far as
    the timing's refusal, not to a ModuleNotFoundError."""
    res = subprocess.run(
        [sys.executable, str(_ROOT / "gpusorting_tpu_torch" / "bench.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=120,
        cwd=tmp_path)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "ModuleNotFoundError" not in res.stderr
    assert "timing needs a CUDA device" in res.stderr


def test_batch_timing_with_repeats_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="timing needs a CUDA device"):
        timing.batch_timing(lambda k: k, 16, batch=5, repeats=4,
                            device="cpu")


_H100 = config.DeviceInfo("cuda", "NVIDIA H100 80GB HBM3", "h100", 1,
                          80 << 30, 3350.0)


def test_is_native_false_on_the_h100_row_and_the_cpu():
    """False on the CPU; on the card's measured row AUTO sends 2^28 keys to
    the 8-bit-digit radix sort, whose kernels are hand-written, and False
    again where the row's threshold lies above 2^28."""
    assert config.get_routing_parameters(_H100).measured
    assert radix.is_native(_H100) is True
    assert radix.is_native(config.get_device_info("cpu")) is False
    assert radix.is_native() is False         # no card here: the CPU
    config.set_routing_override(dataclasses.replace(
        config.get_routing_parameters(_H100), radix256_min=(1 << 28) + 1))
    try:
        assert radix.is_native(_H100) is False
    finally:
        config.clear_routing_override()


def test_is_native_under_a_rangesweep_override():
    """True where AUTO sends 2^28 keys to rangesweep; the CPU still takes
    the flat route under the same override."""
    config.set_routing_override(config.RoutingParameters(
        rangesweep_min=1 << 28))
    try:
        assert radix.is_native(_H100) is True
        assert radix.is_native(config.get_device_info("cpu")) is False
    finally:
        config.clear_routing_override()
    config.set_routing_override(config.RoutingParameters(
        rangesweep_min=(1 << 28) + 1))
    try:
        assert radix.is_native(_H100) is False
    finally:
        config.clear_routing_override()


def test_port_surface_covers_jax():
    assert set(gst.__all__) <= set(gstt.__all__)
