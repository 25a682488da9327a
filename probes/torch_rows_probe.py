"""Hold the sampler's per-row cell against the plain per-row oracle on the
card, and read the port's fixed-route counters over runs of the cell.

    python3 probes/torch_rows_probe.py --seeds 11 12 [--seconds 20]

For each seed: one run of the cell (default
`sampler_rows_f32.b256_v129280`) through sortbench's loop, untraced, with
the port's counters reset before it; every call of the run (the pool's
warm-up and the window) must count `engine.fixed`, `fixed.sort` and
`fixed.gather` once, and no `engine.tile` or `composite.*` span.  Then
every input of the seed's pool is sorted by the cell's own call and by
`sortbench/plain_rows.py` in blocks of whole rows, and the two are
compared bit for bit on the card.  Prints one JSON line a seed and writes
them to chiprun_out/rows_probe.jsonl.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

CELL = "sampler_rows_f32.b256_v129280"
ONCE = ("engine.fixed", "fixed.sort", "fixed.gather")


def check_seed(cell, seed: int, seconds: float, device: torch.device,
               block: int = 1 << 24) -> dict:
    """The run's verdict and counters, and the pool's mismatches against
    the plain oracle, for one seed."""
    import gpusorting_tpu_torch as gstt
    from gpusorting_tpu_torch.utils import trace
    from sortbench import entries, inputs, loop, plain_rows

    trace.reset()
    r = loop.run_cell(cell, seed, seconds, False, device, time.perf_counter())
    counts = trace.counts()
    calls = r["attempted"] + int(cell.traffic["pool"])
    stray = {k: v for k, v in counts.items() if v and (
        k == "engine.tile" or k.startswith("composite."))}
    call = entries.make_call(gstt, cell.config, cell.traffic)
    wrong = []
    for x in inputs.make_pool(cell.config, cell.traffic, seed, device):
        out = call(x)
        pk, pv = plain_rows.sort_rows_blocked(x.keys, x.values, x.starts,
                                              block)
        wrong.append(int((out["keys"].view(torch.int32)
                          != pk.view(torch.int32)).sum())
                     + int((out["values"].view(torch.int32)
                            != pv.view(torch.int32)).sum()))
        del out, pk, pv
    return {
        "workload": cell.name, "seed": seed, "correct": r["correct"],
        "checks": r["checks"], "calls": calls,
        **{name: counts.get(name, 0) for name in ONCE}, "stray": stray,
        "counted_once_a_call": (all(counts.get(name, 0) == calls
                                    for name in ONCE) and not stray),
        "plain_wrong": wrong, "metrics": r["metrics"],
        "memory_peak_bytes": r["device"]["memory_peak_bytes"],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default=CELL)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe: no CUDA card", file=sys.stderr)
        return 2
    from sortbench import spec

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cell = spec.load_cell(args.workload)
    out = ROOT / "chiprun_out" / "rows_probe.jsonl"
    out.parent.mkdir(exist_ok=True)
    ok = True
    with out.open("a") as f:
        for seed in args.seeds:
            line = check_seed(cell, seed, args.seconds, dev)
            line["card"] = torch.cuda.get_device_name(dev)
            ok &= (line["correct"] and line["counted_once_a_call"]
                   and not any(line["plain_wrong"]))
            print(json.dumps(line), flush=True)
            f.write(json.dumps(line) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
