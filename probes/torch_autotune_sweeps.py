"""Full-size sweeps of the port's tuner on one NVIDIA card, through the
console driver and the bench script, each repeated in processes of its own.

    python3 probes/torch_autotune_sweeps.py [--runs 3] [--out FILE]

Builds every kernel of the port (one nvcc per source, all at once), then
runs each command below in a process of its own from the repository's
root, the whole list `--runs` times in turns (so a drift of the card
falls on every cell alike), and prints the card's name and power limit,
then one JSON line per process (its argv, run, seconds and what it
printed) and, at the end, one line per command with each cell's ms in
every run, their median and their spread (max - min):

  python -m gpusorting_tpu_torch autotune --engine rts --n 2^28 --tiles 8 .. 256
  python -m gpusorting_tpu_torch autotune --engine rts --n 2^28 ... --mode pairs
  python -m gpusorting_tpu_torch autotune --engine radix16 --n 2^28
  python -m gpusorting_tpu_torch autotune --engine radix16 --n 2^28 --mode pairs
  python -m gpusorting_tpu_torch autotune --routing --n 2^22
  python -m gpusorting_tpu_torch autotune --rangesweep          (n = 2^28)
  python -m gpusorting_tpu_torch autotune --rangesweep --n 2^29
  python -m gpusorting_tpu_torch.bench
  python -m gpusorting_tpu_torch.bench --flat

A cell's ms is n over the keys/s the command printed.  Nothing is
installed: the rows measured here are recorded for the card's table
(gpusorting_tpu_torch/core/config.py).  `--out FILE` also appends every
line to FILE.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TILES = ["--tiles", "8", "16", "32", "64", "128", "256"]
COMMANDS = (
    ["autotune", "--engine", "rts", "--n", "2^28", *TILES],
    ["autotune", "--engine", "rts", "--n", "2^28", "--mode", "pairs",
     *TILES],
    ["autotune", "--engine", "radix16", "--n", "2^28"],
    ["autotune", "--engine", "radix16", "--n", "2^28", "--mode", "pairs"],
    ["autotune", "--routing", "--n", "2^22"],
    ["autotune", "--rangesweep"],
    ["autotune", "--rangesweep", "--n", "2^29"],
)


def _size(text: str) -> int:
    return 1 << int(text[2:]) if text.startswith("2^") else int(text)


def cells_ms(argv: list, out: dict) -> dict:
    """{cell: ms} from one command's printed line."""
    if argv[0] == "bench":
        return {"sort": out["detail"]["seconds_per_sort"] * 1e3}
    n = _size(argv[argv.index("--n") + 1]) if "--n" in argv else None
    if "sweep_keys_per_sec" in out:
        return {f"tile{t}": n / r * 1e3
                for t, r in out["sweep_keys_per_sec"].items()}
    if "--routing" in argv:
        return {f"max{ml}_{route}": n / r * 1e3
                for ml, cell in out["sweep"]["window_pairs"].items()
                for route, r in cell.items()}
    # --rangesweep: {"keys": {"flat@N": keys/s, "rs_segL@N": ...}, ...}
    return {f"{mode}_{cell}": int(cell.split("@")[1]) / r * 1e3
            for mode, cells in out["sweep"].items()
            for cell, r in cells.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from gpusorting_tpu_torch.ops import _nvcc
    from gpusorting_tpu_torch.utils import timing

    card = timing.card_line()
    if card is None:
        print("torch_autotune_sweeps: nvidia-smi found no card",
              file=sys.stderr)
        return 2
    out_file = open(args.out, "a") if args.out else None

    def emit(rec) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if out_file:
            out_file.write(line + "\n")
            out_file.flush()

    print(card, flush=True)
    t0 = time.perf_counter()
    _nvcc.build_all(sorted(_nvcc.CSRC.glob("*.cu")))
    emit({"build_seconds": time.perf_counter() - t0, "card": card})
    runs = [(["-m", "gpusorting_tpu_torch", *c], c) for c in COMMANDS]
    runs += [(["-m", "gpusorting_tpu_torch.bench", *f], ["bench", *f])
             for f in ((), ("--flat",))]
    failed = 0
    cells: dict = {}
    for run in range(args.runs):
        for argv, key in runs:
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, *argv], capture_output=True,
                                 text=True, cwd=ROOT, timeout=1800)
            rec = {"argv": argv, "run": run,
                   "seconds": time.perf_counter() - t0,
                   "rc": res.returncode, "card": card}
            if res.returncode == 0:
                rec["output"] = json.loads(res.stdout.strip().splitlines()[-1])
                for cell, ms in cells_ms(key, rec["output"]).items():
                    cells.setdefault(" ".join(key), {}).setdefault(
                        cell, []).append(ms)
            else:
                failed += 1
                rec["stderr"] = res.stderr[-4000:]
            emit(rec)
    for cmd, per_cell in cells.items():
        emit({"command": cmd, "card": card, "cells": {
            cell: {"ms": v, "median_ms": statistics.median(v),
                   "spread_ms": max(v) - min(v)}
            for cell, v in per_cell.items()}})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
