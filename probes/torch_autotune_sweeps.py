"""Full-size sweeps of the port's tuner on one NVIDIA card, through the
console driver and the bench script.

    python3 probes/torch_autotune_sweeps.py

Builds every kernel of the port (one nvcc per source, all at once), then
runs each command below in a process of its own from the repository's
root and prints the card's name and power limit, then one JSON line per
command: its argv, its seconds and what it printed (the sweep):

  python -m gpusorting_tpu_torch autotune --engine rts     --n 2^28
  python -m gpusorting_tpu_torch autotune --engine rts     --n 2^28 --mode pairs
  python -m gpusorting_tpu_torch autotune --engine radix16 --n 2^28
  python -m gpusorting_tpu_torch autotune --engine radix16 --n 2^28 --mode pairs
  python -m gpusorting_tpu_torch autotune --routing --n 2^22
  python -m gpusorting_tpu_torch autotune --rangesweep          (n = 2^28)
  python -m gpusorting_tpu_torch.bench
  python -m gpusorting_tpu_torch.bench --flat

Nothing is installed: the rows measured here are recorded for the card's
table (gpusorting_tpu_torch/core/config.py).  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

COMMANDS = (
    ["autotune", "--engine", "rts", "--n", "2^28"],
    ["autotune", "--engine", "rts", "--n", "2^28", "--mode", "pairs"],
    ["autotune", "--engine", "radix16", "--n", "2^28"],
    ["autotune", "--engine", "radix16", "--n", "2^28", "--mode", "pairs"],
    ["autotune", "--routing", "--n", "2^22"],
    ["autotune", "--rangesweep"],
)


def main() -> int:
    sys.path.insert(0, ROOT)
    from gpusorting_tpu_torch.ops import _nvcc
    from gpusorting_tpu_torch.utils import timing

    card = timing.card_line()
    if card is None:
        print("torch_autotune_sweeps: nvidia-smi found no card",
              file=sys.stderr)
        return 2
    print(card, flush=True)
    t0 = time.perf_counter()
    _nvcc.build_all(sorted(_nvcc.CSRC.glob("*.cu")))
    print(json.dumps({"build_seconds": time.perf_counter() - t0,
                      "card": card}), flush=True)
    runs = [[sys.executable, "-m", "gpusorting_tpu_torch", *c]
            for c in COMMANDS]
    runs += [[sys.executable, "-m", "gpusorting_tpu_torch.bench", *f]
             for f in ((), ("--flat",))]
    failed = 0
    for argv in runs:
        t0 = time.perf_counter()
        res = subprocess.run(argv, capture_output=True, text=True, cwd=ROOT,
                             timeout=1800)
        rec = {"argv": argv[1:], "seconds": time.perf_counter() - t0,
               "rc": res.returncode, "card": card}
        if res.returncode == 0:
            rec["output"] = json.loads(res.stdout.strip().splitlines()[-1])
        else:
            failed += 1
            rec["stderr"] = res.stderr[-4000:]
        print(json.dumps(rec), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
