"""Read the control's numbers on the card: the plain reference put in the
program's place, sorting by the top 16 of the 32 key bits (the guarantee
every configuration states that the control breaks), driven through a
short run of the cell at its own sizes on each seed given.

    python3 sortbench/control.py --workload gpusort_u32.keys_2p28 \\
        --seeds 11 12 13 [--seconds 2]

Prints one JSON line a seed with the numbers compared; a sound comparison
reads `correct` false on every seed.  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

_ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))


def control_call(config: dict, traffic: dict):
    """fn(Input) -> the control's outputs as CPU tensors; each pool input's
    outputs are computed once, so the window's calls cost no host sort."""
    import numpy as np
    import torch

    from sortbench import entries, reference

    memo = {}

    def as_tensor(a: np.ndarray) -> torch.Tensor:
        if a.dtype == np.uint64:
            return torch.from_numpy(a.view(np.int64))
        if a.dtype == np.uint32:
            return torch.from_numpy(a.view(np.int32)).view(torch.uint32)
        return torch.from_numpy(a)

    def call(x):
        if id(x) not in memo:
            hin = entries.host_input(x, config)
            out = reference.control(hin, traffic["mode"],
                                    config["order"] == "descending")
            memo[id(x)] = {k: as_tensor(np.ascontiguousarray(v))
                           for k, v in out.items()}
        return memo[id(x)]
    return call


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)

    import torch

    from sortbench import loop, spec

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        r = loop.run_cell(cell, seed, args.seconds, False, dev,
                          time.perf_counter(),
                          call=control_call(cell.config, cell.traffic))
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": r["correct"], "checks": r["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
