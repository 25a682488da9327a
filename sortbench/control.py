"""Read the control's numbers on the card: the plain reference put in the
program's place, sorting by the top 16 of the 32 key bits (the guarantee
every configuration states that the control breaks), driven through a
short run of the cell at its own sizes on each seed given.

    python3 sortbench/control.py --workload gpusort_u32.keys_2p28 \\
        --seeds 11 12 13 [--seconds 2]

Prints one JSON line a seed with the numbers compared; a sound comparison
reads `correct` false on every seed.  A cell over several cards runs every
seed in one launch of its ranks (ranks.py), the control in the program's
place on each rank (`DistControl`).  The benchmark's own runs never run
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


class DistControl:
    """The control of a distributed call, in the program's place on one
    rank: every rank's shard gathered, the global input in its stable
    order by the top 16 key bits (reference.control_order), and this
    rank's equal share of it returned as the program's dict.  Each pool
    input's outputs are computed once."""

    def __init__(self, key_dtype: str):
        self.key_dtype = key_dtype
        self.memo = {}

    def __call__(self, program, x):
        import torch
        import torch.distributed as dist

        from sortbench import reference

        if id(x) not in self.memo:
            while len(self.memo) >= 4:          # inputs of an earlier seed
                self.memo.pop(next(iter(self.memo)))
            world, rank = dist.get_world_size(), dist.get_rank()
            parts = []
            for t in (x.keys, x.values):
                t = t.view(torch.int32)
                got = [torch.empty_like(t) for _ in range(world)]
                dist.all_gather(got, t)
                parts.append(torch.cat(got))
                del got
            keys, values = parts
            mine = reference.control_order(keys, self.key_dtype)[
                rank * x.n:(rank + 1) * x.n].clone()
            codes = reference.codes_of(
                keys[mine].to(torch.int64) & reference.M32, self.key_dtype)
            values = values[mine]
            del parts, keys, mine
            # the input is held beside its outputs, so its id is not reused
            self.memo[id(x)] = (x, {
                "codes": ((codes ^ 0x80000000) - 0x80000000).to(torch.int32),
                "payload_bits": values,
                "count": torch.tensor(x.n, device=x.keys.device),
                "overflow": torch.tensor(0, device=x.keys.device)})
        return self.memo[id(x)][1]


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
    if cell.chips > 1:
        from sortbench import ranks
        if torch.cuda.device_count() < cell.chips:
            print(f"control: {cell.name} needs {cell.chips} cards",
                  file=sys.stderr)
            return 2
        wrap = DistControl(cell.config["key_dtype"])
        results, _ = ranks.launch(
            cell, [(seed, args.seconds, False, wrap) for seed in args.seeds],
            time.perf_counter(), 300.0 * len(args.seeds))
        for seed, r in zip(args.seeds, results):
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "correct": r["correct"],
                              "checks": r["checks"]}), flush=True)
        return 0
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
