"""Headline benchmark of the port: keys/s on the reference's flagship
workload, on the CUDA card.

    python -m gpusorting_tpu_torch.bench            # AUTO
    python -m gpusorting_tpu_torch.bench --flat     # the flat torch.sort
    python3 gpusorting_tpu_torch/bench.py [--flat]  # the same, by its path

The reference's harness (BASELINE.md): 2^28 u32 keys, the average of a
batch after one warm-up, the input regenerated each iteration from seed
i + seed, only the sort timed (GPUSortingCUDA.cu:20-49).  Here that is
`utils/timing.batch_timing` over `gstt.sort` under `OneSweep(SortConfig())`,
that is Backend.AUTO, with the JAX package's settings on its chip (root
`bench.py`): 4 timed chains of 5 sorts, 20 in all, the spread the min and
max of the chains' per-sort means.  `--flat` times the flat `torch.sort`
route (Backend.XLA) instead, the yardstick.  The size is never cut:
without a card the timing raises.

Prints ONE JSON line:
  {"metric": "keys_per_sec_u32_2^28", "value": N, "unit": "keys/s",
   "vs_baseline": N / hbm_speed_of_light_keys_per_sec, "detail": {...}}

vs_baseline is the fraction of the card's memory-rate bound for a 4-pass
LSD radix (8 bytes of traffic per key per pass: hbm_gbps * 1e9 / 32 keys
a second).  `detail` carries the card's name and power limit as
nvidia-smi gives them, the route AUTO took and `backend_native_kernels`
(`ops/radix.is_native`: whether that route runs a hand-written kernel).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if not __package__:
    # run by its path: Python put this package's own directory on sys.path,
    # not its parent, so the package itself would not import
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

N = 1 << 28
BATCH = 5
REPEATS = 4
SEED = 10


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m gpusorting_tpu_torch.bench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--flat", action="store_true",
                   help="time the flat torch.sort route instead of AUTO")
    p.add_argument("--device", default="cuda",
                   help="torch device; timing needs a CUDA card")
    args = p.parse_args(argv)

    import gpusorting_tpu_torch as gstt
    from gpusorting_tpu_torch.ops import radix
    from gpusorting_tpu_torch.utils import timing

    backend = gstt.Backend.XLA if args.flat else gstt.Backend.AUTO
    sorter = gstt.OneSweep(gstt.SortConfig(backend=backend),
                           device=args.device)
    res = timing.batch_timing(
        lambda keys: gstt.sort(keys, backend=sorter.config.backend),
        N, batch=BATCH, seed=SEED, repeats=REPEATS, device=sorter.device)
    info = sorter.device_info
    route = "xla" if args.flat else gstt.auto_engine(N, info=info)

    sol_keys_per_sec = info.hbm_gbps * 1e9 / 32.0
    value = res["keys_per_sec"]
    print(json.dumps({
        "metric": f"keys_per_sec_u32_2^{N.bit_length() - 1}"
                  + ("_flat" if args.flat else ""),
        "value": value,
        "unit": "keys/s",
        "vs_baseline": value / sol_keys_per_sec if sol_keys_per_sec else None,
        "detail": {
            "n": N,
            "batch": res["batch"],
            "repeats": res["repeats"],
            "seconds_per_sort": res["seconds_per_sort"],
            "spread_min_s": res["spread_min_s"],
            "spread_max_s": res["spread_max_s"],
            "device": info.device_kind,
            "generation": info.generation,
            "card": timing.card_line(),
            "backend": backend.value,
            "route": route,
            "backend_native_kernels": radix.is_native(info),
            "hbm_sol_keys_per_sec": sol_keys_per_sec,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
