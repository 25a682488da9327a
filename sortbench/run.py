"""Run one benchmark cell of gpusorting_tpu_torch on the CUDA card.

    python3 sortbench/run.py --workload gpusort_u32.keys_2p28 --seed 7 \\
        --seconds 10 --trace 0

from the root of a checkout.  `--trace 0` prints the cell's end-to-end
metrics, `--trace 1` its per-layer metrics from a torch.profiler trace of
part of the window.  The last line of standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
`breakdown`, then the card's readings, the run's own numbers, and last
`checks`, each number compared beside its limit (also the last lines of
standard error).  Without a CUDA card, or with fewer cards than the cell
asks for, it exits 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

_ROOT = pathlib.Path(__file__).resolve().parents[1]
# every build and kernel cache of the program at a fixed path in the
# checkout, so that only a checkout's first run builds
_CACHE = _ROOT / "sortbench" / "_cache"
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(_CACHE / _sub)
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

FORBIDDEN = {"jax", "jaxlib", "flax", "gpusorting_tpu"}


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the port must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from sortbench import loop, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("sortbench: no CUDA card (torch.cuda.is_available() is "
              "False); no result", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"sortbench: {cell.name} needs {cell.chips} cards, torch sees "
              f"{torch.cuda.device_count()}; no result", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    result = loop.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           dev, T_START)
    bad = forbidden_modules()
    if bad:
        print(f"sortbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    print(f"card before the window: {result['card']['before']}",
          file=sys.stderr)
    print(f"card after the window: {result['card']['after']}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        side = "min" if "min" in c else "max"
        print(f"check {name} {c['value']} ({side} {c[side]})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
