#!/usr/bin/env python3
"""Probe of the distributed sort's merge (parallel/dist_merge.py,
csrc/dist_merge.cu) on the card.

    python3 probes/torch_dist_merge_probe.py [--rounds K]

Prints the card's name and power limit and `-Xptxas -v` of
csrc/dist_merge.cu (each kernel's registers, shared memory and spills),
then runs chip_smoke.py's phase 25: the runs ranks 0 and 3 of the 4-card
cell receive (4 x 2^28 Zipf(1.3) pairs, the path's own splitters, counts,
local sort, pack and mask), the kernel against its plain version
(`merge_plain` of every slot with the padding, the parent's path), bit for
bit, then the kernel and the plain version timed in K turns beside the
byte bound.  One JSON line a result; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def _ptxas(src):
    from gpusorting_tpu_torch.ops import _nvcc
    out = subprocess.run(
        [_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.devnull, str(src)], capture_output=True, text=True)
    if out.returncode:
        print(out.stderr[-3000:], file=sys.stderr)
        raise SystemExit(f"nvcc failed on {src.name}")
    return [ln.split(":", 1)[-1].strip()[:150]
            for ln in out.stderr.splitlines()
            if "Used" in ln or "spill" in ln or "Compiling entry" in ln]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from gpusorting_tpu_torch.parallel import dist_merge
    from gpusorting_tpu_torch.utils import timing

    card = timing.card_line()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    def emit(**rec):
        rec["card"] = card
        print(json.dumps(rec), flush=True)

    emit(phase="ptxas", source=dist_merge.SOURCE.name,
         lines=_ptxas(dist_merge.SOURCE))
    chip_smoke.dist_merge_phase(dev, emit, rounds=args.rounds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
