#!/usr/bin/env python3
"""Probe of the segmented sort's shared-memory tile (segsort/segtile.py,
csrc/segtile.cu) on the card.

    python3 probes/torch_segtile_probe.py [--sweep] [--n LOG2] [--iters K]

Prints the card's name and power limit and `-Xptxas -v` of
csrc/segtile.cu (each tile's instantiation), then runs chip_smoke.py's
phase 24 at n = 2^LOG2 (default 26): the kernel against its plain version
and the composite oracle at both segmented cells' layouts, the route on
the installed row, and the times beside the byte bound, the oracle's
composite and the composite route.  `--sweep` adds the sweep that sets the
card row's `segsort_tile_max`: split_sort_pairs with the tile route on
(`segsort_tile_max` 8192) and off (0, the composite route), in turns, at
2^22 and 2^26 keys in random segments of at most 32 .. 8192, on (u32,
u32) pairs by 32 bits and on 16-bit keys with a 64-bit payload by 16
bits; each time the median of K calls, each call between CUDA events
from an empty stream (the host's time in the call and the card's work)
after one untimed call of the same route, the routes in turns.
Its last line picks the largest max length at and below which the tile
route won every layout swept.  One JSON line a result; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

MAX_LENS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
SIZES = (22, 26)
# (mode, bits_to_sort, payload bytes)
MODES = (("u32_pairs", 32, 4), ("b16_u64_pairs", 16, 8))


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


def _sweep(dev, emit, iters: int) -> None:
    import gpusorting_tpu_torch as gstt
    from gpusorting_tpu_torch.core import prng
    from gpusorting_tpu_torch.utils import timing

    installed = gstt.get_routing_parameters(gstt.get_device_info(dev))
    rows = {"tile": dataclasses.replace(installed, segsort_tile_max=8192),
            "composite": dataclasses.replace(installed, segsort_tile_max=0)}
    wins = {}
    for log2 in SIZES:
        n = 1 << log2
        for mode, bits, pay in MODES:
            if bits < 32:
                keys = prng.make_masked_random_values(n, bits, 90 + log2,
                                                      device=dev)
            else:
                keys = prng.make_test_keys(n, 90 + log2, device=dev)
            idx = torch.arange(n, dtype=torch.int64, device=dev)
            vals = (idx.view(torch.uint64) if pay == 8
                    else idx.to(torch.int32).view(torch.uint32))
            for ml in MAX_LENS:
                offs, S = prng.make_random_segments(n, ml, 7 * ml + log2,
                                                    device=dev)
                ms = {r: [] for r in rows}
                for i in range(iters):
                    for r in (("tile", "composite") if i % 2 else
                              ("composite", "tile")):
                        gstt.set_routing_override(rows[r])
                        try:
                            ms[r] += timing.device_time_ms(
                                lambda: gstt.split_sort_pairs(
                                    offs, keys, vals, S, n, bits),
                                iters=1, warmup=1, device=dev)
                        finally:
                            gstt.clear_routing_override()
                med = {r: statistics.median(v) for r, v in ms.items()}
                wins[log2, mode, ml] = med["tile"] < med["composite"]
                emit(sweep="segsort_tile_max", n=n, mode=mode, max_len=ml,
                     segments=S, tile_ms=med["tile"],
                     composite_ms=med["composite"],
                     tile_runs=ms["tile"], composite_runs=ms["composite"],
                     tile_wins=wins[log2, mode, ml])
                del offs
            del keys, vals, idx
            torch.cuda.empty_cache()
    pick = 0
    for ml in MAX_LENS:
        if not all(w for (_, _, m), w in wins.items() if m == ml):
            break
        pick = ml
    emit(decision="segsort_tile_max", pick=pick,
         installed=installed.segsort_tile_max,
         lost=[list(k) for k, w in wins.items() if not w])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--n", type=int, default=26)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_segtile_probe: no CUDA card", file=sys.stderr)
        return 2

    import chip_smoke
    from gpusorting_tpu_torch.segsort import segtile
    from gpusorting_tpu_torch.utils import timing

    dev = torch.device("cuda", 0)
    card = timing.card_line()

    def emit(**rec) -> None:
        rec["card"] = card
        print(json.dumps(rec), flush=True)

    emit(ptxas=_ptxas(segtile.SOURCE))
    chip_smoke.segtile_phase(dev, emit, 1 << args.n)
    if args.sweep:
        _sweep(dev, emit, args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
