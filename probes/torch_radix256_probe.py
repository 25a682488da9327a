#!/usr/bin/env python3
"""Probe of the 8-bit-digit radix sort (ops/radix256.py,
csrc/binning256.cu) on the card.

    python3 probes/torch_radix256_probe.py [--pairs] [--sweep] [--shapes]
                                           [--n LOG2]

Prints the card's name and power limit and `-Xptxas -v` of
csrc/binning256.cu (the keys-only and the pairs instantiations of the
pass), then runs chip_smoke.py's phase 23 at n = 2^LOG2 (default 28): the
kernels against their plain version and the flat sort, bit for bit, and
the times of the sort and of each of its kernels beside radix16, the flat
sort and AUTO.  `--pairs` adds the phase's pairs half (the pairs form
against its plain version and `torch.sort` with the gather, its pass
times) and the size sweep that sets the card row's `radix256_min_pairs`
(`_sweep`: AUTO on (u32, u32) pairs with the route forced on and off, n =
1 .. 2^28).  `--sweep` adds the keys' sweep, which sets `radix256_min`
(n = 1 .. 2^29).  `--shapes` builds other partitions (-DGST_R256_THREADS
/ _ITEMS / _MIN_BLOCKS, and with --pairs _PAIRS_ITEMS), holds each
build's sort (and pairs sort) equal to the flat route's and times them in
turns.  One JSON line a result; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import itertools
import json
import os
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

# build-time overrides of csrc/binning256.cu (-DGST_R256_<NAME>=<value>),
# each against the source's defaults
SHAPES = (
    {},
    {"ITEMS": 15},
    {"ITEMS": 16},
    {"THREADS": 384, "ITEMS": 20},
    {"THREADS": 256, "ITEMS": 15, "MIN_BLOCKS": 4},
)
# more builds that only the pairs form reads
PAIRS_SHAPES = (
    {"PAIRS_ITEMS": 20},
    {"PAIRS_ITEMS": 18},
    {"PAIRS_ITEMS": 14},
    {"PAIRS_ITEMS": 12},
)
# the build-time names that change the pairs form
_PAIRS_NAMES = ("THREADS", "MIN_BLOCKS", "PAIRS_ITEMS")


def _ptxas(src, extra=()):
    from gpusorting_tpu_torch.ops import _nvcc
    out = subprocess.run(
        [_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, *extra, "-Xptxas", "-v", "-o",
         os.devnull, str(src)], capture_output=True, text=True)
    if out.returncode:
        print(out.stderr[-3000:], file=sys.stderr)
        raise SystemExit(f"nvcc failed on {src.name}")
    return [ln.split(":", 1)[-1].strip()[:150]
            for ln in out.stderr.splitlines()
            if "Used" in ln or "spill" in ln or "Compiling entry" in ln]


def _name(shape: dict) -> str:
    return ",".join(f"{k}={v}" for k, v in shape.items()) or "default"


def _build_shape(shape):
    from gpusorting_tpu_torch.ops import _nvcc, radix256
    flags = [f"-DGST_R256_{m}={v}" for m, v in shape.items()]
    so = (ROOT / "gpusorting_tpu_torch" / "_build"
          / ("binning256_" + "_".join(f"{k}{v}" for k, v in shape.items())
             + ".so"))
    proc = subprocess.run([_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, *flags,
                           "-Xptxas", "-v", "-o", str(so),
                           str(radix256.SOURCE)],
                          capture_output=True, text=True)
    regs = sorted({ln.split(":", 1)[-1].strip()[:90]
                   for ln in proc.stderr.splitlines()
                   if "Used" in ln or "spill" in ln})
    return so, proc, regs


def _shapes(dev, emit, n, pairs):
    import concurrent.futures

    from gpusorting_tpu_torch.core import prng
    from gpusorting_tpu_torch.ops import _nvcc, flat_sort, kernels, radix256
    from gpusorting_tpu_torch.utils import timing

    shapes = SHAPES + (PAIRS_SHAPES if pairs else ())
    x = prng.make_test_keys(n, 77, device=dev)
    v = torch.arange(n, dtype=torch.int32, device=dev)
    want = flat_sort.sort_keys(x)
    wk, wv = flat_sort.sort_pairs(x, v)
    stream = torch.cuda.current_stream(dev).cuda_stream
    (ROOT / "gpusorting_tpu_torch" / "_build").mkdir(exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(shapes)) as pool:
        built = list(zip(shapes, pool.map(_build_shape, shapes)))
    calls = {}
    for shape, (so, proc, regs) in built:
        if proc.returncode:
            emit(kernel="radix256_shape", shape=_name(shape),
                 error=proc.stderr[-1500:])
            continue
        lib = _nvcc.declare(ctypes.CDLL(str(so)), radix256.SOURCE)
        fn, pfn = lib.gst_radix256_sort, lib.gst_radix256_sort_pairs
        counts = torch.zeros(4096, dtype=torch.int32, device=dev)
        threads = shape.get("THREADS", 512)
        part = threads * shape.get("ITEMS", 20)
        ppart = threads * shape.get("PAIRS_ITEMS", 16)

        def call(fn=fn, pfn=pfn, counts=counts, part=part, ppart=ppart,
                 with_v=False):
            planes = ([x, v, torch.empty_like(x), torch.empty_like(v),
                       torch.empty_like(x), torch.empty_like(v)] if with_v
                      else [x, torch.empty_like(x), torch.empty_like(x)])
            eps = []
            for _ in range(4):
                scratch, e = kernels._scan_scratch(
                    dev, stream, 256 * (-(-n // (ppart if with_v
                                                 else part))))
                eps.append(e)
            rc = (pfn if with_v else fn)(
                *(t.data_ptr() for t in planes), counts.data_ptr(),
                scratch.data_ptr(), scratch.numel() - 1, *eps, 0, n,
                stream)
            if rc:
                raise RuntimeError(f"CUDA error {rc}")
            return (planes[2], planes[3]) if with_v else planes[1]

        got = call()
        gk, gv = call(with_v=True)
        torch.cuda.synchronize()
        same = bool(torch.equal(got.view(torch.int32),
                                want.view(torch.int32)))
        same_pairs = bool(torch.equal(gk.view(torch.int32),
                                      wk.view(torch.int32))
                          and torch.equal(gv, wv))
        if same and shape in SHAPES:
            calls["keys " + _name(shape)] = call
        if same_pairs and pairs and (not shape or any(
                k in shape for k in _PAIRS_NAMES)):
            calls["pairs " + _name(shape)] = functools.partial(
                call, with_v=True)
        emit(kernel="radix256_shape", shape=_name(shape), partition=part,
             pairs_partition=ppart, ptxas=regs, same=same,
             same_pairs=same_pairs)
    times = {k: [] for k in calls}
    for _ in range(2):
        for k, call in list(calls.items()) + list(calls.items())[::-1]:
            times[k] += timing.device_time_ms(call, iters=5, device=dev)
    for k, ts in sorted(times.items(), key=lambda kv: statistics.median(
            kv[1])):
        emit(kernel="radix256_shape", shape=k, ms=statistics.median(ts),
             spread=[min(ts), max(ts)])


def _sweep(dev, emit, pairs=False):
    """AUTO on u32 keys (or, with `pairs`, (u32, u32) pairs through
    sort_pairs) with the radix256 route forced on and off through a routing
    override, at n = 1, 16, 256 and 2^10 .. 2^29 (pairs: .. 2^28) at powers
    of two and halfway: events around each call from an empty stream (so a
    call's host time counts where it exceeds its device time), inputs
    cycled through a pool of up to 1024 tensors and at least 256 MiB where
    that fits, 20 calls a turn in turns (off, on, on, off).  Emits each
    size's medians and the smallest n from which the radix sort wins at
    every larger size swept, the row's `radix256_min` (`radix256_min_pairs`
    with `pairs`)."""
    import gpusorting_tpu_torch as gstt
    from gpusorting_tpu_torch.core import prng
    from gpusorting_tpu_torch.utils import timing

    field = "radix256_min_pairs" if pairs else "radix256_min"
    installed = gstt.get_routing_parameters(gstt.get_device_info(dev))
    on = dataclasses.replace(installed, **{field: 1})
    off = dataclasses.replace(installed, **{field: None})
    top = 29 - pairs
    sizes = sorted({1, 16, 256} | {1 << k for k in range(10, top + 1)}
                   | {3 << (k - 1) for k in range(10, top)})
    rows = []
    for size in sizes:
        width = 8 if pairs else 4
        count = min(1024, max(4, -(-(256 << 20) // (width * size))))
        pool = [prng.make_test_keys(size, 1000 + i, device=dev)
                for i in range(count)]
        if pairs:
            pool = [(k, torch.arange(size, dtype=torch.int32, device=dev))
                    for k in pool]
        it = itertools.cycle(pool)
        call = ((lambda: gstt.sort_pairs(*next(it))) if pairs
                else (lambda: gstt.sort(next(it))))
        ms = {"off": [], "on": []}
        for which in ("off", "on", "on", "off"):
            gstt.set_routing_override(on if which == "on" else off)
            try:
                ms[which] += timing.device_time_ms(call, iters=20,
                                                   device=dev)
            finally:
                gstt.clear_routing_override()
        row = {"n": size, "flat_ms": statistics.median(ms["off"]),
               "radix256_ms": statistics.median(ms["on"])}
        rows.append(row)
        emit(phase="radix256_sweep", pairs=pairs, **row)
        del pool, it
        torch.cuda.empty_cache()
    wins = [r["radix256_ms"] < r["flat_ms"] for r in rows]
    pick = next((r["n"] for i, r in enumerate(rows) if all(wins[i:])), None)
    emit(phase="radix256_threshold", pairs=pairs, **{field: pick},
         installed=getattr(installed, field), sizes=len(rows))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--pairs", action="store_true")
    p.add_argument("--sweep", action="store_true")
    p.add_argument("--shapes", action="store_true")
    p.add_argument("--n", type=int, default=28)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2

    import chip_smoke
    from gpusorting_tpu_torch.ops import radix256
    from gpusorting_tpu_torch.utils import timing

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = timing.card_line()

    def emit(**rec):
        rec["card"] = card
        print(json.dumps(rec), flush=True)

    emit(ptxas=_ptxas(radix256.SOURCE))
    if args.shapes:
        _shapes(dev, emit, 1 << args.n, args.pairs)
    chip_smoke.radix256_phase(dev, emit, n=1 << args.n, pairs=args.pairs)
    if args.pairs:
        _sweep(dev, emit, pairs=True)
    if args.sweep:
        _sweep(dev, emit)
    emit(ok=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
