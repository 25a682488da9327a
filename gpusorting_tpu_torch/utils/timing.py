"""Batch-timing harness replicating the reference's benchmark rules, timed
with CUDA events.

Port of `gpusorting_tpu/utils/timing.py`.  Reference rules (BASELINE.md;
GPUSortBase.h:205-235, OneSweepDispatcher.cuh:193-239):
  - one warm-up iteration, excluded from the average
  - input regenerated on the device every iteration from seed (i + seed)
  - only the sort is timed: a CUDA event pair brackets it, not the input
    generation or any readback.
The JAX package's in-jit chained loop (a workaround for its TPU attachment's
unreliable sync) is not needed here.  Timing is a device measurement: it
raises where the device is not a CUDA card.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

from ..core import prng
from ..core.config import EntropyPreset


def _require_cuda(device) -> torch.device:
    dev = prng.require_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"timing needs a CUDA device, got {dev}")
    return dev


def card_line() -> str | None:
    """The first card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them, or None
    where nvidia-smi is absent or fails.  A card may run below its
    maximum power, and slower under load, so a measurement keeps this
    beside it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0] if lines else None


def device_time_ms(fn, iters: int = 5, warmup: int = 1,
                   device: torch.device | str = "cuda") -> list[float]:
    """Per-call device times (ms) of `fn()` on fixed inputs, each call
    bracketed by a CUDA event pair on the current stream; `warmup` calls
    run first and are not kept."""
    dev = _require_cuda(device)
    times = []
    with torch.cuda.device(dev):
        for i in range(warmup + iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            del out
            if i >= warmup:
                times.append(start.elapsed_time(end))
    return times


def queued_device_time_ms(fn, iters: int = 100, warmup: int = 3,
                          spin_cycles: int = 100_000_000,
                          device: torch.device | str = "cuda") -> float:
    """Device time (ms) per call of `fn()`: `iters` calls queued behind a
    `torch.cuda._sleep` spin of `spin_cycles` clocks, so the event pair
    brackets the device's work and not the host's time to issue it (the
    spin must outlast the host's `iters` calls; 10^8 clocks is about 50 ms
    at 2 GHz)."""
    dev = _require_cuda(device)
    with torch.cuda.device(dev):
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / iters


def host_time_ms(fn, iters: int = 1000, warmup: int = 3,
                 device: torch.device | str = "cuda") -> float:
    """Host time (ms) per call of `fn()`: `time.perf_counter` over `iters`
    calls with the device idle before them; the device finishes after the
    clock stops."""
    dev = _require_cuda(device)
    with torch.cuda.device(dev):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize(dev)
    return (t1 - t0) / iters * 1e3


def batch_timing(sort_fn, n: int, batch: int = 10, seed: int = 10,
                 entropy: EntropyPreset = EntropyPreset.E100,
                 repeats: int = 1,
                 key_dtype: torch.dtype = torch.uint32,
                 device: torch.device | str = "cuda") -> dict:
    """Time `sort_fn(keys)` per the reference harness rules: one warm-up,
    then `repeats` timed chains of `batch` sorts, each sort bracketed by a
    CUDA event pair; keys are `key_dtype` from `prng.make_test_keys(n,
    i + seed)` on the device, i = 0 the warm-up and i = 1, 2, ... the
    timed sorts in order.

    As in the JAX package, `seconds_per_sort` is the mean of the chains'
    per-sort means and the spread is their min and max, so a spread
    compares chains, not single sorts (`batch=1, repeats=k` spreads k
    single sorts).  Returns {"seconds_per_sort", "keys_per_sec", "n",
    "batch" (batch * repeats sorts timed), "repeats", "spread_min_s",
    "spread_max_s", "total_seconds", "device"}."""
    dev = _require_cuda(device)
    repeats = max(1, repeats)
    per_sort = []
    wall0 = time.perf_counter()
    with torch.cuda.device(dev):
        for i in range(batch * repeats + 1):
            keys = prng.make_test_keys(n, i + seed, key_dtype, entropy,
                                       device=dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = sort_fn(keys)
            end.record()
            end.synchronize()
            del out, keys
            if i > 0:   # the warm-up iteration is excluded
                per_sort.append(start.elapsed_time(end) / 1e3)
    chains = [statistics.fmean(per_sort[r * batch:(r + 1) * batch])
              for r in range(repeats)]
    mean = statistics.fmean(chains)
    return {
        "seconds_per_sort": mean,
        "keys_per_sec": n / mean,
        "n": n,
        "batch": batch * repeats,
        "repeats": repeats,
        "spread_min_s": min(chains),
        "spread_max_s": max(chains),
        "total_seconds": time.perf_counter() - wall0,
        "device": torch.cuda.get_device_name(dev),
    }
