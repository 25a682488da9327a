#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gpusorting_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs a CUDA card; exits non-zero, printing no result, without one or
outside a checkout of the repository.  Phases, each fatal on failure:

  0. build every kernel from csrc/ (one nvcc per source, all at once), each
     timed on its own `build` line;
  1. hold the range exchange's relocate kernel (method="dma") bit for bit
     against its plain PyTorch version (method="gather") on the card, for 1
     and 4 planes, at n = 2^28 with L = 2^21 (K = 128), on uniform, E020
     and all-equal keys;
  2. the range-exchange path at n = 2^28 through the public entry points
     under Backend.AUTO, the route forced by a routing override (the
     card's measured row sends 2^28 to the flat sort): sort on uint32 /
     int32 / float32 keys (the floats with NaN, +-0 and +-inf injected),
     sort_pairs with a uint32 and with an int64 payload, and argsort, each
     ascending and descending.  Every output is held bit for bit against
     flat torch.sort(stable=True) over the same codes, pairs also against
     the payload == key stability oracle; the relocate launch count shows
     each went through the kernel;
  3. AUTO with no override at 2^28 for keys, pairs, 64-bit pairs and
     argsort: the route auto_engine picks on the installed row (argsort's
     off rangesweep is sort_pairs' with a 32-bit payload), bit for bit
     against the flat sort, relocate launched only on a rangesweep route
     and radix256 (5 launches of `sort` or `sort_pairs`, the keys' count
     on the kernels line) only on a radix256 route; then times with CUDA events (utils/timing.py): end to end for AUTO on
     the installed row, AUTO forced onto rangesweep and the flat
     torch.sort route, per phase of the engine, and the relocate kernel
     beside its bound and its plain version, for keys, pairs and argsort;
  4. the radix kernels against their plain versions at n = 2^28, on
     uniform, E020 and all-equal keys, at both engines' shapes: the card's
     tuning tile for device_radix (exclusive_scan on the pass's 16*T
     counts) and FFX's fixed tile (exclusive_scan on its 16*B block sums,
     the downsweep by the table its ScanAdd builds): tile_histogram4 at
     all 8 shifts, and one downsweep pass on 1, 2 and 3 planes at shifts 0
     and 28, each bit for bit; exclusive_scan also on a 2^24 vector and on
     a 2^20 vector over the whole int32 range (its sums wrap);
  5. the Backend.PALLAS path at n = 2^28 through the public entry points,
     for variant="device_radix" and variant="ffx": sort on uint32 / int32 /
     float32 keys, sort_pairs with a uint32 and an int64 payload, and
     argsort, each ascending and descending, held like phase 2; every call
     must show 8 tile_histogram4, 8 exclusive_scan (one chained-scan
     launch per scan) and 8 downsweep launches; then one
     DeviceRadixSort(backend=PALLAS) sort;
  6. times: the PALLAS routes end to end beside flat torch.sort, and each
     radix kernel at the main path's shapes beside its bound, its plain
     version and the one torch call that computes the same function; for
     the scan and torch.cumsum also the device time (calls queued behind a
     spin, so the events bracket device work only) and the host time a
     call;
  7. the radix16 and network kernels against their plain versions at
     n = 2^28, on uniform, E020 and all-equal keys, each bit for bit:
     global_histogram (also on a length that is not a multiple of 128);
     binning_pass on 1, 2 and 3 planes at shifts 0 and 28 with its
     cursors_out, fused and as the adversarial_segments chain, at tiles of
     1, 3, 32 and 512 rows (the kernel cuts a range into partitions of its
     own, so the 3-row range and the 1-row segments end in ragged ones),
     also on two-digit keys, and 4 passes back to back on one stream and 2
     on a second stream; local_stages (the whole in-tile schedule and one
     tail schedule) on 1 plane (1 key), 2 planes (2 keys), 3 planes (2
     keys) and 4 planes (2 keys), each at its tile, on 2 planes (1 key) with a tie-heavy key
     plane and a distinct rider, and at an 8-row tile; global_stage at
     strides of one and of four tiles (1, 3 and 4 planes);
  8. the Backend.PALLAS path at n = 2^28 for the variants this adds:
     "onesweep" (the default) and "radix16" on every key type and order,
     both payload widths, sort_pairs_wide and argsort, "forward_sweep" and
     "emulated_deadlocking" on keys and pairs, each held like phase 2 and
     each call's launches of the five kernels asserted (the network's
     (L - t + 1) in-tile passes and, for each level above the tile, its
     `mergesweep.level_trips` hyper trips and no global stage, radix16's
     one histogram and one binning pass per pass that is not skipped, per
     segment when segmented); then one sort each through OneSweep,
     ForwardSweep and EmulatedDeadlocking;
  9. times: the new variants, device_radix and ffx end to end beside flat
     torch.sort, and each new kernel beside its bound, its plain version
     and the one torch call that computes the same function, if any; the
     in-tile pass and a tail on 1 plane and on 3 planes (2 keys); the
     strides above the tile of a keys sort (1 plane) and of a pairs sort
     (3 planes, 2 keys), every level to 2^28, as hyper trips and as one
     global stage a stride (the switch off), in turns, each form's
     launches a sort read from the counters around its timed calls;
 10. compact and expand (csrc/stitch.cu) against their plain versions at
     n = 2^28 on 1, 2 and 3 planes, bit for bit, under masks with none, all,
     half and 1/64 set and an interval mask of random segments; expand
     also from a stream shorter than the mask; then odd-offset views: a
     half-set mask at byte offsets 1, 7 and 13 of a longer buffer, 1-4
     planes each at its own element offset 1-3 (plane 0 of 4 values, so
     ties show the ranks' order), expand from streams at other offsets,
     as long as the mask and shorter than the set count;
 11. the segmented sort through the public entry points, each output held
     bit for bit against flat_sort.segmented_sort_pairs (the composite
     oracle), pairs also against the payload == key oracle: (a) the
     reference's matrix, 2^22 keys in random segments of at most 2^2 ..
     2^18 (u32 pairs, a float64 payload as lo/hi planes, i32 and f32 keys
     with NaN and +-0; bits_to_sort 4/8/16/24 at 2^10); (b) fixed lengths
     32, 4096, 2^18; (c) a length-class split at 2^26 (1 compact and 1
     expand a call); (d) a multi-class plan at 2^26 (3 and 3); (e)
     strategy="packed", a SplitSorter and a make_segsort_fn.  (a), (c)
     and (d) run on the card's row (which sends them to the composite)
     and, where that routes them elsewhere, again under the segmented
     fields of the JAX package's row forced by a routing override, which
     reaches the window routes, the split and the multi-class plan;
 12. times: each layout of 11(a)-(d), on each row it ran on, end to end
     with and without a prebuilt plan beside the oracle; compact and expand at 2^28 beside
     their bounds, plain versions and the torch calls computing the same
     function; and each stitch call of layouts (c) and (d) at its shape,
     each held bit for bit against its plain version on the same operands;
 13. the merge kernels (merge_tail, the in-tile kernel of csrc/bitonic.cu
     on the tail's schedule; hyper_stage, csrc/mergesweep.cu) and the
     binning pass's digit-plane form against their plain versions at
     n = 2^28, on
     uniform, E020 and all-equal keys, bit for bit: merge_tail on 1 plane
     (1 key), 3 planes (2 keys: pairs and argsort) and 4 planes (2 keys)
     at k below the tile, twice the tile and 2^28, each at its tile;
     hyper_stage on the same planes at every trip of the network's levels
     above the tile (its whole schedule: 14 trips on 1 plane, 17 on 3,
     20 on 4), and on uniform keys also on a key plane of 16 values with
     a distinct rider (2 planes, 1 key); binning_pass(digits=) on 1, 2
     and 3 planes into 16
     row-aligned regions, uniform and skewed bucket planes, with its
     cursors_out;
 14. Backend.PALLAS at n = 2^28 for variant="splitsweep" and
     "mergesweep": every key type and order, both payload widths,
     sort_pairs_wide and argsort, each held like phase 2, and mergesweep's
     keys and pairs again with the hyper switch off
     (GST_MERGESWEEP_HYPER=0); each call's launches asserted (splitsweep
     one digit-plane binning pass and one compact, so no fallback;
     mergesweep log2(N/L) merge tails and the high strides' hyper trips,
     `level_trips`, and no global stage, or with the switch off one
     global stage a stride and no trip); then a splitsweep keys, pairs and
     64-bit pairs call record their digit-plane pass and compact, each
     held bit for bit against its plain version on the same operands and
     timed;
 15. times: the two variants end to end (mergesweep also with the hyper
     switch off) beside radix16, device_radix and flat torch.sort;
     mergesweep's keys and pairs at segment lengths 2^20 .. 2^27 with the
     switch off and on, and at 2^28 (one segment: the flat sort); each new
     kernel beside its bound and its plain version, the merge tail on 1
     plane and on 3 planes (2 keys) beside local_stages on the same
     strides, the first hyper trip of the 2^28 level on 1 plane and on 3
     planes (2 keys) beside its byte bound and the shared-memory bytes
     its transposes move by the design's count (not measured; they stay
     off the kernels line);
 16. the distributed sort's masking kernel (csrc/exchange_mask.cu) against
     its plain version at one rank's receive buffer in an 8-GPU sort of
     2^30 pairs (D = 8 blocks of 2^25), on 2 and 3 operands, under uniform
     (near 2^24), zero, full, truncated (> cap) and mixed counts, as whole
     blocks, 4 chunk windows, single sources and 5 windows whose rows
     start at odd 4-byte offsets, bit for bit; then timed beside its bound
     (the tail written once), its plain version and masked_fill_, and with
     every slot masked (counts 0) beside its bound;
 17. the distributed sort at one NCCL rank in this process at n = 2^28
     through gstt.distributed_sort on both transports: u32 keys, u32 pairs,
     f32 keys with specials, all-equal pairs, max-code keys (the default
     ladder), and a fixed 2^20 cap that must report its overflow, and
     distributed_sort_gather's retry; each held bit for bit against flat
     stable torch.sort (prefix) with the sentinel and zero tail, and the
     masking launches asserted (the chunk count, or D); then times end to
     end beside the flat sort, and per step (sample and splitters, cell
     counts, local sort, pack, exchange, the composite merge and
     merge_runs, two launches a call, counted); the masking
     kernel timed at the path's shapes, the last chunk of the cap n + 2^20
     call (a 2^20-slot tail) and a 2^26-slot chunk with no tail, each as
     one call between events and as calls queued behind a spin (the card's
     time alone), the tail chunk also beside masked_fill_ per plane with
     the mask built in the call, timed both ways;
 18. four gloo ranks on the one card (2^26 global u32 pairs, the
     collective exchange on CUDA tensors), each rank's blocks held bit for
     bit against the same group's CPU run; remote_dma's refusal recorded;
 19. the row form of the reduce-then-scan pass (GST_MEGACORE=1) at
     n = 2^28: downsweep_rows (its outputs and the side rows rowtab marks
     present) and edge_fixup against their plain versions, bit for bit, on
     uniform, E020, all-equal and a sparse-digit input (three or more side
     entries name one row), 1, 2 and 3 planes, shifts 0 and 28, at the
     "h100" keys tile and at one other (128 rows, or 32 where the tile
     is 128), the fixed planes also against the element-form downsweep; then, with GST_MEGACORE=1 set for the phase
     and restored after it, device_radix sort on uint32 / int32 / float32
     keys, sort_pairs, sort_pairs_wide and argsort, each ascending and
     descending, and one DeviceRadixSort sort, held like phase 2, each call
     through 8 downsweep_rows and 8 edge_fixup launches and no element
     downsweep; end to end keys, pairs and argsort with the gate on and
     off; both kernels timed at both tiles on 1-3 planes on uniform, E020
     and sparse-digit keys beside their byte bounds, on uniform keys also
     beside the element form, the pass's bound and their plain versions
     (the parent's build beside them: probes/torch_row_form_probe.py);
 20. the console driver (`python -m gpusorting_tpu_torch`) through its
     main() in this process, every kernel count zeroed before it and read
     after it: info (generation "h100"), test for onesweep and
     device_radix on PALLAS with a 2^22 large size, supertest, bench at
     2^28 (its line carries the card), segsort at 2^22, dist over 4 gloo
     ranks on the card at 2^24, autotune on rts and radix16 at 2^24,
     --routing at 2^22 and --rangesweep at 2^26, each command's seconds,
     output (the sweeps) and launches on a line; then the bench script,
     AUTO and --flat, each in a process of its own, as `python -m
     gpusorting_tpu_torch.bench` from the root and by its path from
     another directory: exactly one line, 4 chains of 5 sorts (batch 20),
     `backend_native_kernels` as `ops/radix.is_native` reads the card's
     row; the tuning and routing rows read as before and no override is
     left installed;
 21. the host runtime in C++ (gpusorting_tpu_torch/native/), built with
     g++ on the card's host: available() must hold; fill_hybrid_taus at
     2^24 bit for bit against prng.hybrid_taus_bits on the card, and
     radix_sort / radix_sort_pairs at 2^22 against the flat stable
     torch.sort of the same codes on the card; a CUDA tensor refused;
 22. the entry script (gpusorting_tpu_torch/entry.py): entry()'s step, a
     stable u32 pairs sort at 2^16, bit for bit against the flat stable
     torch.sort; dryrun_multichip(1), one NCCL rank, all five checks of
     the JAX dry run; dryrun_multichip(4), four gloo ranks sharing the
     card, remote_dma named as refused; each with its seconds;
 23. the 8-bit-digit radix sort (ops/radix256.py, AUTO's keys-only and
     32-bit-payload pairs route on the card's row; `radix256_phase`): its
     kernels against their plain version, bit for bit, on u32, i32 and f32
     keys at 1, 2, 3, around its partition, a ragged 2^20 + 3 (also 4
     bytes past a 16-byte line) and 2^28, on uniform, E020, all-equal and
     single-digit keys, 5 launches a sort; AUTO both orders against the
     flat sort with no readback; then its time at 2^28, the upsweep's and
     each pass's (a torch.profiler trace) beside their byte bounds,
     radix16, the flat sort, AUTO, the plain version and
     `torch.sort(codes).values`.  The same for the pairs form with u32,
     i32 and f32 payloads (NaN patterns among them), also against
     `torch.sort(stable=True)` and the gather, AUTO's sort_pairs and
     argsort with no readback, its times beside the flat pairs route and
     `torch.sort(codes, stable=True)` with the gather;
 24. the segmented sort's shared-memory tile (segsort/segtile.py, the tile
     route of the card's row; `segtile_phase`) at both segmented cells'
     layouts at 2^26 (u32 pairs in segments of 1-4096; 16-bit keys with a
     64-bit payload in segments of 1-8192): the kernel against its plain
     version and the composite oracle, one launch; split_sort_pairs on the
     installed row through the tile route (no window plan), bit for bit;
     then the kernel's time beside its byte bound, the plain version, the
     oracle's composite, split_sort_pairs on the row and with the route
     off.

 25. the distributed sort's merge (parallel/dist_merge.py;
     `dist_merge_phase`) at the 4-card cell's shape: the runs ranks 0 and
     3 of 4 receive from 4 shards of 2^28 Zipf(1.3) pairs, built by the
     path's own steps (rank 0's all of key 1), the kernel against its
     plain version (`merge_plain` of every slot with the padding, the
     parent's path), bit for bit; then the two timed in turns, the
     kernel's two launches from a trace, beside the byte bound.

Every JSON line carries the card's name and power limit as nvidia-smi gives
them.  The line before the last lists the kernels; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

N = 1 << 28
L = 1 << 21
# float32 outside the tensor cores, the H100 SXM data sheet's 32-bit
# non-tensor rate (op/s), the peak for the network's 32-bit compares
PEAK_OPS_32 = 67e12
LANES = 128
SEED = 2024


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def _phase18_rank(rank: int, world: int, n: int, seed: int) -> dict:
    """One of phase 18's ranks on cuda:0: its shard of n u32 pairs sorted
    by the gloo group on the CPU and on the card, the blocks compared."""
    import torch

    import gpusorting_tpu_torch as gstt
    from gpusorting_tpu_torch.core import prng

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    n_local = n // world
    sl = slice(rank * n_local, (rank + 1) * n_local)
    keys = prng.make_test_keys(n, seed, device=dev).view(torch.int32)[sl]
    keys = keys.view(torch.uint32)
    vals = torch.arange(n, dtype=torch.int32, device=dev)[sl]
    t0 = time.perf_counter()
    cpu = gstt.distributed_sort(keys.cpu(), vals.cpu())
    cpu_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    card = gstt.distributed_sort(keys, vals)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    same = all(
        torch.equal(cpu[f].view(torch.int32), card[f].view(torch.int32).cpu())
        for f in ("codes", "global_index", "payload_bits")) and all(
        int(cpu[f]) == int(card[f]) for f in ("count", "overflow", "cap"))
    try:
        gstt.distributed_sort(keys, vals, exchange="remote_dma")
        remote_dma = "ran"
    except ValueError as e:
        remote_dma = f"ValueError: {e}"
    return {"bit_exact": same, "count": int(card["count"]),
            "cap": card["cap"], "cpu_s": cpu_s, "card_s": card_s,
            "remote_dma": remote_dma}


def _kernel_ms(prof, names: tuple, per_call: int) -> list:
    """Device ms of each of the `per_call` kernels of one call, in launch
    order, averaged over the calls a stopped torch.profiler recorded;
    kernels are counted where their name holds one of `names`, the first
    call from the first kernel named by names[0].  None where the trace has
    no such kernels (no device activity recorded)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    ks = sorted((float(e["ts"]), float(e["dur"]), e.get("name", ""))
                for e in events if e.get("cat") == "kernel"
                and any(m in e.get("name", "") for m in names))
    # a call starts with a kernel named by names[0]: the trace may lose the
    # first kernels it sees
    first = next((i for i, k in enumerate(ks) if names[0] in k[2]), len(ks))
    ks = ks[first:]
    calls = len(ks) // per_call
    if not calls:
        return None
    return [statistics.fmean(ks[c * per_call + i][1] for c in range(calls))
            / 1e3 for i in range(per_call)]


def radix256_phase(dev, emit, n: int = N, pairs: bool = True) -> dict:
    """Phase 23: the 8-bit-digit radix sort (ops/radix256.py,
    csrc/binning256.cu) against its plain version on the card, bit for bit:
    u32, i32 and f32 keys (NaN, +-0, +-inf injected) at 1, 2, 3, around
    the partition, a ragged 2^20 + 3 and n, from an input 4 bytes off a
    16-byte line, on uniform, E020, all-equal and single-digit keys (one
    digit takes every key in passes 1-3); 5 launches a sort; AUTO on the
    installed row, both orders, against the flat sort, with no readback
    under set_sync_debug_mode("error") where the row routes n to it.  Then
    times at n: the sort and each of its 5 kernels (a torch.profiler trace
    of 10 sorts) beside their byte bounds, radix16, the flat sort, AUTO,
    the plain version and `torch.sort(codes).values`.

    `pairs` does the same for the pairs form (`sort_pairs`, a u32, i32 or
    f32 payload with NaN patterns beside each key type), also against the
    flat route (`torch.sort(stable=True)`, then the gather) and, on AUTO,
    for sort_pairs and argsort; its times at n beside the flat route and
    `torch.sort(codes, stable=True)` with the gather.  Returns the keys'
    times."""
    import torch

    import gpusorting_tpu_torch as gstt
    from gpusorting_tpu_torch.core import codec, prng
    from gpusorting_tpu_torch.ops import _nvcc, flat_sort, radix256
    from gpusorting_tpu_torch.utils import timing

    info = gstt.get_device_info(dev)
    bw = info.hbm_gbps * 1e9
    installed = gstt.get_routing_parameters(info)

    def med(fn, iters=10):
        return statistics.median(timing.device_time_ms(fn, iters=iters,
                                                       device=dev))

    def same(a, b) -> bool:
        return a.dtype == b.dtype and torch.equal(a.view(torch.int32),
                                                  b.view(torch.int32))

    def keys_of(kind, size, dtype=torch.uint32, seed=SEED + 23):
        if kind == "E020":
            x = prng.make_test_keys(size, seed, dtype,
                                    gstt.EntropyPreset.E020, device=dev)
        else:
            x = prng.make_test_keys(size, seed, dtype, device=dev)
        raw = x.view(torch.int32)
        if kind == "all_equal":
            raw.fill_(0x1234ABCD)
        elif kind == "single_digit":      # one digit in passes 1-3
            raw.bitwise_and_(0xFF).bitwise_or_(0x5A3C1E00)
        if dtype == torch.float32:
            sp = torch.tensor([0x7FC00000, 0xFFC00001, 0, 0x80000000,
                               0x7F800000, 0xFF800000, 0x7FFFFFFF,
                               0xFFFFFFFF], dtype=torch.int64, device=dev)
            sp = ((sp ^ 0x80000000) - 0x80000000).to(torch.int32)
            pos = torch.arange(0, size, 997, device=dev)
            raw[pos] = sp[pos % sp.numel()]
        return x

    def values_of(size, dtype):
        """distinct payload words, every other one a NaN pattern as f32"""
        idx = torch.arange(size, dtype=torch.int32, device=dev)
        return torch.where(idx % 2 == 1, idx | 0x7F800000, idx).view(dtype)

    def off_line(x):        # the same values 4 bytes past a 16-byte line
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        buf[1:].copy_(x)
        return buf[1:]

    lib = _nvcc.load(radix256.SOURCE)
    part = lib.gst_radix256_partition()
    ppart = lib.gst_radix256_pairs_partition()
    dtypes = (torch.uint32, torch.int32, torch.float32)
    sizes = (1, 2, 3, part - 1, part, part + 1, (1 << 20) + 3, n)
    psizes = (1, 2, 3, ppart - 1, ppart, ppart + 1, (1 << 20) + 3, n)

    def kinds(size):
        return (("uniform", "E020", "all_equal", "single_digit")
                if size in (n, (1 << 20) + 3) else ("uniform",))

    checked = []
    for dtype in dtypes:
        for size in sizes:
            for kind in kinds(size):
                x = keys_of(kind, size, dtype)
                for off in ((0, 1) if size == (1 << 20) + 3 else (0,)):
                    if off:
                        x = off_line(x)
                    before = radix256.sort.launches
                    got = radix256.sort(x)
                    torch.cuda.synchronize()
                    _require(radix256.sort.launches - before == 5,
                             "radix256: not 5 launches a sort")
                    _require(same(got, radix256.sort_plain(x)),
                             f"radix256 {dtype} n={size} {kind} "
                             f"off={off} != its plain version")
                    _require(same(got, flat_sort.sort_keys(x)),
                             f"radix256 {dtype} n={size} {kind} != the "
                             "flat sort")
                    checked.append([str(dtype), size, kind, off])
                del x, got
            torch.cuda.empty_cache()
    route = gstt.auto_engine(n, info=info)
    x = keys_of("uniform", n, torch.float32)
    for order in (gstt.Order.ASCENDING, gstt.Order.DESCENDING):
        before = radix256.sort.launches
        if route == "radix256":
            torch.cuda.set_sync_debug_mode("error")
        try:
            got = gstt.sort(x, order=order)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        _require(same(got, flat_sort.sort_keys(x, order=order)),
                 f"AUTO {order.value} at {n} ({route}) != the flat sort")
        _require((radix256.sort.launches - before == 5)
                 == (route == "radix256"), f"AUTO at {n}: route {route}")
    del x, got
    emit(phase="radix256_vs_plain", partition=part, checked=checked,
         auto_route=route, radix256_min=installed.radix256_min,
         bit_exact=True)

    # times at n
    x = prng.make_test_keys(n, SEED + 24, device=dev)
    codes = codec.encode_biased(x)
    rec = {"n": n, "partition": part, "bound_ms": 8 * n / bw * 1e3,
           "upsweep_bound_ms": 4 * n / bw * 1e3,
           "sort_bound_ms": 4 * 8 * n / bw * 1e3}
    rec["ms"] = med(lambda: radix256.sort(x))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            radix256.sort(x)
        torch.cuda.synchronize()
    per = _kernel_ms(prof, ("upsweep", "binning"), 5)
    rec["upsweep_ms"] = per and per[0]
    rec["pass_ms"] = per and per[1:]
    for name, fn in (
            ("radix16_ms", lambda: gstt.sort(
                x, backend=gstt.Backend.PALLAS, variant="radix16")),
            ("flat_ms", lambda: gstt.sort(x, backend=gstt.Backend.XLA)),
            ("auto_ms", lambda: gstt.sort(x)),
            ("library_ms", lambda: torch.sort(codes).values),
            ("ms_2", lambda: radix256.sort(x))):
        rec[name] = med(fn)
    rec["plain_ms"] = med(lambda: radix256.sort_plain(x), iters=1)
    for kind in ("E020", "all_equal"):
        y = keys_of(kind, n, seed=SEED + 25)
        rec[f"ms_{kind}"] = med(lambda: radix256.sort(y))
        del y
    del x, codes
    torch.cuda.empty_cache()
    emit(phase="radix256_times", **rec)
    if not pairs:
        return rec

    # the pairs form: each key type with each payload type at the small
    # sizes, and with one payload type (rotating) at 2^20 + 3 and n
    checked = []
    for i, dtype in enumerate(dtypes):
        for size in psizes:
            big = size in (n, (1 << 20) + 3)
            for vtype in (dtypes[i],) if big else dtypes:
                v0 = values_of(size, vtype)
                for kind in kinds(size):
                    x, v = keys_of(kind, size, dtype), v0
                    for off in ((0, 1) if size == (1 << 20) + 3 else (0,)):
                        if off:
                            x, v = off_line(x), off_line(v)
                        before = radix256.sort_pairs.launches
                        gk, gv = radix256.sort_pairs(x, v)
                        torch.cuda.synchronize()
                        _require(radix256.sort_pairs.launches - before == 5,
                                 "radix256: not 5 launches a pairs sort")
                        pk, pv = radix256.sort_pairs_plain(x, v)
                        _require(same(gk, pk) and same(gv, pv),
                                 f"radix256 pairs {dtype}/{vtype} n={size} "
                                 f"{kind} off={off} != its plain version")
                        del pk, pv
                        fk, fv = flat_sort.sort_pairs(x, v)
                        _require(same(gk, fk) and same(gv, fv),
                                 f"radix256 pairs {dtype}/{vtype} n={size} "
                                 f"{kind} != torch.sort and the gather")
                        checked.append([str(dtype), str(vtype), size, kind,
                                        off])
                        del gk, gv, fk, fv
                    del x, v
                del v0
                torch.cuda.empty_cache()
    route = gstt.auto_engine(n, gstt.Mode.PAIRS, info=info)
    x = keys_of("uniform", n, torch.float32)
    v = values_of(n, torch.uint32)
    for order in (gstt.Order.ASCENDING, gstt.Order.DESCENDING):
        for what, call, flat in (
                ("sort_pairs", lambda: gstt.sort_pairs(x, v, order=order),
                 lambda: flat_sort.sort_pairs(x, v, order=order)),
                ("argsort", lambda: gstt.argsort(x, order=order,
                                                 return_keys=True),
                 lambda: gstt.argsort(x, order=order, return_keys=True,
                                      backend=gstt.Backend.XLA))):
            before = radix256.sort_pairs.launches
            if route == "radix256":
                torch.cuda.set_sync_debug_mode("error")
            try:
                got = call()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            _require(all(same(g, w) for g, w in zip(got, flat())),
                     f"AUTO {what} {order.value} at {n} ({route}) != the "
                     "flat route")
            _require((radix256.sort_pairs.launches - before == 5)
                     == (route == "radix256"),
                     f"AUTO {what} at {n}: route {route}")
            del got
    del x, v
    emit(phase="radix256_pairs_vs_plain", partition=ppart, checked=checked,
         auto_route=route, radix256_min_pairs=installed.radix256_min_pairs,
         bit_exact=True)

    # times at n
    x = prng.make_test_keys(n, SEED + 26, device=dev)
    v = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)
    codes = codec.encode_biased(x)
    vbits = v.view(torch.int32)

    def library():
        sc, perm = torch.sort(codes, stable=True)
        return sc, vbits[perm]

    prec = {"n": n, "partition": ppart, "bound_ms": 16 * n / bw * 1e3,
            "upsweep_bound_ms": 4 * n / bw * 1e3,
            "sort_bound_ms": 4 * 16 * n / bw * 1e3}
    prec["ms"] = med(lambda: radix256.sort_pairs(x, v))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            radix256.sort_pairs(x, v)
        torch.cuda.synchronize()
    per = _kernel_ms(prof, ("upsweep", "binning"), 5)
    prec["upsweep_ms"] = per and per[0]
    prec["pass_ms"] = per and per[1:]
    for name, fn in (
            ("flat_ms", lambda: gstt.sort_pairs(x, v,
                                                backend=gstt.Backend.XLA)),
            ("auto_ms", lambda: gstt.sort_pairs(x, v)),
            ("library_ms", library),
            ("keys_ms", lambda: radix256.sort(x)),
            ("ms_2", lambda: radix256.sort_pairs(x, v))):
        prec[name] = med(fn)
    prec["plain_ms"] = med(lambda: radix256.sort_pairs_plain(x, v), iters=1)
    for kind in ("E020", "all_equal"):
        y = keys_of(kind, n, seed=SEED + 27)
        prec[f"ms_{kind}"] = med(lambda: radix256.sort_pairs(y, v))
        del y
    del x, v, codes, vbits
    torch.cuda.empty_cache()
    emit(phase="radix256_pairs_times", **prec)
    return rec


def segtile_phase(dev, emit, n: int = 1 << 26) -> dict:
    """Phase 24: the segmented sort's shared-memory tile (segsort/segtile.py,
    csrc/segtile.cu) at the two segmented cells' layouts at n: (u32, u32)
    pairs in random segments of 1-4096 by all 32 bits, and 16-bit u32 keys
    with a 64-bit payload in segments of 1-8192 by 16 bits.  Each: the
    kernel bit for bit against its plain version and the composite oracle
    (flat_sort.segmented_sort_pairs), one launch; split_sort_pairs on the
    installed row, which must take the tile route (`engine.tile` once, no
    window plan, one launch) and give the oracle's bits.  Then times: the
    kernel (a torch.profiler trace of 10 calls, and events around each
    call), its byte bound, the plain version, `library` (the oracle: one
    stable torch.sort of the int64 (segment, code) composite and the
    gather), split_sort_pairs on the installed row, and with the tile
    route off (the composite route).  Returns {layout: times}."""
    import torch

    import gpusorting_tpu_torch as gstt
    from gpusorting_tpu_torch.core import prng
    from gpusorting_tpu_torch.ops import flat_sort
    from gpusorting_tpu_torch.segsort import segtile
    from gpusorting_tpu_torch.utils import timing, trace

    info = gstt.get_device_info(dev)
    bw = info.hbm_gbps * 1e9
    installed = gstt.get_routing_parameters(info)
    off_row = dataclasses.replace(installed, segsort_tile_max=0)

    def med(fn, iters=10):
        return statistics.median(timing.device_time_ms(fn, iters=iters,
                                                       device=dev))

    def same(a, b) -> bool:
        return a.dtype == b.dtype and torch.equal(
            a.view(torch.int32 if a.dtype.itemsize == 4 else torch.int64),
            b.view(torch.int32 if b.dtype.itemsize == 4 else torch.int64))

    out = {}
    for label, max_len, bits, wide in (("max4096_u32_pairs", 4096, 32, False),
                                       ("b16_max8192_u64_pairs", 8192, 16,
                                        True)):
        offs, S = prng.make_random_segments(n, max_len, SEED + max_len,
                                            device=dev)
        if wide:
            keys = prng.make_masked_random_values(n, bits, SEED + 31,
                                                  device=dev)
            vals = torch.arange(n, dtype=torch.int64, device=dev).view(
                torch.uint64)
        else:
            keys = prng.make_test_keys(n, SEED + 32, device=dev)
            vals = torch.arange(n, dtype=torch.int32, device=dev).view(
                torch.uint32)
        planes = (vals.view(torch.int64 if wide else torch.int32),)
        before = segtile.sort.launches
        gk, (gv,) = segtile.sort(offs, keys, planes, bits, max_len=max_len)
        torch.cuda.synchronize()
        _require(segtile.sort.launches - before == 1,
                 f"segtile {label}: not one launch")
        wk, (wv,) = segtile.sort_plain(offs, keys, planes, bits)
        _require(same(gk, wk) and same(gv, wv),
                 f"segtile {label} != its plain version")
        ok, ov = flat_sort.segmented_sort_pairs(offs, keys, vals, n)
        _require(same(gk, ok) and same(gv.view(vals.dtype), ov),
                 f"segtile {label} != the composite oracle")
        del wk, wv
        spans, before = trace.counts(), segtile.sort.launches
        ak, av = gstt.split_sort_pairs(offs, keys, vals, S, n, bits)
        torch.cuda.synchronize()
        after = trace.counts()
        moved = {k: after.get(k, 0) - spans.get(k, 0)
                 for k in ("engine.tile", "dispatch.window_plan",
                           "engine.composite")}
        tile_route = max_len <= installed.segsort_tile_max
        _require(moved == {"engine.tile": int(tile_route),
                           "dispatch.window_plan": int(not tile_route),
                           "engine.composite": int(not tile_route)},
                 f"split_sort_pairs {label}: spans {moved}")
        _require(segtile.sort.launches - before == int(tile_route),
                 f"split_sort_pairs {label}: segtile launches")
        _require(same(ak, ok) and same(av, ov),
                 f"split_sort_pairs {label} != the composite oracle")
        del ak, av, ok, ov, gk, gv
        torch.cuda.empty_cache()

        rec = {"layout": label, "n": n, "segments": S, "max_len": max_len,
               "bits_to_sort": bits, "payload_bytes": 8 if wide else 4,
               "tile": segtile.tile_for(max_len),
               "bound_ms": ((16 + (8 if wide else 0)) * n + 4 * S) / bw
               * 1e3, "bound_by": "bytes",
               "launches": 1, "route": "tile" if tile_route else "composite",
               "segsort_tile_max": installed.segsort_tile_max}
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                segtile.sort(offs, keys, planes, bits, max_len=max_len)
            torch.cuda.synchronize()
        per = _kernel_ms(prof, ("segtile",), 1)
        rec["ms"] = per and per[0]
        rec["call_ms"] = med(lambda: segtile.sort(offs, keys, planes, bits,
                                                  max_len=max_len))
        rec["plain_ms"] = med(lambda: segtile.sort_plain(offs, keys, planes,
                                                         bits), iters=2)
        rec["library_ms"] = med(lambda: flat_sort.segmented_sort_pairs(
            offs, keys, vals, n), iters=5)
        rec["library"] = ("flat_sort.segmented_sort_pairs: torch.sort("
                          "stable=True) of the int64 (segment, code) "
                          "composite, then the gather")
        rec["auto_ms"] = med(lambda: gstt.split_sort_pairs(
            offs, keys, vals, S, n, bits), iters=5)
        gstt.set_routing_override(off_row)
        try:
            rec["composite_route_ms"] = med(lambda: gstt.split_sort_pairs(
                offs, keys, vals, S, n, bits), iters=5)
        finally:
            gstt.clear_routing_override()
        emit(phase="segtile_times", **rec)
        out[label] = rec
        del offs, keys, vals, planes
        torch.cuda.empty_cache()
    return out


def dist_merge_phase(dev, emit, n_local: int = N, d: int = 4,
                     dests: tuple = (0, 3), rounds: int = 2) -> dict:
    """Phase 25: the distributed sort's merge (parallel/dist_merge.py,
    csrc/dist_merge.cu) at the `dist_u32_pairs.4chips` cell's shape on one
    card: the runs destination ranks `dests` receive from d sources of
    n_local Zipf(1.3) (u32, u32) pairs (keys in [1, 2^28 - 1], the payload
    the global position), built by the path's own steps (the global
    sample's splitters, cell counts, the stable local sort, each source's
    cell for the destination packed in 4 chunks of the ladder's rung and
    masked as the exchange masks it), so rc is a real call's.  Rank 0
    receives the Zipf head (key 1 is a quarter of the keys), the last rank
    the spread tail.  The kernel (two launches) against its plain version
    (`merge_plain` of every slot then the padding, the parent's path), bit
    for bit on all three planes and the fills; then, in turns, `rounds`
    times, the kernel and the plain version, each the median of
    its calls between CUDA events, and the kernel's two launches from a
    torch.profiler trace, beside the byte bound.  Returns {dest: times}."""
    import torch

    import gpusorting_tpu_torch as gstt
    from gpusorting_tpu_torch.core import codec
    from gpusorting_tpu_torch.parallel import dist_merge, dist_sort
    from gpusorting_tpu_torch.parallel import remote_exchange as rx
    from gpusorting_tpu_torch.utils import timing
    from sortbench import inputs

    info = gstt.get_device_info(dev)
    bw = info.hbm_gbps * 1e9
    n = n_local * d
    codes = [codec.encode_biased(inputs.zipf_keys(
        n_local, SEED + 25, 1.3, (1 << 28) - 1, device=dev,
        first=s * n_local)) for s in range(d)]
    stride = max(1, n // (d * 32))
    sample = torch.cat([c[(-(s * n_local)) % stride::stride]
                        for s, c in enumerate(codes)])
    sample_gidx = codec.wrap_int32(torch.arange(0, n, stride, device=dev))
    spl_c, spl_g = dist_sort._splitters_from_sample(sample, sample_gidx, d)
    counts = [dist_sort._cell_counts(c, dist_sort._gidx(s * n_local, n_local,
                                                        dev), spl_c, spl_g, d)
              for s, c in enumerate(codes)]
    caps = dist_sort._cap_ladder(n, d, dist_sort._default_max_skew(
        n, d, 3, info.hbm_bytes))
    top = int(torch.stack(counts).max())
    cap = caps[sum(top > c for c in caps[:-1])]
    _require(top <= cap, f"phase 25: a cell of {top} over the top rung")
    pad_to = d * caps[-1]
    chunks, cw = dist_sort._chunking(cap, 4)
    fills = (codec.SENTINEL, -1, 0)
    recv = {r: [torch.empty(chunks, d, cw, dtype=torch.int32, device=dev)
                for _ in fills] for r in dests}
    for s in range(d):
        gidx = dist_sort._gidx(s * n_local, n_local, dev)
        ops = dist_sort._local_sort(codes[s], gidx, gidx)
        codes[s] = None
        starts = torch.cumsum(counts[s], 0, dtype=torch.int64) - counts[s]
        pos = torch.arange(cap, device=dev)
        for r in dests:
            idx = (starts[r] + pos).clamp_(max=n_local - 1)
            for o, x in enumerate(ops):
                recv[r][o][:, s, :] = x[idx].view(chunks, cw)
        del ops, gidx
        torch.cuda.empty_cache()
    out = {}
    for r in dests:
        rc = torch.stack([c[r] for c in counts]).contiguous()
        for c in range(chunks):
            rx.mask_arrivals([x[c] for x in recv[r]], rc, fills,
                             col0=c * cw)
        planes = recv[r]
        total = int(rc.clamp(max=cap).sum())

        def kernel():
            return dist_merge.merge_runs(planes, rc, cap, pad_to, fills)

        def plain_path():
            m = dist_merge.merge_plain([x.view(-1) for x in planes])
            return [torch.cat([x, x.new_full((pad_to - x.shape[0],), f)])
                    for x, f in zip(m, fills)]

        before = dist_merge.merge_runs.launches
        got = kernel()
        torch.cuda.synchronize()
        _require(dist_merge.merge_runs.launches - before == 2,
                 "merge_runs: not two launches")
        diffs = [int((g != w).sum()) for g, w in zip(got, plain_path())]
        del got
        torch.cuda.empty_cache()
        _require(diffs == [0, 0, 0],
                 f"merge_runs dest {r}: slots differing from merge_plain "
                 f"with the padding {diffs}")
        emit(phase="kernel_vs_plain", kernel="merge_runs", dest=r, d=d,
             cap=cap, chunks=chunks, pad_to=pad_to, valid=total,
             rc=rc.tolist(), differences=diffs, bit_exact=True)

        turns = {"ms": [], "plain_ms": []}
        for _ in range(rounds):
            for key, fn, iters in (("ms", kernel, 10),
                                   ("plain_ms", plain_path, 3)):
                turns[key].append(statistics.median(timing.device_time_ms(
                    fn, iters=iters, device=dev)))
                torch.cuda.empty_cache()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                kernel()
            torch.cuda.synchronize()
        per = _kernel_ms(prof, ("merge_partition", "merge_tiles"), 2)
        rec = {"dest": r, "valid": total, "cap": cap, "pad_to": pad_to,
               "turns": turns,
               **{key: statistics.median(v) for key, v in turns.items()},
               "partition_ms": per and per[0], "tiles_ms": per and per[1],
               "device_ms": per and per[0] + per[1],
               "bound_ms": (12 * total + 12 * pad_to) / bw * 1e3,
               "bound_by": "bytes: 12 a valid element read, 12 an output "
                           "slot written",
               "library": "the plain version, the parent's path: "
                          "merge_plain of every slot (CUB's onesweep over "
                          "the int64 composite, the gather) then torch.cat "
                          "of the fills"}
        emit(phase="per_kernel", kernel="merge_runs", **rec)
        out[r] = rec
        del planes
        recv[r] = None
        torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2

    import numpy as np
    import torch.distributed as dist

    import gpusorting_tpu_torch as gstt
    from gpusorting_tpu_torch.core import codec, prng
    from gpusorting_tpu_torch.ops import (_nvcc, bitonic, ffx, flat_sort,
                                          kernels, mergesweep, radix16,
                                          radix256, relocate,
                                          rangesweep as rs, rts, splitsweep,
                                          stitch)
    from gpusorting_tpu_torch.parallel import dist_merge, dist_sort
    from gpusorting_tpu_torch.parallel import remote_exchange as rx
    from gpusorting_tpu_torch.parallel.launch import run_ranks
    from gpusorting_tpu_torch.segsort import segtile, splitsort
    from gpusorting_tpu_torch.utils import timing, validate

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = timing.card_line()
    _require(card is not None, "nvidia-smi reads no card")
    print(card, flush=True)
    info = gstt.get_device_info(dev)
    _require(info.hbm_gbps > 0,
             f"no memory rate known for {info.device_kind}")

    def emit(**rec) -> None:
        rec["card"] = card
        print(json.dumps(rec), flush=True)

    def free() -> None:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    def median_ms(fn, iters=5) -> float:
        return statistics.median(timing.device_time_ms(fn, iters=iters,
                                                       device=dev))

    K = -(-N // L)
    l_rows = L // LANES

    # ---- phase 0: build every kernel, one nvcc per source, all at once ----
    sources = (relocate.SOURCE, kernels.HIST_SOURCE, kernels.SCAN_SOURCE,
               rts.SOURCE, kernels.GLOBAL_HIST_SOURCE, radix16.SOURCE,
               bitonic.SOURCE, stitch.SOURCE, mergesweep.SOURCE, rx.SOURCE,
               rts.ROWS_SOURCE, rts.FIXUP_SOURCE, radix256.SOURCE,
               segtile.SOURCE, dist_merge.SOURCE)
    t0 = time.perf_counter()
    for src, secs in _nvcc.build_all(sources).items():
        emit(phase="build", seconds=secs,
             source=f"gpusorting_tpu_torch/csrc/{src.name}")
    emit(phase="build_all", seconds=time.perf_counter() - t0)

    # ---- phase 1: the relocate kernel against its plain version ----------
    max_abs_err = 0
    for name, entropy, equal in (("uniform", gstt.EntropyPreset.E100, False),
                                 ("E020", gstt.EntropyPreset.E020, False),
                                 ("all_equal", None, True)):
        if equal:
            x = torch.full((N,), 0x1234ABCD, dtype=torch.int32, device=dev)
        else:
            x = codec.encode_biased(prng.make_test_keys(
                N, SEED, torch.uint32, entropy, device=dev))
        x2 = rs._phase_sort_keys(x.view(K, L))
        bounds = rs._cuts(x2, K, L, heads=x2[:, ::LANES])
        extra = tuple(codec.encode_biased(prng.hybrid_taus_bits(
            N, SEED + j, device=dev)).view(K, L) for j in (1, 2, 3))
        for planes in ((x2,), (x2,) + extra):
            got = rs._range_exchange(planes, bounds, K, L, method="dma")
            want = rs._range_exchange(planes, bounds, K, L, method="gather")
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                max_abs_err = max(max_abs_err, err)
                _require(torch.equal(g, w),
                         f"relocate != plain on {name}, {len(planes)} planes")
            emit(phase="kernel_vs_plain", input=name, planes=len(planes),
                 n=N, K=K, L=L, bit_exact=True)
            del got, want
        del x, x2, extra, bounds
        free()

    # ---- phase 2: the main path through the public entry points ----------
    def oracle_perm(keys):
        return torch.sort(codec.encode_biased(keys), stable=True).indices

    def flip(t, order):
        return torch.flip(t, (0,)) if order == gstt.Order.DESCENDING else t

    def bits(t):
        # signed carrier view: torch's uint32 has no indexing or flip
        return t.view(torch.int32 if t.dtype.itemsize == 4 else torch.int64)

    def same_bits(out, src, perm, order) -> bool:
        """out == src permuted by the oracle, bit for bit."""
        return out.dtype == src.dtype and torch.equal(
            bits(out), flip(bits(src)[perm], order))

    specials = torch.tensor(
        [0x7FC00000, 0xFFC00000, 0x00000000, 0x80000000, 0x7F800000,
         0xFF800000], dtype=torch.int64, device=dev)
    specials = ((specials ^ 0x80000000) - 0x80000000).to(torch.int32)

    def f32_keys():
        k = prng.make_test_keys(N, SEED + 5, torch.float32, device=dev)
        pos = torch.arange(0, N, 9973, device=dev)
        k.view(torch.int32)[pos] = specials[pos % specials.numel()]
        return k

    orders = (gstt.Order.ASCENDING, gstt.Order.DESCENDING)
    # The card's row sends AUTO's 2^28 sorts to the flat sort in every mode
    # (core/config.py, measured); the range-exchange route and its relocate
    # kernel are driven through the same entry points with the route
    # forced by a routing override, from 2^28 up in every mode.
    installed_row = gstt.get_routing_parameters(info)
    rs_forced = dataclasses.replace(
        installed_row, rangesweep_min=N, rangesweep_min_pairs=N,
        rangesweep_min_pairs_wide=N, rangesweep_min_index=N)

    def forced(fn):
        def run(*a):
            gstt.set_routing_override(rs_forced)
            try:
                return fn(*a)
            finally:
                gstt.clear_routing_override()
        return run

    gstt.set_routing_override(rs_forced)
    runs = []
    relocate.relocate.launches = 0
    for kname, make, expect in (
            ("sort_u32", lambda: prng.make_test_keys(
                N, SEED + 4, torch.uint32, device=dev), 1),
            ("sort_i32", lambda: prng.make_test_keys(
                N, SEED + 6, torch.int32, gstt.EntropyPreset.E054,
                device=dev), 1),
            ("sort_f32", f32_keys, 1)):
        keys = make()
        perm = oracle_perm(keys)
        for order in orders:
            before = relocate.relocate.launches
            out = gstt.sort(keys, order=order)
            torch.cuda.synchronize()
            delta = relocate.relocate.launches - before
            _require(same_bits(out, keys, perm, order),
                     f"{kname} {order.value} != torch.sort")
            _require(delta == expect, f"{kname}: {delta} relocate launches")
            runs.append((kname, order.value, delta))
            del out
        del keys, perm
        free()

    for pname, pdtype, expect in (("sort_pairs_u32", torch.uint32, 3),
                                  ("sort_pairs_i64", torch.int64, 4)):
        keys, vals = prng.make_test_pairs(N, SEED + 7, torch.uint32, pdtype,
                                          gstt.EntropyPreset.E033,
                                          device=dev)
        perm = oracle_perm(keys)
        for order in orders:
            before = relocate.relocate.launches
            ok, ov = gstt.sort_pairs(keys, vals, order=order)
            torch.cuda.synchronize()
            delta = relocate.relocate.launches - before
            _require(same_bits(ok, keys, perm, order)
                     and same_bits(ov, vals, perm, order),
                     f"{pname} {order.value} != torch.sort")
            _require(int(validate.count_pair_violations(ok, ov, order)) == 0,
                     f"{pname} {order.value}: stability oracle violated")
            _require(delta == expect, f"{pname}: {delta} relocate launches")
            runs.append((pname, order.value, delta))
            del ok, ov
        del keys, vals, perm
        free()

    keys = prng.make_test_keys(N, SEED + 8, torch.uint32,
                               gstt.EntropyPreset.E081, device=dev)
    perm = oracle_perm(keys).to(torch.int32)
    for order in orders:
        before = relocate.relocate.launches
        out = gstt.argsort(keys, order=order)
        torch.cuda.synchronize()
        delta = relocate.relocate.launches - before
        _require(torch.equal(out, flip(perm, order)),
                 f"argsort {order.value} != torch.sort")
        _require(delta == 2, f"argsort: {delta} relocate launches")
        runs.append(("argsort", order.value, delta))
        del out
    del keys, perm
    free()
    main_path_launches = relocate.relocate.launches
    gstt.clear_routing_override()
    _require(main_path_launches > 0, "the main path never launched relocate")
    emit(phase="main_path", n=N, launches=main_path_launches,
         runs=[{"call": c, "order": o, "relocate_launches": d}
               for c, o, d in runs], bit_exact=True)

    # ---- phase 3: times --------------------------------------------------
    # AUTO under the installed row first: its route is auto_engine's for the
    # row in each mode, bit-exact with the flat sort, relocate launched only
    # where that route is rangesweep and radix256 (5 launches) only where it
    # is radix256; then AUTO timed with that route, with the forced
    # rangesweep route and with the flat sort
    bw = info.hbm_gbps * 1e9
    batch = 5
    payload = torch.arange(N, dtype=torch.int32, device=dev)
    lo64 = torch.arange(N, dtype=torch.int32, device=dev)
    hi64 = lo64 ^ 0x5A5A5A5A
    e2e = {}
    auto_runs = []
    for what, auto_fn, flat_fn, kw in (
            ("keys", lambda k: gstt.sort(k),
             lambda k: gstt.sort(k, backend=gstt.Backend.XLA), {}),
            ("pairs", lambda k: gstt.sort_pairs(k, payload),
             lambda k: gstt.sort_pairs(k, payload,
                                       backend=gstt.Backend.XLA),
             {"mode": gstt.Mode.PAIRS}),
            ("pairs_wide", lambda k: gstt.sort_pairs_wide(k, lo64, hi64),
             lambda k: gstt.sort_pairs_wide(k, lo64, hi64,
                                            backend=gstt.Backend.XLA),
             {"mode": gstt.Mode.PAIRS, "payload_bits": 64}),
            ("argsort", lambda k: gstt.argsort(k),
             lambda k: gstt.argsort(k, backend=gstt.Backend.XLA),
             {"mode": gstt.Mode.PAIRS, "index_payload": True})):
        route = gstt.auto_engine(N, info=info, **kw)
        if what == "argsort" and route == "xla":
            # off rangesweep, argsort runs sort_pairs with its int32 index
            route = gstt.auto_engine(N, mode=gstt.Mode.PAIRS, info=info)
        keys = prng.make_test_keys(N, SEED + 9, torch.uint32, device=dev)
        before = relocate.relocate.launches
        radix256.sort.launches = radix256.sort_pairs.launches = 0
        got = auto_fn(keys)
        torch.cuda.synchronize()
        reloc = relocate.relocate.launches - before
        r256 = radix256.sort.launches + radix256.sort_pairs.launches
        want = flat_fn(keys)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        _require(all(g.dtype == w.dtype and torch.equal(bits(g), bits(w))
                     for g, w in zip(got, want)),
                 f"AUTO {what} on the installed row ({route}) != the flat "
                 "sort")
        _require((reloc > 0) == (route == "rangesweep"),
                 f"AUTO {what}: route {route}, {reloc} relocate launches")
        _require(r256 == (5 if route == "radix256" else 0),
                 f"AUTO {what}: route {route}, {r256} radix256 launches")
        if what == "keys":
            r256_main_launches = r256
        auto_runs.append({"what": what, "route": route,
                          "relocate_launches": reloc,
                          "radix256_launches": r256})
        del keys, got, want
        free()
        res = {}
        for rname, fn in (("auto_installed", auto_fn),
                          ("auto_rangesweep", forced(auto_fn)),
                          ("flat_torch_sort", flat_fn),
                          ("auto_installed_2", auto_fn),
                          ("auto_rangesweep_2", forced(auto_fn)),
                          ("flat_torch_sort_2", flat_fn)):
            r = timing.batch_timing(fn, N, batch=1, repeats=batch,
                                    seed=SEED, device=dev)
            res[rname] = r["seconds_per_sort"] * 1e3
            emit(phase="end_to_end", what=what,
                 route=rname.replace("installed", route), n=N,
                 batch=batch, ms=r["seconds_per_sort"] * 1e3,
                 spread_ms=[r["spread_min_s"] * 1e3,
                            r["spread_max_s"] * 1e3],
                 keys_per_sec=r["keys_per_sec"])
            free()
        e2e[what] = res
    emit(phase="auto_installed_row", n=N, runs=auto_runs, bit_exact=True,
         row={k: getattr(installed_row, k) for k in (
             "rangesweep_min", "rangesweep_min_pairs",
             "rangesweep_min_pairs_wide", "rangesweep_min_index",
             "radix256_min", "radix256_min_pairs", "measured")})
    del payload, lo64, hi64
    free()

    relocate_ms = relocate_plain_ms = relocate_bound_ms = None
    for what in ("keys", "pairs", "argsort"):
        keys = codec.encode_biased(prng.make_test_keys(
            N, SEED, torch.uint32, device=dev))
        if what == "keys":
            x2 = rs._phase_sort_keys(keys.view(K, L))
            p1_ms = median_ms(lambda: rs._phase_sort_keys(keys.view(K, L)))
            planes = (x2,)
        else:
            idx = torch.arange(N, dtype=torch.int32, device=dev)
            raw = (keys.view(K, L), idx.view(K, L))
            if what == "pairs":
                raw = raw + (idx.view(K, L).clone(),)
            planes = rs._phase_sort_pairs(raw)
            p1_ms = median_ms(lambda: rs._phase_sort_pairs(raw))
        heads = planes[0][:, ::LANES]
        bounds, v = rs._cuts(planes[0], K, L, heads=heads,
                             return_splitters=True)
        cuts_ms = median_ms(lambda: rs._cuts(planes[0], K, L, heads=heads,
                                             return_splitters=True))
        ctrl, fringes = rs._exchange_prep(planes, bounds, K, L)
        prep_ms = median_ms(lambda: rs._exchange_prep(planes, bounds, K, L))
        srcs = [p.reshape(-1, LANES) for p in planes]
        kern = lambda: [relocate.relocate(ctrl, s, f, K, l_rows, 2 * K)
                        for s, f in zip(srcs, fringes)]
        plain = lambda: [relocate.relocate_plain(ctrl, s, f, K, l_rows,
                                                 2 * K)
                         for s, f in zip(srcs, fringes)]
        ex = kern()
        reloc_ms = median_ms(kern)
        plain_ms = median_ms(plain, iters=3)
        bound_ms = len(planes) * (8 * N + 4 * ctrl.numel()) / bw * 1e3
        if what == "keys":
            # uniform keys flag no constant bucket, so phase 3 is not in
            # place here and may run again on the same buckets
            out = ex[0].view(K, L)
            p3 = rs._phase3_keys(out, v)
            p3_ms = median_ms(lambda: rs._phase3_keys(out, v))
            _require(torch.equal(p3.reshape(-1), torch.sort(keys).values),
                     "keys phases composed != torch.sort")
            relocate_ms, relocate_plain_ms = reloc_ms, plain_ms
            relocate_bound_ms = bound_ms
        else:
            ex2 = tuple(e.view(K, L) for e in ex)
            p3 = rs._phase_sort_pairs(ex2)
            p3_ms = median_ms(lambda: rs._phase_sort_pairs(ex2))
            want = torch.sort(keys, stable=True)
            _require(torch.equal(p3[0].reshape(-1), want.values) and
                     torch.equal(p3[1].reshape(-1).long(), want.indices),
                     f"{what} phases composed != torch.sort")
        emit(phase="per_phase", what=what, n=N, K=K, L=L,
             planes=len(planes), phase1_ms=p1_ms, cuts_ms=cuts_ms,
             prep_ms=prep_ms, relocate_ms=reloc_ms,
             relocate_plain_ms=plain_ms, relocate_bound_ms=bound_ms,
             phase3_ms=p3_ms, sum_ms=p1_ms + cuts_ms + prep_ms + reloc_ms
             + p3_ms, end_to_end_auto_ms=e2e[what]["auto_rangesweep"],
             end_to_end_flat_torch_sort_ms=e2e[what]["flat_torch_sort"])
        del keys, planes, ex, p3, ctrl, fringes, srcs
        free()

    # ---- phase 4: the radix kernels against their plain versions ---------
    # at each engine's own shapes: device_radix scans the (16 * T,) counts at
    # the tuning row's tile; FFX counts at its fixed tile, scans the (16 * B,)
    # block sums and scatters by the table its ScanAdd builds
    tile_rows = rts.default_tile_rows(dev)
    ffx_rows = gstt.get_routing_parameters(info).ffx_tile_rows
    T = N // (tile_rows * LANES)
    radix_err = {"tile_histogram4": 0, "exclusive_scan": 0, "downsweep": 0}

    def check(kname, got, want, what):
        for g, w in zip(got, want):
            err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
            radix_err[kname] = max(radix_err[kname], err)
            _require(torch.equal(g, w), f"{kname} != plain on {what}")

    def checked_scan(values, what):
        table = kernels.exclusive_scan(values)
        check("exclusive_scan", [table], [kernels.exclusive_scan_plain(
            values)], what)
        return table

    for name, entropy, equal in (("uniform", gstt.EntropyPreset.E100, False),
                                 ("E020", gstt.EntropyPreset.E020, False),
                                 ("all_equal", None, True)):
        if equal:
            x = torch.full((N,), 0x1234ABCD, dtype=torch.int32, device=dev)
        else:
            x = codec.encode_biased(prng.make_test_keys(
                N, SEED, torch.uint32, entropy, device=dev))
        rides = tuple(prng.hybrid_taus_bits(N, SEED + j, device=dev)
                      .view(torch.int32) for j in (1, 2))
        for engine, rows_t in (("device_radix", tile_rows),
                               ("ffx", ffx_rows)):
            planes, _ = rts.pad_tiles((x,) + rides, rows_t)
            for shift in range(0, 32, 4):
                counts = kernels.tile_histogram4(planes[0], shift, rows_t)
                check("tile_histogram4", [counts],
                      [kernels.tile_histogram4_plain(planes[0], shift,
                                                     rows_t)],
                      f"{name} {engine} shift {shift}")
                if shift not in (0, 28):
                    continue
                if engine == "ffx":
                    tiles, sums = ffx.count_reduce(counts)
                    table = ffx.scan_add(tiles, checked_scan(
                        sums, f"{name} ffx block sums"), counts.shape[0])
                    scan_len = sums.numel()
                else:
                    table = checked_scan(counts.T.reshape(-1),
                                         f"{name} 16*T table")
                    scan_len = table.numel()
                for ops in (planes[:1], planes[:2], planes):
                    check("downsweep",
                          rts.downsweep(ops, table, shift, rows_t),
                          rts.downsweep_plain(ops, table, shift, rows_t),
                          f"{name} {engine} shift {shift}, {len(ops)} "
                          "planes")
                    emit(phase="kernel_vs_plain", kernel="downsweep",
                         engine=engine, input=name, shift=shift,
                         planes=len(ops), n=N, tile_rows=rows_t,
                         bit_exact=True)
            torch.cuda.synchronize()
            emit(phase="kernel_vs_plain", kernel="tile_histogram4",
                 engine=engine, input=name, shifts=list(range(0, 32, 4)),
                 n=N, tile_rows=rows_t, bit_exact=True)
            emit(phase="kernel_vs_plain", kernel="exclusive_scan",
                 engine=engine, input=name, length=scan_len, bit_exact=True)
            del planes, counts, table
        del x, rides
        free()
    vec = prng.hybrid_taus_bits(1 << 24, SEED + 9, device=dev).view(
        torch.int32)                    # the whole int32 range: sums wrap
    check("exclusive_scan", [kernels.exclusive_scan(vec)],
          [kernels.exclusive_scan_plain(vec)], "a 2^24 vector")
    torch.cuda.synchronize()
    emit(phase="kernel_vs_plain", kernel="exclusive_scan", input="uniform",
         length=1 << 24, bit_exact=True)
    vec = prng.hybrid_taus_bits(1 << 20, SEED + 14, device=dev).view(
        torch.int32)
    check("exclusive_scan", [kernels.exclusive_scan(vec)],
          [kernels.exclusive_scan_plain(vec)], "a full-range 2^20 vector")
    torch.cuda.synchronize()
    emit(phase="kernel_vs_plain", kernel="exclusive_scan",
         input="full_int32_range", length=1 << 20, bit_exact=True)
    del vec
    free()

    # ---- phase 5: the PALLAS path through the public entry points --------
    radix_fns = (kernels.tile_histogram4, kernels.exclusive_scan,
                 rts.downsweep)
    per_call = (8, 8, 8)

    def radix_counts():
        return tuple(f.launches for f in radix_fns)

    for f in radix_fns:
        f.launches = 0
    pallas_runs = []

    def pallas_call(label, fn):
        before = radix_counts()
        out = fn()
        torch.cuda.synchronize()
        delta = tuple(a - b for a, b in zip(radix_counts(), before))
        _require(delta == per_call,
                 f"{label}: launches {delta} != {per_call}")
        pallas_runs.append({"call": label, "launches": delta})
        return out

    for variant in ("device_radix", "ffx"):
        pal = {"backend": gstt.Backend.PALLAS, "variant": variant}
        for kname, make in (
                ("sort_u32", lambda: prng.make_test_keys(
                    N, SEED + 4, torch.uint32, device=dev)),
                ("sort_i32", lambda: prng.make_test_keys(
                    N, SEED + 6, torch.int32, gstt.EntropyPreset.E054,
                    device=dev)),
                ("sort_f32", f32_keys)):
            keys = make()
            perm = oracle_perm(keys)
            for order in orders:
                out = pallas_call(f"{variant} {kname} {order.value}",
                                  lambda: gstt.sort(keys, order=order, **pal))
                _require(same_bits(out, keys, perm, order),
                         f"{variant} {kname} {order.value} != torch.sort")
                del out
            del keys, perm
            free()
        for pname, pdtype in (("sort_pairs_u32", torch.uint32),
                              ("sort_pairs_i64", torch.int64)):
            keys, vals = prng.make_test_pairs(N, SEED + 7, torch.uint32,
                                              pdtype, gstt.EntropyPreset.E033,
                                              device=dev)
            perm = oracle_perm(keys)
            for order in orders:
                ok, ov = pallas_call(
                    f"{variant} {pname} {order.value}",
                    lambda: gstt.sort_pairs(keys, vals, order=order, **pal))
                _require(same_bits(ok, keys, perm, order)
                         and same_bits(ov, vals, perm, order),
                         f"{variant} {pname} {order.value} != torch.sort")
                _require(int(validate.count_pair_violations(ok, ov, order))
                         == 0, f"{variant} {pname}: stability violated")
                del ok, ov
            del keys, vals, perm
            free()
        keys = prng.make_test_keys(N, SEED + 8, torch.uint32,
                                   gstt.EntropyPreset.E081, device=dev)
        perm = oracle_perm(keys).to(torch.int32)
        for order in orders:
            out = pallas_call(f"{variant} argsort {order.value}",
                              lambda: gstt.argsort(keys, order=order, **pal))
            _require(torch.equal(out, flip(perm, order)),
                     f"{variant} argsort {order.value} != torch.sort")
            del out
        del keys, perm
        free()
    keys = prng.make_test_keys(N, SEED + 10, torch.float32, device=dev)
    sorter = gstt.DeviceRadixSort(gstt.SortConfig(backend=gstt.Backend.PALLAS))
    out = pallas_call("DeviceRadixSort.sort", lambda: sorter.sort(keys))
    _require(same_bits(out, keys, oracle_perm(keys), gstt.Order.ASCENDING),
             "DeviceRadixSort(PALLAS).sort != torch.sort")
    del keys, out
    free()
    pallas_launches = dict(zip(("tile_histogram4", "exclusive_scan",
                                "downsweep"), radix_counts()))
    _require(all(v > 0 for v in pallas_launches.values()),
             f"the PALLAS path missed a kernel: {pallas_launches}")
    emit(phase="pallas_path", n=N, tile_rows=tile_rows,
         launches=pallas_launches, runs=pallas_runs, bit_exact=True)

    # ---- phase 6: times of the PALLAS routes and of each radix kernel -----
    payload = torch.arange(N, dtype=torch.int32, device=dev)
    for what, make_fn in (
            ("keys", lambda b, v: lambda k: gstt.sort(k, backend=b,
                                                      variant=v)),
            ("pairs", lambda b, v: lambda k: gstt.sort_pairs(
                k, payload, backend=b, variant=v)),
            ("argsort", lambda b, v: lambda k: gstt.argsort(k, backend=b,
                                                            variant=v))):
        for route, backend, variant in (
                ("pallas_device_radix", gstt.Backend.PALLAS, "device_radix"),
                ("pallas_ffx", gstt.Backend.PALLAS, "ffx"),
                ("flat_torch_sort", gstt.Backend.XLA, "onesweep"),
                ("pallas_device_radix_2", gstt.Backend.PALLAS,
                 "device_radix"),
                ("pallas_ffx_2", gstt.Backend.PALLAS, "ffx"),
                ("flat_torch_sort_2", gstt.Backend.XLA, "onesweep")):
            r = timing.batch_timing(make_fn(backend, variant), N, batch=1,
                                    repeats=batch, seed=SEED, device=dev)
            emit(phase="end_to_end", what=what, route=route, n=N,
                 batch=batch, ms=r["seconds_per_sort"] * 1e3,
                 spread_ms=[r["spread_min_s"] * 1e3,
                            r["spread_max_s"] * 1e3],
                 keys_per_sec=r["keys_per_sec"])
            free()
    del payload
    free()

    x = codec.encode_biased(prng.make_test_keys(N, SEED, torch.uint32,
                                                device=dev))
    ride = torch.arange(N, dtype=torch.int32, device=dev)
    planes3 = rts.pad_tiles((x, ride, ride.clone()), tile_rows)[0]
    shift = 28
    counts = kernels.tile_histogram4(planes3[0], shift, tile_rows)
    flat = counts.T.reshape(-1)
    table = kernels.exclusive_scan(flat)
    tile_elems = tile_rows * LANES
    pos = torch.arange(N, device=dev)
    radix_times = {
        "tile_histogram4": dict(
            ms=median_ms(lambda: kernels.tile_histogram4(planes3[0], shift,
                                                         tile_rows)),
            plain_ms=median_ms(lambda: kernels.tile_histogram4_plain(
                planes3[0], shift, tile_rows), iters=3),
            # torch.bincount of the key tile * 16 + digit, the key built
            # inside the timed call
            library_ms=median_ms(lambda: torch.bincount(
                (pos // tile_elems) * 16
                + kernels.digits(planes3[0].reshape(-1), shift),
                minlength=16 * T)),
            bound_ms=(4 * N + 4 * 16 * T) / bw * 1e3, launches_per_sort=8,
            library="torch.bincount(t*16+digit), key built in the call"),
        # ms is one call between two events on an idle card (the host's
        # work for the call included, as for torch.cumsum); device_ms the
        # same calls queued behind a spin; host_ms the host's time a call
        "exclusive_scan": dict(
            ms=median_ms(lambda: kernels.exclusive_scan(flat)),
            ms_median_of_50=median_ms(lambda: kernels.exclusive_scan(flat),
                                      iters=50),
            device_ms=timing.queued_device_time_ms(
                lambda: kernels.exclusive_scan(flat), device=dev),
            host_ms=timing.host_time_ms(
                lambda: kernels.exclusive_scan(flat), device=dev),
            plain_ms=median_ms(lambda: kernels.exclusive_scan_plain(flat)),
            library_ms=median_ms(lambda: torch.cumsum(flat, 0)),
            library_ms_median_of_50=median_ms(lambda: torch.cumsum(flat, 0),
                                              iters=50),
            library_device_ms=timing.queued_device_time_ms(
                lambda: torch.cumsum(flat, 0), device=dev),
            library_host_ms=timing.host_time_ms(
                lambda: torch.cumsum(flat, 0), device=dev),
            bound_ms=8 * 16 * T / bw * 1e3, launches_per_sort=8,
            library="torch.cumsum (inclusive, int64 out)"),
    }
    for n_planes in (1, 2, 3):
        ops = planes3[:n_planes]
        rec = dict(
            ms=median_ms(lambda: rts.downsweep(ops, table, shift, tile_rows)),
            plain_ms=median_ms(lambda: rts.downsweep_plain(
                ops, table, shift, tile_rows), iters=3),
            library_ms=None,
            bound_ms=(8 * N * n_planes + 4 * 16 * T) / bw * 1e3,
            launches_per_sort=8,
            library="none: no one torch call scatters by a digit table")
        radix_times[f"downsweep_{n_planes}"] = rec
    for kname, rec in radix_times.items():
        emit(phase="per_kernel", kernel=kname, n=N, tile_rows=tile_rows,
             tiles=T, **rec)
    # the FFX engine's fixed tile: its Upsweep, its scan of the block sums
    # and its 1-plane downsweep
    ffx_counts = kernels.tile_histogram4(planes3[0], shift, ffx_rows)
    ffx_tiles, ffx_sums = ffx.count_reduce(ffx_counts)
    ffx_table = ffx.scan_add(ffx_tiles, kernels.exclusive_scan(ffx_sums),
                             ffx_counts.shape[0])
    emit(phase="per_kernel_ffx_tile", n=N, tile_rows=ffx_rows,
         tiles=N // (ffx_rows * LANES), scan_length=ffx_sums.numel(),
         tile_histogram4_ms=median_ms(lambda: kernels.tile_histogram4(
             planes3[0], shift, ffx_rows)),
         exclusive_scan_ms=median_ms(lambda: kernels.exclusive_scan(
             ffx_sums)),
         downsweep_1_ms=median_ms(lambda: rts.downsweep(
             planes3[:1], ffx_table, shift, ffx_rows)))
    del x, ride, planes3, counts, flat, table, pos
    del ffx_counts, ffx_tiles, ffx_sums, ffx_table
    free()

    # ---- phase 7: the radix16 and network kernels against plain ----------
    r16_rows = rts.default_tile_rows(dev)
    new_err = {"global_histogram": 0, "binning_pass": 0, "local_stages": 0,
               "global_stage": 0}

    def check_new(kname, got, want, what):
        for g, w in zip(got, want):
            err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
            new_err[kname] = max(new_err[kname], err)
            _require(torch.equal(g, w), f"{kname} != plain on {what}")

    def check_binning(x, rides, name):
        """One binning pass on 1, 2 and 3 planes at shifts 0 and 28, fused
        and as the adversarial_segments chain, at tiles of 1, 3, 32 and 512
        rows (and the tuning row's), each against one plain answer per
        range: the kernel cuts each range into its own partitions, so the
        3-row tiles' range (the first whole tiles) and the 1-row tiles'
        segments end in ragged partitions."""
        rows = N // LANES
        groups = {}                     # rows used -> the tiles that use them
        for tr in sorted({1, 3, 32, 512, r16_rows}):
            groups.setdefault(rows // tr * tr, []).append(tr)
        for used, tiles in groups.items():
            planes = [y[:used * LANES].view(used, LANES)
                      for y in (x,) + rides]
            bases, _ = radix16._bases_all_passes(planes[0].reshape(-1))
            for p in (0, 7):
                shift = 4 * p
                for ops in (planes[:1], planes[:2], planes):
                    want, wcur = radix16.binning_pass_plain(
                        ops, bases[p], shift, tiles[0])
                    for tr in tiles:
                        got, cur = radix16.binning_pass(ops, bases[p], shift,
                                                        tr)
                        check_new("binning_pass", got + [cur], want + [wcur],
                                  f"{name} shift {shift}, {len(ops)} planes, "
                                  f"{tr}-row tiles")
                        del got
                        segs = radix16.adversarial_segments(used * LANES, tr)
                        bounds = sorted({0, used // tr} | set(segs))
                        out, c = [torch.empty_like(y) for y in ops], bases[p]
                        for a, b in zip(bounds[:-1], bounds[1:]):
                            _, c = radix16.binning_pass(
                                [y[a * tr:b * tr] for y in ops], c, shift, tr,
                                out)
                        check_new("binning_pass", out + [c], want + [wcur],
                                  f"{name} shift {shift}, {len(ops)} planes, "
                                  f"{tr}-row tiles, segments {segs}")
                        del out
                    del want
            emit(phase="kernel_vs_plain", kernel="binning_pass", input=name,
                 shifts=[0, 28], planes=[1, 2, 3], n=used * LANES,
                 tile_rows=tiles, partition=binning_part,
                 ragged_last_partition=(used * LANES) % binning_part != 0,
                 segments="adversarial_segments at each tile",
                 bit_exact=True)
            del planes

    binning_part = _nvcc.load(radix16.SOURCE).gst_binning_partition()
    idx = torch.arange(N, dtype=torch.int32, device=dev)
    for name, entropy, equal in (("uniform", gstt.EntropyPreset.E100, False),
                                 ("E020", gstt.EntropyPreset.E020, False),
                                 ("all_equal", None, True)):
        if equal:
            x = torch.full((N,), 0x1234ABCD, dtype=torch.int32, device=dev)
        else:
            x = codec.encode_biased(prng.make_test_keys(
                N, SEED + 11, torch.uint32, entropy, device=dev))
        rides = tuple(prng.hybrid_taus_bits(N, SEED + j, device=dev)
                      .view(torch.int32) for j in (12, 13))
        for length in (N, N - 77):
            check_new("global_histogram",
                      [kernels.global_histogram(x[:length])],
                      [kernels.global_histogram_plain(x[:length])],
                      f"{name} n={length}")
        emit(phase="kernel_vs_plain", kernel="global_histogram", input=name,
             lengths=[N, N - 77], bit_exact=True)

        check_binning(x, rides, name)

        # 3 planes (2 keys) is the (code, index, payload) of pairs and
        # argsort, 4 the 64-bit pairs', each at its own tile; (2, 1) a key
        # plane of 16 values with a distinct rider, where equal keys make
        # both sides of a pair take one element (the TPU kernels' rule);
        # the 8-row tile is the smallest the network's own sorts give
        tied = x & 15
        for num_ops, num_keys, tr in ((1, 1, None), (2, 2, None),
                                      (2, 1, None), (3, 2, None),
                                      (4, 2, None), (1, 1, 8), (3, 2, 8)):
            tr = tr or bitonic.network_tile_rows(dev, num_ops)
            te = tr * LANES
            ops = [(tied if (num_ops, num_keys) == (2, 1) else x).view(
                       -1, LANES), idx.view(-1, LANES),
                   rides[0].view(-1, LANES), rides[1].view(-1, LANES)]
            ops = ops[:num_ops]
            for sname, sched in (("in_tile", bitonic.in_tile_schedule(te)),
                                 ("tail", bitonic.tail_schedule(te, 4 * te))):
                check_new("local_stages",
                          bitonic.local_stages(ops, sched, num_keys, tr),
                          bitonic.local_stages_plain(ops, sched, num_keys,
                                                     tr),
                          f"{name} {sname}, {num_ops} planes, {num_keys} "
                          f"keys, {tr} rows")
            emit(phase="kernel_vs_plain", kernel="local_stages", input=name,
                 planes=num_ops, num_keys=num_keys, n=N, tile_rows=tr,
                 schedules=["in_tile", "tail k=4*tile"],
                 tie_heavy_key=(num_ops, num_keys) == (2, 1),
                 bit_exact=True)
            if tr == 8 or num_ops == 2:
                continue
            for j in (te, 4 * te):
                got = bitonic.global_stage([y.clone() for y in ops], j,
                                           8 * j, num_keys, tr)
                want = bitonic.global_stage_plain([y.clone() for y in ops],
                                                  j, 8 * j, num_keys, tr)
                check_new("global_stage", got, want,
                          f"{name} j={j}, {num_ops} planes")
                del got, want
            emit(phase="kernel_vs_plain", kernel="global_stage",
                 input=name, planes=num_ops, num_keys=num_keys, n=N,
                 tile_rows=tr, global_strides=[te, 4 * te], bit_exact=True)
            del ops
        del tied
        torch.cuda.synchronize()
        del x, rides
        free()
    del idx
    free()

    # two digits at every shift (u32 0 and 0xFFFFFFFF): every item of a warp
    # ties with about half the others
    gen7 = torch.Generator(device=dev)
    gen7.manual_seed(SEED + 7)
    x = torch.randint(0, 2, (N,), generator=gen7, device=dev,
                      dtype=torch.int32) * -1 ^ codec.SIGN
    rides = tuple(prng.hybrid_taus_bits(N, SEED + j, device=dev)
                  .view(torch.int32) for j in (12, 13))
    check_binning(x, rides, "two_digit")
    # eight passes back to back on one stream with no synchronisation, each
    # on the status words the one before left, then on a second stream
    x2 = x.view(-1, LANES)
    bases, _ = radix16._bases_all_passes(x)
    want = [radix16.binning_pass_plain([x2], bases[p], 4 * p, r16_rows)
            for p in (0, 7)]
    got = [radix16.binning_pass([x2], bases[p], 4 * p, r16_rows)
           for p in (0, 7, 0, 7)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got += [radix16.binning_pass([x2], bases[p], 4 * p, r16_rows)
                for p in (0, 7)]
    torch.cuda.synchronize()
    for i, (go, gc) in enumerate(got):
        wo, wc = want[i % 2]
        check_new("binning_pass", go + [gc], wo + [wc],
                  f"two_digit call {i} of 4 back to back and 2 on a second "
                  "stream")
    emit(phase="kernel_vs_plain", kernel="binning_pass", input="two_digit",
         calls="4 back to back, 2 on a second stream", bit_exact=True)
    del x, x2, rides, want, got
    free()

    # ---- phase 8: the new PALLAS variants through the public entry points
    new_fns = (kernels.global_histogram, radix16.binning_pass,
               bitonic.local_stages, mergesweep.hyper_stage,
               bitonic.global_stage)

    def new_counts():
        return tuple(f.launches for f in new_fns)

    def network_launches(num_ops):
        # (L - t + 1) in-tile passes; above the tile each level's hyper
        # trips and no global stage
        L = N.bit_length() - 1
        te = bitonic.network_tile_rows(dev, num_ops) * LANES
        t = te.bit_length() - 1
        trips = sum(len(mergesweep.level_trips(1 << lk, te, num_ops))
                    for lk in range(t + 1, L + 1))
        return (0, 0, L - t + 1, trips, 0)

    def radix16_launches(keys, segmented):
        codes = codec.encode_biased(keys)
        varying = sum(int(kernels.digits(codes, 4 * p).unique().numel() > 1)
                      for p in range(8))
        if segmented:
            segs = radix16.adversarial_segments(N, r16_rows)
            return (1, 8 * (len(segs) + 1), 0, 0, 0)
        return (1, varying, 0, 0, 0)

    def expected(variant, keys, num_ops):
        if variant in ("onesweep", "forward_sweep"):
            return network_launches(num_ops)
        return radix16_launches(keys, variant == "emulated_deadlocking")

    for f in new_fns:
        f.launches = 0
    new_runs = []

    def new_call(label, fn, want):
        before = new_counts()
        out = fn()
        torch.cuda.synchronize()
        delta = tuple(a - b for a, b in zip(new_counts(), before))
        _require(delta == want, f"{label}: launches {delta} != {want}")
        new_runs.append({"call": label, "launches": delta})
        return out

    key_cases = (("sort_u32", lambda: prng.make_test_keys(
                     N, SEED + 4, torch.uint32, device=dev)),
                 ("sort_i32", lambda: prng.make_test_keys(
                     N, SEED + 6, torch.int32, gstt.EntropyPreset.E054,
                     device=dev)),
                 ("sort_f32", f32_keys))
    for variant in ("onesweep", "radix16", "forward_sweep",
                    "emulated_deadlocking"):
        full = variant in ("onesweep", "radix16")
        pal = {"backend": gstt.Backend.PALLAS, "variant": variant}
        for kname, make in key_cases if full else key_cases[:1]:
            keys = make()
            perm = oracle_perm(keys)
            for order in orders if full else orders[:1]:
                out = new_call(f"{variant} {kname} {order.value}",
                               lambda: gstt.sort(keys, order=order, **pal),
                               expected(variant, keys, 1))
                _require(same_bits(out, keys, perm, order),
                         f"{variant} {kname} {order.value} != torch.sort")
                del out
            del keys, perm
            free()
        pair_cases = ((("sort_pairs_u32", torch.uint32, 3),
                       ("sort_pairs_i64", torch.int64, 4)) if full
                      else (("sort_pairs_u32", torch.uint32, 3),))
        for pname, pdtype, net_ops in pair_cases:
            keys, vals = prng.make_test_pairs(N, SEED + 7, torch.uint32,
                                              pdtype, gstt.EntropyPreset.E033,
                                              device=dev)
            perm = oracle_perm(keys)
            for order in orders if full else orders[:1]:
                ok, ov = new_call(
                    f"{variant} {pname} {order.value}",
                    lambda: gstt.sort_pairs(keys, vals, order=order, **pal),
                    expected(variant, keys, net_ops))
                _require(same_bits(ok, keys, perm, order)
                         and same_bits(ov, vals, perm, order),
                         f"{variant} {pname} {order.value} != torch.sort")
                _require(int(validate.count_pair_violations(ok, ov, order))
                         == 0, f"{variant} {pname}: stability violated")
                del ok, ov
            if pdtype == torch.int64:
                lo, hi = codec.split_wide(vals)
                for order in orders:
                    gk, glo, ghi = new_call(
                        f"{variant} sort_pairs_wide {order.value}",
                        lambda: gstt.sort_pairs_wide(keys, lo, hi,
                                                     order=order, **pal),
                        expected(variant, keys, 4))
                    _require(same_bits(gk, keys, perm, order)
                             and same_bits(glo, lo, perm, order)
                             and same_bits(ghi, hi, perm, order),
                             f"{variant} sort_pairs_wide {order.value} "
                             "!= torch.sort")
                    del gk, glo, ghi
                del lo, hi
            del keys, vals, perm
            free()
        if full:
            keys = prng.make_test_keys(N, SEED + 8, torch.uint32,
                                       gstt.EntropyPreset.E081, device=dev)
            perm = oracle_perm(keys).to(torch.int32)
            for order in orders:
                out = new_call(f"{variant} argsort {order.value}",
                               lambda: gstt.argsort(keys, order=order, **pal),
                               expected(variant, keys, 3))
                _require(torch.equal(out, flip(perm, order)),
                         f"{variant} argsort {order.value} != torch.sort")
                del out
            del keys, perm
            free()
    for cls, variant in ((gstt.OneSweep, "onesweep"),
                         (gstt.ForwardSweep, "forward_sweep"),
                         (gstt.EmulatedDeadlocking, "emulated_deadlocking")):
        keys = prng.make_test_keys(N, SEED + 10, torch.float32, device=dev)
        sorter = cls(gstt.SortConfig(backend=gstt.Backend.PALLAS))
        out = new_call(f"{cls.__name__}.sort", lambda: sorter.sort(keys),
                       expected(variant, keys, 1))
        _require(same_bits(out, keys, oracle_perm(keys),
                           gstt.Order.ASCENDING),
                 f"{cls.__name__}(PALLAS).sort != torch.sort")
        del keys, out
        free()
    new_launches = dict(zip(("global_histogram", "binning_pass",
                             "local_stages", "hyper_stage", "global_stage"),
                            new_counts()))
    _require(all(v > 0 for k, v in new_launches.items()
                 if k != "global_stage"),
             f"the new PALLAS variants missed a kernel: {new_launches}")
    _require(new_launches["global_stage"] == 0,
             f"the network ran global stages: {new_launches}")
    emit(phase="pallas_path_new_variants", n=N, radix16_tile_rows=r16_rows,
         network_tile_rows={k: bitonic.network_tile_rows(dev, k)
                            for k in (1, 3, 4)},
         launches=new_launches, runs=new_runs, bit_exact=True)

    # ---- phase 9: times of the new variants and of each new kernel --------
    payload = torch.arange(N, dtype=torch.int32, device=dev)
    for what, make_fn in (
            ("keys", lambda b, v: lambda k: gstt.sort(k, backend=b,
                                                      variant=v)),
            ("pairs", lambda b, v: lambda k: gstt.sort_pairs(
                k, payload, backend=b, variant=v)),
            ("argsort", lambda b, v: lambda k: gstt.argsort(k, backend=b,
                                                            variant=v))):
        routes = [(f"pallas_{v}", gstt.Backend.PALLAS, v)
                  for v in ("onesweep", "forward_sweep", "radix16",
                            "emulated_deadlocking", "device_radix", "ffx")]
        routes.append(("flat_torch_sort", gstt.Backend.XLA, "onesweep"))
        for rep in ("", "_2"):
            for route, backend, variant in routes:
                r = timing.batch_timing(make_fn(backend, variant), N, batch=1,
                                        repeats=batch, seed=SEED,
                                        device=dev)
                emit(phase="end_to_end", what=what, route=route + rep, n=N,
                     batch=batch, ms=r["seconds_per_sort"] * 1e3,
                     spread_ms=[r["spread_min_s"] * 1e3,
                                r["spread_max_s"] * 1e3],
                     keys_per_sec=r["keys_per_sec"])
                free()
    del payload
    free()

    x = codec.encode_biased(prng.make_test_keys(N, SEED, torch.uint32,
                                                device=dev))
    ride = torch.arange(N, dtype=torch.int32, device=dev)
    planes3 = [x.view(-1, LANES), ride.view(-1, LANES),
               ride.clone().view(-1, LANES)]
    bases, _ = radix16._bases_all_passes(x)
    u = x ^ codec.SIGN
    new_times = {
        "global_histogram": dict(
            ms=median_ms(lambda: kernels.global_histogram(x)),
            plain_ms=median_ms(lambda: kernels.global_histogram_plain(x),
                               iters=3),
            # torch.bincount of p * 256 + byte p, the key built in the call
            library_ms=median_ms(lambda: torch.bincount(torch.cat(
                [((u >> (8 * p)) & 255) + 256 * p for p in range(4)]),
                minlength=1024)),
            bound_ms=(4 * N + 4 * 1024) / bw * 1e3, launches_per_sort=1,
            library="torch.bincount(p*256+byte), key built in the call"),
    }
    for n_planes in (1, 3):
        ops = planes3[:n_planes]
        new_times[f"binning_pass_{n_planes}"] = dict(
            ms=median_ms(lambda: radix16.binning_pass(ops, bases[7], 28,
                                                      r16_rows)),
            plain_ms=median_ms(lambda: radix16.binning_pass_plain(
                ops, bases[7], 28, r16_rows), iters=3),
            library_ms=None,
            bound_ms=8 * N * n_planes / bw * 1e3, launches_per_sort=8,
            library="none: no one torch call places a stable digit "
                    "partition at given cursors")
    tr1 = bitonic.network_tile_rows(dev, 1)
    for num_ops, num_keys in ((1, 1), (3, 2)):
        tr = bitonic.network_tile_rows(dev, num_ops)
        te = tr * LANES
        net = planes3[:num_ops]
        for sname, sched in (("in_tile", bitonic.in_tile_schedule(te)),
                             ("tail", bitonic.tail_schedule(te, 4 * te))):
            # a compare-exchange of a pair is its two lexicographic
            # compares, 2 * (2 * keys - 1) 32-bit comparisons, and 2
            # selections a plane (1 plane, 1 key: 4), at the card's 32-bit
            # non-tensor peak; its bytes are the planes read and written
            # once
            per_pair = 2 * (2 * num_keys - 1) + 2 * num_ops
            ops_ms = sched.shape[0] * (N // 2) * per_pair / PEAK_OPS_32 * 1e3
            bytes_ms = 8 * N * num_ops / bw * 1e3
            suffix = "" if num_ops == 1 else f"_{num_ops}"
            new_times[f"local_stages_{sname}{suffix}"] = dict(
                ms=median_ms(lambda: bitonic.local_stages(net, sched,
                                                          num_keys, tr)),
                plain_ms=median_ms(lambda: bitonic.local_stages_plain(
                    net, sched, num_keys, tr), iters=3),
                library_ms=None, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms > bytes_ms else "bytes",
                ops_ms=ops_ms, bytes_ms=bytes_ms, stages=sched.shape[0],
                runs=len(bitonic.stage_runs(sched)), planes=num_ops,
                num_keys=num_keys, tile_rows=tr,
                library="none: no one torch call runs a partial bitonic "
                        "schedule")
    gplanes = [x.clone().view(-1, LANES)]
    new_times["global_stage"] = dict(
        ms=median_ms(lambda: bitonic.global_stage(gplanes, N // 2, N, 1,
                                                  tr1)),
        plain_ms=median_ms(lambda: bitonic.global_stage_plain(
            gplanes, N // 2, N, 1, tr1), iters=3),
        library_ms=None, bound_ms=8 * N / bw * 1e3,
        library="none: no one torch call runs one compare-exchange stage")
    for kname, rec in new_times.items():
        emit(phase="per_kernel", kernel=kname, n=N, **rec)
    # the above-tile strides of a 2^28 keys sort (1 plane, 1 key) and of a
    # pairs sort (3 planes, 2 keys), each level k from twice the tile to N,
    # both ways in turn: hyper trips (the default) and one global stage a
    # stride (the switch off); bound: each launch reads and writes the
    # planes once
    switch = mergesweep._USE_HYPER
    above = {}
    for num_ops, num_keys in ((1, 1), (3, 2)):
        tr = bitonic.network_tile_rows(dev, num_ops)
        te = tr * LANES
        levels = [1 << lk for lk in range(te.bit_length(), N.bit_length())]
        net = [y.clone() for y in planes3[:num_ops]]
        rec = {}
        calls = [0]

        def above_tile():
            calls[0] += 1
            for k in levels:
                mergesweep.run_high_strides(net, k, tr, num_keys)

        for hyper, form in ((True, "trips"), (False, "global_stages"),
                            (True, "trips_2")):
            # the launches of one sort's strides, read from the counters
            # around the timed calls
            mergesweep._USE_HYPER = hyper
            calls[0] = 0
            mergesweep.hyper_stage.launches = 0
            bitonic.global_stage.launches = 0
            try:
                rec[f"{form}_ms"] = median_ms(above_tile, iters=3)
            finally:
                mergesweep._USE_HYPER = switch
            counted = (mergesweep.hyper_stage.launches,
                       bitonic.global_stage.launches)
            _require(calls[0] > 0 and all(c % calls[0] == 0
                                           for c in counted),
                     f"{form}: {counted} launches in {calls[0]} calls")
            rec[f"{form}_launches"] = dict(zip(
                ("hyper_stage", "global_stage"),
                (c // calls[0] for c in counted)))
        trips = rec["trips_launches"]["hyper_stage"]
        stages = rec["global_stages_launches"]["global_stage"]
        _require(rec["trips_launches"]["global_stage"] == 0
                 and rec["global_stages_launches"]["hyper_stage"] == 0
                 and trips == sum(len(mergesweep.level_trips(k, te, num_ops))
                                  for k in levels)
                 and stages == sum((k // te).bit_length() - 1
                                   for k in levels),
                 f"above-tile launches on {num_ops} planes: {rec}")
        rec.update(trips_bound_ms=trips * 8 * N * num_ops / bw * 1e3,
                   global_stages_bound_ms=stages * 8 * N * num_ops / bw
                   * 1e3)
        above[num_ops] = rec
        emit(phase="above_tile_strides", n=N, planes=num_ops,
             num_keys=num_keys, tile_rows=tr, **rec)
    del x, u, ride, planes3, bases, net, gplanes
    free()

    # ---- phase 10: compact and expand against their plain versions -------
    stitch_err = {"compact": 0, "expand": 0}

    def check_stitch(kname, got, want, what):
        for g, w in zip(got, want):
            if g.numel():
                err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                stitch_err[kname] = max(stitch_err[kname], err)
            _require(torch.equal(g, w), f"{kname} != plain on {what}")

    def host_starts(offs, total):
        starts = offs.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
        return starts, np.diff(np.append(starts, total))

    def segment_mask(n, max_len, seed):
        """Every other segment of make_random_segments, as an interval
        mask (the segmented sort's own `_interval_mask`)."""
        starts, lens = host_starts(
            prng.make_random_segments(n, max_len, seed, device=dev)[0], n)
        return splitsort._interval_mask(starts[1::2], lens[1::2], n, dev)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    masks = {"none": torch.zeros(N, dtype=torch.bool, device=dev),
             "all": torch.ones(N, dtype=torch.bool, device=dev),
             "half": torch.rand(N, generator=gen, device=dev) < 0.5,
             "1/64": torch.rand(N, generator=gen, device=dev) < 1 / 64,
             "segments": segment_mask(N, 1 << 10, SEED + 20)}
    splanes = [prng.hybrid_taus_bits(N, SEED + 21 + j, device=dev)
               .view(torch.int32) for j in range(3)]
    for mname, mask in masks.items():
        count = int(mask.sum())
        for ops in (splanes[:1], splanes[:2], splanes):
            packed, cnt = stitch.compact_ops(ops, mask)
            wpacked, wcnt = stitch.compact_plain(ops, mask)
            _require(int(cnt) == int(wcnt) == count,
                     f"compact count {int(cnt)} != {count} on {mname}")
            check_stitch("compact", [p[:count] for p in packed],
                         [w[:count] for w in wpacked],
                         f"{mname}, {len(ops)} planes")
            del packed, wpacked
            for length in (N, count // 2):
                srcs = [p[:length] for p in ops]
                check_stitch("expand", stitch.expand_ops(srcs, mask),
                             stitch.expand_plain(srcs, mask),
                             f"{mname}, {len(ops)} planes, stream {length}")
            torch.cuda.synchronize()
            emit(phase="kernel_vs_plain", kernel="compact+expand",
                 mask=mname, planes=len(ops), n=N, count=count,
                 expand_stream_lengths=[N, count // 2], bit_exact=True)
            free()
    del masks
    free()
    mbuf = torch.rand(N + 16, generator=gen, device=dev) < 0.5
    obufs = [prng.hybrid_taus_bits(N + 4, SEED + 25 + j, device=dev)
             .view(torch.int32) for j in range(4)]
    obufs[0] &= 3
    for mo in (1, 7, 13):
        mask = mbuf[mo:mo + N]
        count = int(mask.sum())
        for k in (1, 2, 3, 4):
            offs = [(mo + q) % 3 + 1 for q in range(k)]
            ops = [b[o:o + N] for b, o in zip(obufs, offs)]
            what = f"mask offset {mo}, planes at {offs}"
            packed, cnt = stitch.compact_ops(ops, mask)
            wpacked, wcnt = stitch.compact_plain(ops, mask)
            _require(int(cnt) == int(wcnt) == count,
                     f"compact count {int(cnt)} != {count} on {what}")
            check_stitch("compact", [p[:count] for p in packed],
                         [w[:count] for w in wpacked], what)
            del packed, wpacked
            for length in (N, count // 2):
                srcs = [b[4 - o:4 - o + length] for b, o in zip(obufs, offs)]
                check_stitch("expand", stitch.expand_ops(srcs, mask),
                             stitch.expand_plain(srcs, mask),
                             f"{what}, stream {length}")
            torch.cuda.synchronize()
            emit(phase="kernel_vs_plain", kernel="compact+expand",
                 mask="half", mask_byte_offset=mo, plane_offsets=offs,
                 planes=k, n=N, count=count,
                 expand_stream_lengths=[N, count // 2], bit_exact=True)
            free()
    del mbuf, obufs, mask, ops, srcs
    free()

    # ---- phase 11: the segmented sort through the public entry points ----
    tot_a = 1 << 22
    tot_c = 1 << 26
    M32 = 0xFFFFFFFF
    stitch_fns = (stitch.compact_ops, stitch.expand_ops)

    def stitch_counts():
        return tuple(f.launches for f in stitch_fns)

    def route_of(plan, bits_to_sort=32, has_payload=True):
        if plan.fixed_length is not None and plan.fixed_length > 1:
            return "fixed"
        if splitsort._takes_tile(plan.max_len, plan.total, plan.total,
                                 plan.info):
            return "tile"
        wp = plan.window_plan(bits_to_sort, has_payload) or {}

        def mode(ml, sid_bits):
            return splitsort._pick_window_mode(ml, sid_bits, bits_to_sort,
                                               has_payload, plan.info)

        # as splitsort._dispatch_random_lengths decides: the split only
        # where its bulk has a window mode (or needs none)
        sp = wp.get("split")
        if sp is not None and (sp["ml"] <= 1
                               or mode(sp["ml"], sp["sid_bits"]) is not None):
            return "split"
        if "classes" in wp:
            return "classes"
        if "ml" in wp:
            m = mode(wp["ml"], wp["sid_bits"])
            if m is not None:
                return f"window_{m}"
        return "composite"

    def seg_call(label, fn, want_stitch):
        before = stitch_counts()
        out = fn()
        torch.cuda.synchronize()
        delta = tuple(a - b for a, b in zip(stitch_counts(), before))
        _require(want_stitch is None or delta == want_stitch,
                 f"{label}: compact+expand launches {delta} != "
                 f"{want_stitch}")
        return out, delta

    def same(a, b) -> bool:
        return a.dtype == b.dtype and torch.equal(bits(a), bits(b))

    def check_pairs(label, offs, S, total, keys, vals, want_stitch=None,
                    bits_to_sort=32, **kw):
        """u32 pairs with payload == key bits, against the composite oracle
        and the payload == key oracle."""
        (gk, gv), delta = seg_call(label, lambda: gstt.split_sort_pairs(
            offs, keys, vals, S, total, bits_to_sort, **kw), want_stitch)
        wk, wv = flat_sort.segmented_sort_pairs(offs, keys, vals, total)
        _require(same(gk, wk) and same(gv, wv),
                 f"{label} != composite oracle")
        _require(torch.equal(bits(gv), bits(gk)) and int(
            validate.count_segmented_violations(offs, gk)) == 0,
                 f"{label}: payload == key oracle violated")
        return delta

    def check_keys(label, offs, S, total, keys, want_stitch=None, **kw):
        gk, delta = seg_call(label, lambda: gstt.split_sort_keys(
            offs, keys, S, **kw), want_stitch)
        _require(same(gk, flat_sort.segmented_sort_pairs(offs, keys, None,
                                                         total)),
                 f"{label} != composite oracle")
        return delta

    def check_wide(label, offs, S, total, keys):
        """A float64 payload holding the key's value, through
        split_sort_pairs_wide as lo/hi planes."""
        v64 = (bits(keys).to(torch.int64) & M32).to(torch.float64)
        lo, hi = codec.split_wide(v64.view(torch.int64))
        (gk, glo, ghi), delta = seg_call(
            label, lambda: gstt.split_sort_pairs_wide(offs, keys, lo, hi, S,
                                                      total), None)
        wk, wv = flat_sort.segmented_sort_pairs(offs, keys, v64, total)
        got = codec.join_wide(glo, ghi)
        _require(same(gk, wk) and torch.equal(got, wv.view(torch.int64)),
                 f"{label} != composite oracle")
        _require(torch.equal(got.view(torch.float64).to(torch.int64),
                             bits(gk).to(torch.int64) & M32),
                 f"{label}: payload == key oracle violated")
        return delta

    def special_floats(k):
        pos = torch.arange(0, k.numel(), 997, device=dev)
        k.view(torch.int32)[pos] = specials[pos % specials.numel()]
        return k

    def offsets_of(lens):
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
        return (codec.wrap_int32(torch.from_numpy(starts)).to(dev),
                len(lens), int(np.sum(lens)))

    def layout_lens(total, longs, small_max, seed):
        """Long segments (count, lo, hi), the rest filled with segments of
        1..small_max, shuffled."""
        rng = np.random.default_rng(seed)
        big = np.concatenate([rng.integers(lo, hi + 1, c)
                              for c, lo, hi in longs])
        rem = total - int(big.sum())
        small = rng.integers(1, small_max + 1, 2 * rem // small_max + 64)
        ends = np.cumsum(small)
        k = int(np.searchsorted(ends, rem))
        small = small[:k + 1]
        small[k] -= int(ends[k]) - rem
        return rng.permutation(np.concatenate([big, small]))

    # The card's row sends these layouts where its sweeps timed them
    # fastest; the window, split and multi-class routes (the last two
    # launch compact and expand) are also driven, under the segmented
    # fields of the JAX package's row (the dataclass defaults) forced by a
    # routing override, wherever that gives another route.
    seg_defaults = gstt.RoutingParameters()
    seg_force = dataclasses.replace(installed_row, **{
        f: getattr(seg_defaults, f) for f in (
            "window_max_keys", "window_max_fused", "window_max_pairs",
            "segsort_bulk_max", "segsort_padded_max",
            "segsort_extract_max_frac", "segsort_tile_max")})

    def rows_for(offs, total, S):
        """[(tag, override or None, route)]: the installed row, and the
        forced fields where they route this layout elsewhere."""
        out = [("installed", None,
                route_of(gstt.make_segsort_plan(offs, total, S)))]
        gstt.set_routing_override(seg_force)
        try:
            forced_route = route_of(gstt.make_segsort_plan(offs, total, S))
        finally:
            gstt.clear_routing_override()
        if forced_route != out[0][2]:
            out.append(("forced", seg_force, forced_route))
        return out

    def under(rrow, fn):
        if rrow is not None:
            gstt.set_routing_override(rrow)
        try:
            return fn()
        finally:
            gstt.clear_routing_override()

    def layout_a(i, ml, offs, S, keys, vals, tag, rrow, route):
        label = f"a_max2^{ml}" + ("" if rrow is None else f"_{tag}")
        d = check_pairs(f"{label} pairs_u32", offs, S, tot_a, keys, vals)
        check_wide(f"{label} pairs_f64_wide", offs, S, tot_a, keys)
        ikeys = prng.make_test_keys(tot_a, SEED + 50 + i, torch.int32,
                                    gstt.EntropyPreset.E054, device=dev)
        check_keys(f"{label} keys_i32", offs, S, tot_a, ikeys)
        fkeys = special_floats(prng.make_test_keys(
            tot_a, SEED + 60 + i, torch.float32, device=dev))
        check_keys(f"{label} keys_f32", offs, S, tot_a, fkeys)
        if ml == 10:
            for b in (4, 8, 16, 24):
                mk = prng.make_masked_random_values(tot_a, b, SEED + 70 + b,
                                                    device=dev)
                check_pairs(f"{label} bits_to_sort={b}", offs, S, tot_a, mk,
                            mk.clone(), bits_to_sort=b)
        seg_runs.append({"layout": label, "segments": S, "route": route,
                         "row": tag, "stitch_launches_pairs": d})
        timing_cases.append((label, route, rrow, offs, S, tot_a, keys,
                             vals))

    def layout_cd(label, want, calls, offs, S, total, keys, vals, share,
                  tag, rrow, route):
        stitch = (calls, calls) if route == want else None
        plan = gstt.make_segsort_plan(offs, total, S)
        if route == want:
            wp = plan.window_plan(32, True)
            _require(want in wp, f"{label}: plan {sorted(wp)} lacks {want!r}")
            if want == "classes":
                cp = wp["classes"]
                _require([c["B"] for c in cp["padded"]] == [16384]
                         and cp["tail"] is not None,
                         f"{label}: padded {[c['B'] for c in cp['padded']]}, "
                         f"tail {cp['tail'] is not None}")
        label = label + ("" if rrow is None else f"_{tag}")
        d = check_pairs(f"{label} pairs_u32", offs, S, total, keys, vals,
                        stitch)
        check_pairs(f"{label} pairs_u32 plan", offs, S, total, keys, vals,
                    stitch, plan=plan)
        check_keys(f"{label} keys_u32", offs, S, total, keys, stitch)
        seg_runs.append({"layout": label, "segments": S, "total": total,
                         "route": route, "row": tag,
                         "share_at_or_below": share,
                         "stitch_launches_per_call": list(d)})
        timing_cases.append((label, route, rrow, offs, S, total, keys,
                             vals))

    for f in stitch_fns:
        f.launches = 0
    seg_runs = []
    # (layout, route, override, offs, S, total, keys, vals) per layout
    timing_cases = []
    for i, ml in enumerate(range(2, 20, 2)):
        offs, S = prng.make_random_segments(tot_a, 1 << ml, SEED + 30 + i,
                                            device=dev)
        keys, vals = prng.make_test_pairs(tot_a, SEED + 40 + i, torch.uint32,
                                          torch.uint32,
                                          gstt.EntropyPreset.E033, device=dev)
        for tag, rrow, route in rows_for(offs, tot_a, S):
            under(rrow, lambda: layout_a(i, ml, offs, S, keys, vals, tag,
                                         rrow, route))
        del keys, vals
    for seg_len in (32, 4096, 1 << 18):
        offs, S = prng.make_fixed_segments(tot_a, seg_len, device=dev)
        keys, vals = prng.make_test_pairs(tot_a, SEED + 80 + seg_len,
                                          torch.uint32, torch.uint32,
                                          gstt.EntropyPreset.E033, device=dev)
        label = f"b_fixed{seg_len}"
        route = route_of(gstt.make_segsort_plan(offs, tot_a, S))
        _require(route == "fixed", f"{label} planned {route}")
        check_pairs(f"{label} pairs_u32", offs, S, tot_a, keys, vals, (0, 0))
        check_keys(f"{label} keys_u32", offs, S, tot_a, keys, (0, 0))
        seg_runs.append({"layout": label, "segments": S, "route": route})
        timing_cases.append((label, route, None, offs, S, tot_a, keys,
                             vals))
    for label, longs, small_max, want, calls in (
            ("c_split", [(14, 1 << 18, 1 << 19)], 64, "split", 1),
            ("d_classes", [(1100, 8193, 16384), (72, 1 << 18, 1 << 18)], 32,
             "classes", 3)):
        offs, S, total = offsets_of(layout_lens(tot_c, longs, small_max,
                                                SEED + calls))
        keys, vals = prng.make_test_pairs(total, SEED + 90 + calls,
                                          torch.uint32, torch.uint32,
                                          gstt.EntropyPreset.E033, device=dev)
        starts, lens = host_starts(offs, total)
        share = {str(b): float(lens[lens <= b].sum() / total)
                 for b in (32, 64, 16384, 131072)}
        rows_cd = rows_for(offs, total, S)
        _require(any(r == want for _, _, r in rows_cd),
                 f"{label}: no row routes it {want!r}: {rows_cd}")
        for tag, rrow, route in rows_cd:
            under(rrow, lambda: layout_cd(label, want, calls, offs, S, total,
                                          keys, vals, share, tag, rrow,
                                          route))
        del keys, vals
    offs, S = prng.make_random_segments(tot_a, 32, SEED + 100, device=dev)
    keys, vals = prng.make_test_pairs(tot_a, SEED + 101, torch.uint32,
                                      torch.uint32, device=dev)
    check_pairs("e packed", offs, S, tot_a, keys, vals, strategy="packed")
    sorter = gstt.SplitSorter(tot_a, S)
    (gk, gv), _ = seg_call("e SplitSorter", lambda: sorter.sort_pairs(
        offs, keys, vals), None)
    wk, wv = flat_sort.segmented_sort_pairs(offs, keys, vals, tot_a)
    _require(same(gk, wk) and same(gv, wv), "SplitSorter != oracle")
    sorter.close()
    fn = gstt.make_segsort_fn(gstt.make_segsort_plan(offs, tot_a, S))
    (gk, gv), _ = seg_call("e make_segsort_fn", lambda: fn(offs, keys, vals),
                           None)
    _require(same(gk, wk) and same(gv, wv), "make_segsort_fn != oracle")
    del keys, vals, gk, gv, wk, wv
    free()
    seg_launches = dict(zip(("compact", "expand"), stitch_counts()))
    _require(all(v > 0 for v in seg_launches.values()),
             f"the segmented sort missed a stitch kernel: {seg_launches}")
    emit(phase="segsort_path", launches=seg_launches, layouts=seg_runs,
         bit_exact=True)

    # ---- phase 12: times of the segmented sort and of each stitch kernel --
    for label, route, rrow, offs, S, total, keys, vals in timing_cases:
        def case():
            plan = gstt.make_segsort_plan(offs, total, S)
            emit(phase="segsort_end_to_end", layout=label, route=route,
                 row="installed" if rrow is None else "forced",
                 total=total, segments=S,
                 plan_ms=median_ms(lambda: gstt.split_sort_pairs(
                     offs, keys, vals, S, total, plan=plan), iters=3),
                 no_plan_ms=median_ms(lambda: gstt.split_sort_pairs(
                     offs, keys, vals, S, total), iters=3),
                 oracle_ms=median_ms(lambda: flat_sort.segmented_sort_pairs(
                     offs, keys, vals, total), iters=3),
                 plan_build_ms=median_ms(lambda: gstt.make_segsort_plan(
                     offs, total, S).window_plan(32, True), iters=3))
        under(rrow, case)
    free()

    half = torch.rand(N, generator=gen, device=dev) < 0.5
    count = int(half.sum())
    stitch_times = {}
    for n_planes in (1, 3):
        ops = splanes[:n_planes]
        packed, _ = stitch.compact_ops(ops, half)
        srcs = [p[:count] for p in packed]
        stitch_times[f"compact_{n_planes}"] = dict(
            ms=median_ms(lambda: stitch.compact_ops(ops, half)),
            plain_ms=median_ms(lambda: stitch.compact_plain(ops, half),
                               iters=3),
            library_ms=median_ms(lambda: [torch.masked_select(p, half)
                                          for p in ops]),
            bound_ms=(N * (1 + 4 * n_planes) + count * 4 * n_planes)
            / bw * 1e3,
            library="torch.masked_select, one call per plane")
        stitch_times[f"expand_{n_planes}"] = dict(
            ms=median_ms(lambda: stitch.expand_ops(srcs, half)),
            plain_ms=median_ms(lambda: stitch.expand_plain(srcs, half),
                               iters=3),
            library_ms=median_ms(lambda: [
                torch.zeros(N, dtype=torch.int32, device=dev)
                .masked_scatter_(half, s) for s in srcs]),
            bound_ms=(N + count * 4 * n_planes + N * 4 * n_planes)
            / bw * 1e3,
            library="torch.zeros(n).masked_scatter_(mask, src), one call "
                    "per plane")
        del packed, srcs
    for kname, rec in stitch_times.items():
        emit(phase="per_kernel", kernel=kname, n=N, count=count,
             bound_by="bytes", **rec)
    del half, splanes
    free()

    # each stitch call of one (c) and one (d) pairs call, at its shape: one
    # sort captures the operands and answers each call with the plain
    # version, so that no launch counter moves; each kernel is then held bit
    # for bit against that plain answer on the same operands (the 2-plane
    # launches of a pairs call, on its padded-row masks) and timed
    real = {"compact": stitch.compact_ops, "expand": stitch.expand_ops}
    plain = {"compact": stitch.compact_plain, "expand": stitch.expand_plain}
    for label, route, rrow, offs, S, total, keys, vals in (
            t for t in timing_cases
            if t[0][:2] in ("c_", "d_") and t[1] in ("split", "classes")):
        calls = []

        def recorder(kname):
            def rec(planes, mask):
                want = plain[kname](tuple(planes), mask)
                calls.append((kname, tuple(planes), mask, want))
                return want
            return rec
        stitch.compact_ops = recorder("compact")
        stitch.expand_ops = recorder("expand")
        try:
            under(rrow, lambda: gstt.split_sort_pairs(offs, keys, vals, S,
                                                      total))
        finally:
            stitch.compact_ops, stitch.expand_ops = (real["compact"],
                                                     real["expand"])
        shapes = []
        for kname, planes, mask, want in calls:
            what = f"{label}, {len(planes)} planes, n {mask.numel()}"
            got = real[kname](planes, mask)
            if kname == "compact":
                (packed, cnt), (wpacked, wcnt) = got, want
                count = int(wcnt)
                _require(int(cnt) == count,
                         f"compact count {int(cnt)} != {count} on {what}")
                check_stitch("compact", [p[:count] for p in packed],
                             [w[:count] for w in wpacked], what)
            else:
                check_stitch("expand", got, want, what)
            del got
            shapes.append({
                "kernel": kname, "n": mask.numel(), "planes": len(planes),
                "count": int(mask.sum()),
                "plane_lengths": sorted({p.numel() for p in planes}),
                "ms": median_ms(lambda: real[kname](planes, mask))})
        emit(phase="stitch_at_layout", layout=label, route=route,
             total=total, calls=shapes, bit_exact=True,
             sum_ms=sum(c["ms"] for c in shapes))
        del calls, shapes
    del timing_cases
    free()

    # ---- phase 13: the merge kernels and the digit-plane pass vs plain ----
    merge_err = {"merge_tail": 0, "hyper_stage": 0, "binning_digits": 0}

    def check_merge(kname, got, want, what):
        for g, w in zip(got, want):
            err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
            merge_err[kname] = max(merge_err[kname], err)
            _require(torch.equal(g, w), f"{kname} != plain on {what}")

    def in_place_pair(fn, plain, ops, *args):
        """The kernel and its plain version, each on its own copy."""
        got = fn([y.clone() for y in ops], *args)
        want = plain([y.clone() for y in ops], *args)
        return got, want

    def check_trips(ops, num_keys, te, what):
        """The network's hyper trips above a tile of te at N, level by
        level, each held against hyper_stage_plain on the same planes (the
        kernel's copy and the plain copy each go through the whole
        schedule); returns the [k, j_hi, j_lo, cols] trips."""
        got = [y.clone() for y in ops]
        want = [y.clone() for y in ops]
        trips = []
        k = 2 * te
        while k <= N:
            for j_hi, j_lo, cols in mergesweep.level_trips(k, te, len(ops)):
                mergesweep.hyper_stage(got, k, j_hi, j_lo, num_keys, cols)
                mergesweep.hyper_stage_plain(want, k, j_hi, j_lo, num_keys,
                                             cols)
                check_merge("hyper_stage", got, want,
                            f"{what} k={k} trip {j_hi}..{j_lo}")
                trips.append([k, j_hi, j_lo, cols])
            k *= 2
        return trips

    idx = torch.arange(N, dtype=torch.int32, device=dev)
    gen13 = torch.Generator(device=dev)
    gen13.manual_seed(SEED + 13)
    for name, entropy, equal in (("uniform", gstt.EntropyPreset.E100, False),
                                 ("E020", gstt.EntropyPreset.E020, False),
                                 ("all_equal", None, True)):
        if equal:
            x = torch.full((N,), 0x1234ABCD, dtype=torch.int32, device=dev)
        else:
            x = codec.encode_biased(prng.make_test_keys(
                N, SEED + 14, torch.uint32, entropy, device=dev))
        rides = tuple(prng.hybrid_taus_bits(N, SEED + j, device=dev)
                      .view(torch.int32) for j in (15, 16))
        # 3 planes (2 keys) is the (code, index, payload) of pairs and
        # argsort, 4 planes (2 keys) the 64-bit pairs', each at its own
        # tile; the hyper trips of every network level above the tile (the
        # sort's whole trip schedule), and on uniform keys also a key plane
        # of 16 values with a distinct rider (2 planes, 1 key: equal keys
        # make both sides of a pair take one element)
        cases = ((1, 1), (3, 2), (4, 2)) + (((2, 1),) if name == "uniform"
                                            else ())
        for num_ops, num_keys in cases:
            tied = (num_ops, num_keys) == (2, 1)
            tr = bitonic.network_tile_rows(dev, num_ops)
            te = tr * LANES
            ops = [x.view(-1, LANES), idx.view(-1, LANES),
                   rides[0].view(-1, LANES), rides[1].view(-1, LANES)]
            ops = ops[:num_ops]
            if tied:
                ops[0] = (x & 15).view(-1, LANES)
            else:
                for k in (te // 4, 2 * te, N):
                    check_merge("merge_tail", *in_place_pair(
                        mergesweep.merge_tail, mergesweep.merge_tail_plain,
                        ops, k, tr, num_keys),
                        f"{name} k={k}, {num_ops} planes")
            trips = check_trips(ops, num_keys, te,
                                f"{name}, {num_ops} planes")
            emit(phase="kernel_vs_plain", kernel="merge_tail+hyper_stage",
                 input=name, planes=num_ops, num_keys=num_keys, n=N,
                 tile_rows=tr, tie_heavy_key=tied,
                 tail_k=[] if tied else [te // 4, 2 * te, N],
                 trips=len(trips), trip_schedule=trips, bit_exact=True)
            del ops

        # the digit-plane pass into 16 row-aligned regions of slack 1.35
        rows = N // LANES
        cap_rows = splitsweep._cap_rows(rows, 1.35)
        bases = (torch.arange(16, dtype=torch.int32, device=dev)
                 * (cap_rows * LANES))
        planes3 = [x.view(rows, LANES), rides[0].view(rows, LANES),
                   rides[1].view(rows, LANES)]
        for bname in ("uniform", "skewed"):
            r = torch.randint(0, 16 if bname == "uniform" else 12,
                              (rows, LANES), generator=gen13, device=dev,
                              dtype=torch.int32)
            if bname == "skewed":    # buckets 6-9 empty, the rest 1/12 each
                r = (r + 4 * (r >= 6)).to(torch.int32)
            for n_planes in (1, 2, 3):
                ops = planes3[:n_planes]

                def run(fn):
                    out = [torch.zeros(16 * cap_rows, LANES,
                                       dtype=torch.int32, device=dev)
                           for _ in ops]
                    outs, cur = fn(ops, bases, 0, r16_rows, out, digits=r)
                    return outs + [cur]
                check_merge("binning_digits", run(radix16.binning_pass),
                            run(radix16.binning_pass_plain),
                            f"{name} {bname} buckets, {n_planes} planes")
                emit(phase="kernel_vs_plain", kernel="binning_pass_digits",
                     input=name, buckets=bname, planes=n_planes, n=N,
                     tile_rows=r16_rows, cap_rows=cap_rows, bit_exact=True)
            del r
        torch.cuda.synchronize()
        del x, rides, planes3
        free()
    del idx
    free()

    # ---- phase 14: splitsweep and mergesweep through the entry points ----
    last_fns = {"merge_tail": mergesweep.merge_tail,
                "hyper_stage": mergesweep.hyper_stage,
                "global_stage": bitonic.global_stage,
                "binning_pass": radix16.binning_pass,
                "compact_ops": stitch.compact_ops}

    def last_counts():
        return tuple(f.launches for f in last_fns.values())

    seg_default = gstt.get_routing_parameters(info).mergesweep_seg_elems

    def merge_launches(num_ops, hyper):
        L = min(seg_default, N)
        te = bitonic.network_tile_rows(dev, num_ops) * LANES
        tails = glob = trips = 0
        k = 2 * L
        while k <= N:
            tails += 1
            if k > te and hyper:
                trips += len(mergesweep.level_trips(k, te, num_ops))
            elif k > te:
                glob += (k // te).bit_length() - 1
            k *= 2
        return (tails, trips, glob, 0, 0)

    def last_expected(variant, num_ops, hyper):
        if variant == "splitsweep":
            return (0, 0, 0, 1, 1)
        return merge_launches(num_ops, hyper)

    last_runs = []

    def last_call(label, fn, want):
        before = last_counts()
        out = fn()
        torch.cuda.synchronize()
        delta = tuple(a - b for a, b in zip(last_counts(), before))
        _require(delta == want, f"{label}: launches {delta} != {want}")
        last_runs.append({"call": label, "launches": dict(zip(last_fns,
                                                               delta))})
        return out

    for f in last_fns.values():
        f.launches = 0
    # mergesweep with the hyper switch on (the default) on every entry
    # point, then off (one global stage a stride) on keys and pairs
    hyper_default = mergesweep._USE_HYPER
    for variant, hyper in (("splitsweep", True), ("mergesweep", True),
                           ("mergesweep", False)):
        mergesweep._USE_HYPER = hyper
        full = hyper
        tag = f"{variant}{'' if hyper else ' global'}"
        pal = {"backend": gstt.Backend.PALLAS, "variant": variant}
        for kname, make in key_cases if full else key_cases[:1]:
            keys = make()
            perm = oracle_perm(keys)
            for order in orders if full else orders[:1]:
                out = last_call(f"{tag} {kname} {order.value}",
                                lambda: gstt.sort(keys, order=order, **pal),
                                last_expected(variant, 1, hyper))
                _require(same_bits(out, keys, perm, order),
                         f"{tag} {kname} {order.value} != torch.sort")
                del out
            del keys, perm
            free()
        for pname, pdtype, m_ops in ((("sort_pairs_u32", torch.uint32, 3),
                                      ("sort_pairs_i64", torch.int64, 4))
                                     if full else
                                     (("sort_pairs_u32", torch.uint32, 3),)):
            keys, vals = prng.make_test_pairs(N, SEED + 7, torch.uint32,
                                              pdtype, gstt.EntropyPreset.E033,
                                              device=dev)
            perm = oracle_perm(keys)
            for order in orders if full else orders[:1]:
                ok, ov = last_call(
                    f"{tag} {pname} {order.value}",
                    lambda: gstt.sort_pairs(keys, vals, order=order, **pal),
                    last_expected(variant, m_ops, hyper))
                _require(same_bits(ok, keys, perm, order)
                         and same_bits(ov, vals, perm, order),
                         f"{tag} {pname} {order.value} != torch.sort")
                _require(int(validate.count_pair_violations(ok, ov, order))
                         == 0, f"{tag} {pname}: stability violated")
                del ok, ov
            if pdtype == torch.int64:
                lo, hi = codec.split_wide(vals)
                for order in orders:
                    gk, glo, ghi = last_call(
                        f"{tag} sort_pairs_wide {order.value}",
                        lambda: gstt.sort_pairs_wide(keys, lo, hi,
                                                     order=order, **pal),
                        last_expected(variant, 4, hyper))
                    _require(same_bits(gk, keys, perm, order)
                             and same_bits(glo, lo, perm, order)
                             and same_bits(ghi, hi, perm, order),
                             f"{tag} sort_pairs_wide {order.value} "
                             "!= torch.sort")
                    del gk, glo, ghi
                del lo, hi
            del keys, vals, perm
            free()
        if full:
            keys = prng.make_test_keys(N, SEED + 8, torch.uint32,
                                       gstt.EntropyPreset.E081, device=dev)
            perm = oracle_perm(keys).to(torch.int32)
            for order in orders:
                out = last_call(f"{tag} argsort {order.value}",
                                lambda: gstt.argsort(keys, order=order,
                                                     **pal),
                                last_expected(variant, 3, hyper))
                _require(torch.equal(out, flip(perm, order)),
                         f"{tag} argsort {order.value} != torch.sort")
                del out
            del keys, perm
            free()
    mergesweep._USE_HYPER = hyper_default
    last_launches = dict(zip(last_fns, last_counts()))
    _require(all(v > 0 for v in last_launches.values()),
             f"splitsweep/mergesweep missed a kernel: {last_launches}")
    emit(phase="pallas_path_splitsweep_mergesweep", n=N,
         mergesweep_seg_elems=seg_default,
         network_tile_rows={k: bitonic.network_tile_rows(dev, k)
                            for k in (1, 3, 4)},
         splitsweep_tile_rows=r16_rows, splitsweep_fallbacks=0,
         launches=last_launches, runs=last_runs, bit_exact=True)

    # the digit-plane pass and the compact of a splitsweep keys call, a
    # pairs call (2 planes) and a 64-bit pairs call (3 planes), at their
    # shapes: each sort records its calls' operands and answers them with
    # the plain versions, so that no launch counter moves; each kernel is
    # then held bit for bit against its plain version on the same operands
    # (compact on [:count] and the count, over 16 * cap_rows * 128 slots
    # with a prefix mask per region) and timed
    real_ss = {"binning": radix16.binning_pass,
               "compact": stitch.compact_ops}
    ss_calls = []

    def rec_binning(planes, cursors, shift, tile_rows, out=None,
                    digits=None):
        ss_calls.append(("binning", (tuple(planes), cursors, shift,
                                     tile_rows, out[0].shape[0], digits)))
        return radix16.binning_pass_plain(planes, cursors, shift, tile_rows,
                                          out, digits)

    def rec_compact(planes, mask):
        ss_calls.append(("compact", (tuple(planes), mask)))
        return stitch.compact_plain(tuple(planes), mask)

    def ss_binning(fn, planes, cursors, shift, tile_rows, out_rows, digits):
        out = [torch.zeros(out_rows, LANES, dtype=torch.int32, device=dev)
               for _ in planes]
        outs, cur = fn(list(planes), cursors, shift, tile_rows, out,
                       digits=digits)
        return list(outs) + [cur]

    keys = prng.make_test_keys(N, SEED + 17, torch.uint32,
                               gstt.EntropyPreset.E033, device=dev)
    pal = {"backend": gstt.Backend.PALLAS, "variant": "splitsweep"}
    ss_shapes = []
    for label, sort in (
            ("keys", lambda: gstt.sort(keys, **pal)),
            ("pairs_u32", lambda: gstt.sort_pairs(
                keys, prng.hybrid_taus_bits(N, SEED + 18, device=dev),
                **pal)),
            ("pairs_i64", lambda: gstt.sort_pairs(
                keys, torch.arange(N, dtype=torch.int64, device=dev),
                **pal))):
        radix16.binning_pass = rec_binning
        stitch.compact_ops = rec_compact
        try:
            sort()
        finally:
            radix16.binning_pass = real_ss["binning"]
            stitch.compact_ops = real_ss["compact"]
        _require([k for k, _ in ss_calls] == ["binning", "compact"],
                 f"splitsweep {label} calls {[k for k, _ in ss_calls]}")
        for kname, args in ss_calls:
            if kname == "binning":
                planes, cursors, shift, tr, out_rows, digits = args
                what = f"splitsweep {label}, {len(planes)} planes"
                check_merge("binning_digits",
                            ss_binning(real_ss["binning"], *args),
                            ss_binning(radix16.binning_pass_plain, *args),
                            what)
                out_t = [torch.empty(out_rows, LANES, dtype=torch.int32,
                                     device=dev) for _ in planes]
                ms = median_ms(lambda: real_ss["binning"](
                    list(planes), cursors, shift, tr, out_t, digits=digits))
                del out_t
                n_slots = count = planes[0].numel()
            else:
                planes, mask = args
                what = f"splitsweep {label}, {len(planes)} planes, n " \
                       f"{mask.numel()}"
                (packed, cnt), (wpacked, wcnt) = (
                    real_ss["compact"](planes, mask),
                    stitch.compact_plain(planes, mask))
                count = int(wcnt)
                _require(int(cnt) == count,
                         f"compact count {int(cnt)} != {count} on {what}")
                check_stitch("compact", [p[:count] for p in packed],
                             [w[:count] for w in wpacked], what)
                del packed, wpacked
                ms = median_ms(lambda: real_ss["compact"](planes, mask))
                n_slots = mask.numel()
            ss_shapes.append({"call": label, "kernel": kname,
                              "planes": len(planes), "n": n_slots,
                              "count": count, "ms": ms})
        ss_calls.clear()
        free()
    del keys, args, planes, mask, cursors, digits
    free()
    emit(phase="splitsweep_at_shape", calls=ss_shapes, bit_exact=True)

    # ---- phase 15: times ---------------------------------------------------
    payload = torch.arange(N, dtype=torch.int32, device=dev)
    whats = (("keys", lambda b, v: lambda k: gstt.sort(k, backend=b,
                                                       variant=v)),
             ("pairs", lambda b, v: lambda k: gstt.sort_pairs(
                 k, payload, backend=b, variant=v)),
             ("argsort", lambda b, v: lambda k: gstt.argsort(k, backend=b,
                                                             variant=v)))

    def e2e_ms(fn):
        r = timing.batch_timing(fn, N, batch=1, repeats=batch, seed=SEED,
                                device=dev)
        free()
        return r["seconds_per_sort"] * 1e3, [r["spread_min_s"] * 1e3,
                                             r["spread_max_s"] * 1e3]

    for what, make_fn in whats:
        routes = [(f"pallas_{v}", gstt.Backend.PALLAS, v)
                  for v in ("splitsweep", "mergesweep", "radix16",
                            "device_radix")]
        routes.append(("flat_torch_sort", gstt.Backend.XLA, "onesweep"))
        for route, backend, variant in routes:
            ms, spread = e2e_ms(make_fn(backend, variant))
            emit(phase="end_to_end", what=what, route=route, n=N,
                 batch=batch, ms=ms, spread_ms=spread)
        mergesweep._USE_HYPER = False
        try:
            ms, spread = e2e_ms(make_fn(gstt.Backend.PALLAS, "mergesweep"))
        finally:
            mergesweep._USE_HYPER = hyper_default
        emit(phase="end_to_end", what=what, route="pallas_mergesweep_global",
             n=N, batch=batch, ms=ms, spread_ms=spread)

    # mergesweep's segment length, the switch off and on, up to 2^27 (one
    # merge pass); L = N (one segment) is the flat torch.sort, no merge
    # kernel, read once beside them
    row = gstt.get_routing_parameters(info)
    seg_lengths = (1 << 20, 1 << 22, 1 << 24, 1 << 26, 1 << 27)
    seg_sweep = {}
    try:
        for seg in seg_lengths + (N,):
            gstt.set_routing_override(dataclasses.replace(
                row, mergesweep_seg_elems=seg))
            for hyper in (False, True) if seg < N else (False,):
                mergesweep._USE_HYPER = hyper
                for what, make_fn in whats[:2]:
                    ms, spread = e2e_ms(make_fn(gstt.Backend.PALLAS,
                                                "mergesweep"))
                    seg_sweep[what, seg, hyper] = ms
                    emit(phase="mergesweep_seg_sweep", what=what,
                         seg_elems=seg, hyper=hyper, n=N, batch=batch,
                         ms=ms, spread_ms=spread)
    finally:
        gstt.clear_routing_override()
        mergesweep._USE_HYPER = hyper_default
    best = min(seg_lengths, key=lambda s: seg_sweep["keys", s, True])
    emit(phase="mergesweep_seg_best", what="keys", hyper=True,
         seg_elems=best, ms=seg_sweep["keys", best, True],
         one_segment_ms=seg_sweep["keys", N, False],
         installed=row.mergesweep_seg_elems)

    x = codec.encode_biased(prng.make_test_keys(N, SEED, torch.uint32,
                                                device=dev))
    # where a keys sort's time goes: mergesweep at the row's segment
    # length with the switch on (the default), splitsweep at the row's tile
    K = N // seg_default
    runs1 = mergesweep._phase1([x], 1, K, seg_default)
    tr1 = bitonic.network_tile_rows(dev, 1)
    steps = {"phase1_segment_sorts": median_ms(
        lambda: mergesweep._phase1([x], 1, K, seg_default))}
    k = 2 * seg_default
    while k <= N:
        work = [y.clone() for y in runs1]
        steps[f"merge_pass_k{k}"] = median_ms(
            lambda: mergesweep._run_merge_pass(work, k, tr1, 1))
        k *= 2
    del runs1, work
    emit(phase="per_phase_mergesweep", what="keys", n=N,
         seg_elems=seg_default, hyper=hyper_default, tile_rows=tr1, ms=steps,
         sum_ms=sum(steps.values()))
    planes, bucket, counts, cap_rows, _, overflow = splitsweep._prepare(
        x, (), r16_rows, 64, 1.35)
    _require(not overflow, "splitsweep overflowed on uniform keys")
    (part,) = splitsweep._partition_16(planes, bucket, cap_rows, r16_rows)
    cap = cap_rows * LANES
    valid = splitsweep._valid(counts, cap)
    regions = torch.where(valid, part.view(16, cap), splitsweep.SENTINEL)
    sorted_regions = torch.sort(regions, dim=1).values
    steps = {
        "splitters_buckets_counts": median_ms(lambda: splitsweep._prepare(
            x, (), r16_rows, 64, 1.35)),
        "partition": median_ms(lambda: splitsweep._partition_16(
            planes, bucket, cap_rows, r16_rows)),
        "mask_and_region_sort": median_ms(lambda: torch.sort(torch.where(
            valid, part.view(16, cap), splitsweep.SENTINEL), dim=1)),
        "compact": median_ms(lambda: stitch.compact_ops(
            (sorted_regions.view(-1),), valid.view(-1))),
    }
    emit(phase="per_phase_splitsweep", what="keys", n=N, tile_rows=r16_rows,
         cap_rows=cap_rows, ms=steps, sum_ms=sum(steps.values()))
    del planes, bucket, part, valid, regions, sorted_regions
    free()
    plane_ms = 8 * N / bw * 1e3
    last_times = {}
    # the merge tail at k = 2^28 on 1 plane (1 key) and 3 planes (2 keys:
    # pairs and argsort), each beside the network's own tail (local_stages
    # on the same strides, new planes out) timed in turn
    for num_ops, num_keys in ((1, 1), (3, 2)):
        tr = bitonic.network_tile_rows(dev, num_ops)
        te = tr * LANES
        mt = [x.clone().view(-1, LANES)] + [
            payload.clone().view(-1, LANES) for _ in range(num_ops - 1)]
        sched = bitonic.tail_schedule(te, N)
        stages = sched.shape[0]
        per_pair = 2 * (2 * num_keys - 1) + 2 * num_ops
        ops_ms = stages * (N // 2) * per_pair / PEAK_OPS_32 * 1e3
        bytes_ms = num_ops * plane_ms
        suffix = "" if num_ops == 1 else f"_{num_ops}"
        last_times["merge_tail" + suffix] = dict(
            ms=median_ms(lambda: mergesweep.merge_tail(mt, N, tr, num_keys)),
            local_stages_tail_ms=median_ms(lambda: bitonic.local_stages(
                mt, sched, num_keys, tr)),
            plain_ms=median_ms(lambda: mergesweep.merge_tail_plain(
                mt, N, tr, num_keys), iters=3),
            stages=stages, planes=num_ops, num_keys=num_keys, tile_rows=tr,
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        del mt
    # the first trip of the 2^28 level (7 stages) on 1 plane (1 key) and 3
    # planes (2 keys), bound by bytes (the planes read and written once);
    # the shared-memory traffic the design leaves it: a write and a read of
    # every element a plane for each transpose between register runs,
    # ceil(stages / e) - 1 of them, e = log2 of the int4 a thread holds
    for num_ops, num_keys in ((1, 1), (3, 2)):
        te = bitonic.network_tile_rows(dev, num_ops) * LANES
        j_hi, j_lo, cols = mergesweep.level_trips(N, te, num_ops)[0]
        stages = (2 * j_hi // j_lo).bit_length() - 1
        e = mergesweep.HYPER_ITEMS[num_ops].bit_length() - 1
        transposes = -(-stages // e) - 1
        hp = [x.clone().view(-1, LANES)] + [
            payload.clone().view(-1, LANES) for _ in range(num_ops - 1)]
        suffix = "" if num_ops == 1 else f"_{num_ops}"
        last_times["hyper_stage" + suffix] = dict(
            ms=median_ms(lambda: mergesweep.hyper_stage(
                hp, N, j_hi, j_lo, num_keys, cols)),
            plain_ms=median_ms(lambda: mergesweep.hyper_stage_plain(
                hp, N, j_hi, j_lo, num_keys, cols), iters=3),
            stages=stages, planes=num_ops, num_keys=num_keys,
            trip=[j_hi, j_lo, cols], bound_ms=num_ops * plane_ms,
            bound_by="bytes", smem_transposes=transposes,
            smem_bytes=transposes * 8 * N * num_ops)
        del hp
    rows = N // LANES
    cap_rows = splitsweep._cap_rows(rows, 1.35)
    bases = (torch.arange(16, dtype=torch.int32, device=dev)
             * (cap_rows * LANES))
    pos = torch.arange(N, dtype=torch.int32, device=dev)
    spl_c, spl_p = splitsweep._sample_splitters(x, pos, 64)
    bucket = splitsweep._bucketize(x, pos, spl_c, spl_p).view(rows, LANES)
    del pos
    for n_planes in (1, 3):
        ops = [x.view(rows, LANES)] + [payload.view(rows, LANES)] * (
            n_planes - 1)
        out = [torch.empty(16 * cap_rows, LANES, dtype=torch.int32,
                           device=dev) for _ in ops]
        last_times[f"binning_digits_{n_planes}"] = dict(
            ms=median_ms(lambda: radix16.binning_pass(
                ops, bases, 0, r16_rows, out, digits=bucket)),
            plain_ms=median_ms(lambda: radix16.binning_pass_plain(
                ops, bases, 0, r16_rows, out, digits=bucket), iters=3),
            bound_ms=(4 + 8 * n_planes) * N / bw * 1e3, bound_by="bytes",
            cap_rows=cap_rows)
        del out
    for kname, rec in last_times.items():
        emit(phase="per_kernel", kernel=kname, n=N, library_ms=None,
             library="none: no one torch call runs a partial Batcher merge "
                     "or places a partition at given cursors", **rec)
    del x, bucket, payload
    free()

    # ---- phase 16: the exchange's masking kernel against its plain version
    # at the receive buffer of one rank in an 8-GPU sort of 2^30 pairs
    # (configs[4]): D = 8 blocks of the 2^25 rung
    d8, cap8 = 8, 1 << 25
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)

    def rc_of(kind):
        if kind == "uniform":      # near the mean cell, 2^24
            return (1 << 24) + torch.randint(-4096, 4096, (d8,), generator=gen,
                                             device=dev, dtype=torch.int32)
        if kind == "mix":
            return torch.tensor([0, 1, cap8 // 3, cap8 - 1, cap8, cap8 + 5,
                                 1 << 24, 12345], dtype=torch.int32,
                                device=dev)
        fill = {"zero": 0, "full": cap8, "truncated": cap8 + 999}[kind]
        return torch.full((d8,), fill, dtype=torch.int32, device=dev)

    mask_err = 0
    mask_times = {}
    # odd_windows: rows starting at every 4-byte offset mod 16, so the
    # kernel's scalar head and end run beside its 16-byte stores
    odd = (0, 1, cap8 // 4 + 3, cap8 // 2 + 2, cap8 - 5, cap8)
    forms = {"whole": [(0, cap8, None)],
             "chunks": [(c * cap8 // 4, (c + 1) * cap8 // 4, None)
                        for c in range(4)],
             "sources": [(0, cap8, range(s, s + 1)) for s in range(d8)],
             "odd_windows": [(a, b, None) for a, b in zip(odd, odd[1:])]}
    for num_ops in (2, 3):
        fills = (codec.SENTINEL, -1, 0)[:num_ops]
        base = [torch.randint(-2**31, 2**31 - 1, (d8, cap8), generator=gen,
                              device=dev, dtype=torch.int32)
                for _ in range(num_ops)]
        for kind in ("uniform", "zero", "full", "truncated", "mix"):
            rc = rc_of(kind)
            want = [b.clone() for b in base]
            rx.mask_arrivals_plain(want, rc, fills)
            for form, calls in forms.items():
                got = [b.clone() for b in base]
                before = rx.mask_arrivals.launches
                for a, b, src in calls:
                    rx.mask_arrivals([g[:, a:b] for g in got], rc, fills,
                                     col0=a, sources=src)
                torch.cuda.synchronize()
                _require(rx.mask_arrivals.launches - before == len(calls),
                         f"mask_arrivals {form}: launches")
                for g, w in zip(got, want):
                    mask_err = max(mask_err, int(
                        (g.to(torch.int64) - w).abs().max()))
                    _require(torch.equal(g, w), f"mask_arrivals {num_ops} "
                             f"operands, {kind} counts, {form} != plain")
                del got
            del want
            emit(phase="kernel_vs_plain", kernel="mask_arrivals", d=d8,
                 cap=cap8, operands=num_ops, counts=kind,
                 forms=list(forms), bit_exact=True)
        rc = rc_of("uniform")
        tail = int((cap8 - rc.clamp(max=cap8)).sum())
        pos8 = torch.arange(cap8, device=dev)

        def library():
            masked = pos8[None, :] >= rc[:, None]
            for w, f in zip(base, fills):
                w.masked_fill_(masked, f)

        # bytes: the tail written once (the kernel reads D counts); for
        # reference the read-and-write form moves every slot twice
        mask_times[num_ops] = dict(
            ms=median_ms(lambda: rx.mask_arrivals(base, rc, fills)),
            plain_ms=median_ms(lambda: rx.mask_arrivals_plain(base, rc,
                                                              fills),
                               iters=3),
            library_ms=median_ms(library),
            bound_ms=4 * tail * num_ops / bw * 1e3, bound_by="bytes",
            read_write_bound_ms=8 * d8 * cap8 * num_ops / bw * 1e3,
            tail_slots=tail)
        emit(phase="per_kernel", kernel="mask_arrivals", d=d8, cap=cap8,
             operands=num_ops, counts="uniform",
             library="masked_fill_ per plane, the mask built in the call",
             **mask_times[num_ops])
        if num_ops == 3:
            # every slot masked: the whole window written once
            rc0 = rc_of("zero")
            mask_times["zero"] = dict(
                ms=median_ms(lambda: rx.mask_arrivals(base, rc0, fills)),
                plain_ms=median_ms(lambda: rx.mask_arrivals_plain(
                    base, rc0, fills), iters=3),
                bound_ms=4 * d8 * cap8 * num_ops / bw * 1e3,
                bound_by="bytes", tail_slots=d8 * cap8)
            emit(phase="per_kernel", kernel="mask_arrivals", d=d8,
                 cap=cap8, operands=num_ops, counts="zero",
                 **mask_times["zero"])
        del base
        free()

    # ---- phase 17: the distributed sort at one NCCL rank, n = 2^28 -------
    rendezvous = tempfile.TemporaryDirectory()
    dist.init_process_group(
        "nccl", init_method=f"file://{rendezvous.name}/rendezvous", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=300), device_id=dev)
    u32 = prng.make_test_keys(N, SEED + 17, torch.uint32, device=dev)
    vals17 = torch.arange(N, dtype=torch.int32, device=dev).view(torch.uint32)
    maxc = u32.clone()
    maxc.view(torch.int32)[::5] = -1
    cases17 = (("u32_keys", u32, None), ("u32_pairs", u32, vals17),
               ("f32_keys", f32_keys(), None),
               ("all_equal_pairs", torch.full((N,), 0x1234ABCD,
                                              dtype=torch.int32,
                                              device=dev).view(torch.uint32),
                vals17),
               ("max_code_keys", maxc, None))

    def check17(name, keys, values, res, valid, overflow):
        want, perm = torch.sort(codec.encode_biased(keys), stable=True)
        got = codec.bias(res["codes"])
        _require(int(res["count"]) == valid, f"{name}: count "
                 f"{int(res['count'])} != {valid}")
        _require(int(res["overflow"]) == overflow, f"{name}: overflow "
                 f"{int(res['overflow'])} != {overflow}")
        _require(torch.equal(got[:valid], want[:valid]),
                 f"{name}: codes != flat torch.sort")
        _require(bool((got[valid:] == codec.SENTINEL).all()),
                 f"{name}: code tail is not the sentinel")
        gidx = res["global_index"].view(torch.int32)
        _require(torch.equal(gidx[:valid], perm[:valid].to(torch.int32))
                 and bool((gidx[valid:] == -1).all()),
                 f"{name}: global index != the stable permutation")
        if values is not None:
            pb = res["payload_bits"].view(torch.int32)
            _require(torch.equal(pb[:valid], values.view(torch.int32)[
                perm[:valid]]) and bool((pb[valid:] == 0).all()),
                f"{name}: payload != the stable permutation")

    dist_runs = []
    rx.mask_arrivals.launches = 0
    dist_merge.merge_runs.launches = 0

    def merged(what, before):
        """Each distributed_sort call merges through the kernel: two
        launches."""
        _require(dist_merge.merge_runs.launches - before == 2,
                 f"{what}: {dist_merge.merge_runs.launches - before} "
                 f"merge_runs launches, expected 2")

    for exchange in ("collective", "remote_dma"):
        for name, keys, values in cases17:
            before = rx.mask_arrivals.launches
            merges = dist_merge.merge_runs.launches
            res = gstt.distributed_sort(keys, values, exchange=exchange)
            torch.cuda.synchronize()
            launched = rx.mask_arrivals.launches - before
            expect = 1 if exchange == "remote_dma" else \
                dist_sort._chunking(res["cap"], 4)[0]
            _require(launched == expect, f"{name} {exchange}: {launched} "
                     f"mask_arrivals launches, expected {expect}")
            merged(f"{name} {exchange}", merges)
            check17(name, keys, values, res, N, 0)
            dist_runs.append([name, exchange, launched, res["cap"]])
            del res
            free()
        small = 1 << 20
        before = rx.mask_arrivals.launches
        merges = dist_merge.merge_runs.launches
        res = gstt.distributed_sort(u32, cap_elems=small, exchange=exchange)
        merged(f"cap 2^20 {exchange}", merges)
        check17("u32_keys_cap_2^20", u32, None, res, small, N - small)
        dist_runs.append(["u32_keys_cap_2^20", exchange,
                          rx.mask_arrivals.launches - before, small])
        del res
        out, ovf = gstt.distributed_sort_gather(u32, vals17, cap_elems=small,
                                                exchange=exchange)
        want = gstt.sort_pairs(u32, vals17, backend=gstt.Backend.XLA)
        _require(ovf == 0 and all(torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))
                                  for a, b in zip(out, want)),
                 f"distributed_sort_gather retry ({exchange}) != flat sort")
        del out, want
        free()
        # a fixed cap above n: the kernel masks a real tail on the path, the
        # last 2^20 slots of the one cell (in the last of 4 chunks, or the
        # ring's own block); each window it masked is replayed from what was
        # sent (one rank receives what it sent) by the plain version, which
        # launches nothing
        big = N + (1 << 20)
        real_exchange = dist_sort._exchange

        def replayed_exchange(send, counts, group, fills, exchange):
            recv, rc = real_exchange(send, counts, group, fills, exchange)
            chunks, _, cw = send[0].shape
            for c in range(chunks):
                want = [x[c].clone() for x in send]
                rx.mask_arrivals_plain(want, rc, fills, col0=c * cw)
                big_windows.append([c * cw, cw, max(
                    int((r[c].to(torch.int64) - w).abs().max())
                    for r, w in zip(recv, want))])
                del want
            return recv, rc

        big_windows = []
        before = rx.mask_arrivals.launches
        merges = dist_merge.merge_runs.launches
        dist_sort._exchange = replayed_exchange
        try:
            res = gstt.distributed_sort(u32, vals17, cap_elems=big,
                                        exchange=exchange)
            torch.cuda.synchronize()
        finally:
            dist_sort._exchange = real_exchange
        launched = rx.mask_arrivals.launches - before
        expect = 1 if exchange == "remote_dma" else 4
        _require(launched == expect, f"cap n + 2^20 {exchange}: {launched} "
                 f"mask_arrivals launches, expected {expect}")
        merged(f"cap n + 2^20 {exchange}", merges)
        mask_err = max([mask_err] + [e for _, _, e in big_windows])
        _require(len(big_windows) == expect
                 and all(e == 0 for _, _, e in big_windows),
                 f"cap n + 2^20 {exchange}: a masked window != plain "
                 f"{big_windows}")
        _require(res["cap"] == big, f"cap n + 2^20: cap {res['cap']}")
        check17("u32_pairs_cap_n+2^20", u32, vals17, res, N, 0)
        dist_runs.append(["u32_pairs_cap_n+2^20", exchange, launched, big,
                          big_windows])
        del res
        free()
    mask_launches = rx.mask_arrivals.launches
    merge_launches = dist_merge.merge_runs.launches
    emit(phase="distributed_path", n=N, ranks=1, backend="nccl",
         runs=dist_runs, mask_arrivals_launches=mask_launches,
         merge_runs_launches=merge_launches, bit_exact=True)
    # the kernel at the path's shape: the last collective chunk of the
    # cap n + 2^20 run, 3 planes of (1, (n + 2^20) / 4) at col0 = 3/4 of the
    # cell, whose last 2^20 slots are tail
    cw = big // 4
    path_planes = [torch.randint(-2**31, 2**31 - 1, (1, cw), generator=gen,
                                 device=dev, dtype=torch.int32)
                   for _ in range(3)]
    path_rc = torch.tensor([N], dtype=torch.int32, device=dev)
    fills = (codec.SENTINEL, -1, 0)
    path_pos = torch.arange(3 * cw, 4 * cw, device=dev)

    def path_library():
        # masked_fill_ per plane, the mask built in the call
        masked = path_pos[None, :] >= path_rc[:, None]
        for w, f in zip(path_planes, fills):
            w.masked_fill_(masked, f)

    # ms: one call between two events, the host's issue time included when
    # the card is idle; device_ms: 200 calls queued behind a spin, so the
    # events bracket the card's work alone
    path_times = dict(
        ms=median_ms(lambda: rx.mask_arrivals(path_planes, path_rc, fills,
                                              col0=3 * cw)),
        device_ms=timing.queued_device_time_ms(
            lambda: rx.mask_arrivals(path_planes, path_rc, fills,
                                     col0=3 * cw), iters=200, device=dev),
        plain_ms=median_ms(lambda: rx.mask_arrivals_plain(
            path_planes, path_rc, fills, col0=3 * cw)),
        library_ms=median_ms(path_library),
        library_device_ms=timing.queued_device_time_ms(
            path_library, iters=200, device=dev),
        bound_ms=4 * (big - N) * 3 / bw * 1e3)
    emit(phase="per_kernel", kernel="mask_arrivals", d=1, width=cw,
         col0=3 * cw, operands=3, tail_slots=big - N,
         library="masked_fill_ per plane, the mask built in the call",
         **path_times)
    del path_pos
    # a full chunk at the path's shape: the 2^28 ladder's chunk of 2^26
    # slots with no tail, as 60 of the path's 65 launches find their cells;
    # the bound is the one count read
    full_planes = [p[:, :N // 4] for p in path_planes]
    full_times = dict(
        ms=median_ms(lambda: rx.mask_arrivals(full_planes, path_rc, fills)),
        device_ms=timing.queued_device_time_ms(
            lambda: rx.mask_arrivals(full_planes, path_rc, fills),
            iters=200, device=dev),
        plain_ms=median_ms(lambda: rx.mask_arrivals_plain(
            full_planes, path_rc, fills)),
        bound_ms=4 / bw * 1e3, bound_by="bytes")
    emit(phase="per_kernel", kernel="mask_arrivals", d=1, width=N // 4,
         col0=0, operands=3, tail_slots=0, **full_times)
    del path_planes, full_planes

    dist_times = {}
    for what, values in (("keys", None), ("pairs", vals17)):
        for exchange in ("collective", "remote_dma"):
            dist_times[f"{what}_{exchange}"] = median_ms(
                lambda: gstt.distributed_sort(u32, values, exchange=exchange))
        dist_times[f"{what}_flat_torch_sort"] = median_ms(
            (lambda: gstt.sort(u32, backend=gstt.Backend.XLA))
            if values is None else
            (lambda: gstt.sort_pairs(u32, values, backend=gstt.Backend.XLA)))
        free()
    emit(phase="end_to_end_distributed", n=N, ranks=1, ms=dist_times)
    grp = dist.group.WORLD
    codes = codec.encode_biased(u32)
    pb = vals17.view(torch.int32)
    gidx = dist_sort._gidx(0, N, dev)
    steps = {"sample_splitters": median_ms(
        lambda: dist_sort._sample_splitters(codes, 0, 1, 32, grp))}
    spl_c, spl_g = dist_sort._sample_splitters(codes, 0, 1, 32, grp)
    steps["cell_counts"] = median_ms(
        lambda: dist_sort._cell_counts(codes, gidx, spl_c, spl_g, 1))
    counts = dist_sort._cell_counts(codes, gidx, spl_c, spl_g, 1)
    steps["local_sort"] = median_ms(
        lambda: dist_sort._local_sort(codes, gidx, pb))
    sorted_ops = dist_sort._local_sort(codes, gidx, pb)
    del codes, gidx
    cap17 = dist_sort._cap_ladder(N, 1)[-1]
    for exchange in ("collective", "remote_dma"):
        n_chunks = 1 if exchange == "remote_dma" else dist_sort._chunking(
            cap17, 4)[0]
        steps[f"pack_{exchange}"] = median_ms(
            lambda: dist_sort._pack(sorted_ops, counts, cap17, n_chunks))
        send = dist_sort._pack(sorted_ops, counts, cap17, n_chunks)
        steps[f"exchange_{exchange}"] = median_ms(
            lambda: dist_sort._exchange(send, counts, grp, fills, exchange))
        recv, _ = dist_sort._exchange(send, counts, grp, fills, exchange)
        del send
    flat17 = [r.view(-1) for r in recv]
    del sorted_ops
    rc17 = counts.clamp(max=cap17).contiguous()
    for ops in (2, 3):
        steps[f"merge_{ops}_operands"] = median_ms(
            lambda: dist_merge.merge_plain(flat17[:ops]))
        steps[f"merge_runs_{ops}_operands"] = median_ms(
            lambda: dist_merge.merge_runs(recv[:ops], rc17, cap17, cap17,
                                          fills[:ops]))
    emit(phase="per_step_distributed", what="pairs", n=N, ranks=1, cap=cap17,
         ms=steps)
    del flat17, recv, u32, vals17, maxc, cases17
    dist.destroy_process_group()
    rendezvous.cleanup()
    free()

    # ---- phase 18: four ranks on the one card ----------------------------
    # NCCL refuses two ranks on one GPU, and gloo's point-to-point ops take
    # no CUDA tensor, so the ranks share the card through gloo's
    # collectives, which carry CUDA tensors: the collective exchange.  Each
    # rank holds its CUDA block against the same group's CPU run.
    ranks18 = run_ranks(_phase18_rank, 4, 1 << 26, SEED + 18, timeout=600.0,
                        threads=2)
    for r, rec in enumerate(ranks18):
        _require(rec["bit_exact"], f"phase 18 rank {r}: the card's blocks "
                 f"!= the CPU run's")
    _require(sum(rec["count"] for rec in ranks18) == 1 << 26,
             "phase 18: counts do not add up to n")
    emit(phase="distributed_ranks_on_one_card", n=1 << 26, ranks=4,
         backend="gloo", exchange="collective", per_rank=ranks18,
         remote_dma=ranks18[0]["remote_dma"])

    # ---- phase 19: the row form of the downsweep (GST_MEGACORE=1) --------
    # the kernels against their plain versions at n = 2^28, at the "h100"
    # tile and at 128 rows: downsweep_rows' outputs and the side rows that
    # rowtab marks present; edge_fixup on the plain version's (rowtab, side,
    # outs); and the kernels' own chain against the element form
    t19 = time.perf_counter()
    rows_err = {"downsweep_rows": 0, "edge_fixup": 0}
    # the card's tile and one other: 128 rows, or 32 where the tile is 128
    row_tiles = (tile_rows, 128 if tile_rows != 128 else 32)

    def rcheck(kname, got, want, what):
        for g, w in zip(got, want):
            _require(g.shape == w.shape, f"{kname} shape != plain on {what}")
            if g.numel():
                err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                rows_err[kname] = max(rows_err[kname], err)
            _require(torch.equal(g, w), f"{kname} != plain on {what}")

    def sparse_codes():
        # digit 5 at shifts 0 and 28 for 1-3 keys in every 4096, digit 0
        # elsewhere: neighbouring tiles' digit-5 ranges share output rows
        x = prng.hybrid_taus_bits(N, SEED + 19, device=dev).view(
            torch.int32) & 0x0FFFFFF0
        g = torch.Generator(device=dev).manual_seed(SEED + 19)
        blocks = N // 4096
        hits = torch.randint(1, 4, (blocks,), device=dev, generator=g)
        base = torch.arange(blocks, device=dev) * 4096
        for j in range(3):
            off = torch.randint(0, 4096, (blocks,), device=dev, generator=g)
            x[(base + off)[hits > j]] |= 0x50000005
        return codec.bias(x)

    def entries_per_row(rowtab):
        named = rowtab[rowtab >= 0].long()
        return int(torch.bincount(named).max()) if named.numel() else 0

    for name, make in (
            ("uniform", lambda: codec.encode_biased(prng.make_test_keys(
                N, SEED, torch.uint32, device=dev))),
            ("E020", lambda: codec.encode_biased(prng.make_test_keys(
                N, SEED, torch.uint32, gstt.EntropyPreset.E020,
                device=dev))),
            ("all_equal", lambda: torch.full((N,), 0x1234ABCD,
                                             dtype=torch.int32, device=dev)),
            ("sparse_digit", sparse_codes)):
        x = make()
        rides = tuple(prng.hybrid_taus_bits(N, SEED + j, device=dev)
                      .view(torch.int32) for j in (1, 2))
        for rows_t in row_tiles:
            planes, _ = rts.pad_tiles((x,) + rides, rows_t)
            for shift in (0, 28):
                counts = kernels.tile_histogram4(planes[0], shift, rows_t)
                table = kernels.exclusive_scan(counts.T.reshape(-1))
                rowtab = rts.edge_rows(table, counts)
                present = (rowtab.view(2, 16, -1) >= 0).permute(2, 1, 0)
                shared = entries_per_row(rowtab)
                if name == "sparse_digit":
                    _require(shared >= 3, f"sparse_digit at {rows_t} rows, "
                             f"shift {shift}: at most {shared} entries a row")
                for ops in (planes[:1], planes[:2], planes):
                    what = (f"{name} {rows_t} rows shift {shift}, "
                            f"{len(ops)} planes")
                    mask = present.unsqueeze(1).expand(
                        -1, len(ops), -1, -1).reshape(-1)
                    outs, side = rts.downsweep_rows(ops, table, counts,
                                                    shift, rows_t)
                    w_outs, w_side = rts.downsweep_rows_plain(
                        ops, table, counts, shift, rows_t)
                    rcheck("downsweep_rows", outs + [side[mask]],
                           w_outs + [w_side[mask]], what)
                    del mask
                    fixed = rts.edge_fixup(rowtab, table, side, outs)
                    del side
                    got = rts.edge_fixup(rowtab, table, w_side,
                                         [o.clone() for o in w_outs])
                    want = rts.edge_fixup_plain(rowtab, table, w_side,
                                                w_outs)
                    rcheck("edge_fixup", got, want, what)
                    del got, want, w_outs, w_side
                    element = rts.downsweep(ops, table, shift, rows_t)
                    _require(all(torch.equal(f, e) for f, e in
                                 zip(fixed, element)),
                             f"row form != element form on {what}")
                    del fixed, element, outs
                emit(phase="kernel_vs_plain",
                     kernel="downsweep_rows+edge_fixup", input=name, shift=shift, planes=[1, 2, 3],
                     n=N, tile_rows=rows_t, max_entries_per_row=shared,
                     bit_exact=True)
            del planes, counts, table, rowtab, present
            free()
        del x, rides
        free()
    emit(phase="row_form_kernels_vs_plain_seconds",
         seconds=time.perf_counter() - t19)

    # the device_radix entry points with the gate on: every call through
    # 8 downsweep_rows and 8 edge_fixup launches, none of the element form
    megacore_was = os.environ.get("GST_MEGACORE")
    os.environ["GST_MEGACORE"] = "1"
    try:
        row_fns = (rts.downsweep_rows, rts.edge_fixup, rts.downsweep)
        for f in row_fns:
            f.launches = 0
        row_runs = []

        def row_call(label, fn):
            before = tuple(f.launches for f in row_fns)
            out = fn()
            torch.cuda.synchronize()
            delta = tuple(f.launches - b for f, b in zip(row_fns, before))
            _require(delta == (8, 8, 0), f"{label}: launches {delta} != "
                     f"(8, 8, 0) (downsweep_rows, edge_fixup, downsweep)")
            row_runs.append({"call": label, "launches": delta})
            return out

        pal = {"backend": gstt.Backend.PALLAS, "variant": "device_radix"}
        for kname, make in (
                ("sort_u32", lambda: prng.make_test_keys(
                    N, SEED + 4, torch.uint32, device=dev)),
                ("sort_i32", lambda: prng.make_test_keys(
                    N, SEED + 6, torch.int32, gstt.EntropyPreset.E054,
                    device=dev)),
                ("sort_f32", f32_keys)):
            keys = make()
            perm = oracle_perm(keys)
            for order in orders:
                out = row_call(f"{kname} {order.value}",
                               lambda: gstt.sort(keys, order=order, **pal))
                _require(same_bits(out, keys, perm, order),
                         f"row form {kname} {order.value} != torch.sort")
                del out
            del keys, perm
            free()
        keys, vals = prng.make_test_pairs(N, SEED + 7, torch.uint32,
                                          torch.uint32,
                                          gstt.EntropyPreset.E033,
                                          device=dev)
        hi = prng.hybrid_taus_bits(N, SEED + 17, device=dev)
        perm = oracle_perm(keys)
        for order in orders:
            ok, ov = row_call(f"sort_pairs_u32 {order.value}",
                              lambda: gstt.sort_pairs(keys, vals,
                                                      order=order, **pal))
            _require(same_bits(ok, keys, perm, order)
                     and same_bits(ov, vals, perm, order),
                     f"row form sort_pairs {order.value} != torch.sort")
            _require(int(validate.count_pair_violations(ok, ov, order))
                     == 0, f"row form sort_pairs {order.value}: stability "
                     "violated")
            del ok, ov
            wk, wlo, whi = row_call(
                f"sort_pairs_wide {order.value}",
                lambda: gstt.sort_pairs_wide(keys, vals, hi, order=order,
                                             **pal))
            _require(same_bits(wk, keys, perm, order)
                     and same_bits(wlo, vals, perm, order)
                     and same_bits(whi, hi, perm, order),
                     f"row form sort_pairs_wide {order.value} != torch.sort")
            del wk, wlo, whi
        del keys, vals, hi, perm
        free()
        keys = prng.make_test_keys(N, SEED + 8, torch.uint32,
                                   gstt.EntropyPreset.E081, device=dev)
        perm = oracle_perm(keys).to(torch.int32)
        for order in orders:
            out = row_call(f"argsort {order.value}",
                           lambda: gstt.argsort(keys, order=order, **pal))
            _require(torch.equal(out, flip(perm, order)),
                     f"row form argsort {order.value} != torch.sort")
            del out
        del keys, perm
        keys = prng.make_test_keys(N, SEED + 10, torch.float32, device=dev)
        sorter = gstt.DeviceRadixSort(gstt.SortConfig(
            backend=gstt.Backend.PALLAS))
        out = row_call("DeviceRadixSort.sort", lambda: sorter.sort(keys))
        _require(same_bits(out, keys, oracle_perm(keys),
                           gstt.Order.ASCENDING),
                 "row form DeviceRadixSort.sort != torch.sort")
        del keys, out
        free()
        row_launches = {f.__name__: f.launches for f in row_fns}
        _require(row_launches["downsweep_rows"] > 0
                 and row_launches["edge_fixup"] > 0,
                 f"the row form path missed a kernel: {row_launches}")
        emit(phase="row_form_path", n=N, tile_rows=tile_rows,
             launches=row_launches, runs=row_runs, bit_exact=True)

        # end to end, the gate on and off, in turns
        payload = torch.arange(N, dtype=torch.int32, device=dev)
        for what, fn in (
                ("keys", lambda k: gstt.sort(k, **pal)),
                ("pairs", lambda k: gstt.sort_pairs(k, payload, **pal)),
                ("argsort", lambda k: gstt.argsort(k, **pal))):
            for route, gate in (("device_radix_rows", "1"),
                                ("device_radix", "0"),
                                ("device_radix", "0"),
                                ("device_radix_rows", "1")):
                os.environ["GST_MEGACORE"] = gate
                r = timing.batch_timing(fn, N, batch=1, repeats=batch,
                                        seed=SEED, device=dev)
                emit(phase="end_to_end_row_form", what=what, route=route,
                     gst_megacore=gate, n=N, batch=batch,
                     ms=r["seconds_per_sort"] * 1e3,
                     spread_ms=[r["spread_min_s"] * 1e3,
                                r["spread_max_s"] * 1e3])
                free()
        del payload
    finally:
        if megacore_was is None:
            os.environ.pop("GST_MEGACORE", None)
        else:
            os.environ["GST_MEGACORE"] = megacore_was
    free()

    # times of both kernels at the two tiles on 1, 2 and 3 planes, on
    # uniform, E020 and sparse_digit keys (the uniform ones beside the
    # element form on the same table and the plain versions), with their
    # byte bounds.  bound of downsweep_rows: the planes read, the outputs
    # written and the present side rows written; bound of edge_fixup:
    # rowtab and the table read, the present side rows read, the rows
    # they name read and written.  The pass's own bound is the
    # permutation's (8 bytes an element a plane); what the row form moves
    # is the planes read, the whole rows written, the named rows written
    # as zeros, read back and written, the side rows written and read
    # back, and the tables.
    ride = torch.arange(N, dtype=torch.int32, device=dev)
    shift = 28
    row_times = {}
    for name, make in (
            ("uniform", lambda: codec.encode_biased(prng.make_test_keys(
                N, SEED, torch.uint32, device=dev))),
            ("E020", lambda: codec.encode_biased(prng.make_test_keys(
                N, SEED, torch.uint32, gstt.EntropyPreset.E020,
                device=dev))),
            ("sparse_digit", sparse_codes)):
        x = make()
        for rows_t in row_tiles:
            planes3 = rts.pad_tiles((x, ride, ride.clone()), rows_t)[0]
            T_r = N // (rows_t * LANES)
            counts = kernels.tile_histogram4(planes3[0], shift, rows_t)
            table = kernels.exclusive_scan(counts.T.reshape(-1))
            rowtab = rts.edge_rows(table, counts)
            present = int((rowtab >= 0).sum())
            named = int(torch.unique(rowtab[rowtab >= 0]).numel())
            for n_planes in (1, 2, 3):
                ops = planes3[:n_planes]
                outs, side = rts.downsweep_rows(ops, table, counts, shift,
                                                rows_t)
                side_bytes = 512 * n_planes * present
                rows_bytes = 8 * N * n_planes + 128 * T_r + side_bytes
                fix_bytes = (192 * T_r + side_bytes
                             + 1024 * n_planes * named)
                moved = (8 * N * n_planes
                         + 512 * n_planes * (N // LANES - named)
                         + 2 * side_bytes + 1536 * n_planes * named
                         + 448 * T_r)
                rec = dict(
                    input=name, tile_rows=rows_t, tiles=T_r,
                    planes=n_planes, present_entries=present,
                    named_rows=named,
                    rows_ms=median_ms(lambda: rts.downsweep_rows(
                        ops, table, counts, shift, rows_t)),
                    rows_bound_ms=rows_bytes / bw * 1e3,
                    fixup_ms=median_ms(lambda: rts.edge_fixup(
                        rowtab, table, side, outs)),
                    fixup_bound_ms=fix_bytes / bw * 1e3,
                    pass_bound_ms=8 * N * n_planes / bw * 1e3,
                    row_form_bytes=moved,
                    row_form_bytes_ms=moved / bw * 1e3,
                    bound_by="bytes", library_ms=None,
                    library="none: no one torch call scatters by a digit "
                            "table or ORs rows by a table")
                if name == "uniform":
                    p_outs, p_side = rts.downsweep_rows_plain(
                        ops, table, counts, shift, rows_t)
                    rec.update(
                        rows_plain_ms=median_ms(
                            lambda: rts.downsweep_rows_plain(
                                ops, table, counts, shift, rows_t),
                            iters=3),
                        fixup_plain_ms=median_ms(
                            lambda: rts.edge_fixup_plain(
                                rowtab, table, p_side, p_outs), iters=3),
                        element_ms=median_ms(lambda: rts.downsweep(
                            ops, table, shift, rows_t)))
                    row_times[rows_t, n_planes] = rec
                    del p_outs, p_side
                emit(phase="per_kernel_row_form", n=N, **rec)
                del outs, side
            del planes3, counts, table, rowtab
            free()
        del x
        free()
    del ride
    free()
    emit(phase="row_form_seconds", seconds=time.perf_counter() - t19)

    # ---- phase 20: the console driver, the tuner and the bench script ----
    # Each command through `python -m gpusorting_tpu_torch`'s main() in
    # this process (dist spawns its own ranks), its output captured and
    # checked; the kernel counts are zeroed before the commands and read
    # after them, per command and in all.  No command installs a row.
    from gpusorting_tpu_torch import __main__ as cli
    from gpusorting_tpu_torch.core import config

    t20 = time.perf_counter()

    def rows_now():
        return ([config.get_tuning_parameters(info, m) for m in gstt.Mode],
                config.get_routing_parameters(info))

    rows_before = rows_now()
    # the kernels this slice's entry points reach in this process
    cli_fns = {"relocate": relocate.relocate,
               "tile_histogram4": kernels.tile_histogram4,
               "exclusive_scan": kernels.exclusive_scan,
               "downsweep": rts.downsweep,
               "global_histogram": kernels.global_histogram,
               "binning_pass": radix16.binning_pass,
               "local_stages": bitonic.local_stages,
               "hyper_stage": mergesweep.hyper_stage}
    all_fns = dict(cli_fns, global_stage=bitonic.global_stage,
                   compact_ops=stitch.compact_ops,
                   expand_ops=stitch.expand_ops,
                   merge_tail=mergesweep.merge_tail,
                   downsweep_rows=rts.downsweep_rows,
                   edge_fixup=rts.edge_fixup,
                   mask_arrivals=rx.mask_arrivals,
                   segtile=segtile.sort)
    for f in all_fns.values():
        f.launches = 0
    cli_runs = []
    for argv in (
            ["info", "--json"],
            ["test", "--algorithm", "onesweep", "--backend", "pallas",
             "--large", "2^22"],
            ["test", "--algorithm", "device_radix", "--backend", "pallas",
             "--large", "2^22"],
            ["supertest", "--sizes", "2^12", "4109"],
            ["bench", "--n", "2^28", "--batch", "5"],
            ["segsort", "--total", "2^22", "--maxlen", "4096"],
            ["dist", "--ranks", "4", "--exchange", "collective",
             "--n", "2^24"],
            ["autotune", "--engine", "rts", "--n", "2^24"],
            ["autotune", "--engine", "radix16", "--n", "2^24"],
            ["autotune", "--routing", "--n", "2^22"],
            ["autotune", "--rangesweep", "--n", "2^26"]):
        before = {k: f.launches for k, f in all_fns.items()}
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        secs = time.perf_counter() - t0
        out = buf.getvalue().strip()
        _require(rc == 0, f"phase 20: {' '.join(argv)} exited {rc}: {out}")
        if argv[0] in ("info", "bench", "autotune"):
            out = json.loads(out)
        if argv[0] == "info":
            _require(out["device"]["generation"] == "h100",
                     f"phase 20: info reports {out['device']}")
        elif argv[0] in ("segsort", "dist"):
            _require(out.split(": ", 1)[1].startswith("PASS"),
                     f"phase 20: {out}")
        elif argv[0] == "bench":
            _require(out["keys_per_sec"] > 0 and out["card"] == card,
                     f"phase 20: bench line {out}")
        launched = {k: f.launches - before[k] for k, f in all_fns.items()
                    if f.launches != before[k]}
        cli_runs.append({"argv": argv, "seconds": secs,
                         "launches": launched})
        emit(phase="cli", argv=argv, seconds=secs, output=out,
             launches=launched)
        free()
    cli_launches = {k: f.launches for k, f in all_fns.items()}
    for k in cli_fns:
        _require(cli_launches[k] > 0,
                 f"phase 20: the commands launched no {k}")

    # the bench script in a process of its own, AUTO and the flat sort, as
    # `python -m` from the root and by its path from another directory:
    # one line each, 4 chains of 5 sorts
    from gpusorting_tpu_torch.ops import radix

    root = os.path.dirname(os.path.abspath(__file__))
    native_route = radix.is_native(info)
    bench_cwd = tempfile.TemporaryDirectory()
    for how, argv, cwd in (
            ("-m", ["-m", "gpusorting_tpu_torch.bench"], root),
            ("path", [os.path.join(root, "gpusorting_tpu_torch", "bench.py")],
             bench_cwd.name)):
        for flag in ((), ("--flat",)):
            t0 = time.perf_counter()
            res = subprocess.run([sys.executable, *argv, *flag],
                                 capture_output=True, text=True,
                                 timeout=600, cwd=cwd)
            secs = time.perf_counter() - t0
            _require(res.returncode == 0, f"phase 20: the bench script "
                     f"({how}) {' '.join(flag)} exited {res.returncode}: "
                     f"{res.stderr[-2000:]}")
            lines = res.stdout.strip().splitlines()
            _require(len(lines) == 1, f"phase 20: the bench script ({how}) "
                     f"printed {len(lines)} lines")
            line = json.loads(lines[0])
            detail = line["detail"]
            want_route = "xla" if flag else gstt.auto_engine(N, info=info)
            _require(line["value"] > 0 and detail["card"] == card
                     and detail["route"] == want_route
                     and detail["n"] == N and detail["batch"] == 20
                     and detail["repeats"] == 4
                     and detail["backend_native_kernels"] == native_route,
                     f"phase 20: bench script line ({how}) {line}")
            emit(phase="bench_script", run=how, flags=list(flag),
                 seconds=secs, line=line)
    bench_cwd.cleanup()
    _require(rows_now() == rows_before and not config._TUNING_OVERRIDES
             and not config._ROUTING_OVERRIDE,
             "phase 20: a tuning or routing row changed")
    emit(phase="cli_path", launches=cli_launches,
         rows_unchanged=True, seconds=time.perf_counter() - t20)

    # ---- phase 21: the host runtime in C++ (native/) ----------------------
    # built with g++ on this host; no numpy stand-in may pass for it
    from gpusorting_tpu_torch import native

    t21 = time.perf_counter()
    _require(native.available(), "phase 21: the native library did not "
             "build")
    build21 = time.perf_counter() - t21
    n21 = 1 << 24
    fill = native.fill_hybrid_taus(n21, SEED + 21, 2)
    want21 = prng.hybrid_taus_bits(n21, SEED + 21, 2, device=dev)
    _require(torch.equal(torch.from_numpy(fill.view(np.int32)),
                         want21.view(torch.int32).cpu()),
             "phase 21: fill_hybrid_taus != prng.hybrid_taus_bits")
    m21 = 1 << 22
    keys21 = want21[:m21]
    codes21, perm21 = torch.sort(codec.encode_biased(keys21), stable=True)
    flat21 = codec.unbias(codes21).view(torch.int32).cpu()
    host21 = keys21.cpu()
    t0 = time.perf_counter()
    got21 = native.radix_sort(host21)
    sort_s = time.perf_counter() - t0
    _require(torch.equal(got21.view(torch.int32), flat21),
             "phase 21: radix_sort != flat torch.sort")
    vals21 = torch.arange(m21, dtype=torch.int32)
    t0 = time.perf_counter()
    gk21, gv21 = native.radix_sort_pairs(host21, vals21)
    pairs_s = time.perf_counter() - t0
    _require(torch.equal(gk21.view(torch.int32), flat21)
             and torch.equal(gv21.view(torch.int32),
                             perm21.to(torch.int32).cpu()),
             "phase 21: radix_sort_pairs != stable flat torch.sort")
    _require(native.count_order_violations(gk21) == 0
             and native.count_pair_violations(gk21, gk21) == 0,
             "phase 21: the validators count violations in sorted keys")
    try:
        native.radix_sort(keys21)
        refused = None
    except ValueError as e:
        refused = str(e)
    _require(refused is not None, "phase 21: a CUDA tensor was taken")
    emit(phase="native", built=True, build_s=build21, fill_n=n21,
         sort_n=m21, radix_sort_s=sort_s, radix_sort_pairs_s=pairs_s,
         bit_exact=True, cuda_refused=refused,
         seconds=time.perf_counter() - t21)
    del want21, keys21, codes21, perm21

    # ---- phase 22: the entry script (entry.py), the flagship step and the
    # multi-chip dry run
    from gpusorting_tpu_torch import entry

    t0 = time.perf_counter()
    step, (ekeys, evals) = entry.entry()
    eok, eov = step(ekeys, evals)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    eperm = oracle_perm(ekeys)
    _require(ekeys.device == dev and same_bits(eok, ekeys, eperm, orders[0])
             and same_bits(eov, evals, eperm, orders[0]),
             "phase 22: the entry step != the flat stable torch.sort")
    emit(phase="entry", n=ekeys.shape[0], seconds=step_s, bit_exact=True)
    del ekeys, evals, eok, eov, eperm
    for ranks, backend, refused in ((1, "nccl", ()),
                                    (4, "gloo", ("remote_dma",))):
        t0 = time.perf_counter()
        dry = entry.dryrun_multichip(ranks)
        secs = time.perf_counter() - t0
        _require(dry["backend"] == backend
                 and dry["checks"] == [c for c in entry.CHECKS
                                       if c not in refused]
                 and tuple(dry["refused"]) == refused,
                 f"phase 22: dryrun_multichip({ranks}) {dry}")
        emit(phase="dryrun_multichip", seconds=secs, **dry)

    # ---- phase 23: the 8-bit-digit radix sort, AUTO's keys and pairs -----
    r256 = radix256_phase(dev, emit)
    free()

    # ---- phase 24: the segmented sort's shared-memory tile ---------------
    seg_tile = segtile_phase(dev, emit)
    free()

    # ---- phase 25: the distributed sort's merge at the 4-card cell's shape
    merge_times = dist_merge_phase(dev, emit)
    free()

    def stitch_row(kname, replaces):
        t = stitch_times[f"{kname}_1"]
        return {"name": kname, "route": "cuda",
                "source": "gpusorting_tpu_torch/csrc/stitch.cu",
                "replaces": replaces,
                "launches": seg_launches[kname],
                "max_abs_err": stitch_err[kname],
                "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": "bytes",
                "library_ms": t["library_ms"], "card": card}

    def new_row(name, kname, source, replaces, times):
        return {"name": name, "route": "cuda",
                "source": f"gpusorting_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": new_launches[kname],
                "max_abs_err": new_err[kname],
                "ms": times["ms"], "plain_ms": times["plain_ms"],
                "bound_ms": times["bound_ms"],
                "bound_by": times.get("bound_by", "bytes"),
                "library_ms": times["library_ms"], "card": card}

    def last_row(kname, replaces, source="mergesweep.cu"):
        t = last_times[kname]
        return {"name": kname, "route": "cuda",
                "source": f"gpusorting_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": last_launches[kname],
                "max_abs_err": merge_err[kname], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None, "card": card}

    def radix_row(name, kname, source, replaces, times):
        return {"name": name, "route": "cuda",
                "source": f"gpusorting_tpu_torch/csrc/{source}",
                "replaces": replaces,
                "launches": pallas_launches[kname],
                "max_abs_err": radix_err[kname],
                "ms": times["ms"], "plain_ms": times["plain_ms"],
                "bound_ms": times["bound_ms"],
                "bound_by": times.get("bound_by", "bytes"),
                "library_ms": times["library_ms"], "card": card}

    print(json.dumps({"kernels": [{
        "name": "relocate_rows",
        "route": "cuda",
        "source": "gpusorting_tpu_torch/csrc/relocate.cu",
        "replaces": "gpusorting_tpu/ops/rangesweep.py:280",
        "launches": main_path_launches,
        "max_abs_err": max_abs_err,
        "ms": relocate_ms,
        "plain_ms": relocate_plain_ms,
        "bound_ms": relocate_bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "card": card,
    }, radix_row("tile_hist4", "tile_histogram4", "tile_hist4.cu",
                 "gpusorting_tpu/ops/kernels.py:144",
                 radix_times["tile_histogram4"]),
        dict(radix_row("exclusive_scan", "exclusive_scan",
                       "exclusive_scan.cu",
                       "gpusorting_tpu/ops/kernels.py:209",
                       radix_times["exclusive_scan"]),
             redesigned="one chained-scan launch",
             **{key: radix_times["exclusive_scan"][key] for key in (
                 "device_ms", "host_ms", "library_device_ms",
                 "library_host_ms", "ms_median_of_50",
                 "library_ms_median_of_50")}),
        dict(radix_row("downsweep", "downsweep", "downsweep.cu",
                       "gpusorting_tpu/ops/rts.py:62",
                       radix_times["downsweep_1"]),
             rows_source="gpusorting_tpu_torch/csrc/downsweep_rows.cu",
             rows_launches=row_launches["downsweep_rows"],
             rows_max_abs_err=rows_err["downsweep_rows"],
             rows_ms=row_times[tile_rows, 1]["rows_ms"],
             rows_plain_ms=row_times[tile_rows, 1]["rows_plain_ms"],
             rows_bound_ms=row_times[tile_rows, 1]["rows_bound_ms"],
             rows_redesigned="every output row stored once (no memset), "
                             "warp-multisplit ranks straight into a stage "
                             "aligned mod 128 a plane at a time, 16-byte "
                             "row moves"),
        new_row("global_hist", "global_histogram", "global_hist.cu",
                "gpusorting_tpu/ops/kernels.py:62",
                new_times["global_histogram"]),
        dict(new_row("binning", "binning_pass", "binning.cu",
                     "gpusorting_tpu/ops/radix16.py:307",
                     new_times["binning_pass_1"]),
             redesigned="one-read OneSweep partition of its own: warp "
                        "multisplit, cp.async riders, one-warp lookback "
                        "over epoch words",
             partition=binning_part,
             ms_3_planes=new_times["binning_pass_3"]["ms"],
             bound_ms_3_planes=new_times["binning_pass_3"]["bound_ms"],
             digit_plane_launches=last_launches["binning_pass"],
             digit_plane_max_abs_err=merge_err["binning_digits"],
             digit_plane_ms=last_times["binning_digits_1"]["ms"],
             digit_plane_plain_ms=last_times["binning_digits_1"]["plain_ms"],
             digit_plane_bound_ms=last_times["binning_digits_1"][
                 "bound_ms"]),
        dict(new_row("local_stages", "local_stages", "bitonic.cu",
                     "gpusorting_tpu/ops/bitonic.py:94",
                     new_times["local_stages_in_tile"]),
             redesigned="registers, warp shuffles, shared memory "
                        "between runs",
             **{f"{key}_{field}": new_times[key][field]
                for key in ("local_stages_tail", "local_stages_in_tile_3",
                            "local_stages_tail_3")
                for field in ("ms", "plain_ms", "bound_ms")}),
        # off the default path since the hyper trips carry the strides
        # above the tile: its launches are mergesweep's with the switch off
        dict(new_row("global_stage", "global_stage", "bitonic.cu",
                     "gpusorting_tpu/ops/bitonic.py:138",
                     new_times["global_stage"]),
             launches=last_launches["global_stage"],
             launches_from="mergesweep, GST_MERGESWEEP_HYPER=0",
             default_path_launches=new_launches["global_stage"]),
        stitch_row("compact", "gpusorting_tpu/ops/stitch.py:85"),
        stitch_row("expand", "gpusorting_tpu/ops/stitch.py:324"),
        {"name": "edge_fixup", "route": "cuda",
         "source": "gpusorting_tpu_torch/csrc/edge_fixup.cu",
         "replaces": "gpusorting_tpu/ops/rts.py:281",
         "launches": row_launches["edge_fixup"],
         "max_abs_err": rows_err["edge_fixup"],
         "ms": row_times[tile_rows, 1]["fixup_ms"],
         "plain_ms": row_times[tile_rows, 1]["fixup_plain_ms"],
         "bound_ms": row_times[tile_rows, 1]["fixup_bound_ms"],
         "bound_by": "bytes", "library_ms": None, "card": card,
         "redesigned": "one warp a shared row, its partials found by a "
                       "ballot over the table (a binary search on long "
                       "walks) and merged in registers, no atomics",
         f"ms_{row_tiles[1]}_rows": row_times[row_tiles[1], 1]["fixup_ms"],
         f"bound_ms_{row_tiles[1]}_rows": row_times[row_tiles[1], 1][
             "fixup_bound_ms"]},
        dict(last_row("merge_tail", "gpusorting_tpu/ops/mergesweep.py:91",
                      "bitonic.cu"),
             redesigned="the in-tile network's register runs, in place",
             local_stages_tail_ms=last_times["merge_tail"][
                 "local_stages_tail_ms"],
             **{f"{field}_3_planes": last_times["merge_tail_3"][field]
                for field in ("ms", "local_stages_tail_ms", "plain_ms",
                              "bound_ms")}),
        dict(last_row("hyper_stage", "gpusorting_tpu/ops/mergesweep.py:172"),
             redesigned="stages in registers, shared memory only between "
                        "register runs; the network's and mergesweep's "
                        "strides above the tile",
             launches=new_launches["hyper_stage"]
             + last_launches["hyper_stage"],
             launches_network=new_launches["hyper_stage"],
             launches_mergesweep=last_launches["hyper_stage"],
             trip=last_times["hyper_stage"]["trip"],
             **{f"{field}_3_planes": last_times["hyper_stage_3"][field]
                for field in ("ms", "plain_ms", "bound_ms")},
             above_tile_strides={
                 "keys": above[1], "pairs_3_planes": above[3]}),
        {"name": "exchange_mask", "route": "cuda",
         "source": "gpusorting_tpu_torch/csrc/exchange_mask.cu",
         "replaces": "gpusorting_tpu/parallel/remote_exchange.py:106",
         "launches": mask_launches, "max_abs_err": mask_err,
         "ms": mask_times[3]["ms"], "plain_ms": mask_times[3]["plain_ms"],
         "bound_ms": mask_times[3]["bound_ms"], "bound_by": "bytes",
         "library_ms": mask_times[3]["library_ms"], "card": card,
         "operands": 3, "ms_2_operands": mask_times[2]["ms"],
         "bound_ms_2_operands": mask_times[2]["bound_ms"],
         "redesigned": "a grid sized to the card, each row's blocks "
                       "striding over its tail only, 16-byte streaming "
                       "stores after a scalar head to a 128-byte line",
         "path_chunk_ms": path_times["ms"],
         "path_chunk_device_ms": path_times["device_ms"],
         "path_chunk_plain_ms": path_times["plain_ms"],
         "path_chunk_bound_ms": path_times["bound_ms"],
         "path_chunk_library_ms": path_times["library_ms"],
         "path_chunk_library_device_ms": path_times["library_device_ms"],
         "full_chunk_ms": full_times["ms"],
         "full_chunk_device_ms": full_times["device_ms"],
         "full_chunk_plain_ms": full_times["plain_ms"],
         "full_chunk_bound_ms": full_times["bound_ms"],
         "all_masked_ms": mask_times["zero"]["ms"],
         "all_masked_plain_ms": mask_times["zero"]["plain_ms"],
         "all_masked_bound_ms": mask_times["zero"]["bound_ms"]},
        {"name": "radix256", "route": "cuda",
         "source": "gpusorting_tpu_torch/csrc/binning256.cu",
         "replaces": None, "launches": r256_main_launches, "max_abs_err": 0,
         "ms": r256["ms"], "upsweep_ms": r256["upsweep_ms"],
         "pass_ms": r256["pass_ms"], "plain_ms": r256["plain_ms"],
         "bound_ms": r256["bound_ms"], "bound_by": "bytes (a pass)",
         "sort_bound_ms": r256["sort_bound_ms"],
         "upsweep_bound_ms": r256["upsweep_bound_ms"],
         "library_ms": r256["library_ms"],
         "library": "torch.sort(codes).values", "card": card},
        {"name": "segtile", "route": "cuda",
         "source": "gpusorting_tpu_torch/csrc/segtile.cu",
         "replaces": None, "launches": 1, "max_abs_err": 0,
         **{f"{key}_{lay}": rec[key] for lay, rec in seg_tile.items()
            for key in ("ms", "call_ms", "plain_ms", "bound_ms",
                        "library_ms", "auto_ms", "composite_route_ms")},
         "bound_by": "bytes",
         "library": seg_tile["max4096_u32_pairs"]["library"],
         "card": card},
        {"name": "merge_runs", "route": "cuda",
         "source": "gpusorting_tpu_torch/csrc/dist_merge.cu",
         "replaces": None, "launches": merge_launches, "max_abs_err": 0,
         **{f"{key}_dest{r}": rec[key] for r, rec in merge_times.items()
            for key in ("ms", "device_ms", "partition_ms", "tiles_ms",
                        "plain_ms", "bound_ms")},
         "bound_by": "bytes", "library": "the plain version: merge_plain "
         "(torch.sort of the int64 composite, the gather) then torch.cat",
         "card": card}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
