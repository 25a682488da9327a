"""Sweeps of the card rows' fields that the tuner has no sweep for, on one
NVIDIA card: each candidate is forced through `set_routing_override` /
`set_tuning_override` and timed through the public entry points.

    python3 probes/torch_row_sweeps.py [--runs 3] [--out FILE]

Builds every kernel, then runs each sweep below in a process of its own
(`--one NAME`), the whole list `--runs` times in turns, and prints one
JSON line per process (the cells' ms) and, at the end, one line per field:
each candidate's ms in every run, their median and spread (max - min),
the current value and the pick.  A candidate other than the current value
is picked only where its median beats the current value's by more than
the larger of the two spreads.

  wide_index    AUTO's 64-bit-payload and argsort crossovers: the public
                `sort_pairs_wide` / `argsort` forced onto rangesweep
                (`rangesweep_min_pairs_wide` / `_index` = 1) at each
                segment length, against `backend=XLA`, at 2^28 and 2^29
  network       `onesweep` keys and pairs at 2^28 with the network's
                shared-memory budget at 1, 1/2 and 1/4 of the row's
  ffx           the `ffx` variant, keys and pairs at 2^28, at tiles of
                64 .. 1024 rows
  window_tuner  the tuner's own window sweep (`autotune_routing` at 2^22)
                with its candidates extended down to 512
  segsort       the segmented sort at chip_smoke.py's layouts, u32 pairs,
                u32 keys and 16-bit keys with a payload (the fused window):
                (a) 2^22 keys in random segments of at most 2^2 .. 2^18,
                (c) 2^26 keys, 14 segments of 2^18 .. 2^19 among ones of at
                most 64, (d) 2^26 keys, 1100 of 8193 .. 16384 and 72 of
                2^18 among ones of at most 32; each window cap over its
                candidates, and the class bounds with the multi-class
                route forced (window caps 0, extraction share 1.0)
  segsort_frac  the extraction share over its candidates, the caps and
                class bounds at segsort's picks; the current row beside it

A route is timed once per process and layout: candidates that give the
same route (the plan's route, window mode and classes) share its time.
Every forced route's output is held bit for bit against the flat
oracle once.  `--out FILE` also appends every line to FILE.  Needs a CUDA
card and nvcc; `--device cpu --shift K` runs the code paths at sizes cut
by 2^K on the host (host clock, for checking the probe only).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2024
SWEEPS = ("wide_index", "network", "ffx", "window_tuner", "segsort")
RS_SEGS = (1 << 21, 1 << 22, 1 << 23)
FFX_TILES = (64, 128, 256, 512, 1024)
WINDOWS = (512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)
CAPS = (0, 4, 16, 64, 256, 1024, 4096, 16384, 32768, 65536, 262144)
BULK = (1024, 4096, 16384, 65536)
PADDED = (16384, 131072, 524288)
FRACS = (0.0, 0.1, 0.25, 0.5, 0.75, 1.0)
CAP_FIELD = {"pairs": "window_max_pairs", "keys": "window_max_keys",
             "fused16": "window_max_fused"}


# ---- one sweep in this process --------------------------------------------


class Ctx:
    def __init__(self, device: str, shift: int):
        import torch

        import gpusorting_tpu_torch as gstt
        from gpusorting_tpu_torch.core import config

        self.torch, self.gstt, self.config = torch, gstt, config
        self.dev = torch.device(device)
        if self.dev.type == "cuda":
            if self.dev.index is None:
                self.dev = torch.device("cuda", 0)
            torch.cuda.set_device(self.dev)
        self.shift = shift
        self.info = gstt.get_device_info(self.dev)
        self.routing = config.get_routing_parameters(self.info)
        self.tuning = {m: config.get_tuning_parameters(self.info, m)
                       for m in gstt.Mode}

    def n(self, log2: int) -> int:
        return 1 << max(log2 - self.shift, 4)

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def free(self):
        self.sync()
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()

    def ms(self, fn, iters: int = 5) -> float:
        """Median ms of fn() on fixed inputs after one warm-up: CUDA events
        on the card, the host clock on the CPU."""
        if self.dev.type == "cuda":
            from gpusorting_tpu_torch.utils import timing

            return statistics.median(timing.device_time_ms(
                fn, iters=iters, device=self.dev))
        fn()
        out = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    def batch_ms(self, sort_fn, n: int, batch: int = 3) -> float:
        """Mean ms a sort by the reference's rules (fresh u32 keys each
        iteration, one warm-up): utils/timing.batch_timing on the card."""
        if self.dev.type == "cuda":
            from gpusorting_tpu_torch.utils import timing

            r = timing.batch_timing(sort_fn, n, batch=batch, seed=SEED,
                                    device=self.dev)
            return r["seconds_per_sort"] * 1e3
        from gpusorting_tpu_torch.core import prng

        out = []
        for i in range(batch + 1):
            k = prng.make_test_keys(n, SEED + i, device=self.dev)
            t0 = time.perf_counter()
            sort_fn(k)
            if i:
                out.append((time.perf_counter() - t0) * 1e3)
        return statistics.fmean(out)

    def route(self, row=None):
        if row is None:
            self.config.clear_routing_override()
        else:
            self.config.set_routing_override(row)


def _same(a, b) -> bool:
    import torch

    if isinstance(a, (tuple, list)):
        return all(_same(x, y) for x, y in zip(a, b))
    view = torch.int32 if a.dtype.itemsize == 4 else torch.int64
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def sweep_wide_index(c: Ctx) -> dict:
    torch, gstt = c.torch, c.gstt
    from gpusorting_tpu_torch.core import prng

    xla = gstt.Backend.XLA
    cells = {}
    for log2 in (28, 29):
        n = c.n(log2)
        lo = torch.arange(n, dtype=torch.int32, device=c.dev)
        hi = lo ^ 0x5A5A5A5A
        for mode, field, seg_field, fn in (
                ("pairs_wide", "rangesweep_min_pairs_wide",
                 "rangesweep_seg_elems_pairs_wide",
                 lambda k, b: gstt.sort_pairs_wide(k, lo, hi, backend=b)),
                ("index", "rangesweep_min_index",
                 "rangesweep_seg_elems_index",
                 lambda k, b: gstt.argsort(k, backend=b))):
            keys = prng.make_test_keys(n, SEED, device=c.dev)
            want = fn(keys, xla)
            cells[f"{mode}@{n}|flat"] = c.batch_ms(lambda k: fn(k, xla), n)
            c.free()
            for seg in RS_SEGS:
                c.route(dataclasses.replace(c.routing, **{field: 1,
                                                          seg_field: seg}))
                try:
                    if not _same(fn(keys, gstt.Backend.AUTO), want):
                        raise RuntimeError(f"{mode} rangesweep L={seg} != "
                                           f"the flat sort at n={n}")
                    cells[f"{mode}@{n}|rs{seg}"] = c.batch_ms(
                        lambda k: fn(k, gstt.Backend.AUTO), n)
                finally:
                    c.route()
                c.free()
            del want, keys
            c.free()
        del lo, hi
        c.free()
    return cells


def sweep_network(c: Ctx) -> dict:
    torch, gstt = c.torch, c.gstt
    from gpusorting_tpu_torch.core import prng
    from gpusorting_tpu_torch.ops import bitonic

    n = c.n(28)
    pal = gstt.Backend.PALLAS
    payload = torch.arange(n, dtype=torch.int32, device=c.dev)
    keys = prng.make_test_keys(n, SEED, device=c.dev)
    fns = {"keys": lambda k, b: gstt.sort(k, backend=b, variant="onesweep"),
           "pairs": lambda k, b: gstt.sort_pairs(k, payload, backend=b,
                                                 variant="onesweep")}
    cells, tiles = {}, {}
    base = c.tuning[gstt.Mode.KEYS_ONLY]
    full = base.network_smem_bytes
    for mode, fn in fns.items():
        want = fn(keys, gstt.Backend.XLA)
        for budget in (full, full // 2, full // 4):
            # the network reads the keys-only row's budget for every mode
            c.config.set_tuning_override(gstt.Mode.KEYS_ONLY,
                                         dataclasses.replace(
                                             base, network_smem_bytes=budget))
            try:
                tiles[budget] = [bitonic.network_tile_rows(c.dev, p)
                                 for p in (1, 2, 3, 4)]
                if not _same(fn(keys, pal), want):
                    raise RuntimeError(f"onesweep {mode} at budget {budget} "
                                       "!= the flat sort")
                cells[f"{mode}|b{budget}"] = c.batch_ms(
                    lambda k: fn(k, pal), n)
            finally:
                c.config.clear_tuning_overrides()
            c.free()
        del want
    return {"cells": cells, "tile_rows_by_planes": tiles}


def sweep_ffx(c: Ctx) -> dict:
    torch, gstt = c.torch, c.gstt
    from gpusorting_tpu_torch.core import prng

    n = c.n(28)
    pal = gstt.Backend.PALLAS
    payload = torch.arange(n, dtype=torch.int32, device=c.dev)
    keys = prng.make_test_keys(n, SEED, device=c.dev)
    fns = {"keys": lambda k, b: gstt.sort(k, backend=b, variant="ffx"),
           "pairs": lambda k, b: gstt.sort_pairs(k, payload, backend=b,
                                                 variant="ffx")}
    cells = {}
    for mode, fn in fns.items():
        want = fn(keys, gstt.Backend.XLA)
        for tile in FFX_TILES:
            c.route(dataclasses.replace(c.routing, ffx_tile_rows=tile))
            try:
                if not _same(fn(keys, pal), want):
                    raise RuntimeError(f"ffx {mode} at {tile} rows != the "
                                       "flat sort")
                cells[f"{mode}|t{tile}"] = c.batch_ms(lambda k: fn(k, pal),
                                                      n)
            finally:
                c.route()
            c.free()
        del want
    return cells


def sweep_window_tuner(c: Ctx) -> dict:
    n = c.n(22)
    params, sweep = c.gstt.autotune_routing(
        n=n, window_candidates=tuple(w for w in WINDOWS if w <= n),
        device=c.dev)
    cells = {f"max{ml}|{route}": n / r * 1e3
             for ml, cell in sweep["window_pairs"].items()
             for route, r in cell.items()}
    return {"cells": cells, "window_max_pairs": params.window_max_pairs}


# ---- the segmented sort ----------------------------------------------------


def _layout_lens(total, longs, small_max, seed):
    """chip_smoke.py's layouts (c) and (d): long segments (count, lo, hi),
    the rest filled with segments of 1..small_max, shuffled."""
    import numpy as np

    rng = np.random.default_rng(seed)
    big = np.concatenate([rng.integers(lo, hi + 1, cnt)
                          for cnt, lo, hi in longs])
    rem = total - int(big.sum())
    small = rng.integers(1, small_max + 1, 2 * rem // small_max + 64)
    ends = np.cumsum(small)
    k = int(np.searchsorted(ends, rem))
    small = small[:k + 1]
    small[k] -= int(ends[k]) - rem
    return rng.permutation(np.concatenate([big, small]))


def _layouts(c: Ctx) -> list:
    """[(label, offs, S, total, keys, vals, keys16)] as chip_smoke.py
    phase 11 builds them (its seeds)."""
    import numpy as np

    gstt = c.gstt
    from gpusorting_tpu_torch.core import codec, prng

    out = []
    tot_a = c.n(22)
    for i, ml in enumerate(range(2, 20, 2)):
        offs, S = prng.make_random_segments(tot_a, min(1 << ml, tot_a),
                                            SEED + 30 + i, device=c.dev)
        keys, vals = prng.make_test_pairs(tot_a, SEED + 40 + i,
                                          c.torch.uint32, c.torch.uint32,
                                          gstt.EntropyPreset.E033,
                                          device=c.dev)
        k16 = prng.make_masked_random_values(tot_a, 16, SEED + 70 + i,
                                             device=c.dev)
        out.append((f"a_max2^{ml}", offs, S, tot_a, keys, vals, k16))
    tot_c = c.n(26)
    scale = 1 << c.shift
    for label, longs, small_max, calls in (
            ("c_split", [(14, (1 << 18) // scale, (1 << 19) // scale)], 64,
             1),
            ("d_classes", [(1100, 8193 // scale, 16384 // scale),
                           (72, (1 << 18) // scale, (1 << 18) // scale)], 32,
             3)):
        lens = _layout_lens(tot_c, [(k, max(lo, 1), max(hi, 1))
                                    for k, lo, hi in longs], small_max,
                            SEED + calls)
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
        offs = codec.wrap_int32(c.torch.from_numpy(starts)).to(c.dev)
        total = int(np.sum(lens))
        keys, vals = prng.make_test_pairs(total, SEED + 90 + calls,
                                          c.torch.uint32, c.torch.uint32,
                                          gstt.EntropyPreset.E033,
                                          device=c.dev)
        k16 = prng.make_masked_random_values(total, 16, SEED + 170 + calls,
                                             device=c.dev)
        out.append((label, offs, len(lens), total, keys, vals, k16))
    return out


def _route_sig(plan, bits: int, has_payload: bool) -> str:
    """The route `_segmented_sort` takes for this plan under the active
    row, as `splitsort._random_length_route` decides it."""
    from gpusorting_tpu_torch.segsort import splitsort

    if plan.fixed_length is not None and plan.fixed_length > 1:
        return "fixed"
    if splitsort._takes_tile(plan.max_len, plan.total, plan.total,
                             plan.info):
        return "tile"
    wp = plan.window_plan(bits, has_payload) or {}

    def mode(ml, sid_bits):
        return splitsort._pick_window_mode(ml, sid_bits, bits, has_payload,
                                           plan.info)

    sp = wp.get("split")
    if sp is not None:
        bmode = mode(sp["ml"], sp["sid_bits"]) if sp["ml"] > 1 else None
        if bmode is not None or sp["ml"] <= 1:
            return f"split(T={sp['T']},{bmode})"
    cp = wp.get("classes")
    if cp is not None:
        b = cp["bulk"]
        bmode = None
        if b is not None and b["ml"] > 1:
            bmode = mode(b["ml"], b["sid_bits"]) or (
                "stable3" if has_payload else "keys2")
        return (f"classes({bmode},padded={[x['B'] for x in cp['padded']]},"
                f"tail={cp['tail'] is not None})")
    if "ml" in wp:
        m = mode(wp["ml"], wp["sid_bits"])
        if m is not None:
            return f"window({m})"
    return "composite"


class SegTimer:
    """Times each (mode, layout, route) once in this process; every row
    that gives the same route reuses it."""

    MODES = {"pairs": (32, True), "keys": (32, False), "fused16": (16, True)}

    def __init__(self, c: Ctx):
        self.c = c
        self.layouts = _layouts(c)
        self.plans = {lab: c.gstt.make_segsort_plan(offs, total, S)
                      for lab, offs, S, total, *_ in self.layouts}
        self.times: dict = {}
        self.oracle: dict = {}

    def call(self, mode, lay, plan):
        gstt = self.c.gstt
        lab, offs, S, total, keys, vals, k16 = lay
        bits, has_payload = self.MODES[mode]
        if mode == "keys":
            return lambda: gstt.split_sort_keys(offs, keys, S, plan=plan)
        k = k16 if mode == "fused16" else keys
        v = k16.clone() if mode == "fused16" else vals
        return lambda: gstt.split_sort_pairs(offs, k, v, S, total, bits,
                                             plan=plan)

    def want(self, mode, lay):
        from gpusorting_tpu_torch.ops import flat_sort

        key = (mode, lay[0])
        if key not in self.oracle:
            lab, offs, S, total, keys, vals, k16 = lay
            if mode == "keys":
                self.oracle[key] = flat_sort.segmented_sort_pairs(
                    offs, keys, None, total)
            elif mode == "pairs":
                self.oracle[key] = flat_sort.segmented_sort_pairs(
                    offs, keys, vals, total)
            else:
                self.oracle[key] = flat_sort.segmented_sort_pairs(
                    offs, k16, k16.clone(), total)
        return self.oracle[key]

    def row_cells(self, tag: str, row, modes) -> dict:
        """{f"{tag}|{mode}|{layout}": ms} under `row`, and the routes."""
        c = self.c
        cells, routes = {}, {}
        c.route(row)
        try:
            for lay in self.layouts:
                plan = self.plans[lay[0]]
                plan._window_plans = {}     # re-planned under this row
                for mode in modes:
                    bits, has_payload = self.MODES[mode]
                    sig = _route_sig(plan, bits, has_payload)
                    key = (mode, lay[0], sig)
                    if key not in self.times:
                        fn = self.call(mode, lay, plan)
                        if not _same(fn(), self.want(mode, lay)):
                            raise RuntimeError(f"{mode} {lay[0]} {sig} != "
                                               "the composite oracle")
                        self.times[key] = c.ms(fn)
                        c.free()
                    cells[f"{tag}|{mode}|{lay[0]}"] = self.times[key]
                    routes[f"{tag}|{mode}|{lay[0]}"] = sig
        finally:
            c.route()
            for plan in self.plans.values():
                plan._window_plans = {}
        return cells, routes


def sweep_segsort(c: Ctx) -> dict:
    t = SegTimer(c)
    cur = c.routing
    cells, routes = {}, {}
    for mode, field in CAP_FIELD.items():
        for cap in sorted(set(CAPS) | {getattr(cur, field)}):
            got, r = t.row_cells(f"{field}={cap}",
                                 dataclasses.replace(cur, **{field: cap}),
                                 (mode,))
            cells.update(got)
            routes.update(r)
    forced = dict(window_max_pairs=0, window_max_keys=0, window_max_fused=0,
                  segsort_extract_max_frac=1.0)
    pairs = {(b, p) for b in BULK for p in PADDED}
    pairs.add((cur.segsort_bulk_max, cur.segsort_padded_max))
    for b, p in sorted(pairs):
        got, r = t.row_cells(
            f"bulk={b},padded={p}",
            dataclasses.replace(cur, segsort_bulk_max=b,
                                segsort_padded_max=p, **forced),
            ("pairs", "keys"))
        cells.update(got)
        routes.update(r)
    return {"cells": cells, "routes": routes}


def sweep_segsort_frac(c: Ctx, given: dict) -> dict:
    t = SegTimer(c)
    cur = c.routing
    cells, routes = {}, {}
    modes = tuple(SegTimer.MODES)
    for f in sorted(set(FRACS) | {cur.segsort_extract_max_frac}):
        got, r = t.row_cells(f"segsort_extract_max_frac={f}",
                             dataclasses.replace(
                                 cur, segsort_extract_max_frac=f, **given),
                             modes)
        cells.update(got)
        routes.update(r)
    got, r = t.row_cells("row=current", cur, modes)
    cells.update(got)
    routes.update(r)
    return {"cells": cells, "routes": routes}


def run_one(name: str, device: str, shift: int, given: dict) -> dict:
    c = Ctx(device, shift)
    t0 = time.perf_counter()
    if name == "segsort_frac":
        res = sweep_segsort_frac(c, given)
    else:
        res = globals()[f"sweep_{name}"](c)
    if "cells" not in res:
        res = {"cells": res}
    res["seconds"] = time.perf_counter() - t0
    return res


# ---- the parent: runs in turns, medians, spreads, picks ---------------------


def _stats(v: list) -> dict:
    return {"ms": v, "median_ms": statistics.median(v),
            "spread_ms": max(v) - min(v)}


def pick(field: str, current, costs: dict) -> dict:
    """costs: {candidate: [ms a run]}.  The candidate with the lowest
    median; kept only where it beats the current value's median by more
    than the larger of the two spreads, else the current value."""
    st = {str(k): _stats(v) for k, v in costs.items()}
    order = sorted(costs, key=lambda k: statistics.median(costs[k]))
    best = order[0]
    cur = st[str(current)]
    margin = cur["median_ms"] - st[str(best)]["median_ms"]
    spread = max(cur["spread_ms"], st[str(best)]["spread_ms"])
    chosen = best if best != current and margin > spread else current
    runner = next((k for k in order if k != chosen), None)
    return {"field": field, "current": current, "best": best,
            "margin_ms": margin, "spread_ms": spread, "pick": chosen,
            "pick_ms": st[str(chosen)]["median_ms"], "runner_up": runner,
            "runner_up_ms": (st[str(runner)]["median_ms"]
                             if runner is not None else None),
            "candidates": st}


def _cost(runs: list, prefix: str, suffix_ok=lambda s: True) -> list:
    """Per run, the sum of the cells whose name starts with prefix."""
    return [sum(v for k, v in r.items()
                if k.startswith(prefix) and suffix_ok(k[len(prefix):]))
            for r in runs]


def decide(results: dict, routing, tuning_keys) -> dict:
    """Field picks from each sweep's per-run cells."""
    out = {}
    wi = results.get("wide_index")
    if wi:
        for mode, field, seg_field in (
                ("pairs_wide", "rangesweep_min_pairs_wide",
                 "rangesweep_seg_elems_pairs_wide"),
                ("index", "rangesweep_min_index",
                 "rangesweep_seg_elems_index")):
            sizes = sorted({int(k.split("@")[1].split("|")[0])
                            for k in wi[0] if k.startswith(mode + "@")})
            n0 = sizes[0]
            seg = pick(seg_field, getattr(routing, seg_field), {
                s: [r[f"{mode}@{n0}|rs{s}"] for r in wi] for s in RS_SEGS})
            out[seg_field] = seg
            best = seg["best"]
            # crossover candidates: rangesweep from each swept size up, or
            # never (None); the current row's value may lie off the sizes
            costs = {}
            for m in [None] + sizes:
                costs[m] = [sum(r[f"{mode}@{n}|" + (
                    f"rs{best}" if m is not None and n >= m else "flat")]
                    for n in sizes) for r in wi]
            cur = getattr(routing, field)
            if cur not in costs:
                costs[cur] = [sum(r[f"{mode}@{n}|" + (
                    f"rs{best}" if cur is not None and n >= cur else "flat")]
                    for n in sizes) for r in wi]
            out[field] = pick(field, cur, costs)
    net = results.get("network")
    if net:
        budgets = sorted({int(k.split("|b")[1]) for k in net[0]})
        out["network_smem_bytes"] = pick(
            "network_smem_bytes", tuning_keys.network_smem_bytes,
            {b: _cost(net, "", lambda s, b=b: s.endswith(f"|b{b}"))
             for b in budgets})
    fx = results.get("ffx")
    if fx:
        out["ffx_tile_rows"] = pick(
            "ffx_tile_rows", routing.ffx_tile_rows,
            {t: _cost(fx, "", lambda s, t=t: s.endswith(f"|t{t}"))
             for t in FFX_TILES})
    seg = results.get("segsort")
    if seg:
        for mode, field in CAP_FIELD.items():
            caps = sorted({int(k.split("|")[0].split("=")[1])
                           for k in seg[0] if k.startswith(field + "=")})
            out[field] = pick(field, getattr(routing, field), {
                cap: _cost(seg, f"{field}={cap}|{mode}|") for cap in caps})
        combos = sorted({k.split("|")[0] for k in seg[0]
                         if k.startswith("bulk=")})
        costs = {}
        for cmb in combos:
            b, p = (int(x.split("=")[1]) for x in cmb.split(","))
            costs[(b, p)] = _cost(seg, cmb + "|")
        both = pick("segsort_bulk_max,segsort_padded_max",
                    (routing.segsort_bulk_max, routing.segsort_padded_max),
                    costs)
        out["segsort_bulk_max,segsort_padded_max"] = both
    fr = results.get("segsort_frac")
    if fr:
        fracs = sorted({float(k.split("|")[0].split("=")[1])
                        for k in fr[0]
                        if k.startswith("segsort_extract_max_frac=")})
        out["segsort_extract_max_frac"] = pick(
            "segsort_extract_max_frac", routing.segsort_extract_max_frac,
            {f: _cost(fr, f"segsort_extract_max_frac={f}|") for f in fracs})
        chosen = out["segsort_extract_max_frac"]["pick"]
        out["segsort_row"] = {
            mode: {"current": _stats(_cost(fr, f"row=current|{mode}|")),
                   "picked": _stats(_cost(
                       fr, f"segsort_extract_max_frac={chosen}|{mode}|"))}
            for mode in SegTimer.MODES}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", default=None,
                    choices=SWEEPS + ("segsort_frac",))
    ap.add_argument("--given", default="{}",
                    help="segsort_frac: the caps and class bounds (JSON)")
    ap.add_argument("--only", nargs="*", default=list(SWEEPS),
                    help="the sweeps to run (segsort_frac follows segsort)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shift", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.one:
        res = run_one(args.one, args.device, args.shift,
                      json.loads(args.given))
        print(json.dumps(res), flush=True)
        return 0

    import gpusorting_tpu_torch as gstt
    from gpusorting_tpu_torch.core import config
    from gpusorting_tpu_torch.utils import timing

    card = timing.card_line() if args.device != "cpu" else "cpu"
    if card is None:
        print("torch_row_sweeps: nvidia-smi found no card", file=sys.stderr)
        return 2
    out_file = open(args.out, "a") if args.out else None

    def emit(rec) -> None:
        rec["card"] = card
        line = json.dumps(rec)
        print(line, flush=True)
        if out_file:
            out_file.write(line + "\n")
            out_file.flush()

    print(card, flush=True)
    if args.device != "cpu":
        from gpusorting_tpu_torch.ops import _nvcc

        t0 = time.perf_counter()
        _nvcc.build_all(sorted(_nvcc.CSRC.glob("*.cu")))
        emit({"build_seconds": time.perf_counter() - t0})
    info = gstt.get_device_info(args.device)
    routing = config.get_routing_parameters(info)
    tuning_keys = config.get_tuning_parameters(info, gstt.Mode.KEYS_ONLY)
    emit({"row": dataclasses.asdict(routing),
          "tuning_keys": dataclasses.asdict(tuning_keys)})
    results: dict = {}
    failed = 0

    def one(name, given=None):
        nonlocal failed
        argv = [sys.executable, os.path.abspath(__file__), "--one", name,
                "--device", args.device, "--shift", str(args.shift),
                "--given", json.dumps(given or {})]
        t0 = time.perf_counter()
        res = subprocess.run(argv, capture_output=True, text=True, cwd=ROOT,
                             timeout=1800)
        rec = {"sweep": name, "run": run, "rc": res.returncode,
               "seconds": time.perf_counter() - t0}
        if res.returncode == 0:
            got = json.loads(res.stdout.strip().splitlines()[-1])
            rec.update(got)
            results.setdefault(name, []).append(got["cells"])
        else:
            failed += 1
            rec["stderr"] = res.stderr[-4000:]
        emit(rec)

    for run in range(args.runs):
        for name in args.only:
            one(name)
    picks = decide(results, routing, tuning_keys)
    if "segsort" in results:
        given = {f: picks[f]["pick"] for f in CAP_FIELD.values()}
        b, p = picks["segsort_bulk_max,segsort_padded_max"]["pick"]
        given.update(segsort_bulk_max=b, segsort_padded_max=p)
        emit({"segsort_given": given})
        for run in range(args.runs):
            one("segsort_frac", given)
        picks = decide(results, routing, tuning_keys)
    for field, rec in picks.items():
        emit({"decision": field, **rec})
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
