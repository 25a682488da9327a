"""Console driver: `python -m gpusorting_tpu_torch <command>`.

Port of `gpusorting_tpu/__main__.py`, the reference's executable drivers
(`main()` in GPUSortingD3D12.cpp:118-160 and GPUSortingCUDA.cu:16-58)
over the port's sorters and suites.

Commands:
  info      device probe + tuning and routing rows
  test      boundary-exhaustive TestAll for one sorter config
  supertest 18-config matrix (Tests.h:6-368 analog)
  bench     BatchTiming at a given size; one JSON line per run
  segsort   SplitSort against the composite oracle
  dist      distributed sort over N gloo ranks against numpy
  autotune  live tile / routing sweep -> measured row (utils/autotune.py)

Every command but `info` runs on `--device`, the CUDA card by default,
and raises where that card is absent; `--device cpu` runs the suites on
the kernels' plain versions, while `bench` and `autotune`, which time the
card, refuse it.  Failing suites exit non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

# seconds before `dist` terminates its ranks and fails
_DIST_TIMEOUT = 600.0


def _parse_size(s: str) -> int:
    """Accept plain ints and the 2^k form used throughout the benches."""
    s = s.strip()
    if "^" in s:
        base, exp = s.split("^", 1)
        return int(base) ** int(exp)
    return int(s)


def _sorter_cls(name: str):
    import gpusorting_tpu_torch as gstt

    table = {
        "onesweep": gstt.OneSweep,
        "device_radix": gstt.DeviceRadixSort,
        "forward_sweep": gstt.ForwardSweep,
        "emulated_deadlocking": gstt.EmulatedDeadlocking,
        "ffx": gstt.FFXParallelSort,
    }
    return table[name]


def _config(args):
    import gpusorting_tpu_torch as gstt

    kt = {"u32": gstt.KeyType.UINT32, "i32": gstt.KeyType.INT32,
          "f32": gstt.KeyType.FLOAT32}[args.key]
    order = (gstt.Order.ASCENDING if args.order == "asc"
             else gstt.Order.DESCENDING)
    backend = {"auto": gstt.Backend.AUTO, "xla": gstt.Backend.XLA,
               "pallas": gstt.Backend.PALLAS}[args.backend]
    mode = gstt.Mode.PAIRS if args.mode == "pairs" else gstt.Mode.KEYS_ONLY
    return gstt.SortConfig(mode=mode, order=order, key_type=kt,
                           backend=backend)


def _add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the CUDA card; raises "
                        "where torch sees none)")


def _add_config_args(p):
    p.add_argument("--algorithm", default="onesweep",
                   choices=["onesweep", "device_radix", "forward_sweep",
                            "emulated_deadlocking", "ffx"])
    p.add_argument("--mode", default="keys", choices=["keys", "pairs"])
    p.add_argument("--key", default="u32", choices=["u32", "i32", "f32"])
    p.add_argument("--order", default="asc", choices=["asc", "desc"])
    p.add_argument("--backend", default="auto",
                   choices=["auto", "xla", "pallas"])
    _add_device_arg(p)


def cmd_info(args) -> int:
    import gpusorting_tpu_torch as gstt

    info = gstt.get_device_info()
    rows = {
        mode.value: dataclasses.asdict(gstt.get_tuning_parameters(info, mode))
        for mode in (gstt.Mode.KEYS_ONLY, gstt.Mode.PAIRS)
    }
    routing = dataclasses.asdict(gstt.get_routing_parameters(info))
    print(json.dumps({"device": dataclasses.asdict(info), "tuning": rows,
                      "routing": routing},
                     indent=None if args.json else 2))
    return 0


def cmd_test(args) -> int:
    sorter = _sorter_cls(args.algorithm)(_config(args), device=args.device)
    report = sorter.test_all(
        boundary_window=args.window,
        boundary_stride=args.stride,
        large_sizes=tuple(_parse_size(s) for s in args.large),
    )
    print(f"{args.algorithm}: {report}")
    return 0 if report.all_passed else 1


def cmd_supertest(args) -> int:
    from gpusorting_tpu_torch import api

    report = api.super_test(
        sorter_cls=_sorter_cls(args.algorithm),
        sizes=tuple(_parse_size(s) for s in args.sizes),
        device=args.device,
    )
    print(f"supertest {args.algorithm}: {report}")
    return 0 if report.all_passed else 1


def cmd_bench(args) -> int:
    import gpusorting_tpu_torch as gstt
    from gpusorting_tpu_torch.utils import timing

    sorter = _sorter_cls(args.algorithm)(_config(args), device=args.device)
    res = sorter.batch_timing(
        _parse_size(args.n), batch=args.batch, seed=args.seed,
        entropy=gstt.EntropyPreset(args.entropy),
    )
    res["card"] = timing.card_line()
    print(json.dumps(res))
    return 0


def cmd_segsort(args) -> int:
    import torch

    from gpusorting_tpu_torch.core import prng
    from gpusorting_tpu_torch.ops import flat_sort
    from gpusorting_tpu_torch.segsort import splitsort

    dev = prng.require_device(args.device)
    total = _parse_size(args.total)
    offs, count = prng.make_random_segments(total, args.maxlen,
                                            seed=args.seed, device=dev)
    keys = prng.make_test_keys(total, seed=args.seed + 1, device=dev)
    if args.bits < 32:
        # bits_to_sort contract: caller guarantees keys < 2^bits
        # (SplitSort.cuh:702; generators mask the same way,
        # UtilityKernels.cuh:170-248); masked on the int32 view, since
        # torch's uint32 has no bitwise ops
        keys = (keys.view(torch.int32) & ((1 << args.bits) - 1)).view(
            torch.uint32)
    vals = torch.arange(total, dtype=torch.int32, device=dev).view(
        torch.uint32)
    k, v = splitsort.split_sort_pairs(offs, keys, vals, count,
                                      bits_to_sort=args.bits)
    rk, rv = flat_sort.segmented_sort_pairs(offs, keys, vals)
    ok = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
             for a, b in ((k, rk), (v, rv)))
    print(f"segsort total={total} maxlen={args.maxlen} segs={count} "
          f"bits={args.bits}: {'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def _dist_rank(rank: int, world: int, n: int, seed: int, exchange: str,
               device: str) -> dict:
    """One `dist` rank: its shard of the n keys sorted by the group, the
    dense result held against numpy's stable sort of all n."""
    import numpy as np
    import torch

    from gpusorting_tpu_torch.core import prng
    from gpusorting_tpu_torch.parallel import dist_sort

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    n_local = n // world
    # the int32 view: torch's uint32 has no indexing
    everything = prng.make_test_keys(n, seed, device=dev).view(torch.int32)
    shard = everything[rank * n_local:(rank + 1) * n_local].view(
        torch.uint32)
    out, overflow = dist_sort.distributed_sort_gather(shard,
                                                      exchange=exchange)
    want = np.sort(everything.cpu().numpy().view(np.uint32), kind="stable")
    got = out.view(torch.int32).cpu().numpy().view(np.uint32)
    return {"ok": overflow == 0 and bool(np.array_equal(got, want)),
            "overflow": overflow}


def cmd_dist(args) -> int:
    from gpusorting_tpu_torch.core import prng
    from gpusorting_tpu_torch.parallel.launch import run_ranks

    dev = prng.require_device(args.device)
    if dev.type == "cuda" and args.exchange == "remote_dma":
        # the ranks' group is gloo, whose point-to-point ops take no CUDA
        # tensor; nothing is moved to the CPU in the card's place
        raise ValueError("dist: the remote_dma exchange of CUDA tensors "
                         "needs point-to-point ops that gloo, the ranks' "
                         "backend, does not run on CUDA tensors; use "
                         "--exchange collective or --device cpu")
    # the ranks unpickle the rank function by its module's import name,
    # which this module lacks when it runs as `python -m` ("__main__")
    from gpusorting_tpu_torch.__main__ import _dist_rank as rank_fn

    n = -(-_parse_size(args.n) // args.ranks) * args.ranks
    res = run_ranks(rank_fn, args.ranks, n, args.seed, args.exchange,
                    str(dev), timeout=_DIST_TIMEOUT)
    ok = all(r["ok"] for r in res)
    print(f"dist n={n} devices={args.ranks} exchange={args.exchange}: "
          f"{'PASS' if ok else 'FAIL'} (overflow={res[0]['overflow']})")
    return 0 if ok else 1


def cmd_autotune(args) -> int:
    import gpusorting_tpu_torch as gstt

    if args.rangesweep:
        n = _parse_size(args.n or "2^28")
        params, sweep = gstt.autotune_rangesweep(
            n_max=n, batch=args.batch, install=args.install,
            device=args.device)
        print(json.dumps({
            "sweep": sweep,
            "rangesweep_min": params.rangesweep_min,
            "rangesweep_seg_elems": params.rangesweep_seg_elems,
            "rangesweep_min_pairs": params.rangesweep_min_pairs,
            "rangesweep_seg_elems_pairs": params.rangesweep_seg_elems_pairs,
            "rangesweep_min_pairs_nonpow2":
                params.rangesweep_min_pairs_nonpow2,
            "installed": args.install,
        }))
        return 0
    n = _parse_size(args.n or "2^22")
    if args.routing:
        params, sweep = gstt.autotune_routing(
            n=n, batch=args.batch, install=args.install, device=args.device)
        print(json.dumps({
            "sweep": sweep,
            "window_max_pairs": params.window_max_pairs,
            "measured": params.measured,
            "installed": args.install,
        }))
        return 0
    mode = gstt.Mode.PAIRS if args.mode == "pairs" else gstt.Mode.KEYS_ONLY
    params, sweep = gstt.autotune(
        mode, n=n, tiles=tuple(args.tiles), batch=args.batch,
        install=args.install, engine=args.engine, device=args.device,
    )
    print(json.dumps({
        "sweep_keys_per_sec": sweep,
        "best_tile": params.radix_tile_rows,
        "engine": args.engine,
        "measured": params.measured,
        "installed": args.install,
    }))
    return 0


def build_parser() -> argparse.ArgumentParser:
    from gpusorting_tpu_torch.utils.autotune import DEFAULT_TILES

    p = argparse.ArgumentParser(
        prog="python -m gpusorting_tpu_torch",
        description=__doc__.split("\n\n")[0],
    )
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("info", help="device probe + tuning rows")
    sp.add_argument("--json", action="store_true", help="one-line JSON")
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser("test", help="boundary-exhaustive TestAll")
    _add_config_args(sp)
    sp.add_argument("--window", type=int, default=None,
                    help="boundary window start (default: tuner partition)")
    sp.add_argument("--stride", type=int, default=257,
                    help="sweep stride; 1 = the exhaustive reference sweep "
                         "(GPUSortBase.h:245-248)")
    sp.add_argument("--large", nargs="*", default=["2^21"],
                    help="large sizes (accepts 2^k)")
    sp.set_defaults(fn=cmd_test)

    sp = sub.add_parser("supertest", help="18-config matrix")
    _add_config_args(sp)
    sp.add_argument("--sizes", nargs="*", default=["2^12", "4109"])
    sp.set_defaults(fn=cmd_supertest)

    sp = sub.add_parser("bench", help="BatchTiming; prints one JSON line")
    _add_config_args(sp)
    sp.add_argument("--n", default="2^24", help="keys per sort (accepts 2^k)")
    sp.add_argument("--batch", type=int, default=10)
    sp.add_argument("--seed", type=int, default=10)
    sp.add_argument("--entropy", type=int, default=1, choices=[1, 2, 3, 4, 5])
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("segsort", help="SplitSort oracle-identity test")
    sp.add_argument("--total", default="2^16")
    sp.add_argument("--maxlen", type=int, default=256)
    sp.add_argument("--bits", type=int, default=32)
    sp.add_argument("--seed", type=int, default=7)
    _add_device_arg(sp)
    sp.set_defaults(fn=cmd_segsort)

    sp = sub.add_parser("dist", help="distributed sort correctness run")
    sp.add_argument("--n", default="2^16")
    sp.add_argument("--seed", type=int, default=11)
    sp.add_argument("--exchange", default="collective",
                    choices=["collective", "remote_dma"])
    sp.add_argument("--ranks", type=int, default=4, metavar="N",
                    help="gloo ranks spawned on this host; on a CUDA "
                         "device they share the card")
    _add_device_arg(sp)
    sp.set_defaults(fn=cmd_dist)

    sp = sub.add_parser("autotune", help="live tile sweep -> measured row")
    sp.add_argument("--mode", default="keys", choices=["keys", "pairs"])
    sp.add_argument("--n", default=None,
                    help="keys per sort (default 2^22; 2^28, the largest "
                         "size, with --rangesweep)")
    sp.add_argument("--tiles", nargs="*", type=int,
                    default=list(DEFAULT_TILES),
                    help="radix tiles in rows of 128 keys")
    sp.add_argument("--batch", type=int, default=3)
    sp.add_argument("--install", action="store_true",
                    help="register the measured row as a process override")
    sp.add_argument("--engine", default="radix16",
                    choices=["radix16", "rts", "splitsweep"],
                    help="engine to time in the tile sweep (rts decides "
                         "the tile: radix16's binning pass partitions "
                         "4096 keys whatever the tile)")
    sp.add_argument("--routing", action="store_true",
                    help="sweep the segmented sort's pairs window cap "
                         "instead of the radix tile")
    sp.add_argument("--rangesweep", action="store_true",
                    help="sweep AUTO's rangesweep crossovers (flat-sort "
                         "A/B at --n and below)")
    _add_device_arg(sp)
    sp.set_defaults(fn=cmd_autotune)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
