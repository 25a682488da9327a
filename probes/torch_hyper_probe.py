"""Probe of the port's hyper-stage kernel (csrc/mergesweep.cu) and of the
above-tile strides it carries, on one NVIDIA card.

    python3 probes/torch_hyper_probe.py [--time-only] [--shapes]
                                        [--parent DIR]

Prints the card's name and power limit, `-Xptxas -v` of csrc/mergesweep.cu
(each (planes, keys) instantiation: registers, shared memory, spills), then
one JSON line per measurement:

  * unless --time-only, `mergesweep.hyper_stage` against
    `hyper_stage_plain`, bit for bit, at n = 2^22 on 1-4 planes and each
    key count, every W from 2 to the largest a block takes at the smallest
    and the largest cols, both directions in one call (k just above j_hi)
    and k = n, on uniform, all-equal and tie-heavy keys with distinct
    riders; `bitonic.sort_network_i32` against `torch.sort(stable=True)` at
    2^20 + 3, keys and a two-rider stable sort;
  * the card's register compare-exchange rate (probes/torch_exchange_rate.cu:
    `gst::exchange_regs` in registers, no memory traffic), 1 plane and
    3 planes (2 keys), the direction a runtime bit or a constant, in
    exchanges a second and a clock of an SM (at the SM clock nvidia-smi
    reads after the run);
  * times at n = 2^28 (median of 5): one trip of s = 1, 4, 7 and 12 stages
    on 1 plane and of s = 11 on 3 planes (2 keys) beside its byte bound;
    the above-tile strides of a 2^28 keys sort (1 plane, a 2^15 tile:
    levels 2^16 .. 2^28) and of a pairs sort (3 planes, 2 keys, a 2^14
    tile), each as one `global_stage` a stride, as the engine's own trips
    and as the trips of each candidate block (threads x rows of at least
    min_cols elements; the engine takes 512 x 8);
  * with --shapes, mergesweep.cu built with other registers a thread
    (-DGST_HYPER_ITEMS1 / -DGST_HYPER_ITEMS3), each checked against plain
    and timed on the keys and pairs schedules at each candidate block;
  * with --parent DIR (a `git archive` of an earlier tree), the trip and
    schedule times from DIR's package, in turns with this tree's (parent,
    this, this, parent), each in a process of its own, so both share one
    card: each tree's own kernel at its own engine's trips.

Needs a CUDA card and nvcc.
"""

import ctypes
import json
import os
import pathlib
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE = HERE
if "--tree" in sys.argv:
    TREE = os.path.abspath(sys.argv[sys.argv.index("--tree") + 1])
sys.path.insert(0, TREE)

import torch  # noqa: E402

N = 1 << 28
LANES = 128
BW = 3.35e12          # H100 SXM bytes/s (data sheet)
KEYS_TILE = 1 << 15   # the "h100" row's network tiles: 1 plane
PAIRS_TILE = 1 << 14  # and 3 planes
CANDIDATES = [(t, c) for t in (128, 256, 512) for c in (8, 16, 32, 64)]


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _sm_clock() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _emit(card, **rec):
    rec["card"] = card
    rec["tree"] = TREE
    print(json.dumps(rec), flush=True)


def _compile(src, out, extra=()):
    """nvcc with -Xptxas -v; returns (returncode, ptxas lines, stderr)."""
    from gpusorting_tpu_torch.ops import _nvcc
    proc = subprocess.run(
        [_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, *extra, "-Xptxas", "-v", "-o",
         out, str(src)], capture_output=True, text=True)
    lines = [ln.split(":", 1)[-1].strip()[:150]
             for ln in proc.stderr.splitlines()
             if "entry function" in ln or "Used" in ln or "spill" in ln]
    return proc.returncode, lines, proc.stderr


def _med(fn, dev, iters=5):
    from gpusorting_tpu_torch.utils import timing
    return statistics.median(timing.device_time_ms(fn, iters=iters,
                                                   device=dev))


def _planes(kind, num_ops, n, seed, dev):
    """Plane 0 by kind, the others distinct riders."""
    from gpusorting_tpu_torch.core import prng
    x = prng.hybrid_taus_bits(n, seed, device=dev).view(torch.int32)
    if kind == "all_equal":
        x = torch.full_like(x, 0x1234ABCD)
    elif kind == "tie_heavy":
        x = x & 3
    out = [x]
    for q in range(1, num_ops):
        out.append(torch.randperm(n, device=dev).to(torch.int32) * (q + 1))
    return [p.view(-1, LANES) for p in out]


def checks(card, dev):
    """The bit-exact cases of the module docstring; raises on a miss."""
    from gpusorting_tpu_torch.ops import bitonic, mergesweep
    n = 1 << 22
    cases = 0
    for num_ops in (1, 2, 3, 4):
        items = mergesweep.HYPER_ITEMS[num_ops]
        most = 4 * items * mergesweep.HYPER_MAX_THREADS
        for num_keys in range(1, num_ops + 1):
            for kind in ("uniform", "all_equal", "tie_heavy"):
                if kind != "uniform" and num_keys > 1 and num_ops > 2:
                    continue
                ops = _planes(kind, num_ops, n, num_ops + num_keys, dev)
                s = 1
                while (8 << s) <= most:
                    w = 1 << s
                    j_lo = min(1 << 14, n >> s)
                    j_hi = j_lo * w // 2
                    for cols in sorted({max(8, 4 * items // w),
                                        min(j_lo, most // w)}):
                        if not 4 * items <= w * cols <= most:
                            continue
                        for k in {2 * j_hi, n}:
                            got = mergesweep.hyper_stage(
                                [p.clone() for p in ops], k, j_hi, j_lo,
                                num_keys, cols)
                            want = mergesweep.hyper_stage_plain(
                                [p.clone() for p in ops], k, j_hi, j_lo,
                                num_keys, cols)
                            for g, w_ in zip(got, want):
                                if not torch.equal(g, w_):
                                    raise RuntimeError(
                                        f"hyper_stage != plain: {num_ops} "
                                        f"planes {num_keys} keys {kind} "
                                        f"W={w} cols={cols} k={k}")
                            cases += 1
                    s += 1
                del ops
    torch.cuda.synchronize()
    _emit(card, kernel="hyper_stage", n=n, bit_exact=True, cases=cases,
          check="1-4 planes, each key count, W 2 .. most, smallest and "
                "largest cols, k = 2 j_hi and n; uniform, all-equal, "
                "tie-heavy keys")
    from gpusorting_tpu_torch.core import prng
    m = (1 << 20) + 3
    k = prng.hybrid_taus_bits(m, 5, device=dev).view(torch.int32)
    v = torch.arange(m, dtype=torch.int32, device=dev)
    want = torch.sort(k, stable=True)
    before = (mergesweep.hyper_stage.launches, bitonic.global_stage.launches)
    if not torch.equal(bitonic.sort_codes(k), want.values):
        raise RuntimeError("sort_codes != torch.sort")
    sk, sv, sw = bitonic.sort_codes_stable_with(k & 0xFFF, v, v ^ 5)
    w8 = torch.sort(k & 0xFFF, stable=True)
    if not (torch.equal(sk, w8.values) and torch.equal(sv, v[w8.indices])
            and torch.equal(sw, (v ^ 5)[w8.indices])):
        raise RuntimeError("sort_codes_stable_with != torch.sort")
    torch.cuda.synchronize()
    _emit(card, kernel="sort_network_i32", n=m, bit_exact=True,
          hyper_launches=mergesweep.hyper_stage.launches - before[0],
          global_launches=bitonic.global_stage.launches - before[1])


def exchange_rate(card, dev):
    """The register compare-exchange rate; returns {form: exchanges/s}."""
    from gpusorting_tpu_torch.ops import _nvcc
    src = os.path.join(HERE, "probes", "torch_exchange_rate.cu")
    build = os.path.join(HERE, "gpusorting_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    so = os.path.join(build, "exchange_rate_probe.so")
    rc, lines, err = _compile(src, so)
    if rc:
        raise RuntimeError(f"nvcc failed on {src}:\n{err}")
    lib = _nvcc.declare(ctypes.CDLL(so), pathlib.Path(src))
    per_round = lib.gst_rate_exchanges_per_round()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, rounds = sms * 16, 4096
    out = torch.empty(blocks * 256, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    names = ("1 plane, runtime direction", "1 plane, constant direction",
             "3 planes 2 keys, runtime direction",
             "3 planes 2 keys, constant direction")
    _emit(card, kernel="exchange_regs_rate", ptxas=lines)
    rates = {}
    for form, name in enumerate(names):
        def run():
            if lib.gst_rate(out.data_ptr(), form, blocks, rounds, 7, stream):
                raise RuntimeError("exchange rate launch failed")
        ms = _med(run, dev, iters=7)
        clock = _sm_clock()
        rate = blocks * 256 * rounds * per_round / (ms * 1e-3)
        mhz = float(clock.split(",")[0].split()[0])
        rates[form] = rate
        _emit(card, kernel="exchange_regs_rate", form=name, ms=ms,
              exchanges_per_s=rate, sm_clock=clock,
              exchanges_per_sm_clock=rate / (sms * mhz * 1e6))
    return rates


def _engine_trips(mergesweep, k, tile, num_ops):
    """A level's trips as the tree's own engine takes them."""
    if hasattr(mergesweep, "level_trips"):
        return mergesweep.level_trips(k, tile, num_ops)
    return mergesweep.hyper_trips(k, tile, tile)


def _candidate_trips(k, tile, budget, min_cols):
    """A level's trips for a block of `budget` elements a plane with rows
    of at least `min_cols` (`mergesweep.hyper_trips`' split, whose rows are
    at least 8)."""
    stages = (k // tile).bit_length() - 1
    per_trip = (budget // min_cols).bit_length() - 1
    trips = -(-stages // per_trip)
    out = []
    j_hi = k // 2
    for t in range(trips):
        s = stages // trips + (1 if t < stages % trips else 0)
        j_lo = j_hi >> (s - 1)
        out.append((j_hi, j_lo, min(j_lo, budget * j_lo // (2 * j_hi))))
        j_hi = j_lo // 2
    return out


def _schedule(tile, num_ops):
    return [1 << b for b in range(tile.bit_length(), N.bit_length())]


def times(card, dev, candidates=True, launch=None, items=None):
    """Trip and schedule times at 2^28 from whichever tree is on the path
    (or, with `launch`, from a library built with other `items`)."""
    from gpusorting_tpu_torch.ops import bitonic, mergesweep
    hyper = launch or mergesweep.hyper_stage
    x = [_planes("uniform", 3, N, 9, dev)[q] for q in range(3)]
    if launch is None:
        for s, num_ops in ((1, 1), (4, 1), (7, 1), (12, 1), (11, 3)):
            nk = 1 if num_ops == 1 else 2
            j_lo = KEYS_TILE if num_ops == 1 else PAIRS_TILE
            w = 1 << s
            most = 1 << 15 if num_ops == 1 else 1 << 14
            cols = min(j_lo, most // w)
            ops = [p.clone() for p in x[:num_ops]]
            ms = _med(lambda: hyper(ops, N, j_lo * w // 2, j_lo, nk, cols),
                      dev)
            _emit(card, kernel="hyper_stage_trip", stages=s, planes=num_ops,
                  num_keys=nk, cols=cols, n=N, ms=ms,
                  bound_ms=8 * N * num_ops / BW * 1e3)
            del ops
    rows = []
    for num_ops, tile in ((1, KEYS_TILE), (3, PAIRS_TILE)):
        nk = 1 if num_ops == 1 else 2
        tr = tile // LANES
        ops = [p.clone() for p in x[:num_ops]]
        levels = _schedule(tile, num_ops)
        forms = []
        if launch is None:
            forms.append(("global_stages", None))
            forms.append(("engine_trips", [
                (k, _engine_trips(mergesweep, k, tile, num_ops))
                for k in levels]))
        if candidates and hasattr(mergesweep, "HYPER_ITEMS"):
            for t, c in CANDIDATES:
                its = (items or mergesweep.HYPER_ITEMS)[num_ops]
                if 4 * its * t > (1 << 15 if num_ops == 1 else 1 << 14):
                    continue
                forms.append((f"{t}x{c}", [
                    (k, _candidate_trips(k, tile, 4 * its * t, c))
                    for k in levels]))
        for name, sched in forms:
            if sched is None:
                def run():
                    for k in levels:
                        j = k // 2
                        while j >= tile:
                            bitonic.global_stage(ops, j, k, nk, tr)
                            j //= 2
                count = sum((k // tile).bit_length() - 1 for k in levels)
            else:
                def run():
                    for k, trips in sched:
                        for j_hi, j_lo, cols in trips:
                            hyper(ops, k, j_hi, j_lo, nk, cols)
                count = sum(len(t) for _, t in sched)
            ms = _med(run, dev, iters=3)
            rec = dict(kernel="above_tile_strides", planes=num_ops,
                       num_keys=nk, tile=tile, n=N, form=name,
                       launches=count, ms=ms,
                       bound_ms=count * 8 * N * num_ops / BW * 1e3)
            if items:
                rec["items"] = items[num_ops]
            rows.append(rec)
            _emit(card, **rec)
        del ops
    del x
    torch.cuda.empty_cache()
    return rows


def shapes(card, dev):
    """mergesweep.cu built with other registers a thread, each checked and
    timed on the two schedules."""
    from gpusorting_tpu_torch.ops import _nvcc, mergesweep
    build = os.path.join(TREE, "gpusorting_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    for turn, (e1, e3) in enumerate(((8, 4), (32, 4), (16, 8))):
        so = os.path.join(build, f"mergesweep_{e1}_{e3}_{turn}.so")
        rc, lines, err = _compile(mergesweep.SOURCE, so,
                                  (f"-DGST_HYPER_ITEMS1={e1}",
                                   f"-DGST_HYPER_ITEMS3={e3}"))
        if rc:
            _emit(card, kernel="hyper_shape", items1=e1, items3=e3,
                  error=err[-400:])
            continue
        lib = _nvcc.declare(ctypes.CDLL(so), mergesweep.SOURCE)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def launch(ops, k, j_hi, j_lo, nk, cols):
            ptrs = [p.data_ptr() for p in ops] + [None] * (4 - len(ops))
            rc = lib.gst_hyper_stage(*ptrs, len(ops), nk, ops[0].numel(), k,
                                     j_hi, j_lo, cols, stream)
            if rc:
                raise RuntimeError(f"hyper_stage launch failed: {rc}")
            return ops
        items = {1: e1, 3: e3}
        ops = _planes("tie_heavy", 3, 1 << 22, 3, dev)
        for num_ops, nk, tile in ((1, 1, KEYS_TILE), (3, 2, PAIRS_TILE)):
            for k in [k for k in _schedule(tile, num_ops) if k <= 1 << 22]:
                for j_hi, j_lo, cols in _candidate_trips(
                        k, tile, 4 * items[num_ops] * 256, 8):
                    if 2 * j_hi > ops[0].numel():
                        continue
                    got = launch([p.clone() for p in ops[:num_ops]], k,
                                 j_hi, j_lo, nk, cols)
                    want = mergesweep.hyper_stage_plain(
                        [p.clone() for p in ops[:num_ops]], k, j_hi, j_lo,
                        nk, cols)
                    if not all(torch.equal(g, w) for g, w in zip(got,
                                                                  want)):
                        raise RuntimeError(f"items {e1}/{e3} != plain at "
                                           f"k={k} {j_hi}..{j_lo}")
        del ops
        _emit(card, kernel="hyper_shape", items1=e1, items3=e3, ptxas=lines,
              bit_exact=True)
        times(card, dev, launch=launch, items=items)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = _card()
    if "--tree" in sys.argv:            # one turn of a --parent compare
        times(card, dev, candidates=False)
        return 0
    print(card, flush=True)
    from gpusorting_tpu_torch.ops import mergesweep
    rc, lines, err = _compile(mergesweep.SOURCE, os.devnull)
    for line in lines:
        print(mergesweep.SOURCE.name, line)
    if rc:
        print(err, file=sys.stderr)
        return 1
    if "--time-only" not in sys.argv:
        checks(card, dev)
    exchange_rate(card, dev)
    if "--shapes" in sys.argv:
        shapes(card, dev)
    times(card, dev)
    if "--parent" not in sys.argv:
        return 0
    parent = os.path.abspath(sys.argv[sys.argv.index("--parent") + 1])
    torch.cuda.empty_cache()
    rc = 0
    for tree in (parent, HERE, HERE, parent):
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--tree", tree]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
