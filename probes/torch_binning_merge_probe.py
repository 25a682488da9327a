"""Probe of the port's binning pass and merge tail kernels on one NVIDIA
card.

    python3 probes/torch_binning_merge_probe.py [--time-only] [--shapes]
                                               [--parent DIR]

Prints the card's name and power limit, `-Xptxas -v` of csrc/binning.cu
(each (planes, digit-plane) instantiation: registers, shared memory,
spills) and of csrc/bitonic.cu's in-tile kernel, which also runs the merge
tail, then one JSON line per measurement:

  * unless --time-only, `radix16.binning_pass` against its plain version,
    bit for bit with cursors_out, at tiles of 1, 3, 32 and 512 rows (the
    ranges end in ragged partitions), on uniform, E020, all-equal and
    two-digit keys, 1-3 planes, shifts 0 and 28, fused and as the
    `adversarial_segments` chain, the digit-plane form into 16 regions
    (uniform and skewed), two calls back to back and a call on a second
    stream; `mergesweep.merge_tail` against `merge_tail_plain` and against
    `bitonic.local_stages` on the tail's schedule, k below, at twice and
    far above the tile, on 1-4 planes;
  * times at n = 2^28 (median of 5): the binning pass on 1-3 planes at
    shift 28, the digit-plane form (its range check included) on 1 and 3
    planes, the element-form downsweep on 1 plane (it shares
    radix_common.cuh), `merge_tail` at k = 2^28 on 1 plane and on 3 planes
    (2 keys) beside `local_stages` on the 15-stage tail schedule;
  * with --shapes, binning.cu built at other partitions (threads x items
    through -DGST_BINNING_THREADS / -DGST_BINNING_ITEMS), each held
    against plain at 2^28 and timed on 1 and 3 planes;
  * with --parent DIR (a `git archive` of an earlier tree), the times
    again from DIR's package, in turns with this tree's (parent, this,
    this, parent), each in a process of its own, so both share one card.

Needs a CUDA card and nvcc.
"""

import ctypes
import json
import os
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


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _emit(card, **rec):
    rec["card"] = card
    rec["tree"] = TREE
    print(json.dumps(rec), flush=True)


def _ptxas(src, extra=()):
    from gpusorting_tpu_torch.ops import _nvcc
    out = subprocess.run(
        [_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, *extra, "-Xptxas", "-v", "-o",
         os.devnull, str(src)], capture_output=True, text=True)
    for line in out.stderr.splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            print(src.name, *extra, line.split(":", 1)[-1].strip()[:150])


def _med(fn, dev, iters=5):
    from gpusorting_tpu_torch.utils import timing
    return statistics.median(timing.device_time_ms(fn, iters=iters,
                                                   device=dev))


def _keys(kind, n, seed, dev):
    from gpusorting_tpu_torch.core import codec, prng
    import gpusorting_tpu_torch as gstt
    if kind == "uniform":
        return codec.encode_biased(prng.make_test_keys(n, seed, torch.uint32,
                                                       device=dev))
    if kind == "E020":
        return codec.encode_biased(prng.make_test_keys(
            n, seed, torch.uint32, gstt.EntropyPreset.E020, device=dev))
    if kind == "all_equal":
        return torch.full((n,), 0x1234ABCD, dtype=torch.int32, device=dev)
    # two digits at every shift: 0x0... and 0xF...
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    bit = torch.randint(0, 2, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    return bit * -1 ^ -0x80000000    # biased codes of u32 0 and 0xFFFFFFFF


def checks(card, dev):
    """Every bit-exact case of the module docstring; raises on a miss."""
    from gpusorting_tpu_torch.core import prng
    from gpusorting_tpu_torch.ops import bitonic, mergesweep, radix16

    def same(got, want, what):
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise RuntimeError(f"mismatch: {what}")

    n_exact = 0
    for tile_rows in (1, 3, 32, 512):
        # a few thousand tiles of 1 and 3 rows, 300-odd of 32, 9 of 512
        rows = {1: 4099, 3: 3 * 1367, 32: 32 * 311, 512: 512 * 9}[tile_rows]
        n = rows * LANES
        for kind in ("uniform", "E020", "all_equal", "two_digit"):
            x = _keys(kind, n, tile_rows + 7, dev)
            rides = [prng.hybrid_taus_bits(n, 40 + q, device=dev)
                     .view(torch.int32) for q in range(2)]
            planes = [y.view(rows, LANES) for y in [x] + rides]
            bases, _ = radix16._bases_all_passes(x)
            segs = radix16.adversarial_segments(n, tile_rows)
            bounds = sorted({0, rows // tile_rows} | set(segs))
            for p in (0, 7):
                for ops in (planes[:1], planes[:2], planes):
                    got, cur = radix16.binning_pass(ops, bases[p], 4 * p,
                                                    tile_rows)
                    want, wcur = radix16.binning_pass_plain(
                        ops, bases[p], 4 * p, tile_rows)
                    same(got + [cur], want + [wcur],
                         f"{kind} tile {tile_rows} shift {4 * p} "
                         f"{len(ops)} planes")
                    out, c = [torch.empty_like(y) for y in ops], bases[p]
                    for a, b in zip(bounds[:-1], bounds[1:]):
                        _, c = radix16.binning_pass(
                            [y[a * tile_rows:b * tile_rows] for y in ops], c,
                            4 * p, tile_rows, out)
                    same(out + [c], want + [wcur],
                         f"{kind} tile {tile_rows} segments {segs}")
                    n_exact += 2
    _emit(card, kernel="binning_pass", check="tiles 1/3/32/512 x 4 kinds "
          "x 1-3 planes x shifts 0, 28, fused and segments",
          bit_exact=True, cases=n_exact)

    # the digit-plane form into 16 row-aligned regions
    rows, cap_rows = 4096, 3700
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    planes = [prng.hybrid_taus_bits(rows * LANES, 50 + q, device=dev)
              .view(torch.int32).view(rows, LANES) for q in range(3)]
    for skew in (False, True):
        r = torch.randint(0, 128, (rows, LANES), generator=g, device=dev)
        digits = (torch.where(r < 112, 3, r % 16) if skew else r % 16).to(
            torch.int32)
        bases = (torch.arange(16, dtype=torch.int32, device=dev)
                 * (cap_rows * LANES))
        for k in (1, 2, 3):
            def run(fn):
                out = [torch.zeros(16 * cap_rows, LANES, dtype=torch.int32,
                                   device=dev) for _ in range(k)]
                outs, cur = fn(planes[:k], bases, 0, 32, out, digits=digits)
                return outs + [cur]
            same(run(radix16.binning_pass), run(radix16.binning_pass_plain),
                 f"digit plane skew={skew} {k} planes")
    _emit(card, kernel="binning_pass_digits", bit_exact=True, cases=6)

    # back to back on one stream, and on a second stream
    x = _keys("uniform", 1 << 22, 9, dev).view(-1, LANES)
    bases, _ = radix16._bases_all_passes(x.view(-1))
    want = [radix16.binning_pass_plain([x], bases[p], 4 * p, 32)
            for p in range(8)]
    got = [radix16.binning_pass([x], bases[p], 4 * p, 32) for p in range(8)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = [radix16.binning_pass([x], bases[p], 4 * p, 32)
                   for p in range(8)]
    torch.cuda.synchronize()
    for (go, gc), (so, sc), (wo, wc) in zip(got, on_side, want):
        same(go + [gc], wo + [wc], "back to back")
        same(so + [sc], wo + [wc], "second stream")
    _emit(card, kernel="binning_pass", check="8 back to back and 8 on a "
          "second stream", bit_exact=True)

    # merge_tail against plain and against local_stages on its schedule
    n = 1 << 22
    for num_ops, num_keys in ((1, 1), (2, 2), (3, 2), (4, 2)):
        tr = bitonic.network_tile_rows(dev, num_ops)
        te = tr * LANES
        g = torch.Generator(device=dev)
        g.manual_seed(num_ops)
        ops = [torch.randint(-20, 20, (n // LANES, LANES), generator=g,
                             device=dev, dtype=torch.int32),
               torch.randperm(n, generator=g, device=dev)
               .to(torch.int32).view(-1, LANES)]
        ops += [prng.hybrid_taus_bits(n, 60 + q, device=dev)
                .view(torch.int32).view(-1, LANES) for q in range(2)]
        ops = ops[:num_ops]
        for k in (te // 4, 2 * te, n):
            got = mergesweep.merge_tail([y.clone() for y in ops], k, tr,
                                        num_keys)
            want = mergesweep.merge_tail_plain([y.clone() for y in ops], k,
                                               tr, num_keys)
            net = bitonic.local_stages(ops, bitonic.tail_schedule(te, k),
                                       num_keys, tr)
            same(got, want, f"merge_tail k={k} {num_ops} planes")
            same(got, net, f"merge_tail vs local_stages k={k}")
    _emit(card, kernel="merge_tail", check="k = tile/4, 2 tile, n at 2^22, "
          "1-4 planes, vs plain and vs local_stages", bit_exact=True)


def times(card, dev):
    """The kernels' times at 2^28, from whichever tree is on the path."""
    from gpusorting_tpu_torch.ops import (bitonic, kernels, mergesweep,
                                          radix16, rts, splitsweep)

    x = _keys("uniform", N, 2024, dev)
    ride = torch.arange(N, dtype=torch.int32, device=dev)
    planes3 = [x.view(-1, LANES), ride.view(-1, LANES),
               ride.clone().view(-1, LANES)]
    tile_rows = rts.default_tile_rows(dev)
    bases, _ = radix16._bases_all_passes(x)
    for k in (1, 2, 3):
        ops = planes3[:k]
        _emit(card, kernel="binning_pass", planes=k, n=N, shift=28,
              tile_rows=tile_rows,
              ms=_med(lambda: radix16.binning_pass(ops, bases[7], 28,
                                                   tile_rows), dev),
              bound_ms=8 * N * k / 3.35e12 * 1e3)
    rows = N // LANES
    cap_rows = splitsweep._cap_rows(rows, 1.35)
    cbases = (torch.arange(16, dtype=torch.int32, device=dev)
              * (cap_rows * LANES))
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    bucket = torch.randint(0, 16, (rows, LANES), generator=g, device=dev,
                           dtype=torch.int32)
    for k in (1, 3):
        ops = planes3[:k]
        out = [torch.empty(16 * cap_rows, LANES, dtype=torch.int32,
                           device=dev) for _ in ops]
        _emit(card, kernel="binning_pass_digits", planes=k, n=N,
              ms=_med(lambda: radix16.binning_pass(
                  ops, cbases, 0, tile_rows, out, digits=bucket), dev),
              bound_ms=(4 + 8 * k) * N / 3.35e12 * 1e3)
        del out
    del bucket
    counts = kernels.tile_histogram4(planes3[0], 28, tile_rows)
    table = kernels.exclusive_scan(counts.T.reshape(-1))
    _emit(card, kernel="downsweep", planes=1, n=N, tile_rows=tile_rows,
          ms=_med(lambda: rts.downsweep(planes3[:1], table, 28, tile_rows),
                  dev))
    for num_ops, num_keys in ((1, 1), (3, 2)):
        tr = bitonic.network_tile_rows(dev, num_ops)
        te = tr * LANES
        ops = [y.clone() for y in planes3[:num_ops]]
        tail = bitonic.tail_schedule(te, 4 * te)
        _emit(card, kernel="merge_tail", planes=num_ops, num_keys=num_keys,
              n=N, k=N, tile_elems=te, stages=tail.shape[0],
              ms=_med(lambda: mergesweep.merge_tail(ops, N, tr, num_keys),
                      dev),
              local_stages_tail_ms=_med(lambda: bitonic.local_stages(
                  ops, tail, num_keys, tr), dev),
              bound_ms=8 * N * num_ops / 3.35e12 * 1e3)
        del ops
    torch.cuda.empty_cache()


def shapes(card, dev):
    """binning.cu at other partitions, each checked and timed."""
    from gpusorting_tpu_torch.ops import _nvcc, kernels, radix16, rts

    x = _keys("uniform", N, 2024, dev)
    ride = torch.arange(N, dtype=torch.int32, device=dev)
    planes3 = [x.view(-1, LANES), ride.view(-1, LANES),
               ride.clone().view(-1, LANES)]
    tile_rows = rts.default_tile_rows(dev)
    bases, _ = radix16._bases_all_passes(x)
    want = {k: radix16.binning_pass_plain(planes3[:k], bases[7], 28,
                                          tile_rows) for k in (1, 3)}
    stream = torch.cuda.current_stream(dev).cuda_stream
    build = os.path.join(TREE, "gpusorting_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    for threads, items in ((256, 16), (256, 8), (512, 8), (384, 16),
                           (512, 15), (512, 16), (256, 24)):
        flags = (f"-DGST_BINNING_THREADS={threads}",
                 f"-DGST_BINNING_ITEMS={items}")
        so = os.path.join(build, f"binning_{threads}x{items}.so")
        proc = subprocess.run([_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, *flags,
                               "-Xptxas", "-v", "-o", so,
                               str(radix16.SOURCE)],
                              capture_output=True, text=True)
        regs = [ln.split(":", 1)[-1].strip()[:80]
                for ln in proc.stderr.splitlines() if "Used" in ln]
        if proc.returncode:
            _emit(card, kernel="binning_shape", threads=threads,
                  items=items, error=proc.stderr[-400:])
            continue
        fn = _nvcc.declare(ctypes.CDLL(so), radix16.SOURCE).gst_binning
        part = threads * items
        rec = dict(kernel="binning_shape", threads=threads, items=items,
                   partition=part, ptxas=regs)
        for k in (1, 3):
            ops = planes3[:k]
            out = [torch.empty_like(y) for y in ops]
            cur = torch.empty_like(bases[7])
            spare = [0] * (3 - k)

            def call():
                scratch, epoch = kernels._scan_scratch(
                    dev, stream, 16 * (-(-N // part)))
                rc = fn(*[y.data_ptr() for y in ops], *spare,
                        *[o.data_ptr() for o in out], *spare, None,
                        bases[7].data_ptr(), cur.data_ptr(),
                        scratch.data_ptr(), scratch.numel() - 1, epoch, k,
                        N, 28, stream)
                if rc:
                    raise RuntimeError(f"launch failed: {rc}")
            call()
            torch.cuda.synchronize()
            exact = all(torch.equal(a, b) for a, b in
                        zip(out + [cur], want[k][0] + [want[k][1]]))
            rec[f"bit_exact_{k}"] = exact
            rec[f"ms_{k}"] = _med(call, dev)
            del out
        _emit(card, **rec)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = _card()
    if "--tree" in sys.argv:            # one turn of a --parent compare
        times(card, dev)
        return 0
    print(card, flush=True)
    from gpusorting_tpu_torch.ops import bitonic, radix16
    _ptxas(radix16.SOURCE)
    _ptxas(bitonic.SOURCE)
    if "--time-only" not in sys.argv:
        checks(card, dev)
    if "--shapes" in sys.argv:
        shapes(card, dev)
    if "--parent" not in sys.argv:
        times(card, dev)
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
