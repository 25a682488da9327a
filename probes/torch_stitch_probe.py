"""Probe of the port's stitch kernels (compact, expand) on one NVIDIA card.

    python3 probes/torch_stitch_probe.py [--time-only] [--shapes]
                                         [--parent DIR]

Prints the card's name and power limit, `-Xptxas -v` of csrc/stitch.cu
(each kernel and plane count: registers, shared memory, spills) and of
csrc/exclusive_scan.cu, which shares its lookback, then one JSON line per
measurement:

  * unless --time-only, `stitch.compact_ops` and `expand_ops` against
    their plain versions, bit for bit, at 2^22 + 3 on 1-4 planes under a
    half-set, a sparse and an all-set mask, with the mask at byte offsets
    0, 1 and 13 and each plane at its own element offset, streams as long
    as the mask and shorter than the set count;
  * times at n = 2^28 (median of 5), half set: compact and expand on 1-4
    planes beside their byte bounds and, on 1 and 3 planes, the torch calls
    that compute the same function (`masked_select`, `masked_scatter_`);
    the exclusive scan on 2^20 values, the binning pass on 1 and 3 planes
    and the downsweep on 1 plane (they share radix_common.cuh, the scan
    and the binning pass also the scratch), and the global histogram,
    which shares nothing, as a yardstick of the card; every compact call of a
    splitsweep keys, pairs and 64-bit pairs sort (recorded from the sort,
    over 16 * cap_rows * 128 slots with a prefix mask per region); every
    stitch call of a layout-(c) pairs call of the segmented sort (2^26
    keys, 14 segments of 2^18-2^19 among segments of at most 64);
  * with --shapes, csrc/stitch.cu built at other tiles (threads x items
    through -DGST_STITCH_THREADS / -DGST_STITCH_ITEMS), each held against
    plain at 2^28 and timed on 1 and 3 planes (median of 20; the first two
    shapes again at the end, to show the spread);
  * with --parent DIR (a `git archive` of an earlier tree), the times again
    from DIR's package, in turns with this tree's (parent, this, this,
    parent), each in a process of its own, so both share one card.

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

import numpy as np  # noqa: E402
import torch  # noqa: E402

N = 1 << 28
BW = 3.35e12          # H100 SXM bytes/s (data sheet)


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
    lines = []
    for line in out.stderr.splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            lines.append(line.split(":", 1)[-1].strip()[:150])
            print(src.name, *extra, lines[-1])
    return lines


def _med(fn, dev, iters=5):
    from gpusorting_tpu_torch.utils import timing
    return statistics.median(timing.device_time_ms(fn, iters=iters,
                                                   device=dev))


def _mask(kind, n, seed, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if kind == "all":
        return torch.ones(n, dtype=torch.bool, device=dev)
    p = 0.5 if kind == "half" else 1 / 64
    return torch.rand(n, generator=g, device=dev) < p


def _same(got, want, what):
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise RuntimeError(f"mismatch: {what}")


def _check_call(compact, expand, ops, srcs, mask, what):
    from gpusorting_tpu_torch.ops import stitch
    packed, cnt = compact(ops, mask)
    wpacked, wcnt = stitch.compact_plain(ops, mask)
    c = int(wcnt)
    if int(cnt) != c:
        raise RuntimeError(f"count {int(cnt)} != {c}: {what}")
    _same([p[:c] for p in packed], [w[:c] for w in wpacked],
          f"compact {what}")
    _same(expand(srcs, mask), stitch.expand_plain(srcs, mask),
          f"expand {what}")


def checks(card, dev):
    """The bit-exact cases of the module docstring; raises on a miss."""
    from gpusorting_tpu_torch.core import prng
    from gpusorting_tpu_torch.ops import stitch
    n = (1 << 22) + 3
    bufs = [prng.hybrid_taus_bits(n + 8, 70 + q, device=dev)
            .view(torch.int32) for q in range(4)]
    bufs[0] = bufs[0] & 3                         # ties
    cases = 0
    for kind in ("half", "sparse", "all"):
        mbuf = _mask(kind, n + 16, 5, dev)
        for mo in (0, 1, 13):
            mask = mbuf[mo:mo + n]
            count = int(mask.sum())
            for k in (1, 2, 3, 4):
                offs = [(mo + q) % 4 for q in range(k)]
                ops = [b[o:o + n] for b, o in zip(bufs, offs)]
                for length in (n, count // 2):
                    srcs = [b[3 - o:3 - o + length]
                            for b, o in zip(bufs, offs)]
                    _check_call(stitch.compact_ops, stitch.expand_ops, ops,
                                srcs, mask, f"{kind} offset {mo} {k} planes "
                                f"stream {length}")
                    cases += 1
    torch.cuda.synchronize()
    _emit(card, kernel="compact+expand", n=n, bit_exact=True, cases=cases,
          check="masks half/sparse/all at byte offsets 0, 1, 13; 1-4 planes "
                "at their own offsets; streams n and count // 2")


def _splitsweep_compacts(dev):
    """(planes, mask) of the compact of a splitsweep keys, pairs and 64-bit
    pairs sort, recorded from the sorts (answered by the plain version)."""
    import gpusorting_tpu_torch as gstt
    from gpusorting_tpu_torch.core import prng
    from gpusorting_tpu_torch.ops import stitch
    keys = prng.make_test_keys(N, 2041, torch.uint32,
                               gstt.EntropyPreset.E033, device=dev)
    pal = {"backend": gstt.Backend.PALLAS, "variant": "splitsweep"}
    real = stitch.compact_ops
    calls = []

    def rec(planes, mask):
        calls.append((tuple(planes), mask))
        return stitch.compact_plain(tuple(planes), mask)
    stitch.compact_ops = rec
    try:
        gstt.sort(keys, **pal)
        gstt.sort_pairs(keys, prng.hybrid_taus_bits(N, 2042, device=dev),
                        **pal)
        gstt.sort_pairs(keys, torch.arange(N, dtype=torch.int64, device=dev),
                        **pal)
    finally:
        stitch.compact_ops = real
    torch.cuda.synchronize()
    return calls


def _layout_c_calls(dev):
    """(kernel, planes, mask) of every stitch call of one layout-(c) pairs
    call (the length-class split), recorded from the sort."""
    import gpusorting_tpu_torch as gstt
    from gpusorting_tpu_torch.core import codec, prng
    from gpusorting_tpu_torch.ops import stitch
    total = 1 << 26
    rng = np.random.default_rng(2043)
    big = rng.integers(1 << 18, (1 << 19) + 1, 14)
    rem = total - int(big.sum())
    small = rng.integers(1, 65, 2 * rem // 64 + 64)
    ends = np.cumsum(small)
    k = int(np.searchsorted(ends, rem))
    small = small[:k + 1]
    small[k] -= int(ends[k]) - rem
    lens = rng.permutation(np.concatenate([big, small]))
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    offs = codec.wrap_int32(torch.from_numpy(starts)).to(dev)
    keys, vals = prng.make_test_pairs(total, 2044, torch.uint32, torch.uint32,
                                      gstt.EntropyPreset.E033, device=dev)
    real = {"compact": stitch.compact_ops, "expand": stitch.expand_ops}
    plain = {"compact": stitch.compact_plain, "expand": stitch.expand_plain}
    calls = []

    def recorder(kname):
        def rec(planes, mask):
            calls.append((kname, tuple(planes), mask))
            return plain[kname](tuple(planes), mask)
        return rec
    stitch.compact_ops = recorder("compact")
    stitch.expand_ops = recorder("expand")
    try:
        gstt.split_sort_pairs(offs, keys, vals, len(lens), total)
    finally:
        stitch.compact_ops, stitch.expand_ops = (real["compact"],
                                                 real["expand"])
    torch.cuda.synchronize()
    return calls


def times(card, dev):
    """The stitch kernels' times at 2^28, from whichever tree is on the
    path."""
    from gpusorting_tpu_torch.core import prng
    from gpusorting_tpu_torch.ops import kernels, radix16, rts, stitch

    half = _mask("half", N, 2024, dev)
    count = int(half.sum())
    planes = [prng.hybrid_taus_bits(N, 80 + q, device=dev).view(torch.int32)
              for q in range(4)]
    for k in (1, 2, 3, 4):
        ops = planes[:k]
        packed, _ = stitch.compact_ops(ops, half)
        srcs = [p[:count].clone() for p in packed]
        del packed
        rec_c = dict(ms=_med(lambda: stitch.compact_ops(ops, half), dev),
                     bound_ms=(N * (1 + 4 * k) + 4 * k * count) / BW * 1e3)
        rec_e = dict(ms=_med(lambda: stitch.expand_ops(srcs, half), dev),
                     bound_ms=(N + 4 * k * count + 4 * k * N) / BW * 1e3)
        if k in (1, 3):
            rec_c["library_ms"] = _med(
                lambda: [torch.masked_select(p, half) for p in ops], dev)
            rec_e["library_ms"] = _med(lambda: [
                torch.zeros(N, dtype=torch.int32, device=dev)
                .masked_scatter_(half, s) for s in srcs], dev)
        _emit(card, kernel="compact", planes=k, n=N, count=count, **rec_c)
        _emit(card, kernel="expand", planes=k, n=N, count=count, **rec_e)
        del srcs
    del planes
    torch.cuda.empty_cache()

    v = prng.hybrid_taus_bits(1 << 20, 3, device=dev).view(torch.int32)
    x = prng.hybrid_taus_bits(N, 4, device=dev).view(torch.int32)
    bases, _ = radix16._bases_all_passes(x)
    _emit(card, kernel="exclusive_scan", n=1 << 20,
          ms=_med(lambda: kernels.exclusive_scan(v), dev, iters=50))
    planes3 = [x.view(-1, 128), v.new_zeros(N).view(-1, 128),
               x.flip(0).view(-1, 128)]
    for k in (1, 3):
        _emit(card, kernel="binning_pass", planes=k, n=N, shift=28,
              ms=_med(lambda: radix16.binning_pass(planes3[:k], bases[7], 28,
                                                   32), dev))
    counts = kernels.tile_histogram4(planes3[0], 28, 32)
    table = kernels.exclusive_scan(counts.T.reshape(-1))
    _emit(card, kernel="downsweep", planes=1, n=N, tile_rows=32,
          ms=_med(lambda: rts.downsweep(planes3[:1], table, 28, 32), dev))
    _emit(card, kernel="global_histogram", n=N,
          ms=_med(lambda: kernels.global_histogram(x), dev))
    del x, v, planes3
    torch.cuda.empty_cache()

    shapes = []
    for ops, mask in _splitsweep_compacts(dev):
        shapes.append({"planes": len(ops), "n": mask.numel(),
                       "count": int(mask.sum()),
                       "ms": _med(lambda: stitch.compact_ops(ops, mask),
                                  dev)})
    _emit(card, kernel="compact", at="splitsweep keys, pairs, 64-bit pairs",
          calls=shapes)
    torch.cuda.empty_cache()
    shapes = []
    for kname, ops, mask in _layout_c_calls(dev):
        fn = stitch.compact_ops if kname == "compact" else stitch.expand_ops
        shapes.append({"kernel": kname, "planes": len(ops),
                       "n": mask.numel(), "count": int(mask.sum()),
                       "lengths": sorted({p.numel() for p in ops}),
                       "ms": _med(lambda: fn(ops, mask), dev)})
    _emit(card, kernel="compact+expand", at="layout (c) pairs call",
          calls=shapes, sum_ms=sum(c["ms"] for c in shapes))
    torch.cuda.empty_cache()


def shapes(card, dev):
    """csrc/stitch.cu at other tiles, each checked and timed."""
    from gpusorting_tpu_torch.core import prng
    from gpusorting_tpu_torch.ops import _nvcc, kernels, stitch

    half = _mask("half", N, 2024, dev)
    count = int(half.sum())
    planes = [prng.hybrid_taus_bits(N, 80 + q, device=dev).view(torch.int32)
              for q in range(3)]
    srcs = [p[:count] for p in planes]
    stream = torch.cuda.current_stream(dev).cuda_stream
    build = os.path.join(TREE, "gpusorting_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    for turn, (threads, items) in enumerate((
            (256, 16), (128, 16), (512, 16), (128, 32), (256, 32), (256, 16),
            (128, 16))):
        flags = (f"-DGST_STITCH_THREADS={threads}",
                 f"-DGST_STITCH_ITEMS={items}")
        so = os.path.join(build, f"stitch_{threads}x{items}_{turn}.so")
        proc = subprocess.run([_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, *flags,
                               "-Xptxas", "-v", "-o", so, str(stitch.SOURCE)],
                              capture_output=True, text=True)
        regs = [ln.split(":", 1)[-1].strip()[:80]
                for ln in proc.stderr.splitlines() if "Used" in ln]
        if proc.returncode:
            _emit(card, kernel="stitch_shape", threads=threads, items=items,
                  error=proc.stderr[-400:])
            continue
        lib = _nvcc.declare(ctypes.CDLL(so), stitch.SOURCE)
        tile = lib.gst_stitch_tile()

        def scratch():
            buf, epoch = kernels._scan_scratch(dev, stream, -(-N // tile))
            return buf.data_ptr(), buf.numel() - 1, epoch

        def compact(ops, mask):
            outs = [torch.empty_like(p) for p in ops]
            cnt = torch.zeros((), dtype=torch.int32, device=dev)
            spare = [None] * (4 - len(ops))
            rc = lib.gst_compact(*[p.data_ptr() for p in ops], *spare,
                                 *[o.data_ptr() for o in outs], *spare,
                                 mask.data_ptr(), mask.numel(),
                                 cnt.data_ptr(), *scratch(), len(ops),
                                 stream)
            if rc:
                raise RuntimeError(f"compact launch failed: {rc}")
            return outs, cnt

        def expand(ss, mask):
            outs = [torch.empty(mask.numel(), dtype=torch.int32, device=dev)
                    for _ in ss]
            spare = [None] * (4 - len(ss))
            rc = lib.gst_expand(*[s.data_ptr() for s in ss], *spare,
                                *[s.numel() for s in ss],
                                *[0] * (4 - len(ss)),
                                *[o.data_ptr() for o in outs], *spare,
                                mask.data_ptr(), mask.numel(), *scratch(),
                                len(ss), stream)
            if rc:
                raise RuntimeError(f"expand launch failed: {rc}")
            return outs
        rec = dict(kernel="stitch_shape", threads=threads, items=items,
                   tile=tile, ptxas=regs)
        for k in (1, 3):
            _check_call(compact, expand, planes[:k], srcs[:k], half,
                        f"{threads}x{items} {k} planes")
            rec[f"compact_ms_{k}"] = _med(lambda: compact(planes[:k], half),
                                          dev, iters=20)
            rec[f"expand_ms_{k}"] = _med(lambda: expand(srcs[:k], half), dev,
                                         iters=20)
        rec["bit_exact"] = True
        _emit(card, **rec)
    torch.cuda.empty_cache()


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
    from gpusorting_tpu_torch.ops import kernels, stitch
    _ptxas(stitch.SOURCE)
    _ptxas(kernels.SCAN_SOURCE)
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
