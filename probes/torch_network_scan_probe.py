"""Probe of the port's exclusive scan and in-tile network kernels on one
NVIDIA card.

    python3 probes/torch_network_scan_probe.py [--time-only]

Prints the card's name and power limit, `-Xptxas -v` of csrc/bitonic.cu
and csrc/exclusive_scan.cu (registers and spills of each kernel), then one
JSON line per measurement: `kernels.exclusive_scan`, its bare ctypes
launch, `torch.cumsum` and `torch.empty_like` on 2^20 int32 values (the
call between two events as chip_smoke.py times it, median of 5 and of 50;
the device time of calls queued behind a spin; the host time a call), and
`bitonic.local_stages` at n = 2^28 on its in-tile schedule and one tail,
for (planes, keys) (1, 1), (2, 2), (3, 2), (4, 2) at the tuning row's
tiles, each first held bit for bit against its plain version on the first
2^22 elements (not with --time-only); then the 1-plane in-tile pass split
into its warp-run stages, its long-stride stages and a copy, and 50
stages of one stride in the thread or by a shuffle.  Needs a CUDA card
and nvcc.
"""

import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

N = 1 << 28


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from gpusorting_tpu_torch.core import prng
    from gpusorting_tpu_torch.ops import _nvcc, bitonic, kernels
    from gpusorting_tpu_torch.utils import timing

    check = "--time-only" not in sys.argv
    tree = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # a tree from before the run table splits nothing: one run a schedule
    runs_of = getattr(bitonic, "stage_runs", lambda sched: [sched])
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    for src in (bitonic.SOURCE, kernels.SCAN_SOURCE):
        out = subprocess.run(
            [_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             os.devnull, str(src)], capture_output=True, text=True)
        for line in out.stderr.splitlines():
            if "entry function" in line or "Used" in line or "spill" in line:
                print(src.name, line.split(":", 1)[-1].strip()[:140])

    def med(fn, iters=5):
        return statistics.median(timing.device_time_ms(fn, iters=iters,
                                                       device=dev))

    def emit(**rec):
        rec["card"] = card
        print(json.dumps(rec), flush=True)

    vals = prng.hybrid_taus_bits(1 << 20, 7, device=dev).view(torch.int32)
    ok = torch.equal(kernels.exclusive_scan(vals),
                     kernels.exclusive_scan_plain(vals))
    fns = [("exclusive_scan", lambda: kernels.exclusive_scan(vals)),
           ("torch.cumsum", lambda: torch.cumsum(vals, 0)),
           ("torch.empty_like", lambda: torch.empty_like(vals))]
    if hasattr(kernels, "_scan_scratch"):   # the one-launch chained scan
        out = torch.empty_like(vals)
        lib = _nvcc.load(kernels.SCAN_SOURCE)
        scratch, _ = kernels._scan_scratch(
            dev, torch.cuda.current_stream(dev).cuda_stream, 512)
        epoch = [1 << 20]

        def raw():     # the bare ctypes launch, no wrapper around it
            epoch[0] += 1
            lib.gst_exclusive_scan(
                vals.data_ptr(), out.data_ptr(), 1 << 20, scratch.data_ptr(),
                scratch.numel() - 1, epoch[0],
                torch.cuda.current_stream(dev).cuda_stream)
        fns.append(("raw_launch", raw))
    for name, fn in fns:
        rec = dict(kernel=name, n=1 << 20, bit_exact=ok, ms=med(fn),
                   tree=tree, ms_median_of_50=med(fn, 50))
        if hasattr(timing, "queued_device_time_ms"):   # not in older trees
            rec.update(device_ms=timing.queued_device_time_ms(fn,
                                                              device=dev),
                       host_ms=timing.host_time_ms(fn, device=dev))
        emit(**rec)

    x = prng.hybrid_taus_bits(N, 11, device=dev).view(torch.int32)
    rides = [torch.arange(N, dtype=torch.int32, device=dev)] + [
        prng.hybrid_taus_bits(N, 12 + q, device=dev).view(torch.int32)
        for q in range(2)]
    for num_ops, num_keys in ((1, 1), (2, 2), (3, 2), (4, 2)):
        tr = bitonic.network_tile_rows(dev, num_ops)
        te = tr * 128
        ops = [y.view(-1, 128) for y in ([x] + rides)[:num_ops]]
        for sname, sched in (("in_tile", bitonic.in_tile_schedule(te)),
                             ("tail", bitonic.tail_schedule(te, 4 * te))):
            exact = None
            if check:
                part = [y[:(1 << 22) // 128] for y in ops]
                got = bitonic.local_stages(part, sched, num_keys, tr)
                want = bitonic.local_stages_plain(part, sched, num_keys, tr)
                exact = all(torch.equal(g, w) for g, w in zip(got, want))
                del got, want
            emit(kernel="local_stages", schedule=sname, planes=num_ops,
                 num_keys=num_keys, tile_elems=te, stages=sched.shape[0],
                 runs=len(runs_of(sched)), bit_exact_2_22=exact,
                 ms=med(lambda: bitonic.local_stages(ops, sched, num_keys,
                                                     tr)), tree=tree)
            torch.cuda.empty_cache()
    # where the 1-plane in-tile pass spends its time: its warp-run stages
    # alone, its long-stride stages alone, and no stage (the copy)
    tr = bitonic.network_tile_rows(dev, 1)
    sched = bitonic.in_tile_schedule(tr * 128)
    ops = [x.view(-1, 128)]
    # and 50 stages of one stride in a generic warp run: in the thread
    # (1, 2), by a shuffle (8, 16)
    same = {j: torch.tensor([[j, 2 * j]] * 50, dtype=torch.int32)
            for j in (1, 8)}
    for part, sub in (("warp_strides", sched[sched[:, 0] < 256]),
                      ("long_strides", sched[sched[:, 0] >= 256]),
                      ("copy", sched[:0]),
                      ("50_register_stages", same[1]),
                      ("50_shuffle_stages", same[8])):
        emit(kernel="local_stages", schedule=f"in_tile_{part}", planes=1,
             stages=sub.shape[0], runs=len(runs_of(sub)),
             ms=med(lambda: bitonic.local_stages(ops, sub, 1, tr)),
             tree=tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())
