"""Probe of the port's distributed sort on one NVIDIA card: what gloo
carries on CUDA tensors.

    python3 probes/torch_dist_probe.py

Prints the card's name and power limit, `-Xptxas -v` of
csrc/exchange_mask.cu, then for 2 and 4 gloo ranks on cuda:0 which of
all_to_all_single (sync and async), all_gather, all_reduce and
batch_isend_irecv run on CUDA tensors, and whether distributed_sort on the
card is bit-exact with the same group's CPU run (a failed p2p op breaks
the group, so the sorts after it fail too).  Needs a CUDA card and nvcc.
"""

import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def _probe(rank, world, n):
    import torch.distributed as dist

    from gpusorting_tpu_torch.parallel import dist_sort

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out = {}

    def attempt(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:   # recorded: the probe's result
            out[name] = f"{type(e).__name__}: {e}"[:400]

    x = torch.arange(world * 4, dtype=torch.int32, device=dev) + rank * 100
    y = torch.empty_like(x)
    parts = [torch.empty_like(x) for _ in range(world)]

    def p2p():
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % world),
               dist.P2POp(dist.irecv, y, (rank - 1) % world)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()

    attempt("all_to_all_single", lambda: dist.all_to_all_single(y, x))
    attempt("all_to_all_single_async",
            lambda: dist.all_to_all_single(y, x, async_op=True).wait())
    attempt("all_gather", lambda: dist.all_gather(parts, x))
    attempt("all_reduce",
            lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.MAX))
    attempt("batch_isend_irecv", p2p)
    g = torch.Generator().manual_seed(7)
    keys = torch.randint(0, 2**32, (n,), generator=g,
                         dtype=torch.int64).to(torch.uint32)
    vals = torch.arange(n, dtype=torch.int32).view(torch.uint32)
    nl = n // world
    k, v = keys[rank * nl:(rank + 1) * nl], vals[rank * nl:(rank + 1) * nl]
    for ex in ("collective", "remote_dma"):
        try:
            rc = dist_sort.distributed_sort(k.clone(), v.clone(), exchange=ex)
            rg = dist_sort.distributed_sort(k.to(dev), v.to(dev), exchange=ex)
            torch.cuda.synchronize()
            out[f"sort_{ex}"] = all(
                torch.equal(rc[f].view(torch.int32),
                            rg[f].view(torch.int32).cpu())
                for f in ("codes", "global_index", "payload_bits"))
        except Exception as e:   # recorded: the probe's result
            out[f"sort_{ex}"] = f"{type(e).__name__}: {e}"[:600]
    return out


def main():
    from gpusorting_tpu_torch.ops import _nvcc
    from gpusorting_tpu_torch.parallel import remote_exchange as rx
    from gpusorting_tpu_torch.parallel.launch import run_ranks

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(torch.__version__, torch.version.cuda)
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-Xptxas", "-v",
                            "-o", os.path.join(tmp, "m.so"), str(rx.SOURCE)],
                           capture_output=True, text=True)
    print("ptxas:", r.returncode, r.stderr[-1500:])
    for world in (2, 4):
        try:
            res = run_ranks(_probe, world, 1 << 20, timeout=240)
            print(json.dumps({"world": world, "ranks": res}))
        except (RuntimeError, TimeoutError) as e:
            print("probe failed", world, type(e).__name__, str(e)[:2000])


if __name__ == "__main__":
    main()
