"""Probe of the distributed sort's receive-side masking kernel
(csrc/exchange_mask.cu) on one NVIDIA card, beside an earlier build of it.

    python3 probes/torch_mask_probe.py [--parent DIR] [--alt FILE ...]

DIR holds an earlier tree's `gpusorting_tpu_torch/csrc/` (for example
unpacked from `git archive <commit> gpusorting_tpu_torch/csrc` into an
ignored directory such as scratch_chip/).  Prints the card's name and
power limit and `-Xptxas -v` of this tree's source (and DIR's), then one
JSON line per shape:

  path        the last collective chunk of a one-rank cap n + 2^20 sort
              (n = 2^28): 1 row of 2^26 + 2^18 slots at col0 = 3 x width,
              count n, so its last 2^20 slots are tail; 3 planes
  full_chunk  a chunk of the 2^28 ladder, 1 row of 2^26 slots, no tail; 3
              planes (60 of the distributed path's 65 launches)
  d8_3, d8_2  D = 8 blocks of 2^25, counts uniform near 2^24; 3 / 2 planes
              (one rank's receive buffer in an 8-GPU sort of 2^30 pairs)
  d8_3_lines  d8_3 with each count rounded down to a multiple of 32, so
              every tail starts on a 128-byte line
  d8_zero     D = 8 blocks of 2^25, every count 0: every slot masked; 3
              planes

Each build's C entry point is called directly (the same host path for
every build), after its output is held equal to `mask_arrivals_plain`'s
on the same planes.  Each --alt FILE is another source with the same C
entry point (a candidate design), built, checked and timed the same way.
Times in ms a launch: `device_ms`, 200 launches queued behind a spin (the
card's time alone); `call_ms`, one launch between two events, median of
20 (the host's issue time included).  The builds are timed in turns
(parent, this, the candidates, then the same in reverse).  The bound is
the tail's bytes written once over the card's memory rate (the counts
read where there is no tail).

Needs a CUDA card and nvcc.  The parent's library is built into the
package's ignored `_build/` directory.
"""

import argparse
import ctypes
import hashlib
import json
import os
import pathlib
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

N = 1 << 28
SEED = 14
BW = 3.35e12          # H100 SXM bytes/s (data sheet)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _emit(card, **rec):
    rec["card"] = card
    print(json.dumps(rec), flush=True)


def _ptxas(src):
    from gpusorting_tpu_torch.ops import _nvcc
    out = subprocess.run([_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-Xptxas", "-v",
                          "-o", os.devnull, str(src)], capture_output=True,
                         text=True)
    for line in out.stderr.splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            print(src, line.split(":", 1)[-1].strip()[:150], flush=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{out.stderr}")


def _build_other(src: pathlib.Path, tag: str) -> pathlib.Path:
    """`src` built into _build/ under a name of its own."""
    from gpusorting_tpu_torch.ops import _nvcc
    h = hashlib.sha256(src.read_bytes())
    so = _nvcc.BUILD_DIR / f"{tag}_{src.stem}_{h.hexdigest()[:16]}.so"
    if not so.exists():
        _nvcc.BUILD_DIR.mkdir(exist_ok=True)
        subprocess.run([_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, "-o", str(so),
                        str(src)], check=True)
    return so


def _entry(so: pathlib.Path, src: pathlib.Path):
    """`gst_mask_arrivals` of `so`, declared from `src`, its source."""
    from gpusorting_tpu_torch.ops import _nvcc
    return _nvcc.declare(ctypes.CDLL(str(so)), src).gst_mask_arrivals


def _caller(fn, planes, rc, fills, col0):
    """One launch of `fn` on `planes` (all D sources), as the wrapper
    makes it, with the arguments computed once."""
    pad = 4 - len(planes)
    args = ([p.data_ptr() for p in planes] + [None] * pad
            + [p.stride(0) for p in planes] + [0] * pad
            + [int(f) for f in fills] + [0] * pad
            + [len(planes), rc.data_ptr(), 0, rc.shape[0], planes[0].shape[1],
               col0])
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(*args, stream)
        if err:
            raise RuntimeError(f"mask launch failed: CUDA error {err}")
    return call


def _shapes(dev):
    """name -> (planes, rc, col0, tail slots)."""
    g = torch.Generator(device=dev).manual_seed(SEED)

    def planes(rows, width, num_ops):
        return [torch.randint(-2**31, 2**31 - 1, (rows, width), generator=g,
                              device=dev, dtype=torch.int32)
                for _ in range(num_ops)]

    cw = (N + (1 << 20)) // 4
    yield "path", planes(1, cw, 3), torch.tensor(
        [N], dtype=torch.int32, device=dev), 3 * cw, 1 << 20
    yield "full_chunk", planes(1, N // 4, 3), torch.tensor(
        [N], dtype=torch.int32, device=dev), 0, 0
    d8, cap8 = 8, 1 << 25
    rc = (1 << 24) + torch.randint(-4096, 4096, (d8,), generator=g,
                                   device=dev, dtype=torch.int32)
    tail = int((cap8 - rc).sum())
    for num_ops in (3, 2):
        yield f"d8_{num_ops}", planes(d8, cap8, num_ops), rc, 0, tail
    lines = rc & ~31              # every tail starting on a 128-byte line
    yield "d8_3_lines", planes(d8, cap8, 3), lines, 0, int(
        (cap8 - lines).sum())
    yield "d8_zero", planes(d8, cap8, 3), torch.zeros(
        d8, dtype=torch.int32, device=dev), 0, d8 * cap8


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=pathlib.Path, default=None)
    ap.add_argument("--alt", type=pathlib.Path, action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mask_probe: no CUDA card", file=sys.stderr)
        return 2
    from gpusorting_tpu_torch.ops import _nvcc
    from gpusorting_tpu_torch.parallel import remote_exchange as rx
    from gpusorting_tpu_torch.utils import timing

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = _card()
    print(card, flush=True)
    builds = {"this": rx.SOURCE}
    if args.parent is not None:
        builds["parent"] = (args.parent / "gpusorting_tpu_torch" / "csrc"
                            / "exchange_mask.cu")
    for alt in args.alt:
        builds[f"alt_{alt.stem}"] = alt
    for src in builds.values():
        _ptxas(src)
    fns = {"this": _entry(_nvcc.build(rx.SOURCE), rx.SOURCE)}
    for name, src in builds.items():
        if name != "this":
            fns[name] = _entry(_build_other(src, name), src)
    turn = (["parent"] if "parent" in fns else []) + ["this"] + [
        b for b in fns if b.startswith("alt_")]
    order = turn + turn[::-1]
    fills = (-1, -1, 0)
    for name, planes, rc, col0, tail in _shapes(dev):
        fl = fills[:len(planes)]
        want = [p.clone() for p in planes]
        rx.mask_arrivals_plain(want, rc, fl, col0=col0)
        for build, fn in fns.items():
            got = [p.clone() for p in planes]
            _caller(fn, got, rc, fl, col0)()
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise RuntimeError(f"{build} != plain at {name}")
            del got
        del want
        times = {b: {"device_ms": [], "call_ms": []} for b in fns}
        for build in order:
            call = _caller(fns[build], planes, rc, fl, col0)
            times[build]["device_ms"].append(timing.queued_device_time_ms(
                call, iters=200, device=dev))
            times[build]["call_ms"].append(statistics.median(
                timing.device_time_ms(call, iters=20, device=dev)))
        written = 4 * tail * len(planes)
        _emit(card, shape=name, rows=planes[0].shape[0],
              width=planes[0].shape[1], col0=col0, operands=len(planes),
              tail_slots=tail,
              bound_ms=max(written, 4 * rc.shape[0]) / BW * 1e3,
              bound_by="bytes", **times)
        del planes
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
