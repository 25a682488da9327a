"""Probe of the port's row form of the reduce-then-scan pass
(csrc/downsweep_rows.cu, csrc/edge_fixup.cu) on one NVIDIA card, beside an
earlier build of the same two kernels.

    python3 probes/torch_row_form_probe.py [--parent DIR] [--shapes]

DIR holds an earlier tree's `gpusorting_tpu_torch/csrc/` (for example
unpacked from `git archive <commit> gpusorting_tpu_torch/csrc`).  Prints
the card's name and power limit, `-Xptxas -v` of this tree's two sources
(and DIR's), the dynamic shared memory a `downsweep_rows` block takes at
32 and 128 rows on 1-3 planes with the blocks an SM holds, then one JSON
line per (input, tile, planes) at n = 2^28, shift 28, on uniform, E020 and
sparse-digit keys (1-3 keys of digit 5 in every 4096):

  * this tree's `rts.downsweep_rows` and `rts.edge_fixup` (the wrappers,
    allocation included) in ms, median of 5, beside their byte bounds
    (as chip_smoke.py phase 19 counts them) and the element-form
    downsweep on the same table;
  * with --parent, DIR's kernels called as DIR's wrappers called them
    (outputs zeroed with torch.zeros_like, no table for the fixup), timed
    in turns with this tree's (parent, this, this, parent), after their
    outputs, side rows and fixed planes are held equal to this tree's;
  * with --shapes, csrc/downsweep_rows.cu built at other shapes (items a
    thread, -DGST_ROWS_ITEMS, and the blocks an SM its registers are
    sized for, -DGST_ROWS_MIN_BLOCKS), each held against this tree's
    outputs and timed on uniform keys at both tiles on 1 and 3 planes,
    with its registers and the blocks an SM it gets; and
    csrc/edge_fixup.cu built with other numbers of high entries a warp
    (-DGST_FIXUP_GROUP), each held against this tree's fixed planes and
    timed on the three inputs at both tiles on 1 and 3 planes.

Needs a CUDA card and nvcc.  The parent's and the shapes' libraries are
built into the package's ignored `_build/` directory.
"""

import concurrent.futures
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
LANES = 128
SEED = 42
SHIFT = 28
TILES = (32, 128)
SHAPES = ((16, 1), (16, 2), (16, 3), (16, 4), (8, 4), (8, 6))  # items, blocks
GROUPS = (1, 2, 4, 8)   # high entries a fixup warp takes
BW = 3.35e12          # H100 SXM bytes/s (data sheet)


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def _emit(card, **rec):
    rec["card"] = card
    print(json.dumps(rec), flush=True)


def _ptxas(src, flags=()):
    from gpusorting_tpu_torch.ops import _nvcc
    out = subprocess.run([_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, *flags,
                          "-Xptxas", "-v", "-o", os.devnull, str(src)],
                         capture_output=True, text=True)
    for line in out.stderr.splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            print(src, *flags, line.split(":", 1)[-1].strip()[:150],
                  flush=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{out.stderr}")


def _build_other(src: pathlib.Path, tag: str, flags=()) -> ctypes.CDLL:
    """`src` built with `flags` into _build/ under a name of its own, loaded
    with its entries declared from `src`."""
    from gpusorting_tpu_torch.ops import _nvcc
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    so = _nvcc.BUILD_DIR / f"{tag}_{src.stem}_{h.hexdigest()[:16]}.so"
    if not so.exists():
        _nvcc.BUILD_DIR.mkdir(exist_ok=True)
        subprocess.run([_nvcc._nvcc(), *_nvcc.NVCC_FLAGS, *flags, "-o",
                        str(so), str(src)], check=True)
    return _nvcc.declare(ctypes.CDLL(str(so)), src)


def _med(fn, dev, iters=5):
    from gpusorting_tpu_torch.utils import timing
    return statistics.median(timing.device_time_ms(fn, iters=iters,
                                                   device=dev))


def _inputs(dev):
    from gpusorting_tpu_torch.core import codec, prng
    import gpusorting_tpu_torch as gstt

    def sparse():
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

    yield "uniform", lambda: codec.encode_biased(prng.make_test_keys(
        N, SEED, torch.uint32, device=dev))
    yield "E020", lambda: codec.encode_biased(prng.make_test_keys(
        N, SEED, torch.uint32, gstt.EntropyPreset.E020, device=dev))
    yield "sparse_digit", sparse


class Build:
    """Another build's kernels: DIR's behind DIR's wrappers' calls (the
    outputs zeroed, no table for the fixup), or a shape of this tree's
    `downsweep_rows` (the outputs from torch.empty)."""

    def __init__(self, rows_lib, fixup_lib=None, zeroed=True):
        self.rows = rows_lib.gst_downsweep_rows
        self.lib = rows_lib
        self.zeroed = zeroed
        if fixup_lib is not None:
            self.fixup = fixup_lib.gst_edge_fixup

    @staticmethod
    def _ok(rc, what):
        if rc:
            raise RuntimeError(f"parent {what}: CUDA error {rc}")

    def downsweep_rows(self, ops, table, counts, shift, tile_rows):
        num_tiles = ops[0].shape[0] // tile_rows
        outs = [torch.zeros_like(p) if self.zeroed else torch.empty_like(p)
                for p in ops]
        side = torch.empty((num_tiles * len(ops) * 32, LANES),
                           dtype=torch.int32, device=ops[0].device)
        spare = [0] * (3 - len(ops))
        self._ok(self.rows(*[p.data_ptr() for p in ops], *spare,
                           *[o.data_ptr() for o in outs], *spare,
                           side.data_ptr(), table.data_ptr(),
                           counts.data_ptr(), len(ops), num_tiles,
                           tile_rows, shift,
                           torch.cuda.current_stream().cuda_stream),
                 "downsweep_rows")
        return outs, side

    def edge_fixup(self, rowtab, side, outs):
        spare = [0] * (3 - len(outs))
        self._ok(self.fixup(*[o.data_ptr() for o in outs], *spare,
                            side.data_ptr(), rowtab.data_ptr(), len(outs),
                            rowtab.numel() // 32, outs[0].shape[0],
                            torch.cuda.current_stream().cuda_stream),
                 "edge_fixup")
        return outs


def _occupancy(lib, planes, tile):
    from gpusorting_tpu_torch.ops import rts
    smem, blocks = ctypes.c_longlong(), ctypes.c_int()
    rc = lib.gst_downsweep_rows_occupancy(planes, tile, ctypes.byref(smem),
                                          ctypes.byref(blocks))
    if rc:
        raise RuntimeError(f"occupancy query: CUDA error {rc}")
    if smem.value != rts.rows_stage_bytes(planes, tile):
        raise RuntimeError("rows_stage_bytes != the kernel's")
    return smem.value, blocks.value


class Fixup:
    """A shape of this tree's `edge_fixup` (the table passed)."""

    def __init__(self, lib):
        self.fn = lib.gst_edge_fixup

    def __call__(self, rowtab, table, side, outs):
        spare = [0] * (3 - len(outs))
        rc = self.fn(*[o.data_ptr() for o in outs], *spare, side.data_ptr(),
                     rowtab.data_ptr(), table.data_ptr(), len(outs),
                     rowtab.numel() // 32, outs[0].shape[0],
                     torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"edge_fixup shape: CUDA error {rc}")
        return outs


def fixup_shapes(card, dev, fixups):
    """Each fixup shape against this tree's, and its times."""
    from gpusorting_tpu_torch.ops import kernels, rts
    ride = torch.arange(N, dtype=torch.int32, device=dev)
    for name, make in _inputs(dev):
        x = make()
        for tile in TILES:
            planes3 = rts.pad_tiles((x, ride, ride.clone()), tile)[0]
            counts = kernels.tile_histogram4(planes3[0], SHIFT, tile)
            table = kernels.exclusive_scan(counts.T.reshape(-1))
            rowtab = rts.edge_rows(table, counts)
            for n_planes in (1, 3):
                ops = planes3[:n_planes]
                outs, side = rts.downsweep_rows(ops, table, counts, SHIFT,
                                                tile)
                want = rts.edge_fixup(rowtab, table, side,
                                      [o.clone() for o in outs])
                rec = dict(input=name, tile_rows=tile, planes=n_planes,
                           this_tree_ms=_med(lambda: rts.edge_fixup(
                               rowtab, table, side, outs), dev))
                for group, f in fixups.items():
                    got = f(rowtab, table, side, [o.clone() for o in outs])
                    if not all(torch.equal(a, b) for a, b in zip(got, want)):
                        raise RuntimeError(f"fixup group {group} != this "
                                           f"tree's: {rec}")
                    del got
                    rec[f"group_{group}_ms"] = _med(
                        lambda: f(rowtab, table, side, outs), dev)
                _emit(card, kernel="edge_fixup_shape", bit_exact=True, **rec)
                del outs, side, want
            del planes3, counts, table, rowtab
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        del x


def occupancy(card):
    from gpusorting_tpu_torch.ops import _nvcc, rts
    for tile in TILES:
        for planes in (1, 2, 3):
            smem, blocks = _occupancy(_nvcc.load(rts.ROWS_SOURCE), planes,
                                      tile)
            _emit(card, kernel="downsweep_rows_occupancy", tile_rows=tile,
                  planes=planes, dynamic_smem_bytes=smem,
                  blocks_per_sm=blocks)


def shapes(card, dev, builds):
    """Each shape's downsweep_rows against this tree's, and its times."""
    from gpusorting_tpu_torch.core import codec, prng
    from gpusorting_tpu_torch.ops import kernels, rts
    x = codec.encode_biased(prng.make_test_keys(N, SEED, torch.uint32,
                                                device=dev))
    ride = torch.arange(N, dtype=torch.int32, device=dev)
    for tile in TILES:
        planes3 = rts.pad_tiles((x, ride, ride.clone()), tile)[0]
        counts = kernels.tile_histogram4(planes3[0], SHIFT, tile)
        table = kernels.exclusive_scan(counts.T.reshape(-1))
        present = (rts.edge_rows(table, counts).view(2, 16, -1) >= 0
                   ).permute(2, 1, 0)
        for n_planes in (1, 3):
            ops = planes3[:n_planes]
            outs, side = rts.downsweep_rows(ops, table, counts, SHIFT, tile)
            mask = present.unsqueeze(1).expand(-1, n_planes, -1,
                                               -1).reshape(-1)
            default_ms = _med(lambda: rts.downsweep_rows(
                ops, table, counts, SHIFT, tile), dev)
            for (items, minb), b in builds.items():
                g_outs, g_side = b.downsweep_rows(ops, table, counts, SHIFT,
                                                  tile)
                if not (all(torch.equal(p, q) for p, q in zip(outs, g_outs))
                        and torch.equal(side[mask], g_side[mask])):
                    raise RuntimeError(f"shape {items}, {minb} != this "
                                       f"tree's at {tile} rows")
                del g_outs, g_side
                _emit(card, kernel="downsweep_rows_shape", items=items,
                      min_blocks=minb, tile_rows=tile, planes=n_planes,
                      blocks_per_sm=_occupancy(b.lib, n_planes, tile)[1],
                      ms=_med(lambda: b.downsweep_rows(
                          ops, table, counts, SHIFT, tile), dev),
                      this_tree_ms=default_ms, bit_exact=True)
            del outs, side, mask
        del planes3, counts, table, present
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def times(card, dev, parent):
    from gpusorting_tpu_torch.ops import kernels, rts
    ride = torch.arange(N, dtype=torch.int32, device=dev)
    for name, make in _inputs(dev):
        x = make()
        for tile in TILES:
            planes3 = rts.pad_tiles((x, ride, ride.clone()), tile)[0]
            num_tiles = N // (tile * LANES)
            counts = kernels.tile_histogram4(planes3[0], SHIFT, tile)
            table = kernels.exclusive_scan(counts.T.reshape(-1))
            rowtab = rts.edge_rows(table, counts)
            present_t = (rowtab.view(2, 16, -1) >= 0).permute(2, 1, 0)
            present = int((rowtab >= 0).sum())
            named = int(torch.unique(rowtab[rowtab >= 0]).numel())
            for n_planes in (1, 2, 3):
                ops = planes3[:n_planes]
                side_bytes = 512 * n_planes * present
                rows_bound = (8 * N * n_planes + 128 * num_tiles
                              + side_bytes) / BW * 1e3
                fix_bound = (192 * num_tiles + side_bytes
                             + 1024 * n_planes * named) / BW * 1e3
                rec = dict(input=name, n=N, tile_rows=tile,
                           planes=n_planes, present_entries=present,
                           named_rows=named, rows_bound_ms=rows_bound,
                           fixup_bound_ms=fix_bound)
                outs, side = rts.downsweep_rows(ops, table, counts, SHIFT,
                                                tile)
                fixed = rts.edge_fixup(rowtab, table, side,
                                       [o.clone() for o in outs])
                turns = [("this", rts.downsweep_rows,
                          lambda o, s: rts.edge_fixup(rowtab, table, s, o))]
                if parent is not None:
                    p_outs, p_side = parent.downsweep_rows(ops, table,
                                                           counts, SHIFT,
                                                           tile)
                    mask = present_t.unsqueeze(1).expand(
                        -1, n_planes, -1, -1).reshape(-1)
                    same = (all(torch.equal(a, b)
                                for a, b in zip(outs, p_outs))
                            and torch.equal(side[mask], p_side[mask]))
                    p_fixed = parent.edge_fixup(rowtab, p_side, p_outs)
                    same = same and all(torch.equal(a, b)
                                        for a, b in zip(fixed, p_fixed))
                    if not same:
                        raise RuntimeError(f"this != parent: {rec}")
                    rec["bit_exact_with_parent"] = True
                    del p_outs, p_side, p_fixed, mask
                    pturn = ("parent", parent.downsweep_rows,
                             lambda o, s: parent.edge_fixup(rowtab, s, o))
                    turns = [pturn, turns[0], turns[0], pturn]
                for tree, rows_fn, fix_fn in turns:
                    r = _med(lambda: rows_fn(ops, table, counts, SHIFT,
                                             tile), dev)
                    f = _med(lambda: fix_fn(outs, side), dev)
                    rec.setdefault(f"{tree}_rows_ms", []).append(r)
                    rec.setdefault(f"{tree}_fixup_ms", []).append(f)
                rec["element_ms"] = _med(lambda: rts.downsweep(
                    ops, table, SHIFT, tile), dev)
                rec["rows_share_of_bound"] = (
                    rows_bound / statistics.mean(rec["this_rows_ms"]))
                rec["fixup_share_of_bound"] = (
                    fix_bound / statistics.mean(rec["this_fixup_ms"]))
                _emit(card, kernel="row_form", **rec)
                del outs, side, fixed
            del planes3, counts, table, rowtab, present_t
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        del x


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = _card()
    print(card, flush=True)
    from gpusorting_tpu_torch.ops import _nvcc, kernels, rts
    srcs = [rts.ROWS_SOURCE, rts.FIXUP_SOURCE]
    parent_srcs = []
    if "--parent" in sys.argv:
        pdir = pathlib.Path(sys.argv[sys.argv.index("--parent") + 1])
        parent_srcs = [pdir.resolve() / "gpusorting_tpu_torch" / "csrc" /
                       s.name for s in srcs]
    shape_flags, group_flags = {}, {}
    if "--shapes" in sys.argv:
        shape_flags = {(i, b): (f"-DGST_ROWS_ITEMS={i}",
                                f"-DGST_ROWS_MIN_BLOCKS={b}")
                       for i, b in SHAPES}
        group_flags = {g: (f"-DGST_FIXUP_GROUP={g}",) for g in GROUPS}
    with concurrent.futures.ThreadPoolExecutor(16) as pool:
        jobs = [pool.submit(_ptxas, s) for s in srcs + parent_srcs]
        jobs += [pool.submit(_ptxas, rts.ROWS_SOURCE, f)
                 for f in shape_flags.values()]
        jobs.append(pool.submit(_nvcc.build_all, srcs + [
            rts.SOURCE, kernels.HIST_SOURCE, kernels.SCAN_SOURCE]))
        built = [pool.submit(_build_other, s, "parent") for s in parent_srcs]
        shaped = {k: pool.submit(_build_other, rts.ROWS_SOURCE, "shape", f)
                  for k, f in shape_flags.items()}
        grouped = {k: pool.submit(_build_other, rts.FIXUP_SOURCE, "shape",
                                  f) for k, f in group_flags.items()}
        jobs += [pool.submit(_ptxas, rts.FIXUP_SOURCE, f)
                 for f in group_flags.values()]
        for j in jobs:
            j.result()
        parent = Build(*[b.result() for b in built]) if built else None
        builds = {k: Build(f.result(), zeroed=False)
                  for k, f in shaped.items()}
        fixups = {k: Fixup(f.result()) for k, f in grouped.items()}
    occupancy(card)
    if builds:
        shapes(card, dev, builds)
        fixup_shapes(card, dev, fixups)
    times(card, dev, parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
