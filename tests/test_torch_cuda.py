"""Tests of gpusorting_tpu_torch that need an NVIDIA card: each hand-written
kernel (relocate, tile_histogram4, exclusive_scan, downsweep and its row
form downsweep_rows with edge_fixup, global_histogram, binning_pass and its digit-plane form, local_stages,
global_stage, compact_ops, expand_ops, merge_tail, hyper_stage, the
segmented tile, the distributed sort's mask and merge) against its plain
version, their launch checks, the engines
and public entry points through the kernels against flat torch.sort, the
segmented sort (its tile route included) against the composite oracle,
its fixed-length route on a sampler's f32 rows against the plain per-row
oracle (sortbench/plain_rows.py), and the tuner's sweeps and
the console driver's bench line on the card.

Every test here is marked `cuda` and skips where torch sees no card.  This
file imports neither JAX nor the JAX package, so it runs on a machine with
only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import gpusorting_tpu_torch as gstt
from gpusorting_tpu_torch.core import codec, config, prng
from gpusorting_tpu_torch.ops import (_nvcc, bitonic, ffx, flat_sort,
                                      kernels, mergesweep, radix, radix16,
                                      relocate, rangesweep as rs, rts,
                                      splitsweep, stitch)
from gpusorting_tpu_torch.parallel import dist_merge, dist_sort
from gpusorting_tpu_torch.parallel import remote_exchange as rx
from gpusorting_tpu_torch.segsort import splitsort
from gpusorting_tpu_torch.utils import trace, validate

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA-only)")
    return torch.device("cuda")


def _codes(kind, n, seed, dev):
    rng = np.random.default_rng(seed)
    if kind == "rand":
        x = rng.integers(0, 2**32, n, dtype=np.uint32)
    elif kind == "dup16":
        x = rng.integers(0, 16, n, dtype=np.uint32)
    elif kind == "alleq":
        x = np.full(n, 0xABCD1234, np.uint32)
    else:   # lowhi: two values, every range edge a run edge
        x = np.where(np.arange(n) % 2 == 0, 0, 0xFFFFFFFF).astype(np.uint32)
    return codec.bias(torch.from_numpy(x)).to(dev)


@pytest.mark.parametrize("K,L", [(70, 1024), (8, 256), (5, 384), (128, 4096)])
@pytest.mark.parametrize("kind", ["rand", "dup16", "alleq", "lowhi"])
def test_relocate_kernel_matches_plain(cuda, kind, K, L):
    x2 = rs._phase_sort_keys(_codes(kind, K * L, K + L, cuda).view(K, L))
    extra = torch.randint(-2**31, 2**31 - 1, (3, K, L), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(K)
                          ).to(cuda)
    bounds = rs._cuts(x2, K, L, heads=x2[:, ::128])
    for planes in ((x2,), (x2,) + tuple(extra)):
        before = relocate.relocate.launches
        got = rs._range_exchange(planes, bounds, K, L, method="dma")
        want = rs._range_exchange(planes, bounds, K, L, method="gather")
        torch.cuda.synchronize()
        assert relocate.relocate.launches == before + len(planes)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_relocate_checks_on_card(cuda):
    K, l_rows = 4, 2
    ctrl = torch.zeros(3 * K * K + K, dtype=torch.int32, device=cuda)
    src = torch.zeros((K * l_rows, 128), dtype=torch.int32, device=cuda)
    fringe = torch.zeros((2 * K * K, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        relocate.relocate(ctrl, src.float(), fringe, K, l_rows, 2 * K)
    with pytest.raises(ValueError, match="shape"):
        relocate.relocate(ctrl[1:], src, fringe, K, l_rows, 2 * K)
    with pytest.raises(ValueError, match="contiguous"):
        relocate.relocate(ctrl, src.T.contiguous().T, fringe, K, l_rows,
                          2 * K)
    with pytest.raises(ValueError, match="src on"):
        relocate.relocate(ctrl.cpu(), src, fringe, K, l_rows, 2 * K)


@pytest.mark.parametrize("n,L,and_count", [(300_000, 4096, 0),
                                           (1 << 20, 1 << 13, 3),
                                           (99_999, 1024, 6)])
def test_engines_match_torch_sort(cuda, n, L, and_count):
    k = codec.encode_biased(prng.hybrid_taus_bits(n, n, and_count,
                                                  device=cuda))
    want = torch.sort(k, stable=True)
    before = relocate.relocate.launches
    assert torch.equal(rs.sort_codes_rangesweep(k, seg_elems=L), want.values)
    sk, perm = rs.argsort_rangesweep(k, seg_elems=L)
    assert torch.equal(sk, want.values)
    assert torch.equal(perm.long(), want.indices)
    v = prng.hybrid_taus_bits(n, n + 1, device=cuda).view(torch.int32)
    sk, sv = rs.sort_pairs_rangesweep(k, v, seg_elems=L)
    assert torch.equal(sv, v[want.indices])
    w = codec.join_wide(v, v ^ 0x5A5A5A5A)
    sk, sw = rs.sort_pairs_rangesweep(k, w, seg_elems=L)
    assert torch.equal(sw, w[want.indices])
    assert relocate.relocate.launches == before + 1 + 2 + 3 + 4


def test_public_auto_route_on_card(cuda):
    """The public entry points route through rangesweep and the kernel on
    the card once a row sends their size there."""
    n = 300_000
    config.set_routing_override(config.RoutingParameters(
        rangesweep_min=1 << 16, rangesweep_min_pairs=1 << 16,
        rangesweep_min_pairs_wide=1 << 16, rangesweep_min_index=1 << 16,
        rangesweep_seg_elems=1 << 12, rangesweep_seg_elems_pairs=1 << 12,
        rangesweep_seg_elems_pairs_wide=1 << 12,
        rangesweep_seg_elems_index=1 << 12))
    try:
        keys = prng.make_test_keys(n, 9, torch.float32,
                                   gstt.EntropyPreset.E054, device=cuda)
        before = relocate.relocate.launches
        for order in (gstt.Order.ASCENDING, gstt.Order.DESCENDING):
            got = gstt.sort(keys, order=order)
            want = gstt.sort(keys, order=order, backend=gstt.Backend.XLA)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
            perm = gstt.argsort(keys, order=order)
            assert torch.equal(perm, gstt.argsort(
                keys, order=order, backend=gstt.Backend.XLA))
        assert relocate.relocate.launches == before + 2 * (1 + 2)
    finally:
        config.clear_routing_override()


def test_flagship_row_routes_rangesweep(cuda):
    """The card's measured row routes the flagship size: the flat sort
    beat rangesweep at 2^28 and 2^29 in every mode, so AUTO never takes
    rangesweep there (it runs only under an override); keys-only sorts
    take the 8-bit-digit radix sort, and so do pairs with a 32-bit
    payload."""
    info = config.get_device_info(cuda)
    if info.generation != "h100":
        pytest.skip(f"no routing row for {info.device_kind}")
    assert config.get_routing_parameters(info).measured is True
    assert config.auto_engine(1 << 28, info=info) == "radix256"
    assert config.auto_engine((1 << 28) - 1, info=info) == "radix256"
    assert config.auto_engine(1 << 28, config.Mode.PAIRS, payload_bits=32,
                              info=info) == "radix256"


# ---- the radix kernels (Upsweep, scan, downsweep) and the PALLAS engines ----


def _radix_codes(kind, n, seed, dev):
    rng = np.random.default_rng(seed)
    if kind == "distinct16":
        x = rng.integers(0, 16, n, dtype=np.uint32) * np.uint32(0x11111111)
    elif kind == "alleq":
        x = np.full(n, 0xF00DCAFE, np.uint32)
    else:
        x = rng.integers(0, 2**32, n, dtype=np.uint32)
    return codec.bias(torch.from_numpy(x)).to(dev)


@pytest.mark.parametrize("tile_rows", [1, 3, 32, 129])
@pytest.mark.parametrize("kind", ["rand", "distinct16", "alleq"])
def test_tile_histogram4_kernel_matches_plain(cuda, kind, tile_rows):
    rows = tile_rows * 5
    x = _radix_codes(kind, rows * 128, tile_rows, cuda).view(rows, 128)
    before = kernels.tile_histogram4.launches
    for shift in range(0, 32, 4):
        got = kernels.tile_histogram4(x, shift, tile_rows)
        torch.cuda.synchronize()
        assert torch.equal(got, kernels.tile_histogram4_plain(x, shift,
                                                              tile_rows))
    assert kernels.tile_histogram4.launches == before + 8


@pytest.mark.parametrize("n", [1, 2047, 2048, 2049, 16 * 4097, 1 << 20,
                               (1 << 24) + 3])
def test_exclusive_scan_kernel_matches_plain(cuda, n):
    g = torch.Generator().manual_seed(n)
    x = torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                      generator=g).to(cuda)
    before = kernels.exclusive_scan.launches
    got = kernels.exclusive_scan(x)
    torch.cuda.synchronize()
    assert torch.equal(got, kernels.exclusive_scan_plain(x))
    # one chained-scan launch a call
    assert kernels.exclusive_scan.launches == before + 1
    small = (x & 15).contiguous()            # no wrap: equals cumsum
    assert torch.equal(kernels.exclusive_scan(small).long(),
                       torch.cumsum(small.long(), 0) - small.long())


def test_exclusive_scan_scratch_resets_between_calls(cuda):
    """Back-to-back scans on one stream, with no synchronisation between
    them, each reading the status words the one before left; a scan on a
    second stream; and the epoch's wrap, which zeroes the scratch."""
    g = torch.Generator().manual_seed(5)
    xs = [torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                        generator=g).to(cuda)
          for n in (1 << 20, 5000, 1 << 20, 2049, 1 << 22)]
    before = kernels.exclusive_scan.launches
    got = [kernels.exclusive_scan(x) for x in xs]
    torch.cuda.synchronize()
    assert kernels.exclusive_scan.launches == before + len(xs)
    for x, y in zip(xs, got):
        assert torch.equal(y, kernels.exclusive_scan_plain(x))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = [kernels.exclusive_scan(x) for x in xs[:2]]
    main = [kernels.exclusive_scan(x) for x in xs[:2]]
    torch.cuda.synchronize()
    for x, a, b in zip(xs, on_side, main):
        assert torch.equal(a, kernels.exclusive_scan_plain(x))
        assert torch.equal(b, a)
    key = (xs[0].device.index, torch.cuda.current_stream().cuda_stream)
    kernels._SCAN_SCRATCH[key][1] = kernels._SCAN_EPOCHS
    for x in xs[:3]:
        assert torch.equal(kernels.exclusive_scan(x),
                           kernels.exclusive_scan_plain(x))
    assert kernels._SCAN_SCRATCH[key][1] == 3


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 3 * 4096 + 200])
@pytest.mark.parametrize("kind", ["rand", "distinct16", "alleq"])
def test_downsweep_kernel_matches_plain(cuda, kind, n):
    tile_rows = 32
    codes = _radix_codes(kind, n, n, cuda)
    ride = torch.arange(n, dtype=torch.int32, device=cuda)
    planes, _ = rts.pad_tiles((codes, ride, ride * 7), tile_rows)
    for shift in (0, 12, 28):
        counts = kernels.tile_histogram4_plain(planes[0], shift, tile_rows)
        table = kernels.exclusive_scan_plain(counts.T.reshape(-1))
        for ops in (planes[:1], planes):
            before = rts.downsweep.launches
            got = rts.downsweep(ops, table, shift, tile_rows)
            torch.cuda.synchronize()
            assert rts.downsweep.launches == before + 1
            want = rts.downsweep_plain(ops, table, shift, tile_rows)
            for g, w in zip(got, want):
                assert torch.equal(g, w)


def test_radix_wrappers_check_on_card(cuda):
    x = torch.zeros((64, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        kernels.tile_histogram4(x.float(), 0, 32)
    with pytest.raises(ValueError, match="whole tiles"):
        kernels.tile_histogram4(x, 0, 48)
    with pytest.raises(ValueError, match="shift"):
        kernels.tile_histogram4(x, 32, 32)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.exclusive_scan(x.reshape(-1)[::2])
    table = torch.zeros(32, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shape"):
        rts.downsweep([x], table[:-1], 0, 32)
    with pytest.raises(ValueError, match="planes"):
        rts.downsweep([x] * 4, table, 0, 32)
    with pytest.raises(ValueError, match="on cpu"):
        rts.downsweep([x, x.cpu()], table, 0, 32)


@pytest.mark.parametrize("n", [1, 4097, 300_001])
def test_radix_engines_match_torch_sort(cuda, n):
    k = codec.encode_biased(prng.hybrid_taus_bits(n, n, 3, device=cuda))
    v = prng.hybrid_taus_bits(n, n + 1, device=cuda).view(torch.int32)
    want = torch.sort(k, stable=True)
    counts = (kernels.tile_histogram4.launches,
              kernels.exclusive_scan.launches, rts.downsweep.launches)
    assert torch.equal(rts.sort_codes_rts(k), want.values)
    sk, sv = rts.sort_pairs_rts(k, v)
    assert torch.equal(sk, want.values)
    assert torch.equal(sv, v[want.indices])
    sk, sv, sw = rts._sort_rts((k, v, v ^ 0x5A5A5A5A), tile_rows=7)
    assert torch.equal(sw, (v ^ 0x5A5A5A5A)[want.indices])
    assert torch.equal(ffx.sort_codes_ffx(k), want.values)
    sk, sv = ffx.sort_pairs_ffx(k, v)
    assert torch.equal(sv, v[want.indices])
    torch.cuda.synchronize()
    # five sorts of 8 passes: 8 Upsweeps, 8 one-launch scans, 8 downsweeps
    assert (kernels.tile_histogram4.launches - counts[0],
            kernels.exclusive_scan.launches - counts[1],
            rts.downsweep.launches - counts[2]) == (40, 40, 40)


def test_public_pallas_route_on_card(cuda):
    n = 300_000
    keys = prng.make_test_keys(n, 9, torch.float32, gstt.EntropyPreset.E054,
                               device=cuda)
    vals = prng.hybrid_taus_bits(n, 10, device=cuda).view(torch.int32)
    wide = codec.join_wide(vals, vals ^ 0x0F0F0F0F)
    for variant in radix.PORTED:
        kw = {"backend": gstt.Backend.PALLAS, "variant": variant}
        for order in (gstt.Order.ASCENDING, gstt.Order.DESCENDING):
            got = gstt.sort(keys, order=order, **kw)
            want = gstt.sort(keys, order=order, backend=gstt.Backend.XLA)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
            assert torch.equal(gstt.argsort(keys, order=order, **kw),
                               gstt.argsort(keys, order=order,
                                            backend=gstt.Backend.XLA))
            for v in (vals, wide):
                gk, gv = gstt.sort_pairs(keys, v, order=order, **kw)
                wk, wv = gstt.sort_pairs(keys, v, order=order,
                                         backend=gstt.Backend.XLA)
                assert torch.equal(gv, wv)
    for cls in (gstt.DeviceRadixSort, gstt.OneSweep, gstt.ForwardSweep,
                gstt.EmulatedDeadlocking):
        s = cls(gstt.SortConfig(backend=gstt.Backend.PALLAS))
        assert s.device.type == "cuda"
        assert s.validate_against_oracle(100_003, 5)
    # the last two variants (they raised NotImplementedError until they
    # were ported) reach their own kernels: splitsweep its digit-plane
    # binning pass and compact, mergesweep (in 2^15-key segments) its tail
    counts = (radix16.binning_pass.launches, stitch.compact_ops.launches,
              mergesweep.merge_tail.launches)
    gstt.sort(keys, backend=gstt.Backend.PALLAS, variant="splitsweep")
    config.set_routing_override(config.RoutingParameters(
        mergesweep_seg_elems=1 << 15))
    try:
        got = gstt.sort(keys, backend=gstt.Backend.PALLAS,
                        variant="mergesweep")
    finally:
        config.clear_routing_override()
    assert torch.equal(got.view(torch.int32), gstt.sort(
        keys, backend=gstt.Backend.XLA).view(torch.int32))
    torch.cuda.synchronize()
    assert (radix16.binning_pass.launches - counts[0],
            stitch.compact_ops.launches - counts[1],
            mergesweep.merge_tail.launches - counts[2]) == (1, 1, 4)


@pytest.mark.parametrize("variant", radix.PORTED)
def test_public_pallas_offset_views_on_card(cuda, variant):
    """Key and payload slices at odd offsets, a whole number of tiles long,
    sort like any other input (the planes are copied to 16-byte aligned
    storage before a kernel sees them)."""
    n = 1 << 15                           # whole tiles for both engines
    big = prng.hybrid_taus_bits(n + 3, 11, device=cuda).view(torch.int32)
    keys, vals = big[1:n + 1], big.flip(0)[3:]
    assert keys.data_ptr() % 16 and vals.data_ptr() % 16
    want = torch.sort(keys, stable=True)
    kw = {"backend": gstt.Backend.PALLAS, "variant": variant,
          "tile_rows": 8}
    assert torch.equal(gstt.sort(keys, **kw), want.values)
    sk, sv = gstt.sort_pairs(keys, vals, **kw)
    assert torch.equal(sk, want.values)
    assert torch.equal(sv, vals[want.indices])
    assert torch.equal(gstt.argsort(keys, **kw), want.indices.int())


def test_h100_tuning_row(cuda):
    info = config.get_device_info(cuda)
    if info.generation != "h100":
        pytest.skip(f"no tuning row for {info.device_kind}")
    row = config.get_tuning_parameters(info)
    assert row.radix_tile_rows == 128 and row.measured is True
    assert rts.default_tile_rows(cuda) == 128
    assert rts.default_tile_rows(cuda, pairs=True) == 256
    assert [bitonic.network_tile_rows(cuda, k) for k in (1, 2, 3, 4)] == [
        256, 128, 128, 64]


# ---- the radix16 kernels (global histogram, binning pass) and the network --

# n = 1, 127, one 32-row tile, and more than 1000 tiles (a long lookback)
_RADIX16_N = [1, 127, 32 * 128, 1100 * 32 * 128 + 77]


@pytest.mark.parametrize("n", _RADIX16_N + [(1 << 22) + 3])
@pytest.mark.parametrize("kind", ["rand", "distinct16", "alleq"])
def test_global_histogram_kernel_matches_plain(cuda, kind, n):
    x = _radix_codes(kind, n, n, cuda)
    before = kernels.global_histogram.launches
    for passes in (1, 4):
        got = kernels.global_histogram(x, passes)
        torch.cuda.synchronize()
        assert got.shape == (passes, 256)
        assert torch.equal(got, kernels.global_histogram_plain(x, passes))
    assert kernels.global_histogram.launches == before + 2
    assert int(got.sum()) == 4 * n


@pytest.mark.parametrize("n", _RADIX16_N)
@pytest.mark.parametrize("kind", ["rand", "distinct16", "alleq"])
def test_binning_kernel_matches_plain(cuda, kind, n):
    tile_rows = 32
    codes = _radix_codes(kind, n, n + 1, cuda)
    ride = torch.arange(n, dtype=torch.int32, device=cuda)
    planes, _ = rts.pad_tiles((codes, ride, ride * 7), tile_rows)
    bases, _ = radix16._bases_all_passes(planes[0].reshape(-1))
    T = planes[0].shape[0] // tile_rows
    for p in (0, 3, 7):
        shift = 4 * p
        for ops in (planes[:1], planes):
            before = radix16.binning_pass.launches
            got, cur = radix16.binning_pass(ops, bases[p], shift, tile_rows)
            torch.cuda.synchronize()
            assert radix16.binning_pass.launches == before + 1
            want, wcur = radix16.binning_pass_plain(ops, bases[p], shift,
                                                    tile_rows)
            assert torch.equal(cur, wcur)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            # the same pass cut after tile 0 and before the last tile
            out, c = [torch.empty_like(x) for x in ops], bases[p]
            bounds = sorted({0, 1, max(T - 1, 0), T})
            for a, b in zip(bounds[:-1], bounds[1:]):
                _, c = radix16.binning_pass(
                    [x[a * tile_rows:b * tile_rows] for x in ops], c, shift,
                    tile_rows, out)
            torch.cuda.synchronize()
            assert torch.equal(c, wcur)
            for g, w in zip(out, want):
                assert torch.equal(g, w)


@pytest.mark.parametrize("tile_rows,tiles", [(1, 4099), (3, 1367), (32, 9),
                                             (512, 3)])
@pytest.mark.parametrize("kind", ["rand", "alleq", "twodigit"])
def test_binning_kernel_partitions_match_plain(cuda, kind, tile_rows, tiles):
    """The kernel cuts a range into its own partitions, whatever the tile:
    ranges that end in a ragged partition, all-equal and two-digit keys
    (ties on every item of a warp), fused and as the adversarial_segments
    chain, whose launches start mid-array from cursors that are not
    bases."""
    rows = tile_rows * tiles
    n = rows * 128
    if kind == "twodigit":      # u32 0 and 0xFFFFFFFF: digits 0 and 15
        bits = np.random.default_rng(tiles).integers(0, 2, n, np.uint32)
        codes = codec.bias(torch.from_numpy(bits * np.uint32(0xFFFFFFFF))
                           ).to(cuda)
    else:
        codes = _radix_codes(kind, n, tiles, cuda)
    ride = torch.arange(n, dtype=torch.int32, device=cuda)
    planes = [codes.view(rows, 128), ride.view(rows, 128),
              (ride * 7).view(rows, 128)]
    bases, _ = radix16._bases_all_passes(codes)
    segs = radix16.adversarial_segments(n, tile_rows)
    bounds = sorted({0, tiles} | set(segs))
    for p in (0, 7):
        for ops in (planes[:1], planes[:2], planes):
            want, wcur = radix16.binning_pass_plain(ops, bases[p], 4 * p,
                                                    tile_rows)
            got, cur = radix16.binning_pass(ops, bases[p], 4 * p, tile_rows)
            before = radix16.binning_pass.launches
            out, c = [torch.empty_like(x) for x in ops], bases[p]
            for a, b in zip(bounds[:-1], bounds[1:]):
                _, c = radix16.binning_pass(
                    [x[a * tile_rows:b * tile_rows] for x in ops], c, 4 * p,
                    tile_rows, out)
            torch.cuda.synchronize()
            assert radix16.binning_pass.launches == before + len(bounds) - 1
            assert torch.equal(cur, wcur) and torch.equal(c, wcur)
            for g, o, w in zip(got, out, want):
                assert torch.equal(g, w) and torch.equal(o, w)


def test_binning_status_words_across_calls_and_streams(cuda):
    """Passes back to back on one stream with no synchronisation, each on
    the status words the one before left (and those of exclusive_scan,
    which shares the scratch), passes on a second stream, and the epoch's
    wrap, which zeroes the scratch."""
    n = (1 << 20) + 3 * 128        # 8195 rows, tiles of 5
    codes = _radix_codes("rand", n, 3, cuda)
    x = codes.view(-1, 128)
    bases, _ = radix16._bases_all_passes(codes)
    want = [radix16.binning_pass_plain([x], bases[p], 4 * p, 5)
            for p in range(8)]
    got = []
    for p in range(8):
        got.append(radix16.binning_pass([x], bases[p], 4 * p, 5))
        kernels.exclusive_scan(codes)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = [radix16.binning_pass([x], bases[p], 4 * p, 5)
                   for p in range(8)]
    torch.cuda.synchronize()
    for (go, gc), (so, sc), (wo, wc) in zip(got, on_side, want):
        assert torch.equal(gc, wc) and torch.equal(sc, wc)
        assert torch.equal(go[0], wo[0]) and torch.equal(so[0], wo[0])
    key = (x.device.index, torch.cuda.current_stream().cuda_stream)
    kernels._SCAN_SCRATCH[key][1] = kernels._SCAN_EPOCHS
    for p in (0, 7):
        go, gc = radix16.binning_pass([x], bases[p], 4 * p, 5)
        assert torch.equal(go[0], want[p][0][0]) and torch.equal(
            gc, want[p][1])
    assert kernels._SCAN_SCRATCH[key][1] == 2


@pytest.mark.parametrize("tile_rows,tiles", [(1, 1), (8, 1100), (None, 4)])
@pytest.mark.parametrize("num_ops,num_keys",
                         [(1, 1), (4, 2), (2, 1), (2, 2), (3, 2)])
def test_local_stages_kernel_matches_plain(cuda, tile_rows, tiles, num_ops,
                                           num_keys):
    if tile_rows is None:     # the largest tile of an H100's 227 KB budget
        tile_rows = config.TuningParameters(
            1, network_smem_bytes=232448).network_tile_rows(num_ops)
    tile_elems = tile_rows * 128
    rows = tile_rows * tiles
    g = torch.Generator().manual_seed(rows + num_ops)
    planes = [torch.randint(-8, 8, (rows, 128), dtype=torch.int32,
                            generator=g).to(cuda)]
    planes += [torch.arange(rows * 128, dtype=torch.int32,
                            device=cuda).view(rows, 128) * (q + 1)
               for q in range(num_ops - 1)]
    scheds = [bitonic.in_tile_schedule(tile_elems)]
    if tiles > 1:
        scheds.append(bitonic.tail_schedule(tile_elems, 4 * tile_elems))
    for sched in scheds:
        before = bitonic.local_stages.launches
        got = bitonic.local_stages(planes, sched, num_keys, tile_rows)
        torch.cuda.synchronize()
        assert bitonic.local_stages.launches == before + 1
        want = bitonic.local_stages_plain(planes, sched, num_keys, tile_rows)
        for g_, w in zip(got, want):
            assert torch.equal(g_, w)


@pytest.mark.parametrize("num_ops,num_keys", [(1, 1), (2, 2), (3, 2), (4, 2)])
def test_global_stage_kernel_matches_plain(cuda, num_ops, num_keys):
    tile_rows, rows = 8, 1 << 13               # N = 2^20, 1024 tiles
    n = rows * 128
    g = torch.Generator().manual_seed(num_ops)
    planes = [torch.randint(-2**31, 2**31 - 1, (rows, 128),
                            dtype=torch.int32, generator=g).to(cuda)
              for _ in range(num_ops)]
    for j, k in ((1024, 2048), (1 << 15, 1 << 17), (n // 2, n)):
        want = bitonic.global_stage_plain([p.clone() for p in planes], j, k,
                                          num_keys, tile_rows)
        before = bitonic.global_stage.launches
        got = bitonic.global_stage(planes, j, k, num_keys, tile_rows)
        torch.cuda.synchronize()
        assert bitonic.global_stage.launches == before + 1
        assert got is planes                      # in place
        for g_, w in zip(got, want):
            assert torch.equal(g_, w)


def test_new_wrappers_check_and_refused_launch_raises(cuda):
    x = torch.zeros((512, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="1-D"):
        kernels.global_histogram(x)
    with pytest.raises(ValueError, match="passes"):
        kernels.global_histogram(x.view(-1), 5)
    with pytest.raises(ValueError, match="cursors"):
        radix16.binning_pass([x], torch.zeros(15, dtype=torch.int32,
                                              device=cuda), 0, 32)
    with pytest.raises(ValueError, match="whole tiles"):
        radix16.binning_pass([x], torch.zeros(16, dtype=torch.int32,
                                              device=cuda), 0, 48)
    with pytest.raises(ValueError, match="stage"):
        bitonic.local_stages([x], bitonic.in_tile_schedule(2048), 1, 8)
    with pytest.raises(ValueError, match="stage"):
        bitonic.global_stage([x], 512, 1024, 1, 8)
    # 512 rows of one plane need 256 KB of shared memory, more than a block
    # may have: the launch is refused and the wrapper raises
    before = bitonic.local_stages.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        bitonic.local_stages([x], bitonic.in_tile_schedule(512 * 128), 1,
                             512)
    assert bitonic.local_stages.launches == before


@pytest.mark.parametrize("n", [1, 4097, 300_001])
def test_network_and_radix16_engines_match_torch_sort(cuda, n):
    k = codec.encode_biased(prng.hybrid_taus_bits(n, n, 3, device=cuda))
    v = prng.hybrid_taus_bits(n, n + 1, device=cuda).view(torch.int32)
    w = v ^ 0x5A5A5A5A
    want = torch.sort(k, stable=True)
    fns = (kernels.global_histogram, radix16.binning_pass,
           bitonic.local_stages, mergesweep.hyper_stage,
           bitonic.global_stage)
    counts = [f.launches for f in fns]
    assert torch.equal(bitonic.sort_codes(k), want.values)
    sk, sv, sw = bitonic.sort_codes_stable_with(k, v, w)
    assert torch.equal(sk, want.values)
    assert torch.equal(sv, v[want.indices]) and torch.equal(
        sw, w[want.indices])
    assert torch.equal(radix16.sort_codes_radix16(k), want.values)
    sk, sv = radix16.sort_pairs_radix16(k, v)
    assert torch.equal(sv, v[want.indices])
    segs = radix16.adversarial_segments(n, 8)
    sk, sv, sw = radix16._sort_radix16((k, v, w), 8, segments=segs)
    assert torch.equal(sk, want.values) and torch.equal(
        sw, w[want.indices])
    torch.cuda.synchronize()
    grew = [f.launches > c for f, c in zip(fns, counts)]
    # a network of at most one tile runs no hyper trip; above it the trips
    # take every high stride, so no global stage runs
    assert grew == [True, True, True, n > 1 << 13, False]


# ---- the stitch kernels (compact, expand) and the segmented sort ------------


def _stitch_mask(kind, n, dev):
    g = torch.Generator().manual_seed(n)
    if kind == "none":
        m = torch.zeros(n, dtype=torch.bool)
    elif kind == "all":
        m = torch.ones(n, dtype=torch.bool)
    elif kind == "half":
        m = torch.rand(n, generator=g) < 0.5
    elif kind == "sparse":
        m = torch.rand(n, generator=g) < 1 / 64
    else:   # segments: every other random segment, the last one ending at n
        rng = np.random.default_rng(n)
        lens = rng.integers(1, 300, n // 150 + 2)
        ends = np.minimum(np.cumsum(lens), n)
        starts = np.concatenate([[0], ends[:-1]])
        pick = (np.arange(len(lens)) % 2 == 1) & (starts < n)
        pick[np.nonzero(starts < n)[0][-1]] = True
        return splitsort._interval_mask(starts[pick], (ends - starts)[pick],
                                        n, dev)
    return m.to(dev)


_STITCH_N = [1, 127, 129, (1 << 20) + 3]
_MASKS = ["none", "all", "half", "sparse", "segments"]


@pytest.mark.parametrize("n", _STITCH_N)
@pytest.mark.parametrize("kind", _MASKS)
def test_stitch_kernels_match_plain(cuda, kind, n):
    mask = _stitch_mask(kind, n, cuda)
    g = torch.Generator().manual_seed(n + 1)
    planes = [torch.randint(-2**31, 2**31 - 1, (n,), dtype=torch.int32,
                            generator=g).to(cuda) for _ in range(3)]
    want_cnt = int(mask.sum())
    for ops in (planes[:1], planes[:2], planes):
        before = stitch.compact_ops.launches
        packed, cnt = stitch.compact_ops(ops, mask)
        torch.cuda.synchronize()
        assert stitch.compact_ops.launches == before + 1
        assert cnt.device == mask.device and cnt.dtype == torch.int32
        assert int(cnt) == want_cnt
        wpacked, _ = stitch.compact_plain(ops, mask)
        for p, w in zip(packed, wpacked):
            assert torch.equal(p[:want_cnt], w[:want_cnt])
        for length in (n, max(want_cnt - 5, 0)):
            srcs = [p[:length] for p in ops]
            before = stitch.expand_ops.launches
            got = stitch.expand_ops(srcs, mask)
            torch.cuda.synchronize()
            assert stitch.expand_ops.launches == before + 1
            for gt, w in zip(got, stitch.expand_plain(srcs, mask)):
                assert torch.equal(gt, w)


def test_stitch_checks_on_card(cuda):
    x = torch.zeros(256, dtype=torch.int32, device=cuda)
    m = torch.ones(256, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="mask on"):
        stitch.compact_ops((x.cpu(),), m)
    with pytest.raises(ValueError, match="contiguous"):
        stitch.expand_ops((x[::2],), m)
    with pytest.raises(TypeError, match="bool"):
        stitch.expand_ops((x,), m.to(torch.uint8))
    before = (stitch.compact_ops.launches, stitch.expand_ops.launches)
    packed, cnt = stitch.compact_ops((x[:0],), m[:0])     # nothing to launch
    assert int(cnt) == 0 and packed[0].numel() == 0
    assert (stitch.compact_ops.launches,
            stitch.expand_ops.launches) == before


def _check_stitch_call(ops, srcs, mask):
    """compact_ops on `ops` and expand_ops on `srcs` under `mask`, each one
    launch and bit-exact with its plain version."""
    before = (stitch.compact_ops.launches, stitch.expand_ops.launches)
    packed, cnt = stitch.compact_ops(ops, mask)
    got = stitch.expand_ops(srcs, mask)
    torch.cuda.synchronize()
    assert (stitch.compact_ops.launches - before[0],
            stitch.expand_ops.launches - before[1]) == (1, 1)
    wpacked, wcnt = stitch.compact_plain(ops, mask)
    count = int(wcnt)
    assert int(cnt) == count
    for p, w in zip(packed, wpacked):
        assert torch.equal(p[:count], w[:count])
    for gt, w in zip(got, stitch.expand_plain(srcs, mask)):
        assert torch.equal(gt, w)


@pytest.mark.parametrize("num_ops", [1, 2, 3, 4])
def test_stitch_kernels_odd_offsets_match_plain(cuda, num_ops):
    """Masks at byte offsets 1-15 and planes at element offsets 1-3, each
    plane misaligned by its own amount (the kernels read the aligned-down
    chunks and shift); plane 0 holds 4 values, so compact keeps ties in
    input order only if its ranks are stable; streams as long as the mask
    and shorter than the set count."""
    n = 70_001
    g = torch.Generator().manual_seed(num_ops)
    mbuf = (torch.rand(n + 16, generator=g) < 0.5).to(cuda)
    idx = torch.arange(n + 4, dtype=torch.int32)
    ties = torch.randint(0, 4, (n + 4,), generator=g, dtype=torch.int32)
    bufs = [b.to(cuda) for b in (ties, idx, -idx, ties * 7 + 1)[:num_ops]]
    for mo in range(1, 16):
        mask = mbuf[mo:mo + n]
        offs = [(mo + q) % 3 + 1 for q in range(num_ops)]
        ops = [b[o:o + n] for b, o in zip(bufs, offs)]
        count = int(mask.sum())
        for length in (n, count // 2):
            srcs = [b[4 - o:4 - o + length] for b, o in zip(bufs, offs)]
            _check_stitch_call(ops, srcs, mask)


@pytest.mark.parametrize("kind", ["half", "sparse", "segments"])
def test_stitch_kernels_many_tiles_match_plain(cuda, kind):
    """2^24 + 5 elements, thousands of tiles: every lookback crosses many
    32-word windows; 1 and 3 planes, a stream shorter than the set
    count."""
    assert _nvcc.load(stitch.SOURCE).gst_stitch_tile() == stitch.TILE
    n = (1 << 24) + 5
    mask = _stitch_mask(kind, n, cuda)
    planes = [prng.hybrid_taus_bits(n, 30 + q, device=cuda)
              .view(torch.int32) for q in range(3)]
    count = int(mask.sum())
    for ops in (planes[:1], planes):
        _check_stitch_call(ops, ops, mask)
        _check_stitch_call(ops, [p[:count - 1000] for p in ops], mask)


def test_stitch_status_words_across_calls_and_streams(cuda):
    """compact and expand interleaved with exclusive_scan and binning_pass
    on one stream with no synchronisation, each on the status words and
    ticket the one before left in the shared scratch; the same on a second
    stream; then the epoch's wrap, which zeroes the scratch."""
    n = (1 << 20) + 3 * 128
    codes = _radix_codes("rand", n, 5, cuda)
    x = codes.view(-1, 128)
    bases, _ = radix16._bases_all_passes(codes)
    masks = [_stitch_mask(k, n - 7 * j, cuda)
             for j, k in enumerate(("half", "sparse", "segments"))]
    ops = [codes, codes ^ 5]

    def chain():
        out = []
        for p, mask in enumerate(masks):
            m = mask.numel()
            out.append(stitch.compact_ops([o[:m] for o in ops], mask))
            out.append(kernels.exclusive_scan(codes[:m]))
            out.append(stitch.expand_ops([o[:m // 3] for o in ops], mask))
            out.append(radix16.binning_pass([x], bases[p], 4 * p, 5))
        return out

    def check(out):
        for p, mask in enumerate(masks):
            m = mask.numel()
            (packed, cnt), scan, exp, (bo, bc) = out[4 * p:4 * p + 4]
            wpacked, wcnt = stitch.compact_plain([o[:m] for o in ops], mask)
            c = int(wcnt)
            assert int(cnt) == c
            assert all(torch.equal(a[:c], b[:c])
                       for a, b in zip(packed, wpacked))
            assert torch.equal(scan, kernels.exclusive_scan_plain(codes[:m]))
            assert all(torch.equal(a, b) for a, b in zip(
                exp, stitch.expand_plain([o[:m // 3] for o in ops], mask)))
            wo, wc = radix16.binning_pass_plain([x], bases[p], 4 * p, 5)
            assert torch.equal(bo[0], wo[0]) and torch.equal(bc, wc)

    before = (stitch.compact_ops.launches, stitch.expand_ops.launches)
    got = chain()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = chain()
    torch.cuda.synchronize()
    assert (stitch.compact_ops.launches - before[0],
            stitch.expand_ops.launches - before[1]) == (6, 6)
    check(got)
    check(on_side)
    key = (codes.device.index, torch.cuda.current_stream().cuda_stream)
    kernels._SCAN_SCRATCH[key][1] = kernels._SCAN_EPOCHS
    check(chain())
    assert kernels._SCAN_SCRATCH[key][1] == 12


def _segsort_case(lens, seed, dev):
    lens = np.asarray(lens, np.int64)
    offs = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)[:-1]])).to(
        torch.int32).to(dev)
    total = int(lens.sum())
    keys = prng.make_test_keys(total, seed, torch.uint32,
                               gstt.EntropyPreset.E054, device=dev)
    return offs, len(lens), total, keys


@pytest.fixture
def segsort_routes(cuda):
    """The split and multi-class routes, forced: the card's row sends
    every random-length layout to the tile route or the composite (its
    window caps and extraction share are 0), so these tests take the
    segmented fields of the JAX package's row (the dataclass defaults, the
    tile route off) by a routing override."""
    row = config.get_routing_parameters(config.get_device_info(cuda))
    jax_row = config.RoutingParameters()
    config.set_routing_override(dataclasses.replace(row, **{
        f: getattr(jax_row, f) for f in (
            "window_max_keys", "window_max_fused", "window_max_pairs",
            "segsort_bulk_max", "segsort_padded_max",
            "segsort_extract_max_frac", "segsort_tile_max")}))
    yield cuda
    config.clear_routing_override()


def _check_segsort(offs, S, total, keys, want_plan, calls):
    vals = keys.clone()                         # the stability oracle
    plan = gstt.make_segsort_plan(offs, total, S)
    assert want_plan in plan.window_plan(32, True)
    before = (stitch.compact_ops.launches, stitch.expand_ops.launches)
    gk, gv = gstt.split_sort_pairs(offs, keys, vals, S, total)
    torch.cuda.synchronize()
    assert (stitch.compact_ops.launches - before[0],
            stitch.expand_ops.launches - before[1]) == (calls, calls)
    wk, wv = flat_sort.segmented_sort_pairs(offs, keys, vals, total)
    assert torch.equal(gk.view(torch.int32), wk.view(torch.int32))
    assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))
    assert int(validate.count_segmented_violations(offs, gk)) == 0
    sk = gstt.split_sort_keys(offs, keys, S, plan=plan)
    assert torch.equal(sk.view(torch.int32), wk.view(torch.int32))


def test_segsort_split_on_card(segsort_routes):
    """A bimodal layout takes the length-class split: one compact and one
    expand per call, bit-exact with the composite oracle."""
    cuda = segsort_routes
    rng = np.random.default_rng(3)
    lens = list(rng.integers(1, 33, 60_000))
    for at in (0, 20_000, 59_999):
        lens.insert(at, 40_000)
    _check_segsort(*_segsort_case(lens, 3, cuda), "split", 1)


def test_segsort_classes_on_card(segsort_routes):
    """Bulk, one padded class and a tail: the multi-class plan, three
    compacts and three expands per call.  About 55% of the elements lie in
    segments of 1-32, 18% in 8193-16384 and 27% in one of 2^18, so no bin
    bound covers 75% (no split) and 45% is extracted."""
    cuda = segsort_routes
    rng = np.random.default_rng(4)
    lens = list(rng.integers(1, 33, 32_000))
    lens += [int(x) for x in rng.integers(8193, 16385, 14)]
    lens += [1 << 18]
    rng.shuffle(lens)
    offs, S, total, keys = _segsort_case(lens, 4, cuda)
    cp = gstt.make_segsort_plan(offs, total, S).window_plan(32, True)
    assert [c["B"] for c in cp["classes"]["padded"]] == [16384]
    assert cp["classes"]["tail"] is not None
    _check_segsort(offs, S, total, keys, "classes", 3)


# ---- mergesweep and splitsweep ------------------------------------------------


def _net_planes(num_ops, n, seed, dev):
    """Plane 0 with many ties, plane 1 distinct (so (0, 1) key tuples are
    distinct), the others random."""
    g = torch.Generator().manual_seed(seed)
    out = [torch.randint(-20, 20, (n,), generator=g, dtype=torch.int32),
           torch.randperm(n, generator=g).to(torch.int32)]
    out += [torch.randint(-2**31, 2**31 - 1, (n,), generator=g,
                          dtype=torch.int32) for _ in range(2)]
    return [p.view(-1, 128).to(dev) for p in out[:num_ops]]


@pytest.mark.parametrize("num_ops,num_keys", [(1, 1), (3, 2), (4, 2)])
def test_merge_kernels_match_plain(cuda, num_ops, num_keys):
    """merge_tail with k below, at twice and far above the tile, and
    hyper_stage as one trip and as the split trips of the pass's high
    strides, each against its plain version, in place."""
    n = 1 << 20
    tr = bitonic.network_tile_rows(cuda, num_ops)
    te = tr * 128
    planes = _net_planes(num_ops, n, num_ops, cuda)

    def same(fn, plain, *args):
        got = fn([p.clone() for p in planes], *args)
        want = plain([p.clone() for p in planes], *args)
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    before = (mergesweep.merge_tail.launches, mergesweep.hyper_stage.launches)
    for k in (te // 4, 2 * te, n):
        same(mergesweep.merge_tail, mergesweep.merge_tail_plain, k, tr,
             num_keys)
    # a 128-element budget (4 stages a trip) splits the 2^20 pass's high
    # strides into two trips
    trips = mergesweep.hyper_trips(n, te, 128)
    assert len(trips) == 2
    same(mergesweep.hyper_stage, mergesweep.hyper_stage_plain, n, n // 2, te,
         num_keys, min(te, te * te // n))
    for j_hi, j_lo, cols in trips:
        same(mergesweep.hyper_stage, mergesweep.hyper_stage_plain, n, j_hi,
             j_lo, num_keys, cols)
    # the split trips compose to the whole run of strides
    split = [p.clone() for p in planes]
    for j_hi, j_lo, cols in trips:
        mergesweep.hyper_stage(split, n, j_hi, j_lo, num_keys, cols)
    want = mergesweep.hyper_stage_plain([p.clone() for p in planes], n,
                                        n // 2, te, num_keys)
    for g, w in zip(split, want):
        assert torch.equal(g, w)
    torch.cuda.synchronize()
    assert (mergesweep.merge_tail.launches - before[0],
            mergesweep.hyper_stage.launches - before[1]) == (
        3, 1 + 2 * len(trips))


_ALL_KEYS = [(o, k) for o in (1, 2, 3, 4) for k in range(1, o + 1)]


@pytest.mark.parametrize("num_ops,num_keys", _ALL_KEYS)
def test_hyper_kernel_every_block_shape_matches_plain(cuda, num_ops,
                                                      num_keys):
    """hyper_stage against hyper_stage_plain at every group the kernel
    takes: W = 2 .. the most one block holds, every cols from one thread's
    slots to HYPER_MAX_THREADS threads (single-run trips in registers alone
    and trips with 1-3 shared-memory transposes), k = 2 j_hi (the groups
    alternate direction) and k = n; plane 0 tie-heavy with distinct riders
    (the tie rule) and all-equal."""
    n = 1 << 20
    items = mergesweep.HYPER_ITEMS[num_ops]
    most = 4 * items * mergesweep.HYPER_MAX_THREADS
    ties = _net_planes(num_ops, n, 40 + num_ops, cuda)
    equal = [torch.full_like(ties[0], 7)] + ties[1:]
    shapes = 0
    before = mergesweep.hyper_stage.launches
    for planes in (ties, equal):
        w = 2
        while 8 * w <= most:
            j_lo = n // (2 * w)
            j_hi = j_lo * w // 2
            cols = max(8, 4 * items // w)
            while cols <= min(j_lo, most // w):
                for k in (2 * j_hi, n):
                    got = mergesweep.hyper_stage([p.clone() for p in planes],
                                                 k, j_hi, j_lo, num_keys,
                                                 cols)
                    want = mergesweep.hyper_stage_plain(
                        [p.clone() for p in planes], k, j_hi, j_lo,
                        num_keys, cols)
                    for g, w_ in zip(got, want):
                        assert torch.equal(g, w_), (w, cols, k)
                    shapes += 1
                cols *= 2
            w *= 2
    torch.cuda.synchronize()
    assert mergesweep.hyper_stage.launches - before == shapes > 0


def test_hyper_kernel_limits_on_card(cuda):
    """A group outside one block's threads raises before any launch (the
    largest and smallest groups the wrapper lets through launch in
    test_hyper_kernel_every_block_shape_matches_plain)."""
    x = [torch.zeros((1 << 13, 128), dtype=torch.int32, device=cuda)]
    before = mergesweep.hyper_stage.launches
    with pytest.raises(ValueError, match="group of 32 elements"):
        mergesweep.hyper_stage(x, 1 << 16, 1 << 14, 1 << 14, 1, 16)
    with pytest.raises(ValueError, match="group of 65536 elements"):
        mergesweep.hyper_stage(x, 1 << 20, 1 << 15, 1 << 14, 1, 1 << 14)
    assert mergesweep.hyper_stage.launches == before


@pytest.mark.parametrize("hyper", [False, True], ids=["off", "on"])
def test_sort_network_hyper_trips_on_card(cuda, monkeypatch, hyper):
    """sort_network_i32 at 2^20 + 3 against torch.sort(stable=True), keys
    and a stable sort with two riders: with the switch on, each level above
    the tile runs its `level_trips` and no global stage; off, one global
    stage a stride and no trip."""
    monkeypatch.setattr(mergesweep, "_USE_HYPER", hyper)
    n = (1 << 20) + 3
    k = _codes("dup16", n, 7, cuda)
    v = prng.hybrid_taus_bits(n, 8, device=cuda).view(torch.int32)
    want = torch.sort(k, stable=True)
    want_calls = [0, 0]
    for num_ops in (1, 4):
        te = bitonic.network_tile_rows(cuda, num_ops) * 128
        for lk in range(te.bit_length(), 22):
            if hyper:
                want_calls[0] += len(mergesweep.level_trips(1 << lk, te,
                                                            num_ops))
            else:
                want_calls[1] += lk - te.bit_length() + 1
    before = (mergesweep.hyper_stage.launches, bitonic.global_stage.launches)
    assert torch.equal(bitonic.sort_codes(k), want.values)
    sk, sv, sw = bitonic.sort_codes_stable_with(k, v, v ^ 3)
    assert torch.equal(sk, want.values)
    assert torch.equal(sv, v[want.indices])
    assert torch.equal(sw, (v ^ 3)[want.indices])
    torch.cuda.synchronize()
    assert [mergesweep.hyper_stage.launches - before[0],
            bitonic.global_stage.launches - before[1]] == want_calls


def test_chained_kernels_refuse_graph_capture(cuda):
    """The four kernels on the chained scans' scratch raise under CUDA-graph
    capture (a replay would reuse the captured epoch); outside it they
    run."""
    x = torch.arange(1 << 16, dtype=torch.int32, device=cuda)
    planes = [x.view(-1, 128)]
    mask = (x & 1) == 0
    calls = {
        kernels.exclusive_scan: lambda: kernels.exclusive_scan(x),
        radix16.binning_pass: lambda: radix16.binning_pass(
            planes, torch.zeros(16, dtype=torch.int32, device=cuda), 0, 32),
        stitch.compact_ops: lambda: stitch.compact_ops((x,), mask),
        stitch.expand_ops: lambda: stitch.expand_ops((x,), mask),
    }
    for fn in calls.values():     # built and run once outside capture
        fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    for wrapper, fn in calls.items():
        before = wrapper.launches
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                with pytest.raises(RuntimeError, match="CUDA graph"):
                    fn()
            finally:
                graph.capture_end()
        assert wrapper.launches == before, wrapper.__name__
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()


@pytest.mark.parametrize("k_of_tile", [0.25, 2, 1024],
                         ids=["below", "twice", "far_above"])
@pytest.mark.parametrize("num_ops,num_keys", [(1, 1), (2, 1), (3, 2), (4, 2)])
def test_merge_tail_is_local_stages_on_card(cuda, num_ops, num_keys,
                                            k_of_tile):
    """merge_tail runs the network's in-tile kernel in place on the tail's
    schedule: equal to merge_tail_plain and to local_stages on
    bitonic.tail_schedule, counted in merge_tail.launches alone."""
    tr = bitonic.network_tile_rows(cuda, num_ops)
    te = tr * 128
    k = int(te * k_of_tile)
    n = max(1 << 20, k)
    planes = _net_planes(num_ops, n, num_ops + k, cuda)
    before = (mergesweep.merge_tail.launches, bitonic.local_stages.launches)
    got = mergesweep.merge_tail([p.clone() for p in planes], k, tr, num_keys)
    assert (mergesweep.merge_tail.launches - before[0],
            bitonic.local_stages.launches - before[1]) == (1, 0)
    want = mergesweep.merge_tail_plain([p.clone() for p in planes], k, tr,
                                       num_keys)
    net = bitonic.local_stages(planes, bitonic.tail_schedule(te, k),
                               num_keys, tr)
    torch.cuda.synchronize()
    for g, w, x in zip(got, want, net):
        assert torch.equal(g, w) and torch.equal(g, x)


@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("num_ops", [1, 2, 3])
def test_binning_digit_plane_matches_plain(cuda, num_ops, skew):
    """The digit-plane pass into 16 row-aligned regions (more output rows
    than input rows), uniform and skewed bucket planes, with cursors_out."""
    rows, tile_rows, cap_rows = 4096, 32, 400
    g = torch.Generator().manual_seed(num_ops)
    planes = [torch.randint(-2**31, 2**31 - 1, (rows, 128), generator=g,
                            dtype=torch.int32).to(cuda)
              for _ in range(num_ops)]
    if skew:       # about 7/8 of the elements in bucket 3
        r = torch.randint(0, 128, (rows, 128), generator=g)
        digits = torch.where(r < 112, 3, r % 16).to(torch.int32)
        cap_rows = 3700
    else:
        digits = torch.randint(0, 16, (rows, 128), generator=g,
                               dtype=torch.int32)
    digits = digits.to(cuda)
    bases = torch.arange(16, dtype=torch.int32, device=cuda) * (cap_rows * 128)

    def run(fn):
        out = [torch.zeros(16 * cap_rows, 128, dtype=torch.int32,
                           device=cuda) for _ in planes]
        return fn(planes, bases, 0, tile_rows, out, digits=digits)

    before = radix16.binning_pass.launches
    got, cur = run(radix16.binning_pass)
    want, wcur = run(radix16.binning_pass_plain)
    assert torch.equal(cur, wcur)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert radix16.binning_pass.launches - before == 1


@pytest.mark.parametrize("hyper", [False, True], ids=["off", "on"])
def test_mergesweep_engine_on_card(cuda, monkeypatch, hyper):
    monkeypatch.setattr(mergesweep, "_USE_HYPER", hyper)
    n = 3_000_001
    k = _codes("rand", n, 5, cuda)
    v = prng.hybrid_taus_bits(n, 6, device=cuda).view(torch.int32)
    want = torch.sort(k, stable=True)
    before = (bitonic.global_stage.launches, mergesweep.hyper_stage.launches,
              mergesweep.merge_tail.launches)
    assert torch.equal(mergesweep.sort_codes(k, seg_elems=1 << 16),
                       want.values)
    sk, sv, sw = mergesweep.sort_codes_stable_with(k & 0xFF00FF, v, v ^ 7,
                                                   seg_elems=1 << 16)
    w8 = torch.sort(k & 0xFF00FF, stable=True)
    assert torch.equal(sk, w8.values) and torch.equal(sv, v[w8.indices])
    assert torch.equal(sw, (v ^ 7)[w8.indices])
    torch.cuda.synchronize()
    g, h, t = (a - b for a, b in zip(
        (bitonic.global_stage.launches, mergesweep.hyper_stage.launches,
         mergesweep.merge_tail.launches), before))
    assert t == 12 and (h > 0, g > 0) == (hyper, not hyper)


def test_splitsweep_engine_and_fallback_on_card(cuda):
    n = 2_000_003
    k = _codes("dup16", n, 7, cuda) ^ _codes("rand", n, 8, cuda) & 0xFFF0
    v = prng.hybrid_taus_bits(n, 9, device=cuda).view(torch.int32)
    want = torch.sort(k, stable=True)
    before = (radix16.binning_pass.launches, stitch.compact_ops.launches)
    assert torch.equal(splitsweep.sort_codes_splitsweep(k), want.values)
    sk, sv, sw = splitsweep.sort_stable_with_splitsweep(k, v, v ^ 3)
    assert torch.equal(sk, want.values) and torch.equal(sv, v[want.indices])
    assert torch.equal(sw, (v ^ 3)[want.indices])
    torch.cuda.synchronize()
    assert (radix16.binning_pass.launches - before[0],
            stitch.compact_ops.launches - before[1]) == (2, 2)
    # slack 0.5 leaves each region half its share: the exact fallback
    before = radix16.binning_pass.launches
    assert torch.equal(splitsweep.sort_codes_splitsweep(k, slack=0.5),
                       want.values)
    sk, sv = splitsweep.sort_pairs_splitsweep(k, v, slack=0.5)
    assert torch.equal(sk, want.values) and torch.equal(sv, v[want.indices])
    assert radix16.binning_pass.launches == before


@pytest.mark.parametrize("rides", [0, 1, 2])
def test_splitsweep_kernels_at_their_shapes_match_plain(cuda, monkeypatch,
                                                        rides):
    """The digit-plane pass and the compact of one splitsweep call (1-3
    planes), recorded and answered by their plain versions, then each
    kernel held against its plain version on the same operands: compact
    over 16 * cap_rows * 128 slots with a prefix mask per region."""
    n = 1_000_003
    k = _codes("rand", n, 11, cuda)
    vs = [prng.hybrid_taus_bits(n, 12 + i, device=cuda).view(torch.int32)
          for i in range(rides)]
    calls = []

    def rec_binning(planes, cursors, shift, tile_rows, out=None,
                    digits=None):
        calls.append(("binning", (tuple(planes), cursors, shift, tile_rows,
                                  out[0].shape[0], digits)))
        return radix16.binning_pass_plain(planes, cursors, shift, tile_rows,
                                          out, digits)

    def rec_compact(planes, mask):
        calls.append(("compact", (tuple(planes), mask)))
        return stitch.compact_plain(tuple(planes), mask)

    real_binning, real_compact = radix16.binning_pass, stitch.compact_ops
    monkeypatch.setattr(radix16, "binning_pass", rec_binning)
    monkeypatch.setattr(stitch, "compact_ops", rec_compact)
    out = splitsweep.sort_stable_with_splitsweep(k, *vs)
    monkeypatch.undo()
    want = torch.sort(k, stable=True)
    assert torch.equal(out[0], want.values)
    assert [c for c, _ in calls] == ["binning", "compact"]

    (planes, cursors, shift, tile_rows, out_rows, digits) = calls[0][1]
    assert len(planes) == 1 + rides and out_rows > planes[0].shape[0]
    padded = planes[0].numel()

    def run(fn):
        o = [torch.zeros(out_rows, 128, dtype=torch.int32, device=cuda)
             for _ in planes]
        outs, cur = fn(list(planes), cursors, shift, tile_rows, o,
                       digits=digits)
        return list(outs) + [cur]
    for a, b in zip(run(real_binning), run(radix16.binning_pass_plain)):
        assert torch.equal(a, b)
    planes, mask = calls[1][1]
    (packed, cnt), (wpacked, wcnt) = (real_compact(planes, mask),
                                      stitch.compact_plain(planes, mask))
    assert int(cnt) == int(wcnt) == padded
    for a, b in zip(packed, wpacked):
        assert torch.equal(a[:padded], b[:padded])


# ---- the distributed sort: exchange masking and one NCCL rank -----------------


def _mask_case(d, num_ops, cap, seed, dev):
    """(planes, stacked, rc): num_ops (d, cap) planes as views of one
    (d, num_ops, cap) buffer (the ring's stacked layout), and counts of 0,
    partial, exactly cap and above cap (sender truncation)."""
    g = torch.Generator().manual_seed(seed)
    stacked = torch.randint(-2**31, 2**31 - 1, (d, num_ops, cap),
                            generator=g, dtype=torch.int32).to(dev)
    rc = torch.randint(0, cap, (d,), generator=g, dtype=torch.int32)
    rc[0] = 0
    if d > 1:
        rc[1], rc[2], rc[3] = cap, cap + 77, 1
    return stacked, rc.to(dev)


@pytest.mark.parametrize("d,cap", [(1, 128), (1, 5000), (8, 1 << 14),
                                   (8, 3 * 4096 + 129)])
@pytest.mark.parametrize("num_ops", [1, 2, 3])
def test_mask_arrivals_kernel_matches_plain(cuda, d, cap, num_ops):
    """Whole blocks, chunk windows and single sources, on separate and on
    stacked (row-strided) planes, each bit for bit against the plain
    version on the CPU."""
    stacked, rc = _mask_case(d, num_ops, cap, d * cap + num_ops, cuda)
    fills = (codec.SENTINEL, -1, 0)[:num_ops]
    cw = -(-cap // 3)
    windows = [(c0, min(cap, c0 + cw)) for c0 in range(0, cap, cw)]
    forms = [("whole", [(0, cap, None)]),
             ("chunks", [(a, b, None) for a, b in windows]),
             ("sources", [(0, cap, range(s, s + 1)) for s in range(d)])]
    for layout in ("separate", "stacked"):
        for form, calls in forms:
            if layout == "separate":
                got = [stacked[:, o].contiguous() for o in range(num_ops)]
            else:
                buf = stacked.clone()
                got = [buf[:, o] for o in range(num_ops)]
            want = [stacked[:, o].cpu().contiguous() for o in range(num_ops)]
            before = rx.mask_arrivals.launches
            for a, b, src in calls:
                rx.mask_arrivals([p[:, a:b] for p in got], rc, fills,
                                 col0=a, sources=src)
                rx.mask_arrivals_plain([p[:, a:b] for p in want], rc.cpu(),
                                       fills, col0=a, sources=src)
            torch.cuda.synchronize()
            assert rx.mask_arrivals.launches - before == len(calls)
            for g_, w in zip(got, want):
                assert torch.equal(g_.cpu(), w), (layout, form)


@pytest.mark.parametrize("width", [1, 3, 4095, 4097, (1 << 20) + 5])
@pytest.mark.parametrize("num_ops", [1, 2, 3, 4])
def test_mask_arrivals_tails_at_every_alignment(cuda, width, num_ops):
    """The kernel's scalar head, 16-byte body and scalar end: rows starting
    at every 4-byte offset mod 16 (an odd row pitch and a lead of 0-3
    int32s), col0 at every offset mod 4, counts at 0, below the window,
    inside the row, at its last slot, at its end and above the cell, on all
    8 sources, each single source and a middle range; one launch a call,
    bit for bit against the plain version on the same card tensors."""
    d = 8
    g = torch.Generator(device=cuda).manual_seed(width * 8 + num_ops)
    fills = (codec.SENTINEL, -1, 0, 7)[:num_ops]
    pitch = width + 7
    sources = [None, range(3, 6)] + [range(s, s + 1) for s in range(d)]
    for lead in range(4):
        base = [torch.randint(-2**31, 2**31 - 1, (d * pitch + 4,),
                              generator=g, device=cuda, dtype=torch.int32)
                for _ in range(num_ops)]

        def rows(bufs):
            return [b[lead:lead + d * pitch].view(d, pitch)[:, :width]
                    for b in bufs]

        for col0 in (0, 1001, 1002, 1003):
            rc = torch.tensor([0, max(col0 - 1, 0), col0 + width // 3,
                               col0 + width - 1, col0 + width,
                               col0 + width + 5, 2**31 - 1, col0 + 1],
                              dtype=torch.int32, device=cuda)
            for src in sources:
                got = [b.clone() for b in base]
                want = [b.clone() for b in base]
                before = rx.mask_arrivals.launches
                rx.mask_arrivals(rows(got), rc, fills, col0=col0,
                                 sources=src)
                assert rx.mask_arrivals.launches - before == 1
                rx.mask_arrivals_plain(rows(want), rc, fills, col0=col0,
                                       sources=src)
                for a, b in zip(got, want):
                    assert torch.equal(a, b), (lead, col0, src)


def test_native_refuses_card_tensors(cuda):
    """The host runtime copies nothing off the card: a CUDA tensor raises,
    in any argument."""
    from gpusorting_tpu_torch import native

    x = torch.zeros(16, dtype=torch.int32, device=cuda)
    host = torch.zeros(16, dtype=torch.int32)
    for call in (lambda: native.radix_sort(x),
                 lambda: native.radix_sort_pairs(host, x),
                 lambda: native.count_order_violations(x),
                 lambda: native.count_pair_violations(host, x),
                 lambda: native.count_segmented_violations(
                     host, torch.zeros(1, dtype=torch.int32, device=cuda))):
        with pytest.raises(ValueError, match="host"):
            call()


def test_mask_arrivals_checks_on_card(cuda):
    x = torch.zeros(4, 256, dtype=torch.int32, device=cuda)
    rc = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="planes\\[0\\] on"):
        rx.mask_arrivals([x.cpu()], rc, (0,))
    with pytest.raises(ValueError, match="unit stride"):
        rx.mask_arrivals([x[:, ::2]], rc, (0,))
    with pytest.raises(ValueError, match="sources"):
        rx.mask_arrivals([x], rc, (0,), sources=range(2, 6))
    before = rx.mask_arrivals.launches
    rx.mask_arrivals([x[:, :0]], rc, (0,))     # nothing to mask: no launch
    assert rx.mask_arrivals.launches == before


def _received_runs(d, chunks, cw, num_ops, rc, keys, seed, ring, dev):
    """What the exchange leaves a rank, on the card: per operand the
    (chunks, D, cw) blocks, or with `ring` the (D, cap) rows of a stacked
    (D, num_ops, cap) buffer (row stride num_ops * cap); run s sorted by
    (code, global index), its indices above source s - 1's, the slots past
    min(rc[s], cap) masked.  keys: "zipf" (Zipf(1.3) codes), "rand" (the
    whole u32 range), "one_key" (every code 1), "max_code" (Zipf, the last
    5 valid slots of each run the max code)."""
    rng = np.random.default_rng(seed)
    cap = chunks * cw
    codes = np.empty((d, cap), np.uint32)
    gidx = np.empty((d, cap), np.uint32)
    for s in range(d):
        if keys == "one_key":
            c = np.ones(cap, np.uint32)
        elif keys == "rand":
            c = rng.integers(0, 2**32, cap, dtype=np.uint32)
        else:
            c = np.minimum(rng.zipf(1.3, cap), 0xFFFFFFF).astype(np.uint32)
        if keys == "max_code":
            c[max(0, min(rc[s], cap) - 5):] = 0xFFFFFFFF
        g = (s * 2 * cap + rng.permutation(2 * cap)[:cap]).astype(np.uint32)
        order = np.lexsort((g, c))
        codes[s], gidx[s] = c[order], g[order]
    ops = [codec.bias(torch.from_numpy(codes)),
           torch.from_numpy(gidx.view(np.int32)),
           torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (d, cap)
                                         ).astype(np.int32))][:num_ops]
    rc_t = torch.tensor(rc, dtype=torch.int32)
    fills = (codec.SENTINEL, -1, 0)[:num_ops]
    rx.mask_arrivals_plain(ops, rc_t, fills)
    if ring:
        stacked = torch.stack(ops, dim=1).to(dev)
        planes = [stacked[:, o] for o in range(num_ops)]
    else:
        planes = [x.view(d, chunks, cw).transpose(0, 1).contiguous().to(dev)
                  for x in ops]
    return planes, rc_t.to(dev), fills


# (d, chunks, cw, num_ops, rc, keys, pad_to / (d * cap), ring)
_MERGE_CASES = {
    "chunks4_pairs_pad2": (4, 4, 1024, 3, [0, 3000, 4096, 5000], "zipf", 2,
                           False),
    "chunks4_keys_pad1": (4, 4, 1024, 2, [4096, 1, 4095, 4097], "zipf", 1,
                          False),
    "chunks1_pairs_max_code": (4, 1, 8192, 3, [8192, 6000, 0, 9000],
                               "max_code", 2, False),
    "chunks1_keys_max_code": (3, 1, 5000, 2, [7, 5000, 6000], "max_code", 1,
                              False),
    "ring_rows_pairs": (4, 1, 6144, 3, [6144, 0, 3333, 7000], "max_code", 2,
                        True),
    "ring_rows_keys": (2, 1, 640, 2, [640, 100], "rand", 1, True),
    "one_key_runs": (4, 4, 2048, 3, [8192, 8192, 7000, 9999], "one_key", 2,
                     False),
    "odd_chunk_width": (3, 3, 1000, 3, [2999, 1234, 3000], "rand", 2,
                        False),
    "one_source": (1, 4, 1024, 3, [3077], "zipf", 2, False),
    "all_empty": (4, 4, 256, 3, [0, 0, 0, 0], "zipf", 2, False),
    "d8_chunks4": (8, 4, 512, 3, [2048, 0, 1, 2047, 2048, 9999, 1024, 37],
                   "max_code", 1, False),
    "d4_cap_2^20": (4, 4, 1 << 18, 3, [(1 << 20) - 5, 1 << 20,
                                       (1 << 20) + 9, 700_000], "zipf", 2,
                    False),
    "d4_cap_2^20_rand": (4, 4, 1 << 18, 3, [1 << 19, 1 << 20, 3, 999_999],
                         "rand", 1, False),
    "d16_chunks4": (16, 4, 256, 3, [1024, 0, 1023, 1025, 1, 1024, 500, 0,
                                    1024, 7, 5000, 1024, 2, 333, 1024, 1000],
                    "max_code", 2, False),
    "d16_ring_rand": (16, 1, 768, 2, [(97 * s) % 900 for s in range(16)],
                      "rand", 1, True),
    "d32_chunks4": (32, 4, 128, 3, [(37 * s) % 600 for s in range(32)],
                    "zipf", 2, False),
    "d32_one_key": (32, 1, 512, 3, [512 - (s % 3) * 200 + (s % 5 == 4) * 99
                                    for s in range(32)], "one_key", 1,
                    False),
}


@pytest.mark.parametrize("name", list(_MERGE_CASES))
def test_merge_runs_kernel_matches_plain(cuda, name):
    """The distributed sort's merge kernel, two launches a call, bit for
    bit against its plain version (the wrapper on the CPU: `merge_plain`
    of the valid prefixes, then the fills) and the parent's merge of every
    slot then the padding, on every plane and the fills; D from 1 to 32,
    so every partition instantiation (R = 4, 8, 16, 32) runs."""
    d, chunks, cw, num_ops, rc, keys, pad, ring = _MERGE_CASES[name]
    planes, rc_t, fills = _received_runs(d, chunks, cw, num_ops, rc, keys,
                                         len(name), ring, cuda)
    cap = chunks * cw
    pad_to = pad * d * cap
    before = dist_merge.merge_runs.launches
    got = dist_merge.merge_runs(planes, rc_t, cap, pad_to, fills)
    torch.cuda.synchronize()
    assert dist_merge.merge_runs.launches - before == 2
    host = [p.cpu() for p in planes]
    plain = dist_merge.merge_runs(host, rc_t.cpu(), cap, pad_to, fills)
    parent = dist_merge.merge_plain([p.reshape(-1) for p in host])
    parent = [torch.cat([x, x.new_full((pad_to - x.shape[0],), f)])
              for x, f in zip(parent, fills)]
    for g, w, v in zip(got, plain, parent):
        assert g.shape == (pad_to,) and g.dtype == torch.int32
        g = g.cpu()
        assert torch.equal(g, w), name
        assert torch.equal(g, v), name


def test_merge_runs_checks_on_card(cuda):
    planes, rc, fills = _received_runs(4, 1, 256, 3, [1, 2, 3, 4], "zipf", 1,
                                       False, cuda)
    with pytest.raises(ValueError, match="planes\\[0\\] on"):
        dist_merge.merge_runs([planes[0].cpu()] + planes[1:], rc, 256, 1024,
                              fills)
    with pytest.raises(ValueError, match="unit stride"):
        dist_merge.merge_runs([p[:, :, ::2] for p in planes], rc, 128, 512,
                              fills)
    wide = torch.zeros(1, 33, 128, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="sources"):
        dist_merge.merge_runs([wide, wide], torch.zeros(33, dtype=torch.int32,
                                                        device=cuda), 128,
                              33 * 128, fills[:2])


@pytest.fixture
def nccl_rank(cuda, tmp_path):
    """A one-rank NCCL process group in this process."""
    import datetime

    import torch.distributed as dist

    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path / 'rendezvous'}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=60))
    yield cuda
    dist.destroy_process_group()


@pytest.mark.parametrize("exchange", ["collective", "remote_dma"])
def test_distributed_sort_one_rank_on_card(nccl_rank, exchange):
    """At one NCCL rank the distributed sort is the flat stable sort:
    keys, pairs, f32 keys with special values, all-equal pairs, max-code
    keys; the default ladder, and a fixed small cap that reports overflow
    and the gather's retry.  Each call merges through the kernel (two
    launches) inside one `dist.merge` span."""
    dev = nccl_rank
    n = 300_001
    u = prng.make_test_keys(n, 5, device=dev)
    f = prng.make_test_keys(n, 6, torch.float32, device=dev).clone()
    f[::97] = float("nan")
    f[1::97] = -0.0
    f[2::97] = float("inf")
    f[3::97] = -float("inf")
    maxc = u.clone()
    maxc.view(torch.int32)[::5] = -1
    vals = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)
    cases = [(u, None), (u, vals), (f, vals),
             (torch.full((n,), 42, dtype=torch.int32, device=dev), vals),
             (maxc, None)]
    for keys, values in cases:
        codes = codec.encode_biased(keys)
        want, perm = torch.sort(codes, stable=True)
        before = rx.mask_arrivals.launches
        merges, spans = dist_merge.merge_runs.launches, trace.counts()
        res = dist_sort.distributed_sort(keys, values, exchange=exchange)
        torch.cuda.synchronize()
        assert rx.mask_arrivals.launches - before == (
            1 if exchange == "remote_dma" else
            dist_sort._chunking(res["cap"], 4)[0])
        assert dist_merge.merge_runs.launches - merges == 2
        assert trace.counts()["dist.merge"] - spans.get("dist.merge", 0) == 1
        assert int(res["count"]) == n and int(res["overflow"]) == 0
        got = codec.bias(res["codes"])
        assert torch.equal(got[:n], want)
        assert bool((got[n:] == codec.SENTINEL).all())
        assert torch.equal(res["global_index"].view(torch.int32)[:n],
                           perm.to(torch.int32))
        if values is not None:
            pb = res["payload_bits"].view(torch.int32)
            assert torch.equal(pb[:n], values.view(torch.int32)[perm])
            assert bool((pb[n:] == 0).all())
    res = dist_sort.distributed_sort(u, cap_elems=4096, exchange=exchange)
    assert int(res["overflow"]) == n - 4096 and int(res["count"]) == 4096
    out, ovf = dist_sort.distributed_sort_gather(u, cap_elems=4096,
                                                 exchange=exchange)
    assert ovf == 0
    assert torch.equal(codec.encode_biased(out),
                       torch.sort(codec.encode_biased(u)).values)


# ---- the row form of the downsweep and its edge fixup (GST_MEGACORE=1) ----


def _sparse_codes(n, seed, dev):
    """Codes whose digit at shifts 0 and 28 is 5 for 1-3 keys in every 4096
    and 0 elsewhere: the small digit-5 ranges of neighbouring tiles share
    output rows, so three or more side entries name one row."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, n, dtype=np.uint32) & np.uint32(0x0FFFFFF0)
    for b in range(0, n, 4096):
        hits = rng.integers(b, min(b + 4096, n), rng.integers(1, 4))
        x[hits] |= np.uint32(0x50000005)
    return codec.bias(torch.from_numpy(x)).to(dev)


def _entries_per_row(rowtab):
    named = rowtab[rowtab >= 0].long()
    return int(torch.bincount(named).max()) if named.numel() else 0


def _dirty_then_free(ops, side_rows):
    """Fills buffers of the sizes `downsweep_rows` allocates (each output
    plane, then the side rows) with 0x5A5A5A5A and frees them, so that the
    wrapper's torch.empty calls get these bytes back; their addresses."""
    bufs = [torch.full_like(p, 0x5A5A5A5A) for p in ops]
    bufs.append(torch.full((side_rows, 128), 0x5A5A5A5A, dtype=torch.int32,
                           device=ops[0].device))
    ptrs = [b.data_ptr() for b in bufs]
    del bufs
    return ptrs


def _check_row_form(ops, table, counts, rowtab, shift, tile_rows):
    """downsweep_rows on dirty memory and edge_fixup (on its own side rows
    and on the plain version's) against their plain versions and the
    element form; one and two launches."""
    present = (rowtab.view(2, 16, -1) >= 0).permute(2, 1, 0)   # (T, 16, 2)
    before = (rts.downsweep_rows.launches, rts.edge_fixup.launches)
    dirty = _dirty_then_free(ops, counts.shape[0] * len(ops) * 32)
    outs, side = rts.downsweep_rows(ops, table, counts, shift, tile_rows)
    torch.cuda.synchronize()
    assert [o.data_ptr() for o in outs] == dirty[:len(ops)]
    want_outs, want_side = rts.downsweep_rows_plain(ops, table, counts,
                                                    shift, tile_rows)
    for g, w in zip(outs, want_outs):
        assert torch.equal(g, w)
    mask = present.unsqueeze(1).expand(-1, len(ops), -1, -1).reshape(-1)
    assert torch.equal(side[mask], want_side[mask])
    # the kernel's own side rows (absent ones unwritten) and the plain
    # version's, each fixed by the kernel
    element = rts.downsweep_plain(ops, table, shift, tile_rows)
    fixed = rts.edge_fixup(rowtab, table, side, outs)
    got = rts.edge_fixup(rowtab, table, want_side,
                         [o.clone() for o in want_outs])
    torch.cuda.synchronize()
    want = rts.edge_fixup_plain(rowtab, table, want_side,
                                [o.clone() for o in want_outs])
    for f, g, w, e in zip(fixed, got, want, element):
        assert torch.equal(g, w)
        assert torch.equal(f, e) and torch.equal(w, e)
    assert (rts.downsweep_rows.launches, rts.edge_fixup.launches) \
        == (before[0] + 1, before[1] + 2)


@pytest.mark.parametrize("tile_rows", [32, 128])
@pytest.mark.parametrize("kind", ["rand", "distinct16", "alleq", "sparse"])
def test_row_form_kernels_match_plain(cuda, kind, tile_rows):
    n = 5 * tile_rows * 128 - 333
    codes = (_sparse_codes(n, n, cuda) if kind == "sparse"
             else _radix_codes(kind, n, n, cuda))
    ride = torch.arange(n, dtype=torch.int32, device=cuda)
    planes, _ = rts.pad_tiles((codes, ride, ride * 7), tile_rows)
    for shift in (0, 28):
        counts = kernels.tile_histogram4_plain(planes[0], shift, tile_rows)
        table = kernels.exclusive_scan_plain(counts.T.reshape(-1))
        rowtab = rts.edge_rows(table, counts)
        if kind == "sparse":
            assert _entries_per_row(rowtab) >= 3
        for ops in (planes[:1], planes[:2], planes):
            _check_row_form(ops, table, counts, rowtab, shift, tile_rows)


@pytest.mark.parametrize("shift", [0, 28])
def test_row_form_walk_crosses_zero_count_ranges(cuda, shift):
    """One output row holds 40 one-key digit-0 ranges, then digit 1's: 3
    keys in tile 0, none in the next 38 tiles, 2 in the last; digit 2
    elsewhere.  The fixup's walk from that row's high entry crosses 38
    zero-count ranges, two ballot windows."""
    tile_rows, num_tiles = 32, 40
    n = num_tiles * tile_rows * 128
    x = np.full(n, 0x20000002, np.uint32)
    x[::tile_rows * 128] = 0
    x[[5, 6, 7, n - 3, n - 2]] = 0x10000001
    codes = codec.bias(torch.from_numpy(x)).to(cuda)
    ride = torch.arange(n, dtype=torch.int32, device=cuda)
    planes, _ = rts.pad_tiles((codes, ride, ride * 3), tile_rows)
    counts = kernels.tile_histogram4_plain(planes[0], shift, tile_rows)
    table = kernels.exclusive_scan_plain(counts.T.reshape(-1))
    rowtab = rts.edge_rows(table, counts)
    ranges = 16 * num_tiles
    cur, lo = table.tolist(), rowtab.tolist()
    zero = [k for k in range(1, ranges) if cur[k] < 128 and lo[k] < 0]
    assert int(rowtab[ranges]) == 0 and len(zero) >= 32
    for ops in (planes[:1], planes):
        _check_row_form(ops, table, counts, rowtab, shift, tile_rows)


def test_row_form_wrappers_check_on_card(cuda):
    x = torch.zeros((256, 128), dtype=torch.int32, device=cuda)
    counts = torch.zeros((2, 16), dtype=torch.int32, device=cuda)
    table = torch.zeros(32, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        rts.downsweep_rows([x.float()], table, counts, 0, 128)
    with pytest.raises(ValueError, match="counts shape"):
        rts.downsweep_rows([x], table, counts[:1], 0, 128)
    # one plane of 512 rows needs a (512 + 16)-row stage, 270,336 bytes
    x512 = torch.zeros((512, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        rts.downsweep_rows([x512] * 3, table[:16], counts[:1], 0, 512)
    with pytest.raises(ValueError, match="shared memory"):
        rts.downsweep_rows([x512], table[:16], counts[:1], 0, 512)
    rowtab = torch.full((64,), -1, dtype=torch.int32, device=cuda)
    side = torch.ones((2 * 2 * 32, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="side shape"):
        rts.edge_fixup(rowtab, table, side, [x])
    with pytest.raises(ValueError, match="on cpu"):
        rts.edge_fixup(rowtab, table, side, [x, x.cpu()])
    with pytest.raises(ValueError, match="table"):
        rts.edge_fixup(rowtab, table.cpu(), side[:64], [x])
    # every entry absent: nothing is read or written
    assert not rts.edge_fixup(rowtab, table, side[:64], [x])[0].any()


def test_row_form_sorts_on_card(cuda, monkeypatch):
    """GST_MEGACORE=1: the reduce-then-scan engine and its public route run
    the row form, 8 downsweep_rows and 8 edge_fixup launches a sort, and
    match flat torch.sort."""
    monkeypatch.setenv("GST_MEGACORE", "1")
    n = 300_001
    k = codec.encode_biased(prng.hybrid_taus_bits(n, n, 3, device=cuda))
    v = prng.hybrid_taus_bits(n, n + 1, device=cuda).view(torch.int32)
    want = torch.sort(k, stable=True)
    before = (rts.downsweep.launches, rts.downsweep_rows.launches,
              rts.edge_fixup.launches)
    assert torch.equal(rts.sort_codes_rts(k), want.values)
    sk, sv = rts.sort_pairs_rts(k, v)
    assert torch.equal(sk, want.values) and torch.equal(sv, v[want.indices])
    sk, sv, sw = rts._sort_rts((k, v, v ^ 0x5A5A5A5A), tile_rows=128)
    assert torch.equal(sw, (v ^ 0x5A5A5A5A)[want.indices])
    f = prng.make_test_keys(n, 11, torch.float32, device=cuda).clone()
    f[::97] = float("nan")
    f[1::97] = -0.0
    for order in (gstt.Order.ASCENDING, gstt.Order.DESCENDING):
        got = gstt.sort(f, order=order, backend=gstt.Backend.PALLAS,
                        variant="device_radix")
        flat = gstt.sort(f, order=order, backend=gstt.Backend.XLA)
        assert torch.equal(got.view(torch.int32), flat.view(torch.int32))
    torch.cuda.synchronize()
    assert (rts.downsweep.launches - before[0],
            rts.downsweep_rows.launches - before[1],
            rts.edge_fixup.launches - before[2]) == (0, 40, 40)


# ---- the tuner and the console driver ---------------------------------------


@pytest.mark.parametrize("which", ["tiles", "routing", "rangesweep"])
def test_autotune_on_card(cuda, which):
    """Each sweep at 2^20 on the card returns a measured row; installing
    it and clearing the overrides leaves the card's rows as they were."""
    from gpusorting_tpu_torch.utils import autotune

    info = config.get_device_info(cuda)
    rows = ([config.get_tuning_parameters(info, m) for m in config.Mode],
            config.get_routing_parameters(info))
    n = 1 << 20
    try:
        if which == "tiles":
            p, sweep = autotune.autotune(config.Mode.PAIRS, n=n,
                                         tiles=(16, 32), batch=1,
                                         install=True, engine="rts")
            assert set(sweep) == {16, 32} and p.radix_tile_rows in sweep
            assert config.get_tuning_parameters(info, config.Mode.PAIRS) == p
        elif which == "routing":
            p, sweep = autotune.autotune_routing(
                n=n, batch=1, window_candidates=(64, 4096), install=True)
            assert set(sweep["window_pairs"]) == {64, 4096}
            assert config.get_routing_parameters(info) == p
        else:
            p, sweep = autotune.autotune_rangesweep(
                n_max=n, batch=1, seg_candidates_keys=(1 << 18,),
                seg_candidates_pairs=(1 << 18,), install=True)
            assert set(sweep) == {"keys", "pairs"}
            assert config.get_routing_parameters(info) == p
        assert p.measured
        assert all(v > 0 for v in _rates(sweep))
    finally:
        config.clear_tuning_overrides()
        config.clear_routing_override()
    assert ([config.get_tuning_parameters(info, m) for m in config.Mode],
            config.get_routing_parameters(info)) == rows


def _rates(sweep):
    for v in sweep.values():
        if isinstance(v, dict):
            yield from _rates(v)
        else:
            yield v


def test_cli_bench_line_parses(cuda, capsys):
    from gpusorting_tpu_torch.__main__ import main

    assert main(["bench", "--n", "2^20", "--batch", "2"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["n"] == 1 << 20 and res["keys_per_sec"] > 0
    assert res["algorithm"] == "OneSweep" and "card" in res


def test_batch_timing_chains(cuda):
    """repeats chains of batch sorts: batch counts every sort timed, and
    the chains' spread brackets the mean of their means."""
    from gpusorting_tpu_torch.utils import timing

    res = timing.batch_timing(
        lambda k: gstt.sort(k, backend=gstt.Backend.XLA), 1 << 20,
        batch=2, repeats=3, device=cuda)
    assert res["batch"] == 6 and res["repeats"] == 3
    assert (res["spread_min_s"] <= res["seconds_per_sort"]
            <= res["spread_max_s"])
    assert res["keys_per_sec"] == (1 << 20) / res["seconds_per_sort"]


def test_is_native_on_the_card_row(cuda):
    """AUTO's 2^28 keys route on the card's measured row is the 8-bit-digit
    radix sort, whose kernels are hand-written."""
    info = config.get_device_info(cuda)
    if info.generation != "h100":
        pytest.skip(f"no measured row for {info.device_kind}")
    assert radix.is_native(info) is True
    assert radix.is_native() is True


# ---- the 8-bit-digit radix sort (ops/radix256.py, csrc/binning256.cu) ----

def _radix256_keys(kind, n, dtype, dev, seed=31):
    raw = prng.make_test_keys(n, seed, torch.uint32, device=dev).view(
        torch.int32)
    if kind == "all_equal":
        raw.fill_(0x1234ABCD)
    elif kind == "single_digit":        # one digit in passes 1-3
        raw.bitwise_and_(0xFF).bitwise_or_(0x5A3C1E00)
    if dtype == torch.float32:
        sp = torch.tensor([0x7FC00000, -0x3FFFFF, 0, -0x80000000,
                           0x7F800000, -0x800000, 0x7FFFFFFF, -1],
                          dtype=torch.int32, device=dev)
        pos = torch.arange(0, n, 997, device=dev)
        raw[pos] = sp[pos % sp.numel()]
    return raw.view(dtype)


@pytest.mark.parametrize("dtype", [torch.uint32, torch.int32, torch.float32])
@pytest.mark.parametrize("n", [1 << 28, 1 << 20, (1 << 20) + 3, 7681, 1])
def test_radix256_kernel_matches_plain(cuda, dtype, n):
    """The kernels against their plain version, bit for bit, 5 launches a
    sort."""
    from gpusorting_tpu_torch.ops import radix256

    x = _radix256_keys("uniform", n, dtype, cuda)
    before = radix256.sort.launches
    got = radix256.sort(x)
    torch.cuda.synchronize()
    assert radix256.sort.launches == before + 5
    want = radix256.sort_plain(x)
    assert got.dtype == dtype
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("kind", ["all_equal", "single_digit"])
@pytest.mark.parametrize("n", [1 << 26, (1 << 20) + 3])
def test_radix256_one_digit_passes(cuda, kind, n):
    """All-equal keys (one digit takes every key in every pass) and keys
    whose passes 1-3 see one digit: the 256-digit lookback's worst cases;
    also from an input 4 bytes past a 16-byte line."""
    from gpusorting_tpu_torch.ops import radix256

    x = _radix256_keys(kind, n, torch.uint32, cuda)
    buf = torch.empty(n + 1, dtype=torch.uint32, device=cuda)
    buf[1:].copy_(x)
    for keys in (x, buf[1:]):
        got = radix256.sort(keys)
        want = flat_sort.sort_keys(keys)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_radix256_refused_capture_leaves_its_stream_usable(cuda):
    """radix256.sort raises under CUDA-graph capture before it allocates
    the stream's counts buffer (a zero fill made under capture would only
    be recorded), so the first eager sort on that stream afterwards is
    still bit-exact."""
    from gpusorting_tpu_torch.ops import radix256

    x = _radix256_keys("uniform", (1 << 20) + 3, torch.uint32, cuda)
    want = flat_sort.sort_keys(x)
    radix256.sort(x)              # built and run once outside capture
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    key = (x.device.index, side.cuda_stream)
    radix256._COUNTS.pop(key, None)   # the stream's first radix256 call
    before = radix256.sort.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            with pytest.raises(RuntimeError, match="CUDA graph"):
                radix256.sort(x)
        finally:
            graph.capture_end()
    assert radix256.sort.launches == before
    assert key not in radix256._COUNTS
    with torch.cuda.stream(side):
        got = radix256.sort(x)
    side.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()


def test_radix256_route_reads_nothing_back(cuda):
    """AUTO's keys-only route on the card's row: one radix256 sort of 5
    launches and no readback (set_sync_debug_mode("error") raises on
    one), both orders equal to the flat sort."""
    from gpusorting_tpu_torch.ops import radix256
    from gpusorting_tpu_torch.utils import trace

    info = config.get_device_info(cuda)
    if info.generation != "h100":
        pytest.skip(f"no routing row for {info.device_kind}")
    n = 1 << 24
    assert config.auto_engine(n, info=info) == "radix256"
    x = _radix256_keys("uniform", n, torch.float32, cuda)
    for order in (gstt.Order.ASCENDING, gstt.Order.DESCENDING):
        before, spans = radix256.sort.launches, trace.counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = gstt.sort(x, order=order)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        after = trace.counts()
        assert radix256.sort.launches == before + 5
        assert after["engine.radix256"] == spans.get("engine.radix256",
                                                     0) + 1
        assert after.get("engine.flat", 0) == spans.get("engine.flat", 0)
        want = flat_sort.sort_keys(x, order=order)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---- radix256's pairs form and its epochs ----------------------------------

def _radix256_payload(n, dtype, dev):
    """n distinct 32-bit payload words, half of them NaN patterns as f32."""
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    return torch.where(idx % 2 == 1, idx | 0x7F800000, idx).view(dtype)


def _same(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


@pytest.mark.parametrize("vtype", [torch.uint32, torch.int32, torch.float32])
@pytest.mark.parametrize("dtype", [torch.uint32, torch.int32, torch.float32])
@pytest.mark.parametrize("n", [1 << 26, 1 << 20, (1 << 20) + 3, 8195, 7681,
                               1])
def test_radix256_pairs_kernel_matches_plain(cuda, dtype, vtype, n):
    """The pairs kernels against their plain version and against the flat
    route (torch.sort(stable=True), then the gather), bit for bit, 5
    launches a sort."""
    from gpusorting_tpu_torch.ops import radix256

    x = _radix256_keys("uniform", n, dtype, cuda)
    v = _radix256_payload(n, vtype, cuda)
    before = radix256.sort_pairs.launches
    gk, gv = radix256.sort_pairs(x, v)
    torch.cuda.synchronize()
    assert radix256.sort_pairs.launches == before + 5
    pk, pv = radix256.sort_pairs_plain(x, v)
    assert _same(gk, pk) and _same(gv, pv)
    fk, fv = flat_sort.sort_pairs(x, v)
    assert _same(gk, fk) and _same(gv, fv)


@pytest.mark.parametrize("kind", ["all_equal", "single_digit"])
@pytest.mark.parametrize("n", [1 << 26, (1 << 20) + 3])
def test_radix256_pairs_one_digit_passes(cuda, kind, n):
    """All-equal keys (the payloads must keep their input order) and keys
    whose passes 1-3 see one digit, also from inputs 4 bytes past a
    16-byte line."""
    from gpusorting_tpu_torch.ops import radix256

    x = _radix256_keys(kind, n, torch.uint32, cuda)
    v = _radix256_payload(n, torch.float32, cuda)
    kbuf = torch.empty(n + 1, dtype=torch.uint32, device=cuda)
    vbuf = torch.empty(n + 1, dtype=torch.float32, device=cuda)
    kbuf[1:].copy_(x)
    vbuf[1:].copy_(v)
    for keys, vals in ((x, v), (kbuf[1:], vbuf[1:])):
        gk, gv = radix256.sort_pairs(keys, vals)
        fk, fv = flat_sort.sort_pairs(keys, vals)
        assert _same(gk, fk) and _same(gv, fv)
    if kind == "all_equal":
        assert _same(gv, v)


def test_radix256_pairs_refused_capture_leaves_its_stream_usable(cuda):
    """radix256.sort_pairs raises under CUDA-graph capture before it
    allocates the stream's counts buffer, and the first eager sort on that
    stream afterwards is still bit-exact."""
    from gpusorting_tpu_torch.ops import radix256

    n = (1 << 20) + 3
    x = _radix256_keys("uniform", n, torch.uint32, cuda)
    v = _radix256_payload(n, torch.int32, cuda)
    fk, fv = flat_sort.sort_pairs(x, v)
    radix256.sort_pairs(x, v)     # built and run once outside capture
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    key = (x.device.index, side.cuda_stream)
    radix256._COUNTS.pop(key, None)   # the stream's first radix256 call
    before = radix256.sort_pairs.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            with pytest.raises(RuntimeError, match="CUDA graph"):
                radix256.sort_pairs(x, v)
        finally:
            graph.capture_end()
    assert radix256.sort_pairs.launches == before
    assert key not in radix256._COUNTS
    with torch.cuda.stream(side):
        gk, gv = radix256.sort_pairs(x, v)
    side.synchronize()
    assert _same(gk, fk) and _same(gv, fv)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()


def test_radix256_pairs_route_reads_nothing_back(cuda):
    """AUTO's pairs route on the card's row, sort_pairs with a 32-bit
    payload and argsort (its int32 index): one radix256 pairs sort of 5
    launches, one `engine.radix256` span and no readback
    (set_sync_debug_mode("error") raises on one) a call, both orders equal
    to the flat route."""
    from gpusorting_tpu_torch.ops import radix256
    from gpusorting_tpu_torch.utils import trace

    info = config.get_device_info(cuda)
    if info.generation != "h100":
        pytest.skip(f"no routing row for {info.device_kind}")
    n = 1 << 24
    assert config.auto_engine(n, config.Mode.PAIRS, info=info) == "radix256"
    x = _radix256_keys("uniform", n, torch.float32, cuda)
    v = _radix256_payload(n, torch.uint32, cuda)
    for order in (gstt.Order.ASCENDING, gstt.Order.DESCENDING):
        for call, flat in (
                (lambda: gstt.sort_pairs(x, v, order=order),
                 lambda: flat_sort.sort_pairs(x, v, order=order)),
                (lambda: gstt.argsort(x, order=order, return_keys=True),
                 lambda: gstt.argsort(x, order=order, return_keys=True,
                                      backend=gstt.Backend.XLA))):
            before, spans = radix256.sort_pairs.launches, trace.counts()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = call()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            after = trace.counts()
            assert radix256.sort_pairs.launches == before + 5
            assert after["engine.radix256"] == spans.get(
                "engine.radix256", 0) + 1
            assert after.get("engine.flat", 0) == spans.get("engine.flat", 0)
            want = flat()
            assert all(_same(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_radix256_across_the_epoch_wrap(cuda, k):
    """The stream's epoch counter set to _SCAN_EPOCHS - k, so that the four
    epochs of the first sort after it wrap (the scratch is zeroed and
    counting starts again at 1) after k of them: 2^20 + 3 keys, and pairs,
    each sorted twice, equal to their plain versions."""
    from gpusorting_tpu_torch.ops import radix256

    n = (1 << 20) + 3
    x = _radix256_keys("uniform", n, torch.int32, cuda)
    v = _radix256_payload(n, torch.float32, cuda)
    pk = radix256.sort_plain(x)
    ppk, ppv = radix256.sort_pairs_plain(x, v)
    radix256.sort(x)                  # the stream's scratch is made
    torch.cuda.synchronize()
    key = (x.device.index, torch.cuda.current_stream().cuda_stream)
    for sort_pairs in (False, True):
        kernels._SCAN_SCRATCH[key][1] = kernels._SCAN_EPOCHS - k
        for _ in range(2):
            if sort_pairs:
                gk, gv = radix256.sort_pairs(x, v)
                assert _same(gk, ppk) and _same(gv, ppv)
            else:
                assert _same(radix256.sort(x), pk)
        # the wrap came after k draws: the rest of the eight count from 1
        assert kernels._SCAN_SCRATCH[key][1] == 8 - k



# ---- the segmented sort's shared-memory tile (csrc/segtile.cu) -------------

def _tile_lens(total, max_len, seed, extra=()):
    """Random lengths in [1, max_len] with `extra` among them, the last one
    cut so that they sum to `total`."""
    rng = np.random.default_rng(seed)
    lens = np.concatenate([np.asarray(extra, np.int64),
                           rng.integers(1, max_len + 1,
                                        4 * total // max_len + 16)])
    ends = np.cumsum(lens)
    k = int(np.searchsorted(ends, total))
    lens = lens[:k + 1].copy()
    lens[k] -= int(ends[k]) - total
    return rng.permutation(lens)


def _tile_keys(kind, n, dtype, seed, dev):
    keys = prng.make_test_keys(n, seed, dtype, device=dev)
    raw = keys.view(torch.int32)
    if kind == "alleq":
        raw.fill_(0x1234ABCD)
    elif kind.startswith("bits"):
        raw.bitwise_and_((1 << int(kind[4:])) - 1)
    if dtype == torch.float32:
        sp = torch.tensor([0x7FC00000, 0xFFC00001, 0, 0x80000000,
                           0x7F800000, 0xFF800000], dtype=torch.int64,
                          device=dev)
        sp = ((sp ^ 0x80000000) - 0x80000000).to(torch.int32)
        pos = torch.arange(0, n, 331, device=dev)
        raw[pos] = sp[pos % sp.numel()]
    return keys


# (case, key dtype, key kind, payload, bits_to_sort, options): payload None,
# "u32", "u64" (one int64 plane) or "wide" (lo/hi planes through
# split_sort_pairs_wide); options: "edges" (segments of 0, 1 and the cap),
# "over_cap" (one segment one over the cap: the composite), "u32_offsets",
# "plan" (a SegSortPlan call)
TILE_ROUTE = [
    ("keys_u32", torch.uint32, "rand", None, 32, ()),
    ("pairs_u32", torch.uint32, "rand", "u32", 32, ()),
    ("pairs_u64_b16", torch.uint32, "bits16", "u64", 16, ()),
    ("wide_b16", torch.uint32, "bits16", "wide", 16, ()),
    ("pairs_b4", torch.uint32, "bits4", "u32", 4, ()),
    ("keys_i32", torch.int32, "rand", None, 32, ()),
    ("pairs_i32", torch.int32, "rand", "u32", 32, ()),
    ("pairs_f32", torch.float32, "rand", "u32", 32, ()),
    ("keys_f32", torch.float32, "rand", None, 32, ()),
    ("alleq_pairs", torch.uint32, "alleq", "u32", 32, ()),
    ("alleq_u64", torch.uint32, "alleq", "u64", 32, ()),
    ("edges_pairs", torch.uint32, "rand", "u32", 32, ("edges",)),
    ("edges_u64_b16", torch.uint32, "bits16", "u64", 16, ("edges",)),
    ("over_cap_pairs", torch.uint32, "rand", "u32", 32, ("over_cap",)),
    ("over_cap_keys", torch.uint32, "rand", None, 32, ("over_cap",)),
    ("u32_offsets", torch.uint32, "rand", "u32", 32, ("u32_offsets",)),
    ("plan_pairs", torch.uint32, "rand", "u32", 32, ("plan",)),
    ("plan_u64_b16", torch.uint32, "bits16", "u64", 16, ("plan",)),
]


@pytest.mark.parametrize("case", TILE_ROUTE, ids=[c[0] for c in TILE_ROUTE])
def test_segsort_tile_route_on_card(cuda, case):
    """The card's row sends a random-length layout whose longest segment is
    at most its `segsort_tile_max` to the tile route: one segtile launch,
    `engine.tile` once, no window plan, one readback (the offsets), bit for
    bit with the composite oracle (flat_sort.segmented_sort_pairs) and in
    order by count_segmented_violations; one segment over the cap takes the
    composite."""
    from gpusorting_tpu_torch.segsort import segtile
    from gpusorting_tpu_torch.utils import trace

    name, dtype, kind, pay, bits, opts = case
    cap = config.get_routing_parameters(
        config.get_device_info(cuda)).segsort_tile_max
    if cap == 0:
        pytest.skip("the card's row sends no layout to the tile route")
    total = 1 << 21
    extra = ((0, 1, cap, 0, 1) if "edges" in opts
             else (cap + 1,) if "over_cap" in opts else ())
    lens = _tile_lens(total, cap, len(name), extra)
    offs = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)[:-1]])).to(
        torch.int32).to(cuda)
    S = len(lens)
    keys = _tile_keys(kind, total, dtype, len(name) + 7, cuda)
    idx = torch.arange(total, dtype=torch.int64, device=cuda)
    vals = {None: None, "u32": (idx * 2654435761).to(torch.int32),
            "u64": idx * 0x9E3779B97F4A7C15 + 12345,
            "wide": idx * 0x9E3779B97F4A7C15 + 12345}[pay]
    arg_offs = offs.view(torch.uint32) if "u32_offsets" in opts else offs
    plan = (gstt.make_segsort_plan(offs, total, S) if "plan" in opts
            else None)
    launches, spans = segtile.sort.launches, trace.counts()
    if pay == "wide":
        lo, hi = codec.split_wide(vals)
        gk, glo, ghi = gstt.split_sort_pairs_wide(arg_offs, keys, lo, hi, S,
                                                  total, bits, plan=plan)
        gv = codec.join_wide(glo, ghi)
    elif pay is None:
        gk, gv = gstt.split_sort_keys(arg_offs, keys, S, bits,
                                      plan=plan), None
    else:
        gk, gv = gstt.split_sort_pairs(arg_offs, keys, vals, S, total, bits,
                                       plan=plan)
    torch.cuda.synchronize()
    after = trace.counts()

    def moved(name):
        return after.get(name, 0) - spans.get(name, 0)
    tile = "over_cap" not in opts
    assert segtile.sort.launches - launches == int(tile)
    assert moved("engine.tile") == int(tile)
    assert moved("dispatch.window_plan") == int(not tile and plan is None)
    assert moved("engine.composite") == int(not tile)
    if tile:
        assert moved("payload.split") == 0
        assert moved("sync.segment_mask") == 0
        assert moved("sync.offsets") == int(plan is None)
    want = flat_sort.segmented_sort_pairs(offs, keys, vals, total)
    wk, wv = want if vals is not None else (want, None)
    assert gk.dtype == keys.dtype
    assert torch.equal(gk.view(torch.int32), wk.view(torch.int32))
    if vals is not None:
        assert torch.equal(gv.view(vals.dtype), wv)
    assert int(validate.count_segmented_violations(offs, gk)) == 0


@pytest.mark.parametrize("tile", [256, 1024, 2048, 4096, 8192])
@pytest.mark.parametrize("pay", [None, "u32", "two", "u64"])
def test_segtile_kernel_matches_plain(cuda, tile, pay):
    """Each instantiation against the plain version, bit for bit, with
    every payload form: segments of 0, 1, 2, the tile and random lengths
    up to it, a start past n at the end; f32 keys (NaN, +-0) at 32 bits
    and u32 keys at 12."""
    from gpusorting_tpu_torch.segsort import segtile

    total = 300_000 + tile
    lens = _tile_lens(total, tile, tile, (0, 1, 2, tile, 1, 0))
    starts = np.concatenate([[0], np.cumsum(lens)[:-1], [total + 9]])
    offs = codec.wrap_int32(torch.from_numpy(starts)).to(cuda)
    idx = torch.arange(total, dtype=torch.int64, device=cuda)
    planes = {None: (), "u32": ((idx * 40503).to(torch.int32),),
              "two": ((idx * 40503).to(torch.int32),
                      (idx ^ 0x5555).to(torch.int32)),
              "u64": (idx * 0x9E3779B97F4A7C15,)}[pay]
    for dtype, kind, bits in ((torch.float32, "rand", 32),
                              (torch.uint32, "bits12", 12)):
        keys = _tile_keys(kind, total, dtype, tile + 1, cuda)
        before = segtile.sort.launches
        gk, gp = segtile.sort(offs, keys, planes, bits, max_len=tile)
        torch.cuda.synchronize()
        assert segtile.sort.launches == before + 1
        wk, wp = segtile.sort_plain(offs, keys, planes, bits)
        assert gk.dtype == dtype
        assert torch.equal(gk.view(torch.int32), wk.view(torch.int32))
        for g, w in zip(gp, wp):
            assert torch.equal(g, w)


def test_segtile_wrapper_checks_on_card(cuda):
    """A refused launch (a tile the kernel lacks) raises; no segments for
    keys raises; no keys launches nothing."""
    from gpusorting_tpu_torch.segsort import segtile

    lib = _nvcc.load(segtile.SOURCE)
    k = torch.zeros(64, dtype=torch.int32, device=cuda)
    offs = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _nvcc.launch("segtile.sort", lib.gst_segtile_sort, k.data_ptr(),
                     torch.empty_like(k).data_ptr(), offs.data_ptr(), 1, 64,
                     None, None, None, None, 0, 0, 4, 512, device=cuda)
    with pytest.raises(ValueError, match="no segments"):
        segtile.sort(offs[:0], k)
    before = segtile.sort.launches
    out, _ = segtile.sort(offs, k[:0])
    assert out.numel() == 0 and segtile.sort.launches == before


# ---- the segmented fixed-length route: a sampler's rows of logits ----------


def test_sampler_rows_match_the_plain_rows_on_card(cuda):
    """8 rows of 129,280 f32 keys (a top-p sampler's logits over
    DeepSeek-V3's vocabulary) with their u32 indices through
    split_sort_pairs on the card's routing row: the fixed-length route,
    `engine.fixed`, `fixed.sort` and `fixed.gather` once each, no tile or
    composite span, and bit for bit with sortbench/plain_rows.py (one
    stable sort of the int64 (row, code) key).  The keys hold NaNs of both
    signs, both zeros, both infinities, denormals and repeated values."""
    from gpusorting_tpu_torch.utils import trace
    from sortbench import plain_rows

    rows, L = 8, 129_280
    n = rows * L
    rng = np.random.default_rng(26)
    bits = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    specials = np.array([0x7FC00000, 0xFFC00000, 0x80000000, 0, 0x7F800000,
                         0xFF800000, 1, 0x80000001, 0x3F800000],
                        dtype=np.uint32)
    bits[::13] = specials[np.arange(bits[::13].shape[0]) % len(specials)]
    bits[5::11] = bits[:5][np.arange(bits[5::11].shape[0]) % 5]
    keys = torch.from_numpy(bits.view(np.int32)).view(torch.float32).to(cuda)
    index = torch.arange(n, dtype=torch.int32, device=cuda).view(torch.uint32)
    starts = np.arange(rows, dtype=np.int64) * L
    offs = torch.from_numpy(starts.astype(np.int32)).to(cuda)
    trace.reset()
    gk, gv = gstt.split_sort_pairs(offs, keys, index, rows, n)
    torch.cuda.synchronize()
    marked = {k: v for k, v in trace.counts().items()
              if v and k.startswith(("engine.", "fixed.", "composite.",
                                     "payload."))}
    assert marked == {"engine.fixed": 1, "fixed.sort": 1, "fixed.gather": 1}
    wk, wv = plain_rows.sort_rows_blocked(keys, index, starts)
    assert gk.dtype == torch.float32 and gv.dtype == torch.uint32
    assert torch.equal(gk.view(torch.int32), wk.view(torch.int32))
    assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))
