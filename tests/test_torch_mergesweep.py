"""Port parity for the mergesweep engine: the merge-tail and hyper-stage
kernels (plain versions on the CPU), the engine and its stable form, the
seg_elems checks and the public entry points under `variant="mergesweep"`,
against gpusorting_tpu, bit for bit.

The same numpy inputs go through the JAX package on the CPU (its Pallas
kernels in interpret mode, as tests/test_mergesweep.py runs them) and
through the port on device="cpu".  The merge network is deterministic, so
the planes after any kernel match too, ties included.  At the JAX tests'
sizes one tile spans the whole array and no high stride runs, so both
packages get tiny tiles here: the JAX package's tuning override sets
`vmem_limit_bytes` to 12288 (8-row tiles) on every mode, and the port's
sets `network_smem_bytes` to 2- or 64-row tiles for the operand count;
the output does not depend on the tile.  Then global stages, hyper-stage
trips (two in one pass with the 2-row tile) and merge tails all
run, with the hyper switch (`_USE_HYPER`) off and on in both packages (on
by default in the port, off in JAX).  The CUDA kernels are tested on the
card by tests/test_torch_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpusorting_tpu as gst
import gpusorting_tpu_torch as gstt
from gpusorting_tpu.core import config as jconfig
from gpusorting_tpu.core import prng as jprng
from gpusorting_tpu.ops import mergesweep as jmerge
from gpusorting_tpu_torch.core import codec, config
from gpusorting_tpu_torch.ops import bitonic, mergesweep

JTILE = 8                        # rows of the JAX kernels' tiles


def _t(a: np.ndarray) -> torch.Tensor:
    """u32 numpy codes -> the port's biased carrier."""
    return codec.bias(torch.from_numpy(np.ascontiguousarray(a).copy()))


def _u32(t: torch.Tensor) -> np.ndarray:
    return codec.unbias(t.contiguous()).numpy()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread keeps the plain versions fast when several test
    processes share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _planes(num_ops, rows, seed):
    """Plane 0 with many ties, the others distinct: (plane 0, plane 1) keys
    are distinct tuples."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(-20, 20, (rows, 128)).astype(np.int32)]
    for q in range(1, num_ops):
        out.append((np.arange(rows * 128, dtype=np.int64) * (2 * q + 1)
                    % (rows * 128)).astype(np.int32).reshape(rows, 128))
    return out


def _jax_tiles():
    """8-row tiles for every operand count in the JAX package: a VMEM
    budget of 12288 bytes on every mode."""
    for mode in jconfig.Mode:
        jconfig.set_tuning_override(mode, dataclasses.replace(
            jconfig.get_tuning_parameters(mode=mode),
            vmem_limit_bytes=12288))


def _port_tiles(rows, num_ops):
    """`rows`-row network tiles for `num_ops` planes in the port."""
    config.set_tuning_override(config.Mode.KEYS_ONLY, config.TuningParameters(
        512, network_smem_bytes=rows * 128 * 4 * num_ops))


@pytest.fixture
def clean_overrides():
    yield
    jconfig.clear_tuning_overrides()
    jconfig.clear_routing_override()
    config.clear_tuning_overrides()
    config.clear_routing_override()


# ---- the two kernels ----------------------------------------------------------


@pytest.mark.parametrize("k", [512, 2048, 4096])
@pytest.mark.parametrize("num_ops,num_keys", [(1, 1), (3, 2)])
def test_merge_tail_matches_jax(num_ops, num_keys, k):
    """k < tile (512: the direction changes inside a tile) and k >= tile."""
    R = 32
    planes = _planes(num_ops, R, seed=k + num_ops)
    top = min(k, JTILE * 128)
    jr_top = max(1, (top // 2) // 128)
    tail = jmerge._build_merge_tail(num_ops, num_keys, JTILE,
                                    jr_top.bit_length(), 7, R // JTILE, True)
    want = tail(jnp.asarray([k // 128, jr_top], jnp.int32),
                *[jnp.asarray(p) for p in planes])
    got = mergesweep.merge_tail([torch.from_numpy(p.copy()) for p in planes],
                                k, JTILE, num_keys)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k_of_tile", [0.25, 1, 2, 64],
                         ids=["below", "at", "twice", "far_above"])
@pytest.mark.parametrize("num_ops,num_keys", [(1, 1), (2, 1), (3, 2), (4, 2)])
def test_merge_tail_is_local_stages_on_its_schedule(num_ops, num_keys,
                                                    k_of_tile):
    """merge_tail_plain equals local_stages_plain on tail_schedule(tile, k):
    the identity that lets the card run the merge tail on the network's
    in-tile kernel.  k below the tile (the direction changes inside a
    tile), at it, at twice and far above it."""
    R, tr = 512, 8                 # n = 2^16, 64 tiles of 2^10
    te = tr * 128
    k = int(te * k_of_tile)
    planes = [torch.from_numpy(p) for p in _planes(num_ops, R, seed=k)]
    sched = bitonic.tail_schedule(te, k)
    j = min(k, te) // 2
    assert sched.tolist() == [[j >> s, k] for s in range(j.bit_length())]
    want = bitonic.local_stages_plain(planes, sched, num_keys, tr)
    got = mergesweep.merge_tail_plain([p.clone() for p in planes], k, tr,
                                      num_keys)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("stride_rows,W,k", [(8, 8, 8192), (16, 4, 16384)])
@pytest.mark.parametrize("num_ops,num_keys", [(1, 1), (3, 2)])
def test_hyper_stage_matches_jax(num_ops, num_keys, stride_rows, W, k):
    """One JAX hyper call against one trip and against the same strides in
    two trips; k = 8192 alternates the direction between the groups."""
    R, lo_tile = 128, 8
    H, mid = R // (W * stride_rows), stride_rows // lo_tile
    planes = _planes(num_ops, R, seed=W + num_ops)
    hyper = jmerge._build_hyper_stage(num_ops, num_keys, W, lo_tile,
                                      W.bit_length() - 1, H, mid, True)
    want = hyper(jnp.asarray([k // 128, stride_rows], jnp.int32),
                 *[jnp.asarray(p.reshape(H, W, mid, lo_tile, 128))
                   for p in planes])
    want = [np.asarray(w).reshape(R, 128) for w in want]
    j_lo = stride_rows * 128
    j_hi = W // 2 * j_lo
    one = mergesweep.hyper_stage([torch.from_numpy(p.copy()) for p in planes],
                                 k, j_hi, j_lo, num_keys)
    two = [torch.from_numpy(p.copy()) for p in planes]
    mergesweep.hyper_stage(two, k, j_hi, 2 * j_lo, num_keys, cols=16)
    mergesweep.hyper_stage(two, k, j_lo, j_lo, num_keys, cols=j_lo)
    for g1, g2, w in zip(one, two, want):
        np.testing.assert_array_equal(g1.numpy(), w)
        np.testing.assert_array_equal(g2.numpy(), w)


def test_hyper_trips_and_checks():
    # the H100 row's one-plane tile at 2^28: 13 high strides, 2 trips
    assert mergesweep.hyper_trips(1 << 28, 1 << 15, 1 << 15) == [
        (1 << 27, 1 << 21, 256), (1 << 20, 1 << 15, 512)]
    assert mergesweep.hyper_trips(1 << 16, 1 << 15, 1 << 15) == [
        (1 << 15, 1 << 15, 1 << 14)]
    trips = mergesweep.hyper_trips(1 << 15, 256, 256)      # 7 stages, <= 5
    assert trips == [(1 << 14, 1 << 11, 16), (1 << 10, 256, 32)]
    planes = [torch.zeros(64, 128, dtype=torch.int32)]
    for bad in ({"cols": 4}, {"cols": 2048}, {"cols": 24}):
        with pytest.raises(ValueError, match="cols"):
            mergesweep.hyper_stage(planes, 8192, 2048, 1024, 1, **bad)
    with pytest.raises(ValueError, match="run of pass"):
        mergesweep.hyper_stage(planes, 4096, 4096, 1024, 1)
    with pytest.raises(ValueError, match="pass k"):
        mergesweep.merge_tail(planes, 3000, 8, 1)


def test_level_trips_of_the_h100_schedules():
    """The engines' trips take the most a block holds, HYPER_MAX_THREADS
    threads of HYPER_ITEMS int4 (2^15 elements on one plane, 2^14 on two or
    three, 2^13 on four): on the H100 row's tiles that is the tile, so 12
    and 11 stages a trip: a 2^28 keys sort's 91 high strides in 14 trips, a
    pairs sort's 105 in 17, every trip's group the budget.  A smaller tile
    caps the budget."""
    for num_ops, tile in ((1, 1 << 15), (2, 1 << 14), (3, 1 << 14),
                          (4, 1 << 13)):
        assert (4 * mergesweep.HYPER_ITEMS[num_ops]
                * mergesweep.HYPER_MAX_THREADS) == tile
        assert mergesweep.level_trips(1 << 28, tile, num_ops) == \
            mergesweep.hyper_trips(1 << 28, tile, tile)
    assert mergesweep.level_trips(1 << 28, 1 << 15, 1) == [
        (1 << 27, 1 << 21, 256), (1 << 20, 1 << 15, 512)]
    assert mergesweep.level_trips(1 << 14, 1024, 1) == \
        mergesweep.hyper_trips(1 << 14, 1024, 1024)
    for num_ops, tile, stages, trips in ((1, 1 << 15, 91, 14),
                                         (3, 1 << 14, 105, 17)):
        levels = [mergesweep.level_trips(1 << lk, tile, num_ops)
                  for lk in range(tile.bit_length(), 29)]
        assert sum(len(t) for t in levels) == trips
        assert sum((2 * j_hi // j_lo).bit_length() - 1
                   for t in levels for j_hi, j_lo, _ in t) == stages
        for t in levels:
            for j_hi, j_lo, cols in t:
                assert 2 * j_hi // j_lo * cols == tile
                assert mergesweep.MIN_COLS <= cols <= j_lo


# ---- the engine ---------------------------------------------------------------


_N, _SEG = 20000, 1024


def _engine_inputs():
    rng = np.random.default_rng(5)
    x = np.asarray(jprng.hybrid_taus_bits(_N, seed=7))
    k8 = x & np.uint32(0xFF)
    r1 = rng.integers(0, 2**32, _N, dtype=np.uint32)
    r2 = rng.integers(0, 2**32, _N, dtype=np.uint32)
    a = rng.integers(-3, 3, _N).astype(np.int32)
    b = rng.integers(-50, 50, _N).astype(np.int32)
    return x, k8, r1, r2, a, b, r1.view(np.int32)


_ENGINE_IN = _engine_inputs()


@pytest.fixture(scope="module")
def jax_engine():
    """JAX results with 8-row tiles, the hyper switch off and on."""
    x, k8, r1, r2, a, b, c = _ENGINE_IN
    old = jmerge._USE_HYPER
    _jax_tiles()
    res = {}
    try:
        for hyper in (False, True):
            jmerge._USE_HYPER = hyper
            res["keys", hyper] = np.asarray(jmerge.sort_codes(
                jnp.asarray(x), seg_elems=_SEG))
            res["stable", hyper] = tuple(map(
                np.asarray, jmerge.sort_codes_stable_with(
                    jnp.asarray(k8), jnp.asarray(r1), jnp.asarray(r2),
                    seg_elems=_SEG)))
            res["net3", hyper] = tuple(map(
                np.asarray, jmerge.merge_sort_network_i32(
                    tuple(jnp.asarray(v) for v in (a, b, c)), num_keys=3,
                    seg_elems=2 * _SEG)))
    finally:
        jmerge._USE_HYPER = old
        jconfig.clear_tuning_overrides()
    for key in ("keys", "stable", "net3"):
        for w_off, w_on in zip(np.atleast_2d(res[key, False]),
                               np.atleast_2d(res[key, True])):
            np.testing.assert_array_equal(w_off, w_on)
    return res


def _expected_calls(N, L, tile_rows, hyper, num_ops):
    """(global_stage, hyper_stage, merge_tail) calls of one engine run."""
    tile = tile_rows * 128
    g = h = t = 0
    k = 2 * L
    while k <= N:
        if k > tile:
            stages = (k // tile).bit_length() - 1
            if hyper:
                h += len(mergesweep.level_trips(k, tile, num_ops))
            else:
                g += stages
        t += 1
        k *= 2
    return g, h, t


@pytest.mark.parametrize("port_rows", [2, 64])
@pytest.mark.parametrize("hyper", [False, True], ids=["off", "on"])
def test_engine_matches_jax(jax_engine, monkeypatch, clean_overrides, hyper,
                            port_rows):
    """sort_codes, sort_codes_stable_with (2 rides, 4 planes) and
    merge_sort_network_i32 (3 keys) against JAX; 2-row tiles split a pass's
    high strides into two hyper trips, 64-row tiles run tails with k below
    the tile."""
    x, k8, r1, r2, a, b, c = _ENGINE_IN
    monkeypatch.setattr(mergesweep, "_USE_HYPER", hyper)
    calls = {"global_stage": 0, "hyper_stage": 0, "merge_tail": 0}
    for mod, name in ((bitonic, "global_stage"), (mergesweep, "hyper_stage"),
                      (mergesweep, "merge_tail")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*args, **kw)
        monkeypatch.setattr(mod, name, spy)

    def counted(fn, N, L, num_ops):
        for key in calls:
            calls[key] = 0
        _port_tiles(port_rows, num_ops)
        out = fn()
        want = _expected_calls(N, L, port_rows, hyper, num_ops)
        assert tuple(calls.values()) == want
        return out

    got = counted(lambda: mergesweep.sort_codes(_t(x), seg_elems=_SEG),
                  32768, _SEG, 1)
    np.testing.assert_array_equal(_u32(got), jax_engine["keys", hyper])
    got = counted(lambda: mergesweep.sort_codes_stable_with(
        _t(k8), torch.from_numpy(r1.view(np.int32).copy()),
        torch.from_numpy(r2.view(np.int32).copy()), seg_elems=_SEG),
        32768, _SEG, 4)
    wk, w1, w2 = jax_engine["stable", hyper]
    np.testing.assert_array_equal(_u32(got[0]), wk)
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32), w1)
    np.testing.assert_array_equal(got[2].numpy().view(np.uint32), w2)
    got = counted(lambda: mergesweep.merge_sort_network_i32(
        tuple(torch.from_numpy(v.copy()) for v in (a, b, c)), num_keys=3,
        seg_elems=2 * _SEG), 32768, 2 * _SEG, 3)
    for g, w in zip(got, jax_engine["net3", hyper]):
        np.testing.assert_array_equal(g.numpy(), w)
    if port_rows == 2:       # 5 stages a trip: levels of 6-7 in 2 trips
        assert calls["merge_tail"] == 4 and (
            not hyper or calls["hyper_stage"] == 6)


def test_adversarial_inputs_match_jax():
    arrs = (np.full(30000, 7, np.uint32), np.arange(30000, dtype=np.uint32),
            np.arange(30000, dtype=np.uint32)[::-1],
            np.full(30000, 0xFFFFFFFF, np.uint32),
            np.asarray(jprng.hybrid_taus_bits(30000, seed=5, and_count=3)))
    for arr in arrs:
        want = np.asarray(jmerge.sort_codes(jnp.asarray(arr), seg_elems=2048))
        got = mergesweep.sort_codes(_t(arr), seg_elems=2048)
        np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("n,seg", [(1000, 3000), (1000, 512), (5000, 1000)])
def test_bad_seg_elems_raise_like_jax(n, seg):
    x = np.asarray(jprng.hybrid_taus_bits(n, seed=1))
    with pytest.raises(ValueError, match="seg_elems"):
        jmerge.sort_codes(jnp.asarray(x), seg_elems=seg)
    with pytest.raises(ValueError, match="seg_elems"):
        mergesweep.sort_codes(_t(x), seg_elems=seg)


def test_single_segment_is_one_flat_sort(monkeypatch):
    """K == 1 (the default segment at small n): no merge kernel runs."""
    monkeypatch.setattr(mergesweep, "merge_tail", None)
    x = np.asarray(jprng.hybrid_taus_bits(5000, seed=2))
    got = mergesweep.sort_codes(_t(x))
    np.testing.assert_array_equal(_u32(got), np.sort(x))
    k, v = _t(x & np.uint32(0xF)), torch.arange(5000, dtype=torch.int32)
    sk, sv = mergesweep.sort_codes_stable_with(k, v)
    want = torch.sort(k, stable=True)
    assert torch.equal(sk, want.values) and torch.equal(sv, want.indices.int())


# ---- the public entry points ---------------------------------------------------


def test_public_entry_points_match_jax_mergesweep(clean_overrides):
    """Every entry point, each order, against the JAX router's mergesweep,
    with 1024-key segments and small tiles in both packages, so the merge
    passes run (5000 keys: 8 segments)."""
    n = 5000
    jconfig.set_routing_override(dataclasses.replace(
        jconfig.get_routing_parameters(), mergesweep_seg_elems=1024))
    config.set_routing_override(config.RoutingParameters(
        mergesweep_seg_elems=1024))
    _jax_tiles()
    _port_tiles(2, 4)
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2**32, n, dtype=np.uint32)
    bits[::5] = bits[0]
    bits[::97] = 0x7FC00000
    bits[1::97] = 0x80000000
    bits[2::97] = 0
    lo = rng.integers(0, 2**32, n, dtype=np.uint32)
    hi = rng.integers(0, 2**32, n, dtype=np.uint32)
    jpal = {"backend": gst.Backend.PALLAS, "variant": "mergesweep"}
    tpal = {"backend": gstt.Backend.PALLAS, "variant": "mergesweep"}

    def eq(t, j):
        np.testing.assert_array_equal(
            t.contiguous().view(torch.int32).numpy(),
            np.asarray(j).view(np.int32))

    for jorder, torder in ((gst.Order.ASCENDING, gstt.Order.ASCENDING),
                           (gst.Order.DESCENDING, gstt.Order.DESCENDING)):
        for dt in (np.uint32, np.int32, np.float32):
            keys = bits.view(dt)
            tk, jk = torch.from_numpy(keys.copy()), jnp.asarray(keys)
            eq(gstt.sort(tk, order=torder, **tpal),
               gst.sort(jk, order=jorder, **jpal))
        tk, jk = torch.from_numpy(bits.copy()), jnp.asarray(bits)
        ok, ov = gstt.sort_pairs(tk, torch.from_numpy(lo), order=torder,
                                 **tpal)
        wk, wv = gst.sort_pairs(jk, jnp.asarray(lo), order=jorder, **jpal)
        eq(ok, wk)
        eq(ov, wv)
        wk, wlo, whi = gst.sort_pairs_wide(jk, jnp.asarray(lo),
                                           jnp.asarray(hi), order=jorder,
                                           **jpal)
        gk, glo, ghi = gstt.sort_pairs_wide(tk, torch.from_numpy(lo),
                                            torch.from_numpy(hi),
                                            order=torder, **tpal)
        eq(gk, wk)
        eq(glo, wlo)
        eq(ghi, whi)
        wide = (hi.astype(np.uint64) << 32 | lo).view(np.int64)
        k64, v64 = gstt.sort_pairs(tk, torch.from_numpy(wide), order=torder,
                                   **tpal)
        eq(k64, wk)
        np.testing.assert_array_equal(
            v64.numpy(), (np.asarray(whi).astype(np.uint64) << 32
                          | np.asarray(wlo)).view(np.int64))
        eq(gstt.argsort(tk, order=torder, **tpal),
           gst.argsort(jk, order=jorder, **jpal))
        tb, jb = tk[:4096].view(4, 1024), jk[:4096].reshape(4, 1024)
        eq(gstt.sort_batched(tb, order=torder, **tpal).reshape(-1),
           np.asarray(gst.sort_batched(jb, order=jorder, **jpal)).reshape(-1))


def test_seg_elems_field_carries_from_jax_and_h100_row_is_measured():
    jrow = jconfig.RoutingParameters(mergesweep_seg_elems=1 << 12)
    assert config.routing_from_jax_fields(
        dataclasses.asdict(jrow)).mergesweep_seg_elems == 1 << 12
    assert (config.RoutingParameters().mergesweep_seg_elems
            == jconfig.RoutingParameters().mergesweep_seg_elems)
    # the H100 row holds the length its chip run timed fastest, not the
    # TPU's 2^24, and every field of the row is measured
    assert config._ROUTING_TABLE["h100"].mergesweep_seg_elems == 1 << 27
    assert config._ROUTING_TABLE["h100"].measured is True
