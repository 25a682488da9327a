"""Port parity for the bitonic sorting network: the in-tile and cross-tile
stages (plain versions on the CPU), the network and its stable form,
against gpusorting_tpu, bit for bit.

The same numpy inputs go through the JAX package on the CPU (its Pallas
kernels in interpret mode, as tests/test_bitonic.py runs them) and through
the port on device="cpu".  The network is deterministic, so the planes
after any pass match too, ties included.  To run the levels above the tile
at n of about 16K, the JAX package's tuning override sets
`vmem_limit_bytes` to 49152 (8-row tiles for up to 4 operands) and the
port's sets `network_smem_bytes` to the same 8-row tile.  The port runs
those levels as hyper trips by default (JAX as global stages; the same
compare-exchanges in the same order); the tests hold both switch settings.
The CUDA kernels are tested on the card by tests/test_torch_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpusorting_tpu as gst
from gpusorting_tpu.core import config as jconfig
from gpusorting_tpu.ops import bitonic as jbitonic
from gpusorting_tpu_torch.core import codec, config
from gpusorting_tpu_torch.ops import bitonic, mergesweep

TILE = 8                       # rows of 128 keys
TILE_ELEMS = TILE * 128


def _t(a: np.ndarray) -> torch.Tensor:
    """u32 numpy codes -> the port's biased carrier."""
    return codec.bias(torch.from_numpy(np.ascontiguousarray(a).copy()))


def _u32(t: torch.Tensor) -> np.ndarray:
    return codec.unbias(t.contiguous()).numpy()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops; one intra-op thread
    keeps them fast when several test processes share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tile8():
    """8-row network tiles in both packages: JAX's VMEM budget of 49152
    bytes gives 8 rows for up to 4 operands; the port's budget is set per
    operand count."""
    jconfig.set_tuning_override(jconfig.Mode.KEYS_ONLY, dataclasses.replace(
        jconfig.get_tuning_parameters(), vmem_limit_bytes=49152))

    def port(num_ops):
        config.set_tuning_override(
            config.Mode.KEYS_ONLY, config.TuningParameters(
                512, network_smem_bytes=TILE_ELEMS * 4 * num_ops))
    yield port
    jconfig.clear_tuning_overrides()
    config.clear_tuning_overrides()


def _planes(num_ops, rows, seed):
    """Plane 0 with many ties, the others distinct: (plane 0, plane 1) keys
    are distinct tuples."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(-20, 20, (rows, 128)).astype(np.int32)]
    for q in range(1, num_ops):
        out.append((np.arange(rows * 128, dtype=np.int64) * (2 * q + 1)
                    % (rows * 128)).astype(np.int32).reshape(rows, 128))
    return out


# ---- the two stages ---------------------------------------------------------


@pytest.mark.parametrize("num_ops,num_keys", [(1, 1), (2, 1), (4, 2)])
@pytest.mark.parametrize("which", ["in_tile", "tail"])
def test_local_stages_match_jax(num_ops, num_keys, which):
    grid = 4
    rows = grid * TILE
    planes = _planes(num_ops, rows, seed=num_ops)
    if which == "in_tile":
        sched = bitonic.in_tile_schedule(TILE_ELEMS)
    else:                       # a level above the tile: k from the index
        sched = bitonic.tail_schedule(TILE_ELEMS, 4 * TILE_ELEMS)
    call = jbitonic._build_local_pass(num_ops, num_keys, TILE,
                                      sched.shape[0], grid, True)
    want = call(jnp.asarray(sched.numpy()), *map(jnp.asarray, planes))
    got = bitonic.local_stages([torch.from_numpy(p) for p in planes], sched,
                               num_keys, TILE)
    assert len(got) == num_ops
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("num_ops,num_keys", [(1, 1), (3, 2)])
@pytest.mark.parametrize("jblocks,k_mult", [(1, 2), (2, 8)])
def test_global_stage_matches_jax(num_ops, num_keys, jblocks, k_mult):
    grid = 8
    rows = grid * TILE
    planes = _planes(num_ops, rows, seed=10 + num_ops)
    j = jblocks * TILE_ELEMS
    k = j * k_mult
    call = jbitonic._build_global_stage(num_ops, num_keys, TILE, grid,
                                        jblocks, True)
    want = call(jnp.asarray([j, k], jnp.int32), *map(jnp.asarray, planes))
    tp = [torch.from_numpy(p.copy()) for p in planes]
    got = bitonic.global_stage(tp, j, k, num_keys, TILE)
    assert got is tp                                  # in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_stage_checks():
    p = [torch.zeros((16, 128), dtype=torch.int32)]
    for bad in ((3, 8), (1024, 2048), (4, 4)):
        with pytest.raises(ValueError, match="stage"):
            bitonic.local_stages(p, torch.tensor([bad], dtype=torch.int32),
                                 1, 8)
    with pytest.raises(ValueError, match="stage"):
        bitonic.global_stage(p, 512, 2048, 1, 8)         # below the tile
    with pytest.raises(ValueError, match="stage"):
        bitonic.global_stage(p, 2048, 4096, 1, 8)        # not below n
    with pytest.raises(ValueError, match="num_keys"):
        bitonic.local_stages(p, bitonic.in_tile_schedule(1024), 2, 8)
    with pytest.raises(ValueError, match="tiles"):
        bitonic.local_stages(p, bitonic.in_tile_schedule(1024), 1, 3)
    with pytest.raises(TypeError):
        bitonic.global_stage(p + [p[0].float()], 1024, 2048, 1, 8)


# ---- the in-tile kernel's run table ----------------------------------------


def _schedules(tile_elems):
    return {"in_tile": bitonic.in_tile_schedule(tile_elems),
            "tail_2": bitonic.tail_schedule(tile_elems, 2 * tile_elems),
            "tail_4": bitonic.tail_schedule(tile_elems, 4 * tile_elems)}


@pytest.mark.parametrize("which", ["in_tile", "tail_2", "tail_4"])
@pytest.mark.parametrize("tile_log", range(7, 16))
def test_stage_runs_cover_schedule(tile_log, which):
    """The runs cover the schedule in order, each stage once; each run's
    strides lie in one class (below the warp's span: registers and
    shuffles; at least it: registers by the group's bits, at most
    GROUP_BITS distinct strides)."""
    sched = _schedules(1 << tile_log)[which]
    runs = bitonic.stage_runs(sched)
    strides = sched[:, 0].tolist()
    assert [s for a, b in runs for s in range(a, b)] == list(range(
        len(strides)))
    classes = []
    for a, b in runs:
        assert a < b
        in_warp = {j < bitonic.WARP_SPAN for j in strides[a:b]}
        assert len(in_warp) == 1
        classes.append(in_warp.pop())
        if not classes[-1]:      # long strides: at most GROUP_BITS bits
            assert len(set(strides[a:b])) <= bitonic.GROUP_BITS
    # warp runs are maximal; a long-stride run ends where a new stride
    # would make one bit too many
    for (a, b), (c, d), x, y in zip(runs, runs[1:], classes, classes[1:]):
        assert x != y or (not x and len(set(strides[a:d])) >
                          bitonic.GROUP_BITS)
    # a tile within one warp's span is one run: no shared memory
    if (1 << tile_log) <= bitonic.WARP_SPAN:
        assert runs == [(0, len(strides))]


def test_stage_runs_of_the_h100_tiles():
    """The counts the kernel's design rests on: at a 2^15 tile the in-tile
    pass is 120 stages, 42 inside a thread, 50 across a warp and 28 of long
    strides, in 8 warp runs and 12 long-stride runs (so 19 barriers); a
    tail is 7 long strides in 3 runs, then one warp run of 8.  At 2^13 (4
    planes) a tail is 5 long strides in 2 runs, then 8."""
    assert bitonic.WARP_SPAN == 32 * bitonic.WARP_ITEMS == 256
    assert bitonic.WARP_ITEMS == 1 << bitonic.GROUP_BITS
    sched = bitonic.in_tile_schedule(1 << 15)
    j = sched[:, 0]
    assert (len(j), int((j < bitonic.WARP_ITEMS).sum()),
            int(((j >= bitonic.WARP_ITEMS) & (j < bitonic.WARP_SPAN)).sum()),
            int((j >= bitonic.WARP_SPAN).sum())) == (120, 42, 50, 28)
    runs = bitonic.stage_runs(sched)
    warp = [r for r in runs if sched[r[0], 0] < bitonic.WARP_SPAN]
    assert (len(warp), len(runs) - len(warp)) == (8, 12)
    assert bitonic.stage_runs(bitonic.tail_schedule(1 << 15, 1 << 16)) == [
        (0, 3), (3, 6), (6, 7), (7, 15)]
    assert bitonic.stage_runs(bitonic.tail_schedule(1 << 13, 1 << 20)) == [
        (0, 3), (3, 5), (5, 13)]
    assert bitonic.stage_runs(torch.zeros((0, 2), dtype=torch.int32)) == []


@pytest.mark.parametrize("tile_log", [8, 10, 13, 14, 15])
def test_run_table_kinds(tile_log):
    """The run table names the network's own patterns, which the kernel
    runs with compile-time strides: the first 36 stages of an in-tile pass
    (levels 2 .. 256), each level's last 8 strides (128 .. 1, one k), and
    three halving long strides with one k; everything else is generic."""
    te = 1 << tile_log
    in_tile = bitonic.run_table(bitonic.in_tile_schedule(te))
    levels = range(9, tile_log + 1)
    want = [(0, 36, bitonic.RUN_SORT256, 0)]
    s = 36
    for m in levels:                      # level k = 2^m above the span
        longs = list(range(m - 1, 7, -1))
        while longs:
            g, longs = longs[:3], longs[3:]
            kind = (bitonic.RUN_GROUP_MERGE if len(g) == 3
                    else bitonic.RUN_GROUP)
            want.append((s, s + len(g), kind,
                         1 << m if kind == bitonic.RUN_GROUP_MERGE else 0))
            s += len(g)
        want.append((s, s + 8, bitonic.RUN_MERGE, 1 << m))
        s += 8
    assert [tuple(r) for r in in_tile.tolist()] == want
    tail = bitonic.run_table(bitonic.tail_schedule(te, 4 * te))
    assert tail[-1].tolist() == [tail[-1][0], tail[-1][0] + 8,
                                 bitonic.RUN_MERGE, 4 * te]
    # a schedule in no pattern: generic runs
    odd = torch.tensor([[1, 4], [256, 1024], [2, 8]], dtype=torch.int32)
    assert bitonic.run_table(odd).tolist() == [
        [0, 1, bitonic.RUN_WARP, 0], [1, 2, bitonic.RUN_GROUP, 0],
        [2, 3, bitonic.RUN_WARP, 0]]
    small = bitonic.run_table(bitonic.in_tile_schedule(128))
    assert small.tolist() == [[0, 28, bitonic.RUN_WARP, 0]]


def test_device_schedule_is_checked_and_kept():
    """The wrapper's schedule table: the (R, 4) run table, then the (S, 2)
    stages, built and checked once per device, tile and schedule."""
    sched = bitonic.tail_schedule(1024, 4096)
    key = sched.numpy().tobytes()
    table, s, r = bitonic._device_schedule(torch.device("cpu"), 1024, key)
    assert (s, r) == (10, 2)
    assert table.dtype == torch.int32 and table.shape == (4 * r + 2 * s,)
    assert torch.equal(table[4 * r:].view(s, 2), sched)
    # (512, 256) a generic long-stride run, then the level's last 8
    assert table[:4 * r].view(r, 4).tolist() == [
        [0, 2, bitonic.RUN_GROUP, 0], [2, 10, bitonic.RUN_MERGE, 4096]]
    again = bitonic._device_schedule(torch.device("cpu"), 1024, key)
    assert again[0] is table
    with pytest.raises(ValueError, match="stage"):
        bitonic._device_schedule(torch.device("cpu"), 512, key)


# ---- the network ------------------------------------------------------------


_KEYS = np.random.default_rng(3).integers(0, 2**32, 16_000, dtype=np.uint32)
_KEYS[::7] = _KEYS[0]                                 # ties
_KEYS[::101] = np.uint32(0xFFFFFFFF)                  # the pad's code too
_VALS = np.arange(16_000, dtype=np.uint32) * np.uint32(2654435761)
_VALS2 = np.random.default_rng(4).integers(0, 2**32, 16_000, dtype=np.uint32)


def test_sort_codes_matches_jax(tile8):
    tile8(1)
    assert bitonic.network_tile_rows(torch.device("cpu"), 1) == TILE
    want = np.asarray(jbitonic.sort_codes(jnp.asarray(_KEYS)))
    np.testing.assert_array_equal(_u32(bitonic.sort_codes(_t(_KEYS))), want)
    np.testing.assert_array_equal(want, np.sort(_KEYS))


@pytest.mark.parametrize("rides", [1, 2])
def test_sort_codes_stable_with_matches_jax(tile8, rides):
    tile8(2 + rides)
    assert bitonic.network_tile_rows(torch.device("cpu"), 2 + rides) == TILE
    ride_u32 = (_VALS, _VALS2)[:rides]
    want = jbitonic.sort_codes_stable_with(jnp.asarray(_KEYS),
                                           *map(jnp.asarray, ride_u32))
    got = bitonic.sort_codes_stable_with(
        _t(_KEYS), *[torch.from_numpy(r.copy()).view(torch.int32)
                     for r in ride_u32])
    assert len(got) == 1 + rides
    np.testing.assert_array_equal(_u32(got[0]), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w))
    order = np.argsort(_KEYS, kind="stable")
    np.testing.assert_array_equal(got[1].numpy().view(np.uint32),
                                  _VALS[order])


@pytest.mark.parametrize("rides", [0, 1, 2])
def test_network_with_global_stages_matches_jax(monkeypatch, tile8, rides):
    """With the hyper switch off (GST_MERGESWEEP_HYPER=0) the levels above
    the tile run one global stage a stride, as in JAX: keys, and the
    stable sort on 3 and 4 planes, bit for bit (the tests above hold the
    default, hyper trips)."""
    monkeypatch.setattr(mergesweep, "_USE_HYPER", False)
    tile8(1 + rides + (rides > 0))
    ride_u32 = (_VALS, _VALS2)[:rides]
    if rides:
        want = jbitonic.sort_codes_stable_with(jnp.asarray(_KEYS),
                                               *map(jnp.asarray, ride_u32))
        got = bitonic.sort_codes_stable_with(
            _t(_KEYS), *[torch.from_numpy(r.copy()).view(torch.int32)
                         for r in ride_u32])
    else:
        want = (jbitonic.sort_codes(jnp.asarray(_KEYS)),)
        got = (bitonic.sort_codes(_t(_KEYS)),)
    np.testing.assert_array_equal(_u32(got[0]), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w))


def test_sort_network_i32_matches_jax(tile8):
    """Two keys, every plane a key (ties leave nothing to tell apart)."""
    tile8(2)
    a = _KEYS.view(np.int32) & 15
    b = _VALS2.view(np.int32) & 3
    want = jbitonic.sort_network_i32((jnp.asarray(a), jnp.asarray(b)), 2)
    got = bitonic.sort_network_i32((torch.from_numpy(a.copy()),
                                    torch.from_numpy(b.copy())), 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("hyper", [False, True], ids=["off", "on"])
@pytest.mark.parametrize("n", [0, 1, 1024, 5000, 1 << 14])
def test_network_launches_and_input_untouched(monkeypatch, tile8, n, hyper):
    """(L - t + 1) in-tile passes for N = 2^L and a 2^t-key tile; above the
    tile, each level's `level_trips` hyper trips and no global stage, or
    with the switch off (L - t)(L - t + 1) / 2 global stages and no trip;
    the caller's planes are never written, also when no pad is needed."""
    tile8(3)
    monkeypatch.setattr(mergesweep, "_USE_HYPER", hyper)
    calls = {"local": 0, "global": 0, "hyper": 0}
    for mod, name, key in ((bitonic, "local_stages", "local"),
                           (bitonic, "global_stage", "global"),
                           (mergesweep, "hyper_stage", "hyper")):
        def spy(*a, _real=getattr(mod, name), _key=key):
            calls[_key] += 1
            return _real(*a)
        monkeypatch.setattr(mod, name, spy)
    codes = _t(_KEYS[:n] if n <= _KEYS.size else np.resize(_KEYS, n))
    vals = torch.arange(n, dtype=torch.int32)
    before = (codes.clone(), vals.clone())
    sk, sv = bitonic.sort_codes_stable_with(codes, vals)
    want = torch.sort(codes, stable=True)
    assert torch.equal(sk, want.values)
    assert torch.equal(sv.long(), want.indices)
    assert torch.equal(codes, before[0]) and torch.equal(vals, before[1])
    L = max(10, (n - 1).bit_length())
    t = min(TILE_ELEMS, 1 << L).bit_length() - 1
    trips = sum(len(mergesweep.level_trips(1 << lk, 1 << t, 3))
                for lk in range(t + 1, L + 1))
    assert calls == {"local": L - t + 1,
                     "global": 0 if hyper else (L - t) * (L - t + 1) // 2,
                     "hyper": trips if hyper else 0}


@pytest.mark.parametrize("rides", [0, 1])
def test_network_level_in_two_trips_matches_jax_oracle(monkeypatch, tile8,
                                                       rides):
    """n = 2^18 - 5 with 8-row tiles: a trip holds log2(1024 / 8) = 7
    stages, so the level 2^18 (8 strides above the tile) runs in two hyper
    trips.  Keys, and a stable sort with one ride, against JAX's flat
    oracle (backend=XLA), bit for bit."""
    tile8(1 + 2 * rides)
    n = (1 << 18) - 5
    seen = []
    real = mergesweep.hyper_stage

    def spy(planes, k, *a):
        seen.append(k)
        return real(planes, k, *a)
    monkeypatch.setattr(mergesweep, "hyper_stage", spy)
    rng = np.random.default_rng(18 + rides)
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    keys[::3] = keys[1]                                 # ties
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    if rides:
        wk, wv = gst.sort_pairs(jnp.asarray(keys), jnp.asarray(vals),
                                backend=gst.Backend.XLA)
        gk, gv = bitonic.sort_codes_stable_with(
            _t(keys), torch.from_numpy(vals).view(torch.int32))
        np.testing.assert_array_equal(gv.numpy().view(np.uint32),
                                      np.asarray(wv))
    else:
        wk = gst.sort(jnp.asarray(keys), backend=gst.Backend.XLA)
        gk = bitonic.sort_codes(_t(keys))
    np.testing.assert_array_equal(_u32(gk), np.asarray(wk))
    assert [seen.count(1 << lk) for lk in range(11, 19)] == [1] * 7 + [2]


def test_network_tile_rows():
    generic = config.get_tuning_parameters(config.get_device_info("cpu"))
    assert generic.network_smem_bytes == 48 << 10
    assert [generic.network_tile_rows(k) for k in (1, 2, 3, 4)] == [
        64, 32, 32, 16]
    with pytest.raises(ValueError, match="network_smem_bytes"):
        config.TuningParameters(1, network_smem_bytes=511).network_tile_rows(1)
    with pytest.raises(ValueError, match="at most"):
        bitonic.sort_network_i32(
            (torch.empty(1, dtype=torch.int32).expand((1 << 30) + 1),), 1)
