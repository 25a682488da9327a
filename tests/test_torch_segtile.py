"""The segmented sort's shared-memory tile route (segsort/segtile.py) on the
CPU: its plain version bit for bit against the JAX package's segmented
sort at small shapes, and the route choice in segsort/splitsort.py.

The kernel itself (csrc/segtile.cu) runs only on a card and is tested by
tests/test_torch_cuda.py.  Here the route is reached on CPU tensors by a
stand-in CUDA device probe and a routing override with
`segsort_tile_max` > 0, so the wrapper takes its plain version; the
default row (0) and the CPU's own probe keep every route as it was.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpusorting_tpu as gst
import gpusorting_tpu_torch as gstt
from gpusorting_tpu_torch.core import config
from gpusorting_tpu_torch.ops import flat_sort
from gpusorting_tpu_torch.segsort import segtile, splitsort
from gpusorting_tpu_torch.utils import trace


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the other port files pin it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_CUDA_INFO = config.DeviceInfo(platform="cuda", device_kind="test card",
                               generation="cuda", num_devices=1,
                               hbm_bytes=0, hbm_gbps=0.0)


def _lens(total, max_len, seed, extra=()):
    rng = np.random.RandomState(seed)
    lens = list(extra)
    while sum(lens) < total:
        lens.append(min(int(rng.randint(1, max_len + 1)), total - sum(lens)))
    rng.shuffle(lens)
    return lens


def _offsets(lens) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.uint32)


def _keys(total, kind, seed):
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2**32, size=total, dtype=np.uint64).astype(
        np.uint32)
    if kind == "alleq":
        return np.full(total, 0xABCD1234, np.uint32)
    if kind.startswith("bits"):
        return bits & np.uint32((1 << int(kind[4:])) - 1)
    if kind == "i32":
        return bits.view(np.int32)
    if kind == "f32":
        f = bits.view(np.float32).copy()
        specials = np.array([0x7FC00000, 0xFFC00000, 0, 0x80000000,
                             0x7F800000, 0xFF800000], np.uint32)
        f.view(np.uint32)[::37] = specials[np.arange(len(f[::37])) % 6]
        return f
    return bits


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int32 if x.dtype.itemsize == 4 else torch.int64
                   ).numpy()
    x = np.asarray(x)
    return x.view(np.uint32 if x.dtype.itemsize == 4 else np.uint64)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


# (case, lens, key kind, payload, bits_to_sort)
PLAIN = [
    ("u32_pairs", _lens(3000, 300, 1, (0, 1, 300)), "u32", "u32", 32),
    ("i32_keys", _lens(2000, 64, 2, (1, 0)), "i32", None, 32),
    ("f32_pairs", _lens(2000, 500, 3), "f32", "u32", 32),
    ("alleq_pairs", _lens(2500, 700, 4, (700,)), "alleq", "u32", 32),
    ("bits16_wide", _lens(3000, 400, 5), "bits16", "wide", 16),
    ("bits4_pairs", _lens(1500, 90, 6), "bits4", "u32", 4),
]


@pytest.mark.parametrize("case", PLAIN, ids=[c[0] for c in PLAIN])
def test_plain_matches_jax(case):
    """sort_plain against the JAX package's split_sort_pairs (its own
    routes on the CPU) at small shapes, bit for bit: keys only, a 32-bit
    payload, a 64-bit payload as lo/hi planes; bits_to_sort 32, 16, 4;
    segments of length 0 and 1 among them."""
    name, lens, kind, pay, bits = case
    offs = _offsets(lens)
    total, S = int(sum(lens)), len(lens)
    keys = _keys(total, kind, len(name))
    vals = np.arange(total, dtype=np.uint32) * np.uint32(2654435761)
    hi = vals ^ np.uint32(0x5BD1E995)
    o = _t(offs).view(torch.int32)
    if pay == "wide":
        want = gst.split_sort_pairs_wide(
            jnp.asarray(offs), jnp.asarray(keys), jnp.asarray(vals),
            jnp.asarray(hi), S, total, bits)
        planes = (_t(vals).view(torch.int32), _t(hi).view(torch.int32))
    else:
        want = gst.split_sort_pairs(
            jnp.asarray(offs), jnp.asarray(keys),
            jnp.asarray(vals) if pay else None, S, total, bits)
        planes = (_t(vals).view(torch.int32),) if pay else ()
    want = want if isinstance(want, tuple) else (want,)
    sk, ps = segtile.sort_plain(o, _t(keys), planes, bits)
    _same((sk,) + ps, tuple(np.asarray(w) for w in want))
    # the wrapper takes the same plain version for CPU tensors
    sk2, ps2 = segtile.sort(o, _t(keys), planes, bits, max_len=max(lens))
    _same((sk2,) + ps2, (sk,) + ps)


def test_plain_moves_a_64bit_plane_as_its_pair_of_halves():
    """One int64 plane moves as the two int32 halves would."""
    lens = _lens(1200, 200, 9)
    o = _t(_offsets(lens)).view(torch.int32)
    keys = _t(_keys(1200, "bits12", 9))
    wide = _t(np.random.RandomState(3).randint(
        0, 2**63, size=1200, dtype=np.int64))
    halves = wide.view(torch.int32).view(-1, 2)
    sk, (sw,) = segtile.sort_plain(o, keys, (wide,), 12)
    sk2, (slo, shi) = segtile.sort_plain(
        o, keys, (halves[:, 0].contiguous(), halves[:, 1].contiguous()), 12)
    _same((sk, slo, shi), (sk2, sw.view(torch.int32).view(-1, 2)[:, 0],
                          sw.view(torch.int32).view(-1, 2)[:, 1]))


@pytest.mark.parametrize("max_len,tile", [(0, 256), (1, 256), (256, 256),
                                          (257, 1024), (2048, 2048),
                                          (2049, 4096), (8192, 8192)])
def test_tile_for(max_len, tile):
    assert segtile.tile_for(max_len) == tile


def test_wrapper_guards():
    o = torch.zeros(1, dtype=torch.int32)
    k = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="largest tile"):
        segtile.sort(o, k, max_len=8193)
    with pytest.raises(ValueError, match="payload planes"):
        segtile.sort(o, k, (k, k, k))
    with pytest.raises(ValueError, match="does not match"):
        segtile.sort(o, k, (k[1:],))
    with pytest.raises(ValueError, match="1-D"):
        segtile.sort(o, k.view(2, 4))
    assert [segtile.passes_for(b) for b in (4, 8, 9, 16, 24, 32)] == [
        1, 1, 2, 2, 3, 4]


# ---- the route choice -------------------------------------------------------


@pytest.fixture
def on_card(monkeypatch):
    """A CUDA device probe for CPU tensors, so the routes a card takes are
    chosen here; returns a function that installs a routing row."""
    monkeypatch.setattr(config, "get_device_info", lambda *a, **k: _CUDA_INFO)
    yield config.set_routing_override
    config.clear_routing_override()


_TILE_ROW = config.RoutingParameters(segsort_tile_max=1024)


def _counts(fn):
    before = trace.counts()
    out = fn()
    after = trace.counts()
    return out, {k: after.get(k, 0) - before.get(k, 0)
                 for k in ("engine.tile", "dispatch.window_plan",
                           "engine.composite", "engine.window",
                           "engine.fixed", "payload.split",
                           "launch.segtile.sort")}


def _case(lens, kind="u32", seed=0):
    offs = _offsets(lens)
    total = int(sum(lens))
    keys = _t(_keys(total, kind, seed))
    vals = _t(np.arange(total, dtype=np.uint32) * np.uint32(40503))
    return _t(offs).view(torch.int32), len(lens), total, keys, vals


@pytest.mark.parametrize("form", ["pairs_u32", "pairs_u64", "keys", "wide",
                                  "uint32_offsets", "plan", "sorter",
                                  "segsort_fn"])
def test_tile_route_skips_the_window_plan(on_card, form):
    """With segsort_tile_max > 0 on a card, a random-length layout within
    it takes the tile route: `engine.tile` once, no window plan, no payload
    split, bit for bit with the composite oracle."""
    on_card(_TILE_ROW)
    o, S, total, keys, vals = _case(_lens(4000, 1024, 11, (0, 1, 1024)),
                                    seed=5)
    u64 = vals.to(torch.int64) * 0x100000001 + 7
    want_k, want_v = flat_sort.segmented_sort_pairs(o, keys, vals, total)
    want_w = flat_sort.segmented_sort_pairs(o, keys, u64, total)[1]
    calls = {
        "pairs_u32": lambda: gstt.split_sort_pairs(o, keys, vals, S, total),
        "pairs_u64": lambda: gstt.split_sort_pairs(o, keys, u64, S, total),
        "keys": lambda: (gstt.split_sort_keys(o, keys, S), None),
        "wide": lambda: gstt.split_sort_pairs_wide(
            o, keys, vals, vals ^ 3, S, total),
        "uint32_offsets": lambda: gstt.split_sort_pairs(
            o.view(torch.uint32), keys, vals, S, total),
        "plan": lambda: gstt.split_sort_pairs(
            o, keys, vals, S, total, plan=gstt.make_segsort_plan(o, total,
                                                                 S)),
        "sorter": lambda: gstt.SplitSorter(total, S).sort_pairs(o, keys,
                                                                vals),
        "segsort_fn": lambda: gstt.make_segsort_fn(
            gstt.make_segsort_plan(o, total, S))(o, keys, vals),
    }
    out, n = _counts(calls[form])
    assert n == {"engine.tile": 1, "dispatch.window_plan": 0,
                 "engine.composite": 0, "engine.window": 0,
                 "engine.fixed": 0, "payload.split": 0,
                 "launch.segtile.sort": 0}     # the plain version: no launch
    _same((out[0],), (want_k,))
    if form == "pairs_u64":
        _same((out[1],), (want_w,))
    elif form == "wide":
        _same(out[1:], (want_v, want_v ^ 3))
    elif out[1] is not None:
        _same((out[1],), (want_v,))


@pytest.mark.parametrize("kind,bits", [("i32", 32), ("f32", 32),
                                       ("bits16", 16), ("alleq", 32)])
def test_tile_route_key_kinds(on_card, kind, bits):
    """i32, f32 (NaN and +-0 among them), bounded and all-equal keys take
    the tile route and keep the composite oracle's bits."""
    on_card(_TILE_ROW)
    o, S, total, keys, vals = _case(_lens(3000, 700, 17), kind, seed=2)
    gk, gv = gstt.split_sort_pairs(o, keys, vals, S, total, bits)
    wk, wv = flat_sort.segmented_sort_pairs(o, keys, vals, total)
    _same((gk, gv), (wk, wv))


@pytest.mark.parametrize("layout", ["over_cap", "starts_past_zero",
                                    "fixed"])
def test_layouts_outside_the_tile_keep_their_route(on_card, layout):
    """A layout one over the cap, offsets that do not start at 0 and equal
    lengths keep today's routes (the first two build the window plan)."""
    on_card(_TILE_ROW)
    if layout == "fixed":
        lens = [16] * 64
    else:
        lens = _lens(3000, 600, 23, (1025,) if layout == "over_cap" else ())
    o, S, total, keys, vals = _case(lens, seed=3)
    if layout == "starts_past_zero":
        o = o.clone()
        o[0] = 1
    (gk, gv), n = _counts(lambda: gstt.split_sort_pairs(o, keys, vals, S,
                                                        total))
    assert n["engine.tile"] == 0
    assert n["engine.fixed" if layout == "fixed" else
             "dispatch.window_plan"] == 1
    if layout != "starts_past_zero":
        _same((gk, gv), flat_sort.segmented_sort_pairs(o, keys, vals, total))


def test_default_and_cpu_rows_keep_their_routes(on_card, monkeypatch):
    """segsort_tile_max is 0 on the default row and on every row but the
    card's; with it 0 a card's layout builds the window plan as before,
    and a CPU tensor never takes the tile, whatever the row."""
    assert config.RoutingParameters().segsort_tile_max == 0
    assert gstt.routing_from_jax_fields(dataclasses.asdict(
        config.RoutingParameters())).segsort_tile_max == 0
    o, S, total, keys, vals = _case(_lens(3000, 500, 29), seed=4)
    for row in (None, config.RoutingParameters()):
        if row is not None:
            on_card(row)
        _, n = _counts(lambda: gstt.split_sort_pairs(o, keys, vals, S,
                                                     total))
        assert (n["engine.tile"], n["dispatch.window_plan"]) == (0, 1)
    monkeypatch.undo()      # the CPU's own probe, with the tile row
    config.set_routing_override(_TILE_ROW)
    try:
        _, n = _counts(lambda: gstt.split_sort_pairs(o, keys, vals, S,
                                                     total))
    finally:
        config.clear_routing_override()
    assert (n["engine.tile"], n["dispatch.window_plan"]) == (0, 1)


def test_plan_records_the_ordered_max_len():
    lens = _lens(2000, 300, 31, (300,))
    o = _t(_offsets(lens)).view(torch.int32)
    plan = gstt.make_segsort_plan(o, 2000, len(lens))
    assert plan.max_len == 300
    bad = o.clone()
    bad[1] = 0x7FFFFFFF       # a start past a later one
    assert gstt.make_segsort_plan(bad, 2000, len(lens)).max_len is None
    assert splitsort._ordered_max_len(np.zeros(0, np.int64), 0, 0) is None
