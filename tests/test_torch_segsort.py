"""Port parity for the segmented sort: the host plans, every route and the
public surface of gpusorting_tpu_torch.segsort against gpusorting_tpu's,
bit for bit.

The same numpy inputs go through the JAX package on the CPU (its stitch
kernels in interpret mode, as tests/test_segsort.py runs them) and through
the port on device="cpu", where the stitch wrappers take their plain
versions.  Floats are compared by their bits, so the tolerance is 0.  Each
test asserts the port's route with spies on its route functions; a routing
override is installed in BOTH packages where a test needs one.  JAX results
shared between tests are computed once (`_jax`).  The CUDA kernels are
tested on the card by tests/test_torch_cuda.py.
"""

import contextlib
import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpusorting_tpu as gst
import gpusorting_tpu_torch as gstt
from gpusorting_tpu.core import config as jconfig
from gpusorting_tpu.segsort import splitsort as jsplit
from gpusorting_tpu_torch.core import config
from gpusorting_tpu_torch.ops import stitch
from gpusorting_tpu_torch.segsort import splitsort


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops; one intra-op thread
    keeps them fast when several test processes share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---- inputs (numpy, handed to both packages) ------------------------------


def _random(total, max_len, seed):
    rng = np.random.RandomState(seed)
    lens = []
    while sum(lens) < total:
        lens.append(min(int(rng.randint(1, max_len + 1)), total - sum(lens)))
    return lens


def _bimodal(total, long_lens, seed, max_small=32):
    """Many small segments with a few long ones (tests/test_segsort.py)."""
    rng = np.random.RandomState(seed)
    lens, rem = [], total - sum(long_lens)
    while rem > 0:
        lens.append(min(int(rng.randint(1, max_small + 1)), rem))
        rem -= lens[-1]
    for ll in long_lens:
        lens.insert(int(rng.randint(0, len(lens))), ll)
    return lens


def _classes():
    """Bulk, two padded classes and a tail under SMALL_CAPS
    (tests/test_segsort.py:697-700)."""
    rng = np.random.RandomState(7)
    lens = ([int(x) for x in rng.randint(1, 100, size=40)]
            + [300, 450, 700, 1000] + [2000])
    rng.shuffle(lens)
    return lens


_LENS = {
    "fixed32": [32] * 256,
    "random64": _random(1 << 12, 64, 3),
    "random200": _random(1 << 13, 200, 5),
    "random1000": _random(1 << 13, 1000, 8),
    "packed32": _random(1 << 12, 32, 60),
    "bimodal": _bimodal(1 << 13, [1100, 800], 21),
    "classes": _classes(),
}
# exclusive-prefix offsets (u32, as JAX takes them) of each layout
LAYOUTS = {k: np.concatenate([[0], np.cumsum(v)[:-1]]).astype(np.uint32)
           for k, v in _LENS.items()}

# the multi-class test's caps (tests/test_segsort.py:692-695)
SMALL_CAPS = dict(window_max_keys=256, window_max_fused=256,
                  window_max_pairs=256, segsort_bulk_max=128,
                  segsort_padded_max=1024, segsort_extract_max_frac=1.0)
# caps that leave a random-length workload no route but the composite
NO_ROUTE = dict(window_max_keys=16, window_max_fused=16, window_max_pairs=16,
                segsort_extract_max_frac=0.0)


def _total(name) -> int:
    return int(sum(_LENS[name]))


def _keys(total, kind, seed):
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2**32, size=total, dtype=np.uint64).astype(
        np.uint32)
    if kind == "dup":
        return bits & np.uint32(0x3F)          # duplicate-heavy
    if kind.startswith("bits"):
        return bits & np.uint32((1 << int(kind[4:])) - 1)
    if kind == "i32":
        return bits.view(np.int32)
    if kind == "f32":
        f = bits.view(np.float32).copy()
        specials = np.array([0x7FC00000, 0xFFC00000, 0, 0x80000000,
                             0x7F800000, 0xFF800000], np.uint32)
        f.view(np.uint32)[::97] = specials[np.arange(len(f[::97])) % 6]
        return f
    return bits


@contextlib.contextmanager
def _caps(**fields):
    """Install the same routing row in both packages."""
    if not fields:
        yield
        return
    jconfig.set_routing_override(jconfig.RoutingParameters(**fields))
    config.set_routing_override(config.RoutingParameters(**fields))
    try:
        yield
    finally:
        jconfig.clear_routing_override()
        config.clear_routing_override()


_JAX_CACHE = {}


def _jax(key, fn):
    """A JAX result as numpy arrays, computed once per key."""
    if key not in _JAX_CACHE:
        out = fn()
        out = out if isinstance(out, tuple) else (out,)
        _JAX_CACHE[key] = tuple(np.asarray(o) for o in out)
    return _JAX_CACHE[key]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _bits(x) -> np.ndarray:
    """The bits of a result (torch or numpy) as unsigned integers."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int32 if x.dtype.itemsize == 4 else torch.int64
                   ).numpy()
    x = np.asarray(x)
    return x.view(np.uint32 if x.dtype.itemsize == 4 else np.uint64)


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.fixture
def routes(monkeypatch):
    """Record which of the port's route functions ran (and each window
    pass's mode), and the stitch calls the segmented sort made."""
    ran = []
    for name in ("_batched_segmented_sort", "_split_class_segmented_sort",
                 "_multi_class_segmented_sort", "_padded_rows_class_sort",
                 "_packed_bins_segmented_sort", "_composite_multi",
                 "_dense_tail_composite"):
        real = getattr(splitsort, name)

        def spy(*a, _real=real, _name=name, **k):
            ran.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(splitsort, name, spy)
    real_pass = splitsort._window_pass

    def window_spy(*a, **k):
        ran.append("window_" + (a[6] if len(a) > 6 else k.get("mode",
                                                             "stable3")))
        return real_pass(*a, **k)
    monkeypatch.setattr(splitsort, "_window_pass", window_spy)
    for name in ("compact_ops", "expand_ops"):
        real = getattr(stitch, name)

        def sspy(*a, _real=real, _name=name, **k):
            ran.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(stitch, name, sspy)
    return ran


# ---- fixed-length, window, split, class, packed and composite routes -------

# (case, layout, key kind, payload, bits_to_sort, strategy, caps, the routes
# the port must take)
ROUTES = [
    ("fixed_pairs", "fixed32", "u32", True, 32, "auto", {},
     ["_batched_segmented_sort"]),
    ("fixed_keys", "fixed32", "dup", False, 32, "auto", {},
     ["_batched_segmented_sort"]),
    ("window_stable3", "random200", "dup", True, 32, "auto", {},
     ["window_stable3"]),
    ("window_keys2", "random200", "u32", False, 32, "auto", {},
     ["window_keys2"]),
    ("window_fused_pairs", "random200", "bits12", True, 12, "auto", {},
     ["window_fused"]),
    ("window_fused_keys", "random64", "bits8", False, 8, "auto", {},
     ["window_fused"]),
    ("split_pairs", "bimodal", "dup", True, 32, "auto", {},
     ["_split_class_segmented_sort", "window_stable3",
      "_dense_tail_composite"]),
    ("split_keys", "bimodal", "dup", False, 32, "auto", {},
     ["_split_class_segmented_sort", "window_keys2"]),
    ("classes_pairs", "classes", "u32", True, 32, "auto", SMALL_CAPS,
     ["_multi_class_segmented_sort", "_padded_rows_class_sort",
      "_dense_tail_composite"]),
    ("classes_keys", "classes", "dup", False, 32, "auto", SMALL_CAPS,
     ["_multi_class_segmented_sort", "_padded_rows_class_sort"]),
    ("packed_pairs", "packed32", "u32", True, 32, "packed", {},
     ["_packed_bins_segmented_sort"]),
    ("packed_keys", "packed32", "dup", False, 32, "packed", {},
     ["_packed_bins_segmented_sort"]),
    ("composite_pairs", "random1000", "dup", True, 32, "auto", NO_ROUTE,
     ["_composite_multi"]),
    ("composite_keys", "random1000", "u32", False, 32, "auto", NO_ROUTE,
     ["_composite_multi"]),
    ("composite_fused_pairs", "random1000", "bits12", True, 12, "auto",
     NO_ROUTE, ["_composite_multi"]),
    ("composite_fused_keys", "random1000", "bits12", False, 12, "auto",
     NO_ROUTE, ["_composite_multi"]),
]

# stitch calls per split call and per class-plan call (two padded classes
# of two compacts and two expands each, and the tail's one of each)
STITCH_CALLS = {"split": 1, "classes": 5}


@pytest.mark.parametrize("case", ROUTES, ids=[r[0] for r in ROUTES])
def test_route_matches_jax(routes, case):
    name, layout, kind, pairs, bits, strategy, caps, expect = case
    offs = LAYOUTS[layout]
    total = _total(layout)
    keys = _keys(total, kind, zlib.crc32(name.encode()) % 1000)
    vals = np.arange(total, dtype=np.uint32) * np.uint32(2654435761)
    S = len(offs)
    with _caps(**caps):
        want = _jax(name, lambda: gst.split_sort_pairs(
            jnp.asarray(offs), jnp.asarray(keys),
            jnp.asarray(vals) if pairs else None, S, total, bits,
            strategy=strategy))
        got = gstt.split_sort_pairs(_t(offs).view(torch.int32), _t(keys),
                                    _t(vals) if pairs else None, S, total,
                                    bits, strategy=strategy)
    _same(got, want)
    for r in expect:
        assert r in routes, (r, routes)
    if layout in ("bimodal", "classes"):
        calls = STITCH_CALLS["split" if layout == "bimodal" else "classes"]
        assert routes.count("compact_ops") == calls
        assert routes.count("expand_ops") == calls


def test_composite_rangesweep_route_matches_jax(monkeypatch):
    """Composites the routing row sends to the range-exchange engine
    (forced here, as tests/test_segsort.py:833-863 forces JAX's) are
    bit-exact with JAX's composite for 0, 1 and 2 payload planes."""
    n, bits = 40_000, 12
    offs = np.concatenate([[0], np.cumsum(_random(n, 512, 3))[:-1]]).astype(
        np.uint32)
    rng = np.random.RandomState(5)
    codes = rng.randint(0, 1 << bits, size=n).astype(np.uint32)
    pays = [rng.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
            for _ in range(2)]
    S = len(offs)
    ran = []
    real = config.auto_engine

    def forced(*a, **k):
        ran.append(real(*a, **k))
        return "rangesweep"
    monkeypatch.setattr(config, "auto_engine", forced)
    config.set_routing_override(config.RoutingParameters(
        rangesweep_seg_elems=1024, rangesweep_seg_elems_pairs=1024,
        rangesweep_seg_elems_pairs_wide=1024))
    try:
        for k in range(3):
            want = jsplit._composite_multi(
                jnp.asarray(offs), jnp.asarray(codes),
                tuple(jnp.asarray(p) for p in pays[:k]), S, bits)
            sc, ps = splitsort._composite_multi(
                _t(offs).view(torch.int32),
                _t(codes).view(torch.int32) ^ -0x80000000,
                tuple(_t(p).view(torch.int32) for p in pays[:k]), S, bits)
            _same((sc ^ -0x80000000,) + ps, (want[0],) + tuple(want[1]))
    finally:
        config.clear_routing_override()
    assert ran == ["xla"] * 3      # the real decision on a CPU tensor


def test_window_modes_compose_like_jax():
    """`_windowed_segmented_sort` itself, in each mode, equals JAX's."""
    offs = LAYOUTS["random200"]
    total = _total("random200")
    keys = _keys(total, "bits12", 11)
    vals = np.arange(total, dtype=np.uint32)
    S = len(offs)
    ml = int(np.max(np.diff(np.append(offs.astype(np.int64), total))))
    for mode, fuse, pays in (("stable3", 0, (vals,)), ("keys2", 0, ()),
                             ("fused", 12, (vals,)), ("fused", 12, ())):
        want = jsplit._windowed_segmented_sort(
            jnp.asarray(offs), jnp.asarray(keys),
            tuple(jnp.asarray(p) for p in pays), S, ml, mode=mode,
            fuse_bits=fuse)
        sc, ps = splitsort._windowed_segmented_sort(
            _t(offs).view(torch.int32), _t(keys).view(torch.int32)
            ^ -0x80000000, tuple(_t(p).view(torch.int32) for p in pays), S,
            ml, mode=mode, fuse_bits=fuse)
        _same((sc ^ -0x80000000,) + ps, (want[0],) + tuple(want[1]))


# ---- host plans -------------------------------------------------------------


def _same_plan(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _same_plan(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_plan(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("layout,caps", [
    ("fixed32", {}), ("random64", {}), ("random1000", {}), ("bimodal", {}),
    ("classes", SMALL_CAPS), ("classes", {}), ("random1000", NO_ROUTE)])
@pytest.mark.parametrize("bits,pairs", [(32, True), (32, False),
                                        (12, True)])
def test_window_dispatch_plan_matches_jax(layout, caps, bits, pairs):
    offs = LAYOUTS[layout]
    total, S = _total(layout), len(offs)
    with _caps(**caps):
        want = jsplit._window_dispatch(jnp.asarray(offs), total, S,
                                       bits_to_sort=bits, has_payload=pairs)
        got = splitsort._window_dispatch(_t(offs).view(torch.int32), total,
                                         S, bits_to_sort=bits,
                                         has_payload=pairs)
    _same_plan(got, want)


def test_plan_edges_match_jax():
    """A giant segment, no segments and a mismatched count: JAX's plans."""
    for offs, total, S in ((np.array([0], np.uint32), 1 << 18, 1),
                           (np.zeros(0, np.uint32), 0, 0),
                           (LAYOUTS["random64"], 1 << 12, 5)):
        _same_plan(splitsort._window_dispatch(offs, total, S),
                   jsplit._window_dispatch(jnp.asarray(offs), total, S))
    for lens in ([1, 32, 33, 64, 131072, 131073, 5000], [0, 7, 40000]):
        _same_plan(splitsort.segment_length_histogram(lens),
                   jsplit.segment_length_histogram(lens))
    lengths = np.random.RandomState(0).randint(1, 50, size=500)
    _same_plan(splitsort.next_fit_bin_packing(lengths, 32),
               jsplit.next_fit_bin_packing(lengths, 32))
    starts = LAYOUTS["random1000"].astype(np.int64)
    for ml in (1, 31, 1000, 5000):
        assert (splitsort._window_sid_bits(starts, ml)
                == jsplit._window_sid_bits(starts, ml))


# ---- the public surface -----------------------------------------------------


@pytest.mark.parametrize("kind", ["u32", "i32", "f32"])
def test_public_key_types_match_jax(kind):
    """split_sort_keys and split_sort_pairs on u32/i32/f32 keys (NaN and
    +-0 among the floats), a u32 payload."""
    offs, total = LAYOUTS["random64"], _total("random64")
    keys = _keys(total, kind, 31)
    vals = np.arange(total, dtype=np.uint32)
    S = len(offs)
    want_k = _jax(("keys", kind), lambda: gst.split_sort_keys(
        jnp.asarray(offs), jnp.asarray(keys), S))
    want_p = _jax(("pairs", kind), lambda: gst.split_sort_pairs(
        jnp.asarray(offs), jnp.asarray(keys), jnp.asarray(vals), S, total))
    o = _t(offs).view(torch.int32)
    out = gstt.split_sort_keys(o, _t(keys), S)
    assert out.dtype == _t(keys).dtype
    _same(out, want_k)
    _same(gstt.split_sort_pairs(o, _t(keys), _t(vals), S, total), want_p)


@pytest.mark.parametrize("layout", ["random200", "bimodal"])
def test_64bit_payloads_match_jax(layout):
    """A float64 payload through split_sort_pairs, and lo/hi planes through
    split_sort_pairs_wide, against JAX's two-plane form (its float64
    needs x64)."""
    offs, total = LAYOUTS[layout], _total(layout)
    keys = _keys(total, "dup", 41)
    f64 = np.random.RandomState(1).rand(total)
    lo = (f64.view(np.uint64) & 0xFFFFFFFF).astype(np.uint32)
    hi = (f64.view(np.uint64) >> 32).astype(np.uint32)
    S = len(offs)
    wk, wlo, whi = _jax(("wide", layout), lambda: gst.split_sort_pairs_wide(
        jnp.asarray(offs), jnp.asarray(keys), jnp.asarray(lo),
        jnp.asarray(hi), S, total))
    o = _t(offs).view(torch.int32)
    gk, gv = gstt.split_sort_pairs(o, _t(keys), _t(f64), S, total)
    assert gv.dtype == torch.float64
    _same(gk, (wk,))
    np.testing.assert_array_equal(
        _bits(gv), wlo.astype(np.uint64) | (whi.astype(np.uint64) << 32))
    _same(gstt.split_sort_pairs_wide(o, _t(keys), _t(lo), _t(hi), S, total),
          (wk, wlo, whi))


@pytest.mark.parametrize("bits", [4, 8, 16, 24])
def test_bits_to_sort_matches_jax(bits):
    offs, total = LAYOUTS["random1000"], _total("random1000")
    keys = _keys(total, f"bits{bits}", bits)
    vals = np.arange(total, dtype=np.uint32)
    S = len(offs)
    want = gst.split_sort_pairs(jnp.asarray(offs), jnp.asarray(keys),
                                jnp.asarray(vals), S, total, bits)
    _same(gstt.split_sort_pairs(_t(offs).view(torch.int32), _t(keys),
                                _t(vals), S, total, bits),
          tuple(np.asarray(w) for w in want))


def test_plan_fn_and_sorter_match_jax():
    """make_segsort_plan, a plan= call, make_segsort_fn (pairs and keys)
    and SplitSorter give JAX's bits; the plan reads the offsets once."""
    offs, total = LAYOUTS["bimodal"], _total("bimodal")
    keys = _keys(total, "dup", 51)
    vals = np.arange(total, dtype=np.uint32)
    S = len(offs)
    want_p = gst.split_sort_pairs(jnp.asarray(offs), jnp.asarray(keys),
                                  jnp.asarray(vals), S, total)
    want_p = tuple(np.asarray(w) for w in want_p)
    o = _t(offs).view(torch.int32)
    plan = gstt.make_segsort_plan(o, total, S)
    jplan = gst.make_segsort_plan(jnp.asarray(offs), total, S)
    assert plan.fixed_length == jplan.fixed_length is None
    _same_plan(plan.window_plan(32, True), jplan.window_plan(32, True))
    _same(gstt.split_sort_pairs(o, _t(keys), _t(vals), S, total, plan=plan),
          want_p)
    fn = gstt.make_segsort_fn(plan)
    _same(fn(o, _t(keys), _t(vals)), want_p)
    _same(gstt.make_segsort_fn(plan, has_payload=False)(o, _t(keys)),
          (want_p[0],))
    sorter = gstt.SplitSorter(total, S)
    _same(sorter.sort_pairs(o, _t(keys), _t(vals)), want_p)
    _same(sorter.sort_keys(o, _t(keys)), (want_p[0],))
    sorter.close()
    fixed = gstt.make_segsort_plan(_t(LAYOUTS["fixed32"]).view(torch.int32),
                                   1 << 13, 256)
    assert fixed.fixed_length == 32
    handle = gstt.split_sort_allocate_temp_memory(total, S)
    assert handle == gst.split_sort_allocate_temp_memory(total, S)
    gstt.split_sort_free_temp_memory(handle)


def test_guards():
    offs = _t(LAYOUTS["random200"]).view(torch.int32)
    total, S = _total("random200"), len(LAYOUTS["random200"])
    keys = _t(_keys(total, "u32", 1))
    with pytest.raises(ValueError, match="bits_to_sort"):
        gstt.split_sort_keys(offs, keys, S, bits_to_sort=3)
    with pytest.raises(ValueError, match="bits_to_sort"):
        gstt.split_sort_pairs(offs, keys, keys, S, total, 33)
    with pytest.raises(ValueError, match="strategy"):
        gstt.split_sort_keys(offs, keys, S, strategy="bogus")
    with pytest.raises(ValueError, match="uint32"):
        gstt.split_sort_keys(offs, keys.view(torch.int32), S,
                             bits_to_sort=16)
    with pytest.raises(ValueError, match="uint32"):
        gstt.split_sort_pairs_wide(offs, keys.view(torch.float32), keys,
                                   keys, S, total, 8)
    with pytest.raises(ValueError, match="<= 32"):
        gstt.split_sort_keys(offs, keys, S, strategy="packed")
    plan = gstt.make_segsort_plan(offs, total, S)
    with pytest.raises(ValueError, match="plan was built for"):
        gstt.split_sort_pairs(offs, keys, keys, S + 1, total, plan=plan)
    with pytest.raises(ValueError, match="payload shape"):
        gstt.split_sort_pairs(offs, keys, keys[1:], S, total)
    with pytest.raises(TypeError, match="32-bit"):
        gstt.split_sort_pairs_wide(offs, keys, keys.to(torch.int64),
                                   keys, S, total)


def test_routing_fields_carry_from_jax():
    jrow = jconfig.RoutingParameters(
        window_max_keys=1, window_max_fused=2, window_max_pairs=3,
        segsort_bulk_max=4, segsort_padded_max=5,
        segsort_extract_max_frac=0.25)
    row = gstt.routing_from_jax_fields(dataclasses.asdict(jrow))
    for f in ("window_max_keys", "window_max_fused", "window_max_pairs",
              "segsort_bulk_max", "segsort_padded_max",
              "segsort_extract_max_frac"):
        assert getattr(row, f) == getattr(jrow, f)
        assert (getattr(config.RoutingParameters(), f)
                == getattr(jconfig.RoutingParameters(), f))
    assert not hasattr(row, "map_rows_min_keys")
