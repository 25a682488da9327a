"""Port parity for `Backend.PALLAS`: the Upsweep, scan and downsweep (plain
versions on the CPU), the reduce-then-scan and FFX engines, and the public
entry points under PALLAS, against gpusorting_tpu, bit for bit.

The same numpy inputs go through the JAX package on the CPU (its Pallas
kernels in interpret mode, as tests/test_rts.py runs them) and through the
port on device="cpu".  The port carries codes as biased int32
(`codec.bias`), so u32 codes are compared after `codec.unbias`.  The JAX
engines compile once per padded shape and operand count, so the engine
inputs share padded shapes (1, 2 or 3 tiles of 128 rows) and each JAX
engine runs once per input, in a module-scoped fixture.  The wider matrix
of key types, orders and entry points is held against the JAX package's
flat oracle (`backend=XLA`), which its own tests hold bit-exact with its
PALLAS engines.  The CUDA kernels are tested on the card by
tests/test_torch_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpusorting_tpu as gst
import gpusorting_tpu_torch as gstt
from gpusorting_tpu.core import config as jconfig
from gpusorting_tpu.ops import ffx as jffx
from gpusorting_tpu.ops import kernels as jkernels
from gpusorting_tpu.ops import radix16 as jradix16
from gpusorting_tpu.ops import rts as jrts
from gpusorting_tpu_torch import ops
from gpusorting_tpu_torch.core import codec, config
from gpusorting_tpu_torch.ops import (bitonic, ffx, flat_sort, kernels,
                                      mergesweep, radix, radix16, rts,
                                      splitsweep)

TILE = 128


def _t(a: np.ndarray) -> torch.Tensor:
    """u32 numpy codes -> the port's biased carrier."""
    return codec.bias(torch.from_numpy(np.ascontiguousarray(a).copy()))


def _raw(a: np.ndarray) -> torch.Tensor:
    """u32 numpy payload -> int32 plane with the same bits (unbiased)."""
    return torch.from_numpy(np.ascontiguousarray(a).copy()).view(torch.int32)


def _u32(t: torch.Tensor) -> np.ndarray:
    return codec.unbias(t.contiguous()).numpy()


def _eq(t: torch.Tensor, j) -> None:
    want = np.asarray(j)
    got = t.contiguous().view(torch.int32 if t.dtype.itemsize == 4
                              else torch.int64).numpy()
    np.testing.assert_array_equal(got, want.view(got.dtype))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops; one intra-op thread
    keeps them fast when several test processes share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def small_ffx_tile():
    """The port's FFX engine at 2-row tiles and mergesweep at 1024-key
    segments (so its merge passes run), for the cases held against the JAX
    package's flat oracle (neither changes the output)."""
    config.set_routing_override(config.RoutingParameters(
        ffx_tile_rows=2, mergesweep_seg_elems=1024))
    yield
    config.clear_routing_override()


@pytest.fixture
def ffx_tile_128():
    """Both packages' FFX engines at 128-row tiles (the JAX one reads the
    routing override; the port's reads its own)."""
    jconfig.set_routing_override(dataclasses.replace(
        jconfig.RoutingParameters(), ffx_tile_rows=TILE))
    config.set_routing_override(config.RoutingParameters(
        ffx_tile_rows=TILE))
    yield
    jconfig.clear_routing_override()
    config.clear_routing_override()


# ---- the three kernels ------------------------------------------------------


@pytest.mark.parametrize("shift", range(0, 32, 4))
def test_tile_histogram4_matches_jax(shift):
    rows = 256
    x = np.random.default_rng(11).integers(0, 2**32, (rows, 128),
                                           dtype=np.uint32)
    want = jkernels.tile_histogram4(jnp.asarray(x), shift, TILE)
    got = kernels.tile_histogram4(_t(x).view(rows, 128), shift, TILE)
    assert got.dtype == torch.int32 and got.shape == (2, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1, 127, 128, 1000, 16 * 3,
                               kernels.SCAN_TILE - 1, kernels.SCAN_TILE,
                               kernels.SCAN_TILE + 1,
                               2 * kernels.SCAN_TILE + 3, 1 << 20])
def test_exclusive_scan_matches_jax(n):
    # values over the whole int32 range, so the sums wrap
    x = np.random.default_rng(n).integers(-2**31, 2**31, n, dtype=np.int32)
    want = jkernels.exclusive_scan(jnp.asarray(x))
    got = kernels.exclusive_scan(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [kernels.SCAN_TILE, kernels.SCAN_TILE + 1,
                               1 << 20])
def test_exclusive_scan_wraps_like_jax(n):
    # int32 extremes, so the running sum wraps on nearly every element
    rng = np.random.default_rng(n + 1)
    x = np.where(rng.integers(0, 3, n) == 0, np.int32(-2**31),
                 np.int32(2**31 - 1)).astype(np.int32)
    want = np.asarray(jkernels.exclusive_scan(jnp.asarray(x)))
    got = kernels.exclusive_scan(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    ref = (np.cumsum(x.astype(np.int64)) - x) & 0xFFFFFFFF
    np.testing.assert_array_equal(got.view(np.uint32), ref.astype(np.uint32))


@pytest.mark.parametrize("capturing", [False, True])
def test_scan_scratch_refuses_graph_capture(monkeypatch, capturing):
    """The chained kernels' scratch (exclusive_scan, binning_pass,
    compact_ops, expand_ops take it before they launch) raises under
    CUDA-graph capture, whose replays would reuse the captured epoch; out
    of capture it hands out the next epoch.  The capture query is patched,
    since this build has no card."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    monkeypatch.setattr(kernels, "_SCAN_SCRATCH", {})
    dev = torch.device("cpu")
    if capturing:
        with pytest.raises(RuntimeError, match="CUDA graph"):
            kernels._scan_scratch(dev, 7, 16)
        assert kernels._SCAN_SCRATCH == {}
    else:
        buf, epoch = kernels._scan_scratch(dev, 7, 16)
        assert (buf.numel(), epoch) == (1025, 1)
        assert kernels._scan_scratch(dev, 7, 16)[1] == 2


@pytest.fixture(scope="module")
def downsweep_case():
    """Two 128-row tiles of low-entropy codes, two rides, and each shift's
    digit-major cursor table (computed with numpy) fed to both packages."""
    rng = np.random.default_rng(21)
    n = 2 * TILE * 128
    codes = rng.integers(0, 2**32, n, dtype=np.uint32)
    codes &= rng.integers(0, 2**32, n, dtype=np.uint32)
    codes[::3] = codes[0]
    rides = [np.arange(n, dtype=np.uint32),
             rng.integers(0, 2**32, n, dtype=np.uint32)]
    tables = {}
    for shift in (0, 28):
        d = (codes >> np.uint32(shift)) & np.uint32(15)
        counts = np.stack([np.bincount(d[t * TILE * 128:(t + 1) * TILE * 128],
                                       minlength=16) for t in range(2)])
        dm = counts.T.reshape(-1)
        tables[shift] = (np.cumsum(dm) - dm).astype(np.int32)
    return codes, rides, tables


@pytest.mark.parametrize("num_ops", [1, 3])
@pytest.mark.parametrize("shift", [0, 28])
def test_downsweep_pass_matches_jax(downsweep_case, num_ops, shift):
    codes, rides, tables = downsweep_case
    rows = codes.size // 128
    ops_u32 = [codes] + rides[:num_ops - 1]
    table = tables[shift]
    jout = jrts.run_downsweep_chunks(
        [jnp.asarray(a.view(np.int32).reshape(rows, 128)) for a in ops_u32],
        jnp.asarray(table.reshape(16, -1)),
        jnp.asarray(jradix16._within_row_sort_schedule()),
        jnp.full((1,), shift, jnp.int32), rows, TILE, num_ops, 2, True)
    planes = [_t(codes).view(rows, 128)] + [
        _raw(r).view(rows, 128) for r in rides[:num_ops - 1]]
    got = rts.downsweep(planes, torch.from_numpy(table), shift, TILE)
    assert len(got) == num_ops
    np.testing.assert_array_equal(_u32(got[0]).reshape(-1),
                                  np.asarray(jout[0]).view(np.uint32)
                                  .reshape(-1))
    for g, j in zip(got[1:], jout[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


# ---- the engines ------------------------------------------------------------


def _engine_inputs():
    rng = np.random.default_rng(5)
    e020 = rng.integers(0, 2**32, 30_000, dtype=np.uint32)
    for _ in range(4):                     # E020: 4 extra ANDed draws
        e020 &= rng.integers(0, 2**32, 30_000, dtype=np.uint32)
    return {
        "n1": rng.integers(0, 2**32, 1, dtype=np.uint32),
        "n127": rng.integers(0, 2**32, 127, dtype=np.uint32),
        "n16385": rng.integers(0, 2**32, 16385, dtype=np.uint32),
        "uniform20000": rng.integers(0, 2**32, 20_000, dtype=np.uint32),
        "e020_30000": e020,
        "equal33000": np.full(33_000, 0xDEADBEEF, np.uint32),
    }


_INPUTS = _engine_inputs()
_PAIR_KEYS = np.random.default_rng(6).integers(0, 256, 20_000,
                                               dtype=np.uint32)
_PAIR_VALS = np.arange(20_000, dtype=np.uint32)
_PAIR_RIDE2 = np.random.default_rng(7).integers(0, 2**32, 20_000,
                                                dtype=np.uint32)


@pytest.fixture(scope="module")
def jax_engines():
    """Every JAX engine result the engine tests compare with, one call per
    engine and input."""
    jconfig.set_routing_override(dataclasses.replace(
        jconfig.RoutingParameters(), ffx_tile_rows=TILE))
    try:
        res = {}
        for name, x in _INPUTS.items():
            jx = jnp.asarray(x)
            res["rts", name] = np.asarray(jrts.sort_codes_rts(
                jx, tile_rows=TILE))
            res["ffx", name] = np.asarray(jffx.sort_codes_ffx(jx))
        k, v, w = (jnp.asarray(a) for a in (_PAIR_KEYS, _PAIR_VALS,
                                             _PAIR_RIDE2))
        res["rts_pairs"] = tuple(map(np.asarray, jrts.sort_pairs_rts(
            k, v, tile_rows=TILE)))
        res["ffx_pairs"] = tuple(map(np.asarray, jffx.sort_pairs_ffx(k, v)))
        res["rts_3ops"] = tuple(map(np.asarray, jrts._sort_rts((k, v, w),
                                                               TILE)))
        # one public case per variant, straight through the JAX router
        pub = jnp.asarray(_INPUTS["uniform20000"].view(np.float32))
        for variant in radix.PORTED:
            res["public", variant] = np.asarray(gst.sort(
                pub, order=gst.Order.DESCENDING, backend=gst.Backend.PALLAS,
                variant=variant, tile_rows=TILE))
        return res
    finally:
        jconfig.clear_routing_override()


@pytest.mark.parametrize("name", list(_INPUTS))
def test_rts_keys_match_jax(jax_engines, name):
    got = rts.sort_codes_rts(_t(_INPUTS[name]), tile_rows=TILE)
    np.testing.assert_array_equal(_u32(got), jax_engines["rts", name])


@pytest.mark.parametrize("name", list(_INPUTS))
def test_ffx_keys_match_jax(jax_engines, ffx_tile_128, name):
    got = ffx.sort_codes_ffx(_t(_INPUTS[name]))
    np.testing.assert_array_equal(_u32(got), jax_engines["ffx", name])


def test_rts_pairs_match_jax(jax_engines):
    """8-bit keys: long equal runs, so the payload shows stability."""
    sk, sv = rts.sort_pairs_rts(_t(_PAIR_KEYS), _raw(_PAIR_VALS),
                                tile_rows=TILE)
    wk, wv = jax_engines["rts_pairs"]
    np.testing.assert_array_equal(_u32(sk), wk)
    np.testing.assert_array_equal(sv.numpy().view(np.uint32), wv)


def test_ffx_pairs_match_jax(jax_engines, ffx_tile_128):
    sk, sv = ffx.sort_pairs_ffx(_t(_PAIR_KEYS), _raw(_PAIR_VALS))
    wk, wv = jax_engines["ffx_pairs"]
    np.testing.assert_array_equal(_u32(sk), wk)
    np.testing.assert_array_equal(sv.numpy().view(np.uint32), wv)


def test_rts_three_operands_match_jax(jax_engines):
    got = rts._sort_rts((_t(_PAIR_KEYS), _raw(_PAIR_VALS),
                         _raw(_PAIR_RIDE2)), TILE)
    want = jax_engines["rts_3ops"]
    np.testing.assert_array_equal(_u32(got[0]), want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), w)


@pytest.mark.parametrize("variant", radix.PORTED)
def test_public_pallas_matches_jax_router(jax_engines, ffx_tile_128,
                                          variant):
    keys = torch.from_numpy(_INPUTS["uniform20000"].view(np.float32).copy())
    got = gstt.sort(keys, order=gstt.Order.DESCENDING,
                    backend=gstt.Backend.PALLAS, variant=variant,
                    tile_rows=TILE)
    _eq(got, jax_engines["public", variant])


@pytest.mark.parametrize("tile_rows", [1, 3, 128])
def test_rts_any_tile(tile_rows):
    """The port takes any tile of at least one row (the JAX package's
    multiple-of-128 rule is a TPU placement rule)."""
    x = _INPUTS["e020_30000"]
    got = rts.sort_codes_rts(_t(x), tile_rows=tile_rows)
    np.testing.assert_array_equal(_u32(got), np.sort(x))
    for bad in (0, -1):
        with pytest.raises(ValueError, match="tile_rows"):
            rts._sort_rts((_t(x),), bad)
        with pytest.raises(ValueError, match="tile_rows"):
            rts.sort_codes_rts(_t(x), tile_rows=bad)
        with pytest.raises(ValueError, match="tile_rows"):
            gstt.sort(_t(x), backend=gstt.Backend.PALLAS,
                      variant="device_radix", tile_rows=bad)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_pad_tiles_aligns_offset_views(offset):
    """A whole number of tiles is only reshaped; an operand that is a view
    at an odd offset is copied, so every plane the kernels get starts
    16-byte aligned, and the engines sort such views."""
    n = 4 * 128
    big = _t(_INPUTS["uniform20000"][:n + offset])
    keys, ride = big[offset:], torch.arange(n + offset,
                                            dtype=torch.int32)[offset:]
    assert keys.data_ptr() % 16 and ride.data_ptr() % 16
    planes, got_n = rts.pad_tiles((keys, ride), 2)
    assert got_n == n and planes[0].shape == (4, 128)
    assert all(p.data_ptr() % 16 == 0 for p in planes)
    assert torch.equal(planes[0].reshape(-1), keys)
    assert torch.equal(planes[1].reshape(-1), ride)
    want = torch.sort(keys, stable=True)
    sk, sv = rts.sort_pairs_rts(keys, ride, tile_rows=2)
    assert torch.equal(sk, want.values)
    assert torch.equal(sv, ride[want.indices])


# ---- the public surface under PALLAS ----------------------------------------

_KEY_DT = {"uint32": (np.uint32, jnp.uint32), "int32": (np.int32, jnp.int32),
           "float32": (np.float32, jnp.float32)}
_SPECIALS = np.array([0x7FC00000, 0xFFC00000, 0, 0x80000000, 0x7F800000,
                      0xFF800000], np.uint32)
_ORDERS = [("ascending", gst.Order.ASCENDING, gstt.Order.ASCENDING),
           ("descending", gst.Order.DESCENDING, gstt.Order.DESCENDING)]


def _keys(kind, n, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, n, dtype=np.uint32)
    bits &= rng.integers(0, 2**32, n, dtype=np.uint32)
    bits[::5] = bits[0]                          # long equal runs
    bits[::97] = _SPECIALS[np.arange(bits[::97].size) % _SPECIALS.size]
    return bits.view(_KEY_DT[kind][0])


def _pair(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


@pytest.mark.parametrize("oname,jorder,torder", _ORDERS)
@pytest.mark.parametrize("kind", ["uint32", "int32", "float32"])
@pytest.mark.parametrize("variant", radix.PORTED)
def test_public_surface_matches_jax_oracle(small_ffx_tile, variant, kind,
                                           oname, jorder, torder):
    n = 5000
    jk, tk = _pair(_keys(kind, n, seed=len(kind)))
    pal = {"backend": gstt.Backend.PALLAS, "variant": variant,
           "tile_rows": 2}
    _eq(gstt.sort(tk, order=torder, **pal),
        gst.sort(jk, order=jorder, backend=gst.Backend.XLA))
    jv, tv = _pair(np.arange(n, dtype=np.uint32) * np.uint32(2654435761))
    ok, ov = gstt.sort_pairs(tk, tv, order=torder, **pal)
    ek, ev = gst.sort_pairs(jk, jv, order=jorder, backend=gst.Backend.XLA)
    assert ok.dtype == tk.dtype and ov.dtype == tv.dtype
    _eq(ok, ek)
    _eq(ov, ev)
    perm = gstt.argsort(tk, order=torder, **pal)
    assert perm.dtype == torch.int32
    _eq(perm, gst.argsort(jk, order=jorder, backend=gst.Backend.XLA))
    sk, sp = gstt.argsort(tk, order=torder, return_keys=True, **pal)
    _eq(sk, ek)
    _eq(sp, perm.numpy())
    # 64-bit payloads: as two planes, and as one int64 tensor
    rng = np.random.default_rng(4)
    lo = rng.integers(0, 2**32, n, dtype=np.uint32)
    hi = rng.integers(0, 2**32, n, dtype=np.uint32)
    wk, wlo, whi = gst.sort_pairs_wide(jk, jnp.asarray(lo), jnp.asarray(hi),
                                       order=jorder, backend=gst.Backend.XLA)
    gk, glo, ghi = gstt.sort_pairs_wide(tk, torch.from_numpy(lo),
                                        torch.from_numpy(hi), order=torder,
                                        **pal)
    assert glo.dtype == torch.uint32
    _eq(gk, wk)
    _eq(glo, wlo)
    _eq(ghi, whi)
    wide = (hi.astype(np.uint64) << 32 | lo).view(np.int64)
    want = (np.asarray(whi).astype(np.uint64) << 32 | np.asarray(wlo))
    k64, v64 = gstt.sort_pairs(tk, torch.from_numpy(wide), order=torder,
                               **pal)
    assert v64.dtype == torch.int64
    _eq(k64, wk)
    np.testing.assert_array_equal(v64.numpy(), want.view(np.int64))


@pytest.mark.parametrize("variant", radix.PORTED)
def test_sort_batched_pallas_matches_jax_oracle(small_ffx_tile, variant):
    S, L = 3, 700
    jk, tk = _pair(_keys("float32", S * L, seed=9).reshape(S, L))
    jv, tv = _pair(np.arange(S * L, dtype=np.int32).reshape(S, L))
    for _, jorder, torder in _ORDERS:
        pal = {"order": torder, "backend": gstt.Backend.PALLAS,
               "variant": variant, "tile_rows": 1}
        _eq(gstt.sort_batched(tk, **pal).reshape(-1),
            np.asarray(gst.sort_batched(jk, order=jorder)).reshape(-1))
        ok, ov = gstt.sort_batched(tk, tv, **pal)
        ek, ev = gst.sort_batched(jk, jv, order=jorder)
        _eq(ok.reshape(-1), np.asarray(ek).reshape(-1))
        _eq(ov.reshape(-1), np.asarray(ev).reshape(-1))


# ---- routing ----------------------------------------------------------------


def _boom(*a, **k):
    raise AssertionError("another engine was reached")


# the engine functions of the last two variants, as the JAX router maps them
_OWN = {"splitsweep": (splitsweep, ("sort_codes_splitsweep",
                                    "sort_stable_with_splitsweep")),
        "mergesweep": (mergesweep, ("sort_codes", "sort_codes_stable_with"))}


@pytest.mark.parametrize("variant", ["splitsweep", "mergesweep"])
def test_unported_variants_raise_and_reach_no_engine(monkeypatch, variant):
    """The two variants that raised NotImplementedError until they were
    ported: every entry point now reaches the variant's own engine, keys
    and rides alike, and no other engine (each patched to fail)."""
    for mod, name in ((rts, "_sort_rts"), (ffx, "_sort_ffx"),
                      (radix16, "_sort_radix16"),
                      (bitonic, "sort_network_i32"),
                      (kernels, "tile_histogram4"), (rts, "downsweep"),
                      (flat_sort, "sort_keys"), (flat_sort, "sort_pairs"),
                      (flat_sort, "sort_pairs_wide"),
                      (flat_sort, "sort_batched"),
                      (ops.rangesweep, "sort_codes_rangesweep")):
        monkeypatch.setattr(mod, name, _boom)
    other = "mergesweep" if variant == "splitsweep" else "splitsweep"
    for name in _OWN[other][1]:
        monkeypatch.setattr(_OWN[other][0], name, _boom)
    seen = []
    mod, names = _OWN[variant]
    for name in names:
        def spy(*a, _real=getattr(mod, name), _name=name, **kw):
            seen.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    keys = _keys("uint32", 300, seed=3)
    k = torch.from_numpy(keys)
    pal = {"backend": gstt.Backend.PALLAS, "variant": variant,
           "tile_rows": 1}
    np.testing.assert_array_equal(gstt.sort(k, **pal).numpy(), np.sort(keys))
    perm = np.argsort(keys, kind="stable")
    _, sv = gstt.sort_pairs(k, k, **pal)
    np.testing.assert_array_equal(sv.numpy(), keys[perm])
    _, sv = gstt.sort_pairs(k, k.view(torch.int32).long(), **pal)
    np.testing.assert_array_equal(sv.numpy(), keys.view(np.int32)[perm])
    _, slo, shi = gstt.sort_pairs_wide(k, k, k, **pal)
    np.testing.assert_array_equal(shi.numpy(), keys[perm])
    np.testing.assert_array_equal(gstt.argsort(k, **pal).numpy(), perm)
    np.testing.assert_array_equal(
        gstt.sort_batched(k.view(3, 100), **pal).numpy(),
        np.sort(keys.reshape(3, 100), axis=1))
    _, sv = gstt.sort_batched(k.view(3, 100), k.view(3, 100), **pal)
    np.testing.assert_array_equal(sv.numpy(),
                                  np.sort(keys.reshape(3, 100), axis=1))
    assert seen == [names[0]] + [names[1]] * 4 + [names[0]] * 3 + [
        names[1]] * 3


# each variant's engine core, as the JAX router maps it (an unknown name
# runs the network)
_ENGINE = {"device_radix": (rts, "_sort_rts"), "ffx": (ffx, "_sort_ffx"),
           "radix16": (radix16, "_sort_radix16"),
           "emulated_deadlocking": (radix16, "_sort_radix16"),
           "onesweep": (bitonic, "sort_network_i32"),
           "forward_sweep": (bitonic, "sort_network_i32"),
           "no_such_variant": (bitonic, "sort_network_i32")}


@pytest.mark.parametrize("variant", list(_ENGINE))
def test_ported_variants_reach_only_their_engine(monkeypatch, small_ffx_tile,
                                                 variant):
    for other in set(_ENGINE.values()) - {_ENGINE[variant]}:
        monkeypatch.setattr(*other, _boom)
    for name in ("sort_keys", "sort_pairs", "sort_pairs_wide",
                 "sort_batched"):
        monkeypatch.setattr(flat_sort, name, _boom)
    seen = []
    if _ENGINE[variant][0] is radix16:
        real = radix16._sort_radix16

        def spy(operands, tile_rows, segments=None):
            seen.append(segments)
            return real(operands, tile_rows, segments)

        monkeypatch.setattr(radix16, "_sort_radix16", spy)
    keys = _keys("uint32", 3000, seed=2)
    tk = torch.from_numpy(keys)
    pal = {"backend": gstt.Backend.PALLAS, "variant": variant,
           "tile_rows": 2}
    np.testing.assert_array_equal(gstt.sort(tk, **pal).numpy(),
                                  np.sort(keys))
    perm = gstt.argsort(tk, **pal)
    np.testing.assert_array_equal(perm.numpy(),
                                  np.argsort(keys, kind="stable"))
    if variant == "emulated_deadlocking":     # 12 tiles of 2 rows
        assert seen == [radix16.adversarial_segments(3000, 2)] * 2 == [
            (1, 4, 6, 11)] * 2
    elif variant == "radix16":
        assert seen == [None, None]
