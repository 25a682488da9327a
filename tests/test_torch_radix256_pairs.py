"""The 8-bit-digit radix sort's pairs form (ops/radix256.py `sort_pairs`) on
the CPU: its plain version against numpy's stable order and the JAX
package's `sort_pairs`, bit for bit, over every 32-bit key and payload
type; the route AUTO gives it (core/config.py `radix256_min_pairs`); and
the public `sort_pairs` and `argsort` through it under the card's row.

`sort_pairs_plain` is what the wrapper runs for a CPU pair and what the
card's kernels (csrc/binning256.cu) are held to in tests/test_torch_cuda.py
and chip_smoke.py.  The JAX package has no 8-bit-digit engine, so the sort
is held to its flat `sort_pairs`, which orders by the same u32 codes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpusorting_tpu as gst
import gpusorting_tpu_torch as gstt
from gpusorting_tpu_torch import ops
from gpusorting_tpu_torch.core import config
from gpusorting_tpu_torch.ops import flat_sort, radix256
from gpusorting_tpu_torch.utils import trace

PART = 512 * 16          # the pairs pass's partition (csrc/binning256.cu)
RAGGED = 3 * PART + 517
DTYPES = ["u32", "i32", "f32"]
_NP = {"u32": np.uint32, "i32": np.int32, "f32": np.float32}
_TORCH = {"u32": torch.uint32, "i32": torch.int32, "f32": torch.float32}
_SPECIALS = np.array([0x7FC00000, 0xFFC00001, 0x00000000, 0x80000000,
                      0x7F800000, 0xFF800000, 0x7FFFFFFF, 0xFFFFFFFF,
                      0x00000001, 0x80000001, 0x7FA00001], np.uint32)
_H100 = config.DeviceInfo("cuda", "NVIDIA H100 80GB HBM3", "h100", 1,
                          80 << 30, 3350.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _keys(n: int, kind: str, seed: int) -> np.ndarray:
    """n u32 key bit patterns: uniform, E020 (4 more ANDed draws) or all
    equal, with NaN, +-0 and +-inf patterns every 97th."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    if kind == "e020":
        for _ in range(4):
            x &= rng.integers(0, 2**32, n, dtype=np.uint32)
    elif kind == "equal":
        x[:] = 0xDEADBEEF
    if kind != "equal":
        x[::97] = _SPECIALS[np.arange(x[::97].size) % _SPECIALS.size]
    return x


def _payload(n: int, seed: int) -> np.ndarray:
    """n distinct payload bit patterns (so any reordering of ties shows),
    NaN patterns among them: the index's bits with the top bits set every
    other slot, which makes half of them NaN as f32."""
    idx = np.arange(n, dtype=np.uint32)
    return np.where(idx % 2 == 1, idx | np.uint32(0x7F800000 + (seed & 1)),
                    idx)


def _codes(bits: np.ndarray, dt: str) -> np.ndarray:
    """numpy's u32 codes of raw bits (core/codec.py's bijections)."""
    if dt == "u32":
        return bits
    if dt == "i32":
        return bits ^ np.uint32(0x80000000)
    neg = (bits >> 31).astype(bool)
    return np.where(neg, ~bits, bits | np.uint32(0x80000000))


def _torch(bits: np.ndarray, dt: str) -> torch.Tensor:
    return torch.from_numpy(bits.copy()).view(_TORCH[dt])


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


def _np_pairs(keys: np.ndarray, vals: np.ndarray, dt: str):
    order = np.argsort(_codes(keys, dt), kind="stable")
    return keys[order], vals[order]


_SIZES = [(0, "uniform"), (1, "uniform"), (PART - 1, "uniform"),
          (PART + 3, "uniform"), (RAGGED, "uniform"), (RAGGED, "e020"),
          (PART + 3, "equal"), (RAGGED, "equal")]


@pytest.mark.parametrize("vt", DTYPES)
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("n,kind", _SIZES)
def test_plain_pairs_match_numpy(dt, vt, n, kind):
    """Keys and payloads in numpy's stable order by the keys' codes, both
    dtypes kept, the payload's NaN patterns moved as they are; ties
    (E020, all-equal) keep their input order."""
    keys, vals = _keys(n, kind, n + 7), _payload(n, n)
    gk, gv = radix256.sort_pairs_plain(_torch(keys, dt), _torch(vals, vt))
    assert gk.dtype == _TORCH[dt] and gv.dtype == _TORCH[vt]
    assert gk.shape == gv.shape == (n,)
    wk, wv = _np_pairs(keys, vals, dt)
    assert np.array_equal(_u32(gk), wk)
    assert np.array_equal(_u32(gv), wv)


@pytest.mark.parametrize("vt", DTYPES)
@pytest.mark.parametrize("dt", DTYPES)
def test_plain_pairs_match_jax_sort_pairs(dt, vt):
    """The plain pairs sort, both orders (descending as the public route
    flips it), against the JAX package's flat sort_pairs, bit for bit."""
    keys, vals = _keys(RAGGED, "e020", 41), _payload(RAGGED, 1)
    gk, gv = radix256.sort_pairs_plain(_torch(keys, dt), _torch(vals, vt))
    for jorder in (gst.Order.ASCENDING, gst.Order.DESCENDING):
        jk, jv = gst.sort_pairs(jnp.asarray(keys.view(_NP[dt])),
                                jnp.asarray(vals.view(_NP[vt])),
                                order=jorder, backend=gst.Backend.XLA)
        if jorder == gst.Order.DESCENDING:
            gk, gv = (t.view(torch.int32).flip(0).view(t.dtype)
                      for t in (gk, gv))
        assert np.array_equal(_u32(gk), np.asarray(jk).view(np.uint32))
        assert np.array_equal(_u32(gv), np.asarray(jv).view(np.uint32))


def test_plain_pairs_agree_with_plain_keys():
    """The pairs form's keys are the keys-only sort's, and an index payload
    is the stable argsort."""
    keys = _torch(_keys(RAGGED, "e020", 5), "f32")
    idx = torch.arange(RAGGED, dtype=torch.int32)
    gk, gv = radix256.sort_pairs_plain(keys, idx)
    assert torch.equal(gk.view(torch.int32),
                       radix256.sort_plain(keys).view(torch.int32))
    assert torch.equal(gv, torch.argsort(
        radix256._codes(keys), stable=True).to(torch.int32))


def test_sort_pairs_refuses_bad_input():
    k = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="1-D"):
        radix256.sort_pairs(k.view(2, 2), k.view(2, 2))
    with pytest.raises(ValueError, match="32-bit"):
        radix256.sort_pairs(k, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="32-bit"):
        radix256.sort_pairs(k, torch.zeros(5, dtype=torch.int32))
    with pytest.raises(TypeError):
        radix256.sort_pairs(torch.zeros(4, dtype=torch.int64), k)


def test_auto_engine_at_and_below_radix256_min_pairs():
    """PAIRS with a 32-bit payload takes radix256 from the row's
    `radix256_min_pairs` up to RADIX256_MAX_N and the flat sort one below
    it; 64-bit payloads and argsort's index stay on the flat sort; a row
    with rangesweep's pairs threshold keeps rangesweep from it."""
    P = config.Mode.PAIRS
    m = config.get_routing_parameters(_H100).radix256_min_pairs
    assert m is not None
    for n in (m, m + 1, 1 << 26, config.RADIX256_MAX_N):
        assert config.auto_engine(n, P, info=_H100) == "radix256", n
        assert config.auto_engine(n, P, payload_bits=64,
                                  info=_H100) == "xla"
        assert config.auto_engine(n, P, index_payload=True,
                                  info=_H100) == "xla"
    assert config.auto_engine(m - 1, P, info=_H100) == "xla"
    assert config.auto_engine(config.RADIX256_MAX_N + 1, P,
                              info=_H100) == "xla"
    assert config.auto_engine(m, P, info=config.get_device_info(
        "cpu")) == "xla"
    config.set_routing_override(config.RoutingParameters(
        radix256_min_pairs=1 << 10, rangesweep_min_pairs=1 << 20))
    try:
        assert config.auto_engine((1 << 20) - 1, P,
                                  info=_H100) == "radix256"
        assert config.auto_engine(1 << 20, P, info=_H100) == "rangesweep"
        assert config.auto_engine(1 << 20, info=_H100) == "xla"
    finally:
        config.clear_routing_override()


@pytest.fixture
def h100_row(monkeypatch):
    """The public entry points route CPU tensors as on the card's row (the
    plain versions then run)."""
    monkeypatch.setattr(ops, "get_device_info", lambda device=None: _H100)


def _spans():
    c = trace.counts()
    return {k: c.get(k, 0) for k in ("engine.radix256", "engine.flat")}


@pytest.mark.parametrize("dt,vt", [("u32", "u32"), ("i32", "f32"),
                                   ("f32", "i32")])
def test_public_sort_pairs_through_the_route(h100_row, dt, vt):
    """gstt.sort_pairs on the card's row at RAGGED pairs: one
    `engine.radix256` span and no `engine.flat` a call, both orders equal
    to the flat sort; the flat backend never takes the route."""
    keys = _torch(_keys(RAGGED, "e020", 9), dt)
    vals = _torch(_payload(RAGGED, 0), vt)
    for order in (gstt.Order.ASCENDING, gstt.Order.DESCENDING):
        before = _spans()
        gk, gv = gstt.sort_pairs(keys, vals, order=order)
        after = _spans()
        assert after["engine.radix256"] == before["engine.radix256"] + 1
        assert after["engine.flat"] == before["engine.flat"]
        wk, wv = flat_sort.sort_pairs(keys, vals, order=order)
        assert gk.dtype == wk.dtype and gv.dtype == wv.dtype
        assert torch.equal(gk.view(torch.int32), wk.view(torch.int32))
        assert torch.equal(gv.view(torch.int32), wv.view(torch.int32))
    before = _spans()
    gstt.sort_pairs(keys, vals, backend=gstt.Backend.XLA)
    assert _spans()["engine.radix256"] == before["engine.radix256"]


def test_public_argsort_through_the_route(h100_row):
    """argsort reaches the route through sort_pairs with its int32 index:
    one `engine.radix256` span a call, the permutation and keys equal to
    the flat route's."""
    keys = _torch(_keys(RAGGED, "equal", 3), "f32")
    keys[::5] = -0.0
    for order in (gstt.Order.ASCENDING, gstt.Order.DESCENDING):
        before = _spans()
        k, perm = gstt.argsort(keys, order=order, return_keys=True)
        assert _spans()["engine.radix256"] == before["engine.radix256"] + 1
        wk, wperm = gstt.argsort(keys, order=order, return_keys=True,
                                 backend=gstt.Backend.XLA)
        assert perm.dtype == torch.int32
        assert torch.equal(perm, wperm)
        assert torch.equal(k.view(torch.int32), wk.view(torch.int32))


def test_wide_pairs_and_batched_stay_flat(h100_row):
    """On the card's row a 64-bit payload, sort_pairs_wide and sort_batched
    take the flat sort, never the pairs kernel."""
    keys = _torch(_keys(PART + 3, "uniform", 13), "u32")
    wide = torch.arange(PART + 3, dtype=torch.int64) * 3
    before = _spans()
    gstt.sort_pairs(keys, wide)
    gstt.sort_pairs_wide(keys, wide.to(torch.int32), wide.to(torch.int32))
    gstt.sort_batched(keys.view(1, -1), wide.to(torch.int32).view(1, -1))
    after = _spans()
    assert after["engine.radix256"] == before["engine.radix256"]
    assert after["engine.flat"] == before["engine.flat"] + 3
