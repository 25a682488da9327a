"""Port parity: the public surface of gpusorting_tpu_torch against
gpusorting_tpu on the CPU, the AUTO routing gate, and the package's
independence from JAX.

A CPU tensor always takes the flat route.  The slice as a whole — the
public entry points through the range-exchange engine — is driven on the
CPU by handing the entry points a CUDA `DeviceInfo` with a routing
override, so AUTO picks rangesweep and the relocate wrapper takes its
plain version; its outputs must equal the JAX package's bit for bit.
"""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpusorting_tpu as gst
import gpusorting_tpu_torch as gstt
from gpusorting_tpu.ops import xla_sort as jflat
from gpusorting_tpu.utils import validate as jvalidate
from gpusorting_tpu_torch import ops
from gpusorting_tpu_torch.core import config
from gpusorting_tpu_torch.ops import flat_sort, relocate
from gpusorting_tpu_torch.utils import timing, validate

_KEY_DT = {"uint32": (np.uint32, jnp.uint32), "int32": (np.int32, jnp.int32),
           "float32": (np.float32, jnp.float32)}
_SPECIALS = np.array([0x7FC00000, 0xFFC00000, 0, 0x80000000, 0x7F800000,
                      0xFF800000], np.uint32)

_CUDA_INFO = config.DeviceInfo(platform="cuda", device_kind="test card",
                               generation="cuda", num_devices=1,
                               hbm_bytes=0, hbm_gbps=0.0)


def _keys(kind, n, seed=1, low_entropy=True):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, n, dtype=np.uint32)
    if low_entropy:
        bits &= rng.integers(0, 2**32, n, dtype=np.uint32)
        bits[::5] = bits[0]                      # long equal runs
    bits[::97] = _SPECIALS[np.arange(bits[::97].size) % _SPECIALS.size]
    return bits.view(_KEY_DT[kind][0])


def _pair(a):
    """numpy -> (jax array, torch tensor) of the same bits."""
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def _eq(t: torch.Tensor, j) -> None:
    want = np.asarray(j)
    got = t.view(torch.int32 if t.dtype.itemsize == 4 else torch.int64)
    np.testing.assert_array_equal(got.numpy(),
                                  want.view(got.numpy().dtype))


_ORDERS = [("ascending", gst.Order.ASCENDING, gstt.Order.ASCENDING),
           ("descending", gst.Order.DESCENDING, gstt.Order.DESCENDING)]


@pytest.fixture(params=["flat", "rangesweep"])
def route(request, monkeypatch):
    """flat: AUTO on a CPU tensor.  rangesweep: AUTO handed a CUDA device
    info and a row sending every size at or above 2048 to rangesweep with
    small chunks (K > 64 at n = 20_000 runs the hierarchical cuts)."""
    if request.param == "rangesweep":
        monkeypatch.setattr(ops, "get_device_info", lambda dev: _CUDA_INFO)
        config.set_routing_override(config.RoutingParameters(
            rangesweep_min=2048, rangesweep_min_pairs=2048,
            rangesweep_min_pairs_wide=2048, rangesweep_min_index=2048,
            rangesweep_seg_elems=256, rangesweep_seg_elems_pairs=256,
            rangesweep_seg_elems_pairs_wide=512,
            rangesweep_seg_elems_index=256))
    yield request.param
    config.clear_routing_override()


@pytest.mark.parametrize("oname,jorder,torder", _ORDERS)
@pytest.mark.parametrize("kind", ["uint32", "int32", "float32"])
def test_sort_and_pairs(route, kind, oname, jorder, torder):
    n = 20_000
    jk, tk = _pair(_keys(kind, n))
    jv, tv = _pair(np.arange(n, dtype=np.uint32) * np.uint32(7))
    before = relocate.relocate.launches
    _eq(gstt.sort(tk, order=torder), gst.sort(jk, order=jorder))
    ok, ov = gstt.sort_pairs(tk, tv, order=torder)
    ek, ev = gst.sort_pairs(jk, jv, order=jorder)
    assert ok.dtype == tk.dtype and ov.dtype == tv.dtype
    _eq(ok, ek)
    _eq(ov, ev)
    perm = gstt.argsort(tk, order=torder)
    assert perm.dtype == torch.int32
    _eq(perm, gst.argsort(jk, order=jorder))
    sk, sp = gstt.argsort(tk, order=torder, return_keys=True)
    _eq(sk, ek)
    _eq(sp, perm.numpy())
    assert relocate.relocate.launches == before   # CPU: plain version only


@pytest.mark.parametrize("oname,jorder,torder", _ORDERS)
@pytest.mark.parametrize("kind", ["uint32", "float32"])
def test_wide_payloads(route, kind, oname, jorder, torder):
    n = 9000
    jk, tk = _pair(_keys(kind, n, seed=3))
    rng = np.random.default_rng(4)
    lo = rng.integers(0, 2**32, n, dtype=np.uint32)
    hi = rng.integers(0, 2**32, n, dtype=np.uint32)
    ek, elo, ehi = gst.sort_pairs_wide(jk, jnp.asarray(lo), jnp.asarray(hi),
                                       order=jorder)
    ok, olo, ohi = gstt.sort_pairs_wide(tk, torch.from_numpy(lo),
                                        torch.from_numpy(hi), order=torder)
    assert olo.dtype == torch.uint32
    _eq(ok, ek)
    _eq(olo, elo)
    _eq(ohi, ehi)
    wide = (hi.astype(np.uint64) << 32 | lo)
    want = (np.asarray(ehi).astype(np.uint64) << 32 | np.asarray(elo))
    for dt in (torch.int64, torch.float64):
        wk, wv = gstt.sort_pairs(tk, torch.from_numpy(wide.view(np.int64))
                                 .view(dt), order=torder)
        assert wv.dtype == dt
        _eq(wk, ek)
        np.testing.assert_array_equal(wv.view(torch.int64).numpy(),
                                      want.view(np.int64))


@pytest.mark.parametrize("oname,jorder,torder", _ORDERS)
@pytest.mark.parametrize("kind", ["uint32", "int32", "float32"])
def test_sort_batched(kind, oname, jorder, torder):
    S, L = 6, 700
    jk, tk = _pair(_keys(kind, S * L, seed=5).reshape(S, L))
    jv, tv = _pair(np.arange(S * L, dtype=np.float32).reshape(S, L))
    _eq(gstt.sort_batched(tk, order=torder).reshape(-1),
        gst.sort_batched(jk, order=jorder).reshape(-1))
    ok, ov = gstt.sort_batched(tk, tv, order=torder)
    ek, ev = gst.sort_batched(jk, jv, order=jorder)
    _eq(ok.reshape(-1), np.asarray(ek).reshape(-1))
    _eq(ov.reshape(-1), np.asarray(ev).reshape(-1))


@pytest.mark.parametrize("with_values", [False, True])
def test_segmented_sort_pairs(with_values):
    n = 5000
    keys = _keys("float32", n, seed=6)
    offs = np.array([0, 3, 3, 100, 1000, 4096, 4999], np.uint32)
    vals = np.arange(n, dtype=np.int32) if with_values else None
    want = jflat.segmented_sort_pairs(
        jnp.asarray(offs), jnp.asarray(keys),
        None if vals is None else jnp.asarray(vals))
    got = flat_sort.segmented_sort_pairs(
        torch.from_numpy(offs), torch.from_numpy(keys),
        None if vals is None else torch.from_numpy(vals))
    if with_values:
        _eq(got[0], want[0])
        _eq(got[1], want[1])
    else:
        _eq(got, want)


def test_validators_match_jax():
    n = 4000
    keys = _keys("float32", n, seed=7)
    for arr in (keys, np.sort(keys.view(np.int32)).view(np.float32)):
        jk, tk = _pair(arr)
        assert int(validate.count_order_violations(tk)) == int(
            jvalidate.count_order_violations(jk))
        assert int(validate.count_pair_violations(tk, tk)) == int(
            jvalidate.count_pair_violations(jk, jk))
        offs = np.array([0, 10, 2000], np.uint32)
        assert int(validate.count_segmented_violations(
            torch.from_numpy(offs), tk)) == int(
            jvalidate.count_segmented_violations(jnp.asarray(offs), jk))
    sk, sv = gstt.sort_pairs(torch.from_numpy(keys),
                             torch.from_numpy(keys.view(np.int32).astype(
                                 np.int64) & 0xFFFFFFFF))
    assert int(validate.count_pair_violations(sk, sv)) == 0
    a = torch.from_numpy(keys)
    assert int(validate.identical(a, a.clone())) == 0
    with pytest.raises(ValueError):
        validate.identical(a, a.view(torch.int32))


def test_public_errors():
    k = torch.zeros(8, dtype=torch.uint32)
    with pytest.raises(ValueError):
        gstt.sort(k.view(2, 4))
    with pytest.raises(ValueError):
        gstt.sort_pairs(k, torch.zeros(7, dtype=torch.uint32))
    with pytest.raises(ValueError):
        gstt.sort_batched(k)
    with pytest.raises(TypeError):
        gstt.sort_pairs_wide(k, k.view(torch.int32).long(),
                             k.view(torch.int32).long())
    # the last two PALLAS variants sort (they raised NotImplementedError
    # until they were ported) and keep the shape errors
    for variant in ("splitsweep", "mergesweep"):
        pal = {"backend": gstt.Backend.PALLAS, "variant": variant}
        assert torch.equal(gstt.sort(k, **pal), k)
        assert torch.equal(gstt.argsort(k, **pal),
                           torch.arange(8, dtype=torch.int32))
        assert torch.equal(gstt.sort_batched(k.view(2, 4), **pal),
                           k.view(2, 4))
        with pytest.raises(ValueError):
            gstt.sort(k.view(2, 4), **pal)
        with pytest.raises(ValueError):
            gstt.sort_pairs(k, torch.zeros(7, dtype=torch.uint32), **pal)


# ---- routing ---------------------------------------------------------------


def test_auto_gate_cpu_always_flat():
    cpu = config.get_device_info("cpu")
    assert cpu.platform == "cpu"
    config.set_routing_override(config.RoutingParameters(
        rangesweep_min=1, rangesweep_min_pairs=1,
        rangesweep_min_pairs_wide=1, rangesweep_min_index=1))
    try:
        for kw in ({}, {"mode": config.Mode.PAIRS},
                   {"mode": config.Mode.PAIRS, "payload_bits": 64},
                   {"mode": config.Mode.PAIRS, "index_payload": True}):
            assert config.auto_engine(1 << 30, info=cpu, **kw) == "xla"
    finally:
        config.clear_routing_override()


def test_auto_gate_cuda_row_and_override():
    h100 = dataclasses.replace(_CUDA_INFO, generation="h100")
    row = config.get_routing_parameters(h100)
    assert row.measured is True
    # the card's measured row: the flat sort wins at every size swept, so
    # every crossover is None and AUTO never takes rangesweep there
    assert (row.rangesweep_min, row.rangesweep_min_pairs,
            row.rangesweep_min_pairs_wide, row.rangesweep_min_index) == (
        None, None, None, None)
    assert row.rangesweep_min_pairs_nonpow2 is None
    assert row.rangesweep_seg_elems == 1 << 22
    # keys-only sorts from the row's radix256_min take the 8-bit-digit
    # radix sort; every mode with a payload stays on the flat sort
    assert config.auto_engine(1 << 28, info=h100) == "radix256"
    assert config.auto_engine((1 << 28) - 1, info=h100) == "radix256"
    assert config.auto_engine(row.radix256_min - 1, info=h100) == "xla"
    assert config.auto_engine(1 << 28, config.Mode.PAIRS, payload_bits=64,
                              info=h100) == "xla"
    # a card without a row keeps every route off ...
    assert config.auto_engine(1 << 30, info=_CUDA_INFO) == "xla"
    # ... until an override is installed
    config.set_routing_override(config.RoutingParameters(
        rangesweep_min=4096, rangesweep_min_pairs=1 << 20,
        rangesweep_min_pairs_nonpow2=3 << 10, rangesweep_min_index=100))
    try:
        assert config.auto_engine(4096, info=_CUDA_INFO) == "rangesweep"
        assert config.auto_engine(4095, info=_CUDA_INFO) == "xla"
        P = config.Mode.PAIRS
        assert config.auto_engine(3 << 10, P, info=_CUDA_INFO) == "rangesweep"
        assert config.auto_engine(4096, P, info=_CUDA_INFO) == "xla"
        assert config.auto_engine(100, P, info=_CUDA_INFO,
                                  index_payload=True) == "rangesweep"
        assert config.auto_engine(1 << 30, P, payload_bits=64,
                                  info=_CUDA_INFO) == "xla"
    finally:
        config.clear_routing_override()


# The "h100" rows as measured on the card (core/config.py, PERF.md).
_H100_TUNING = {
    config.Mode.KEYS_ONLY: {"partition_rows": 128, "radix_tile_rows": 128,
                            "network_smem_bytes": 232448, "measured": True},
    config.Mode.PAIRS: {"partition_rows": 256, "radix_tile_rows": 256,
                        "network_smem_bytes": 232448, "measured": True},
}
_H100_ROUTING = {
    "rangesweep_min": None, "rangesweep_seg_elems": 1 << 22,
    "rangesweep_min_pairs": None, "rangesweep_seg_elems_pairs": 1 << 22,
    "rangesweep_min_pairs_nonpow2": None,
    "rangesweep_min_pairs_wide": None,
    "rangesweep_seg_elems_pairs_wide": 1 << 23,
    "rangesweep_min_index": None, "rangesweep_seg_elems_index": 1 << 23,
    "mergesweep_seg_elems": 1 << 27, "ffx_tile_rows": 256,
    "window_max_keys": 0, "window_max_fused": 0, "window_max_pairs": 0,
    "segsort_bulk_max": 4096, "segsort_padded_max": 131072,
    "segsort_extract_max_frac": 0.0, "radix256_min": 1 << 11,
    "radix256_min_pairs": 1, "segsort_tile_max": 8192, "measured": True,
}


def test_h100_rows_hold_their_measured_fields():
    """Every field of both "h100" rows at the value its card run installed,
    and AUTO's route on the card at the swept sizes (2^28, 2^29), one
    below each and a non-power of two between them, in all four modes:
    keys and pairs with a 32-bit payload take the 8-bit-digit radix sort
    from their measured thresholds (and the flat sort just below them);
    64-bit pairs and argsort's index the flat sort everywhere."""
    h100 = dataclasses.replace(_CUDA_INFO, generation="h100")
    for mode, want in _H100_TUNING.items():
        assert dataclasses.asdict(config.get_tuning_parameters(
            h100, mode)) == want
    assert dataclasses.asdict(config.get_routing_parameters(h100)) == (
        _H100_ROUTING)
    P = config.Mode.PAIRS
    m = _H100_ROUTING["radix256_min"]
    mp = _H100_ROUTING["radix256_min_pairs"]
    for n in (1 << 28, (1 << 28) - 1, 3 << 27, 1 << 29, (1 << 29) - 1, m,
              mp):
        assert config.auto_engine(n, info=h100) == (
            "radix256" if n >= m else "xla"), n
        assert config.auto_engine(n, mode=P, info=h100) == "radix256", n
        for kw in ({"mode": P, "payload_bits": 64},
                   {"mode": P, "index_payload": True}):
            assert config.auto_engine(n, info=h100, **kw) == "xla", (n, kw)
    assert config.auto_engine(m - 1, info=h100) == "xla"
    assert config.auto_engine(mp - 1, mode=P, info=h100) == "xla"


def test_auto_engine_agrees_with_jax_on_its_rows():
    """With the JAX row converted by routing_from_jax_fields, the port's
    decision on a CUDA device equals the JAX decision on a TPU."""
    from gpusorting_tpu.core import config as jconfig

    jrow = jconfig._ROUTING_TABLE["v5e"]
    row = config.routing_from_jax_fields(dataclasses.asdict(jrow))
    assert row.rangesweep_min == jrow.rangesweep_min
    assert (row.rangesweep_min_pairs_nonpow2
            == jrow.rangesweep_min_pairs_nonpow2)
    tpu = jconfig.DeviceInfo(platform="tpu", device_kind="TPU v5 lite",
                             generation="v5e", num_devices=1,
                             hbm_bytes=0, vmem_bytes=0, hbm_gbps=0.0)
    config.set_routing_override(row)
    try:
        for n in (1 << 24, 1 << 25, 3 << 25, 1 << 26, (1 << 27) - 1, 1 << 27,
                  (1 << 27) + 5):
            for mode, kw in ((config.Mode.KEYS_ONLY, {}),
                             (config.Mode.PAIRS, {}),
                             (config.Mode.PAIRS, {"payload_bits": 64}),
                             (config.Mode.PAIRS, {"index_payload": True})):
                jmode = jconfig.Mode(mode.value)
                assert config.auto_engine(n, mode, info=_CUDA_INFO, **kw) \
                    == jconfig.auto_engine(n, jmode, info=tpu, **kw)
    finally:
        config.clear_routing_override()


def test_timing_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA"):
        timing.device_time_ms(lambda: None, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        timing.batch_timing(lambda k: k, 16, device="cpu")


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither jax nor the JAX
    package, nor its entry script (checked in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import gpusorting_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib', 'gpusorting_tpu.'))\n"
        "             or m in ('gpusorting_tpu', '__graft_entry__'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
