"""Port parity for the live-card tuner, `gpusorting_tpu_torch/utils/
autotune.py` against `gpusorting_tpu/utils/autotune.py`.

Timing needs a CUDA card, so on the CPU each function must refuse.  The
selection rules are held against the JAX package's by stubbing both
packages' `_timed` (monkeypatch only) with one scripted list of rates, so
both see the same measurements in the same order; the port's two recorded
differences (no mapped-row crossovers; a losing pairs sweep also turns off
the non-power-of-two pairs band) have their own cases.  One case runs every
cell the port's sweeps build, once each, on CPU codes, and holds each
output against a stable torch.sort: the pairs cells carry an independent
payload plane.
"""

import numpy as np
import pytest
import torch

import gpusorting_tpu as gst
import gpusorting_tpu_torch as gstt
from gpusorting_tpu.utils import autotune as jautotune
from gpusorting_tpu_torch.core import codec, config, prng
from gpusorting_tpu_torch.utils import autotune

CPU_INFO = config.get_device_info("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops; one intra-op thread
    keeps them fast when several test processes share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_overrides():
    yield
    config.clear_tuning_overrides()
    config.clear_routing_override()
    gst.clear_tuning_overrides()
    gst.clear_routing_override()


def _script(monkeypatch, rates, jax_prefix=()):
    """Stub both packages' `_timed` with the same rates, in call order;
    the JAX stub first yields `jax_prefix` (cells the port has no twin
    of)."""
    port_rates = iter(rates)
    jax_rates = iter(tuple(jax_prefix) + tuple(rates))
    monkeypatch.setattr(autotune, "_timed",
                        lambda *a, **k: {"keys_per_sec": next(port_rates)})
    monkeypatch.setattr(jautotune, "_timed",
                        lambda *a, **k: {"keys_per_sec": next(jax_rates)})


@pytest.mark.parametrize("fn,kw", [
    (autotune.autotune, {"n": 1 << 12}),
    (autotune.autotune, {"n": 1 << 12, "mode": config.Mode.PAIRS,
                         "engine": "rts"}),
    (autotune.autotune_routing, {"n": 1 << 12, "window_candidates": (64,)}),
    (autotune.autotune_rangesweep, {"n_max": 1 << 12}),
])
def test_refuses_the_cpu(fn, kw):
    with pytest.raises(RuntimeError, match="timing needs a CUDA device"):
        fn(device="cpu", **kw)


# per mode: flat@n_max, rs@seg 2^22, rs@seg 2^21, then, if the engine won,
# flat@3n/4, rs@3n/4, flat@n/2, rs@n/2
_BRACKETS = {
    "lose": ((10, 5, 6), None, 1 << 21),
    "win_n_max_only": ((10, 12, 11, 10, 9, 10, 9), "n_max", 1 << 22),
    "win_non_pow2": ((10, 11, 12, 10, 11, 10, 9), "half+1", 1 << 21),
    "win_both": ((10, 12, 11, 10, 11, 10, 11), "half", 1 << 22),
}


@pytest.mark.parametrize("keys,pairs", [
    ("lose", "win_both"), ("win_n_max_only", "win_non_pow2"),
    ("win_non_pow2", "lose"), ("win_both", "win_n_max_only")])
def test_rangesweep_picks_match_jax(monkeypatch, keys, pairs):
    n_max = 1 << 12
    want = {"n_max": n_max, "half+1": n_max // 2 + 1, "half": n_max // 2,
            None: None}
    _script(monkeypatch, _BRACKETS[keys][0] + _BRACKETS[pairs][0])
    p, sweep = autotune.autotune_rangesweep(n_max=n_max, device="cpu")
    j, jsweep = jautotune.autotune_rangesweep(n_max=n_max)
    assert (p.rangesweep_min, p.rangesweep_seg_elems) == (
        want[_BRACKETS[keys][1]], _BRACKETS[keys][2])
    assert (p.rangesweep_min_pairs, p.rangesweep_seg_elems_pairs) == (
        want[_BRACKETS[pairs][1]], _BRACKETS[pairs][2])
    for f in ("rangesweep_min", "rangesweep_seg_elems",
              "rangesweep_min_pairs", "rangesweep_seg_elems_pairs",
              "measured"):
        assert getattr(p, f) == getattr(j, f), f
    assert sweep == jsweep
    assert p.measured


@pytest.mark.parametrize("pairs", ["lose", "win_both"])
def test_losing_pairs_sweep_turns_off_the_non_pow2_band(monkeypatch, pairs):
    """The recorded difference: JAX keeps the row's non-pow2 pairs band
    after a losing pairs sweep; the port turns it off with the rest."""
    band = 3 << 25
    config.set_routing_override(config.RoutingParameters(
        rangesweep_min_pairs_nonpow2=band))
    gst.set_routing_override(gst.RoutingParameters(
        rangesweep_min_pairs_nonpow2=band))
    _script(monkeypatch, _BRACKETS["win_both"][0] + _BRACKETS[pairs][0])
    p, _ = autotune.autotune_rangesweep(n_max=1 << 12, device="cpu")
    j, _ = jautotune.autotune_rangesweep(n_max=1 << 12)
    assert j.rangesweep_min_pairs_nonpow2 == band
    assert p.rangesweep_min_pairs_nonpow2 == (None if pairs == "lose"
                                              else band)
    assert p.rangesweep_min_pairs == j.rangesweep_min_pairs


@pytest.mark.parametrize("rates,cap", [
    ((5, 4, 3, 4, 3, 4), 64),           # the window wins at 64 only
    ((5, 4, 3, 4, 5, 4), 256),          # the largest winning length
    ((3, 4, 3, 4, 3, 4), None),         # the composite wins everywhere
])
def test_routing_window_cap_matches_jax(monkeypatch, rates, cap):
    base = 4096
    config.set_routing_override(config.RoutingParameters(
        window_max_pairs=base))
    gst.set_routing_override(gst.RoutingParameters(window_max_pairs=base))
    # JAX first sweeps the mapped-row crossovers: keys, then pairs, one
    # (batched, mapped) pair each at its one candidate
    _script(monkeypatch, rates, jax_prefix=(1, 2, 1, 2))
    wins = (64, 128, 256)
    p, sweep = autotune.autotune_routing(n=1 << 12, window_candidates=wins,
                                         device="cpu")
    j, jsweep = jautotune.autotune_routing(
        n=1 << 12, map_candidates=(1 << 10,), window_candidates=wins)
    assert p.window_max_pairs == j.window_max_pairs == (cap or base)
    assert sweep == {"window_pairs": jsweep["window_pairs"]}
    assert p.measured


def test_tile_pick_is_the_argmax_and_installs(monkeypatch):
    before = config.get_tuning_parameters(CPU_INFO, config.Mode.PAIRS)
    _script(monkeypatch, (3.0, 7.0, 5.0))
    tiles = (8, 16, 32)
    p, sweep = autotune.autotune(config.Mode.PAIRS, n=1 << 12, tiles=tiles,
                                 install=True, engine="rts", device="cpu")
    j, jsweep = jautotune.autotune(gst.Mode.PAIRS, n=1 << 12, tiles=tiles,
                                   engine="rts")
    assert sweep == jsweep == {8: 3.0, 16: 7.0, 32: 5.0}
    assert p.radix_tile_rows == j.radix_tile_rows == 16
    assert p.measured
    assert config.get_tuning_parameters(CPU_INFO, config.Mode.PAIRS) == p
    assert config.get_tuning_parameters(
        CPU_INFO, config.Mode.KEYS_ONLY) != p
    config.clear_tuning_overrides()
    assert config.get_tuning_parameters(CPU_INFO, config.Mode.PAIRS) \
        == before


def test_routing_installs_and_clears(monkeypatch):
    before = config.get_routing_parameters(CPU_INFO)
    _script(monkeypatch, (5, 4))
    p, _ = autotune.autotune_routing(n=1 << 12, window_candidates=(64,),
                                     install=True, device="cpu")
    assert config.get_routing_parameters(CPU_INFO) == p
    assert p.window_max_pairs == 64 and p.measured
    config.clear_routing_override()
    assert config.get_routing_parameters(CPU_INFO) == before


def test_empty_candidates_raise():
    with pytest.raises(ValueError, match="non-empty"):
        autotune.autotune(tiles=(), device="cpu")
    with pytest.raises(ValueError, match="non-empty"):
        autotune.autotune_routing(window_candidates=(), device="cpu")
    with pytest.raises(ValueError, match="divisible by 4"):
        autotune.autotune_rangesweep(n_max=(1 << 12) + 2, device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        autotune.autotune(n=1 << 12, engine="bogus", device="cpu")


def test_every_cell_sorts_with_an_independent_payload(monkeypatch):
    """Each cell of the tile and rangesweep sweeps, run once on CPU int32
    codes: keys cells give the sorted codes; pairs cells the codes and
    their own payload plane (not the keys) moved by the stable
    permutation."""
    ran = []

    def run_once(sort_fn, n, batch, seed, device):
        codes = prng.make_test_keys(n, seed, torch.int32, device=device)
        out = sort_fn(codes)
        ref, perm = torch.sort(codes, stable=True)
        if isinstance(out, torch.Tensor):
            assert torch.equal(out, ref)
        else:
            assert torch.equal(out[0], ref)
            assert torch.equal(out[1], perm.to(torch.int32))
        ran.append(n)
        # flat cells 1, engine cells 2: the engine wins, so the rangesweep
        # bracket's cells run too
        return {"keys_per_sec": 1.0 + (len(ran) % 2 == 0)}

    monkeypatch.setattr(autotune, "_timed", run_once)
    n = 1 << 12
    for engine in ("radix16", "rts", "splitsweep"):
        for mode in (config.Mode.KEYS_ONLY, config.Mode.PAIRS):
            autotune.autotune(mode, n=n, tiles=(8,), engine=engine,
                              device="cpu")
    assert ran == [n] * 6
    ran.clear()
    autotune.autotune_rangesweep(n_max=n, seg_candidates_keys=(1 << 10,),
                                 seg_candidates_pairs=(1 << 10,),
                                 device="cpu")
    assert ran == [n, n, 3 * n // 4, 3 * n // 4, n // 2, n // 2] * 2


def test_every_cell_sorts_routing_pairs(monkeypatch):
    """The routing cells on segments: both routes give the composite
    oracle's segmented order, the payload plane riding."""
    from gpusorting_tpu_torch.ops import flat_sort

    n, ml = 1 << 12, 16
    offs, _ = prng.make_random_segments(n, ml, seed=10, device="cpu")

    def run_once(sort_fn, n_, batch, seed, device):
        codes = prng.make_test_keys(n_, seed, torch.int32, device=device)
        c, (v,) = sort_fn(codes)
        keys = codec.unbias(codes)
        rk, rv = flat_sort.segmented_sort_pairs(
            offs, keys, torch.arange(n_, dtype=torch.int32))
        np.testing.assert_array_equal(
            codec.unbias(c).view(torch.int32).numpy(),
            rk.view(torch.int32).numpy())
        np.testing.assert_array_equal(v.numpy(), rv.numpy())
        return {"keys_per_sec": 1.0}

    monkeypatch.setattr(autotune, "_timed", run_once)
    autotune.autotune_routing(n=n, window_candidates=(ml,), device="cpu")


def test_port_exports_the_tuner():
    assert {"autotune", "autotune_routing", "autotune_rangesweep"} <= set(
        gstt.__all__)
    assert gstt.autotune is autotune.autotune
