"""Port parity: the sorter objects of gpusorting_tpu_torch (api.py) and the
tuning table, against gpusorting_tpu on the CPU.

The JAX object runs its PALLAS engine in interpret mode once, at 128-row
tiles (the one case held against the JAX engine itself); the rest is held
against the JAX package's flat oracle or checked by the port's own
validators.  A sorter on the CPU makes its inputs on the CPU and its
engines take the kernels' plain versions.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpusorting_tpu as gst
import gpusorting_tpu_torch as gstt
from gpusorting_tpu.core import config as jconfig
from gpusorting_tpu_torch.core import config
from gpusorting_tpu_torch.ops import rts

PALLAS = gstt.Backend.PALLAS


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
    """FFX at 2-row tiles (its fixed tile does not change the output)."""
    config.set_routing_override(config.RoutingParameters(ffx_tile_rows=2))
    yield
    config.clear_routing_override()


def _tuning(tile_rows, partition_rows=4):
    return gstt.TuningParameters(partition_rows=partition_rows,
                                 radix_tile_rows=tile_rows)


def test_device_radix_object_matches_jax_object():
    keys = np.random.default_rng(3).integers(0, 2**32, 20_000,
                                             dtype=np.uint32)
    jtune = dataclasses.replace(jconfig.get_tuning_parameters(),
                                radix_tile_rows=128)
    want = gst.DeviceRadixSort(gst.SortConfig(backend=gst.Backend.PALLAS),
                               tuning=jtune).sort(jnp.asarray(keys))
    s = gstt.DeviceRadixSort(gstt.SortConfig(backend=PALLAS),
                             tuning=_tuning(128), device="cpu")
    got = s.sort(torch.from_numpy(keys))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # pairs through the object, against the JAX flat oracle
    vals = np.arange(20_000, dtype=np.float32)
    ok, ov = s.sort(torch.from_numpy(keys & 0xFF), torch.from_numpy(vals))
    ek, ev = gst.sort_pairs(jnp.asarray(keys & 0xFF), jnp.asarray(vals),
                            backend=gst.Backend.XLA)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ek))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(ev))


@pytest.mark.parametrize("cls", [gstt.DeviceRadixSort, gstt.FFXParallelSort])
@pytest.mark.parametrize("mode", [gstt.Mode.KEYS_ONLY, gstt.Mode.PAIRS])
def test_test_all_small_window(small_ffx_tile, cls, mode):
    s = cls(gstt.SortConfig(mode=mode, backend=PALLAS), tuning=_tuning(2),
            device="cpu")
    report = s.test_all(boundary_window=200, boundary_stride=37,
                        large_sizes=(3000,))
    assert report.all_passed, str(report)
    assert report.passed == len(range(200, 401, 37)) + 1
    # the window defaults to the tuning row's partition (4 rows here)
    report = s.test_all(boundary_stride=173, large_sizes=())
    assert report.all_passed and report.passed == len(range(512, 1025, 173))


@pytest.mark.parametrize("backend", [gstt.Backend.PALLAS, gstt.Backend.XLA,
                                     gstt.Backend.AUTO])
def test_super_test_18_configs(backend):
    report = gstt.super_test(gstt.DeviceRadixSort, sizes=(777,),
                             backend=backend, device="cpu")
    assert (report.passed, report.failed) == (18, 0), str(report)


@pytest.mark.parametrize("mode", [gstt.Mode.KEYS_ONLY, gstt.Mode.PAIRS])
@pytest.mark.parametrize("key_type", list(gstt.KeyType))
def test_validate_against_oracle(mode, key_type):
    s = gstt.DeviceRadixSort(gstt.SortConfig(
        mode=mode, key_type=key_type, order=gstt.Order.DESCENDING,
        payload_type=gstt.PayloadType.FLOAT32, backend=PALLAS),
        tuning=_tuning(3), device="cpu")
    assert s.validate_against_oracle(5000, seed=11)


def test_ffx_object_checks_and_sorts(small_ffx_tile):
    with pytest.raises(ValueError, match="u32 ascending"):
        gstt.FFXParallelSort(gstt.SortConfig(key_type=gstt.KeyType.INT32),
                             device="cpu")
    with pytest.raises(ValueError, match="u32 ascending"):
        gstt.FFXParallelSort(gstt.SortConfig(order=gstt.Order.DESCENDING),
                             device="cpu")
    s = gstt.FFXParallelSort(gstt.SortConfig(backend=PALLAS), device="cpu")
    keys = torch.from_numpy(np.random.default_rng(4).integers(
        0, 2**32, 3000, dtype=np.uint32))
    np.testing.assert_array_equal(s.sort(keys).numpy(),
                                  np.sort(keys.numpy()))


@pytest.mark.parametrize("name", ["OneSweep", "ForwardSweep",
                                  "EmulatedDeadlocking"])
def test_unported_families(name):
    """The three families whose PALLAS engines came last (the network, and
    radix16 in adversarial segments) sort as the JAX sorters do under
    PALLAS, at 128-row tiles, and as the flat sort under AUTO and XLA."""
    cls, jcls = getattr(gstt, name), getattr(gst, name)
    keys = np.random.default_rng(5).integers(0, 2**32, 20_000,
                                             dtype=np.uint32)
    jtune = dataclasses.replace(jconfig.get_tuning_parameters(),
                                radix_tile_rows=128)
    want = jcls(gst.SortConfig(backend=gst.Backend.PALLAS),
                tuning=jtune).sort(jnp.asarray(keys))
    s = cls(gstt.SortConfig(backend=PALLAS), tuning=_tuning(128),
            device="cpu")
    tk = torch.from_numpy(keys)
    np.testing.assert_array_equal(s.sort(tk).numpy(), np.asarray(want))
    # pairs (8-bit keys: long equal runs), against the JAX flat oracle
    vals = np.arange(20_000, dtype=np.float32)
    ok, ov = s.sort(torch.from_numpy(keys & 0xFF), torch.from_numpy(vals))
    ek, ev = gst.sort_pairs(jnp.asarray(keys & 0xFF), jnp.asarray(vals),
                            backend=gst.Backend.XLA)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ek))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(ev))
    for backend in (gstt.Backend.AUTO, gstt.Backend.XLA):
        s = cls(gstt.SortConfig(backend=backend), device="cpu")
        np.testing.assert_array_equal(s.sort(tk).numpy(), np.sort(keys))


def test_sorter_device_is_explicit(monkeypatch):
    """A sorter never picks the CPU by itself: "cuda", the default, raises
    where torch sees no card; "cpu" runs the kernels' plain versions."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (gstt.GPUSorterBase, gstt.OneSweep, gstt.FFXParallelSort):
        with pytest.raises(RuntimeError, match="is_available"):
            cls(gstt.SortConfig(backend=PALLAS))
        with pytest.raises(RuntimeError, match="is_available"):
            cls(gstt.SortConfig(backend=PALLAS), device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        gstt.super_test(gstt.OneSweep, sizes=(10,))
    s = gstt.OneSweep(gstt.SortConfig(backend=PALLAS, mode=gstt.Mode.PAIRS),
                      device="cpu")
    assert s.device == torch.device("cpu")
    assert s.device_info.platform == "cpu"
    assert s.tuning == gstt.get_tuning_parameters(s.device_info,
                                                  gstt.Mode.PAIRS)
    assert s.validate_sort(3000, seed=3)
    assert s.validate_against_oracle(3000, seed=4)


def test_make_sort_fn_and_timing():
    s = gstt.DeviceRadixSort(gstt.SortConfig(
        backend=PALLAS, order=gstt.Order.DESCENDING), tuning=_tuning(1),
        device="cpu")
    keys = torch.from_numpy(np.random.default_rng(6).integers(
        0, 2**32, 4000, dtype=np.uint32))
    vals = torch.arange(4000, dtype=torch.int32)
    for donate in (False, True):
        fn = s.make_sort_fn(donate=donate)
        assert torch.equal(fn(keys), s.sort(keys))
        pk, pv = s.make_sort_fn(pairs=True, donate=donate)(keys, vals)
        wk, wv = s.sort(keys, vals)
        assert torch.equal(pk, wk) and torch.equal(pv, wv)
    assert s.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        s.batch_timing(1000, batch=1)


def test_report():
    r = gstt.TestReport()
    r.record(True, "a")
    r.record(False, "b")
    assert (r.passed, r.failed, r.all_passed) == (1, 1, False)
    assert str(r) == "1 / 2 passed; failures: b"


# ---- the tuning table ------------------------------------------------------


@pytest.mark.parametrize("mode", [gstt.Mode.KEYS_ONLY, gstt.Mode.PAIRS])
def test_tuning_rows(mode):
    jmode = jconfig.Mode(mode.value)
    jrow = jconfig.get_tuning_parameters(mode=jmode)   # the CPU's row
    row = gstt.tuning_from_jax_fields(dataclasses.asdict(jrow))
    cpu = config.get_device_info("cpu")
    assert row == gstt.get_tuning_parameters(cpu, mode)
    assert row.partition_size == jrow.partition_size
    h100 = dataclasses.replace(cpu, platform="cuda", generation="h100")
    hrow = gstt.get_tuning_parameters(h100, mode)
    assert (hrow.radix_tile_rows, hrow.network_smem_bytes, hrow.measured) == (
        128 if mode == gstt.Mode.KEYS_ONLY else 256, 232448, True)
    assert [hrow.network_tile_rows(k) for k in (1, 2, 3, 4)] == [
        256, 128, 128, 64]
    gstt.set_tuning_override(mode, _tuning(7))
    try:
        assert gstt.get_tuning_parameters(h100, mode).radix_tile_rows == 7
        assert rts.default_tile_rows(torch.device("cpu"),
                                     pairs=mode == gstt.Mode.PAIRS) == 7
    finally:
        gstt.clear_tuning_overrides()
    assert gstt.get_tuning_parameters(cpu, mode) == row


def test_ffx_tile_row_matches_jax():
    jrow = jconfig.RoutingParameters()
    row = gstt.routing_from_jax_fields(dataclasses.asdict(jrow))
    assert row.ffx_tile_rows == jrow.ffx_tile_rows == 256
