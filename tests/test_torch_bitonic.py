"""Port parity for the bitonic sorting network: the in-tile and cross-tile
stages (plain versions on the CPU), the network and its stable form,
against gpusorting_tpu, bit for bit.

The same numpy inputs go through the JAX package on the CPU (its Pallas
kernels in interpret mode, as tests/test_bitonic.py runs them) and through
the port on device="cpu".  The network is deterministic, so the planes
after any pass match too, ties included.  To run global stages at n of
about 16K, the JAX package's tuning override sets `vmem_limit_bytes` to
49152 (8-row tiles for up to 4 operands) and the port's sets
`network_smem_bytes` to the same 8-row tile.  The CUDA kernels are tested
on the card by tests/test_torch_cuda.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpusorting_tpu.core import config as jconfig
from gpusorting_tpu.ops import bitonic as jbitonic
from gpusorting_tpu_torch.core import codec, config
from gpusorting_tpu_torch.ops import bitonic

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


@pytest.mark.parametrize("n", [0, 1, 1024, 5000, 1 << 14])
def test_network_launches_and_input_untouched(monkeypatch, tile8, n):
    """(L - t + 1) in-tile passes and (L - t)(L - t + 1) / 2 global stages
    for N = 2^L and a 2^t-key tile; the caller's planes are never
    written, also when no pad is needed."""
    tile8(3)
    calls = {"local": 0, "global": 0}
    real_local, real_global = bitonic.local_stages, bitonic.global_stage

    def local(*a):
        calls["local"] += 1
        return real_local(*a)

    def glob(*a):
        calls["global"] += 1
        return real_global(*a)

    monkeypatch.setattr(bitonic, "local_stages", local)
    monkeypatch.setattr(bitonic, "global_stage", glob)
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
    assert calls == {"local": L - t + 1, "global": (L - t) * (L - t + 1) // 2}


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
