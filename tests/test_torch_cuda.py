"""Tests of gpusorting_tpu_torch that need an NVIDIA card: the relocate
kernel against its plain version, its launch checks, and the engines and
public entry points through the kernel against flat torch.sort.

Every test here is marked `cuda` and skips where torch sees no card.  This
file imports neither JAX nor the JAX package, so it runs on a machine with
only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import gpusorting_tpu_torch as gstt
from gpusorting_tpu_torch.core import codec, config, prng
from gpusorting_tpu_torch.ops import relocate, rangesweep as rs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the relocate kernel is CUDA-only)")
    return torch.device("cuda")


def _codes(kind, n, seed, dev):
    rng = np.random.default_rng(seed)
    if kind == "rand":
        x = rng.integers(0, 2**32, n, dtype=np.uint32)
    elif kind == "dup16":
        x = rng.integers(0, 16, n, dtype=np.uint32)
    elif kind == "alleq":
        x = np.full(n, 0xABCD1234, np.uint32)
    else:   # lowhi: two values, every range edge a run edge
        x = np.where(np.arange(n) % 2 == 0, 0, 0xFFFFFFFF).astype(np.uint32)
    return codec.bias(torch.from_numpy(x)).to(dev)


@pytest.mark.parametrize("K,L", [(70, 1024), (8, 256), (5, 384), (128, 4096)])
@pytest.mark.parametrize("kind", ["rand", "dup16", "alleq", "lowhi"])
def test_relocate_kernel_matches_plain(cuda, kind, K, L):
    x2 = rs._phase_sort_keys(_codes(kind, K * L, K + L, cuda).view(K, L))
    extra = torch.randint(-2**31, 2**31 - 1, (3, K, L), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(K)
                          ).to(cuda)
    bounds = rs._cuts(x2, K, L, heads=x2[:, ::128])
    for planes in ((x2,), (x2,) + tuple(extra)):
        before = relocate.relocate.launches
        got = rs._range_exchange(planes, bounds, K, L, method="dma")
        want = rs._range_exchange(planes, bounds, K, L, method="gather")
        torch.cuda.synchronize()
        assert relocate.relocate.launches == before + len(planes)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_relocate_checks_on_card(cuda):
    K, l_rows = 4, 2
    ctrl = torch.zeros(3 * K * K + K, dtype=torch.int32, device=cuda)
    src = torch.zeros((K * l_rows, 128), dtype=torch.int32, device=cuda)
    fringe = torch.zeros((2 * K * K, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        relocate.relocate(ctrl, src.float(), fringe, K, l_rows, 2 * K)
    with pytest.raises(ValueError, match="shape"):
        relocate.relocate(ctrl[1:], src, fringe, K, l_rows, 2 * K)
    with pytest.raises(ValueError, match="contiguous"):
        relocate.relocate(ctrl, src.T.contiguous().T, fringe, K, l_rows,
                          2 * K)
    with pytest.raises(ValueError, match="src on"):
        relocate.relocate(ctrl.cpu(), src, fringe, K, l_rows, 2 * K)


@pytest.mark.parametrize("n,L,and_count", [(300_000, 4096, 0),
                                           (1 << 20, 1 << 13, 3),
                                           (99_999, 1024, 6)])
def test_engines_match_torch_sort(cuda, n, L, and_count):
    k = codec.encode_biased(prng.hybrid_taus_bits(n, n, and_count,
                                                  device=cuda))
    want = torch.sort(k, stable=True)
    before = relocate.relocate.launches
    assert torch.equal(rs.sort_codes_rangesweep(k, seg_elems=L), want.values)
    sk, perm = rs.argsort_rangesweep(k, seg_elems=L)
    assert torch.equal(sk, want.values)
    assert torch.equal(perm.long(), want.indices)
    v = prng.hybrid_taus_bits(n, n + 1, device=cuda).view(torch.int32)
    sk, sv = rs.sort_pairs_rangesweep(k, v, seg_elems=L)
    assert torch.equal(sv, v[want.indices])
    w = codec.join_wide(v, v ^ 0x5A5A5A5A)
    sk, sw = rs.sort_pairs_rangesweep(k, w, seg_elems=L)
    assert torch.equal(sw, w[want.indices])
    assert relocate.relocate.launches == before + 1 + 2 + 3 + 4


def test_public_auto_route_on_card(cuda):
    """The public entry points route through rangesweep and the kernel on
    the card once a row sends their size there."""
    n = 300_000
    config.set_routing_override(config.RoutingParameters(
        rangesweep_min=1 << 16, rangesweep_min_pairs=1 << 16,
        rangesweep_min_pairs_wide=1 << 16, rangesweep_min_index=1 << 16,
        rangesweep_seg_elems=1 << 12, rangesweep_seg_elems_pairs=1 << 12,
        rangesweep_seg_elems_pairs_wide=1 << 12,
        rangesweep_seg_elems_index=1 << 12))
    try:
        keys = prng.make_test_keys(n, 9, torch.float32,
                                   gstt.EntropyPreset.E054, device=cuda)
        before = relocate.relocate.launches
        for order in (gstt.Order.ASCENDING, gstt.Order.DESCENDING):
            got = gstt.sort(keys, order=order)
            want = gstt.sort(keys, order=order, backend=gstt.Backend.XLA)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
            perm = gstt.argsort(keys, order=order)
            assert torch.equal(perm, gstt.argsort(
                keys, order=order, backend=gstt.Backend.XLA))
        assert relocate.relocate.launches == before + 2 * (1 + 2)
    finally:
        config.clear_routing_override()


def test_flagship_row_routes_rangesweep(cuda):
    info = config.get_device_info(cuda)
    if info.generation != "h100":
        pytest.skip(f"no routing row for {info.device_kind}")
    assert config.auto_engine(1 << 28, info=info) == "rangesweep"
    assert config.auto_engine((1 << 28) - 1, info=info) == "xla"
