"""Port parity: gpusorting_tpu_torch.ops.rangesweep and its relocate kernel
against gpusorting_tpu.ops.rangesweep.

The same numpy inputs go through the JAX engine on the CPU (the Pallas
relocate in interpret mode, as tests/test_rangesweep.py runs it) and through
the port on device="cpu"; results are compared bit for bit.  The port
carries codes as biased int32 (`codec.bias`), so u32 results are compared
after `codec.unbias`.  The CUDA kernel itself is tested on the card by
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpusorting_tpu.ops import rangesweep as jrs
from gpusorting_tpu_torch.core import codec
from gpusorting_tpu_torch.ops import relocate, rangesweep as rs

_KL = [(2, 256), (8, 1024), (33, 128), (70, 256)]
_KINDS = ["rand", "dup16", "alleq", "lowhi", "iota"]


def _gen(kind, n, seed):
    # the five distributions of tests/test_rangesweep.py:403-414
    rng = np.random.default_rng(seed)
    if kind == "rand":
        return rng.integers(0, 2**32, n, dtype=np.uint32)
    if kind == "dup16":
        return rng.integers(0, 16, n, dtype=np.uint32)
    if kind == "alleq":
        return np.full(n, 0xABCD1234, np.uint32)
    if kind == "lowhi":
        return np.where(np.arange(n) % 2 == 0, 0,
                        0xFFFFFFFF).astype(np.uint32)
    return np.arange(n, dtype=np.uint32)


def _sorted_chunks(kind, K, L):
    x = _gen(kind, K * L, seed=K * 7 + L % 97)
    return np.sort(x.reshape(K, L), axis=1)


def _t(a: np.ndarray) -> torch.Tensor:
    """u32 numpy codes -> the port's biased carrier."""
    return codec.bias(torch.from_numpy(np.ascontiguousarray(a).copy()))


def _raw(a: np.ndarray) -> torch.Tensor:
    """u32 numpy payload -> int32 plane with the same bits (unbiased)."""
    return torch.from_numpy(np.ascontiguousarray(a).copy()).view(torch.int32)


def _u32(t: torch.Tensor) -> np.ndarray:
    return codec.unbias(t).numpy()


# ---- cuts ------------------------------------------------------------------


@pytest.mark.parametrize("kind", _KINDS)
@pytest.mark.parametrize("K,L", _KL)
def test_cuts_bit_identical_to_jax(kind, K, L):
    x2 = _sorted_chunks(kind, K, L)
    jb, jv = jrs._exact_cuts(jnp.asarray(x2), K, L, return_splitters=True)
    jb, jv = np.asarray(jb), np.asarray(jv)
    tx2 = _t(x2)
    b, v = rs._exact_cuts(tx2, K, L, return_splitters=True)
    np.testing.assert_array_equal(b.numpy(), jb)
    np.testing.assert_array_equal(_u32(v), jv)
    h, hv = rs._exact_cuts_hier(tx2, K, L, return_splitters=True)
    np.testing.assert_array_equal(h.numpy(), jb)
    np.testing.assert_array_equal(_u32(hv), jv)
    # the dispatch (hier at K >= 64), fed the row heads as the engine does
    d, dv = rs._cuts(tx2, K, L, heads=tx2[:, ::128], return_splitters=True)
    np.testing.assert_array_equal(d.numpy(), jb)
    np.testing.assert_array_equal(_u32(dv), jv)


def test_cuts_dispatch(monkeypatch):
    """_cuts takes the head-window form exactly at K >= _CUTS_HIER_MIN_K,
    the JAX package's threshold."""
    assert rs._CUTS_HIER_MIN_K == jrs._CUTS_HIER_MIN_K
    taken = []
    for name in ("_exact_cuts", "_exact_cuts_hier"):
        real = getattr(rs, name)
        monkeypatch.setattr(rs, name, lambda *a, _n=name, _f=real, **kw:
                            taken.append(_n) or _f(*a, **kw))
    for K in (rs._CUTS_HIER_MIN_K - 1, rs._CUTS_HIER_MIN_K):
        rs._cuts(_t(_sorted_chunks("rand", K, 128)), K, 128)
    assert taken == ["_exact_cuts", "_exact_cuts_hier"]


# ---- exchange --------------------------------------------------------------


def _planes(kind, K, L, count):
    x2 = _sorted_chunks(kind, K, L)
    rng = np.random.default_rng(K + L)
    extra = [rng.integers(0, 2**32, (K, L), dtype=np.uint32)
             for _ in range(count - 1)]
    return x2, extra


@pytest.fixture(scope="module")
def jax_exchange():
    """JAX prep and interpret-mode relocate, once per (case, planes)."""
    cache = {}

    def get(kind, K, L, count):
        key = (kind, K, L, count)
        if key not in cache:
            x2, extra = _planes(kind, K, L, count)
            jplanes = (jnp.asarray(x2),) + tuple(jnp.asarray(p)
                                                 for p in extra)
            jb = jrs._cuts(jplanes[0], K, L)
            ctrl, fr, _ = jrs._exchange_prep(jplanes, jb, K, L)
            out = jrs._range_exchange(jplanes, jb, K, L, interpret=True,
                                      method="dma")
            cache[key] = (x2, extra, np.asarray(jb), np.asarray(ctrl),
                          [np.asarray(f) for f in fr],
                          [np.asarray(o) for o in out])
        return cache[key]

    return get


_EXCHANGE_CASES = [("dup16", 8, 1024), ("rand", 33, 128), ("alleq", 70, 256)]


@pytest.mark.parametrize("kind,K,L", _EXCHANGE_CASES)
def test_exchange_prep_ctrl_bit_identical(jax_exchange, kind, K, L):
    x2, extra, jb, jctrl, jfr, _ = jax_exchange(kind, K, L, 4)
    planes = (_t(x2),) + tuple(_raw(p) for p in extra)
    ctrl, fr = rs._exchange_prep(planes, torch.from_numpy(jb.copy()), K, L)
    assert ctrl.dtype == torch.int32 and ctrl.shape == (3 * K * K + K,)
    np.testing.assert_array_equal(ctrl.numpy(), jctrl)
    # the defined head of each bucket's slab: L - 128*bulk_b elements
    bulk = jctrl[3 * K * K:]
    for j, (f, jf) in enumerate(zip(fr, jfr)):
        tf = f.view(torch.uint32).numpy().reshape(K, -1)
        if j == 0:
            tf = _u32(f).reshape(K, -1)
        jf = jf.reshape(K, -1)
        for b in range(K):
            m = L - 128 * int(bulk[b])
            np.testing.assert_array_equal(tf[b, :m], jf[b, :m])


@pytest.mark.parametrize("method", ["dma", "gather"])
@pytest.mark.parametrize("count", [1, 4])
@pytest.mark.parametrize("kind,K,L", _EXCHANGE_CASES)
def test_range_exchange_matches_jax_relocate(jax_exchange, kind, K, L,
                                             count, method):
    x2, extra, jb, _, _, jout = jax_exchange(kind, K, L, count)
    planes = (_t(x2),) + tuple(_raw(p) for p in extra)
    out = rs._range_exchange(planes, torch.from_numpy(jb.copy()), K, L,
                             method=method)
    assert len(out) == count
    np.testing.assert_array_equal(_u32(out[0]), jout[0])
    for o, jo in zip(out[1:], jout[1:]):
        assert o.shape == (K * L // 128, 128) and o.dtype == torch.int32
        np.testing.assert_array_equal(o.view(torch.uint32).numpy(), jo)


def test_relocate_wrapper_takes_plain_version_on_cpu(jax_exchange):
    x2, _, jb, jctrl, jfr, jout = jax_exchange("dup16", 8, 1024, 1)
    before = relocate.relocate.launches
    ctrl = torch.from_numpy(jctrl.copy())
    src = _t(x2).reshape(-1, 128)
    fringe = _t(jfr[0])
    out = relocate.relocate(ctrl, src, fringe, 8, 8, 16)
    np.testing.assert_array_equal(_u32(out), jout[0])
    assert torch.equal(out, relocate.relocate_plain(ctrl, src, fringe, 8, 8,
                                                    16))
    assert relocate.relocate.launches == before   # no kernel on the CPU


def test_relocate_checks():
    with pytest.raises(ValueError, match="device"):
        relocate.relocate(torch.zeros(4, dtype=torch.int32, device="meta"),
                          torch.zeros((2, 128), dtype=torch.int32,
                                      device="meta"),
                          torch.zeros((2, 128), dtype=torch.int32,
                                      device="meta"), 1, 2, 2)
    dev = torch.device("cpu")
    good = torch.zeros((4, 128), dtype=torch.int32)
    relocate._check("src", good, (4, 128), dev)
    with pytest.raises(TypeError):
        relocate._check("src", good.to(torch.int64), (4, 128), dev)
    with pytest.raises(ValueError, match="shape"):
        relocate._check("src", good, (8, 128), dev)
    with pytest.raises(ValueError, match="contiguous"):
        relocate._check("src", good.T, (128, 4), dev)
    with pytest.raises(ValueError, match="aligned"):
        relocate._check("src", good.view(-1)[1:].view(-1)[:127].view(1, 127),
                        (1, 127), dev)


def test_bad_method_and_seg_elems():
    x = _t(_gen("rand", 1000, 1))
    with pytest.raises(ValueError):
        rs.sort_codes_rangesweep(x, seg_elems=300)
    with pytest.raises(ValueError):
        rs._range_exchange((x[:512].view(2, 256),),
                           torch.zeros((2, 3), dtype=torch.int32), 2, 256,
                           method="nope")
    with pytest.raises(ValueError):
        rs.sort_pairs_rangesweep_planes(x, (), seg_elems=300)


# ---- engines end to end ----------------------------------------------------


_ENGINE_CASES = [
    (1000, 2048, 0),       # single chunk: flat sort
    (5000, 512, 4),        # K=10, padded tail, heavy duplicates
    (33_000, 1024, 6),     # K=33, extreme duplication
    (70 * 256 - 37, 256, 2),   # K=70: hierarchical cuts
]


def _keys(n, and_count, seed):
    from gpusorting_tpu.core import prng as jprng

    return np.asarray(jprng.hybrid_taus_bits(n, seed, and_count))


@pytest.mark.parametrize("n,L,and_count", _ENGINE_CASES)
def test_keys_engine(n, L, and_count):
    k = _keys(n, and_count, n % 97)
    want = np.asarray(jrs.sort_codes_rangesweep(jnp.asarray(k), seg_elems=L))
    got = rs.sort_codes_rangesweep(_t(k), seg_elems=L)
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("n,L,and_count", _ENGINE_CASES)
def test_pairs_and_argsort_engines(n, L, and_count):
    k = _keys(n, and_count, n % 89)
    v = _keys(n, 0, n % 89 + 1)
    jk, jv = jrs.sort_pairs_rangesweep(jnp.asarray(k), jnp.asarray(v),
                                       seg_elems=L)
    tk, tv = rs.sort_pairs_rangesweep(_t(k), _raw(v),
                                      seg_elems=L)
    np.testing.assert_array_equal(_u32(tk), np.asarray(jk))
    np.testing.assert_array_equal(tv.view(torch.uint32).numpy(),
                                  np.asarray(jv))
    ak, ap = jrs.argsort_rangesweep(jnp.asarray(k), seg_elems=L)
    sk, perm = rs.argsort_rangesweep(_t(k), seg_elems=L)
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(_u32(sk), np.asarray(ak))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(ap).view(np.int32))


@pytest.mark.parametrize("n,L,and_count", _ENGINE_CASES[1:])
def test_wide_planes_engine(n, L, and_count):
    """64-bit payloads: the 4-plane pipeline against the JAX planes form,
    and the int64 carrier form against the same planes."""
    k = _keys(n, and_count, 5)
    lo, hi = _keys(n, 0, 6), _keys(n, 0, 7)
    jk, jlo, jhi = jrs.sort_pairs_rangesweep_planes(
        jnp.asarray(k), (jnp.asarray(lo), jnp.asarray(hi)), seg_elems=L)
    tk, tlo, thi = rs.sort_pairs_rangesweep_planes(
        _t(k), (_raw(lo), _raw(hi)),
        seg_elems=L)
    np.testing.assert_array_equal(_u32(tk), np.asarray(jk))
    np.testing.assert_array_equal(tlo.view(torch.uint32).numpy(),
                                  np.asarray(jlo))
    np.testing.assert_array_equal(thi.view(torch.uint32).numpy(),
                                  np.asarray(jhi))
    wide = (hi.astype(np.uint64) << 32 | lo).view(np.int64)
    wk, wv = rs.sort_pairs_rangesweep(_t(k), torch.from_numpy(wide),
                                      seg_elems=L)
    np.testing.assert_array_equal(_u32(wk), np.asarray(jk))
    np.testing.assert_array_equal(
        wv.numpy(), (np.asarray(jhi).astype(np.uint64) << 32
                     | np.asarray(jlo)).view(np.int64))


@pytest.mark.parametrize("arr", ["all7", "allmax", "maxmix"])
def test_adversarial_inputs(arr):
    """All-equal keys and real 0xFFFFFFFF keys beside the pad sentinel."""
    n, L = 6000, 512
    k = {"all7": np.full(n, 7, np.uint32),
         "allmax": np.full(n, 0xFFFFFFFF, np.uint32),
         "maxmix": np.where(np.arange(n) % 3 == 0, 0xFFFFFFFF,
                            42).astype(np.uint32)}[arr]
    v = np.arange(n, dtype=np.uint32)
    got = rs.sort_codes_rangesweep(_t(k), seg_elems=L)
    np.testing.assert_array_equal(_u32(got), np.sort(k))
    ek, ev = jax.lax.sort((jnp.asarray(k), jnp.asarray(v)), num_keys=1,
                          is_stable=True)
    tk, tv = rs.sort_pairs_rangesweep(_t(k), _raw(v),
                                      seg_elems=L)
    np.testing.assert_array_equal(_u32(tk), np.asarray(ek))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(ev).view(np.int32))


def test_constant_bucket_skip(monkeypatch):
    """On all-equal input every interior bucket is flagged constant and
    phase 3 sorts only the two edge buckets; the output is unchanged."""
    n, L = 40 * 256, 256
    k = np.full(n, 0xABCD1234, np.uint32)
    rows = []
    real = rs._phase_sort_keys
    monkeypatch.setattr(rs, "_phase_sort_keys",
                        lambda x2: rows.append(x2.shape[0]) or real(x2))
    got = rs.sort_codes_rangesweep(_t(k), seg_elems=L)
    np.testing.assert_array_equal(_u32(got), k)
    assert rows == [40, 2]
    rows.clear()
    r = _gen("rand", n, 3)
    np.testing.assert_array_equal(
        _u32(rs.sort_codes_rangesweep(_t(r), seg_elems=L)), np.sort(r))
    assert rows == [40, 40]        # below the 90% gate: every bucket
