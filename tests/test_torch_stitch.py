"""Port parity for the stitch primitives: `compact_ops` and `expand_ops`
(plain versions on the CPU) against gpusorting_tpu's, bit for bit.

The same numpy inputs go through the JAX package on the CPU (its Pallas
kernels in interpret mode, as tests/test_stitch.py runs them) and through
the port on device="cpu".  JAX leaves the compacted tail unspecified, so
only `[:count]` is compared; the tolerance is 0.  Each JAX result is
computed once, in a module-scoped fixture.  The CUDA kernels are tested on
the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpusorting_tpu.ops import stitch as jstitch
from gpusorting_tpu.segsort import splitsort as jsplitsort
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


def _planes(n, num_ops, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
            for _ in range(num_ops)]


def _segment_mask(n, seed):
    """An `_interval_mask` of random segments: every other one of lengths
    1-300, the last ending at n (the dropped bound)."""
    rng = np.random.RandomState(seed)
    lens = []
    while sum(lens) < n:
        lens.append(min(int(rng.randint(1, 301)), n - sum(lens)))
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    lens = np.asarray(lens, np.int64)
    pick = np.arange(len(lens)) % 2 == 1
    pick[-1] = True
    return starts[pick], lens[pick]


# (name, n, mask kind): the sizes of tests/test_stitch.py, n <= 50 000.  JAX
# compiles one kernel per padded shape: n <= 16384 share one, the two
# 50 000-element cases another.
_CASES = [("n1_all", 1, 1.0), ("n127_half", 127, 0.5), ("n128_none", 128, 0.0),
          ("n1000_half", 1000, 0.5), ("n4096_all", 4096, 1.0),
          ("n50000_sparse", 50_000, 1 / 64), ("n50000_segments", 50_000,
                                               "segments")]


def _mask(n, kind, seed):
    if kind == "segments":
        m = np.zeros(n, bool)
        for s, l in zip(*_segment_mask(n, seed)):
            m[s:s + l] = True
        return m
    return np.random.RandomState(seed).rand(n) < kind


_INPUTS = {name: (_mask(n, kind, i), _planes(n, 3, 100 + i))
           for i, (name, n, kind) in enumerate(_CASES)}


@pytest.fixture(scope="module")
def jax_compact():
    """JAX's (packed planes, count) per case, for 1, 2 and 3 operands."""
    out = {}
    for name, (m, xs) in _INPUTS.items():
        for ops in (1, 2, 3):
            packed, cnt = jstitch.compact_ops(
                tuple(jnp.asarray(x) for x in xs[:ops]), jnp.asarray(m))
            out[name, ops] = ([np.asarray(p) for p in packed], int(cnt))
    return out


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).view(torch.int32)


@pytest.mark.parametrize("ops", [1, 2, 3])
@pytest.mark.parametrize("name", list(_INPUTS))
def test_compact_matches_jax(jax_compact, name, ops):
    m, xs = _INPUTS[name]
    want, want_cnt = jax_compact[name, ops]
    before = stitch.compact_ops.launches
    packed, cnt = stitch.compact_ops(tuple(_t(x) for x in xs[:ops]),
                                     torch.from_numpy(m))
    assert stitch.compact_ops.launches == before      # the CPU runs plain
    assert cnt.dtype == torch.int32 and cnt.ndim == 0
    assert int(cnt) == want_cnt == int(m.sum())
    for g, w in zip(packed, want):
        assert g.shape == m.shape and g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy().view(np.uint32)[:want_cnt],
                                      w[:want_cnt])


@pytest.mark.parametrize("short", [False, True])
@pytest.mark.parametrize("ops", [1, 2, 3])
@pytest.mark.parametrize("name", ["n127_half", "n1000_half", "n4096_all",
                                  "n50000_sparse", "n50000_segments"])
def test_expand_matches_jax(name, ops, short):
    """A stream as long as the mask, or one shorter than the set count
    (JAX zero-pads it: the positions past the stream read 0)."""
    m, xs = _INPUTS[name]
    k = int(m.sum())
    length = max(k - 17, 0) if short else m.shape[0]
    srcs = [x[:length] for x in xs[:ops]]
    want = jstitch.expand_ops(tuple(jnp.asarray(s) for s in srcs),
                              jnp.asarray(m))
    got = stitch.expand_ops(tuple(_t(s) for s in srcs), torch.from_numpy(m))
    for g, w in zip(got, want):
        assert g.shape == m.shape and g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w))


def test_compact_then_expand_roundtrip():
    """where(mask, expand(compact(x)), x) == x; compact(x) on one plane."""
    m, xs = _INPUTS["n50000_segments"]
    x = _t(xs[0])
    mask = torch.from_numpy(m)
    packed, cnt = stitch.compact(x, mask)
    (back,) = stitch.expand_ops((packed[:int(cnt)],), mask)
    assert torch.equal(torch.where(mask, back, x), x)


def test_interval_mask_matches_jax():
    """The interval mask drops a bound equal to n, as JAX's mode="drop"."""
    n = 33_000
    starts, lens = _segment_mask(n, 6)
    assert starts[-1] + lens[-1] == n
    got = splitsort._interval_mask(starts, lens, n, torch.device("cpu"))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsplitsort._interval_mask(starts, lens, n)))


def test_stitch_checks():
    x = torch.zeros(8, dtype=torch.int32)
    m = torch.ones(8, dtype=torch.bool)
    with pytest.raises(ValueError, match="planes"):
        stitch.compact_ops((), m)
    with pytest.raises(ValueError, match="planes"):
        stitch.expand_ops((x,) * 5, m)
    with pytest.raises(TypeError, match="bool"):
        stitch.compact_ops((x,), m.to(torch.int32))
    with pytest.raises(TypeError, match="int32"):
        stitch.compact_ops((x.float(),), m)
    with pytest.raises(ValueError, match="length"):
        stitch.compact_ops((x[:7],), m)
    # expand takes a stream of any length, the empty one included
    (out,) = stitch.expand_ops((x[:0],), m)
    assert torch.equal(out, torch.zeros(8, dtype=torch.int32))
    packed, cnt = stitch.compact_ops((x[:0],), m[:0])
    assert packed[0].numel() == 0 and int(cnt) == 0
