"""Port parity for the fused radix-16 engine: the global histogram, the
digit bases, one binning pass (plain versions on the CPU), and the fused
and segmented engine, against gpusorting_tpu, bit for bit.

The same numpy inputs go through the JAX package on the CPU (its Pallas
kernels in interpret mode, as tests/test_radix16.py runs them) and through
the port on device="cpu".  The port carries codes as biased int32
(`codec.bias`), so u32 codes are compared after `codec.unbias`.  The JAX
engine compiles once per padded shape, operand count and segment, so the
inputs share padded shapes (1, 2 or 3 tiles of 128 rows) and every JAX
result is computed once, in module-scoped fixtures.  The CUDA kernels are
tested on the card by tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpusorting_tpu.ops import kernels as jkernels
from gpusorting_tpu.ops import radix16 as jradix16
from gpusorting_tpu_torch.core import codec
from gpusorting_tpu_torch.ops import kernels, radix16

TILE = 128


def _t(a: np.ndarray) -> torch.Tensor:
    """u32 numpy codes -> the port's biased carrier."""
    return codec.bias(torch.from_numpy(np.ascontiguousarray(a).copy()))


def _raw(a: np.ndarray) -> torch.Tensor:
    """u32 numpy payload -> int32 plane with the same bits (unbiased)."""
    return torch.from_numpy(np.ascontiguousarray(a).copy()).view(torch.int32)


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


def _inputs():
    """The engine inputs of tests/test_torch_radix.py (same seed), plus
    12-bit keys filling one 128-row tile exactly and a 3-tile input."""
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


_INPUTS = _inputs()
_HIST_INPUTS = ("n1", "n127", "n16385", "e020_30000", "equal33000")
# 12 significant bits over exactly one 128-row tile: no pads, so the top
# five digits are constant and JAX's skip rule fires for those passes
_BOUNDED = np.random.default_rng(8).integers(0, 1 << 12, TILE * 128,
                                             dtype=np.uint32)
_SEG_KEYS = np.random.default_rng(9).integers(0, 2**32, 40_000,
                                              dtype=np.uint32)  # 3 tiles
_PAIR_KEYS = np.random.default_rng(6).integers(0, 256, 20_000,
                                               dtype=np.uint32)
_PAIR_VALS = np.arange(20_000, dtype=np.uint32)
_PAIR_RIDE2 = np.random.default_rng(7).integers(0, 2**32, 20_000,
                                                dtype=np.uint32)


@pytest.fixture(scope="module")
def jax_radix16():
    """Every JAX engine result the tests compare with, one call each."""
    res = {}
    for name, x in _INPUTS.items():
        res["keys", name] = np.asarray(jradix16.sort_codes_radix16(
            jnp.asarray(x), tile_rows=TILE))
    res["keys", "bounded"] = np.asarray(jradix16.sort_codes_radix16(
        jnp.asarray(_BOUNDED), tile_rows=TILE))
    k, v, w = (jnp.asarray(a) for a in (_PAIR_KEYS, _PAIR_VALS, _PAIR_RIDE2))
    res["pairs"] = tuple(map(np.asarray, jradix16.sort_pairs_radix16(
        k, v, tile_rows=TILE)))
    res["3ops"] = tuple(map(np.asarray, jradix16._sort_radix16(
        (k, v, w), TILE)))
    segs = jradix16.adversarial_segments(_SEG_KEYS.size, TILE)
    res["seg_keys"] = np.asarray(jradix16.sort_codes_radix16(
        jnp.asarray(_SEG_KEYS), tile_rows=TILE, segments=segs))
    res["seg_pairs"] = tuple(map(np.asarray, jradix16.sort_pairs_radix16(
        k, v, tile_rows=TILE,
        segments=jradix16.adversarial_segments(_PAIR_KEYS.size, TILE))))
    return res


# ---- the global histogram and the digit bases --------------------------------


@pytest.fixture(scope="module")
def jax_hist():
    return {name: (np.asarray(jkernels.global_histogram(
                       jnp.asarray(_INPUTS[name]), passes=4,
                       interpret=True)),
                   tuple(map(np.asarray, jradix16._bases_all_passes(
                       jnp.asarray(_INPUTS[name]), interpret=True))))
            for name in _HIST_INPUTS}


@pytest.mark.parametrize("name", _HIST_INPUTS)
def test_global_histogram_matches_jax(jax_hist, name):
    got = kernels.global_histogram(_t(_INPUTS[name]))
    assert got.dtype == torch.int32 and got.shape == (4, 256)
    np.testing.assert_array_equal(got.numpy(), jax_hist[name][0])
    for passes in (1, 3):
        np.testing.assert_array_equal(
            kernels.global_histogram(_t(_INPUTS[name]), passes).numpy(),
            jax_hist[name][0][:passes])


@pytest.mark.parametrize("name", _HIST_INPUTS)
def test_bases_all_passes_matches_jax(jax_hist, name):
    bases, counts = radix16._bases_all_passes(_t(_INPUTS[name]))
    assert bases.dtype == counts.dtype == torch.int32
    assert bases.shape == counts.shape == (8, 16)
    np.testing.assert_array_equal(bases.numpy(), jax_hist[name][1][0])
    np.testing.assert_array_equal(counts.numpy(), jax_hist[name][1][1])


# ---- one binning pass -------------------------------------------------------


@pytest.fixture(scope="module")
def pass_case():
    """Two 128-row tiles of low-entropy codes and two rides; each shift's
    global digit bases (numpy) go to both packages."""
    rng = np.random.default_rng(21)
    n = 2 * TILE * 128
    codes = rng.integers(0, 2**32, n, dtype=np.uint32)
    codes &= rng.integers(0, 2**32, n, dtype=np.uint32)
    codes[::3] = codes[0]
    rides = [np.arange(n, dtype=np.uint32),
             rng.integers(0, 2**32, n, dtype=np.uint32)]
    bases = {}
    for shift in (0, 28):
        counts = np.bincount((codes >> np.uint32(shift)) & np.uint32(15),
                             minlength=16)
        bases[shift] = (np.cumsum(counts) - counts).astype(np.int32)
    return codes, rides, bases


@pytest.mark.parametrize("num_ops", [1, 3])
@pytest.mark.parametrize("shift", [0, 28])
def test_binning_pass_matches_jax(pass_case, num_ops, shift):
    codes, rides, bases = pass_case
    rows = codes.size // 128
    ops_u32 = [codes] + rides[:num_ops - 1]
    call = jradix16._build_pass(rows, TILE, num_ops, True)
    ctrl = jnp.asarray(np.append(bases[shift], shift).astype(np.int32))
    jres = call(jnp.asarray(jradix16._within_row_sort_schedule()), ctrl,
                *[jnp.asarray(a.view(np.int32).reshape(rows, 128))
                  for a in ops_u32])
    planes = [_t(codes).view(rows, 128)] + [
        _raw(r).view(rows, 128) for r in rides[:num_ops - 1]]
    got, cursors_out = radix16.binning_pass(
        planes, torch.from_numpy(bases[shift]), shift, TILE)
    assert len(got) == num_ops
    np.testing.assert_array_equal(cursors_out.numpy(),
                                  np.asarray(jres[num_ops]))
    np.testing.assert_array_equal(
        _u32(got[0]), np.asarray(jres[0])[:rows].view(np.uint32))
    for g, j in zip(got[1:], jres[1:num_ops]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j)[:rows])


def test_binning_pass_segments_equal_fused(pass_case):
    """The pass cut after tile 0 writes the same buffers and cursors."""
    codes, rides, bases = pass_case
    rows = codes.size // 128
    planes = [_t(codes).view(rows, 128), _raw(rides[1]).view(rows, 128)]
    cur = torch.from_numpy(bases[28])
    want, wcur = radix16.binning_pass(planes, cur, 28, TILE)
    out = [torch.zeros_like(p) for p in planes]
    _, c = radix16.binning_pass([p[:TILE] for p in planes], cur, 28, TILE,
                                out)
    _, c = radix16.binning_pass([p[TILE:] for p in planes], c, 28, TILE, out)
    assert torch.equal(c, wcur)
    for o, w in zip(out, want):
        assert torch.equal(o, w)
    with pytest.raises(ValueError, match="whole tiles"):
        radix16.binning_pass(planes, cur, 28, 3)
    with pytest.raises(ValueError, match="cursors"):
        radix16.binning_pass(planes, cur[:8], 28, TILE)
    with pytest.raises(ValueError, match="shift"):
        radix16.binning_pass(planes, cur, 32, TILE)


# ---- the engine -------------------------------------------------------------


@pytest.mark.parametrize("name", list(_INPUTS))
def test_radix16_keys_match_jax(jax_radix16, name):
    got = radix16.sort_codes_radix16(_t(_INPUTS[name]), tile_rows=TILE)
    np.testing.assert_array_equal(_u32(got), jax_radix16["keys", name])


def test_radix16_pairs_match_jax(jax_radix16):
    """8-bit keys: long equal runs, so the payload shows stability."""
    sk, sv = radix16.sort_pairs_radix16(_t(_PAIR_KEYS), _raw(_PAIR_VALS),
                                        tile_rows=TILE)
    wk, wv = jax_radix16["pairs"]
    np.testing.assert_array_equal(_u32(sk), wk)
    np.testing.assert_array_equal(sv.numpy().view(np.uint32), wv)


def test_radix16_three_operands_match_jax(jax_radix16):
    got = radix16._sort_radix16((_t(_PAIR_KEYS), _raw(_PAIR_VALS),
                                 _raw(_PAIR_RIDE2)), TILE)
    want = jax_radix16["3ops"]
    np.testing.assert_array_equal(_u32(got[0]), want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), w)


def test_radix16_skips_constant_passes(jax_radix16, monkeypatch):
    """12-bit keys over one whole tile: passes 3-7 see one digit, whose
    count is the padded total (JAX's rule, radix16.py:662), so only passes
    0-2 run."""
    shifts = []
    real = radix16.binning_pass

    def counting(planes, cursors, shift, tile_rows, out=None):
        shifts.append(shift)
        return real(planes, cursors, shift, tile_rows, out)

    monkeypatch.setattr(radix16, "binning_pass", counting)
    got = radix16.sort_codes_radix16(_t(_BOUNDED), tile_rows=TILE)
    assert shifts == [0, 4, 8]
    np.testing.assert_array_equal(_u32(got), jax_radix16["keys", "bounded"])
    # a segmented run runs every pass, as JAX's does
    shifts.clear()
    radix16.sort_codes_radix16(_t(_BOUNDED), tile_rows=TILE // 2,
                               segments=(1,))
    assert shifts == [s for s in range(0, 32, 4) for _ in range(2)]


def test_radix16_segmented_keys_match_jax(jax_radix16):
    segs = radix16.adversarial_segments(_SEG_KEYS.size, TILE)
    assert segs == (1, 2)
    got = radix16.sort_codes_radix16(_t(_SEG_KEYS), tile_rows=TILE,
                                     segments=segs)
    np.testing.assert_array_equal(_u32(got), jax_radix16["seg_keys"])
    np.testing.assert_array_equal(_u32(got), np.sort(_SEG_KEYS))


def test_radix16_segmented_pairs_match_jax(jax_radix16):
    segs = radix16.adversarial_segments(_PAIR_KEYS.size, TILE)
    sk, sv = radix16.sort_pairs_radix16(_t(_PAIR_KEYS), _raw(_PAIR_VALS),
                                        tile_rows=TILE, segments=segs)
    wk, wv = jax_radix16["seg_pairs"]
    np.testing.assert_array_equal(_u32(sk), wk)
    np.testing.assert_array_equal(sv.numpy().view(np.uint32), wv)


@pytest.mark.parametrize("n,tile_rows", [(1, 512), (20_000, 128),
                                         (1 << 20, 512), (1 << 20, 32),
                                         (3 * 128 * 7, 7)])
def test_adversarial_segments_match_jax(n, tile_rows):
    assert radix16.adversarial_segments(n, tile_rows) == \
        jradix16.adversarial_segments(n, tile_rows)


@pytest.mark.parametrize("tile_rows", [1, 3, 128])
def test_radix16_any_tile(tile_rows):
    """Any tile of at least one row (JAX's multiple-of-128 rule is a TPU
    placement rule), fused and segmented."""
    x = _INPUTS["e020_30000"]
    v = _raw(np.arange(x.size, dtype=np.uint32))
    for segs in (None, radix16.adversarial_segments(x.size, tile_rows)):
        sk, sv = radix16.sort_pairs_radix16(_t(x), v, tile_rows=tile_rows,
                                            segments=segs)
        np.testing.assert_array_equal(_u32(sk), np.sort(x, kind="stable"))
        np.testing.assert_array_equal(sv.numpy(),
                                      np.argsort(x, kind="stable"))
    for bad in (0, -1):
        with pytest.raises(ValueError, match="tile_rows"):
            radix16.sort_codes_radix16(_t(x), tile_rows=bad)
        with pytest.raises(ValueError, match="tile_rows"):
            radix16.adversarial_segments(x.size, bad)
