"""Port parity for the splitsweep engine: the splitters, the bucket ids, the
16-bucket partition (the binning pass's digit-plane form, plain version on
the CPU), the keys, stable and pairs sorts, the two-level form, the
overflow fallback and the public entry points under
`variant="splitsweep"`, against gpusorting_tpu, bit for bit.

The same numpy inputs go through the JAX package on the CPU (its Pallas
kernels in interpret mode, as tests/test_splitsweep.py runs them) and through
the port on device="cpu", at `tile_rows=128` in both (the tile sets the
padding, and so the sample positions and the region size).  A JAX
splitsweep call takes seconds here, so each JAX result is computed once, in
a module-scoped fixture.  The CUDA kernels are tested on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpusorting_tpu as gst
import gpusorting_tpu_torch as gstt
from gpusorting_tpu.core import prng as jprng
from gpusorting_tpu.ops import splitsweep as jsplit
from gpusorting_tpu_torch.core import codec
from gpusorting_tpu_torch.ops import radix16, splitsweep, stitch

TILE = 128
SIZES = (1, 127, 16384, 16385, 40000)


def _t(a: np.ndarray) -> torch.Tensor:
    """u32 numpy codes -> the port's biased carrier."""
    return codec.bias(torch.from_numpy(np.ascontiguousarray(a).copy()))


def _raw(a: np.ndarray) -> torch.Tensor:
    """u32 numpy payload -> int32 plane with the same bits (unbiased)."""
    return torch.from_numpy(np.ascontiguousarray(a).copy()).view(torch.int32)


def _u32(t: torch.Tensor) -> np.ndarray:
    return codec.unbias(t.contiguous()).numpy()


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().numpy().view(np.uint32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread keeps the plain versions fast when several test
    processes share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs():
    n = 20000
    periodic = np.asarray(jprng.hybrid_taus_bits(n, seed=3))
    periodic = np.where(np.arange(n) % 3 == 0, np.uint32(0xFFFFFFFF),
                        periodic).astype(np.uint32)
    return {
        "uniform": np.asarray(jprng.hybrid_taus_bits(40000, seed=1)),
        "e020": np.asarray(jprng.make_test_keys(
            30000, 7, entropy=jprng.EntropyPreset.E020)),
        "all_equal": np.full(n, 0xDEADBEEF, np.uint32),
        "periodic_max": periodic,
    }


_INPUTS = _inputs()


def _padded(x: np.ndarray):
    """The JAX engine's padding at TILE: (padded codes, rows)."""
    n = x.shape[0]
    rows = max(TILE, -(-n // 128))
    rows = -(-rows // TILE) * TILE
    return np.concatenate([x, np.full(rows * 128 - n, 0xFFFFFFFF,
                                      np.uint32)]), rows


def _rides(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2**32, n, dtype=np.uint32),
            rng.integers(0, 2**32, n, dtype=np.uint32))


def _pair_keys(n, seed):
    """8-bit keys (long equal runs show stability), every 7th the max
    code, which must still come before the gaps."""
    k = np.asarray(jprng.hybrid_taus_bits(n, seed=seed)) & np.uint32(0xFF)
    k[::7] = 0xFFFFFFFF
    return k


@pytest.fixture(scope="module")
def jax_results():
    res = {}
    for n in SIZES:
        x = np.asarray(jprng.hybrid_taus_bits(n, seed=n))
        res["keys", n] = np.asarray(jsplit.sort_codes_splitsweep(
            jnp.asarray(x), tile_rows=TILE))
        k = _pair_keys(n, seed=n + 1)
        r1, r2 = _rides(n, seed=n)
        res["rides2", n] = tuple(map(np.asarray, jsplit.
                                     sort_stable_with_splitsweep(
                                         jnp.asarray(k), jnp.asarray(r1),
                                         jnp.asarray(r2), tile_rows=TILE)))
    res["pairs"] = tuple(map(np.asarray, jsplit.sort_pairs_splitsweep(
        jnp.asarray(_pair_keys(40000, 5)),
        jnp.asarray(_rides(40000, 5)[0]), tile_rows=TILE)))
    return res


# ---- splitters, buckets, partition ------------------------------------------


@pytest.mark.parametrize("name", list(_INPUTS))
def test_splitters_and_buckets_match_jax(name):
    xp, rows = _padded(_INPUTS[name])
    jpos = jnp.arange(xp.shape[0], dtype=jnp.uint32)
    jc, jp = jsplit._sample_splitters(jnp.asarray(xp), jpos, 64)
    jb = jsplit._bucketize(jnp.asarray(xp), jpos, jc, jp)
    pos = torch.arange(xp.shape[0], dtype=torch.int32)
    c, p = splitsweep._sample_splitters(_t(xp), pos, 64)
    np.testing.assert_array_equal(_u32(c), np.asarray(jc))
    np.testing.assert_array_equal(_bits(p), np.asarray(jp))
    b = splitsweep._bucketize(_t(xp), pos, c, p)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    assert splitsweep._cap_rows(rows, 1.35) == -(-int(
        np.ceil(rows * 1.35 / 16)) // 8) * 8


@pytest.mark.parametrize("num_ops", [1, 3])
@pytest.mark.parametrize("name", ["uniform", "e020"])
def test_partition_digit_plane_matches_jax(name, num_ops):
    """The binning pass's digit-plane form against JAX `_partition_16` on
    the valid slots of every region (the gaps are unspecified in both)."""
    xp, rows = _padded(_INPUTS[name])
    r1, r2 = _rides(xp.shape[0], seed=3)
    planes = [xp, r1, r2][:num_ops]
    jpos = jnp.arange(xp.shape[0], dtype=jnp.uint32)
    jc, jp = jsplit._sample_splitters(jnp.asarray(xp), jpos, 64)
    jb = np.asarray(jsplit._bucketize(jnp.asarray(xp), jpos, jc, jp))
    cap_rows = splitsweep._cap_rows(rows, 1.35)
    want = jsplit._partition_16(
        tuple(jnp.asarray(p.view(np.int32).reshape(rows, 128))
              for p in planes),
        jnp.asarray(jb.reshape(rows, 128)), cap_rows, TILE, True)
    bucket = torch.from_numpy(jb.reshape(rows, 128).copy())
    got = splitsweep._partition_16(
        [_raw(p).view(rows, 128) for p in planes], bucket, cap_rows, TILE)
    counts = np.bincount(jb, minlength=16)
    valid = (np.arange(cap_rows * 128)[None, :]
             < counts[:, None]).reshape(-1)
    for g, w in zip(got, want):
        assert g.shape == (16 * cap_rows, 128)
        np.testing.assert_array_equal(g.numpy().reshape(-1)[valid],
                                      np.asarray(w).reshape(-1)[valid])
    # the same pass through the public wrapper returns the cursors
    bases = torch.arange(16, dtype=torch.int32) * (cap_rows * 128)
    _, cur = radix16.binning_pass(
        [_raw(xp).view(rows, 128)], bases, 0, TILE,
        [torch.empty(16 * cap_rows, 128, dtype=torch.int32)], digits=bucket)
    np.testing.assert_array_equal(cur.numpy(), bases.numpy() + counts)


@pytest.mark.parametrize("bad", [-1, 16])
@pytest.mark.parametrize("fn", [radix16.binning_pass,
                                radix16.binning_pass_plain],
                         ids=["wrapper", "plain"])
def test_digit_plane_out_of_range_raises(fn, bad):
    """A digit outside [0, 16) raises in the wrapper and its plain version
    alike, before any element moves (the kernel indexes its bins by it)."""
    planes = [torch.arange(4 * 128, dtype=torch.int32).view(4, 128)]
    digits = torch.zeros(4, 128, dtype=torch.int32)
    digits[2, 7] = bad
    out = [torch.full((64, 128), 5, dtype=torch.int32)]
    with pytest.raises(ValueError, match="digits must lie"):
        fn(planes, torch.zeros(16, dtype=torch.int32), 0, 4, out,
           digits=digits)
    assert bool((out[0] == 5).all())


# ---- the engine ---------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_keys_match_jax(jax_results, n):
    x = np.asarray(jprng.hybrid_taus_bits(n, seed=n))
    got = splitsweep.sort_codes_splitsweep(_t(x), tile_rows=TILE)
    np.testing.assert_array_equal(_u32(got), jax_results["keys", n])


@pytest.mark.parametrize("n", SIZES)
def test_stable_with_rides_match_jax(jax_results, n):
    """Two rides against JAX; one ride is the same permutation, so it
    matches the first ride of the JAX two-ride sort."""
    k = _pair_keys(n, seed=n + 1)
    r1, r2 = _rides(n, seed=n)
    wk, w1, w2 = jax_results["rides2", n]
    sk, s1, s2 = splitsweep.sort_stable_with_splitsweep(
        _t(k), _raw(r1), _raw(r2), tile_rows=TILE)
    np.testing.assert_array_equal(_u32(sk), wk)
    np.testing.assert_array_equal(_bits(s1), w1)
    np.testing.assert_array_equal(_bits(s2), w2)
    ok, o1 = splitsweep.sort_stable_with_splitsweep(_t(k), _raw(r1),
                                                    tile_rows=TILE)
    np.testing.assert_array_equal(_u32(ok), wk)
    np.testing.assert_array_equal(_bits(o1), w1)


def test_pairs_match_jax(jax_results):
    k, v = _pair_keys(40000, 5), _rides(40000, 5)[0]
    sk, sv = splitsweep.sort_pairs_splitsweep(_t(k), _raw(v),
                                              tile_rows=TILE)
    wk, wv = jax_results["pairs"]
    np.testing.assert_array_equal(_u32(sk), wk)
    np.testing.assert_array_equal(_bits(sv), wv)


def test_two_level_matches_jax(monkeypatch):
    x = np.asarray(jprng.hybrid_taus_bits(20000, seed=9))
    want = np.asarray(jsplit.sort_codes_splitsweep(
        jnp.asarray(x), tile_rows=TILE,
        sub_sort=lambda r: jsplit.sort_codes_splitsweep(r, tile_rows=TILE)))
    calls = []
    real = splitsweep.sort_codes_splitsweep

    def second_level(r):
        calls.append(r.shape[0])
        return real(r, tile_rows=TILE)

    got = splitsweep.sort_codes_splitsweep(_t(x), tile_rows=TILE,
                                           sub_sort=second_level)
    np.testing.assert_array_equal(_u32(got), want)
    assert len(calls) == 16


def test_overflow_fallback_matches_jax(monkeypatch):
    """All-zero splitters put every element in the last bucket, which
    overflows its region: both packages take the exact flat sort."""
    def jbad(codes, pos, oversample):
        return (jnp.zeros((15,), codes.dtype), jnp.zeros((15,), jnp.uint32))

    def bad(codes, pos, oversample):
        # u32 zero is the biased carrier's minimum
        return (torch.full((15,), -2**31, dtype=torch.int32),
                torch.zeros(15, dtype=torch.int32))

    monkeypatch.setattr(jsplit, "_sample_splitters", jbad)
    monkeypatch.setattr(splitsweep, "_sample_splitters", bad)
    monkeypatch.setattr(stitch, "compact_ops", None)   # never reached
    x = np.asarray(jprng.hybrid_taus_bits(20000, seed=21))
    want = np.asarray(jsplit.sort_codes_splitsweep(jnp.asarray(x),
                                                   tile_rows=TILE))
    got = splitsweep.sort_codes_splitsweep(_t(x), tile_rows=TILE)
    np.testing.assert_array_equal(_u32(got), want)
    k, v = x & np.uint32(0xFF), np.arange(20000, dtype=np.uint32)
    wk, wv = jsplit.sort_pairs_splitsweep(jnp.asarray(k), jnp.asarray(v),
                                          tile_rows=TILE)
    sk, sv = splitsweep.sort_pairs_splitsweep(_t(k), _raw(v), tile_rows=TILE)
    np.testing.assert_array_equal(_u32(sk), np.asarray(wk))
    np.testing.assert_array_equal(_bits(sv), np.asarray(wv))


# ---- the public entry points ---------------------------------------------------


def test_public_entry_points_match_jax_splitsweep():
    """Each entry point once under `variant="splitsweep"` in both packages
    (f32 keys with NaN and +-0, descending where the key type allows a
    flip); tests/test_torch_radix.py holds the full matrix of key types and
    orders against the JAX flat oracle."""
    n = 5000
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2**32, n, dtype=np.uint32)
    bits[::5] = bits[0]
    bits[::97] = 0x7FC00000
    bits[1::97] = 0x80000000
    bits[2::97] = 0
    keys = bits.view(np.float32)
    tk = torch.from_numpy(keys.copy())
    jk = jnp.asarray(keys)
    jpal = {"backend": gst.Backend.PALLAS, "variant": "splitsweep",
            "tile_rows": TILE}
    tpal = {"backend": gstt.Backend.PALLAS, "variant": "splitsweep",
            "tile_rows": TILE}

    def eq(t, j):
        np.testing.assert_array_equal(
            t.contiguous().view(torch.int32).numpy(),
            np.asarray(j).view(np.int32))

    eq(gstt.sort(tk, order=gstt.Order.DESCENDING, **tpal),
       gst.sort(jk, order=gst.Order.DESCENDING, **jpal))
    lo, hi = _rides(n, seed=4)
    wk, wlo, whi = gst.sort_pairs_wide(jk, jnp.asarray(lo), jnp.asarray(hi),
                                       **jpal)
    gk, glo, ghi = gstt.sort_pairs_wide(tk, torch.from_numpy(lo),
                                        torch.from_numpy(hi), **tpal)
    eq(gk, wk)
    eq(glo, wlo)
    eq(ghi, whi)
    ik = bits.view(np.int32)
    eq(gstt.argsort(torch.from_numpy(ik.copy()), order=gstt.Order.DESCENDING,
                    **tpal),
       gst.argsort(jnp.asarray(ik), order=gst.Order.DESCENDING, **jpal))
