"""The segmented sort of equal rows of f32 keys with u32 indices (a top-p
sampler's per-row sort of logits) through the fixed-length route, against
the plain PyTorch oracle (sortbench/plain_rows.py: one stable sort of the
int64 (row, code) key, not the port's batched row sort) and against the
JAX package's split_sort_pairs, bit for bit, on the CPU with the H100's
routing row installed, so that the CPU takes the card's route.

The keys hold NaNs of both signs, -0.0 and +0.0, both infinities,
denormals of both signs and repeated values, so the f32 transform's order
(negative NaNs first, -0.0 before +0.0, positive NaNs last) and stability
both show.  Each call counts `engine.fixed` and `fixed.sort` once,
`fixed.gather` once with a payload and never without, and no tile or
composite span.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpusorting_tpu as gst
import gpusorting_tpu_torch as gstt
from gpusorting_tpu_torch.core import config
from gpusorting_tpu_torch.utils import trace
from sortbench import plain_rows

# NaNs of both signs with payloads, -0.0, +0.0, +-inf, denormals of both
# signs, the extremes, 1.0 and -1.0
SPECIALS = np.array([0x7FC00000, 0x7F800001, 0xFFC00000, 0xFF800001,
                     0x80000000, 0, 0x7F800000, 0xFF800000, 1, 0x80000001,
                     0x007FFFFF, 0x807FFFFF, 0x7F7FFFFF, 0xFF7FFFFF,
                     0x3F800000, 0xBF800000], dtype=np.uint32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread keeps the small sorts fast when several test
    processes share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def h100_row():
    config.set_routing_override(config._ROUTING_TABLE["h100"])
    yield
    config.clear_routing_override()


def _rows(rows, L, seed):
    """Random f32 bit patterns, a quarter from SPECIALS and a quarter
    repeating a few values of the row; the offsets of `rows` rows of L."""
    rng = np.random.default_rng(seed)
    n = rows * L
    bits = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    pick = rng.random(n)
    special = pick < 0.25
    bits[special] = rng.choice(SPECIALS, int(special.sum()))
    rep = pick > 0.75
    bits[rep] = rng.choice(bits[:5], int(rep.sum()))
    starts = np.arange(rows, dtype=np.int64) * L
    return bits, starts


def _spans():
    return {k: v for k, v in trace.counts().items()
            if v and k.startswith(("engine.", "fixed.", "composite.",
                                   "payload."))}


@pytest.mark.parametrize("pairs", [True, False], ids=["pairs", "keys"])
@pytest.mark.parametrize("rows,L", [(1, 1000), (3, 1000), (4, 1000),
                                    (1, 4099), (3, 4099), (4, 4099)])
def test_f32_rows_match_the_plain_rows_and_jax(h100_row, rows, L, pairs):
    bits, starts = _rows(rows, L, seed=rows * 7919 + L)
    n = bits.shape[0]
    keys = torch.from_numpy(bits.view(np.int32)).view(torch.float32)
    index = torch.arange(n, dtype=torch.int32).view(torch.uint32)
    offs = torch.from_numpy(starts.astype(np.int32))
    trace.reset()
    if pairs:
        gk, gv = gstt.split_sort_pairs(offs, keys, index, rows, n)
    else:
        gk, gv = gstt.split_sort_keys(offs, keys, rows), None
    assert _spans() == {"engine.fixed": 1, "fixed.sort": 1,
                        **({"fixed.gather": 1} if pairs else {})}
    assert gk.dtype == torch.float32
    got_k = gk.view(torch.int32).numpy()

    wk, wv = plain_rows.sort_rows_blocked(keys, index, starts)
    np.testing.assert_array_equal(got_k, wk.view(torch.int32).numpy())

    jout = gst.split_sort_pairs(
        jnp.asarray(starts.astype(np.uint32)),
        jnp.asarray(bits.view(np.float32)),
        jnp.asarray(np.arange(n, dtype=np.uint32)) if pairs else None,
        rows, n)
    jk, jv = jout if pairs else (jout, None)
    np.testing.assert_array_equal(got_k, np.asarray(jk).view(np.int32))
    if pairs:
        assert gv.dtype == torch.uint32
        got_v = gv.view(torch.int32).numpy()
        np.testing.assert_array_equal(got_v, wv.view(torch.int32).numpy())
        np.testing.assert_array_equal(got_v, np.asarray(jv).view(np.int32))
        # each index still names its own key
        np.testing.assert_array_equal(bits.view(np.int32)[got_v], got_k)
