"""The 8-bit-digit radix sort (ops/radix256.py) on the CPU: its plain sort
and one plain pass against the JAX package's `sort` and numpy, bit for
bit; the route AUTO gives it (core/config.py `radix256_min`) and the
public `sort` through it.

The plain versions are what the wrapper runs for a CPU tensor and what the
card's kernels (csrc/binning256.cu) are held to in tests/test_torch_cuda.py
and chip_smoke.py.  The JAX package has no 8-bit-digit engine, so the sort
is held to its flat `sort`, which orders by the same u32 codes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpusorting_tpu as gst
import gpusorting_tpu_torch as gstt
from gpusorting_tpu_torch import ops
from gpusorting_tpu_torch.core import config
from gpusorting_tpu_torch.ops import flat_sort, radix256
from gpusorting_tpu_torch.utils import trace

PART = 512 * 20          # the kernel's partition (csrc/binning256.cu)
_NP = {"u32": np.uint32, "i32": np.int32, "f32": np.float32}
_TORCH = {"u32": torch.uint32, "i32": torch.int32, "f32": torch.float32}
_SPECIALS = np.array([0x7FC00000, 0xFFC00001, 0x00000000, 0x80000000,
                      0x7F800000, 0xFF800000, 0x7FFFFFFF, 0xFFFFFFFF,
                      0x00000001, 0x80000001], np.uint32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(n: int, kind: str, seed: int) -> np.ndarray:
    """n u32 bit patterns: uniform, E020 (4 more ANDed draws), all equal,
    or one digit in passes 1-3 (only the low byte varies)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, n, dtype=np.uint32)
    if kind == "e020":
        for _ in range(4):
            x &= rng.integers(0, 2**32, n, dtype=np.uint32)
    elif kind == "equal":
        x[:] = 0xDEADBEEF
    elif kind == "low_byte":
        x = (x & 0xFF) | 0x5A3C1E00
    x[::97] = _SPECIALS[np.arange(x[::97].size) % _SPECIALS.size]
    return x


def _codes(bits: np.ndarray, dt: str) -> np.ndarray:
    """numpy's u32 codes of raw bits (core/codec.py's bijections)."""
    if dt == "u32":
        return bits
    if dt == "i32":
        return bits ^ np.uint32(0x80000000)
    neg = (bits >> 31).astype(bool)
    return np.where(neg, ~bits, bits | np.uint32(0x80000000))


def _np_sort(bits: np.ndarray, dt: str) -> np.ndarray:
    return bits[np.argsort(_codes(bits, dt), kind="stable")]


def _torch(bits: np.ndarray, dt: str) -> torch.Tensor:
    return torch.from_numpy(bits.copy()).view(_TORCH[dt])


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


_CASES = [(0, "uniform"), (1, "uniform"), (PART - 1, "uniform"),
          (2 * PART + 5, "uniform"), (2 * PART + 5, "e020"),
          (PART + 3, "equal"), (2 * PART + 5, "low_byte")]


@pytest.mark.parametrize("dt", ["u32", "i32", "f32"])
@pytest.mark.parametrize("n,kind", _CASES)
def test_plain_sort_matches_numpy(dt, n, kind):
    bits = _bits(n, kind, n + 11)
    got = radix256.sort_plain(_torch(bits, dt))
    assert got.dtype == _TORCH[dt] and got.shape == (n,)
    assert np.array_equal(_u32(got), _np_sort(bits, dt))


@pytest.mark.parametrize("dt", ["u32", "i32", "f32"])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("n,kind", [(2 * PART + 5, "uniform"),
                                    (PART - 1, "e020"), (1, "uniform")])
def test_sort_matches_jax_sort(dt, descending, n, kind):
    """The plain sort, reversed for descending as the public route does,
    against the JAX package's sort, both orders, bit for bit."""
    bits = _bits(n, kind, n + 3)
    jorder = gst.Order.DESCENDING if descending else gst.Order.ASCENDING
    want = np.asarray(gst.sort(jnp.asarray(bits.view(_NP[dt])),
                               order=jorder)).view(np.uint32)
    got = radix256.sort_plain(_torch(bits, dt))
    if descending:
        got = got.view(torch.int32).flip(0).view(got.dtype)
    assert np.array_equal(_u32(got), want)


@pytest.mark.parametrize("shift", [0, 8, 16, 24])
@pytest.mark.parametrize("dt,kind", [("u32", "uniform"), ("f32", "e020"),
                                     ("i32", "equal"), ("u32", "low_byte")])
def test_plain_pass_matches_numpy(dt, kind, shift):
    """One pass: the j-th key of digit d lands at bases[d] + j, with the
    upsweep's bases equal to numpy's exclusive digit counts."""
    n = 2 * PART + 5
    bits = _bits(n, kind, shift + 5)
    digit = (_codes(bits, dt) >> shift) & 255
    counts = np.bincount(digit, minlength=256)
    bases = radix256.upsweep_plain(_torch(bits, dt))
    assert bases.shape == (4, 256)
    assert np.array_equal(bases[shift // 8].numpy(),
                          np.cumsum(counts) - counts)
    got = radix256.binning_pass_plain(_torch(bits, dt), bases[shift // 8],
                                      shift)
    assert np.array_equal(_u32(got), bits[np.argsort(digit, kind="stable")])


def test_plain_pass_refuses_other_shifts():
    with pytest.raises(ValueError, match="shift"):
        radix256.binning_pass_plain(torch.zeros(4, dtype=torch.int32),
                                    torch.zeros(256, dtype=torch.int64), 4)


def test_sort_refuses_bad_input():
    with pytest.raises(ValueError, match="1-D"):
        radix256.sort(torch.zeros(2, 2, dtype=torch.int32))
    with pytest.raises(TypeError):
        radix256.sort(torch.zeros(4, dtype=torch.int64))


_H100 = config.DeviceInfo("cuda", "NVIDIA H100 80GB HBM3", "h100", 1,
                          80 << 30, 3350.0)


def test_auto_engine_at_and_around_radix256_min():
    """Keys take radix256 from `radix256_min`; pairs with a 32-bit payload
    from their own `radix256_min_pairs`; 64-bit payloads and argsort's
    index never."""
    row = config.get_routing_parameters(_H100)
    m = row.radix256_min
    assert m is not None and row.radix256_min_pairs is not None
    K, P = config.Mode.KEYS_ONLY, config.Mode.PAIRS
    for n in (m, m + 1, 3 * m, 1 << 29, config.RADIX256_MAX_N):
        assert config.auto_engine(n, K, info=_H100) == "radix256", n
        assert config.auto_engine(n, P, info=_H100) == (
            "radix256" if n >= row.radix256_min_pairs else "xla"), n
        for kw in ({"payload_bits": 64}, {"index_payload": True}):
            assert config.auto_engine(n, P, info=_H100, **kw) == "xla"
    assert config.auto_engine(m - 1, K, info=_H100) == "xla"
    assert config.auto_engine(config.RADIX256_MAX_N + 1, K,
                              info=_H100) == "xla"
    other = dataclasses.replace(_H100, device_kind="NVIDIA A100",
                                generation="cuda")
    cpu = config.get_device_info("cpu")
    for n in (m, 1 << 28):
        assert config.auto_engine(n, K, info=other) == "xla"
        assert config.auto_engine(n, K, info=cpu) == "xla"


def test_auto_engine_radix256_under_overrides():
    """A row with both routes sends keys to rangesweep from its own
    threshold and to radix256 below it; the CPU stays on the flat sort."""
    config.set_routing_override(config.RoutingParameters(
        radix256_min=1 << 10, rangesweep_min=1 << 20))
    try:
        assert config.auto_engine(1 << 10, info=_H100) == "radix256"
        assert config.auto_engine((1 << 20) - 1, info=_H100) == "radix256"
        assert config.auto_engine(1 << 20, info=_H100) == "rangesweep"
        assert config.auto_engine(1 << 10, info=config.get_device_info(
            "cpu")) == "xla"
    finally:
        config.clear_routing_override()


@pytest.mark.parametrize("dt", ["u32", "i32", "f32"])
def test_public_sort_through_the_route(monkeypatch, dt):
    """ops.sort on the route: one `engine.radix256` span and no
    `engine.flat`, both orders equal to the flat sort (the route forced on
    the CPU, where the plain version runs)."""
    monkeypatch.setattr(ops, "auto_engine", lambda *a, **k: "radix256")
    x = _torch(_bits(2 * PART + 5, "uniform", 21), dt)
    for order in (gstt.Order.ASCENDING, gstt.Order.DESCENDING):
        before = trace.counts()
        got = gstt.sort(x, order=order)
        after = trace.counts()
        assert after.get("engine.radix256", 0) - before.get(
            "engine.radix256", 0) == 1
        assert after.get("engine.flat", 0) == before.get("engine.flat", 0)
        want = flat_sort.sort_keys(x, order=order)
        assert got.dtype == want.dtype
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the flat backend never takes the route
    before = trace.counts().get("engine.radix256", 0)
    gstt.sort(x, backend=gstt.Backend.XLA)
    assert trace.counts().get("engine.radix256", 0) == before
