"""The plain reference: what it accepts, what it rejects, and the control
it must fail."""

import numpy as np
import pytest

from sortbench import reference as ref


def _segmented(seed=0, n=3000, max_len=32):
    rng = np.random.default_rng(seed)
    lens = []
    while sum(lens) < n:
        lens.append(int(rng.integers(1, max_len + 1)))
    lens[-1] -= sum(lens) - n
    starts = np.zeros(len(lens), np.int64)
    starts[1:] = np.cumsum(lens[:-1])
    keys = rng.integers(0, 64, n).astype(np.uint32)   # many equal keys
    vals = np.arange(n, dtype=np.uint32)
    return ref.HostInput(keys, "uint32", vals, starts)


def _plain_segmented_sort(inp):
    """Each segment sorted alone by Python's stable sort."""
    n = inp.key_bits.shape[0]
    bounds = list(inp.starts) + [n]
    ks, vs = [], []
    for a, b in zip(bounds[:-1], bounds[1:]):
        pairs = sorted(zip(inp.key_bits[a:b], inp.values[a:b]),
                       key=lambda p: p[0])
        ks += [k for k, _ in pairs]
        vs += [v for _, v in pairs]
    return np.array(ks, np.uint32), np.array(vs, np.uint32)


def test_segmented_pairs_match_a_plain_loop():
    inp = _segmented()
    exp = ref.expected(inp, "pairs")
    k, v = _plain_segmented_sort(inp)
    assert np.array_equal(exp["keys"], k) and np.array_equal(exp["values"], v)
    assert ref.judge({"keys": k, "values": v}, inp, exp) == {
        "keys_wrong": 0, "values_wrong": 0}


@pytest.mark.parametrize("fault", ["swapped_pair", "unstable",
                                   "across_boundary", "values_missing"])
def test_rejects(fault):
    inp = _segmented(1)
    exp = ref.expected(inp, "pairs")
    k, v = exp["keys"].copy(), exp["values"].copy()
    n = k.shape[0]
    if fault == "swapped_pair":          # two payloads trade keys
        i = next(i for i in range(n - 1) if k[i] != k[i + 1])
        v[i], v[i + 1] = v[i + 1], v[i]
    elif fault == "unstable":            # equal keys out of input order
        i = next(i for i in range(n - 1) if k[i] == k[i + 1])
        v[i], v[i + 1] = v[i + 1], v[i]
    elif fault == "across_boundary":     # a key moved into the next segment
        s = int(inp.starts[5])
        k[s - 1], k[s] = k[s], k[s - 1]
        v[s - 1], v[s] = v[s], v[s - 1]
    else:
        v = None
    got = {"keys": k} if v is None else {"keys": k, "values": v}
    counts = ref.judge(got, inp, exp)
    assert sum(counts.values()) > 0
    assert not ref.verdict({"calls_checked": 1, **counts})[0]


@pytest.mark.parametrize("dtype", ["uint32", "int32", "float32"])
def test_flat_order_by_key_type(dtype):
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    if dtype == "float32":
        bits[:4] = np.array([0x80000000, 0, 0x7FC00000, 0xFF800000],
                            np.uint32)          # -0, +0, NaN, -inf
    inp = ref.HostInput(bits, dtype, np.arange(5000, dtype=np.uint32))
    exp = ref.expected(inp, "pairs")
    typed = bits.view({"uint32": np.uint32, "int32": np.int32,
                       "float32": np.float32}[dtype])
    want = np.argsort(typed if dtype != "float32" else
                      ref.codes(bits, dtype), kind="stable")
    assert np.array_equal(exp["values"], want.astype(np.uint32))
    if dtype != "float32":
        assert np.array_equal(exp["keys"], ref.codes(np.sort(typed).view(
            np.uint32), dtype))
    desc = ref.expected(inp, "pairs", descending=True)
    assert np.array_equal(desc["values"], exp["values"][::-1])
    perm = ref.expected(inp, "argsort")["perm"]
    assert np.array_equal(perm, want)


@pytest.mark.parametrize("mode,segmented", [("keys", False), ("pairs", False),
                                            ("pairs", True), ("keys", True),
                                            ("argsort", False)])
def test_the_control_fails(mode, segmented):
    rng = np.random.default_rng(11)
    n = 20000
    bits = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    starts = _segmented(2, n, 4096).starts if segmented else None
    inp = ref.HostInput(bits, "uint32", np.arange(n, dtype=np.uint32),
                        starts)
    exp = ref.expected(inp, mode)
    counts = ref.judge(ref.control(inp, mode), inp, exp)
    assert sum(counts.values()) > 0
    assert sum(ref.judge(exp, inp, exp).values()) == 0
