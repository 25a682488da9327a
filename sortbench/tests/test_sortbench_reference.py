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


def _global(n=6000, world=4, seed=3):
    """A global input of few distinct keys, its stable order, and each
    rank's run of it (codes, payloads)."""
    import torch
    rng = np.random.default_rng(seed)
    keys = torch.from_numpy(rng.integers(0, 40, n).astype(np.int32))
    keys[::7] = -5                       # u32 keys above 2^31 too
    order = torch.sort(keys.to(torch.int64) & 0xFFFFFFFF, stable=True).indices
    codes, vals = keys[order], order.to(torch.int32)
    cuts = [0, 1000, 2600, 4500, n]      # uneven runs, as ranks hold them
    runs = [(codes[a:b], vals[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
    return keys, runs


def _judge(keys, runs, counts=None, overflow=0, block=1 << 26):
    import torch
    counts = counts or [c.shape[0] for c, _ in runs]
    held = [min(k, c.shape[0]) for k, (c, _) in zip(counts, runs)]
    return ref.judge_runs(torch.cat([c[:h] for (c, _), h in zip(runs, held)]),
                          torch.cat([v[:h] for (_, v), h in zip(runs, held)]),
                          counts, held, overflow, keys, "uint32", block)


@pytest.mark.parametrize("block", [1 << 26, 1000, 7])
def test_distributed_runs_of_the_stable_order_pass(block):
    keys, runs = _global()
    assert _judge(keys, runs, block=block) == {
        "keys_wrong": 0, "values_wrong": 0, "count_sum_off": 0,
        "overflow": 0}


@pytest.mark.parametrize("fault,name", [
    ("swap_across_runs", "values_wrong"), ("key_changed", "keys_wrong"),
    ("out_of_order", "keys_wrong"), ("dropped", "count_sum_off"),
    ("doubled", "values_wrong"), ("count_high", "count_sum_off"),
    ("payload_out_of_range", "keys_wrong"), ("overflow", "overflow")])
def test_distributed_runs_reject(fault, name):
    keys, runs = _global()
    runs = [(c.clone(), v.clone()) for c, v in runs]
    counts, overflow = None, 0
    (c0, v0), (c1, v1) = runs[0], runs[1]
    if fault == "swap_across_runs":     # equal keys across a boundary
        c0[-1], v0[-1], c1[0], v1[0] = c1[0], v1[0], c0[-1], v0[-1]
        assert c0[-1] == c1[0]
    elif fault == "key_changed":
        c1[5] ^= 1
    elif fault == "out_of_order":       # keys and payloads move together
        i = int(np.nonzero((c1[:-1] != c1[1:]).numpy())[0][0])
        c1[[i, i + 1]], v1[[i, i + 1]] = c1[[i + 1, i]], v1[[i + 1, i]]
    elif fault == "dropped":
        runs[1] = (c1[1:], v1[1:])
    elif fault == "doubled":            # one pair twice, its neighbour lost
        i = int(np.nonzero((c1[:-1] == c1[1:]).numpy())[0][0])
        v1[i + 1] = v1[i]
    elif fault == "count_high":         # a count past what the run holds
        counts = [c.shape[0] for c, _ in runs]
        counts[2] += 1
    elif fault == "payload_out_of_range":
        v1[3] = 6000
    else:
        overflow = 3
    wrong = _judge(keys, runs, counts, overflow)
    assert wrong[name] > 0, wrong


def test_the_distributed_control_breaks_the_order():
    import torch
    keys = torch.from_numpy(np.random.default_rng(5).integers(
        0, 1 << 20, 4000).astype(np.int32))
    vals = torch.arange(4000, dtype=torch.int32)
    order = ref.control_order(keys, "uint32", block=1000)
    k, v = keys[order], vals[order]
    runs = [(k[i:i + 1000], v[i:i + 1000]) for i in range(0, 4000, 1000)]
    assert _judge(keys, runs)["keys_wrong"] > 0
    # and it is the stable order of the top 16 bits
    top = (keys.to(torch.int64) & 0xFFFFFFFF) >> 16
    assert torch.equal(v.to(torch.int64),
                       torch.sort(top, stable=True).indices)
