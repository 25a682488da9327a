"""Port parity for the distributed sort (gpusorting_tpu_torch/parallel/)
against gpusorting_tpu's, bit for bit, per rank.

Eight gloo ranks are spawned ONCE for the module (`port` fixture) and run
every case of CASES in that one spawn; each case is then its own test,
which runs the JAX package's `distributed_sort` on the conftest's
8-device CPU mesh and compares rank r's outputs with JAX's block r: the
padded (D * cap,) codes, global index and payload bits, the count, the
overflow and the cap.  The JAX package is imported inside the tests only:
the spawned ranks re-import this module, and must not import JAX.

The cases are those of tests/test_distributed.py, of the multi-chip
dry run (`__graft_entry__.dryrun_multichip`) and of
tests/test_remote_exchange.py's distributed sorts.  JAX's remote-DMA path
runs its Pallas kernel in interpret mode (seconds a call), so the port's
"remote_dma" outputs are held against JAX's collective outputs, which JAX's
own tests hold to the same answer, and one case against JAX's remote_dma
itself.  Inputs come from the port's prng (bit-exact with JAX's,
tests/test_torch_prng.py) and numpy.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gpusorting_tpu_torch.core import prng
from gpusorting_tpu_torch.core.config import EntropyPreset
from gpusorting_tpu_torch.core import codec
from gpusorting_tpu_torch.parallel import dist_merge, dist_sort, remote_exchange
from gpusorting_tpu_torch.parallel.launch import run_ranks, step
from gpusorting_tpu_torch.utils import trace

D = 8
SPAWN_TIMEOUT = 240.0


def _bits(n, seed, and_count=0):
    return prng.hybrid_taus_bits(n, seed, and_count, device="cpu").numpy()


def _keys(n, seed, dtype=torch.uint32, entropy=EntropyPreset.E100):
    return prng.make_test_keys(n, seed, dtype, entropy, device="cpu").numpy()


def _adversarial_sample(n):
    """tests/test_distributed.py's input against the strided sampler:
    positions 0 mod 32 (the only ones sampled at stride 32) tiny, the rest
    huge, so the mass overflows a truncated top rung."""
    pos = np.arange(n, dtype=np.uint32)
    base = _bits(n, 11)
    return np.where(pos % 32 == 0, base & 0xFF, base | 0xF0000000
                    ).astype(np.uint32)


def _cases() -> dict:
    """name -> (keys, values or None, kwargs, gather, jax_exchange).

    gather: None, or the gather's check: "oracle" holds every rank's dense
    result against numpy's stable sort, "jax" also against JAX's
    `distributed_sort_gather` (kept to one case of keys, pairs and floats:
    each JAX call compiles anew, 2 s, and a JAX retry once per cap, 15-50
    s here)."""
    n13, n12 = 1 << 13, 1 << 12
    ar13 = np.arange(n13, dtype=np.uint32)
    ar12 = np.arange(n12, dtype=np.uint32)
    max_code = np.where(ar12 % 5 == 0, np.uint32(0xFFFFFFFF),
                        _keys(n12, 11)).astype(np.uint32)
    n_dry = 128 * D * 8
    dry = _keys(n_dry, 1)
    dry_skew = np.concatenate([np.zeros(n_dry // 2, np.uint32),
                               _keys(n_dry - n_dry // 2, 7)])
    zipf = np.minimum(np.random.RandomState(0).zipf(1.3, n13),
                      0xFFFFFFF).astype(np.uint32)
    c = "collective"
    return {
        # tests/test_distributed.py
        "uniform": (_keys(1 << 14, 2), None, {}, "jax", c),
        "pairs_stable": (_bits(n13, 4) & np.uint32(0x3F), ar13, {}, "jax",
                         c),
        "zipf": (zipf, None, {}, None, c),
        "e020": (_keys(n13, 6, entropy=EntropyPreset.E020), None,
                 {"oversample": 64}, None, c),
        "presorted": (ar13, None, {}, None, c),
        "all_equal_pairs": (np.full(n13, 42, np.uint32), ar13, {}, None, c),
        "max_code": (max_code, None, {}, "oracle", c),
        "cap128_overflow": (ar12, None, {"cap_elems": 128}, "oracle", c),
        "max_skew4": (_keys(n13, 9), None, {"max_skew": 4.0}, "oracle", c),
        "max_skew2_adversarial": (_adversarial_sample(n13), None,
                                  {"max_skew": 2.0}, "oracle", c),
        "exact_cap_seed1": (_keys(n12, 1), None, {}, None, c),
        "exact_cap_seed2": (_keys(n12, 2), None, {}, None, c),
        "f32": (_keys(n12, 8, torch.float32), None, {}, "jax", c),
        "i32_pairs": (_keys(n12, 3, torch.int32), _keys(n12, 4), {}, None,
                      c),
        "one_chunk": (_keys(n12, 5), ar12, {"exchange_chunks": 3}, None, c),
        # __graft_entry__.dryrun_multichip
        "dryrun_pairs": (dry, np.arange(n_dry, dtype=np.uint32), {},
                         "oracle", c),
        "dryrun_remote_dma": (dry, np.arange(n_dry, dtype=np.uint32),
                              {"cap_elems": n_dry // D,
                               "exchange": "remote_dma"}, None, c),
        "dryrun_all_equal": (np.full(n_dry, 0xABCD1234, np.uint32), None,
                             {}, None, c),
        "dryrun_skew_cap128": (dry_skew, None, {"cap_elems": 128},
                               "oracle", c),
        # tests/test_remote_exchange.py
        "remote_dma_pairs": ((ar13 * np.uint32(2654435761)) & np.uint32(0xFF),
                             ar13, {"cap_elems": n13 // D,
                                    "exchange": "remote_dma"}, "oracle", c),
        "remote_dma_all_equal": (np.full(n12, 42, np.uint32), None,
                                 {"cap_elems": n12 // D,
                                  "exchange": "remote_dma"}, None,
                                 "remote_dma"),
        "remote_dma_ladder": ((ar12 * np.uint32(2246822519))
                              & np.uint32(0x3F), None,
                              {"exchange": "remote_dma"}, "oracle", c),
    }


CASES = _cases()


def _shard(x, rank, world):
    n_local = x.shape[0] // world
    return torch.from_numpy(x[rank * n_local:(rank + 1) * n_local].copy())


def _error(fn):
    try:
        fn()
    except (ValueError, TypeError) as e:
        return f"{type(e).__name__}: {e}"
    return None


def _run_cases(rank, world, cases):
    """Every case on this rank: its distributed_sort outputs (and its
    gather where asked), then the calls that must raise."""
    out = {}
    for name, (keys, values, kw, gather, _) in cases.items():
        step(f"case {name}")
        k = _shard(keys, rank, world)
        v = None if values is None else _shard(values, rank, world)
        before = trace.counts()
        res = dist_sort.distributed_sort(k, v, **kw)
        after = trace.counts()
        rec = {f: res[f].view(torch.int32).numpy().view(np.uint32)
               for f in ("codes", "global_index", "payload_bits")
               if res[f] is not None}
        rec.update(count=int(res["count"]), overflow=int(res["overflow"]),
                   cap=res["cap"], n=res["n"],
                   merge_counts={key: after.get(key, 0) - before.get(key, 0)
                                 for key in ("dist.merge",
                                             "launch.dist_merge.merge_runs")})
        if gather:
            got, ovf = dist_sort.distributed_sort_gather(k, v, **kw)
            if v is not None:
                got, got_v = got
                rec["gather_values"] = got_v.numpy()
            rec.update(gather=got.numpy(), gather_overflow=ovf)
        out[name] = rec
    step("the calls that must raise")
    out["errors"] = {
        "empty": _error(lambda: dist_sort.distributed_sort(
            torch.zeros(0, dtype=torch.uint32))),
        "unequal": _error(lambda: dist_sort.distributed_sort(
            torch.zeros(16 + rank, dtype=torch.uint32))),
        "exchange": _error(lambda: dist_sort.distributed_sort(
            torch.zeros(16, dtype=torch.uint32), exchange="ici")),
        "payload64": _error(lambda: dist_sort.distributed_sort(
            torch.zeros(16, dtype=torch.uint32),
            torch.zeros(16, dtype=torch.int64))),
    }
    step("make_mesh(4)")
    mesh = dist_sort.make_mesh(4)      # every rank creates the group
    out["mesh4"] = (dist.get_world_size(mesh), dist.get_rank(mesh)) \
        if rank < 4 else None
    return out


@pytest.fixture(scope="module")
def port():
    """Every case on 8 spawned gloo ranks, once: one result dict a rank."""
    return run_ranks(_run_cases, D, CASES, timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_blocks(name, mesh):
    import jax.numpy as jnp
    from gpusorting_tpu.parallel import dist_sort as jdist

    keys, values, kw, _, jax_exchange = CASES[name]
    kw = dict(kw, exchange=jax_exchange)
    res = jdist.distributed_sort(
        jnp.asarray(keys), None if values is None else jnp.asarray(values),
        mesh=mesh, **kw)
    blocks = {f: np.asarray(res[f]).reshape(D, -1)
              for f in ("codes", "global_index", "payload_bits")
              if res[f] is not None}
    return blocks, np.asarray(res["counts"]), np.asarray(res["overflow"]), \
        res["cap"]


@pytest.mark.parametrize("name", list(CASES))
def test_distributed_sort_matches_jax_per_rank(port, cpu_mesh, name):
    blocks, counts, overflow, cap = _jax_blocks(name, cpu_mesh)
    keys = CASES[name][0]
    for r in range(D):
        got = port[r][name]
        assert got["cap"] == cap
        assert got["n"] == keys.shape[0]
        assert got["count"] == int(counts[r])
        assert got["overflow"] == int(overflow[r])
        assert set(blocks) == {f for f in ("codes", "global_index",
                                           "payload_bits") if f in got}
        for f, want in blocks.items():
            np.testing.assert_array_equal(got[f], want[r], err_msg=f"{f}@{r}")
    if CASES[name][2].get("cap_elems") == 128:
        assert int(overflow[0]) > 0       # the injection is reported
    if name == "max_skew2_adversarial":
        assert int(overflow[0]) > 0
    if name == "max_skew4":
        assert cap < keys.shape[0] // D   # the ladder top is truncated
    if name.startswith("exact_cap") or name in ("uniform", "presorted"):
        assert int(overflow[0]) == 0
        assert int(counts.sum()) == keys.shape[0]


@pytest.mark.parametrize("name", list(CASES))
def test_distributed_sort_merges_once_a_call(port, name):
    """Each call opens `dist.merge` once on every rank, and a CPU rank
    takes the plain merge: no kernel launch."""
    for r in range(D):
        assert port[r][name]["merge_counts"] == {
            "dist.merge": 1, "launch.dist_merge.merge_runs": 0}


_GATHERED = [n for n, c in CASES.items() if c[3]]


@pytest.mark.parametrize("name", _GATHERED)
def test_distributed_sort_gather_matches(port, cpu_mesh, name):
    keys, values, kw, gather, _ = CASES[name]
    perm = np.argsort(_order_codes(keys), kind="stable")
    for r in range(D):
        got = port[r][name]
        assert got["gather_overflow"] == 0
        np.testing.assert_array_equal(got["gather"].view(np.uint32),
                                      keys[perm].view(np.uint32))
        if values is not None:
            np.testing.assert_array_equal(got["gather_values"],
                                          values[perm])
    if gather == "jax":
        import jax.numpy as jnp
        from gpusorting_tpu.parallel import dist_sort as jdist

        out, ovf = jdist.distributed_sort_gather(
            jnp.asarray(keys), None if values is None else jnp.asarray(values),
            mesh=cpu_mesh, **kw)
        assert ovf == 0
        if values is not None:
            out, out_v = out
            np.testing.assert_array_equal(port[0][name]["gather_values"],
                                          np.asarray(out_v))
        np.testing.assert_array_equal(
            port[0][name]["gather"].view(np.uint32),
            np.asarray(out).view(np.uint32))


def _order_codes(keys):
    """u32 codes whose unsigned order is the key type's order (numpy)."""
    if keys.dtype == np.float32:
        i = keys.view(np.uint32)
        return np.where(i >> 31 == 1, ~i, i | np.uint32(0x80000000))
    if keys.dtype == np.int32:
        return keys.view(np.uint32) ^ np.uint32(0x80000000)
    return keys


@pytest.mark.parametrize("what,match", [
    ("empty", "ValueError: .*non-empty"),
    ("unequal", "ValueError: .*one length"),
    ("exchange", "ValueError: unknown exchange"),
    ("payload64", "TypeError: .*32-bit payloads"),
])
def test_distributed_sort_raises(port, what, match):
    import re

    for r in range(D):
        assert re.match(match, port[r]["errors"][what] or ""), \
            port[r]["errors"][what]


def test_make_mesh_subgroup(port):
    for r in range(D):
        assert port[r]["mesh4"] == ((4, r) if r < 4 else None)


def test_make_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        dist_sort.make_mesh()


# ---- plain tests: the host and local steps against JAX's functions -----

def test_splitters_from_sample_matches_jax():
    import jax.numpy as jnp
    from gpusorting_tpu.parallel import dist_sort as jdist
    from gpusorting_tpu_torch.core import codec

    rng = np.random.default_rng(3)
    for m, n_dev in ((256, 8), (1000, 5), (7, 8), (64, 1)):
        codes = rng.integers(0, 16, m, dtype=np.uint32)   # many ties
        codes[::9] = 0xFFFFFFFF
        gidx = rng.permutation(1 << 20)[:m].astype(np.uint32)
        gidx[-1] = 0xFFFFFFFF - 1
        want_c, want_g = jdist._splitters_from_sample(
            jnp.asarray(codes), jnp.asarray(gidx), n_dev)
        got_c, got_g = dist_sort._splitters_from_sample(
            codec.bias(torch.from_numpy(codes)),
            torch.from_numpy(gidx.view(np.int32)), n_dev)
        np.testing.assert_array_equal(
            codec.unbias(got_c).view(torch.int32).numpy().view(np.uint32),
            np.asarray(want_c))
        np.testing.assert_array_equal(got_g.numpy().view(np.uint32),
                                      np.asarray(want_g))


def test_cell_counts_blocked_tail_matches_jax():
    """JAX blocks its compare-reduction at 2^20 with a masked tail; the
    port's unblocked compare-reductions give the same counts on that
    input."""
    import jax.numpy as jnp
    from gpusorting_tpu.parallel import dist_sort as jdist
    from gpusorting_tpu_torch.core import codec

    n_local = (1 << 20) + 257
    codes = _bits(n_local, 5)
    gidx = np.arange(n_local, dtype=np.uint32)
    spl_c = np.asarray([1 << 30, 3 << 30], np.uint32)
    spl_g = np.asarray([n_local // 3, n_local // 2], np.uint32)
    want = np.asarray(jdist._cell_counts(
        jnp.asarray(codes), jnp.asarray(gidx), jnp.asarray(spl_c),
        jnp.asarray(spl_g), 3))
    got = dist_sort._cell_counts(
        codec.bias(torch.from_numpy(codes)),
        torch.from_numpy(gidx.view(np.int32)),
        codec.bias(torch.from_numpy(spl_c)),
        torch.from_numpy(spl_g.view(np.int32)), 3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    one = dist_sort._cell_counts(codec.bias(torch.from_numpy(codes)),
                                 torch.from_numpy(gidx.view(np.int32)),
                                 torch.zeros(0, dtype=torch.int32),
                                 torch.zeros(0, dtype=torch.int32), 1)
    np.testing.assert_array_equal(one.numpy(), [n_local])


_JAX_CPU_HBM = 8 << 30   # JAX's get_device_info on a non-TPU backend


@pytest.mark.parametrize("n,n_dev,num_ops", [
    (1 << 16, 8, 3), (1 << 30, 8, 3), (1 << 30, 8, 2), (1 << 13, 8, 2),
    (1 << 28, 1, 3), (1 << 26, 4, 3), (3 * (1 << 20), 7, 2),
])
def test_ladder_and_skew_match_jax(n, n_dev, num_ops):
    """At JAX's CPU budget the derived skew and the ladder are JAX's; the
    configs[4] shape (2^30 keys on 8 ranks) truncates the ladder."""
    from gpusorting_tpu.parallel import dist_sort as jdist

    skew = dist_sort._default_max_skew(n, n_dev, num_ops, _JAX_CPU_HBM)
    assert skew == jdist._default_max_skew(n, n_dev, num_ops)
    for s in (skew, None, 2.0, 4.0, float("inf")):
        assert dist_sort._cap_ladder(n, n_dev, s) == \
            jdist._cap_ladder(n, n_dev, s)
    if (n, n_dev) == (1 << 30, 8):
        assert skew is not None and 4.0 <= skew < 8.0
        caps = dist_sort._cap_ladder(n, n_dev, skew)
        assert caps[-1] < n // 8 and caps[-1] <= int(skew * n // 64) + 128
        assert dist_sort._cap_ladder(n, n_dev, float("inf"))[-1] == n // 8


def test_default_max_skew_without_a_budget():
    """The CPU reports no device memory (hbm_bytes 0): the drop-proof
    ladder at every size; an 80 GB card truncates configs[4] to the
    (2^25, 2^26) ladder."""
    assert dist_sort._default_max_skew(1 << 30, 8, 3, 0) is None
    skew = dist_sort._default_max_skew(1 << 30, 8, 3, 80 * 10**9)
    assert skew == 4.0
    assert dist_sort._cap_ladder(1 << 30, 8, skew) == (1 << 25, 1 << 26)


def test_merges_agree():
    """The merge gives the (code, global index) order on 2 and 3 operands,
    with the masked tails (code SENTINEL, index 0xFFFFFFFF) after real
    max-code keys."""
    from gpusorting_tpu_torch.core import codec

    rng = np.random.default_rng(9)
    n = 5000
    codes = rng.integers(0, 8, n).astype(np.int32)
    codes[::7] = codec.SENTINEL
    gidx = rng.permutation(n).astype(np.int32)
    gidx[::11] = -1
    codes[::11] = codec.SENTINEL
    pay = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    pay[::11] = 0
    flat = [torch.from_numpy(x) for x in (codes, gidx, pay)]
    order = np.lexsort((gidx.view(np.uint32), codes))
    for num_ops in (2, 3):
        got = dist_merge.merge_plain(flat[:num_ops])
        assert len(got) == num_ops
        for x, w in zip(got, (codes, gidx, pay)):
            np.testing.assert_array_equal(x.numpy(), w[order])


def received_runs(d, chunks, cw, num_ops, rc, keys, seed, ring=False):
    """What the exchange leaves a rank: per operand the (chunks, D, cw)
    blocks (with `ring`, (D, cap) rows of a stacked (D, num_ops, cap)
    buffer, row stride num_ops * cap), run s sorted by (code, global
    index), its global indices above every one of source s - 1, the slots
    past min(rc[s], cap) masked with the fills; rc as an int32 tensor.
    `keys`: "zipf" (Zipf(1.3) codes), "one_key" (every code 1),
    "max_code" (Zipf codes, the last 5 valid slots of each run the max
    code, a real key, so every run boundary holds max-code keys beside
    the masked tail's)."""
    rng = np.random.default_rng(seed)
    cap = chunks * cw
    codes = np.empty((d, cap), np.uint32)
    gidx = np.empty((d, cap), np.uint32)
    for s in range(d):
        if keys == "one_key":
            c = np.ones(cap, np.uint32)
        else:
            c = np.minimum(rng.zipf(1.3, cap), 0xFFFFFFF).astype(np.uint32)
        if keys == "max_code":
            c[max(0, min(rc[s], cap) - 5):] = 0xFFFFFFFF
        g = (s * 4 * cap + rng.permutation(4 * cap)[:cap]).astype(np.uint32)
        order = np.lexsort((g, c))
        codes[s], gidx[s] = c[order], g[order]
    pay = rng.integers(-2**31, 2**31 - 1, (d, cap)).astype(np.int32)
    ops = [codec.bias(torch.from_numpy(codes)),
           torch.from_numpy(gidx.view(np.int32)), torch.from_numpy(pay)]
    ops = ops[:num_ops]
    rc_t = torch.tensor(rc, dtype=torch.int32)
    fills = (codec.SENTINEL, -1, 0)[:num_ops]
    remote_exchange.mask_arrivals_plain(ops, rc_t, fills)
    if ring:
        stacked = torch.stack(ops, dim=1)           # (D, num_ops, cap)
        return [stacked[:, o] for o in range(num_ops)], rc_t, fills
    return [x.view(d, chunks, cw).transpose(0, 1).contiguous()
            for x in ops], rc_t, fills


def merge_then_pad(planes, pad_to, fills):
    """The parent's merge: `merge_plain` of every slot, masked tails
    included, then each plane padded to pad_to by a concatenation."""
    out = dist_merge.merge_plain([p.reshape(-1) for p in planes])
    return [torch.cat([x, x.new_full((pad_to - x.shape[0],), f)])
            for x, f in zip(out, fills)]


# name -> (d, chunks, cw, num_ops, rc, keys, pad_to / (d * cap), ring)
MERGE_CASES = {
    "chunks4_pairs_pad2": (4, 4, 128, 3, [0, 300, 512, 700], "zipf", 2,
                           False),
    "chunks4_keys_pad1": (4, 4, 128, 2, [512, 1, 511, 513], "zipf", 1,
                          False),
    "chunks1_pairs_max_code": (4, 1, 2048, 3, [2048, 1500, 0, 4000],
                               "max_code", 2, False),
    "chunks1_keys_max_code": (3, 1, 512, 2, [7, 512, 600], "max_code", 1,
                              False),
    "ring_rows_pairs": (4, 1, 1024, 3, [1024, 0, 333, 2000], "max_code", 2,
                        True),
    "ring_rows_keys": (2, 1, 640, 2, [640, 100], "zipf", 1, True),
    "one_key_runs": (4, 4, 256, 3, [1024, 1024, 900, 5000], "one_key", 2,
                     False),
    "one_source": (1, 4, 32, 3, [77], "zipf", 2, False),
    "all_empty": (4, 4, 32, 3, [0, 0, 0, 0], "zipf", 2, False),
    "d8_chunks4": (8, 4, 64, 3, [256, 0, 1, 255, 256, 999, 128, 37],
                   "max_code", 1, False),
    "d16_chunks4": (16, 4, 16, 3, [64, 0, 63, 65, 1, 64, 30, 0, 64, 7, 100,
                                   64, 2, 33, 64, 63], "max_code", 2, False),
    "d32_keys": (32, 1, 40, 2, [(7 * s) % 45 for s in range(32)], "zipf", 1,
                 False),
}


@pytest.mark.parametrize("name", list(MERGE_CASES))
def test_merge_runs_plain_is_merge_then_pad(name):
    """The wrapper on CPU tensors (its plain version, no launch) gives the
    parent's `_merge` and padding bit for bit: chunked and ring layouts,
    2 and 3 operands, pad_to D * cap and twice it, counts of 0, below,
    at and above the cell, max-code keys at every run boundary, runs of
    one key."""
    d, chunks, cw, num_ops, rc, keys, pad, ring = MERGE_CASES[name]
    planes, rc_t, fills = received_runs(d, chunks, cw, num_ops, rc, keys,
                                        seed=len(name), ring=ring)
    cap = chunks * cw
    pad_to = pad * d * cap
    before = dist_merge.merge_runs.launches
    got = dist_merge.merge_runs(planes, rc_t, cap, pad_to, fills)
    assert dist_merge.merge_runs.launches == before
    want = merge_then_pad(planes, pad_to, fills)
    assert len(got) == num_ops
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (pad_to,)
        assert torch.equal(g, w)
    total = sum(min(max(r, 0), cap) for r in rc)
    assert bool((got[0][total:] == codec.SENTINEL).all())


def test_merge_runs_reads_only_the_valid_prefix():
    """Slots past a run's valid prefix are never read: garbage there (no
    mask) gives the masked runs' result."""
    planes, rc_t, fills = received_runs(4, 4, 64, 3, [10, 256, 0, 200],
                                        "zipf", seed=3)
    want = dist_merge.merge_runs(planes, rc_t, 256, 2048, fills)
    pos = torch.arange(256).view(4, 64)      # (chunk, column) -> position
    dirty = [p.clone() for p in planes]
    for p in dirty:
        for s, n in enumerate([10, 256, 0, 200]):
            p[:, s][pos >= n] = -12345
    got = dist_merge.merge_runs(dirty, rc_t, 256, 2048, fills)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_merge_runs_refuses_bad_operands():
    planes, rc_t, fills = received_runs(4, 4, 32, 3, [1, 2, 3, 4], "zipf",
                                        seed=4)
    with pytest.raises(ValueError, match="pad_to"):
        dist_merge.merge_runs(planes, rc_t, 128, 511, fills)
    with pytest.raises(ValueError, match="runs of cap"):
        dist_merge.merge_runs(planes, rc_t, 256, 1024, fills)
    with pytest.raises(ValueError, match="fills"):
        dist_merge.merge_runs(planes, rc_t, 128, 512, fills[:2])
    with pytest.raises(TypeError, match="rc"):
        dist_merge.merge_runs(planes, rc_t.long(), 128, 512, fills)
    with pytest.raises(ValueError, match="planes\\[1\\]"):
        dist_merge.merge_runs([planes[0], planes[1][:, :, :16]], rc_t, 128,
                              512, fills[:2])
    with pytest.raises(ValueError, match="2-3 planes"):
        dist_merge.merge_runs(planes[:1], rc_t, 128, 512, fills[:1])
    # only an all-CPU call takes the plain merge
    with pytest.raises(ValueError, match="planes\\[2\\] on meta"):
        dist_merge.merge_runs(planes[:2] + [planes[2].to("meta")], rc_t, 128,
                              512, fills)


def test_fills_are_the_carriers():
    assert remote_exchange.raw_fills(3) == (-1, -1, 0)
    assert remote_exchange.raw_fills(2) == (-1, -1)


def test_package_exports():
    import gpusorting_tpu_torch as gstt

    assert gstt.distributed_sort is dist_sort.distributed_sort
    assert gstt.distributed_sort_gather is dist_sort.distributed_sort_gather
    assert gstt.make_mesh is dist_sort.make_mesh
    assert {"distributed_sort", "distributed_sort_gather",
            "make_mesh"} <= set(gstt.__all__)
