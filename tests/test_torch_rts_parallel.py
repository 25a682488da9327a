"""Port parity for the row-writing ("parallel") form of the reduce-then-scan
pass, which GST_MEGACORE=1 selects: the gate, `downsweep_rows` and
`edge_fixup` (their plain versions on the CPU), `edge_rows`, one whole pass,
the engine and every `device_radix` entry point, against gpusorting_tpu,
bit for bit.

The kernel-level cases feed the JAX package's `_build_downsweep(...,
parallel=True)` and `_build_edge_fixup` (interpret mode, as
tests/test_rts.py runs them) exactly as `run_downsweep_chunks` feeds them,
on 3 tiles of 128 rows with n not a multiple of 128.  A JAX Pallas build
costs seconds, so every input shares one padded shape and each JAX kernel
is built once per operand count (its build functions cache) in a
module-scoped fixture.  The port carries codes as biased int32, so plane 0
is compared on the slots a range owns, with the bias applied to the JAX
side; the other planes are compared whole.  The CUDA kernels are tested on
the card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpusorting_tpu as gst
import gpusorting_tpu_torch as gstt
from gpusorting_tpu.ops import radix16 as jradix16
from gpusorting_tpu.ops import rts as jrts
from gpusorting_tpu_torch.core import codec, config
from gpusorting_tpu_torch.ops import kernels, rts

TILE = 128
T = 3
ROWS = T * TILE
N = ROWS * 128 - 77
SIGN = np.int32(-2**31)
SHIFTS = (0, 28)


def _inputs():
    rng = np.random.default_rng(71)
    e020 = rng.integers(0, 2**32, N, dtype=np.uint32)
    for _ in range(4):                     # E020: 4 extra ANDed draws
        e020 &= rng.integers(0, 2**32, N, dtype=np.uint32)
    # digit 5 at shifts 0 and 28 for 1-3 keys a tile, digit 0 elsewhere:
    # the tiles' digit-5 ranges are tiny and land in one output row
    sparse = rng.integers(0, 2**32, N, dtype=np.uint32) & np.uint32(
        0x0FFFFFF0)
    for t in range(T):
        lo, hi = t * TILE * 128, min((t + 1) * TILE * 128, N)
        sparse[rng.integers(lo, hi, rng.integers(1, 4))] |= np.uint32(
            0x50000005)
    return {
        "uniform": rng.integers(0, 2**32, N, dtype=np.uint32),
        "e020": e020,
        "all_equal": np.full(N, 0xDEADBEEF, np.uint32),
        "sparse_digit": sparse,
    }


INPUTS = _inputs()
RIDES = (np.arange(N, dtype=np.uint32),
         np.random.default_rng(72).integers(0, 2**32, N, dtype=np.uint32))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops; one intra-op thread
    keeps them fast when several test processes share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _padded(name, num_ops):
    """The operands padded as both engines pad them (the sentinel code in
    plane 0, zeros in the rides): u32 numpy (ROWS, 128) planes."""
    out = []
    for i, a in enumerate((INPUTS[name],) + RIDES[:num_ops - 1]):
        fill = 0xFFFFFFFF if i == 0 else 0
        out.append(np.concatenate([a, np.full(ROWS * 128 - N, fill,
                                              np.uint32)]).reshape(ROWS, 128))
    return out


def _port_planes(planes_u32):
    return [codec.bias(torch.from_numpy(planes_u32[0].reshape(-1).copy()))
            .view(ROWS, 128)] + [torch.from_numpy(p.copy()).view(torch.int32)
                                 for p in planes_u32[1:]]


def _tables(plane0, shift):
    """numpy (T, 16) counts and the digit-major (16 * T,) cursor table."""
    d = (plane0.reshape(-1) >> np.uint32(shift)) & np.uint32(15)
    counts = np.stack([np.bincount(d[t * TILE * 128:(t + 1) * TILE * 128],
                                   minlength=16) for t in range(T)])
    dm = counts.T.reshape(-1)
    return counts.astype(np.int32), (np.cumsum(dm) - dm).astype(np.int32)


def _owned(rowtab, table, counts):
    """(T, 16, 2, 128) mask of the slots of each side row that its range
    owns (False for absent entries), and the (ROWS,) mask of rows that one
    range owns whole (no entry names them)."""
    cur = table.reshape(16, T).T
    rt = rowtab.reshape(2, 16, T).transpose(2, 1, 0)
    slot = np.maximum(rt, 0)[..., None] * 128 + np.arange(128)
    side = ((slot >= cur[:, :, None, None])
            & (slot < (cur + counts)[:, :, None, None])
            & (rt >= 0)[..., None])
    whole = np.ones(ROWS, bool)
    whole[rt[rt >= 0]] = False
    return side, whole


def _case_keys():
    return [(name, num_ops, shift) for name in INPUTS
            for num_ops in (1, 2, 3) for shift in SHIFTS]


@pytest.fixture(scope="module")
def cases():
    """Per (input, num_ops, shift): the port's plain downsweep_rows and
    rowtab, JAX's parallel downsweep on the same planes and table, and
    JAX's edge fixup on the port's (rowtab, side, outs)."""
    sched = jnp.asarray(jradix16._within_row_sort_schedule())
    res = {}
    for name, num_ops, shift in _case_keys():
        planes = _padded(name, num_ops)
        counts, table = _tables(planes[0], shift)
        call = jrts._build_downsweep(ROWS, TILE, num_ops, T, True,
                                     first_chunk=True, parallel=True)
        zeros = [jnp.zeros((ROWS + 2, 128), jnp.int32)
                 for _ in range(num_ops)]
        jout = [np.asarray(a) for a in call(
            sched, jnp.full((1,), shift, jnp.int32), jnp.asarray(table),
            *[jnp.asarray(p.view(np.int32)) for p in planes], *zeros)]
        tplanes = _port_planes(planes)
        outs, side = rts.downsweep_rows(tplanes, torch.from_numpy(table),
                                        torch.from_numpy(counts), shift,
                                        TILE)
        rowtab = rts.edge_rows(torch.from_numpy(table),
                               torch.from_numpy(counts))
        fix = jrts._build_edge_fixup(ROWS, num_ops, T, True)
        jfixed = [np.asarray(a)[:ROWS] for a in fix(
            jnp.asarray(rowtab.numpy()), jnp.asarray(side.numpy()),
            *[jnp.asarray(np.concatenate([o.numpy(), np.zeros(
                (2, 128), np.int32)])) for o in outs])]
        res[name, num_ops, shift] = dict(
            planes=tplanes, counts=counts, table=table, jout=jout,
            outs=outs, side=side, rowtab=rowtab, jfixed=jfixed)
    return res


# ---- the gate ----------------------------------------------------------------


_H100 = config.DeviceInfo("cuda", "NVIDIA H100 80GB HBM3", "h100", 1,
                          80 << 30, 3350.0)


@pytest.mark.parametrize("env", ["1", "0", None])
@pytest.mark.parametrize("info", [None, "cpu", "h100"])
def test_megacore_gate(monkeypatch, env, info):
    """GST_MEGACORE forces the gate, read at each call; without it the gate
    follows the core count, 1 on the CPU and on a CUDA card."""
    info = {"cpu": config.get_device_info("cpu"), "h100": _H100}.get(info)
    if env is None:
        monkeypatch.delenv("GST_MEGACORE", raising=False)
    else:
        monkeypatch.setenv("GST_MEGACORE", env)
    assert config.tensorcores_per_chip(info) == 1
    assert config.megacore_parallel(info) is (env == "1")


# ---- one pass, kernel by kernel, against JAX in interpret mode ---------------


@pytest.mark.parametrize("name,num_ops,shift", _case_keys())
def test_downsweep_rows_matches_jax(cases, name, num_ops, shift):
    c = cases[name, num_ops, shift]
    jout, outs, side = c["jout"], c["outs"], c["side"]
    owned, whole = _owned(c["rowtab"].numpy(), c["table"], c["counts"])
    # outs: whole rows written, every other row zero
    np.testing.assert_array_equal(
        outs[0].numpy(), np.where(whole[:, None], jout[0][:ROWS] ^ SIGN, 0))
    for o in range(1, num_ops):
        np.testing.assert_array_equal(outs[o].numpy(), jout[o][:ROWS])
    # side rows that rowtab marks present; absent ones are zero in both
    got = side.numpy().reshape(T, num_ops, 16, 2, 128)
    want = jout[num_ops].reshape(T, num_ops, 16, 2, 128)
    np.testing.assert_array_equal(got[:, 0],
                                  np.where(owned, want[:, 0] ^ SIGN, 0))
    np.testing.assert_array_equal(got[:, 1:], want[:, 1:])


@pytest.mark.parametrize("name,num_ops,shift", _case_keys())
def test_edge_fixup_matches_jax(cases, name, num_ops, shift):
    """JAX's fixup and the port's plain one on the same (rowtab, side, outs);
    the fixed planes are the element form's scatter."""
    c = cases[name, num_ops, shift]
    got = rts.edge_fixup(c["rowtab"], torch.from_numpy(c["table"]),
                         c["side"], [o.clone() for o in c["outs"]])
    element = rts.downsweep(c["planes"], torch.from_numpy(c["table"]),
                            shift, TILE)
    for g, j, e in zip(got, c["jfixed"], element):
        np.testing.assert_array_equal(g.numpy(), j)
        assert torch.equal(g, e)


def test_sparse_digit_input_shares_rows(cases):
    """The crafted input has an output row that three or more side entries
    name, at both shifts."""
    for shift in SHIFTS:
        rt = cases["sparse_digit", 1, shift]["rowtab"]
        assert int(torch.bincount(rt[rt >= 0].long()).max()) >= 3


# ---- the index properties the kernels rely on --------------------------------
#
# csrc/downsweep_rows.cu stores each output row once: a row whole in one
# range from that range's block, a shared row as zeros from the block of
# the range that covers its slot 0.  csrc/edge_fixup.cu gives each shared
# row one warp, keyed by that range's high entry, which walks the
# digit-major table while the cursors stay in the row.  Checked on the
# planes of `cases` at a 2-row tile and at TILE.


def _index_case(cases, name, shift, tile):
    """(cursors, ends, rowtab) of `cases`' plane 0 at `tile` rows: the
    digit-major ranges [cursors[m], ends[m]) as int64 and `edge_rows`."""
    plane0 = cases[name, 1, shift]["planes"][0]
    counts = kernels.tile_histogram4(plane0, shift, tile)
    table = kernels.exclusive_scan(counts.T.reshape(-1))
    cur = table.long()
    return cur, cur + counts.T.reshape(-1).long(), rts.edge_rows(table,
                                                                 counts)


def _shared_rows(cur):
    """(ROWS,) mask of the output rows that no one range holds whole."""
    slots = torch.arange(ROWS * 128)
    owner = (torch.searchsorted(cur, slots, right=True) - 1).view(ROWS, 128)
    return owner[:, 0] != owner[:, -1]


def _walk(cur, m, row):
    """The fixup warp's walk from high entry m over a row: the ranges after
    m whose cursor lies in the row (as lists of ints)."""
    k, met = m + 1, []
    while k < len(cur) and cur[k] < (row + 1) * 128:
        met.append(k)
        k += 1
    return met


_INDEX_CASES = [(name, shift, tile) for name in INPUTS for shift in SHIFTS
                for tile in (2, TILE)]


@pytest.mark.parametrize("name,shift,tile", _INDEX_CASES)
def test_shared_row_has_one_high_entry(cases, name, shift, tile):
    """(a) Every output row that is not whole in one range is named by
    exactly one high entry, whose range covers the row's slot 0."""
    cur, end, rowtab = _index_case(cases, name, shift, tile)
    hi = rowtab[cur.numel():].long()
    m = torch.nonzero(hi >= 0).squeeze(1)
    named = torch.bincount(hi[m], minlength=ROWS)
    shared = _shared_rows(cur)
    assert (named[shared] == 1).all()
    slot0 = hi[m] * 128
    assert ((cur[m] <= slot0) & (slot0 < end[m])).all()


@pytest.mark.parametrize("name,shift,tile", _INDEX_CASES)
def test_walk_meets_the_rows_low_entries(cases, name, shift, tile):
    """(b) The walk from a row's high entry, over the table until a cursor
    leaves the row, meets exactly the present low entries naming the row;
    the other ranges it meets hold no keys."""
    cur, end, rowtab = _index_case(cases, name, shift, tile)
    ranges = cur.numel()
    lo = rowtab[:ranges].tolist()
    hi = rowtab[ranges:].tolist()
    cur_l, empty = cur.tolist(), (end == cur).tolist()
    by_row = {}
    for k, r in enumerate(lo):
        if r >= 0:
            by_row.setdefault(r, []).append(k)
    for m, row in enumerate(hi):
        if row < 0:
            continue
        met = _walk(cur_l, m, row)
        assert [k for k in met if lo[k] >= 0] == by_row.get(row, [])
        assert all(empty[k] for k in met if lo[k] < 0)
        by_row.pop(row, None)
    assert not by_row     # every low entry names a row some walk covers


@pytest.mark.parametrize("name,shift,tile", _INDEX_CASES)
def test_every_row_has_one_writer(cases, name, shift, tile):
    """(c) The rows that the high entries name (stored as zeros by the
    downsweep, merged by the fixup) and the whole rows cover every output
    row exactly once."""
    cur, _, rowtab = _index_case(cases, name, shift, tile)
    hi = rowtab[cur.numel():].long()
    writers = torch.bincount(hi[hi >= 0], minlength=ROWS)
    writers += (~_shared_rows(cur)).long()
    assert (writers == 1).all()


@pytest.mark.parametrize("name,shift,tile", _INDEX_CASES)
def test_stage_offsets_fit(cases, name, shift, tile):
    """(d) Each digit's run staged at the first slot after the previous
    run's end that is congruent to its cursor mod 128 (the kernel's
    layout) ends within (tile + STAGE_PAD_ROWS) rows, whose 16-bit slots
    and shared memory the wrapper's check admits on 1-3 planes."""
    cur, end, _ = _index_case(cases, name, shift, tile)
    num_tiles = cur.numel() // 16
    g = cur.view(16, num_tiles)
    c = (end - cur).view(16, num_tiles)
    p = torch.zeros(num_tiles, dtype=torch.int64)
    for d in range(16):
        s = p + ((g[d] - p) & 127)
        assert ((s - g[d]) % 128 == 0).all()
        p = torch.where(c[d] > 0, s + c[d], p)
    stage_slots = (tile + rts.STAGE_PAD_ROWS) * 128
    assert int(p.max()) <= stage_slots <= 1 << 16
    for num_ops in (1, 2, 3):
        assert rts.rows_stage_bytes(num_ops, tile) <= rts.ROWS_STAGE_BYTES


def test_stage_check_admits_the_old_tiles():
    """Every (planes, tile) that the old whole-tile stage admitted (planes x
    tile x 512 bytes within 192 KiB) fits the per-plane stage."""
    for num_ops in (1, 2, 3):
        for tile in range(1, 384 // num_ops + 1):
            assert rts.rows_stage_bytes(num_ops, tile) <= rts.ROWS_STAGE_BYTES
    assert rts.rows_stage_bytes(3, 512) > rts.ROWS_STAGE_BYTES


def _zero_run_codes(num_tiles, tile):
    """Codes whose one output row holds 40 one-key digit-0 ranges, then
    digit 1's ranges: 3 keys in tile 0, none in the next 38 tiles, 2 in
    the last; digit 2 elsewhere (the digit the same at shifts 0 and 28)."""
    n = num_tiles * tile * 128
    x = np.full(n, 0x20000002, np.uint32)
    x[::tile * 128] = 0
    x[[5, 6, 7, n - 3, n - 2]] = 0x10000001
    return x


@pytest.mark.parametrize("shift", SHIFTS)
def test_walk_crosses_zero_count_ranges(shift):
    """A walk over more than 32 zero-count ranges in one row (two ballot
    windows) still meets exactly the row's low entries, and the row form's
    pass equals the element form's."""
    tile, num_tiles = 2, 40
    codes = codec.bias(torch.from_numpy(_zero_run_codes(num_tiles, tile)))
    planes = [codes.view(-1, 128),
              torch.arange(codes.numel(), dtype=torch.int32).view(-1, 128)]
    counts = kernels.tile_histogram4(planes[0], shift, tile)
    table = kernels.exclusive_scan(counts.T.reshape(-1))
    rowtab = rts.edge_rows(table, counts)
    ranges = table.numel()
    lo, hi = rowtab[:ranges].tolist(), rowtab[ranges:].tolist()
    met = _walk(table.tolist(), 0, hi[0])
    assert hi[0] == 0 and len([k for k in met if lo[k] < 0]) >= 32
    assert [k for k in met if lo[k] >= 0] == [k for k in range(ranges)
                                              if lo[k] == 0]
    got = rts.rts_pass(planes, shift, tile, parallel=True)
    want = rts.rts_pass(planes, shift, tile, parallel=False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---- one whole pass ------------------------------------------------------------


@pytest.mark.parametrize("name,num_ops,shift", _case_keys())
def test_pass_matches_jax(cases, name, num_ops, shift):
    """JAX's `run_downsweep_chunks(parallel=True)` (its rowtab, downsweep and
    fixup) against the port's pass with parallel=True (Upsweep, scan,
    downsweep_rows, edge_rows, edge_fixup)."""
    c = cases[name, num_ops, shift]
    planes = _padded(name, num_ops)
    jres = jrts.run_downsweep_chunks(
        [jnp.asarray(p.view(np.int32)) for p in planes],
        jnp.asarray(c["table"].reshape(16, T)),
        jnp.asarray(jradix16._within_row_sort_schedule()),
        jnp.full((1,), shift, jnp.int32), ROWS, TILE, num_ops, T, True,
        parallel=True, counts_dm=jnp.asarray(c["counts"].T))
    got = rts.rts_pass(c["planes"], shift, TILE, parallel=True)
    np.testing.assert_array_equal(codec.unbias(got[0]).numpy(),
                                  np.asarray(jres[0]).view(np.uint32))
    for g, j in zip(got[1:], jres[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


# ---- the engine --------------------------------------------------------------


@pytest.mark.parametrize("tile_rows", [2, TILE])
@pytest.mark.parametrize("rides", [0, 1, 2])
def test_engine_row_form_matches_flat_oracle(rides, tile_rows):
    """_sort_rts with parallel=True equals parallel=False, and both equal
    JAX's flat oracle (jax.lax.sort, stable)."""
    n = 20_000
    rng = np.random.default_rng(rides + tile_rows)
    codes = rng.integers(0, 2**32, n, dtype=np.uint32) & np.uint32(
        0xF00F00FF)
    ops = (codes,) + tuple(rng.integers(0, 2**32, n, dtype=np.uint32)
                           for _ in range(rides))
    want = jax.lax.sort(tuple(jnp.asarray(a) for a in ops), num_keys=1,
                        is_stable=True)
    tops = (codec.bias(torch.from_numpy(codes)),) + tuple(
        torch.from_numpy(a).view(torch.int32) for a in ops[1:])
    par = rts._sort_rts(tops, tile_rows, parallel=True)
    seq = rts._sort_rts(tops, tile_rows, parallel=False)
    for p, s in zip(par, seq):
        assert torch.equal(p, s)
    np.testing.assert_array_equal(codec.unbias(par[0]).numpy(),
                                  np.asarray(want[0]))
    for p, w in zip(par[1:], want[1:]):
        np.testing.assert_array_equal(p.numpy().view(np.uint32),
                                      np.asarray(w))


# ---- the entry points under GST_MEGACORE=1 -----------------------------------


@pytest.fixture
def counted(monkeypatch):
    """Calls of the plain versions, which the CPU path runs in place of
    the kernels: the row form's two and the element form's downsweep."""
    calls = {"downsweep_rows": 0, "edge_fixup": 0, "downsweep": 0}

    def counting(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    for name in calls:
        monkeypatch.setattr(rts, f"{name}_plain",
                            counting(name, getattr(rts, f"{name}_plain")))
    return calls


_KEY_DT = {"uint32": (np.uint32, jnp.uint32), "int32": (np.int32, jnp.int32),
           "float32": (np.float32, jnp.float32)}
_SPECIALS = np.array([0x7FC00000, 0xFFC00000, 0, 0x80000000, 0x7F800000,
                      0xFF800000], np.uint32)
_ORDERS = [("ascending", gst.Order.ASCENDING, gstt.Order.ASCENDING),
           ("descending", gst.Order.DESCENDING, gstt.Order.DESCENDING)]


def _keys(kind, n, seed):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, n, dtype=np.uint32)
    bits &= rng.integers(0, 2**32, n, dtype=np.uint32)
    bits[::5] = bits[0]                          # long equal runs
    bits[::97] = _SPECIALS[np.arange(bits[::97].size) % _SPECIALS.size]
    return bits.view(_KEY_DT[kind][0])


def _eq(t: torch.Tensor, j) -> None:
    want = np.asarray(j)
    got = t.contiguous().view(torch.int32 if t.dtype.itemsize == 4
                              else torch.int64).numpy()
    np.testing.assert_array_equal(got, want.view(got.dtype))


@pytest.mark.parametrize("oname,jorder,torder", _ORDERS)
@pytest.mark.parametrize("kind", ["uint32", "int32", "float32"])
def test_entry_points_take_row_form(monkeypatch, counted, kind, oname,
                                    jorder, torder):
    """sort, sort_pairs, sort_pairs_wide and argsort with
    variant="device_radix" under GST_MEGACORE=1, against JAX's flat oracle,
    each sort through 8 downsweep_rows and 8 edge_fixup calls."""
    monkeypatch.setenv("GST_MEGACORE", "1")
    n = 5000
    keys = _keys(kind, n, seed=len(kind))
    jk, tk = jnp.asarray(keys), torch.from_numpy(keys.copy())
    pal = {"backend": gstt.Backend.PALLAS, "variant": "device_radix",
           "tile_rows": 2}
    xla = {"order": jorder, "backend": gst.Backend.XLA}
    _eq(gstt.sort(tk, order=torder, **pal), gst.sort(jk, **xla))
    vals = np.arange(n, dtype=np.uint32) * np.uint32(2654435761)
    ok, ov = gstt.sort_pairs(tk, torch.from_numpy(vals), order=torder, **pal)
    ek, ev = gst.sort_pairs(jk, jnp.asarray(vals), **xla)
    _eq(ok, ek)
    _eq(ov, ev)
    rng = np.random.default_rng(4)
    lo = rng.integers(0, 2**32, n, dtype=np.uint32)
    hi = rng.integers(0, 2**32, n, dtype=np.uint32)
    got = gstt.sort_pairs_wide(tk, torch.from_numpy(lo), torch.from_numpy(hi),
                               order=torder, **pal)
    want = gst.sort_pairs_wide(jk, jnp.asarray(lo), jnp.asarray(hi), **xla)
    for g, w in zip(got, want):
        _eq(g, w)
    _eq(gstt.argsort(tk, order=torder, **pal), gst.argsort(jk, **xla))
    assert counted == {"downsweep_rows": 32, "edge_fixup": 32,
                       "downsweep": 0}


def test_sorter_takes_row_form(monkeypatch, counted):
    """The DeviceRadixSort sorter, keys and pairs, under GST_MEGACORE=1."""
    monkeypatch.setenv("GST_MEGACORE", "1")
    keys = np.random.default_rng(3).integers(0, 2**32, 20_000,
                                             dtype=np.uint32)
    vals = np.arange(20_000, dtype=np.float32)
    s = gstt.DeviceRadixSort(
        gstt.SortConfig(backend=gstt.Backend.PALLAS),
        tuning=gstt.TuningParameters(partition_rows=4, radix_tile_rows=16),
        device="cpu")
    _eq(s.sort(torch.from_numpy(keys)),
        gst.sort(jnp.asarray(keys), backend=gst.Backend.XLA))
    ok, ov = s.sort(torch.from_numpy(keys & 0xFF), torch.from_numpy(vals))
    ek, ev = gst.sort_pairs(jnp.asarray(keys & 0xFF), jnp.asarray(vals),
                            backend=gst.Backend.XLA)
    _eq(ok, ek)
    _eq(ov, ev)
    assert counted == {"downsweep_rows": 16, "edge_fixup": 16,
                       "downsweep": 0}


@pytest.mark.parametrize("env", ["0", None])
def test_gate_off_keeps_element_form(monkeypatch, counted, env):
    """Without GST_MEGACORE=1 the route is the element form, as before."""
    if env is None:
        monkeypatch.delenv("GST_MEGACORE", raising=False)
    else:
        monkeypatch.setenv("GST_MEGACORE", env)
    keys = _keys("float32", 3000, seed=8)
    got = gstt.sort(torch.from_numpy(keys.copy()),
                    backend=gstt.Backend.PALLAS, variant="device_radix",
                    tile_rows=2)
    _eq(got, gst.sort(jnp.asarray(keys), backend=gst.Backend.XLA))
    assert counted == {"downsweep_rows": 0, "edge_fixup": 0, "downsweep": 8}


# ---- the wrappers' checks on the CPU -----------------------------------------


def test_row_form_wrappers_check():
    x = torch.zeros((4, 128), dtype=torch.int32)
    counts = torch.zeros((2, 16), dtype=torch.int32)
    table = torch.zeros(32, dtype=torch.int32)
    with pytest.raises(ValueError, match="counts shape"):
        rts.downsweep_rows([x], table, counts[:1], 0, 2)
    with pytest.raises(ValueError, match="planes"):
        rts.downsweep_rows([x] * 4, table, counts, 0, 2)
    with pytest.raises(ValueError, match="shift"):
        rts.downsweep_rows([x], table, counts, 32, 2)
    with pytest.raises(TypeError):
        rts.downsweep_rows([x.float()], table, counts, 0, 2)
    rowtab = torch.full((64,), -1, dtype=torch.int32)
    side = torch.ones((2 * 32, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="2 \\* 16 \\* T"):
        rts.edge_fixup(rowtab[:-1], table, side, [x])
    with pytest.raises(ValueError, match="side shape"):
        rts.edge_fixup(rowtab, table, side, [x, x])
    with pytest.raises(ValueError, match="table shape"):
        rts.edge_fixup(rowtab, table[:16], side, [x])
    with pytest.raises(TypeError):
        rts.edge_fixup(rowtab, table, side.float(), [x])
    # every entry absent: nothing is read or written
    assert not rts.edge_fixup(rowtab, table, side, [x])[0].any()
