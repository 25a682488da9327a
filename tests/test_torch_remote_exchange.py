"""Port parity for the distributed sort's exchange
(gpusorting_tpu_torch/parallel/remote_exchange.py) against the JAX
package's remote-DMA kernel, bit for bit.

The masking's plain version (`mask_arrivals_plain`, which `mask_arrivals`
takes for CPU tensors) is held against JAX's `remote_exchange` run on the
conftest's 8-device CPU mesh (its Pallas kernel in interpret mode), on
tests/test_remote_exchange.py's input: counts with an empty cell, partial
ones, an exactly full one and a sender-truncated one.  The port's transports
run on 8 gloo ranks spawned once for the module; the JAX package is
imported inside the tests only, since the ranks re-import this module.
The CUDA kernel is held against the plain version on the card by
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from gpusorting_tpu_torch.parallel import remote_exchange as rx
from gpusorting_tpu_torch.parallel.launch import run_ranks

D = 8
LANES = 128


def _input(num_ops, r, seed):
    """send (src, dst, num_ops*r, 128) u32 and counts (src, dst) int32,
    as tests/test_remote_exchange.py makes them."""
    rng = np.random.RandomState(seed)
    send = rng.randint(0, 1 << 31, size=(D, D, num_ops * r, LANES)
                       ).astype(np.uint32)
    counts = rng.randint(0, r * LANES + 100, size=(D, D)).astype(np.int32)
    counts[0, 1] = 0
    counts[2, 3] = r * LANES
    counts[4, 5] = r * LANES + 57
    return send, counts


INPUTS = {"ops3": (3, 2, 7), "ops2": (2, 1, 3)}


def _exchanges(rank, world, inputs):
    """Per input: remote_exchange of this rank's send row, and the chunked
    collective exchange of the same cells (2 chunks) as (D, cap) planes."""
    out = {}
    for name, (num_ops, r, seed) in inputs.items():
        send, counts = _input(num_ops, r, seed)
        mine = torch.from_numpy(send[rank].view(np.int32).copy())
        cnt = torch.from_numpy(counts[rank].copy())
        data, rc = rx.remote_exchange(mine, cnt, group=None, num_ops=num_ops)
        cap = r * LANES
        cells = mine.view(D, num_ops, 2, cap // 2).permute(1, 2, 0, 3)
        recv, rc2 = rx.collective_exchange(
            [c.contiguous() for c in cells], cnt, None,
            rx.raw_fills(num_ops))
        planes = torch.stack(recv).permute(2, 0, 1, 3).reshape(
            D, num_ops * r, LANES)
        out[name] = (data.numpy(), rc.numpy(), planes.numpy(), rc2.numpy())
    return out


@pytest.fixture(scope="module")
def port():
    return run_ranks(_exchanges, D, INPUTS, timeout=120.0)


@pytest.fixture(scope="module")
def jax_exchange(cpu_mesh):
    """JAX's remote_exchange over the mesh: name -> (data, rc), each
    (dst, src, ...)."""
    import jax
    import jax.numpy as jnp
    from gpusorting_tpu.parallel.remote_exchange import remote_exchange

    P = jax.sharding.PartitionSpec
    out = {}
    for name, (num_ops, r, seed) in INPUTS.items():
        send, counts = _input(num_ops, r, seed)
        fn = jax.jit(jax.shard_map(
            lambda s, c: remote_exchange(
                s.reshape(s.shape[1:]), c.reshape(-1), axis="x", n_dev=D,
                num_ops=num_ops),
            mesh=cpu_mesh, in_specs=(P("x"), P("x")),
            out_specs=(P("x"), P("x")), check_vma=False))
        data, rc = fn(jnp.asarray(send), jnp.asarray(counts))
        out[name] = (np.asarray(data).reshape(D, D, num_ops * r, LANES),
                     np.asarray(rc).reshape(D, D))
    return out


@pytest.mark.parametrize("name", list(INPUTS))
def test_mask_plain_matches_jax_kernel(jax_exchange, name):
    """Each destination's arrivals, masked by the plain version, are JAX's
    kernel output; the whole block, per chunk window and per source."""
    num_ops, r, seed = INPUTS[name]
    send, counts = _input(num_ops, r, seed)
    want, want_rc = jax_exchange[name]
    cap = r * LANES
    fills = rx.raw_fills(num_ops)
    for d in range(D):
        rc = torch.from_numpy(counts[:, d].copy())
        np.testing.assert_array_equal(rc.numpy(), want_rc[d].astype(np.int32))
        arrived = send[:, d].view(np.int32).reshape(D, num_ops, cap)
        for form in ("whole", "chunks", "sources"):
            buf = torch.from_numpy(arrived.copy())
            planes = [buf[:, o] for o in range(num_ops)]
            before = rx.mask_arrivals.launches
            if form == "whole":
                rx.mask_arrivals(planes, rc, fills)
            elif form == "chunks":
                for c0 in range(0, cap, 96):       # a ragged last window
                    rx.mask_arrivals([p[:, c0:c0 + 96] for p in planes], rc,
                                     fills, col0=c0)
            else:
                for s in reversed(range(D)):
                    rx.mask_arrivals_plain(planes, rc, fills,
                                           sources=range(s, s + 1))
            assert rx.mask_arrivals.launches == before   # CPU: plain
            np.testing.assert_array_equal(
                buf.numpy().view(np.uint32).reshape(D, num_ops * r, LANES),
                want[d], err_msg=f"{form} @ dst {d}")


@pytest.mark.parametrize("name", list(INPUTS))
def test_exchanges_match_jax_kernel(port, jax_exchange, name):
    """The port's ring (remote_exchange) and chunked collective exchange
    over 8 gloo ranks: every rank's data and counts are JAX's."""
    want, want_rc = jax_exchange[name]
    for d in range(D):
        data, rc, planes, rc2 = port[d][name]
        np.testing.assert_array_equal(rc, want_rc[d].astype(np.int32))
        np.testing.assert_array_equal(rc2, want_rc[d].astype(np.int32))
        np.testing.assert_array_equal(data.view(np.uint32), want[d])
        np.testing.assert_array_equal(planes.view(np.uint32), want[d])


def test_mask_sources_leave_other_rows():
    """A per-source call touches only its rows; a window at col0 masks from
    position rc - col0; rc above the window leaves it whole."""
    x = torch.arange(4 * 10, dtype=torch.int32).view(4, 10)
    rc = torch.tensor([0, 3, 10, 99], dtype=torch.int32)
    y = x.clone()
    rx.mask_arrivals([y], rc, (-7,), sources=range(1, 3))
    want = x.clone()
    want[1, 3:] = -7
    assert torch.equal(y, want)
    z = x.clone()
    rx.mask_arrivals([z], rc, (5,), col0=4)        # positions 4..13
    want = x.clone()
    want[0] = 5
    want[1] = 5
    want[2, 6:] = 5
    assert torch.equal(z, want)


def test_exchange_rejects_bad_shape():
    with pytest.raises(ValueError, match="bad send shape"):
        rx.remote_exchange(torch.zeros((8, 5, 128), dtype=torch.int32),
                           torch.zeros(8, dtype=torch.int32), group=None,
                           num_ops=2)
    with pytest.raises(ValueError, match="bad send shape"):
        rx.remote_exchange(torch.zeros((8, 4, 64), dtype=torch.int32),
                           torch.zeros(8, dtype=torch.int32), group=None,
                           num_ops=2)


def test_mask_rejects_bad_operands():
    x = torch.zeros(4, 8, dtype=torch.int32)
    rc = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="1-4 planes"):
        rx.mask_arrivals([x] * 5, rc, (0,) * 5)
    with pytest.raises(ValueError, match="fills"):
        rx.mask_arrivals([x, x], rc, (0,))
    with pytest.raises(TypeError, match="rc"):
        rx.mask_arrivals([x], rc.long(), (0,))
    with pytest.raises(ValueError, match="rows"):
        rx.mask_arrivals([x[:3]], rc, (0,))
    with pytest.raises(ValueError, match="range"):
        rx.mask_arrivals([x], rc, (0,), sources=[0, 1])
    with pytest.raises(ValueError, match="int32"):
        rx.mask_arrivals([x.float()], rc, (0,))
