"""The port's entry script (`gpusorting_tpu_torch/entry.py`) against the JAX
package's (`__graft_entry__.py`) on the CPU: the flagship step bit for bit,
and the multi-chip dry run's five checks on four spawned gloo ranks.

`__graft_entry__` (which imports JAX) is imported inside the tests only;
tests/test_torch_surface.py holds that the port's modules import neither.
"""

import numpy as np
import pytest
import torch

from gpusorting_tpu_torch import entry

# tests/test_torch_dist.py's deadline for one spawn of its ranks, which
# the dry run keeps
SPAWN_TIMEOUT = 240.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small torch ops; one intra-op thread
    keeps them fast when several test processes share the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy().view(np.uint32)


def test_entry_step_matches_jax_bit_for_bit():
    import jax

    import __graft_entry__ as graft

    jstep, (jk, jv) = graft.entry()
    fn, (keys, values) = entry.entry(device="cpu")
    assert keys.dtype == values.dtype == torch.uint32
    assert keys.device.type == "cpu"
    np.testing.assert_array_equal(_bits(keys), np.asarray(jk))
    np.testing.assert_array_equal(_bits(values), np.asarray(jv))
    ok, ov = fn(keys, values)
    ek, ev = jax.jit(jstep)(jk, jv)
    assert ok.dtype == ov.dtype == torch.uint32
    np.testing.assert_array_equal(_bits(ok), np.asarray(ek))
    np.testing.assert_array_equal(_bits(ov), np.asarray(ev))
    # the stable pairs oracle: numpy's stable argsort of the keys
    perm = np.argsort(_bits(keys), kind="stable")
    np.testing.assert_array_equal(_bits(ov), _bits(values)[perm])


def test_entry_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        entry.entry()
    with pytest.raises(RuntimeError, match="is_available"):
        entry.dryrun_multichip(1)


def test_dryrun_multichip_four_gloo_ranks():
    assert entry.DRYRUN_TIMEOUT == SPAWN_TIMEOUT
    res = entry.dryrun_multichip(4, device="cpu")
    assert res["checks"] == list(entry.CHECKS)
    assert res["refused"] == {}
    assert res["backend"] == "gloo"
    assert (res["n_devices"], res["n"], res["device"]) == (4, 4096, "cpu")

