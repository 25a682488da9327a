"""The range-exchange row relocate: a hand-written CUDA kernel
(`csrc/relocate.cu`) and its plain PyTorch version.

Replaces the Pallas kernel `gpusorting_tpu/ops/rangesweep.py:_relocate_kernel`.
Contract, per bucket b of K, on (K*l_rows, 128) int32 planes:
  - copy the K source row ranges  src[ctrl[b*K+i] : +ctrl[2KK+b*K+i]]
    to out[ctrl[KK+b*K+i] : ...]  (i = 0..K-1, packed in order), then
  - copy the l_rows - ctrl[3KK+b] fringe rows from fringe row b*slab_rows
    to out row b*l_rows + ctrl[3KK+b].
Every output row is written exactly once.

`relocate` launches the kernel on a CUDA tensor and takes the plain version
only for a CPU tensor; `relocate.launches` counts the kernel launches
(`utils.trace.counts()` reads it as `launch.relocate.relocate`).  The
kernel is compiled with `nvcc` at first use from the package's own source
(ops/_nvcc.py).
"""

from __future__ import annotations

import torch

from ..utils.trace import launch_counter
from . import _nvcc

SOURCE = _nvcc.CSRC / "relocate.cu"
LANES = 128


def relocate_plain(ctrl: torch.Tensor, src: torch.Tensor,
                   fringe: torch.Tensor, K: int, l_rows: int,
                   slab_rows: int) -> torch.Tensor:
    """Plain version: one row gather through the row map.  Output row q of
    bucket b comes from range i = max{i : cum[b,i] <= q} at row
    a0[b,i] + (q - cum[b,i]) while q < bulk_b, else from the fringe slab."""
    dev = src.device
    KK = K * K
    rows_total = K * l_rows
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)
    c = ctrl.to(torch.int64)
    a0 = c[:KK].view(K, K)                                         # (b,i)
    cum = c[KK:2 * KK].view(K, K) - (ar(K) * l_rows)[:, None]
    bulk = c[3 * KK:]
    q = ar(l_rows)[None, :].expand(K, l_rows).contiguous()
    i_sel = torch.clamp(torch.searchsorted(cum, q, right=True) - 1, 0, K - 1)
    src_bulk = (torch.gather(a0, 1, i_sel) + q
                - torch.gather(cum, 1, i_sel))
    slab_base = (rows_total + slab_rows * ar(K)[:, None] - bulk[:, None])
    g = torch.where(q >= bulk[:, None], slab_base + q, src_bulk)
    return torch.cat([src, fringe]).index_select(0, g.reshape(-1))


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device):
    _nvcc.check("relocate", name, t, shape, device, ref="src")


@launch_counter
def relocate(ctrl: torch.Tensor, src: torch.Tensor, fringe: torch.Tensor,
             K: int, l_rows: int, slab_rows: int) -> torch.Tensor:
    """Range-exchange relocate of one int32 plane (see module docstring).

    A CUDA `src` launches the kernel on the current stream (or raises); a
    CPU `src` takes `relocate_plain`."""
    if src.device.type == "cpu":
        return relocate_plain(ctrl, src, fringe, K, l_rows, slab_rows)
    if src.device.type != "cuda":
        raise ValueError(f"relocate: unsupported device {src.device}")
    dev = src.device
    rows_total = K * l_rows
    _check("ctrl", ctrl, (3 * K * K + K,), dev)
    _check("src", src, (rows_total, LANES), dev)
    _check("fringe", fringe, (K * slab_rows, LANES), dev)
    if rows_total >= 1 << 31:
        raise ValueError(f"relocate: {rows_total} rows exceed int32")
    out = torch.empty_like(src)
    _nvcc.launch("relocate", _nvcc.load(SOURCE).gst_relocate_rows,
                 ctrl.data_ptr(), src.data_ptr(), fringe.data_ptr(),
                 out.data_ptr(), K, l_rows, slab_rows, device=dev)
    relocate.launches += 1
    return out
