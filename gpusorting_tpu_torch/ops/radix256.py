"""The keys-only LSD radix-256 sort: one upsweep and four OneSweep
digit-binning passes of 8-bit digits, enqueued by one call.

Ports no TPU kernel.  The JAX package's radix engines take 4-bit digits,
and `radix16.py` keeps that contract; this is the reference OneSweep's own
width (OneSweep.cu:44-344: 8-bit digits, four passes a 32-bit key), the
pass count the bench's bound assumes (ROADMAP A2).  AUTO sends keys-only
sorts on the card to it from the row's `radix256_min` (core/config.py),
where the flat route's `torch.sort` runs a pairs sort over an index it
then drops.

  upsweep  — all four digit positions' counts in one read of the keys; the
             block that finishes last scans them into each pass's 256 digit
             bases and clears the counts for the next call (they live in a
             zeroed buffer per device and stream, `_counts_buffer`).
  pass     — (kernel `csrc/binning256.cu`) every key goes to its digit's
             base plus the count of earlier keys of that digit: a chained
             scan with decoupled lookback over the kernel's own partitions,
             on epoch-tagged status words in `kernels._scan_scratch`, one
             fresh epoch a pass.
  codec    — fused: the kernels read raw u32, i32 or f32 bits, take each
             digit from the key's u32 code (core/codec.py) computed in
             registers, and move the raw bits, so no encode or decode pass
             runs.  Descending is the caller's flip of the ascending result.

A call reads nothing back to the host and launches five kernels, counted
by `sort.launches`.  A CPU tensor takes `sort_plain`, the same four passes
in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core import codec
from ..core.config import RADIX256_MAX_N, KeyType
from ..utils.trace import launch_counter
from . import _nvcc, kernels

SOURCE = _nvcc.CSRC / "binning256.cu"
PASSES = 4
DIGITS = 256
_KIND = {KeyType.UINT32: 0, KeyType.INT32: 1, KeyType.FLOAT32: 2}

# one zeroed counts buffer per (device index, stream handle); the upsweep
# leaves it zero after every call
_COUNTS: dict = {}


def _codes(keys: torch.Tensor) -> torch.Tensor:
    """The keys' u32 codes, as int64 in [0, 2^32)."""
    return (codec.encode_biased(keys) ^ codec.SIGN).to(torch.int64) \
        & 0xFFFFFFFF


# ---- plain versions -------------------------------------------------------


def upsweep_plain(keys: torch.Tensor) -> torch.Tensor:
    """(4, 256) int64 exclusive digit bases of each pass: the u32 codes'
    bytes counted, then summed below each digit."""
    codes = _codes(keys.reshape(-1))
    counts = torch.stack([torch.bincount((codes >> (8 * p)) & 255,
                                         minlength=DIGITS)
                          for p in range(PASSES)])
    return torch.cumsum(counts, 1) - counts


def binning_pass_plain(keys: torch.Tensor, bases: torch.Tensor,
                       shift: int) -> torch.Tensor:
    """One stable pass of the 8-bit digit at `shift` (0, 8, 16, 24) of the
    keys' u32 codes: the j-th key of digit d goes to bases[d] + j.  The keys
    move as raw bits; returns a tensor of their dtype."""
    if shift not in (0, 8, 16, 24):
        raise ValueError(f"shift must be 0, 8, 16 or 24, got {shift}")
    keys = keys.reshape(-1)
    raw = keys.view(torch.int32)
    d = (_codes(keys) >> shift) & 255
    order = torch.argsort(d, stable=True)
    sd = d[order]
    counts = torch.bincount(d, minlength=DIGITS)
    first = torch.cumsum(counts, 0) - counts
    dst = (bases.to(torch.int64)[sd]
           + torch.arange(raw.numel(), device=raw.device) - first[sd])
    out = torch.empty_like(raw)
    out[dst] = raw[order]
    return out.view(keys.dtype)


def sort_plain(keys: torch.Tensor) -> torch.Tensor:
    """The kernels' sort in plain PyTorch: the upsweep's bases, then four
    passes, least significant digit first."""
    bases = upsweep_plain(keys)
    out = keys.reshape(-1)
    for p in range(PASSES):
        out = binning_pass_plain(out, bases[p], 8 * p)
    return out


# ---- the kernels ----------------------------------------------------------


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _nvcc.load(SOURCE)
    fn = lib.gst_radix256_sort
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [
        ctypes.c_uint] * 4 + [ctypes.c_int, ctypes.c_longlong,
                              ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for name in ("gst_radix256_partition", "gst_radix256_counts_words"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _counts_buffer(dev: torch.device, stream: int, words: int
                   ) -> torch.Tensor:
    key = (dev.index, stream)
    buf = _COUNTS.get(key)
    if buf is None:
        # allocated on `stream` (the current one), which alone uses it
        buf = _COUNTS[key] = torch.zeros(words, dtype=torch.int32,
                                         device=dev)
    return buf


@launch_counter
def sort(keys: torch.Tensor) -> torch.Tensor:
    """Ascending sort of a 1-D tensor of uint32, int32 or float32 keys by
    their u32 codes (core/codec.py; NaNs where their codes put them), equal
    codes in input order; returns a new tensor of the keys' dtype.

    A CUDA tensor (n < 2^31) runs `csrc/binning256.cu`: the upsweep and four
    passes on the current stream, 5 launches counted in `sort.launches`, no
    host readback (or raises, also under CUDA-graph capture: the status
    words' epochs would replay); a CPU tensor takes `sort_plain`."""
    kind = codec.key_type_of(keys)
    if keys.ndim != 1:
        raise ValueError(f"radix256.sort takes a 1-D tensor, got "
                         f"{tuple(keys.shape)}")
    dev = keys.device
    if dev.type == "cpu":
        return sort_plain(keys)
    if dev.type != "cuda":
        raise ValueError(f"radix256.sort: unsupported device {dev}")
    n = keys.shape[0]
    if n > RADIX256_MAX_N:
        raise ValueError(f"radix256.sort: {n} keys exceed {RADIX256_MAX_N}")
    if n == 0:
        return keys.clone()
    keys = keys.contiguous()
    out = torch.empty_like(keys)
    tmp = torch.empty_like(keys)
    lib = _library()
    parts = -(-n // lib.gst_radix256_partition())
    stream = torch.cuda.current_stream(dev).cuda_stream
    # one epoch a pass: the passes share the status words of the chained
    # scans' scratch of this device and stream.  First, since it raises
    # under capture, where the counts buffer's zero fill would only be
    # recorded and never run
    epochs = []
    for _ in range(PASSES):
        scratch, epoch = kernels._scan_scratch(dev, stream, parts * DIGITS)
        epochs.append(epoch)
    counts = _counts_buffer(dev, stream, lib.gst_radix256_counts_words())
    _nvcc.launch("radix256.sort", lib.gst_radix256_sort, keys.data_ptr(),
                 out.data_ptr(), tmp.data_ptr(), counts.data_ptr(),
                 scratch.data_ptr(), scratch.numel() - 1, *epochs,
                 _KIND[kind], n, device=dev, stream=stream)
    sort.launches += 1 + PASSES
    return out
