"""The LSD radix-256 sort, keys only or with one 32-bit payload: one upsweep
and four OneSweep digit-binning passes of 8-bit digits, enqueued by one
call.

Ports no TPU kernel.  The JAX package's radix engines take 4-bit digits,
and `radix16.py` keeps that contract; this is the reference OneSweep's own
width (OneSweep.cu:44-344: 8-bit digits, four passes a 32-bit key), the
pass count the bench's bound assumes (ROADMAP A2).  AUTO sends keys-only
sorts on the card to it from the row's `radix256_min` (core/config.py),
where the flat route's `torch.sort` runs a pairs sort over an index it
then drops, and pairs with a 32-bit payload from `radix256_min_pairs`,
where it sorts the keys with an int64 index and a gather then moves the
payload.

  upsweep  — all four digit positions' counts in one read of the keys; the
             block that finishes last scans them into each pass's 256 digit
             bases and clears the counts for the next call (they live in a
             zeroed buffer per device and stream, `_counts_buffer`).
  pass     — (kernel `csrc/binning256.cu`) every key goes to its digit's
             base plus the count of earlier keys of that digit: a chained
             scan with decoupled lookback over the kernel's own partitions,
             on epoch-tagged status words in `kernels._scan_scratch`, one
             fresh epoch a pass.  `sort_pairs`' passes carry the payload
             as raw bits to the same places, through a second ping-pong
             buffer.
  codec    — fused: the kernels read raw u32, i32 or f32 bits, take each
             digit from the key's u32 code (core/codec.py) computed in
             registers, and move the raw bits, so no encode or decode pass
             runs.  Descending is the caller's flip of the ascending result.

A call reads nothing back to the host and launches five kernels, counted
by `sort.launches` or `sort_pairs.launches`.  A CPU tensor takes
`sort_plain` or `sort_pairs_plain`, the same four passes in plain PyTorch.
"""

from __future__ import annotations

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


def _pass_moves(keys: torch.Tensor, bases: torch.Tensor, shift: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dst, order) of one stable pass of the 8-bit digit at `shift`: the
    pass puts element order[j] at dst[j], the j-th key of digit d at
    bases[d] + j."""
    if shift not in (0, 8, 16, 24):
        raise ValueError(f"shift must be 0, 8, 16 or 24, got {shift}")
    d = (_codes(keys) >> shift) & 255
    order = torch.argsort(d, stable=True)
    sd = d[order]
    counts = torch.bincount(d, minlength=DIGITS)
    first = torch.cumsum(counts, 0) - counts
    dst = (bases.to(torch.int64)[sd]
           + torch.arange(keys.numel(), device=keys.device) - first[sd])
    return dst, order


def _move(x: torch.Tensor, dst: torch.Tensor, order: torch.Tensor
          ) -> torch.Tensor:
    """x's 32-bit words moved as raw bits by a pass's (dst, order)."""
    raw = x.view(torch.int32)
    out = torch.empty_like(raw)
    out[dst] = raw[order]
    return out.view(x.dtype)


def binning_pass_plain(keys: torch.Tensor, bases: torch.Tensor,
                       shift: int) -> torch.Tensor:
    """One stable pass of the 8-bit digit at `shift` (0, 8, 16, 24) of the
    keys' u32 codes: the j-th key of digit d goes to bases[d] + j.  The keys
    move as raw bits; returns a tensor of their dtype."""
    keys = keys.reshape(-1)
    return _move(keys, *_pass_moves(keys, bases, shift))


def sort_plain(keys: torch.Tensor) -> torch.Tensor:
    """The kernels' sort in plain PyTorch: the upsweep's bases, then four
    passes, least significant digit first."""
    bases = upsweep_plain(keys)
    out = keys.reshape(-1)
    for p in range(PASSES):
        out = binning_pass_plain(out, bases[p], 8 * p)
    return out


def sort_pairs_plain(keys: torch.Tensor, values: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """`sort_plain` carrying a 32-bit payload: each pass moves the payload
    words, as raw bits, where it moves their keys."""
    bases = upsweep_plain(keys)
    k, v = keys.reshape(-1), values.reshape(-1)
    for p in range(PASSES):
        dst, order = _pass_moves(k, bases[p], 8 * p)
        k, v = _move(k, dst, order), _move(v, dst, order)
    return k, v


# ---- the kernels ----------------------------------------------------------


def _counts_buffer(dev: torch.device, stream: int, words: int
                   ) -> torch.Tensor:
    key = (dev.index, stream)
    buf = _COUNTS.get(key)
    if buf is None:
        # allocated on `stream` (the current one), which alone uses it
        buf = _COUNTS[key] = torch.zeros(words, dtype=torch.int32,
                                         device=dev)
    return buf


def _check(op: str, keys: torch.Tensor) -> KeyType:
    kind = codec.key_type_of(keys)
    if keys.ndim != 1:
        raise ValueError(f"radix256.{op} takes a 1-D tensor, got "
                         f"{tuple(keys.shape)}")
    dev = keys.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"radix256.{op}: unsupported device {dev}")
    if dev.type == "cuda" and keys.shape[0] > RADIX256_MAX_N:
        raise ValueError(f"radix256.{op}: {keys.shape[0]} keys exceed "
                         f"{RADIX256_MAX_N}")
    return kind


def _launch(pairs: bool, kind: KeyType, planes: list) -> None:
    """Enqueue one sort, keys only or pairs, on the current stream: `planes`
    are the C entry's buffer arguments before its counts buffer (inputs,
    outputs, ping-pong buffers), the first of them the keys."""
    dev = planes[0].device
    n = planes[0].shape[0]
    lib = _nvcc.load(SOURCE)
    if pairs:
        op, fn = "radix256.sort_pairs", lib.gst_radix256_sort_pairs
        parts = -(-n // lib.gst_radix256_pairs_partition())
    else:
        op, fn = "radix256.sort", lib.gst_radix256_sort
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
    _nvcc.launch(op, fn, *[t.data_ptr() for t in planes], counts.data_ptr(),
                 scratch.data_ptr(), scratch.numel() - 1, *epochs,
                 _KIND[kind], n, device=dev, stream=stream)


@launch_counter
def sort(keys: torch.Tensor) -> torch.Tensor:
    """Ascending sort of a 1-D tensor of uint32, int32 or float32 keys by
    their u32 codes (core/codec.py; NaNs where their codes put them), equal
    codes in input order; returns a new tensor of the keys' dtype.

    A CUDA tensor (n < 2^31) runs `csrc/binning256.cu`: the upsweep and four
    passes on the current stream, 5 launches counted in `sort.launches`, no
    host readback (or raises, also under CUDA-graph capture: the status
    words' epochs would replay); a CPU tensor takes `sort_plain`."""
    kind = _check("sort", keys)
    if keys.device.type == "cpu":
        return sort_plain(keys)
    if keys.shape[0] == 0:
        return keys.clone()
    keys = keys.contiguous()
    out = torch.empty_like(keys)
    _launch(False, kind, [keys, out, torch.empty_like(keys)])
    sort.launches += 1 + PASSES
    return out


@launch_counter
def sort_pairs(keys: torch.Tensor, values: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """`sort` carrying a payload: a 1-D tensor of any 32-bit dtype, as long
    as the keys, moved as raw bits (NaN patterns included) to where its
    keys go; returns (keys, values), new tensors of their dtypes, equal
    codes in input order.

    A CUDA pair runs `csrc/binning256.cu`'s pairs form: the upsweep and four
    passes that carry the payload, 5 launches counted in
    `sort_pairs.launches`, no host readback (or raises, also under
    CUDA-graph capture); a CPU pair takes `sort_pairs_plain`."""
    kind = _check("sort_pairs", keys)
    if values.shape != keys.shape or values.dtype.itemsize != 4:
        raise ValueError(f"radix256.sort_pairs: the payload must be 32-bit "
                         f"words of the keys' shape {tuple(keys.shape)}, got "
                         f"{values.dtype} {tuple(values.shape)}")
    if values.device != keys.device:
        raise ValueError(f"radix256.sort_pairs: payload on {values.device}, "
                         f"keys on {keys.device}")
    if keys.device.type == "cpu":
        return sort_pairs_plain(keys, values)
    if keys.shape[0] == 0:
        return keys.clone(), values.clone()
    keys, values = keys.contiguous(), values.contiguous()
    out, vout = torch.empty_like(keys), torch.empty_like(values)
    _launch(True, kind, [keys, values, out, vout, torch.empty_like(keys),
                         torch.empty_like(values)])
    sort_pairs.launches += 1 + PASSES
    return out, vout
