"""The segmented sort's shared-memory tile: every segment of a layout whose
longest segment holds at most 8192 keys, sorted inside one group of
threads by one launch (the port's counterpart of SplitSort's bin kernels
for segments of up to 8192, SplitSortRadixFine, SplitSort.cuh:228-453).

Ports no TPU kernel.  `segsort/splitsort.py` sends a random-length layout
here on the card from its routing row's `segsort_tile_max` (the `tile`
route), in place of the host's window plan and the composite's sort over
int64 keys.

  kernel — (`csrc/segtile.cu`) a group of threads a segment: its keys
           read once into registers with their 16-bit positions, ceil(
           bits_to_sort / 8) stable 8-bit LSD passes through a shared-memory
           stage (warp-ballot ranks, a scan of the 256 digit counts), the
           keys written out once and each payload word read once from the
           segment's range at its key's position (index chasing).  One of
           `TILES` instantiations, the smallest that holds the layout's
           longest segment.
  codec  — fused: the kernel reads raw u32, i32 or f32 bits and orders
           them by their u32 codes (core/codec.py), moving raw bits.
  rider  — none, one or two planes of 32-bit words, or one plane of 64-bit
           words (a 64-bit payload is not split into two planes).

A call reads nothing back to the host and launches one kernel, counted by
`sort.launches`.  A CPU tensor takes `sort_plain`, one stable sort of the
(segment, masked code) composite in plain PyTorch.
"""

from __future__ import annotations

import torch

from ..core import codec
from ..core.config import KeyType
from ..ops import _nvcc
from ..utils.trace import launch_counter

SOURCE = _nvcc.CSRC / "segtile.cu"
# the kernel's instantiations: the longest segment each takes
TILES = (256, 1024, 2048, 4096, 8192)
MAX_TILE = TILES[-1]
_KIND = {KeyType.UINT32: 0, KeyType.INT32: 1, KeyType.FLOAT32: 2}
_M32 = 0xFFFFFFFF


def passes_for(bits_to_sort: int) -> int:
    """8-bit passes that cover `bits_to_sort` low key bits."""
    return -(-bits_to_sort // 8)


def tile_for(max_len: int) -> int:
    """The smallest instantiation that holds a segment of `max_len` keys."""
    for tile in TILES:
        if max_len <= tile:
            return tile
    raise ValueError(f"segtile: a segment of {max_len} keys exceeds the "
                     f"largest tile, {MAX_TILE}")


def _word_view(x: torch.Tensor) -> torch.Tensor:
    """x as signed words of its width (torch's unsigned types index
    nothing)."""
    return x.view(torch.int32 if x.dtype.itemsize == 4 else torch.int64)


def _starts(seg_offsets: torch.Tensor) -> torch.Tensor:
    """The offsets as int64 u32 values."""
    off = seg_offsets
    if off.dtype == torch.uint32:
        off = off.view(torch.int32)
    return off.to(torch.int64) & _M32


def sort_plain(seg_offsets: torch.Tensor, keys: torch.Tensor,
               planes: tuple = (), bits_to_sort: int = 32):
    """The kernel's sort in plain PyTorch: each key's segment (the last
    start at or below it, starts past n read as n), then one stable sort
    of (segment, the low 8 * passes_for(bits_to_sort) bits of its u32
    code); keys and planes move as raw bits.  Returns (keys, planes)."""
    n = keys.shape[0]
    starts = _starts(seg_offsets).clamp(max=n)
    pos = torch.arange(n, dtype=torch.int64, device=keys.device)
    seg = torch.searchsorted(starts, pos, right=True) - 1
    codes = (codec.encode_biased(keys) ^ codec.SIGN).to(torch.int64) & _M32
    mask = (1 << (8 * passes_for(bits_to_sort))) - 1
    order = torch.argsort((seg << 32) | (codes & mask), stable=True)
    return (_word_view(keys)[order].view(keys.dtype),
            tuple(_word_view(p)[order].view(p.dtype) for p in planes))


def _payload_kind(planes: tuple, keys: torch.Tensor) -> int:
    """0 none, 1 one 32-bit plane, 2 two, 3 one 64-bit plane; raises on
    anything else."""
    for p in planes:
        if p.shape != keys.shape or p.device != keys.device:
            raise ValueError(f"segtile.sort: a payload plane {p.dtype} "
                             f"{tuple(p.shape)} on {p.device} does not "
                             f"match the keys {tuple(keys.shape)} on "
                             f"{keys.device}")
    widths = tuple(p.dtype.itemsize for p in planes)
    kinds = {(): 0, (4,): 1, (4, 4): 2, (8,): 3}
    if widths not in kinds:
        raise ValueError(f"segtile.sort: payload planes of {widths} bytes; "
                         "it takes none, one or two of 4, or one of 8")
    return kinds[widths]


@launch_counter
def sort(seg_offsets: torch.Tensor, keys: torch.Tensor, planes: tuple = (),
         bits_to_sort: int = 32, max_len: int = MAX_TILE):
    """Sort every segment of a 1-D tensor of uint32, int32 or float32 keys,
    stably, by the low 8 * passes_for(bits_to_sort) bits of their u32
    codes, carrying `planes` (none, one or two of 32-bit words, or one of
    64-bit words) as raw bits.  `seg_offsets` are the segments' exclusive
    starts (a 1-D integer tensor on the keys' device; the first 0, none
    below its predecessor), the last segment ending at the keys' end;
    `max_len` bounds every segment's length and picks the tile.  Returns
    (keys, planes), new tensors of their dtypes.

    A CUDA tensor runs `csrc/segtile.cu`: one launch counted in
    `sort.launches`, no host readback; a CPU tensor takes `sort_plain`."""
    kind = codec.key_type_of(keys)
    if keys.ndim != 1:
        raise ValueError(f"segtile.sort takes 1-D keys, got "
                         f"{tuple(keys.shape)}")
    if not 1 <= bits_to_sort <= 32:
        raise ValueError(f"bits_to_sort must be in [1, 32], got "
                         f"{bits_to_sort}")
    payload = _payload_kind(planes, keys)
    tile = tile_for(max_len)
    if keys.device.type == "cpu":
        return sort_plain(seg_offsets, keys, planes, bits_to_sort)
    n, segs = keys.shape[0], seg_offsets.shape[0]
    if n == 0:
        return keys.clone(), tuple(p.clone() for p in planes)
    if segs == 0:
        raise ValueError("segtile.sort: no segments for "
                         f"{n} keys")
    if seg_offsets.dtype.itemsize != 4:
        seg_offsets = codec.wrap_int32(_starts(seg_offsets))
    offs = seg_offsets.contiguous()
    if offs.device != keys.device:
        raise ValueError(f"segtile.sort: offsets on {offs.device}, keys on "
                         f"{keys.device}")
    keys = keys.contiguous()
    planes = tuple(p.contiguous() for p in planes)
    out = torch.empty_like(keys)
    outs = tuple(torch.empty_like(p) for p in planes)
    ptr = [p.data_ptr() for p in planes] + [None] * (2 - len(planes))
    optr = [o.data_ptr() for o in outs] + [None] * (2 - len(outs))
    lib = _nvcc.load(SOURCE)
    _nvcc.launch("segtile.sort", lib.gst_segtile_sort, keys.data_ptr(),
                 out.data_ptr(), offs.data_ptr(), segs, n, ptr[0], optr[0],
                 ptr[1], optr[1], payload, _KIND[kind],
                 passes_for(bits_to_sort), tile, device=keys.device)
    sort.launches += 1
    return out, outs
