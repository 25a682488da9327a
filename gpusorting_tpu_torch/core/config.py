"""Configuration types for the PyTorch/CUDA sort engine.

Port of `gpusorting_tpu/core/config.py`:
  - enums MODE/ORDER/KEY_TYPE/PAYLOAD_TYPE/ENTROPY_PRESET and `Backend`
    (reference: GPUSortingD3D12/GPUSorting.h:14-87)
  - `DeviceInfo`, probed from the tensor's device with
    `torch.cuda.get_device_properties` (reference: GPUSortingD3D12.cpp:18-81)
  - `tensorcores_per_chip` and the `GST_MEGACORE` gate `megacore_parallel`
    (no `grid_semantics`: no kernel here declares a Mosaic grid)
  - `TuningParameters`, the radix engines' tile table per card and mode,
    and its overrides (reference: Tuner.h:895-927)
  - `RoutingParameters`, its per-card table and overrides, and the single
    AUTO routing decision `auto_engine`.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import os

import torch


class Mode(enum.Enum):
    """Sorting mode (reference: GPUSorting.h `GPU_SORTING_MODE`)."""

    KEYS_ONLY = "keys_only"
    PAIRS = "pairs"


class Order(enum.Enum):
    """Sort direction (reference: GPUSorting.h `GPU_SORTING_ORDER`).

    Descending is the element-wise reverse of the stable ascending output
    (SortCommon.hlsl `DescendingIndex`): ties appear in reverse input order.
    """

    ASCENDING = "ascending"
    DESCENDING = "descending"


class KeyType(enum.Enum):
    """Key element type (reference: GPUSorting.h `GPU_SORTING_KEY_TYPE`)."""

    UINT32 = "uint32"
    INT32 = "int32"
    FLOAT32 = "float32"

    @property
    def dtype(self) -> torch.dtype:
        return {"uint32": torch.uint32, "int32": torch.int32,
                "float32": torch.float32}[self.value]


class PayloadType(enum.Enum):
    """Payload element type (reference: GPUSorting.h `GPU_SORTING_PAYLOAD_TYPE`).

    The 64-bit types ride the pair sorts as two int32 planes (lo, hi);
    torch's signed `int64` is accepted beside `uint64`.
    """

    UINT32 = "uint32"
    INT32 = "int32"
    FLOAT32 = "float32"
    UINT64 = "uint64"
    FLOAT64 = "float64"

    @property
    def dtype(self) -> torch.dtype:
        return {
            "uint32": torch.uint32,
            "int32": torch.int32,
            "float32": torch.float32,
            "uint64": torch.uint64,
            "float64": torch.float64,
        }[self.value]


class EntropyPreset(enum.IntEnum):
    """Thearling–Smith entropy presets (reference: Utility.hlsl:65-75).

    Preset k ANDs (k-1) extra PRNG draws into each key:
      1 -> 1.000 bits/bit, 2 -> .811, 3 -> .544, 4 -> .337, 5 -> .201
    """

    E100 = 1
    E081 = 2
    E054 = 3
    E033 = 4
    E020 = 5

    @property
    def and_count(self) -> int:
        return int(self) - 1

    @property
    def bits_per_bit(self) -> float:
        return {1: 1.0, 2: 0.811, 3: 0.544, 4: 0.337, 5: 0.201}[int(self)]


class Backend(enum.Enum):
    """Which compute path executes the sort.

    XLA     — the flat library sort: `torch.sort(stable=True)` over the key
              codes (CUB on CUDA, the reference's own oracle).  The name is
              kept from the JAX package, where this role is `jax.lax.sort`.
    PALLAS  — the hand-written engine families, picked by `variant=`
              (ops/radix.py); the name is kept from the JAX package, whose
              kernels here are hand-written CUDA.
    AUTO    — `auto_engine()` picks per size and device: on a CUDA card
              with a routing row, sorts at or above the row's thresholds
              run the range-exchange engine (ops/rangesweep.py) or, keys
              only and pairs with a 32-bit payload, the 8-bit-digit radix
              sort (ops/radix256.py); all else runs the flat sort.
    """

    XLA = "xla"
    PALLAS = "pallas"
    AUTO = "auto"


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    """Device capability probe (reference: GetDeviceInfo,
    GPUSortingD3D12.cpp:18-81).  `hbm_gbps` is the data-sheet memory rate
    (GB/s) the bound of a memory-bound kernel is computed from; 0.0 where
    the card is not in `_CUDA_HBM_GBPS`."""

    platform: str        # "cuda" or "cpu"
    device_kind: str     # torch.cuda.get_device_name, or "cpu"
    generation: str      # routing-table key: "h100", "cuda", "cpu"
    num_devices: int
    hbm_bytes: int
    hbm_gbps: float

    @property
    def supports_pallas(self) -> bool:
        """Backend.PALLAS runs its hand-written kernels here: a CUDA card
        (the JAX package's: a TPU); elsewhere the plain versions run."""
        return self.platform == "cuda"


# Data-sheet HBM rates in GB/s, matched against the lower-cased device name
# (NVIDIA H100 data sheet: the SXM card, whose name ends in "HBM3").  A card
# gets its row when a run on it needs one.
_CUDA_HBM_GBPS = (
    ("h100 80gb hbm3", 3350.0),
)


@functools.lru_cache(maxsize=None)
def _probe(device: str) -> DeviceInfo:
    dev = torch.device(device)
    if dev.type != "cuda":
        return DeviceInfo(platform=dev.type, device_kind=dev.type,
                          generation=dev.type, num_devices=1, hbm_bytes=0,
                          hbm_gbps=0.0)
    props = torch.cuda.get_device_properties(dev)
    name = props.name
    low = name.lower()
    bw = next((r for k, r in _CUDA_HBM_GBPS if k in low), 0.0)
    return DeviceInfo(platform="cuda", device_kind=name,
                      generation="h100" if "h100" in low else "cuda",
                      num_devices=torch.cuda.device_count(),
                      hbm_bytes=props.total_memory, hbm_gbps=bw)


def get_device_info(device: torch.device | str | None = None) -> DeviceInfo:
    """Probe `device` (a tensor's device); None probes the current CUDA
    card, or the CPU where torch sees no card."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _probe(str(dev))


def tensorcores_per_chip(info: DeviceInfo | None = None) -> int:
    """TPU TensorCores per chip, the count the JAX package's dual-core
    ("Megacore") gate reads: 1 for every CUDA card and for the CPU, since a
    GPU has no pair of cores that split one kernel's grid between them."""
    del info
    return 1


def megacore_parallel(info: DeviceInfo | None = None) -> bool:
    """Whether the reduce-then-scan engine runs its core-split-safe pass
    (ops/rts.py: the row-writing downsweep and the edge fixup).

    GST_MEGACORE=1 or =0 forces it, read at each call, as in the JAX
    package; otherwise it is on only where `tensorcores_per_chip` is above
    1, which is never here, so the element-writing downsweep stays the
    default on every device."""
    env = os.environ.get("GST_MEGACORE")
    if env in ("0", "1"):
        return env == "1"
    return tensorcores_per_chip(info) > 1


@dataclasses.dataclass(frozen=True)
class TuningParameters:
    """Per-card tile geometry of the radix engines (reference:
    `TuningParameters`, GPUSorting.h:31-38, selected by Tuner.h:14-927).

    The JAX package's row also carries TPU budgets (VMEM limits, bucket
    bits, in-VMEM sort caps); no ported module reads them, so they are not
    here and `tuning_from_jax_fields` drops them.  Its `vmem_limit_bytes`,
    which sizes the network's tile there, has no counterpart: here
    `network_smem_bytes` does.

      partition_rows     — rows of 128 keys per partition, the reference's
                           PART_SIZE analog: the sorter objects' boundary
                           test window is [partition_size, 2*partition_size].
      radix_tile_rows    — rows of 128 keys per tile of the radix engines
                           (ops/rts.py, ops/radix16.py).
      network_smem_bytes — shared memory one block of the sorting network's
                           in-tile kernel may hold its tile's planes in
                           (ops/bitonic.py); 48 KB by default, what every
                           CUDA card gives a block without opting in.
      measured           — True only for a row measured on its card.
    """

    partition_rows: int
    radix_tile_rows: int = 512
    network_smem_bytes: int = 48 << 10
    measured: bool = False

    @property
    def partition_size(self) -> int:
        return self.partition_rows * 128

    def network_tile_rows(self, num_ops: int) -> int:
        """Rows of 128 keys per tile of the sorting network: the largest
        power of two whose `num_ops` int32 planes fit `network_smem_bytes`
        (port of the JAX `TuningParameters.network_tile_rows`, which sizes
        the tile by VMEM instead)."""
        rows = self.network_smem_bytes // (num_ops * 128 * 4)
        if rows < 1:
            raise ValueError(f"network_smem_bytes={self.network_smem_bytes} "
                             f"holds no 128-key row of {num_ops} planes")
        return 1 << (rows.bit_length() - 1)


_TUNING_TABLE = {
    # H100 (SXM), measured on an NVIDIA H100 80GB HBM3 at 700.00 W as
    # nvidia-smi names it: ms a 2^28 sort, the median of 3 processes (each
    # the mean of 3 sorts after a warm-up), int32 codes.
    # radix_tile_rows: `python -m gpusorting_tpu_torch autotune --engine
    #   rts --n 2^28 --tiles 8 16 32 64 128 256` (probes/
    #   torch_autotune_sweeps.py).  Keys: 128 rows 12.348 ms, runner-up 256
    #   rows 12.390 (32 rows 12.549, spread 0.001-0.067).  Pairs: 256 rows
    #   17.571, runner-up 16 rows 17.650 (32 rows 17.758, spread
    #   0.026-0.103).  256 is the sweep's edge; the row form's stage
    #   (rts.ROWS_STAGE_BYTES) holds at most 436 rows.
    # partition_rows: the tile (the radix engines' partition; it sizes only
    #   the sorter objects' boundary-test window).
    # network_smem_bytes: the 227 KB (232448 bytes) an H100 block may opt
    #   in to (a 2^15-key tile for one plane, 2^14 for two or three, 2^13
    #   for four).  probes/torch_row_sweeps.py, `onesweep` keys + pairs at
    #   2^28: 232448 bytes 139.133 ms, runner-up half of it 150.528, a
    #   quarter 169.687.  The network reads the keys-only row's budget for
    #   every mode.
    "h100": {
        Mode.KEYS_ONLY: TuningParameters(128, 128, 232448, measured=True),
        Mode.PAIRS: TuningParameters(256, 256, 232448, measured=True),
    },
}
# Every other device, the CPU included (the JAX package's generic row).
_GENERIC_TUNING = {
    Mode.KEYS_ONLY: TuningParameters(512, 512),
    Mode.PAIRS: TuningParameters(512, 512),
}

# Process-wide per-mode overrides installed by callers (tests, a future
# autotuner).
_TUNING_OVERRIDES: dict[Mode, TuningParameters] = {}


def set_tuning_override(mode: Mode, params: TuningParameters) -> None:
    """Install a tuning row for `mode` that wins over the card table."""
    _TUNING_OVERRIDES[mode] = params


def clear_tuning_overrides() -> None:
    _TUNING_OVERRIDES.clear()


def get_tuning_parameters(info: DeviceInfo | None = None,
                          mode: Mode = Mode.KEYS_ONLY) -> TuningParameters:
    """Tuning row (reference: Tuner::GetTuningParameters, Tuner.h:895-927):
    the installed override for `mode`, else the card's table row, else the
    generic row.  The engines pass the info of their tensor's device; as
    with routing, the override also wins when `info` is given."""
    if mode in _TUNING_OVERRIDES:
        return _TUNING_OVERRIDES[mode]
    info = info or get_device_info()
    return _TUNING_TABLE.get(info.generation, _GENERIC_TUNING)[mode]


def tuning_from_jax_fields(d: dict) -> TuningParameters:
    """The port's row from a JAX `TuningParameters` rendered by
    `dataclasses.asdict`; the TPU-only fields are dropped."""
    names = {f.name for f in dataclasses.fields(TuningParameters)}
    return TuningParameters(**{k: v for k, v in d.items() if k in names})


@dataclasses.dataclass(frozen=True)
class RoutingParameters:
    """Routing thresholds and chunk lengths of the range-exchange engine,
    the FFX engine's fixed tile, and the segmented sort's window caps and
    class bounds.

    The JAX package's row carries one more kind of field, which
    `routing_from_jax_fields` drops: the mapped-row crossovers
    (`map_rows_min_*`, a TPU `lax.map` route; the port sorts rows in one
    batched `torch.sort`).

      rangesweep_min            — smallest keys-only n AUTO sends to
                                  rangesweep; None disables the route.
      rangesweep_min_pairs      — the same for stable 32-bit-payload pairs.
      rangesweep_min_pairs_nonpow2 — an earlier band for non-power-of-two
                                  pair counts; None disables it.
      rangesweep_min_pairs_wide — 64-bit payloads (4 planes).
      rangesweep_min_index      — argsort (2 planes).
      rangesweep_seg_elems*     — phase-1 chunk length L per mode.
      mergesweep_seg_elems      — mergesweep's phase-1 segment length L
                                  (a power of two, at least 1024): one
                                  batched `torch.sort` of the N / L
                                  segments, then log2(N / L) merge passes.
      ffx_tile_rows             — the FFX engine's tile (rows of 128 keys).
                                  FFX is fixed-tuning by definition
                                  (FFXParallelSort.cpp:28-43): recorded
                                  here to be auditable, not to vary.
      window_max_keys/fused/pairs — largest max segment length the
                                  segmented sort's two-window ladder serves
                                  in its keys-only (`keys2`), bounded-bits
                                  (`fused`) and 32-bit pairs (`stable3`)
                                  modes (0: none); beyond it the workload
                                  splits by length class or takes the
                                  composite.
      segsort_bulk_max          — multi-class dispatch: largest length
                                  class the bulk window ladder sorts in
                                  place.
      segsort_padded_max        — multi-class dispatch: largest length
                                  class extracted and sorted as padded rows;
                                  longer segments go to the dense composite
                                  tail.
      segsort_extract_max_frac  — multi-class dispatch runs only when the
                                  extracted share of the elements is at most
                                  this.
      radix256_min              — smallest keys-only n AUTO sends to the
                                  8-bit-digit radix sort (ops/radix256.py,
                                  hand-written kernels; at most
                                  `RADIX256_MAX_N` keys); None disables the
                                  route.  The JAX package has no such route,
                                  so its rows convert to None.
      radix256_min_pairs        — the same for stable pairs with a 32-bit
                                  payload (the kernels' pairs form; argsort
                                  reaches it through `sort_pairs` with its
                                  int32 index; 64-bit payloads never).
      segsort_tile_max          — largest longest-segment length of a
                                  random-length layout the segmented sort
                                  sends to its shared-memory tile route
                                  on a CUDA card (segsort/segtile.py,
                                  hand-written kernel, at most 8192);
                                  0 disables the route.  The JAX package
                                  has no such route, so its rows convert
                                  to 0.
      measured                  — True only for a row measured on its card.
    """

    rangesweep_min: int | None = None
    rangesweep_seg_elems: int = 1 << 21
    rangesweep_min_pairs: int | None = None
    rangesweep_seg_elems_pairs: int = 1 << 21
    rangesweep_min_pairs_nonpow2: int | None = None
    rangesweep_min_pairs_wide: int | None = None
    rangesweep_seg_elems_pairs_wide: int = 1 << 21
    rangesweep_min_index: int | None = None
    rangesweep_seg_elems_index: int = 1 << 21
    mergesweep_seg_elems: int = 1 << 24
    ffx_tile_rows: int = 256
    window_max_keys: int = 32768
    window_max_fused: int = 32768
    window_max_pairs: int = 16384
    segsort_bulk_max: int = 4096
    segsort_padded_max: int = 131072
    segsort_extract_max_frac: float = 0.5
    radix256_min: int | None = None
    radix256_min_pairs: int | None = None
    segsort_tile_max: int = 0
    measured: bool = False


# The largest n the 8-bit-digit radix sort takes: its kernels index keys in
# 32 bits (ops/radix256.py).
RADIX256_MAX_N = (1 << 31) - 1


_ROUTING_TABLE = {
    # H100 (SXM), measured on an NVIDIA H100 80GB HBM3 at 700.00 W as
    # nvidia-smi names it; every time is the median of 3 processes.  Only
    # the SXM card has run it; PCIe and NVL cards take the same row.
    # Every route gives the same bits: each field picks a mechanism.
    # rangesweep_min, _pairs (and the pairs' non-power-of-two band):
    #   `python -m gpusorting_tpu_torch autotune --rangesweep` at n = 2^28
    #   and `--n 2^29` (probes/torch_autotune_sweeps.py): the flat sort
    #   wins at both sizes, so AUTO never takes rangesweep.  Keys 13.992 ms
    #   against 39.198 (L = 2^22) at 2^28, 27.176 against 79.011 at 2^29;
    #   pairs 23.557 against 106.121, 46.648 against 213.018.
    # rangesweep_seg_elems, _pairs: that sweep's L, 2^22 against 2^21:
    #   keys 39.198 against 51.174 ms, pairs 106.121 against 126.515 at
    #   2^28 (it times only these two).
    # rangesweep_min_pairs_wide, _index: probes/torch_row_sweeps.py, the
    #   public sort_pairs_wide / argsort forced onto rangesweep against
    #   backend=XLA at 2^28 and 2^29 (ms summed over both sizes): the flat
    #   sort 103.247 / 81.825 against rangesweep from 2^28 320.338 /
    #   277.314 and from 2^29 247.943 / 212.288.
    # rangesweep_seg_elems_pairs_wide, _index: the same probe at 2^28, L =
    #   2^23 106.821 / 92.447 ms, runner-up 2^22 111.837 / 100.697 (2^21
    #   131.724 / 121.125); 2^23 is the sweep's edge.
    # mergesweep_seg_elems: L = 2^27 is the fastest that still merges:
    #   chip_smoke.py phase 15 (the run PERF.md records as mergesweep's run
    #   C) timed 2^28 keys, switch off, at L = 2^20, 2^22, 2^24, 2^26,
    #   2^27: 108.3, 85.2, 63.3, 42.4, 31.2 ms (pairs 319.0, 259.2, 210.7,
    #   152.8, 118.6), one merge pass fewer winning each time.  L = 2^28 is
    #   one segment, the flat torch.sort (15.4 ms), which runs no merge
    #   kernel.
    # ffx_tile_rows: probes/torch_row_sweeps.py, the `ffx` variant keys +
    #   pairs at 2^28 over 64-1024 rows: 256 rows 33.010 ms, runner-up 128
    #   rows 33.105 (1024 rows 33.746).
    # window_max_pairs, _keys, _fused: 0, so no workload takes the
    #   two-window ladder.  probes/torch_row_sweeps.py, each cap over 0 ..
    #   2^18 at chip_smoke.py's segmented layouts (2^22 keys in segments of
    #   at most 2^2 .. 2^18, and 2^26 keys by length class, (c) and (d)),
    #   ms summed over the 11 layouts: u32 pairs 59.921 at 0, runner-up
    #   60.580 at 4 (16384: 79.843); u32 keys 56.551, runner-up 57.012 at 4
    #   (32768: 74.337); 16-bit keys with a payload (the fused window)
    #   79.141, runner-up 79.920 at 4 (32768: 98.053).  The tuner's own
    #   window sweep (`autotune --routing` at 2^22) agrees: the composite
    #   1.176-1.302 ms against the window's 2.372-2.815 at max lengths
    #   8192-65536.
    # segsort_bulk_max, segsort_padded_max: the same probe with the
    #   multi-class route forced (caps 0, extraction share 1.0), u32 pairs
    #   and keys summed: (4096, 131072) 135.474 ms, spread 7.726; the best,
    #   (65536, 524288), 128.772 wins by less than that spread, so the
    #   bounds stay.  They act only where the extraction share lets the
    #   multi-class route run, which it does not on this row.
    # radix256_min: 2^11, the smallest n from which the radix sort wins at
    #   every size swept: probes/torch_radix256_probe.py --sweep, AUTO on
    #   u32 keys with the route forced on and off, n = 1, 16, 256 and
    #   2^10 .. 2^29 at powers of two and halfway, events around each call
    #   from an empty stream.  The flat sort wins at 2^10 (0.083 against
    #   0.103 ms) and 1536 (0.093 against 0.100); from 2^11 the radix sort
    #   wins at every size: 0.118 against 0.153 ms at 2^11, 0.126 against
    #   0.226 at 2^16, 0.109 against 0.167 at 2^20, 7.190 against 15.525
    #   at 2^28, 14.184 against 30.315 at 2^29.  A second sweep had the
    #   radix sort ahead at every size, 1 included (0.111 against 0.136 ms
    #   at 2^10, 0.119 against 0.145 at 1536).  Below 2^17 both routes
    #   take the host's time a call (0.08-0.33 ms, the radix sort's nearly
    #   flat at 0.09-0.19), so the crossover moves with the host's jitter;
    #   2^11 is the smallest n the radix sort won from in both sweeps.
    # radix256_min_pairs: 1, the smallest n from which the pairs form wins
    #   at every size swept: probes/torch_radix256_probe.py --pairs, AUTO's
    #   sort_pairs on (u32, u32) pairs with the route forced on and off, n =
    #   1, 16, 256 and 2^10 .. 2^28 at powers of two and halfway, as for
    #   radix256_min.  Three sweeps of the 512 x 16 partition (two of its
    #   first build, one of the one installed) had the radix sort ahead at
    #   all 40 sizes: in the last, 0.172 against 0.203 ms at 1, 0.148
    #   against 0.151 at 2^10 (the narrowest), 0.116 against 0.208 at 2^16,
    #   0.813 against 1.519 at 2^24, 2.625 against 6.405 at 2^26, 10.126
    #   against 25.322 at 2^28.  Below 2^20 both routes take the host's
    #   time a call (0.10-0.27 ms).  The first build's 512 x 20 partition
    #   spilled and lost at 6 sizes below 786432.
    # segsort_tile_max: 8192, the largest max length swept, since the tile
    #   route beat the composite at all 36 layouts: probes/
    #   torch_segtile_probe.py --sweep, split_sort_pairs with the route on
    #   (8192) and off (0) in turns, 2^22 and 2^26 keys in random segments
    #   of at most 32, 64, .. 8192, (u32, u32) pairs by 32 bits and 16-bit
    #   keys with a 64-bit payload by 16 bits, the median of 5 calls each
    #   between events after an untimed call.  At 2^26, u32 pairs: 50.754
    #   against 534.215 ms at 32, 2.342 against 28.645 at 1024, 2.189
    #   against 18.662 at 4096, 2.158 against 17.231 at 8192; 16-bit keys
    #   with 64-bit payloads 1.308 against 15.334 at 8192.  The narrowest
    #   margin, 5.75x: 2^22 u32 pairs at 4096, 0.388 against 2.230 ms.
    # segsort_extract_max_frac: 0.0, so the multi-class route never runs:
    #   the probe at the picks above, all three modes summed, 116.601 ms at
    #   0.0 (and 0.1, 0.25: the same routes) against 175.506 at 0.5 and
    #   211.395 at 1.0.
    "h100": RoutingParameters(rangesweep_min=None,
                              rangesweep_seg_elems=1 << 22,
                              rangesweep_min_pairs=None,
                              rangesweep_seg_elems_pairs=1 << 22,
                              rangesweep_min_pairs_nonpow2=None,
                              rangesweep_min_pairs_wide=None,
                              rangesweep_seg_elems_pairs_wide=1 << 23,
                              rangesweep_min_index=None,
                              rangesweep_seg_elems_index=1 << 23,
                              mergesweep_seg_elems=1 << 27,
                              ffx_tile_rows=256,
                              window_max_keys=0,
                              window_max_fused=0,
                              window_max_pairs=0,
                              segsort_bulk_max=4096,
                              segsort_padded_max=131072,
                              segsort_extract_max_frac=0.0,
                              radix256_min=1 << 11,
                              radix256_min_pairs=1,
                              segsort_tile_max=8192,
                              measured=True),
}

# Process-wide override installed by callers (tests, a future autotuner).
_ROUTING_OVERRIDE: list[RoutingParameters] = []


def set_routing_override(params: RoutingParameters) -> None:
    """Install a routing row that wins over the card table."""
    _ROUTING_OVERRIDE.clear()
    _ROUTING_OVERRIDE.append(params)


def clear_routing_override() -> None:
    _ROUTING_OVERRIDE.clear()


def get_routing_parameters(info: DeviceInfo | None = None
                           ) -> RoutingParameters:
    """Routing row: the installed override, else the card's table row,
    else the defaults (every route off).

    Unlike the JAX package, the override also wins when `info` is given:
    the port's entry points always pass the info of the tensor's device.
    """
    if _ROUTING_OVERRIDE:
        return _ROUTING_OVERRIDE[0]
    info = info or get_device_info()
    return _ROUTING_TABLE.get(info.generation, RoutingParameters())


def routing_from_jax_fields(d: dict) -> RoutingParameters:
    """The port's row from a JAX `RoutingParameters` rendered by
    `dataclasses.asdict`; the TPU-only `map_rows_min_*` fields are
    dropped."""
    names = {f.name for f in dataclasses.fields(RoutingParameters)}
    return RoutingParameters(**{k: v for k, v in d.items() if k in names})


def auto_engine(n: int, mode: Mode = Mode.KEYS_ONLY,
                payload_bits: int = 32,
                info: DeviceInfo | None = None,
                index_payload: bool = False) -> str:
    """THE AUTO routing decision: "rangesweep", "radix256" or "xla" (the
    flat sort).

    Port of `gpusorting_tpu/core/config.py:auto_engine`, with the platform
    gate moved from TPU to CUDA: a CPU tensor always takes the flat route.
    index_payload=True is argsort (payload == index, 2 planes), routed by
    `rangesweep_min_index`.  Keys-only sorts the JAX rules leave on the flat
    sort go to "radix256" from the row's `radix256_min` (a route the JAX
    package does not have) up to `RADIX256_MAX_N`, and pairs with a 32-bit
    payload from its `radix256_min_pairs`.
    """
    inf = info or get_device_info()
    if inf.platform != "cuda":
        return "xla"
    r = get_routing_parameters(inf)
    k = None
    if mode == Mode.PAIRS:
        if index_payload:
            m = r.rangesweep_min_index
        elif payload_bits > 32:
            m = r.rangesweep_min_pairs_wide
        else:
            m = r.rangesweep_min_pairs
            mn = r.rangesweep_min_pairs_nonpow2
            if (mn is not None and n >= mn and n & (n - 1)
                    and (m is None or n < m)):
                return "rangesweep"
            k = r.radix256_min_pairs
    else:
        m = r.rangesweep_min
        k = r.radix256_min
    if k is not None and k <= n <= RADIX256_MAX_N and (m is None or n < m):
        return "radix256"
    return "rangesweep" if (m is not None and n >= m) else "xla"


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """Full sort configuration (reference: `GPUSortingConfig`,
    GPUSorting.h:70-76)."""

    mode: Mode = Mode.KEYS_ONLY
    order: Order = Order.ASCENDING
    key_type: KeyType = KeyType.UINT32
    payload_type: PayloadType = PayloadType.UINT32
    backend: Backend = Backend.AUTO


ALL_KEY_TYPES = (KeyType.UINT32, KeyType.INT32, KeyType.FLOAT32)
ALL_PAYLOAD_TYPES_32 = (PayloadType.UINT32, PayloadType.INT32,
                        PayloadType.FLOAT32)
ALL_ORDERS = (Order.ASCENDING, Order.DESCENDING)
