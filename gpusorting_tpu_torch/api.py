"""Sorter objects: configuration, sorting, self-test and batch timing.

Port of `gpusorting_tpu/api.py`.  Reference analogs:
  - `GPUSortBase` (GPUSortingD3D12/GPUSortBase.h:15-584): per-algorithm host
    object with config, TestAll, BatchTiming, ValidateOutput
  - Unity `OneSweep.Sort(...)` immediate and CommandBuffer overloads
    (Runtime/OneSweep.cs:297-427): `sort()` sorts at once, `make_sort_fn()`
    returns a closure
  - the algorithm families DeviceRadixSort / OneSweep / ForwardSweep /
    EmulatedDeadlocking and the FFXParallelSort baseline (README.md:5-15),
    each a class naming its `variant` of the `Backend.PALLAS` router.

A sorter makes its test inputs on the device it is given, the CUDA card by
default; it raises where that card is absent and never picks the CPU by
itself.
"""

from __future__ import annotations

import dataclasses

import torch

from . import ops
from .core import prng
from .core.config import (
    ALL_KEY_TYPES,
    ALL_ORDERS,
    ALL_PAYLOAD_TYPES_32,
    Backend,
    EntropyPreset,
    Mode,
    Order,
    SortConfig,
    get_device_info,
    get_tuning_parameters,
)
from .ops import flat_sort
from .utils import timing, validate


@dataclasses.dataclass
class TestReport:
    passed: int = 0
    failed: int = 0
    failures: list = dataclasses.field(default_factory=list)

    def record(self, ok: bool, label: str):
        if ok:
            self.passed += 1
        else:
            self.failed += 1
            self.failures.append(label)

    @property
    def all_passed(self) -> bool:
        return self.failed == 0

    def __str__(self):
        s = f"{self.passed} / {self.passed + self.failed} passed"
        if self.failures:
            s += "; failures: " + ", ".join(self.failures[:10])
        return s


class GPUSorterBase:
    """Base sorter (reference: GPUSortBase, GPUSortBase.h:15-584)."""

    variant = "onesweep"

    def __init__(self, config: SortConfig | None = None, tuning=None,
                 device: torch.device | str = "cuda", **kw):
        """tuning: optional manual TuningParameters — the analog of the
        reference's constructors that take explicit tuning instead of the
        device-table lookup (GPUSortBase.h:57-155).  When given, its
        radix_tile_rows is passed to the PALLAS engines as `tile_rows`.

        device: where the harness (validate_sort, test_all, batch_timing)
        makes its inputs, and whose tuning row applies; "cuda" raises when
        torch sees no card ("cpu" runs the kernels' plain versions)."""
        self.config = config or SortConfig(**kw)
        self.device = prng.require_device(device)
        self.device_info = get_device_info(self.device)
        self._manual_tuning = tuning is not None
        self.tuning = tuning if tuning is not None else get_tuning_parameters(
            self.device_info, self.config.mode)

    @property
    def _tile_override(self):
        return self.tuning.radix_tile_rows if self._manual_tuning else None

    # -- sorting ----------------------------------------------------------
    def sort(self, keys: torch.Tensor, values: torch.Tensor | None = None):
        """Sort at once (Unity immediate-mode overloads analog)."""
        if values is None:
            return ops.sort(keys, order=self.config.order,
                            backend=self.config.backend,
                            variant=self.variant,
                            tile_rows=self._tile_override)
        return ops.sort_pairs(keys, values, order=self.config.order,
                              backend=self.config.backend,
                              variant=self.variant,
                              tile_rows=self._tile_override)

    def make_sort_fn(self, pairs: bool = False, donate: bool = False):
        """Return a sort closure over this sorter's configuration (Unity
        CommandBuffer-mode analog).

        donate=True is accepted for parity and has no effect: PyTorch runs
        eagerly and the engines never write into their inputs, as on the
        JAX package's CPU backend, which ignores the donation."""
        del donate
        order, backend = self.config.order, self.config.backend
        variant, tile = self.variant, self._tile_override
        if pairs:
            return lambda k, v: ops.sort_pairs(k, v, order, backend, variant,
                                               tile)
        return lambda k: ops.sort(k, order, backend, variant, tile)

    # -- validation (ValidateOutput analog, GPUSortBase.h:482-515) --------
    def validate_sort(self, n: int, seed: int,
                      entropy=EntropyPreset.E100) -> bool:
        kt = self.config.key_type.dtype
        if self.config.mode == Mode.PAIRS:
            pt = self.config.payload_type.dtype
            keys, vals = prng.make_test_pairs(n, seed, kt, pt, entropy,
                                              device=self.device)
            out_k, out_v = self.sort(keys, vals)
            errs = validate.count_pair_violations(out_k, out_v,
                                                  self.config.order)
        else:
            keys = prng.make_test_keys(n, seed, kt, entropy,
                                       device=self.device)
            out_k = self.sort(keys)
            errs = validate.count_order_violations(out_k, self.config.order)
        return int(errs) == 0

    def validate_against_oracle(self, n: int, seed: int) -> bool:
        """Bit-exact identity with the flat `torch.sort` oracle (the
        CUB-identity analog)."""
        kt = self.config.key_type.dtype
        if self.config.mode == Mode.PAIRS:
            pt = self.config.payload_type.dtype
            keys, vals = prng.make_test_pairs(n, seed, kt, pt,
                                              device=self.device)
            out_k, out_v = self.sort(keys, vals)
            ref_k, ref_v = flat_sort.sort_pairs(keys, vals, self.config.order)
            return (int(validate.identical(out_k, ref_k)) == 0
                    and int(validate.identical(out_v, ref_v)) == 0)
        keys = prng.make_test_keys(n, seed, kt, device=self.device)
        ref_k = flat_sort.sort_keys(keys, self.config.order)
        return int(validate.identical(self.sort(keys), ref_k)) == 0

    # -- test suites (TestAll analog, GPUSortBase.h:517-524) --------------
    def test_all(self, boundary_window: int | None = None,
                 large_sizes: tuple = (1 << 21,),
                 report: TestReport | None = None,
                 boundary_stride: int = 1) -> TestReport:
        """Boundary-exhaustive sweep [part, 2*part] + large sizes.

        Reference: every size in [partitionSize, 2*partitionSize], seed=size
        (GPUSortBase.h:245-248), then multi-dispatch large tests
        (DeviceRadixSort.cpp:97-128).  `boundary_stride` thins the sweep;
        stride 1 is the exhaustive reference sweep.
        """
        report = report or TestReport()
        part = boundary_window or self.tuning.partition_size
        for n in range(part, 2 * part + 1, boundary_stride):
            ok = self.validate_sort(n, seed=n)
            report.record(ok, f"{type(self).__name__} n={n}")
            if not ok:
                break
        for n in large_sizes:
            report.record(
                self.validate_sort(int(n), seed=int(n) & 0x7FFFFFFF),
                f"{type(self).__name__} large n={n}")
        return report

    # -- timing (BatchTiming analog, GPUSortBase.h:205-235) ---------------
    def batch_timing(self, n: int, batch: int = 10, seed: int = 10,
                     entropy: EntropyPreset = EntropyPreset.E100) -> dict:
        """Time this sorter's configuration per the reference's rules
        (utils/timing.py); a device measurement, so it needs a CUDA card."""
        backend, variant, tile = (self.config.backend, self.variant,
                                  self._tile_override)
        if self.config.mode == Mode.PAIRS:
            def fn(keys):
                return ops.sort_pairs(keys, keys, Order.ASCENDING, backend,
                                      variant, tile)[0]
        else:
            def fn(keys):
                return ops.sort(keys, Order.ASCENDING, backend, variant, tile)

        res = timing.batch_timing(fn, n, batch=batch, seed=seed,
                                  entropy=entropy, device=self.device)
        res["algorithm"] = type(self).__name__
        res["mode"] = self.config.mode.value
        return res


class OneSweep(GPUSorterBase):
    """Single-pass-scan family (reference: OneSweep.hlsl / OneSweep.cu).

    As in the JAX package, its PALLAS variant runs the bitonic network
    (ops/bitonic.py): on the card the in-tile `local_stages` kernel of
    `csrc/bitonic.cu` and the above-tile hyper trips of
    `csrc/mergesweep.cu`.  The fused
    single-pass radix engine is variant "radix16"."""

    variant = "onesweep"


class DeviceRadixSort(GPUSorterBase):
    """Reduce-then-scan family (reference: DeviceRadixSort.hlsl/.cu):
    separate Upsweep / Scan / Downsweep launches per pass (ops/rts.py)."""

    variant = "device_radix"


class ForwardSweep(OneSweep):
    """Portable lookback-with-fallback family (reference:
    ForwardSweep.hlsl).  Its PALLAS variant runs the bitonic network, as
    OneSweep's does."""

    variant = "forward_sweep"


class EmulatedDeadlocking(OneSweep):
    """Adversarial-scheduling test variant (reference:
    EmulatedDeadlocking.hlsl:15-247); must give identical output.

    Its PALLAS variant runs the fused radix-16 engine with every pass cut
    at `radix16.adversarial_segments` (after the first tile, near thirds,
    before the last): on the card one `csrc/binning.cu` launch per tile
    range, each resuming from the last one's cursors, after one
    `csrc/global_hist.cu` launch."""

    variant = "emulated_deadlocking"


class FFXParallelSort(GPUSorterBase):
    """Vendored-baseline analog (reference: FFXParallelSort.cpp:28-329).

    4-bit digits, 8 passes, fixed tuning; u32 ascending only in the
    reference.  Exists as a perf baseline, not a recommended path.
    """

    variant = "ffx"

    def __init__(self, config: SortConfig | None = None, **kw):
        super().__init__(config, **kw)
        if (self.config.key_type != ALL_KEY_TYPES[0]
                or self.config.order != Order.ASCENDING):
            raise ValueError("FFXParallelSort supports u32 ascending only "
                             "(parity with reference)")


# ---------------------------------------------------------------------------
# Super tests (reference: Tests.h:6-368 — 18-config sweeps per algorithm)
# ---------------------------------------------------------------------------


def super_test(sorter_cls=OneSweep, sizes: tuple = (1 << 12, (1 << 12) + 13),
               backend: Backend = Backend.AUTO,
               device: torch.device | str = "cuda") -> TestReport:
    """3 key types x 3 payload types x 2 orders = 18 configs, each
    validated on `device`."""
    report = TestReport()
    for kt in ALL_KEY_TYPES:
        for pt in ALL_PAYLOAD_TYPES_32:
            for order in ALL_ORDERS:
                s = sorter_cls(SortConfig(mode=Mode.PAIRS, order=order,
                                          key_type=kt, payload_type=pt,
                                          backend=backend),
                               device=device)
                for n in sizes:
                    ok = s.validate_sort(int(n), seed=int(n))
                    report.record(
                        ok, f"{kt.value}/{pt.value}/{order.value} n={n}")
    return report
