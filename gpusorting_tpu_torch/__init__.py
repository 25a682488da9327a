"""gpusorting_tpu_torch — the PyTorch/CUDA port of gpusorting_tpu.

A second package beside the JAX one, for NVIDIA Hopper: the same public
entry points, key codes, stability and descending rules, held bit-exact
against `gpusorting_tpu` on the same inputs.  It imports neither JAX nor
the JAX package.  Entry points compute on the device of the tensor given;
every kernel the JAX package wrote in Pallas becomes a hand-written CUDA
kernel (so far: the range-exchange relocate; the reduce-then-scan
Upsweep, scan and downsweep; radix16's global histogram and binning pass;
the sorting network's in-tile and cross-tile stages; the segmented sort's
compact and expand; mergesweep's merge tail and hyper stage; the
distributed sort's receive-side masking, `csrc/`); the JAX package's C++
host runtime has its twin in `native/` (built with g++ at first use).

Quick start:
    import gpusorting_tpu_torch as gstt
    out = gstt.sort(keys_cuda)                 # stable ascending
    k, v = gstt.sort_pairs(keys_cuda, values)  # stable pair sort
    out = gstt.sort(keys_cuda, backend=gstt.Backend.PALLAS,
                    variant="device_radix")    # the radix engines
    k, v = gstt.split_sort_pairs(offsets, keys_cuda, values, seg_count)
                                               # the segmented sort
    res = gstt.distributed_sort(shard)         # on every rank of an
                                               # initialised process group
    params, sweep = gstt.autotune(engine="rts")  # a tile sweep on the card

Console driver: `python -m gpusorting_tpu_torch {info,test,supertest,bench,
segsort,dist,autotune}`; headline benchmark: `python -m
gpusorting_tpu_torch.bench`.
"""

from .core.config import (
    Backend,
    DeviceInfo,
    EntropyPreset,
    KeyType,
    Mode,
    Order,
    PayloadType,
    RoutingParameters,
    SortConfig,
    TuningParameters,
    auto_engine,
    clear_routing_override,
    clear_tuning_overrides,
    get_device_info,
    get_routing_parameters,
    get_tuning_parameters,
    routing_from_jax_fields,
    set_routing_override,
    set_tuning_override,
    tuning_from_jax_fields,
)
from .api import (
    DeviceRadixSort,
    EmulatedDeadlocking,
    FFXParallelSort,
    ForwardSweep,
    GPUSorterBase,
    OneSweep,
    TestReport,
    super_test,
)
from .ops import argsort, sort, sort_batched, sort_pairs, sort_pairs_wide
from .parallel.dist_sort import (
    distributed_sort,
    distributed_sort_gather,
    make_mesh,
)
from .segsort.splitsort import (
    SegSortPlan,
    SplitSorter,
    make_segsort_fn,
    make_segsort_plan,
    split_sort_allocate_temp_memory,
    split_sort_free_temp_memory,
    split_sort_keys,
    split_sort_pairs,
    split_sort_pairs_wide,
)
from .utils.autotune import autotune, autotune_rangesweep, autotune_routing

__version__ = "0.1.0"

__all__ = [
    "Backend",
    "DeviceInfo",
    "DeviceRadixSort",
    "EmulatedDeadlocking",
    "EntropyPreset",
    "FFXParallelSort",
    "ForwardSweep",
    "GPUSorterBase",
    "KeyType",
    "Mode",
    "OneSweep",
    "Order",
    "PayloadType",
    "RoutingParameters",
    "SegSortPlan",
    "SortConfig",
    "SplitSorter",
    "TestReport",
    "TuningParameters",
    "argsort",
    "auto_engine",
    "autotune",
    "autotune_rangesweep",
    "autotune_routing",
    "distributed_sort",
    "distributed_sort_gather",
    "clear_routing_override",
    "clear_tuning_overrides",
    "get_device_info",
    "get_routing_parameters",
    "get_tuning_parameters",
    "make_mesh",
    "make_segsort_fn",
    "make_segsort_plan",
    "routing_from_jax_fields",
    "set_routing_override",
    "set_tuning_override",
    "sort",
    "sort_batched",
    "sort_pairs",
    "sort_pairs_wide",
    "split_sort_allocate_temp_memory",
    "split_sort_free_temp_memory",
    "split_sort_keys",
    "split_sort_pairs",
    "split_sort_pairs_wide",
    "super_test",
    "tuning_from_jax_fields",
]
