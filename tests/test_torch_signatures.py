"""Signature parity: every public function, class and public method that a
module of gpusorting_tpu defines has a counterpart in the same module of
gpusorting_tpu_torch (`ops.xla_sort` is `ops.flat_sort` there), and the
counterpart's parameters include the JAX one's, by name.

The only exceptions are the rows of EXCEPTIONS, each the port's deliberate
difference (ROADMAP.md, "Deliberate differences") with its reason.  A name
or parameter the JAX package adds and the port lacks fails here; a row that
no longer names a gap fails `test_every_exception_names_a_real_gap`.
"""

import importlib
import inspect
import pkgutil

import pytest

import gpusorting_tpu

_JAX, _PORT = "gpusorting_tpu", "gpusorting_tpu_torch"
_RENAMED = {"ops.xla_sort": "ops.flat_sort"}

# The reasons, one line each (ROADMAP.md "Deliberate differences")
_INTERPRET = ("no Pallas interpret mode: a CPU tensor takes each kernel's "
              "plain version")
_MESH = ("a torch.distributed process group takes the place of the JAX Mesh "
         "and its axis name")
_RING = ("the ring's ranks come from the process group; Pallas "
         "interpret-mode race detection has no CUDA twin")
_RANGESWEEP = ("rangesweep's probe arms: the relocate kernel is the one "
               "exchange, the cuts go hierarchical at K >= 64 and the "
               "constant-bucket skip is always on")
_MAP_ROWS = ("lax.map row bodies are a TPU layout device; the port sorts "
             "rows in one batched torch.sort")
_VMEM = ("TPU VMEM budgets and the TPU radix's bucket width and local-sort "
         "cap: the card's tiles are rows of 128 keys and "
         "network_smem_bytes")
_GRID = ("Mosaic grid semantics: a CUDA grid runs its blocks in no order, "
         "so carries are chained scans")
_RESOLVE = ("AUTO's route is auto_engine's alone; the port keeps no second "
            "family report")
_CHUNKS = ("SMEM-sized downsweep chunks: the port's downsweep is one launch "
           "a pass with no chunking")
_UNSTABLE = ("the unstable sort takes one key tensor (the whole comparator "
             "key), not lax.sort's (operands, num_keys, dimension)")

# (JAX module below the package, name or "Class.method", parameter or None
# for the whole object) -> reason
EXCEPTIONS = {
    ("core.config", "DeviceInfo", "vmem_bytes"): _VMEM,
    ("core.config", "TuningParameters", "bucket_bits"): _VMEM,
    ("core.config", "TuningParameters", "local_sort_cap"): _VMEM,
    ("core.config", "TuningParameters", "vmem_limit_bytes"): _VMEM,
    ("core.config", "RoutingParameters", "map_rows_min_keys"): _MAP_ROWS,
    ("core.config", "RoutingParameters", "map_rows_min_pairs"): _MAP_ROWS,
    ("core.config", "grid_semantics", None): _GRID,
    ("core.config", "SortConfig.resolve_backend", None): _RESOLVE,
    ("ops.bitonic", "sort_network_i32", "interpret"): _INTERPRET,
    ("ops.ffx", "sort_codes_ffx", "interpret"): _INTERPRET,
    ("ops.ffx", "sort_pairs_ffx", "interpret"): _INTERPRET,
    ("ops.kernels", "global_histogram", "interpret"): _INTERPRET,
    ("ops.kernels", "tile_histogram4", "interpret"): _INTERPRET,
    ("ops.kernels", "exclusive_scan", "interpret"): _INTERPRET,
    ("ops.mergesweep", "merge_sort_network_i32", "interpret"): _INTERPRET,
    ("ops.mergesweep", "sort_codes", "interpret"): _INTERPRET,
    ("ops.mergesweep", "sort_codes_stable_with", "interpret"): _INTERPRET,
    ("ops.radix16", "sort_codes_radix16", "interpret"): _INTERPRET,
    ("ops.radix16", "sort_pairs_radix16", "interpret"): _INTERPRET,
    ("ops.rangesweep", "sort_codes_rangesweep", "interpret"): _INTERPRET,
    ("ops.rangesweep", "sort_codes_rangesweep", "method"): _RANGESWEEP,
    ("ops.rangesweep", "sort_codes_rangesweep", "cuts"): _RANGESWEEP,
    ("ops.rangesweep", "sort_codes_rangesweep", "entropy_skip"): _RANGESWEEP,
    ("ops.rangesweep", "sort_pairs_rangesweep", "interpret"): _INTERPRET,
    ("ops.rangesweep", "sort_pairs_rangesweep", "method"): _RANGESWEEP,
    ("ops.rangesweep", "sort_pairs_rangesweep", "cuts"): _RANGESWEEP,
    ("ops.rangesweep", "sort_pairs_rangesweep_planes", "interpret"):
        _INTERPRET,
    ("ops.rangesweep", "sort_pairs_rangesweep_planes", "method"): _RANGESWEEP,
    ("ops.rangesweep", "sort_pairs_rangesweep_planes", "cuts"): _RANGESWEEP,
    ("ops.rangesweep", "argsort_rangesweep", "interpret"): _INTERPRET,
    ("ops.rangesweep", "argsort_rangesweep", "method"): _RANGESWEEP,
    ("ops.rangesweep", "argsort_rangesweep", "cuts"): _RANGESWEEP,
    ("ops.rts", "run_downsweep_chunks", None): _CHUNKS,
    ("ops.rts", "sort_codes_rts", "interpret"): _INTERPRET,
    ("ops.rts", "sort_pairs_rts", "interpret"): _INTERPRET,
    ("ops.splitsweep", "sort_codes_splitsweep", "interpret"): _INTERPRET,
    ("ops.splitsweep", "sort_stable_with_splitsweep", "interpret"):
        _INTERPRET,
    ("ops.splitsweep", "sort_pairs_splitsweep", "interpret"): _INTERPRET,
    ("ops.stitch", "compact_ops", "interpret"): _INTERPRET,
    ("ops.stitch", "compact", "interpret"): _INTERPRET,
    ("ops.stitch", "expand_ops", "interpret"): _INTERPRET,
    ("ops.xla_sort", "sort_all_keys_unstable", "operands"): _UNSTABLE,
    ("ops.xla_sort", "sort_all_keys_unstable", "num_keys"): _UNSTABLE,
    ("ops.xla_sort", "sort_all_keys_unstable", "dimension"): _UNSTABLE,
    ("ops.xla_sort", "map_rows_min", None): _MAP_ROWS,
    ("ops.xla_sort", "map_rows_sort", None): _MAP_ROWS,
    ("parallel.dist_sort", "make_mesh", "axis"): _MESH,
    ("parallel.dist_sort", "distributed_sort", "mesh"): _MESH,
    ("parallel.dist_sort", "distributed_sort", "axis"): _MESH,
    ("parallel.dist_sort", "distributed_sort_gather", "mesh"): _MESH,
    ("parallel.remote_exchange", "remote_exchange", "axis"): _MESH,
    ("parallel.remote_exchange", "remote_exchange", "n_dev"): _RING,
    ("parallel.remote_exchange", "remote_exchange", "interpret"): _INTERPRET,
    ("parallel.remote_exchange", "remote_exchange", "detect_races"): _RING,
    ("utils.autotune", "autotune_routing", "map_candidates"): _MAP_ROWS,
}


def _jax_modules() -> list[str]:
    """Every module of the JAX package, below the package ("" for it)."""
    names = [""]
    for m in pkgutil.walk_packages(gpusorting_tpu.__path__, _JAX + "."):
        names.append(m.name[len(_JAX) + 1:])
    return sorted(names)


def _full(rel: str, pkg: str) -> str:
    rel = _RENAMED.get(rel, rel) if pkg == _PORT else rel
    return pkg + ("." + rel if rel else "")


def _params(obj) -> list[str] | None:
    try:
        return list(inspect.signature(obj).parameters)
    except (TypeError, ValueError):
        return None


def _unwrap(obj):
    return obj.__func__ if isinstance(obj, (staticmethod, classmethod)) \
        else obj


def _public(rel: str):
    """(name, JAX object, port object or None) for each public function,
    class and class method the JAX module `rel` defines; methods as
    "Class.method", properties with no parameters to compare."""
    jmod = importlib.import_module(_full(rel, _JAX))
    tmod = importlib.import_module(_full(rel, _PORT))
    for name, obj in sorted(vars(jmod).items()):
        if name.startswith("_") or not (inspect.isfunction(obj)
                                        or inspect.isclass(obj)):
            continue
        if getattr(obj, "__module__", None) != jmod.__name__:
            continue
        tobj = getattr(tmod, name, None)
        yield name, obj, tobj
        if not inspect.isclass(obj) or tobj is None:
            continue
        for mname, mobj in sorted(vars(obj).items()):
            mobj = _unwrap(mobj)
            if mname.startswith("_") or not (inspect.isfunction(mobj)
                                             or isinstance(mobj, property)):
                continue
            tm = inspect.getattr_static(tobj, mname, None)
            yield f"{name}.{mname}", mobj, None if tm is None else _unwrap(tm)


def _gaps(rel: str) -> set:
    """The (rel, name, parameter or None) where the port falls short."""
    gaps = set()
    for name, jobj, tobj in _public(rel):
        if tobj is None:
            gaps.add((rel, name, None))
            continue
        if isinstance(jobj, property):
            continue
        jp, tp = _params(jobj), _params(tobj)
        if jp is None or tp is None:
            continue
        gaps |= {(rel, name, p) for p in jp if p not in tp}
    return gaps


@pytest.mark.parametrize("rel", _jax_modules())
def test_port_signatures_include_jax(rel):
    importlib.import_module(_full(rel, _PORT))   # the module's twin exists
    unlisted = sorted(_gaps(rel) - set(EXCEPTIONS), key=str)
    assert not unlisted, (
        f"gpusorting_tpu_torch lacks these of {_full(rel, _JAX)} (module, "
        f"name, parameter or None for the whole object): {unlisted}")


def test_every_exception_names_a_real_gap():
    """Each row names a JAX object or parameter that the port lacks, and
    carries a reason; a row whose gap closed must go."""
    modules = {rel for rel, _, _ in EXCEPTIONS}
    assert modules <= set(_jax_modules())
    gaps = set().union(*(_gaps(rel) for rel in modules))
    assert set(EXCEPTIONS) <= gaps, sorted(set(EXCEPTIONS) - gaps, key=str)
    assert all(isinstance(r, str) and r for r in EXCEPTIONS.values())


def test_chain_rules_and_is_native_are_not_exceptions():
    assert not [k for k in EXCEPTIONS
                if "repeats" in k or "is_native" in k]
