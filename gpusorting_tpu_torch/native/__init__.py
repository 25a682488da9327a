"""Host runtime in C++ (ctypes binding, built with g++ at first use).

Port of `gpusorting_tpu/native/`, the equivalent of the reference's C++
host framework (GPUSortBase.h, UtilityKernels.h, Utils.h):

  fill_hybrid_taus(n, seed, and_count)  Thearling-Smith PRNG fill, bit-exact
                                        with core.prng.hybrid_taus_bits
  count_order_violations / count_pair_violations / count_segmented_violations
                                        O(n) validation oracles
  radix_sort / radix_sort_pairs         stable host LSD radix sort (the
                                        CUB-oracle analog)

The source (`src/gpusorting_native.cpp`) is compiled with g++ on first use
into `_build/` beside the package, named by a hash of the source and the
flags (with OpenMP, or without it where the compiler refuses it), and
loaded once per process under a lock.  There is no fallback: where the
library cannot be built `available()` is False and every function raises,
so no numpy stand-in can pass for it.

The functions take numpy arrays of 4-byte elements (their bits read as
u32) or CPU tensors, and give back the kind they were given: numpy uint32
arrays, or torch.uint32 tensors.  A tensor on another device raises: this
is host code, and nothing is copied off the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np
import torch

SOURCE = pathlib.Path(__file__).resolve().parent / "src" / \
    "gpusorting_native.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
OPENMP = "-fopenmp"

_LOCK = threading.Lock()
_u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")


def _target(flags: tuple) -> pathlib.Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"gpusorting_native_{h.hexdigest()[:16]}.so"


def _compile(flags: tuple) -> str | None:
    """Build the library with `flags` unless it exists; None on success,
    else the compiler's complaint."""
    so = _target(flags)
    if so.exists():
        return None
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *flags, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        return f"g++ did not run: {e}"
    if proc.returncode != 0:
        return proc.stderr[-2000:] or f"g++ exited {proc.returncode}"
    os.replace(tmp, so)
    return None


@functools.cache
def _built():
    """(library, None), or (None, why it could not be built)."""
    why = []
    for flags in (FLAGS + (OPENMP,), FLAGS):     # retry without OpenMP
        err = _compile(flags)
        if err is None:
            break
        why.append(err)
    else:
        return None, "\n".join(why)
    try:
        lib = ctypes.CDLL(str(_target(flags)))
    except OSError as e:
        return None, str(e)
    lib.hybrid_taus_fill.argtypes = [
        _u32p, ctypes.c_int64, ctypes.c_uint32, ctypes.c_int, ctypes.c_int]
    lib.hybrid_taus_fill.restype = None
    lib.count_order_violations_u32.argtypes = [
        _u32p, ctypes.c_int64, ctypes.c_int]
    lib.count_order_violations_u32.restype = ctypes.c_int64
    lib.count_pair_violations_u32.argtypes = [
        _u32p, _u32p, ctypes.c_int64, ctypes.c_int]
    lib.count_pair_violations_u32.restype = ctypes.c_int64
    lib.count_segmented_violations_u32.argtypes = [
        _u32p, _u32p, ctypes.c_int64, ctypes.c_int64]
    lib.count_segmented_violations_u32.restype = ctypes.c_int64
    lib.lsd_radix_sort_u32.argtypes = [_u32p, ctypes.c_int64]
    lib.lsd_radix_sort_u32.restype = None
    lib.lsd_radix_sort_pairs_u32.argtypes = [_u32p, _u32p, ctypes.c_int64]
    lib.lsd_radix_sort_pairs_u32.restype = None
    return lib, None


def _library() -> ctypes.CDLL:
    with _LOCK:
        lib, why = _built()
    if lib is None:
        raise RuntimeError(f"the native library could not be built:\n{why}")
    return lib


def available() -> bool:
    """True when the library is built and loaded (building it if need be)."""
    with _LOCK:
        return _built()[0] is not None


def _host_u32(op: str, name: str, x) -> tuple[np.ndarray, bool]:
    """(a C-contiguous uint32 numpy view or copy of x's bits, whether x was
    a tensor); raises for a tensor off the CPU or a width other than 4."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"{op}: {name} is on {x.device}; the native "
                             f"library runs on the host and copies nothing "
                             f"off the device")
        if x.element_size() != 4:
            raise TypeError(f"{op}: {name} must have 4-byte elements, got "
                            f"{x.dtype}")
        arr = x.contiguous().view(torch.int32).numpy().view(np.uint32)
        return arr, True
    arr = np.asarray(x)
    if arr.dtype.itemsize != 4:
        raise TypeError(f"{op}: {name} must have 4-byte elements, got "
                        f"{arr.dtype}")
    return np.ascontiguousarray(arr.view(np.uint32)), False


def _give_back(arr: np.ndarray, as_tensor: bool):
    if not as_tensor:
        return arr
    return torch.from_numpy(arr.view(np.int32)).view(torch.uint32)


def fill_hybrid_taus(n: int, seed: int, and_count: int = 0,
                     warmup: int = 2) -> np.ndarray:
    """Native PRNG fill (numpy uint32); bit-exact with
    core.prng.hybrid_taus_bits."""
    lib = _library()
    out = np.empty(n, dtype=np.uint32)
    lib.hybrid_taus_fill(out, n, np.uint32(seed), and_count, warmup)
    return out


def count_order_violations(keys, descending: bool = False) -> int:
    """Adjacent pairs out of order, over the keys' u32 bits."""
    lib = _library()
    k, _ = _host_u32("count_order_violations", "keys", keys)
    return int(lib.count_order_violations_u32(k, k.shape[0],
                                              int(descending)))


def count_pair_violations(keys, payload, descending: bool = False) -> int:
    """Adjacent-pair order check over keys AND payload bit patterns.

    Valid only for the reference's payload == key test fixture (the payload
    is initialized equal to the key, so a payload inversion is a stability
    or permutation error, Shaders/Utility.hlsl:147-231).  On real (key,
    payload) data with unrelated payloads it reports false violations; use
    the oracle-identity check instead."""
    lib = _library()
    k, _ = _host_u32("count_pair_violations", "keys", keys)
    p, _ = _host_u32("count_pair_violations", "payload", payload)
    if p.shape != k.shape:
        raise ValueError(f"count_pair_violations: payload shape {p.shape} "
                         f"!= keys shape {k.shape}")
    return int(lib.count_pair_violations_u32(k, p, k.shape[0],
                                             int(descending)))


def count_segmented_violations(keys, offsets) -> int:
    """Adjacent pairs out of order inside each segment; `offsets` are the
    segments' exclusive-prefix starts, the last segment ends at len(keys)."""
    lib = _library()
    k, _ = _host_u32("count_segmented_violations", "keys", keys)
    if isinstance(offsets, torch.Tensor):
        if offsets.device.type != "cpu":
            raise ValueError(f"count_segmented_violations: offsets are on "
                             f"{offsets.device}; the native library runs on "
                             f"the host and copies nothing off the device")
        offsets = offsets.to(torch.int64).numpy()
    offs = np.ascontiguousarray(np.asarray(offsets).astype(np.uint32))
    return int(lib.count_segmented_violations_u32(k, offs, offs.shape[0],
                                                  k.shape[0]))


def radix_sort(keys):
    """Stable host LSD radix sort of u32 codes (reference oracle)."""
    lib = _library()
    k, as_tensor = _host_u32("radix_sort", "keys", keys)
    out = k.copy()
    lib.lsd_radix_sort_u32(out, out.shape[0])
    return _give_back(out, as_tensor)


def radix_sort_pairs(keys, payload):
    """Stable host LSD radix pair sort (CUB SortPairs analog)."""
    lib = _library()
    k, as_tensor = _host_u32("radix_sort_pairs", "keys", keys)
    v, _ = _host_u32("radix_sort_pairs", "payload", payload)
    if v.shape != k.shape:
        raise ValueError(f"radix_sort_pairs: payload shape {v.shape} != "
                         f"keys shape {k.shape}")
    k, v = k.copy(), v.copy()
    lib.lsd_radix_sort_pairs_u32(k, v, k.shape[0])
    return _give_back(k, as_tensor), _give_back(v, as_tensor)
