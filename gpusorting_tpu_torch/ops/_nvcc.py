"""Build and load the port's hand-written CUDA kernels.

Every kernel source in `csrc/` has a plain C interface.  `build` compiles
one with `nvcc` for sm_90a into a shared library under `_build/` beside
the package, named by a hash of the source, the shared headers
(`csrc/*.cuh`) and the flags, so an unchanged
source is compiled once; `build_all` starts one `nvcc` per source at once.
`load` returns the library as a `ctypes.CDLL` with every `gst_*` entry
declared: `signatures` reads each entry's `extern "C"` prototype from the
source itself, so the prototype is the one declaration of the interface.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

import torch

from ..utils.trace import span

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in ((os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME
                  else None), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(source: pathlib.Path) -> pathlib.Path:
    h = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):   # what a source may include
        h.update(header.read_bytes())
    return BUILD_DIR / f"{source.stem}_{h.hexdigest()[:16]}.so"


def _compile(source: pathlib.Path) -> float:
    """Compile `source` unless its library exists; the seconds it took."""
    so = _target(source)
    if so.exists():
        return 0.0
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    with span("build." + source.stem):
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name}:\n{proc.stderr}")
    os.replace(tmp, so)
    return time.perf_counter() - t0


def build(source: pathlib.Path) -> pathlib.Path:
    """Compile `source` (once per source hash); return the .so."""
    _compile(source)
    return _target(source)


def build_all(sources) -> dict:
    """Compile every source at once, one `nvcc` each; returns
    {source: seconds its build took} (0.0 where the library existed)."""
    sources = list(sources)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        futures = {s: pool.submit(_compile, s) for s in sources}
        return {s: f.result() for s, f in futures.items()}


# The C parameter types of the entries' prototypes, as ctypes types.
_CTYPES = {
    "const void*": ctypes.c_void_p,
    "void*": ctypes.c_void_p,
    "long long": ctypes.c_longlong,
    "long long*": ctypes.POINTER(ctypes.c_longlong),
    "int": ctypes.c_int,
    "int*": ctypes.POINTER(ctypes.c_int),
    "unsigned": ctypes.c_uint,
}
_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_PROTOTYPE = re.compile(r'extern\s+"C"\s+([\w\s*]+?)\s*\b(gst_\w+)\s*'
                        r"\(([^)]*)\)")


def _ctype(source: pathlib.Path, name: str, param: str):
    """The ctypes type of one parameter of `name`, named or not."""
    words = param.replace("*", " * ").split()
    for ctype in (words, words[:-1]):
        key = " ".join(ctype).replace(" *", "*")
        if key in _CTYPES:
            return _CTYPES[key]
    raise ValueError(f"{source.name}: {name} has a parameter "
                     f"{param.strip()!r} of a type with no ctypes map")


def signatures(source: pathlib.Path) -> dict:
    """{name: [ctypes types of its parameters]} of every `extern "C"`
    `gst_*` entry of `source`, read from its prototype; raises ValueError
    for a return type other than int or a parameter type with no map."""
    text = _COMMENT.sub(" ", source.read_text())
    sigs = {}
    for ret, name, params in _PROTOTYPE.findall(text):
        if " ".join(ret.split()) != "int":
            raise ValueError(f"{source.name}: {name} returns "
                             f"{' '.join(ret.split())!r}, not int")
        params = params.strip()
        sigs[name] = [] if params in ("", "void") else [
            _ctype(source, name, p) for p in params.split(",")]
    return sigs


def declare(lib, source: pathlib.Path):
    """Set `argtypes` and an int `restype` on each `gst_*` entry of
    `source` in `lib` (the library built from it); returns `lib`."""
    for name, argtypes in signatures(source).items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def load(source: pathlib.Path) -> ctypes.CDLL:
    """The built library of `source`, its entries declared, loaded once per
    process."""
    return declare(ctypes.CDLL(str(build(source))), source)


def check(op: str, name: str, t: torch.Tensor, shape: tuple,
          device: torch.device, ref: str = "input",
          dtype: torch.dtype = torch.int32, align: int = 16) -> None:
    """Raise unless `t` is a contiguous, `align`-byte aligned tensor of
    `dtype` (int32 by default) and `shape` on `device` (where the tensor
    named `ref` lies)."""
    if t.dtype != dtype:
        raise TypeError(f"{op}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{op}: {name} shape {tuple(t.shape)} != {shape}")
    if t.device != device:
        raise ValueError(f"{op}: {name} on {t.device}, {ref} on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{op}: {name} must be {align}-byte aligned")


def launch(op: str, fn, *args, device: torch.device,
           stream: int | None = None) -> None:
    """Call the C entry point `fn(*args, stream)` on `stream` (a CUDA
    stream handle; by default the current stream of `device`); raise if it
    reports a CUDA error.  The device is made current for the call only
    where it is not already."""
    if stream is None:
        stream = torch.cuda.current_stream(device).cuda_stream
    if device.index is None or device.index == torch.cuda.current_device():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{op} kernel launch failed: CUDA error {rc}")
