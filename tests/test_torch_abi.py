"""The C interface of the port's CUDA kernels, checked on the CPU.

Every `extern "C" int gst_*` entry of `csrc/*.cu` is declared once, by its
prototype; `ops/_nvcc.signatures` reads the ctypes types from there, and
`_nvcc.load` sets them on the built library.  No CPU test loads a library
(a CPU tensor takes the plain version), so these tests hold the parse
itself: every source parses, every entry the Python code calls exists,
and the derived types of the entries the wrappers call equal the types
their calls are written for (`PINNED`, literal data).  A changed
prototype shows here first, as a failing case to update with its
callers.  The kernels themselves are tested on the card by
tests/test_torch_cuda.py.
"""

import ctypes
import pathlib
import re

import pytest
import torch

from gpusorting_tpu_torch.ops import _nvcc

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCES = sorted(_nvcc.CSRC.glob("*.cu"))

# One letter a C parameter type: void* or const void*, long long, int,
# unsigned.
_LETTER = {"p": ctypes.c_void_p, "q": ctypes.c_longlong, "i": ctypes.c_int,
           "u": ctypes.c_uint}

# The argtypes each wrapper's calls are written for, entry by entry.
PINNED = {
    "gst_binning": "ppppppppppquiqip",
    "gst_binning_partition": "",
    "gst_compact": "pppppppppqppquip",
    "gst_downsweep": "pppppppiiqip",
    "gst_downsweep_rows": "pppppppppiiiip",
    "gst_edge_fixup": "ppppppiiip",
    "gst_exclusive_scan": "ppqpqup",
    "gst_expand": "ppppqqqqpppppqpquip",
    "gst_global_hist": "pqipp",
    "gst_global_stage": "ppppiiqqqp",
    "gst_hyper_stage": "ppppiiqqqqip",
    "gst_local_stages": "pppppppppipiiiiip",
    "gst_mask_arrivals": "ppppqqqqiiiiipiiqqp",
    "gst_merge_runs": "pppqqqqqqpppiiiipiqqqpp",
    "gst_merge_tile": "",
    "gst_radix256_counts_words": "",
    "gst_radix256_pairs_partition": "",
    "gst_radix256_partition": "",
    "gst_radix256_sort": "pppppquuuuiqp",
    "gst_radix256_sort_pairs": "ppppppppquuuuiqp",
    "gst_relocate_rows": "ppppiiip",
    "gst_segtile_sort": "pppqqppppiiiip",
    "gst_tile_hist4": "ppiqip",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as the other port files pin it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _all_signatures() -> dict:
    """{name: (source, argtypes)} over every source."""
    return {name: (src, types) for src in SOURCES
            for name, types in _nvcc.signatures(src).items()}


@pytest.mark.parametrize("source", SOURCES, ids=lambda s: s.name)
def test_signatures_parse_each_source(source):
    """Each source declares at least one entry, and every parameter of each
    maps to a ctypes type."""
    sigs = _nvcc.signatures(source)
    assert sigs, f"{source.name} declares no gst_* entry"
    known = set(_nvcc._CTYPES.values())
    for name, types in sigs.items():
        assert name.startswith("gst_")
        assert all(t in known for t in types), name
    # every entry the text names after extern "C" was read
    named = set(re.findall(r'extern\s+"C"\s+int\s+(gst_\w+)\s*\(',
                           source.read_text()))
    assert named == set(sigs)


def test_entry_names_unique_across_sources():
    names = [n for src in SOURCES for n in _nvcc.signatures(src)]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("entry", sorted(PINNED))
def test_signature_matches_the_hand_typed_one(entry):
    """The prototype's types equal those the wrapper declared by hand."""
    sigs = _all_signatures()
    assert entry in sigs, f"{entry} is in no csrc/*.cu"
    assert sigs[entry][1] == [_LETTER[c] for c in PINNED[entry]]


def test_every_entry_called_exists():
    """Every `.gst_*` attribute the port's Python code reads (the package,
    the card tests, chip_smoke.py) is an entry of some csrc/*.cu."""
    files = sorted((ROOT / "gpusorting_tpu_torch").rglob("*.py")) + [
        ROOT / "tests" / "test_torch_cuda.py", ROOT / "chip_smoke.py"]
    used = {m for f in files
            for m in re.findall(r"\.(gst_\w+)", f.read_text())}
    assert used >= set(PINNED)
    assert used - set(_all_signatures()) == set()


@pytest.mark.parametrize("prototype, words", [
    ('extern "C" int gst_bad(const void* in, size_t n, void* stream);',
     ["gst_bad", "size_t n"]),
    ('extern "C" int gst_bad(unsigned long long seed, void* stream);',
     ["gst_bad", "unsigned long long seed"]),
    ('extern "C" void gst_bad(void* stream);', ["gst_bad", "void"]),
])
def test_unmapped_prototype_refused(tmp_path, prototype, words):
    """A parameter type with no map, or a return type other than int, is
    refused with the source, the entry and the culprit named."""
    src = tmp_path / "bad.cu"
    src.write_text('// extern "C" int gst_ok(size_t n);  (a comment)\n'
                   'extern "C" int gst_fine(int x) { return x; }\n'
                   + prototype + "\n")
    with pytest.raises(ValueError) as err:
        _nvcc.signatures(src)
    for word in ["bad.cu"] + words:
        assert word in str(err.value)


def test_declare_sets_every_entry(tmp_path):
    """`declare` sets argtypes and an int restype on each entry of a stand-in
    library, unnamed and pointer parameters included, and returns it."""
    src = tmp_path / "stand_in.cu"
    src.write_text('/* extern "C" int gst_gone(size_t n); */\n'
                   'extern "C" int gst_none() { return 4; }\n'
                   'extern "C" int\ngst_mixed(const void *a, long long,\n'
                   '          int* blocks, long long* smem, unsigned e,\n'
                   '          void* stream) { return 0; }\n')

    class Entry:
        pass

    class Library:
        def __init__(self):
            self.gst_none, self.gst_mixed = Entry(), Entry()

    lib = Library()
    assert _nvcc.declare(lib, src) is lib
    assert lib.gst_none.argtypes == []
    assert lib.gst_mixed.argtypes == [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_uint, ctypes.c_void_p]
    assert lib.gst_none.restype is ctypes.c_int
    assert lib.gst_mixed.restype is ctypes.c_int
