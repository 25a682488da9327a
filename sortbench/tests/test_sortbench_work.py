"""Each configuration's work count: the bytes one call reads and writes
once, whatever implements the call."""

import pytest

from sortbench import spec


@pytest.mark.parametrize("config,mode,n,segs,want", [
    ("gpusort_u32", "keys", 1 << 28, 0, 8 << 28),
    ("gpusort_u32", "keys", 1 << 20, 0, 8 << 20),
    ("gpusort_u32", "pairs", 1 << 26, 0, 16 << 26),
    ("gpusort_u32", "argsort", 1000, 0, 8000),
    ("splitsort_u32_pairs", "pairs", 1 << 26, 32768, (16 << 26) + 4 * 32768),
    ("splitsort_u32_pairs", "pairs", 1 << 26, 4066851,
     (16 << 26) + 4 * 4066851),
    ("splitsort_u32_pairs", "keys", 100, 7, 828),
])
def test_bytes_per_call(config, mode, n, segs, want):
    work = spec.work_module({"name": config})
    assert work.bytes_per_call(mode, n, segs) == want
