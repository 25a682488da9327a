"""Segmented sort (SplitSort analog).

Port of `gpusorting_tpu/segsort/`.  The public surface mirrors the
reference free-function API (SplitSort.cuh:674-934) plus the object form;
also re-exported at the package top level.
"""

from .splitsort import (
    SegSortPlan,
    SplitSorter,
    make_segsort_fn,
    make_segsort_plan,
    next_fit_bin_packing,
    segment_length_histogram,
    split_sort_allocate_temp_memory,
    split_sort_free_temp_memory,
    split_sort_keys,
    split_sort_pairs,
    split_sort_pairs_wide,
)

__all__ = [
    "SegSortPlan",
    "SplitSorter",
    "make_segsort_fn",
    "make_segsort_plan",
    "next_fit_bin_packing",
    "segment_length_histogram",
    "split_sort_allocate_temp_memory",
    "split_sort_free_temp_memory",
    "split_sort_keys",
    "split_sort_pairs",
    "split_sort_pairs_wide",
]
