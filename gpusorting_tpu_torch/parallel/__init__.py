"""Distributed sort over a torch.distributed process group.

Port of `gpusorting_tpu/parallel/`: `dist_sort.py` (sampled splitters, cell
counts, the cap ladder, the chunked exchange and the merge) and
`remote_exchange.py` (the exchange's transports and its receive-side
masking kernel, `csrc/exchange_mask.cu`).
"""

from .dist_sort import distributed_sort, distributed_sort_gather, make_mesh

__all__ = ["distributed_sort", "distributed_sort_gather", "make_mesh"]
