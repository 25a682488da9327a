"""How a configuration calls the program, and how its outputs reach the
reference.

A configuration file names its entry ("sort" or "split_sort") and the
arguments the program takes from it (order, backend, strategy); the
traffic file names the mode ("keys", "pairs", "argsort") and the key bits.
These are the public entry points users call, on their default paths
unless the configuration says otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from .inputs import Input
from .reference import HostInput


def make_call(gstt, config: dict, traffic: dict):
    """The timed call: fn(Input) -> {output name: tensor}."""
    entry, mode = config["entry"], traffic["mode"]
    if entry == "sort":
        order = gstt.Order[config["order"].upper()]
        backend = gstt.Backend[config["backend"]]
        if mode == "keys":
            return lambda x: {"keys": gstt.sort(x.keys, order=order,
                                                backend=backend)}
        if mode == "pairs":
            def pairs(x):
                k, v = gstt.sort_pairs(x.keys, x.values, order=order,
                                       backend=backend)
                return {"keys": k, "values": v}
            return pairs
        if mode == "argsort":
            return lambda x: {"perm": gstt.argsort(x.keys, order=order,
                                                   backend=backend)}
    if entry == "split_sort":
        if config["order"] != "ascending":
            raise ValueError("the segmented sort is ascending only")
        strategy = config["strategy"]
        bits = int(traffic.get("key_bits", 32))
        if mode == "keys":
            return lambda x: {"keys": gstt.split_sort_keys(
                x.offsets, x.keys, x.seg_count, bits_to_sort=bits,
                strategy=strategy)}
        if mode == "pairs":
            def seg_pairs(x):
                k, v = gstt.split_sort_pairs(
                    x.offsets, x.keys, x.values, x.seg_count, x.n,
                    bits_to_sort=bits, strategy=strategy)
                return {"keys": k, "values": v}
            return seg_pairs
    raise ValueError(f"no call for entry {entry!r} in mode {mode!r}")


def to_host_bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bit pattern on the host: uint32 or uint64."""
    if t.dtype.itemsize == 8:
        return t.view(torch.int64).cpu().numpy().view(np.uint64)
    return t.view(torch.int32).cpu().numpy().view(np.uint32)


def host_outputs(out: dict) -> dict[str, np.ndarray]:
    return {name: (t.cpu().numpy() if name == "perm" else to_host_bits(t))
            for name, t in out.items()}


def host_input(x: Input, config: dict) -> HostInput:
    return HostInput(key_bits=to_host_bits(x.keys),
                     key_dtype=config["key_dtype"],
                     values=None if x.values is None
                     else to_host_bits(x.values),
                     starts=x.starts)
