"""A cell, found by its name in BENCHMARK.json.

Everything that belongs to one configuration, traffic mix or metric sits in
files of its own, found by the name BENCHMARK.json gives it:

  configs/<config>.json   the configuration: entry, dtypes, guarantees
  traffic/<traffic>.json  the traffic mix: mode, layout, sizes, pool
  work/<config>.py        bytes_per_call(mode, n, seg_count): the bytes
                          one call must read once and write once
  metrics/<metric>.py     read(window) -> a number, or None where the
                          trace holds nothing to read

so a new cell, configuration or metric is new files and new entries in
BENCHMARK.json, and no edit to a file that is there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]   # the cell's end-to-end metrics
    per_layer: list[dict]    # the cell's per-layer metrics


def load_module(path: pathlib.Path):
    spec = importlib.util.spec_from_file_location(
        f"sortbench_{path.parent.name}_{path.stem}".replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {', '.join(cells)})")
    w = cells[name]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=json.loads((HERE / "configs" / f"{w['config']}.json")
                          .read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def work_module(config: dict):
    return load_module(HERE / "work" / f"{config['name']}.py")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py")
