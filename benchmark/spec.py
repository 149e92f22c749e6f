"""A cell as the benchmark's files describe it.

``BENCHMARK.json`` names the cell, its configuration and its traffic mix;
each of these, the cell's correctness limits, every per-layer metric's
reader and every kernel's layer is a file of its own under ``benchmark/``,
found by name:

    configs/<config>.json     the deployment: grid, ring, frequency, PML,
                              stencil, precision, inversion settings, data
    traffic/<traffic>.json    the entry it drives and how (loop, iterations,
                              refactoring, live redraw, warm-up, trace units)
    cells/<cell>.json         samples checked and the limit of each number
    entries/<entry>.py        ``Loop``: the closed loop through one entry of
                              the program (inputs, timed call, counts,
                              quantities, shapes, comparison)
    references/<entry>.py     the entry's plain reference; a configuration's
                              ``data.maker`` names one that writes its data
    metrics/<metric>.py       ``read(readings)`` -> value or None
    kernels/<kernel>.json     {"kernel", "layer", "counter"}
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class Cell:
    name: str
    root: Path
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list = field(default_factory=list)   # metric entries
    per_layer: list = field(default_factory=list)    # metric entries
    kernels: dict = field(default_factory=dict)      # kernel -> mapping

    def path(self, rel: str) -> Path:
        return self.root / rel


def _load(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _for_cell(metrics: list, cell: str) -> list:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def load(root: Path, name: str) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    root = Path(root)
    bench = _load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(known: {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    here = root / "benchmark"
    kernels = {}
    for p in sorted((here / "kernels").glob("*.json")):
        k = _load(p)
        kernels[k["kernel"]] = k
    return Cell(name=name, root=root, chips=int(w["chips"]),
                config=_load(root / configs[w["config"]]["file"]),
                traffic=_load(here / "traffic" / f"{w['traffic']}.json"),
                check=_load(here / "cells" / f"{name}.json"),
                end_to_end=_for_cell(bench["end_to_end"], name),
                per_layer=_for_cell(bench["per_layer"], name),
                kernels=kernels)


def module(root: Path, kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` of the tree at ``root``, loaded from
    its file (a tree's own copy, never one imported from elsewhere)."""
    path = Path(root) / "benchmark" / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} file {path}")
    modname = f"{kind}_" + name.replace(".", "_").replace("-", "_")
    sp = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def reader(root: Path, metric: str):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    return module(root, "metrics", metric).read
