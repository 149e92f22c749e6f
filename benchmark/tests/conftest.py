"""CPU tests of the benchmark harness (``python -m pytest benchmark/tests``).

They import the harness's modules from ``benchmark/`` and the port from
the repository root, and drive whole runs on the CPU through a tiny
configuration written into a temporary copy of ``benchmark/``. Tests
marked ``cuda`` need the card and skip here.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# A ring a CPU inverts in a fraction of a second: 16 elements on a 41 x 41
# grid, a wavelength of 10 cells; data made on a 61 x 61 grid.
TINY = {
    "name": "tiny", "source": "test", "grid": {"xmax": 0.03, "dx": 0.0015},
    "frequency": 100000.0,
    "ring": {"num_elements": 16, "radius": 0.024, "num_excluded_each_side": 3},
    "pml": {"a0": 10.0, "l_pml": 0.004, "sign_convention": -1},
    "stencil": {"angular_resolution": 100, "range_resolution": 10,
                "fix_b": True, "corner_mode": "matlab"},
    "solver": {"factorization": "auto", "factor_precision": "highest"},
    "fwi": {"c_init": 1480.0, "momentum": "hestenes_stiefel",
            "step_size": "residual", "estimate_source_strength": True,
            "reject_nonfinite": True, "eps_stabilizer": 0.0},
    "data": {"file": "benchmark/data/tiny.npz",
             "synthesized_on": {"xmax": 0.03, "dx": 0.001},
             "phantom_seeds": [0, 1]},
    "reduced": []}
# limits of the tiny cells, above what the program reads on the CPU
# (vel_gap <= 0.15 m/s, loss_gap <= 1e-5, rec_gap <= 1e-6)
TINY_LIMITS = {"tiny.live": {"vel_gap": 0.5, "loss_gap": 1e-4},
               "tinysim.shots": {"rec_gap": 1e-5}}


def write_json(path: Path, obj) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=1))


def add_cell(root: Path, cell: str, config: str, traffic: str,
             limits: dict, samples: int = 1) -> None:
    """Add a cell the way a later change would: its files and an entry in
    BENCHMARK.json (its end-to-end metrics listed for it)."""
    write_json(root / "benchmark" / "cells" / f"{cell}.json",
               {"samples": samples, "limits": limits})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": cell, "config": config,
                               "traffic": traffic, "chips": 1, "why": "test"})
    tr = json.loads((root / "benchmark" / "traffic" / f"{traffic}.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in tr["end_to_end"]:
            m["workloads"].append(cell)
    write_json(root / "BENCHMARK.json", bench)


@pytest.fixture(scope="session")
def tiny_tree(tmp_path_factory) -> Path:
    """A copy of ``benchmark/`` and ``BENCHMARK.json`` with two tiny cells,
    ``tiny.live`` and ``tinysim.shots``, and the tiny stored data made by
    ``make_data.py`` on the CPU."""
    import make_data

    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    write_json(root / "benchmark" / "configs" / "tiny.json", TINY)
    sim = {k: v for k, v in TINY.items() if k not in ("data", "fwi")}
    write_json(root / "benchmark" / "configs" / "tinysim.json", dict(sim, name="tinysim"))
    live = json.loads((BENCH / "traffic" / "live.json").read_text())
    write_json(root / "benchmark" / "traffic" / "tinylive.json",
               dict(live, iterations=3))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name in ("tiny", "tinysim"):
        bench["configs"].append({"name": name, "source": "test", "reduced": [],
                                 "file": f"benchmark/configs/{name}.json",
                                 "why": "test"})
    write_json(root / "BENCHMARK.json", bench)
    add_cell(root, "tiny.live", "tiny", "tinylive", TINY_LIMITS["tiny.live"], 2)
    add_cell(root, "tinysim.shots", "tinysim", "shots",
             TINY_LIMITS["tinysim.shots"])
    make_data.main(["--config", "tiny", "--device", "cpu", "--root", str(root)])
    return root


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skipped where torch.cuda is "
                   "unavailable")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the chip)")
    return torch.device("cuda", 0)
