"""Every file the benchmark finds by name loads and fits BENCHMARK.json."""

import json
import re

import numpy as np
import pytest

import spec
from conftest import BENCH, ROOT

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


def test_top_level_keys():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["benchmark"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    names = [m["name"] for m in BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]]
    names += CELLS + [c["name"] for c in BENCHMARK["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_load(cell):
    c = spec.load(ROOT, cell)
    assert c.traffic["entry"] in ("invert_dataset", "synthesize_ring_dataset")
    assert c.check["samples"] >= 1 and c.check["limits"]
    assert all(v > 0 for v in c.check["limits"].values())
    reported = {m["name"] for m in c.end_to_end} - {"setup_s"}
    assert reported and reported <= set(c.traffic["end_to_end"])
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert callable(spec.reader(ROOT, m["name"]))
    layers = {k["layer"] for k in c.kernels.values()}
    assert set(c.traffic["must_run"]) <= layers


@pytest.mark.parametrize("config", BENCHMARK["configs"], ids=lambda c: c["name"])
def test_config_files_load(config):
    cfg = json.loads((ROOT / config["file"]).read_text())
    assert cfg["name"] == config["name"] and cfg["reduced"] == config["reduced"]
    for key in ("grid", "frequency", "ring", "pml", "stencil", "solver"):
        assert key in cfg
    if "data" in cfg:
        with np.load(ROOT / cfg["data"]["file"]) as z:
            rec = z["rec"]
        n = cfg["ring"]["num_elements"]
        assert rec.shape == (len(cfg["data"]["phantom_seeds"]), n, n)
        assert rec.dtype == np.complex64 and np.all(np.isfinite(rec))


def test_metrics_and_kernels_are_files():
    for m in BENCHMARK["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in {e["name"] for e in BENCHMARK["end_to_end"]}
        for cell in m["workloads"]:
            e2e = spec.load(ROOT, cell).end_to_end
            assert m["moves"] in {e["name"] for e in e2e}
    for p in (BENCH / "kernels").glob("*.json"):
        k = json.loads(p.read_text())
        assert set(k) == {"kernel", "layer", "counter"} and p.stem == k["kernel"]
    for p in (BENCH / "traffic").glob("*.json"):
        assert "entry" in json.loads(p.read_text())
