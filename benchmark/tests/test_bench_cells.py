"""Whole runs on the CPU at a tiny size, and a cell added from new files
alone: the frozen-factor traffic (``refactor_every=2``, no live redraw)
with its own per-layer metric, as a later change would add it."""

import json
import shutil
import time

import pytest

import harness
from conftest import TINY_LIMITS, add_cell, write_json

STENCIL_READER = '''"""K3's share of its roofline: the least time of the applies the
configuration asks for over K3's device time."""

from costs import apply_cost, least_seconds


def read(r):
    t, n = r.layer("K3 stencil"), r.counts["applies"]
    if t <= 0 or n == 0:
        return None
    return 100.0 * n * least_seconds(apply_cost(r.ny, r.nx, r.batch)) / t
'''


def run(root, cell, seed=2**31 + 12345, seconds=1.0):
    return harness.run(root, cell, seed, seconds, False, "cpu",
                       time.perf_counter())


@pytest.mark.parametrize("cell,metrics", [
    ("tiny.live", {"setup_s", "recon_s", "frame_s_p95"}),
    ("tinysim.shots", {"setup_s", "synth_s"})])
def test_a_run_is_correct_and_reports_its_metrics(tiny_tree, cell, metrics):
    result, lines = run(tiny_tree, cell)
    assert result["correct"], lines
    assert set(result["metrics"]) == metrics
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == set(TINY_LIMITS[cell])
    assert lines[-len(result["checks"]):] == [
        f"check {k}: {c['value']!r} (limit {c['limit']!r})"
        for k, c in result["checks"].items()]


def test_the_same_seed_makes_the_same_inputs(tiny_tree):
    import numpy as np
    import spec
    import workload
    cell = spec.load(tiny_tree, "tiny.live")
    a, b = (workload.make(cell, 2**31 + 7, "cpu") for _ in range(2))
    assert np.array_equal(a.inputs(3), b.inputs(3))
    assert not np.array_equal(a.inputs(3), a.inputs(4))


def test_a_cell_added_from_files_alone(tiny_tree, tmp_path):
    root = tmp_path / "tree"
    shutil.copytree(tiny_tree, root)
    live = json.loads((root / "benchmark/traffic/tinylive.json").read_text())
    frozen = dict(live, refactor_every=2, live_every=None, iterations=4,
                  end_to_end={"recon_s": "unit_s"})
    write_json(root / "benchmark/traffic/frozen.json", frozen)
    (root / "benchmark/metrics/stencil_roofline.recon.py").write_text(STENCIL_READER)
    add_cell(root, "tiny.frozen", "tiny", "frozen", TINY_LIMITS["tiny.live"])
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "stencil_roofline.recon", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "K3 stencil", "moves": "recon_s",
        "workloads": ["tiny.frozen"]})
    write_json(root / "BENCHMARK.json", bench)

    result, lines = run(root, "tiny.frozen")
    assert result["correct"], lines
    assert set(result["metrics"]) == {"setup_s", "recon_s"}
    import spec
    cell = spec.load(root, "tiny.frozen")
    assert [m["name"] for m in cell.per_layer] == ["stencil_roofline.recon"]
    assert cell.per_layer and callable(spec.reader(root, "stencil_roofline.recon"))
