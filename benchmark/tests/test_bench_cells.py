"""Whole runs on the CPU at a tiny size, and what a cell added from files
alone finds: the frozen-factor traffic of ``ring2d-301.frozen``
(``refactor_every=2``, no live redraw) on the tiny configuration, with its
own per-layer metric, added by ``conftest.tiny_tree`` as a later change
adds a cell."""

import time

import pytest

import harness
from conftest import TINY_LIMITS


def run(root, cell, seed=2**31 + 12345, seconds=1.0):
    return harness.run(root, cell, seed, seconds, False, "cpu",
                       time.perf_counter())


@pytest.mark.parametrize("cell,metrics", [
    ("tiny.live", {"setup_s", "recon_s", "frame_s_p95"}),
    ("tiny.frozen", {"setup_s", "recon_s"}),
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


def test_a_cell_added_from_files_alone(tiny_tree):
    import spec
    import workload
    cell = spec.load(tiny_tree, "tiny.frozen")
    assert [m["name"] for m in cell.end_to_end] == ["recon_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["stencil_roofline.recon"]
    assert callable(spec.reader(tiny_tree, "stencil_roofline.recon"))
    assert "K3 stencil" in cell.traffic["must_run"]
    # 4 iterations, a factor every second: 2 factorizations, 2 stale
    # iterations of one more solve and one apply forward and adjoint
    assert workload.make(cell, 1, "cpu").counts(1) == {
        "units": 1, "iterations": 4, "factorizations": 2, "solves": 16,
        "applies": 4}


def test_the_window_holds_a_unit_on_a_busy_host():
    """A unit slower than the whole window still completes in it: the
    window ends at its nominal end only once a unit has returned."""
    import workload

    class Slow:
        def unit(self, k):
            u = workload.Unit(k)
            u.t_in = workload.now()
            time.sleep(0.05)
            u.t_done = workload.now()
            return u

    t0, t_end, units = workload.window(Slow(), 0.001)
    assert len(units) == 1 and t_end == units[0].t_done > t0 + 0.001
    t0, t_end, units = workload.window(Slow(), 0.12)
    assert len(units) >= 3 and t_end == pytest.approx(t0 + 0.12)
