"""A cell with an entry of its own, added from new files alone in a copy
of the tree, as a later change adds a deployment: the entry's loop
(``entries/``), its plain reference and the maker of its stored data
(``references/``), a traffic file, a configuration, a cell file, a kernel
file whose counter is named ``<module>:<attribute>``, and a per-layer
metric that reads a span of the program and a counter. No file the tree
already had changes."""

import hashlib
import json
import shutil
import time

import pytest

import devtrace
import harness
import make_data
import program
from conftest import TINY, write_json
from devtrace import Interval
from waveforminversionust_tpu_torch.ops import kernel_stencil

ENTRY = '''"""Toy: stored phantoms synthesized back to back, each inside a span."""

import numpy as np
from torch.profiler import record_function

import program
import reference
import workload
from workload import Unit, now, unit_rng


class Loop:
    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, device
        with np.load(cell.path(cell.config["data"]["file"])) as z:
            self.vel = z["vel"]
        self.run = program.Synthesis(cell.config, cell.traffic, device)
        self.reference = workload.reference(cell)

    def inputs(self, k):
        return (self.vel[(k + self.seed) % len(self.vel)],
                int(unit_rng(self.seed, k).integers(1 << 63)))

    def unit(self, k):
        u = Unit(k)
        vel, amp_seed = self.inputs(k)
        u.t_in = now()
        with record_function("toy.synth"):
            u.output = self.run(vel, amp_seed)
        u.t_done = now()
        return u

    def counts(self, units):
        return {"units": units}

    def quantities(self, units, t0, t_end):
        done = [u for u in units if u.t_done <= t_end]
        return {"unit_s": (max(u.t_done for u in done) - t0) / len(done)}

    def shapes(self):
        ny, nx = reference.grid_of(self.cell.config["grid"]).shape
        return {"ny": ny, "nx": nx}

    def check(self, u):
        want = self.reference.expected(*self.inputs(u.k), self.cell.config,
                                       self.device)
        gap = (np.linalg.norm(u.output - want, axis=1)
               / np.linalg.norm(want, axis=1))
        return {"rec_gap": float(gap.max())}
'''

REFERENCE = '''"""Toy: the maker of the stored phantoms and the plain reference."""

import numpy as np

import reference
from phantom import breast_phantom


def make(config, device):
    grid = reference.grid_of(config["grid"])
    return {"vel": np.stack([breast_phantom(grid, int(s))
                             for s in config["data"]["phantom_seeds"]])}


def expected(vel, amp_seed, config, device, precision="fp32"):
    rng = np.random.default_rng(amp_seed)
    n = int(config["ring"]["num_elements"])
    amps = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    return reference.synthesize(vel, config, amps, device, precision)
'''

METRIC = '''"""Toy: device milliseconds inside the span a launch counted."""

COUNTER = "ops.kernel_stencil:launches"


def read(r):
    t, n = r.span("toy.synth"), r.launched.get(COUNTER, 0)
    if t <= 0 or n == 0:
        return None
    return 1e3 * t / n
'''

CELL = "toy.synth"


def digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def toy_tree(tiny_tree, tmp_path_factory):
    root = tmp_path_factory.mktemp("toy") / "tree"
    shutil.copytree(tiny_tree, root)
    before = digests(root)
    b = root / "benchmark"
    (b / "entries" / "toy_synth.py").write_text(ENTRY)
    (b / "references" / "toy_synth.py").write_text(REFERENCE)
    (b / "metrics" / "toy_ms.py").write_text(METRIC)
    write_json(b / "kernels" / "toy_kernel.json",
               {"kernel": "toy_kernel", "layer": "toy layer",
                "counter": "ops.kernel_stencil:launches"})
    write_json(b / "traffic" / "toy.json",
               {"entry": "toy_synth", "warmup_units": 1, "trace_units": 2,
                "must_run": ["toy layer"], "end_to_end": {"toy_s": "unit_s"}})
    cfg = {k: v for k, v in TINY.items() if k != "fwi"}
    write_json(b / "configs" / "toy.json", dict(cfg, name="toy", data={
        "file": "benchmark/data/toy.npz", "maker": "toy_synth",
        "phantom_seeds": [3, 4, 5]}))
    write_json(b / "cells" / f"{CELL}.json",
               {"samples": 2, "limits": {"rec_gap": 1e-5}})
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "test", "reduced": [],
                             "file": "benchmark/configs/toy.json", "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "toy", "traffic": "toy",
                               "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "toy_s", "unit": "s", "better": "lower",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": [CELL]})
    bench["per_layer"].append({"name": "toy_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "toy layer",
                               "moves": "toy_s", "workloads": [CELL]})
    write_json(root / "BENCHMARK.json", bench)
    make_data.main(["--config", "toy", "--device", "cpu", "--root", str(root)])
    after = digests(root)
    assert {p: after[p] for p in before} == before, "a file of the tree changed"
    return root


def run(root, trace):
    return harness.run(root, CELL, 2**31 + 4242, 1.0, trace, "cpu",
                       time.perf_counter())


def test_a_toy_entry_runs_correct(toy_tree):
    result, lines = run(toy_tree, False)
    assert result["correct"], lines
    assert set(result["metrics"]) == {"setup_s", "toy_s"}
    assert set(result["checks"]) == {"rec_gap"}
    assert program.launches(["ops.kernel_stencil:launches"]) == {
        "ops.kernel_stencil:launches": kernel_stencil.launches}


def test_a_toy_metric_reads_its_span_and_its_counter(toy_tree, monkeypatch):
    """The CPU has no device records and launches no kernel, so a card is
    stood in for: each unit's ``toy.synth`` range (a span, as the trace
    gives it) launches one ``toy_kernel`` that runs for half of it, and
    each call into the program counts one launch."""
    real = devtrace.records

    def records(prof):
        device, host, spans = real(prof)
        assert {sp.name for sp in spans} == {"toy.synth"}
        for sp in spans:
            device.append(Interval(sp.start, 0.5 * (sp.start + sp.end),
                                   "void toy_kernel<4>(float2*)", sp.thread,
                                   sp.start))
        return device, host, spans

    synth = program.synthesize_ring_dataset

    def counted(*args, **kw):
        kernel_stencil.launches += 1
        return synth(*args, **kw)

    monkeypatch.setattr(devtrace, "records", records)
    monkeypatch.setattr(program, "synthesize_ring_dataset", counted)
    monkeypatch.setattr(kernel_stencil, "launches", kernel_stencil.launches)
    result, lines = run(toy_tree, True)
    assert result["correct"], lines
    assert set(result["metrics"]) == {"toy_ms"}
    ms = result["metrics"]["toy_ms"]["value"]
    # half of each of the two units' spans is kernel, one launch a unit
    assert 0 < ms < 0.5e3 * result["device"]["window_s"]
    assert result["device"]["busy_s"] == pytest.approx(2 * ms / 1e3)
    assert result["breakdown"]["device_ops"][0][0] == "toy_kernel"
