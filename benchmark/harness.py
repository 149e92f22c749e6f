"""One run of one cell: set-up, the measured (or traced) window, the
metrics, the comparison with the reference that decides ``correct``, and
the result line.

Order of a run: load the cell's files and make its inputs from the seed;
build and load the port's kernels; warm up on the cell's own shapes
(``warmup_units`` units, then the profiler when tracing); the window
(``--seconds`` of units back to back, or ``trace_units`` units under
torch.profiler); the peak memory; the program's state dropped; the
reference over a sample of the window's units drawn from the seed; the
check that no JAX module was loaded.
"""

from __future__ import annotations

import gc
import subprocess
import sys
from dataclasses import dataclass

import numpy as np
import torch

import devtrace
import program
import reference
import spec
import workload

FORBIDDEN = ("jax", "jaxlib", "flax", "waveforminversionust_tpu")


class Malformed(RuntimeError):
    """The run cannot give its metrics: it prints no result."""


@dataclass
class Readings:
    """What a per-layer metric's reader gets: the traced window's summary,
    what the configuration asked of the program in it, and the shapes."""

    summary: devtrace.Summary
    counts: dict
    ny: int
    nx: int
    batch: int

    def layer(self, name: str) -> float:
        return self.summary.layer_s.get(name, 0.0)


def log(msg: str) -> None:
    print(f"[bench {workload.now():.3f}] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable: {exc!r}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def _must_run(cell, before: dict, after: dict, summary=None) -> None:
    """Each layer the traffic says the cell must run launched its kernels
    (the port's counters) and, in a traced run, ran on the device."""
    for layer in cell.traffic.get("must_run", []):
        counters = {k["counter"] for k in cell.kernels.values()
                    if k["layer"] == layer}
        if not any(after.get(c, 0) > before.get(c, 0) for c in counters):
            raise Malformed(f"layer {layer!r} launched no kernel "
                            f"(counters {sorted(counters)})")
        if summary is not None and summary.layer_s.get(layer, 0.0) <= 0.0:
            raise Malformed(f"layer {layer!r}: no mapped kernel in the trace")


def _spread(units) -> str:
    """Quartiles of the units' durations, of their first frame gaps (from
    the hand-in) and of the later ones, for the log."""
    def q(xs):
        return ("-" if not xs else
                " / ".join(f"{v:.4f}" for v in np.percentile(xs, [0, 25, 50, 75, 100])))
    dur = [u.t_done - u.t_in for u in units]
    first = [u.frames[0][0] - u.t_in for u in units if u.frames]
    later = [b[0] - a[0] for u in units for a, b in zip(u.frames, u.frames[1:])]
    return (f"unit s {q(dur)}; first frame s {q(first)}; "
            f"later frames s {q(later)}")


def _traced(loop, n_units: int, device):
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    # the first profiler start on a process initialises CUPTI (seconds):
    # part of set-up, not of the window
    with profile(activities=acts):
        torch.zeros(1, device=device).add_(1)
        workload.sync(device)
    with profile(activities=acts) as prof:
        with record_function(devtrace.WINDOW):
            units = [loop.unit(k) for k in range(n_units)]
            workload.sync(device)
    return units, devtrace.records(prof)


def _per_layer(cell, readings: Readings) -> dict:
    """Each per-layer metric of the cell from its reader; one that reads
    nothing, or no number, makes the run malformed."""
    metrics = {}
    for m in cell.per_layer:
        v = spec.reader(cell.root, m["name"])(readings)
        if v is None or not np.isfinite(v):
            raise Malformed(f"per-layer metric {m['name']} read {v!r}")
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return metrics


def _end_to_end(cell, quantities: dict, setup_s: float) -> dict:
    """``setup_s`` and each end-to-end metric of the cell, as the traffic
    names its quantity."""
    metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
    names = cell.traffic["end_to_end"]
    for m in cell.end_to_end:
        if m["name"] == "setup_s":
            continue
        if names.get(m["name"]) not in quantities:
            raise Malformed(f"end-to-end metric {m['name']} not measured")
        metrics[m["name"]] = {"value": float(quantities[names[m["name"]]]),
                              "unit": m["unit"]}
    return metrics


def _compare(cell, loop, units, seed: int):
    """The reference over a sample of the completed units drawn from the
    seed; each number the worst of the sample (the largest, or any that is
    not a number), beside its limit. Returns (checks, units checked)."""
    good = [u for u in units if u.error is None]
    n = min(int(cell.check["samples"]), len(good))
    rng = np.random.default_rng([seed % (1 << 64), 99])
    read: dict = {}
    for i in sorted(rng.choice(len(good), size=n, replace=False)) if n else []:
        for key, v in loop.check(good[int(i)]).items():
            read.setdefault(key, []).append(float(v))
    checks = {}
    for k, lim in cell.check["limits"].items():
        vs = read.get(k, [float("nan")])
        bad = [v for v in vs if not np.isfinite(v)]
        checks[k] = {"value": str(bad[0]) if bad else max(vs),
                     "limit": float(lim)}
    return checks, n


def run(root, name: str, seed: int, seconds: float, trace: bool, device,
        t_start: float):
    """Run cell ``name`` once. Returns (result, check lines); raises
    :class:`Malformed` when the run gives no result."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    cell = spec.load(root, name)
    if cuda and torch.cuda.device_count() < cell.chips:
        raise Malformed(f"{name} needs {cell.chips} cards, "
                        f"{torch.cuda.device_count()} present")
    tr = cell.traffic
    loop = workload.make(cell, seed, device)
    if cuda:
        program.build_kernels()
        torch.zeros(1, device=device)  # the context, before its counters
        torch.cuda.reset_peak_memory_stats(device)
    for i in range(int(tr.get("warmup_units", 1))):
        u = loop.unit(workload.WARMUP_BASE + i)
        if u.error is not None:
            raise Malformed(f"warm-up unit failed: {u.error}")
    workload.sync(device)
    log(f"set-up done: {workload.now() - t_start:.3f} s")

    before = program.launches()
    if trace:
        units, (dev_iv, host_iv) = _traced(loop, int(tr["trace_units"]), device)
        t0 = t_end = None
    else:
        t_window = workload.now()
        t0, t_end, units = workload.window(loop, seconds)
    after = program.launches()
    log(f"window done: {len(units)} units, launches "
        f"{ {k: after[k] - before[k] for k in after} }")
    log(_spread(units))
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    result = {"correct": False, "attempted": len(units),
              "failed": sum(u.error is not None for u in units)}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if trace:
        summary = devtrace.summarize(
            dev_iv, host_iv, {k: m["layer"] for k, m in cell.kernels.items()})
        log(f"trace: {len(dev_iv)} device and {len(host_iv)} host records; "
            f"device time by kernel {devtrace.top(summary.kernel_s, 12)}")
        if cuda:
            _must_run(cell, before, after, summary)
        metrics = _per_layer(cell, Readings(
            summary, loop.counts(len(units)),
            *reference.grid_of(cell.config["grid"]).shape,
            batch=int(cell.config["ring"]["num_elements"])))
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": devtrace.top(summary.kernel_s),
                               "idle_gaps": devtrace.top(summary.idle_by_host)}
    else:
        if cuda:
            _must_run(cell, before, after)
        metrics = _end_to_end(cell, loop.quantities(units, t0, t_end),
                              t_window - t_start)
    result["metrics"] = metrics
    result["device"] = dev

    # the program's cached device memory goes before the reference runs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, n = _compare(cell, loop, units, seed)
    log(f"reference done over {n} units")
    result["correct"] = bool(n > 0 and result["failed"] == 0 and all(
        isinstance(c["value"], float) and c["value"] <= c["limit"]
        for c in checks.values()))
    if cuda:
        result["card"] = power_limit()
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
             for k, c in checks.items()]
    lines.insert(0, f"checked {n} of {len(units)} units; failed "
                    f"{result['failed']}; peak memory {peak} bytes")
    return result, lines

