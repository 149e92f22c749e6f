"""Profiling and timing helpers (port of
``waveforminversionust_tpu.utils.profiling``).

Every span waits for the work it launched on the card before it reads the
clock (``torch.cuda.synchronize()`` when CUDA is initialised), so it times
execution, not the launches; :func:`trace` wraps ``torch.profiler`` for a
Chrome/Perfetto timeline of host and device events.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the CPU and, when CUDA is
    available, of the card; it is written into ``logdir`` as
    ``trace.json`` (Chrome trace format, viewable in Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        _sync()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def timed(label: str, results: dict | None = None):
    """Wall-clock span that waits for the card's work to finish."""
    _sync()
    t0 = time.perf_counter()
    yield
    _sync()
    dt = time.perf_counter() - t0
    if results is not None:
        results[label] = dt
    else:
        print(f"[timed] {label}: {dt:.4f}s")


def benchmark(fn: Callable, *args, warmup: int = 1, iters: int = 3,
              **kwargs) -> dict:
    """First call, then steady-state calls of ``fn``, each synchronised.

    Returns {'compile_s': first-call time (the kernels' build and the
    first launches), 'mean_s': steady-state mean, 'min_s': best}."""
    def once():
        _sync()
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        return time.perf_counter() - t0

    compile_s = once()
    for _ in range(max(0, warmup - 1)):
        once()
    times = [once() for _ in range(iters)]
    return {"compile_s": compile_s, "mean_s": sum(times) / len(times),
            "min_s": min(times)}
