"""The traffic generator's shared parts and the closed loops it drives.

A traffic file names its entry (``"entry"``) and the parameters of the
loop. The loop of an entry is the class ``Loop`` of
``benchmark/entries/<entry>.py``, found by name; it makes every input
from ``--seed``, hands the same input to the program and, after the
window, to the entry's plain reference (``benchmark/references/<entry>.py``).
Each unit of work is one call into the program, made only after the
previous one returned (a closed loop, one client).

A ``Loop`` gives:
  * ``unit(k)`` -> :class:`Unit`: the k-th call, timed;
  * ``counts(units)``: what the configuration asks of the program in that
    many units (the per-layer metrics' denominators);
  * ``quantities(units, t0, t_end)``: what each end-to-end metric a
    traffic file may name (its ``end_to_end`` values) measures;
  * ``shapes()``: the sizes the per-layer metrics' costs are taken at;
  * ``check(unit)``: each compared number of one unit against the
    reference;
  * and, for ``calibrate.py`` and the control's tests, ``produced(unit)``,
    ``expected(k, precision)`` and ``compare(got, want)``, with the
    program's callable as ``run``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import spec

WARMUP_BASE = 1 << 40  # unit indices of the warm-up, apart from the window's


def now() -> float:
    return time.perf_counter()


def unit_rng(seed: int, k: int, stream: int = 0) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), k, stream])


class Unit:
    """One call into the program and what it returned."""

    def __init__(self, k: int):
        self.k = k
        self.t_in = self.t_done = None
        self.frames = []      # (time, iteration, velocity)
        self.output = None
        self.error = None


def make(cell, seed: int, device):
    """The loop of the cell's entry, ``entries/<entry>.py``'s ``Loop``."""
    return spec.module(cell.root, "entries", cell.traffic["entry"]).Loop(
        cell, seed, device)


def reference(cell):
    """The plain reference of the cell's entry, ``references/<entry>.py``."""
    return spec.module(cell.root, "references", cell.traffic["entry"])


def window(loop, seconds: float):
    """Units back to back until ``seconds`` have passed and at least one
    unit has returned; returns (t0, t_end, units). t_end is the later of
    the nominal end and the first unit's return, so the window holds a
    unit even on a host too busy to finish one in ``seconds``. The last
    unit may end after t_end."""
    units = []
    t0 = now()
    t_end = t0 + seconds
    k = 0
    while now() < t_end or not units:
        units.append(loop.unit(k))
        k += 1
    return t0, max(t_end, units[0].t_done), units


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
