"""The loop of ``synthesize_ring_dataset``: datasets back to back.

Inputs: a pool of ``phantoms`` seeded phantoms made in set-up; unit k
synthesizes phantom k mod pool with the amplitudes of a seed drawn from
(seed, k).
"""

from __future__ import annotations

import numpy as np
from torch.profiler import record_function

import program
import reference
import workload
from phantom import breast_phantom
from workload import Unit, now, unit_rng


class Loop:
    """Datasets back to back through ``synthesize_ring_dataset``."""

    def __init__(self, cell, seed: int, device):
        cfg, tr = cell.config, cell.traffic
        self.cell, self.seed, self.device = cell, seed, device
        grid = reference.grid_of(cfg["grid"])
        pool = unit_rng(seed, 0, 1).integers(1 << 31, size=int(tr["phantoms"]))
        self.phantoms = [breast_phantom(grid, int(s)) for s in pool]
        self.run = program.Synthesis(cfg, tr, device)
        self.reference = workload.reference(cell)

    def inputs(self, k: int):
        return (self.phantoms[k % len(self.phantoms)],
                int(unit_rng(self.seed, k).integers(1 << 63)))

    def unit(self, k: int) -> Unit:
        u = Unit(k)
        vel, amp_seed = self.inputs(k)
        u.t_in = now()
        try:
            with record_function("bench.unit"):
                rec = self.run(vel, amp_seed)
            u.output = rec
            if not np.all(np.isfinite(rec)):
                u.error = "non-finite receiver data"
        except Exception as exc:  # a failed unit is counted, the loop goes on
            u.error = repr(exc)
        u.t_done = now()
        return u

    def counts(self, units: int) -> dict:
        return {"units": units, "iterations": 0, "factorizations": units,
                "solves": units, "applies": units}

    def shapes(self) -> dict:
        """The grid and the right-hand sides a solve carries (one a
        transmitter)."""
        ny, nx = reference.grid_of(self.cell.config["grid"]).shape
        return {"ny": ny, "nx": nx,
                "batch": int(self.cell.config["ring"]["num_elements"])}

    def quantities(self, units: list, t0: float, t_end: float) -> dict:
        done = [u for u in units if u.error is None and u.t_done <= t_end]
        return {"unit_s": (max(u.t_done for u in done) - t0) / len(done)} if done else {}

    def expected(self, k: int, precision: str = "fp32") -> np.ndarray:
        """The reference's receiver data for unit ``k``'s phantom and
        amplitudes (the seed's draw, as SimulateData.m:23-27 makes them)."""
        vel, amp_seed = self.inputs(k)
        return self.reference.expected(vel, amp_seed, self.cell.config,
                                       self.device, precision)

    @staticmethod
    def produced(u: Unit) -> np.ndarray:
        return u.output

    @staticmethod
    def compare(got, want) -> dict:
        """rec_gap: the largest relative gap of a transmitter's row."""
        gap = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
        return {"rec_gap": float(np.max(gap))}

    def check(self, u: Unit) -> dict:
        return self.compare(self.produced(u), self.expected(u.k))
