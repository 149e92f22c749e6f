"""The traffic generator and the closed loops it drives.

A traffic file names its entry (``"entry"``) and the parameters of the
loop; the generator makes every input from ``--seed``, hands the same
input to the program and, after the window, to the reference. Each unit
of work (one reconstruction, one synthesized dataset) is one call into the
program, made only after the previous one returned (a closed loop, one
client: a scanner console, or a script that synthesizes one dataset
after another).

Inputs:
  * ``invert_dataset``: the configuration's stored receiver data (one
    matrix a phantom, synthesized once at unit amplitudes by
    ``make_data.py``); unit k inverts phantom (k + seed) mod P, every
    transmitter's row scaled by a complex amplitude drawn from (seed, k)
    (SimulateData.m:23-27). Every seed so runs the same phantoms in
    another order, and the same sizes.
  * ``synthesize_ring_dataset``: a pool of ``phantoms`` seeded phantoms
    made in set-up; unit k synthesizes phantom k mod pool with the
    amplitudes of a seed drawn from (seed, k).
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function

import program
import reference
from phantom import breast_phantom

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


class InversionLoop:
    """Reconstructions back to back through ``invert_dataset``."""

    def __init__(self, cell, seed: int, device):
        cfg, tr = cell.config, cell.traffic
        self.cell, self.seed, self.device = cell, seed, device
        with np.load(cell.path(cfg["data"]["file"])) as z:
            self.stored = z["rec"]
        r = cfg["ring"]
        xe, ye = reference.ring_positions(int(r["num_elements"]),
                                          float(r["radius"]))
        self.run = program.Inversion(cfg, tr, xe, ye, device)
        self.live = bool(tr.get("live_every"))

    def inputs(self, k: int) -> np.ndarray:
        p = (k + self.seed) % self.stored.shape[0]
        rng = unit_rng(self.seed, k)
        n = self.stored.shape[1]
        amps = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        return (self.stored[p] * amps[:, None]).astype(np.complex64)

    def unit(self, k: int) -> Unit:
        u = Unit(k)
        data = self.inputs(k)

        def frame(stage, freq, iteration, vel, metrics):
            u.frames.append((now(), int(iteration), vel))

        u.t_in = now()
        try:
            with record_function("bench.unit"):
                vel, loss = self.run(data, frame if self.live else None)
            u.output = (vel, loss)
            if not (np.all(np.isfinite(vel)) and np.all(np.isfinite(loss))):
                u.error = "non-finite reconstruction"
        except Exception as exc:  # a failed unit is counted, the loop goes on
            u.error = repr(exc)
        u.t_done = now()
        return u

    def counts(self, units: int) -> dict:
        """What the configuration asks of the program in ``units``
        reconstructions."""
        tr = self.cell.traffic
        n, K = int(tr["iterations"]), int(tr.get("refactor_every", 1))
        chunk = int(tr["live_every"]) if self.live else n
        fac = sum(1 for it in range(n) if it % K == 0 or it % chunk == 0)
        stale = n - fac if K > 1 else 0
        return {"units": units, "iterations": units * n,
                "factorizations": units * fac,
                "solves": units * (3 * n + 2 * stale),
                "applies": units * 2 * stale}

    def quantities(self, units: list, t0: float, t_end: float) -> dict:
        done = [u for u in units if u.error is None and u.t_done <= t_end]
        q = {}
        if done:
            q["unit_s"] = (max(u.t_done for u in done) - t0) / len(done)
        gaps = []
        for u in units:
            prev = u.t_in
            for t, _, _ in u.frames:
                if t > t_end:
                    break
                gaps.append(t - prev)
                prev = t
        if gaps:
            q["frame_gap_p95"] = float(np.percentile(gaps, 95))
            q["frames"] = len(gaps)
        return q

    def expected(self, k: int, precision: str = "fp32"):
        """The reference's (frames, losses) for unit ``k``'s input."""
        return reference.reconstruct(self.inputs(k), self.cell.config,
                                     self.cell.traffic, self.device, precision)

    def produced(self, u: Unit):
        """The (frames, losses) the program gave: its live frames, or the
        final velocity when the traffic draws none."""
        frames = [v for _, _, v in u.frames] if self.live else [u.output[0]]
        return frames, np.asarray(u.output[1], np.float64)

    @staticmethod
    def compare(got, want) -> dict:
        """vel_gap: the largest |velocity gap| [m/s] over every frame;
        loss_gap: the largest relative gap of an iteration's misfit."""
        (frames, loss), (ref_frames, ref_loss) = got, want
        vel_gap = (max(float(np.max(np.abs(a - b)))
                       for a, b in zip(frames, ref_frames))
                   if len(frames) == len(ref_frames) else float("inf"))
        loss_gap = (float(np.max(np.abs(loss - ref_loss) / np.abs(ref_loss)))
                    if loss.shape == ref_loss.shape else float("inf"))
        return {"vel_gap": vel_gap, "loss_gap": loss_gap}

    def check(self, u: Unit) -> dict:
        return self.compare(self.produced(u), self.expected(u.k))


class SynthesisLoop:
    """Datasets back to back through ``synthesize_ring_dataset``."""

    def __init__(self, cell, seed: int, device):
        cfg, tr = cell.config, cell.traffic
        self.cell, self.seed, self.device = cell, seed, device
        grid = reference.grid_of(cfg["grid"])
        pool = unit_rng(seed, 0, 1).integers(1 << 31, size=int(tr["phantoms"]))
        self.phantoms = [breast_phantom(grid, int(s)) for s in pool]
        self.run = program.Synthesis(cfg, tr, device)

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

    def quantities(self, units: list, t0: float, t_end: float) -> dict:
        done = [u for u in units if u.error is None and u.t_done <= t_end]
        return {"unit_s": (max(u.t_done for u in done) - t0) / len(done)} if done else {}

    def expected(self, k: int, precision: str = "fp32") -> np.ndarray:
        """The reference's receiver data for unit ``k``'s phantom and
        amplitudes (the seed's draw, as SimulateData.m:23-27 makes them)."""
        vel, amp_seed = self.inputs(k)
        rng = np.random.default_rng(amp_seed)
        n = int(self.cell.config["ring"]["num_elements"])
        amps = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
        return reference.synthesize(vel, self.cell.config, amps, self.device,
                                    precision)

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


ENTRIES = {"invert_dataset": InversionLoop,
           "synthesize_ring_dataset": SynthesisLoop}


def make(cell, seed: int, device):
    return ENTRIES[cell.traffic["entry"]](cell, seed, device)


def window(loop, seconds: float):
    """Units back to back until ``seconds`` have passed; returns (t0,
    t_end, units). The last unit may end after t_end."""
    units = []
    t0 = now()
    t_end = t0 + seconds
    k = 0
    while now() < t_end:
        units.append(loop.unit(k))
        k += 1
    return t0, t_end, units


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
