"""The loop of ``invert_dataset``: reconstructions back to back.

Inputs: the configuration's stored receiver data (one matrix a phantom,
synthesized once at unit amplitudes by ``make_data.py``); unit k inverts
phantom (k + seed) mod P, every transmitter's row scaled by a complex
amplitude drawn from (seed, k) (SimulateData.m:23-27). Every seed so runs
the same phantoms in another order, and the same sizes. With
``live_every`` the program hands a frame to the loop every that many
iterations (the console's redraw); without, only the final velocity is
compared.
"""

from __future__ import annotations

import numpy as np
from torch.profiler import record_function

import program
import reference
import workload
from workload import Unit, now, unit_rng


class Loop:
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
        self.reference = workload.reference(cell)

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

    def shapes(self) -> dict:
        """The grid and the right-hand sides a solve carries (one a
        transmitter)."""
        ny, nx = reference.grid_of(self.cell.config["grid"]).shape
        return {"ny": ny, "nx": nx,
                "batch": int(self.cell.config["ring"]["num_elements"])}

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
        return self.reference.expected(self.inputs(k), self.cell.config,
                                       self.cell.traffic, self.device,
                                       precision)

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
