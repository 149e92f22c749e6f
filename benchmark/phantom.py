"""Seeded breast phantoms, the benchmark's own plain copy (numpy) of the
recipe of soundSpeedPhantom2D.m:24-26: an off-centre tissue disk with a
fast skin rim and six random elliptical inclusions, 1500 +/- 90 m/s."""

from __future__ import annotations

import numpy as np

from reference import Grid


def breast_phantom(grid: Grid, seed: int, c_bkgnd: float = 1500.0,
                   c_std: float = 90.0) -> np.ndarray:
    """(n, n) float32 sound speed [m/s] on ``grid``."""
    X, Y = np.meshgrid(grid.x, grid.x, indexing="xy")
    rng = np.random.default_rng(seed)
    c = np.full(grid.shape, c_bkgnd, dtype=np.float64)
    edge = abs(-grid.xmax + grid.dx * (grid.n - 1))
    r_out = 0.35 * edge * 2.0
    cx, cy = 0.06 * r_out, -0.04 * r_out
    rr = ((X - cx) / (1.05 * r_out)) ** 2 + ((Y - cy) / (0.92 * r_out)) ** 2
    tissue = rr <= 1.0
    c[tissue] = c_bkgnd - 0.35 * c_std
    c[(rr <= 1.0) & (rr >= 0.88)] = c_bkgnd + 0.6 * c_std
    for _ in range(6):
        ang = rng.uniform(0, 2 * np.pi)
        rad = rng.uniform(0.15, 0.6) * r_out
        ex, ey = cx + rad * np.cos(ang), cy + rad * np.sin(ang)
        a = rng.uniform(0.08, 0.22) * r_out
        b = rng.uniform(0.08, 0.22) * r_out
        tilt = rng.uniform(0, np.pi)
        dxr = (X - ex) * np.cos(tilt) + (Y - ey) * np.sin(tilt)
        dyr = -(X - ex) * np.sin(tilt) + (Y - ey) * np.cos(tilt)
        inside = (dxr / a) ** 2 + (dyr / b) ** 2 <= 1.0
        c[inside & tissue] = c_bkgnd + rng.uniform(-1.0, 1.0) * c_std
    return c.astype(np.float32)
