"""Procedural sound-speed phantoms (port of
``waveforminversionust_tpu.models.phantom``; numpy, bit-identical)."""

from __future__ import annotations

import numpy as np

from .grid import Grid2D

C_BACKGROUND = 1500.0
C_STD = 90.0


def breast_phantom(grid: Grid2D, c_bkgnd: float = C_BACKGROUND,
                   c_std: float = C_STD, seed: int = 0) -> np.ndarray:
    """Breast-like phantom: an off-center tissue disk with a fast skin rim
    and six random elliptical inclusions (1500 +/- 90 m/s; reference:
    soundSpeedPhantom2D.m:24-26). Returns (ny, nx) float32 m/s."""
    X, Y = grid.meshgrid()
    rng = np.random.default_rng(seed)
    c = np.full(grid.shape, c_bkgnd, dtype=np.float64)

    r_out = 0.35 * min(abs(grid.extent[1]), abs(grid.extent[3])) * 2.0
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
        contrast = rng.uniform(-1.0, 1.0) * c_std
        c[inside & tissue] = c_bkgnd + contrast

    return c.astype(np.float32)


def smooth_blob_phantom(grid: Grid2D, radius: float, dc: float = 40.0,
                        c_bkgnd: float = C_BACKGROUND,
                        center=(0.0, 0.0)) -> np.ndarray:
    """Smooth Gaussian blob (easy single-frequency FWI target)."""
    X, Y = grid.meshgrid()
    r2 = (X - center[0]) ** 2 + (Y - center[1]) ** 2
    c = c_bkgnd + dc * np.exp(-r2 / (2 * (radius / 2.0) ** 2))
    return c.astype(np.float32)
