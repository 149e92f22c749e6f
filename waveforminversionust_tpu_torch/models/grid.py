"""Regular 2D computational grids (port of ``waveforminversionust_tpu.models.grid``).

A grid is a small frozen, hashable dataclass; coordinate arrays are numpy and
derived on demand. Fields are stored row-major as ``(..., ny, nx)`` with the
batch (source) axis leading, exactly as in the JAX package, so both packages
exchange arrays without transposes.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grid2D:
    """A uniform 2D grid (hashable).

    Attributes:
        nx, ny: number of grid points in x and y.
        dx, dy: grid spacing [m].
        x0, y0: coordinate of the first grid point [m].
    """

    nx: int
    ny: int
    dx: float
    dy: float
    x0: float
    y0: float

    @classmethod
    def centered(cls, xmax: float, dx: float, ymax: float | None = None,
                 dy: float | None = None) -> "Grid2D":
        """Grid spanning [-xmax, xmax] x [-ymax, ymax] inclusive.

        ``Grid2D.centered(120e-3, 0.8e-3)`` reproduces the reference's
        301x301 inversion grid (reference: fwi_script.py:46-49).
        """
        ymax = xmax if ymax is None else ymax
        dy = dx if dy is None else dy
        nx = int(round(2 * xmax / dx)) + 1
        ny = int(round(2 * ymax / dy)) + 1
        return cls(nx=nx, ny=ny, dx=float(dx), dy=float(dy),
                   x0=-float(xmax), y0=-float(ymax))

    @classmethod
    def from_arrays(cls, x, y) -> "Grid2D":
        x = np.asarray(x).ravel()
        y = np.asarray(y).ravel()
        return cls(nx=int(x.size), ny=int(y.size),
                   dx=float(np.mean(np.diff(x))), dy=float(np.mean(np.diff(y))),
                   x0=float(x[0]), y0=float(y[0]))

    @property
    def shape(self) -> tuple[int, int]:
        """(ny, nx) — the row-major field shape."""
        return (self.ny, self.nx)

    @property
    def x(self) -> np.ndarray:
        return self.x0 + self.dx * np.arange(self.nx, dtype=np.float64)

    @property
    def y(self) -> np.ndarray:
        return self.y0 + self.dy * np.arange(self.ny, dtype=np.float64)

    @property
    def h(self) -> float:
        """Grid spacing in x (the stencil's reference spacing)."""
        return self.dx

    @property
    def aspect(self) -> float:
        """g = dy/dx, the stencil anisotropy ratio."""
        return self.dy / self.dx

    @property
    def extent(self) -> tuple[float, float, float, float]:
        """(xmin, xmax, ymin, ymax)."""
        return (self.x0, self.x0 + self.dx * (self.nx - 1),
                self.y0, self.y0 + self.dy * (self.ny - 1))

    @property
    def diagonal(self) -> float:
        """Length of the grid diagonal [m]."""
        lx = self.dx * self.nx
        ly = self.dy * self.ny
        return float(np.hypot(lx, ly))

    def meshgrid(self) -> tuple[np.ndarray, np.ndarray]:
        """(X, Y) with shape (ny, nx)."""
        return np.meshgrid(self.x, self.y, indexing="xy")

    def nearest_index(self, xq, yq) -> tuple[np.ndarray, np.ndarray]:
        """Snap physical coordinates to nearest grid indices.

        Returns integer arrays (x_idx, y_idx); replaces the reference's
        cKDTree/argmin snapping (reference: fwi_script.py:53-66).
        """
        xq = np.asarray(xq).ravel()
        yq = np.asarray(yq).ravel()
        x_idx = np.clip(np.round((xq - self.x0) / self.dx), 0, self.nx - 1)
        y_idx = np.clip(np.round((yq - self.y0) / self.dy), 0, self.ny - 1)
        return x_idx.astype(np.int32), y_idx.astype(np.int32)
