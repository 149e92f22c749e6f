"""Regular 3D computational grids (port of
``waveforminversionust_tpu.models.grid3d``), the volumetric extension of
the 2D ring geometry. Fields are row-major ``(..., nz, ny, nx)``, as in the
JAX package, so both packages exchange volumes without transposes.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Grid3D:
    """A uniform 3D grid (hashable, like :class:`.grid.Grid2D`)."""

    nx: int
    ny: int
    nz: int
    dx: float
    dy: float
    dz: float
    x0: float
    y0: float
    z0: float

    @classmethod
    def centered(cls, xmax: float, dx: float, ymax: float | None = None,
                 zmax: float | None = None) -> "Grid3D":
        """Grid spanning [-xmax, xmax] x [-ymax, ymax] x [-zmax, zmax]
        inclusive at spacing ``dx`` on every axis."""
        ymax = xmax if ymax is None else ymax
        zmax = xmax if zmax is None else zmax
        nx = int(round(2 * xmax / dx)) + 1
        ny = int(round(2 * ymax / dx)) + 1
        nz = int(round(2 * zmax / dx)) + 1
        return cls(nx=nx, ny=ny, nz=nz, dx=float(dx), dy=float(dx),
                   dz=float(dx), x0=-float(xmax), y0=-float(ymax),
                   z0=-float(zmax))

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.nz, self.ny, self.nx)

    @property
    def x(self) -> np.ndarray:
        return self.x0 + self.dx * np.arange(self.nx)

    @property
    def y(self) -> np.ndarray:
        return self.y0 + self.dy * np.arange(self.ny)

    @property
    def z(self) -> np.ndarray:
        return self.z0 + self.dz * np.arange(self.nz)

    @property
    def diagonal(self) -> float:
        return float(np.sqrt((self.dx * self.nx) ** 2
                             + (self.dy * self.ny) ** 2
                             + (self.dz * self.nz) ** 2))

    def meshgrid(self):
        """(Z, Y, X) arrays of shape (nz, ny, nx)."""
        return np.meshgrid(self.z, self.y, self.x, indexing="ij")
