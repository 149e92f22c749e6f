"""Ring-array acquisition geometry (port of
``waveforminversionust_tpu.models.acquisition``): element placement, acceptance-angle masks,
source cubes, and receiver gather indices.

Replaces the reference's inline preprocessing (reference: fwi_script.py:31-85,
FrequencyDomainFWI.m:13-68, Functions/sampled_circle.m:1-14) with one
precomputed, canonical row-major geometry object.

Parity notes:
  * The reference addresses receiver pixels through a MATLAB-style linear
    index ``ind_matlab = x_idx * Nxi + y_idx`` into a Fortran-order flattening
    (reference: fwi_script.py:68, nonlinearcg.py:83-85). On the square grids
    used there this is exactly ``field[y_idx, x_idx]``; we store (y_idx, x_idx)
    pairs directly, which is also correct on non-square grids.
  * Acceptance mask: for transmitter t, receivers t-31..t+31 (mod N, incl.
    self) are excluded, leaving 193 active receivers of 256
    (reference: fwi_script.py:39-44, FrequencyDomainFWI.m:20-30).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import AcquisitionConfig
from .grid import Grid2D


def ring_positions(num_elements: int, radius: float) -> tuple[np.ndarray, np.ndarray]:
    """Element coordinates on a ring, theta in [-pi, pi).

    Matches the reference element layout ``theta = -pi : 2*pi/N : pi - 2*pi/N``
    (reference: SimulateData.m:17-19).
    """
    theta = -np.pi + 2 * np.pi * np.arange(num_elements) / num_elements
    return radius * np.cos(theta), radius * np.sin(theta)


def snap_to_grid(grid: Grid2D, xq: np.ndarray, yq: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Nearest-grid-point snap via argmin over coordinates.

    Uses argmin (first minimum on ties) to match the reference's
    cKDTree/argmin behavior exactly (reference: fwi_script.py:53-66,
    FrequencyDomainFWI.m:53-54).
    """
    x = grid.x
    y = grid.y
    x_idx = np.argmin(np.abs(x[None, :] - np.asarray(xq).ravel()[:, None]), axis=1)
    y_idx = np.argmin(np.abs(y[None, :] - np.asarray(yq).ravel()[:, None]), axis=1)
    return x_idx.astype(np.int32), y_idx.astype(np.int32)


def bilinear_weights(grid: Grid2D, xq: np.ndarray, yq: np.ndarray):
    """4-corner bilinear interpolation stencils for physical points.

    Returns (y_idx, x_idx, w) of shape (n, 4): the enclosing pixel corners
    and their weights (sum to 1). Used for exact element placement —
    removing the reference's nearest-pixel snapping error
    (reference: fwi_script.py:53-66; see AcquisitionConfig.interpolation).
    """
    xq = np.asarray(xq, np.float64).ravel()
    yq = np.asarray(yq, np.float64).ravel()
    fx = np.clip((xq - grid.x0) / grid.dx, 0, grid.nx - 1 - 1e-9)
    fy = np.clip((yq - grid.y0) / grid.dy, 0, grid.ny - 1 - 1e-9)
    ix = np.clip(fx.astype(int), 0, grid.nx - 2)
    iy = np.clip(fy.astype(int), 0, grid.ny - 2)
    wx = fx - ix
    wy = fy - iy
    x_idx = np.stack([ix, ix + 1, ix, ix + 1], axis=1).astype(np.int32)
    y_idx = np.stack([iy, iy, iy + 1, iy + 1], axis=1).astype(np.int32)
    w = np.stack([(1 - wx) * (1 - wy), wx * (1 - wy),
                  (1 - wx) * wy, wx * wy], axis=1).astype(np.float32)
    return y_idx, x_idx, w


def acceptance_mask(num_elements: int, num_excluded_each_side: int) -> np.ndarray:
    """Boolean (num_elements, num_elements) include-mask.

    mask[tx, rx] is True when rx is within the acceptance angle of tx
    (reference: fwi_script.py:39-44).
    """
    tx = np.arange(num_elements)[:, None]
    offsets = np.arange(-num_excluded_each_side, num_excluded_each_side + 1)[None, :]
    mask = np.ones((num_elements, num_elements), dtype=bool)
    excl = (tx + offsets) % num_elements
    mask[np.arange(num_elements)[:, None], excl] = False
    return mask


@dataclasses.dataclass(frozen=True)
class RingAcquisition:
    """Precomputed acquisition geometry on a given grid.

    All index arrays are numpy int32 (they depend only on static geometry);
    :func:`..fwi.objective.build_fwi_data` moves them to the device.

    Attributes:
        grid: the reconstruction grid.
        x_elem, y_elem: (num_elements,) physical element positions [m].
        x_idx, y_idx: (num_elements,) element pixel indices on the grid.
        tx_include: (ntx,) transmitter element ids used for inversion.
        include_mask: (ntx, num_elements) bool acceptance mask, rows follow
            tx_include.
        rx_indices: (ntx, n_active) int32 active-receiver element ids per tx.
        rx_y, rx_x: (ntx, n_active) pixel indices of the active receivers.
    """

    grid: Grid2D
    x_elem: np.ndarray
    y_elem: np.ndarray
    x_idx: np.ndarray
    y_idx: np.ndarray
    tx_include: np.ndarray
    include_mask: np.ndarray
    rx_indices: np.ndarray
    rx_y: np.ndarray
    rx_x: np.ndarray
    # Bilinear placement (None for nearest): (num_elements, 4) corner
    # stencils and the per-tx gathered receiver versions (ntx, n_active, 4).
    elem_y4: np.ndarray | None = None
    elem_x4: np.ndarray | None = None
    elem_w4: np.ndarray | None = None
    rx_y4: np.ndarray | None = None
    rx_x4: np.ndarray | None = None
    rx_w4: np.ndarray | None = None

    @property
    def num_elements(self) -> int:
        return int(self.x_elem.size)

    @property
    def num_tx(self) -> int:
        return int(self.tx_include.size)

    @property
    def num_active_rx(self) -> int:
        return int(self.rx_indices.shape[1])

    def source_fields(self, dtype=np.complex64, amplitudes=None) -> np.ndarray:
        """Source cube, shape (ntx, ny, nx): one-hot per transmit element
        (nearest placement) or a 4-pixel bilinear stencil.

        ``amplitudes`` (ntx,) sets per-element complex amplitudes (the data
        synthesizer draws them at random to force source-strength estimation;
        reference: SimulateData.m:23-27). Defaults to 1.
        """
        ntx = self.num_tx
        src = np.zeros((ntx, self.grid.ny, self.grid.nx), dtype=dtype)
        amp = np.ones(ntx, dtype=dtype) if amplitudes is None else np.asarray(amplitudes, dtype=dtype)
        tx = self.tx_include
        if self.elem_w4 is None:
            src[np.arange(ntx), self.y_idx[tx], self.x_idx[tx]] = amp
        else:
            for k in range(4):
                np.add.at(src, (np.arange(ntx), self.elem_y4[tx, k],
                                self.elem_x4[tx, k]),
                          amp * self.elem_w4[tx, k])
        return src

    def sample_receivers_all(self, fields: np.ndarray) -> np.ndarray:
        """Sample fields (ntx, ny, nx) at ALL element pixels -> (ntx, num_elements)."""
        return fields[..., self.y_idx, self.x_idx]


def build_ring_acquisition(grid: Grid2D, config: AcquisitionConfig,
                           x_elem: np.ndarray | None = None,
                           y_elem: np.ndarray | None = None) -> RingAcquisition:
    """Construct the full acquisition geometry.

    If ``x_elem``/``y_elem`` are given (e.g. loaded from a recorded dataset),
    they override the ideal ring positions.
    """
    if x_elem is None or y_elem is None:
        x_elem, y_elem = ring_positions(config.num_elements, config.radius)
    x_elem = np.asarray(x_elem, dtype=np.float64).ravel()
    y_elem = np.asarray(y_elem, dtype=np.float64).ravel()
    n = x_elem.size

    x_idx, y_idx = snap_to_grid(grid, x_elem, y_elem)
    if config.interpolation == "bilinear":
        elem_y4, elem_x4, elem_w4 = bilinear_weights(grid, x_elem, y_elem)
    elif config.interpolation == "nearest":
        elem_y4 = elem_x4 = elem_w4 = None
    else:
        raise ValueError(f"unknown interpolation {config.interpolation!r}")
    tx_include = np.arange(0, n, config.tx_downsample, dtype=np.int32)

    full_mask = acceptance_mask(n, config.num_excluded_each_side)
    include_mask = full_mask[tx_include]

    # Every row has the same number of active receivers by construction.
    n_active = int(include_mask[0].sum())
    if n_active == 0:
        raise ValueError(
            f"acceptance mask leaves 0 active receivers: excluding "
            f"±{config.num_excluded_each_side} of {n} ring elements wraps the "
            f"whole ring. Lower AcquisitionConfig.num_excluded_each_side "
            f"(the default 31 assumes the reference's 256-element array).")
    rx_indices = np.stack(
        [np.flatnonzero(include_mask[i]).astype(np.int32) for i in range(len(tx_include))]
    )
    assert rx_indices.shape == (len(tx_include), n_active)

    return RingAcquisition(
        grid=grid,
        x_elem=x_elem,
        y_elem=y_elem,
        x_idx=x_idx,
        y_idx=y_idx,
        tx_include=tx_include,
        include_mask=include_mask,
        rx_indices=rx_indices,
        rx_y=y_idx[rx_indices],
        rx_x=x_idx[rx_indices],
        elem_y4=elem_y4,
        elem_x4=elem_x4,
        elem_w4=elem_w4,
        rx_y4=None if elem_y4 is None else elem_y4[rx_indices],
        rx_x4=None if elem_x4 is None else elem_x4[rx_indices],
        rx_w4=None if elem_w4 is None else elem_w4[rx_indices],
    )
