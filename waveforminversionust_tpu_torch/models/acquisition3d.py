"""3D acquisition geometries (port of
``waveforminversionust_tpu.models.acquisition3d``): cylindrical and
hemispherical transducer arrays, the volumetric extension of the 2D ring
(reference: FrequencyDomainFWI.m:48-68, sampled_circle.m).

Element positions snap to the nearest voxel of a :class:`.grid3d.Grid3D`;
the acceptance rule generalizes the 2D exclusion arc to a minimum angle
between transmit and receive directions. The geometry is numpy; only the
one-hot sources are a tensor, on the device the caller names.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import default_device
from .grid3d import Grid3D


def cylinder_positions(n_rings: int, n_per_ring: int, radius: float,
                       z_span: float) -> np.ndarray:
    """(n_rings * n_per_ring, 3) xyz positions on a cylinder of the given
    radius, rings evenly spaced over [-z_span/2, z_span/2]."""
    theta = 2 * np.pi * np.arange(n_per_ring) / n_per_ring
    zs = (np.linspace(-z_span / 2, z_span / 2, n_rings)
          if n_rings > 1 else np.zeros(1))
    pts = [np.stack([radius * np.cos(theta), radius * np.sin(theta),
                     np.full(n_per_ring, z)], axis=1) for z in zs]
    return np.concatenate(pts, axis=0)


def hemisphere_positions(n: int, radius: float) -> np.ndarray:
    """(n, 3) Fibonacci-spiral points on the lower half-sphere (a bowl
    array, elements looking up at z <= 0)."""
    i = np.arange(n) + 0.5
    z = -i / n
    phi = np.pi * (1 + 5 ** 0.5) * i
    r = np.sqrt(np.maximum(1 - z * z, 0.0))
    return radius * np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


class Acquisition3D(NamedTuple):
    """Snapped 3D acquisition: per-transmitter sources and receiver gathers
    (numpy). Every transmitter has the same number of active receivers."""

    src_idx: np.ndarray    # (ntx, 3) int32 voxel (iz, iy, ix) per tx
    rx_idx: np.ndarray     # (ntx, n_active, 3) int32 receiver voxels
    positions: np.ndarray  # (n_elements, 3) xyz [m]
    n_elements: int
    # (ntx, n_active) int32 receiver element ids behind rx_idx: the bridge
    # from per-element channel data (data/timedomain3d.py) to the gathers.
    rx_elem: np.ndarray | None = None


def snap_to_grid3d(grid: Grid3D, positions: np.ndarray) -> np.ndarray:
    """Nearest-voxel indices (iz, iy, ix) for xyz positions (argmin snap,
    as in 2D; reference: FrequencyDomainFWI.m:52-55)."""
    ix = np.argmin(np.abs(positions[:, 0:1]
                          - (grid.x0 + grid.dx * np.arange(grid.nx))), axis=1)
    iy = np.argmin(np.abs(positions[:, 1:2]
                          - (grid.y0 + grid.dy * np.arange(grid.ny))), axis=1)
    iz = np.argmin(np.abs(positions[:, 2:3]
                          - (grid.z0 + grid.dz * np.arange(grid.nz))), axis=1)
    return np.stack([iz, iy, ix], axis=1).astype(np.int32)


def build_acquisition3d(grid: Grid3D, positions: np.ndarray,
                        min_angle: float = 0.5) -> Acquisition3D:
    """Snap an element cloud and build the angular acceptance mask.

    A receiver is active for a transmitter when the angle between their
    position vectors (from the array centre) exceeds ``min_angle`` [rad]
    (the 3D form of the reference's exclusion arc, fwi_script.py:31-44).
    Every transmitter keeps its ``n_active`` largest-angle receivers, with
    n_active the smallest acceptance count over the transmitters, so the
    receiver arrays stay rectangular. ``min_angle <= 0`` is full aperture:
    every element receives for every transmitter in element order, the
    geometry random source encoding needs (``fwi3d.encode_supershots``).
    """
    pos = np.asarray(positions, np.float64)
    n = pos.shape[0]
    if min_angle <= 0.0:
        rx_elem = np.tile(np.arange(n), (n, 1))
    else:
        unit = pos / np.maximum(np.linalg.norm(pos, axis=1, keepdims=True),
                                1e-30)
        cosang = np.clip(unit @ unit.T, -1.0, 1.0)
        ang = np.arccos(cosang)                   # (n, n), 0 on the diagonal
        accept = ang > min_angle
        n_active = int(accept.sum(axis=1).min())
        if n_active < 1:
            raise ValueError("min_angle excludes every receiver for some tx")
        order = np.argsort(-ang, axis=1, kind="stable")
        rx_elem = order[:, :n_active]             # (n, n_active) element ids
    idx = snap_to_grid3d(grid, pos)               # (n, 3)
    return Acquisition3D(src_idx=idx, rx_idx=idx[rx_elem], positions=pos,
                         n_elements=n, rx_elem=rx_elem.astype(np.int32))


def source_fields_3d(acq: Acquisition3D, grid: Grid3D,
                     device=None) -> torch.Tensor:
    """One-hot complex sources (ntx, nz, ny, nx) complex64, 1 at each
    element's voxel (reference: FrequencyDomainFWI.m:61-68), on ``device``
    (default: the card, which raises when there is none)."""
    device = default_device() if device is None else device
    idx = torch.as_tensor(np.asarray(acq.src_idx), dtype=torch.long,
                          device=device)
    ntx = idx.shape[0]
    src = torch.zeros((ntx,) + grid.shape, dtype=torch.complex64,
                      device=device)
    src[torch.arange(ntx, device=device), idx[:, 0], idx[:, 1],
        idx[:, 2]] = 1.0
    return src
