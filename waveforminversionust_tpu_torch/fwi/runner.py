"""Inversion driver: dataset -> reconstruction (port of the single-stage CG
path of ``waveforminversionust_tpu.fwi.runner``).

Continuation, checkpoints, live callbacks, receiver calibration, ``mesh``
and the other methods ("lbfgs", "gn", "joint-multifreq") are ported in
later slices and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import (AcquisitionConfig, ContinuationConfig, FWIConfig,
                      SolverConfig)
from ..device import default_device
from ..models.acquisition import build_ring_acquisition
from ..models.grid import Grid2D
from .objective import build_fwi_data
from .optimizers import CGMetrics, nonlinear_cg


class InversionResult(NamedTuple):
    velocity: np.ndarray          # (ny, nx) reconstructed speed [m/s]
    metrics: dict                 # per-iteration scalar histories (numpy)
    grid: Grid2D
    frequencies: tuple


def default_inversion_grid() -> Grid2D:
    """The reference's 301x301 / 0.8 mm reconstruction grid
    (fwi_script.py:46-49)."""
    return Grid2D.centered(120e-3, 0.8e-3)


def _initial_velocity(c_init, fwi: FWIConfig, grid: Grid2D, device):
    """None -> homogeneous fwi.c_init; scalar -> homogeneous; map -> as is."""
    if c_init is None:
        c_init = fwi.c_init
    c = torch.as_tensor(c_init, dtype=torch.float32)
    if c.dim() == 0:
        return torch.full(grid.shape, float(c), dtype=torch.float32,
                          device=device)
    if tuple(c.shape) != grid.shape:
        raise ValueError(f"c_init shape {tuple(c.shape)} != grid shape "
                         f"{grid.shape}")
    return c.to(device)


def invert_dataset(dataset, grid: Grid2D | None = None,
                   acquisition: AcquisitionConfig = AcquisitionConfig(),
                   solver: SolverConfig = SolverConfig(),
                   fwi: FWIConfig = FWIConfig(),
                   continuation: ContinuationConfig | None = None,
                   method: str = "cg",
                   callback: Callable | None = None,
                   attenuation=None,
                   checkpoint_dir: str | None = None,
                   checkpoint_every: int | None = None,
                   resume_from: str | None = None,
                   live_every: int | None = None,
                   live_callback: Callable | None = None,
                   c_init=None,
                   mesh=None,
                   receiver_calibration: bool = False,
                   device=None) -> InversionResult:
    """Invert a RingDataset with nonlinear CG in one stage at ``dataset.f``
    for ``fwi.num_iterations`` iterations, on ``device`` (default: the
    card, :func:`..device.default_device`, which raises when there is
    none; pass ``"cpu"`` for the plain PyTorch path).
    ``callback(stage, frequency, velocity, metrics)`` fires once at the
    end of the stage."""
    later = {
        "method": method != "cg",
        "continuation": continuation is not None and bool(continuation.frequencies),
        "checkpoints": bool(checkpoint_dir or resume_from),
        "live callbacks": live_callback is not None,
        "mesh": mesh is not None,
        "receiver_calibration": receiver_calibration,
        "per-frequency datasets": isinstance(dataset, dict),
    }
    missing = [k for k, v in later.items() if v]
    if missing:
        raise NotImplementedError(
            f"{', '.join(missing)}: ported in a later slice (ROADMAP.md A); "
            f"this slice runs single-stage nonlinear CG")
    if device is None:
        device = default_device()
    grid = grid or default_inversion_grid()
    if attenuation is not None and np.ndim(attenuation) == 0:
        attenuation = (None if float(attenuation) == 0.0 else
                       np.full(grid.shape, float(attenuation), np.float32))
    acq = build_ring_acquisition(grid, acquisition, x_elem=dataset.x_circ,
                                 y_elem=dataset.y_circ)
    freq = float(dataset.f)
    data = build_fwi_data(acq, dataset.rec_data, freq,
                          attenuation=attenuation, device=device)
    vel0 = _initial_velocity(c_init, fwi, grid, data.src.device)
    res = nonlinear_cg(vel0, data, grid, solver, fwi,
                       num_iterations=int(fwi.num_iterations))
    vel = res.velocity.cpu().numpy()
    metrics = {f: getattr(res.metrics, f).cpu().numpy()
               for f in CGMetrics._fields}
    if callback is not None:
        callback(0, freq, vel, res.metrics)
    return InversionResult(velocity=vel, metrics=metrics, grid=grid,
                           frequencies=(freq,))


def reconstruction_rmse(velocity, grid: Grid2D, true_map, true_grid: Grid2D,
                        radius: float = 100e-3) -> float:
    """RMSE inside the ring between a reconstruction and a (finer-grid)
    truth map, bilinearly resampled onto the reconstruction grid."""
    tx = (grid.x - true_grid.x0) / true_grid.dx
    ty = (grid.y - true_grid.y0) / true_grid.dy
    ix = np.clip(tx.astype(int), 0, true_grid.nx - 2)
    iy = np.clip(ty.astype(int), 0, true_grid.ny - 2)
    wx = np.clip(tx - ix, 0, 1)[None, :]
    wy = np.clip(ty - iy, 0, 1)[:, None]
    t = np.asarray(true_map)
    interp = (t[np.ix_(iy, ix)] * (1 - wx) * (1 - wy)
              + t[np.ix_(iy, ix + 1)] * wx * (1 - wy)
              + t[np.ix_(iy + 1, ix)] * (1 - wx) * wy
              + t[np.ix_(iy + 1, ix + 1)] * wx * wy)
    X, Y = grid.meshgrid()
    inside = np.hypot(X, Y) < radius
    return float(np.sqrt(np.mean((np.asarray(velocity) - interp)[inside] ** 2)))
