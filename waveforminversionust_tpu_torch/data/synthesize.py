"""Synthetic ring datasets (port of ``waveforminversionust_tpu.data.synthesize``).

Forward-model a known phantom on a grid finer than the inversion grid, with
random complex per-element source amplitudes drawn from numpy's
``default_rng(seed)`` (reference: SimulateData.m:1-63), and record the
wavefield at every element pixel. The same seed gives the same amplitudes
as the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import AcquisitionConfig, SolverConfig
from ..device import default_device
from ..models.acquisition import build_ring_acquisition
from ..models.grid import Grid2D
from ..ops.solve import solve_helmholtz


class RingDataset(NamedTuple):
    """The schema of the reference ``RecordedData.mat`` (numpy arrays)."""

    x: np.ndarray        # (nx,) simulation-grid x coords [m]
    y: np.ndarray        # (ny,)
    c: np.ndarray        # (ny, nx) true sound speed [m/s]
    x_circ: np.ndarray   # (num_elements,) element x [m]
    y_circ: np.ndarray   # (num_elements,) element y [m]
    f: float             # frequency [Hz]
    rec_data: np.ndarray  # (num_elements, num_elements) complex64, [tx, rx]


def add_complex_noise(rec_data, snr_db: float, seed: int = 0,
                      exclude_each_side: int = 0) -> np.ndarray:
    """Additive complex-Gaussian measurement noise at a stated SNR over the
    admitted entries (outside the +-``exclude_each_side`` ring band, the
    entries the inversion fits): ``10 log10(mean|signal|^2 /
    mean|noise|^2) = snr_db``. numpy ``default_rng(seed)``, so the same
    seed gives the reference's bits. Returns a new complex64 matrix."""
    from .qc import _pair_mask

    m = np.asarray(rec_data).astype(np.complex64)
    w = (_pair_mask(m.shape[0], exclude_each_side)
         if exclude_each_side else np.ones(m.shape, bool))
    sig_pow = float(np.mean(np.abs(m[w]) ** 2))
    noise_pow = sig_pow / (10.0 ** (snr_db / 10.0))
    rng = np.random.default_rng(seed)
    scale = np.sqrt(noise_pow / 2.0)
    noise = scale * (rng.standard_normal(m.shape)
                     + 1j * rng.standard_normal(m.shape))
    return (m + noise).astype(np.complex64)


def dataclass_replace_tx_all(acquisition: AcquisitionConfig) -> AcquisitionConfig:
    """Synthesis transmits from every element and records the full rx
    matrix (the acceptance mask is an inversion-side choice)."""
    return dataclasses.replace(acquisition, tx_downsample=1,
                               num_excluded_each_side=0)


def synthesize_ring_dataset(vel, grid: Grid2D,
                            acquisition: AcquisitionConfig = AcquisitionConfig(),
                            f: float = 0.35e6,
                            solver: SolverConfig = SolverConfig(),
                            seed: int = 0,
                            random_amplitudes: bool = True,
                            x_elem=None, y_elem=None,
                            attenuation=None,
                            device=None) -> RingDataset:
    """Simulate a full ring acquisition over the (ny, nx) speed map ``vel``
    on ``grid``; the solve runs on ``device`` (default: ``vel``'s device if
    it is a tensor, else the card, which raises when there is none; pass
    ``"cpu"`` for the plain PyTorch path)."""
    if device is None:
        device = (vel.device if isinstance(vel, torch.Tensor)
                  else default_device())
    acq = build_ring_acquisition(grid, dataclass_replace_tx_all(acquisition),
                                 x_elem=x_elem, y_elem=y_elem)
    rng = np.random.default_rng(seed)
    if random_amplitudes:
        amps = (rng.standard_normal(acq.num_tx)
                + 1j * rng.standard_normal(acq.num_tx)).astype(np.complex64)
    else:
        amps = np.ones(acq.num_tx, np.complex64)
    src = acq.source_cube(amplitudes=amps, device=device)
    vel_t = torch.as_tensor(vel, dtype=torch.float32).to(device)
    u, _ = solve_helmholtz(vel_t, src, f, grid, solver,
                           attenuation=attenuation)
    y_idx = torch.as_tensor(acq.y_idx, dtype=torch.long, device=device)
    x_idx = torch.as_tensor(acq.x_idx, dtype=torch.long, device=device)
    rec_data = u[:, y_idx, x_idx].cpu().numpy().astype(np.complex64)
    return RingDataset(
        x=grid.x.astype(np.float64), y=grid.y.astype(np.float64),
        c=np.asarray(vel_t.cpu().numpy(), np.float64),
        x_circ=acq.x_elem, y_circ=acq.y_elem, f=float(f), rec_data=rec_data)
