"""Carry arrays from the JAX package into the port's tensors.

The JAX package keeps complex data either as complex numpy/JAX arrays or,
in its split engine, as (re, im) float32 plane pairs (``ops.cpx.Cpx``). These
helpers take the numpy side of such objects (call ``np.asarray`` on each
plane first) and return the port's ``torch.complex64`` tensors. They take
numpy arrays only and never import JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .data.synthesize import RingDataset
from .ops.banded import BandedFactor


def complex_tensor(re: np.ndarray, im: np.ndarray | None = None,
                   device=None) -> torch.Tensor:
    """complex64 tensor from (re, im) planes, or from one complex/real
    numpy array when ``im`` is None."""
    if im is None:
        z = np.asarray(re).astype(np.complex64)
    else:
        z = (np.asarray(re, np.float32) + 1j * np.asarray(im, np.float32)
             ).astype(np.complex64)
    return torch.from_numpy(z).to(device)


def ring_dataset(x: np.ndarray, y: np.ndarray, c: np.ndarray,
                 x_circ: np.ndarray, y_circ: np.ndarray, f: float,
                 rec_data: np.ndarray) -> RingDataset:
    """The port's RingDataset from the fields of the JAX package's one."""
    return RingDataset(
        x=np.asarray(x, np.float64), y=np.asarray(y, np.float64),
        c=np.asarray(c, np.float64), x_circ=np.asarray(x_circ, np.float64),
        y_circ=np.asarray(y_circ, np.float64), f=float(f),
        rec_data=np.asarray(rec_data).astype(np.complex64))


def banded_factor(g_re: np.ndarray, g_im: np.ndarray, coeffs_re: np.ndarray,
                  coeffs_im: np.ndarray, device=None) -> BandedFactor:
    """The port's BandedFactor from a ``BandedFactorCpx``'s G planes
    (ny, nx, nx) and coefficient planes (9, ny, nx)."""
    return BandedFactor(g=complex_tensor(g_re, g_im, device),
                        coeffs=complex_tensor(coeffs_re, coeffs_im, device))
