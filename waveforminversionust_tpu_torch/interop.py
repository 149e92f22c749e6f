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
from .fwi.fwi3d import FWIData3D
from .ops.banded import BandedFactor
from .ops.cyclic import CRFactor, CRLevel
from .ops.twisted import TwistedFactor


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


def twisted_factor(coeffs_re: np.ndarray, coeffs_im: np.ndarray, m: int,
                   g=None, g_down=None, g_up=None, device=None) -> TwistedFactor:
    """The port's TwistedFactor from the planes of a ``TwistedFactorCpx``,
    in either of its layouts (each argument an (re, im) pair of arrays):

    * ``g``: the row-ordered (ny, nx, nx) inverses of the plain factor;
    * ``g_down`` / ``g_up``: the fused kernel's block-step layout,
      (nsteps + 1, nxp, nxp) each with nsteps = ny - 1 - m:
      ``g_down[i] = G_i`` for i < m, ``g_down[nsteps]`` the middle inverse,
      ``g_up[i] = B_{ny-1-i}`` for i < nsteps, padded to nxp columns and
      cropped here.
    """
    coeffs = complex_tensor(coeffs_re, coeffs_im, device)
    ny, nx = coeffs.shape[1], coeffs.shape[2]
    if g is not None:
        rows = complex_tensor(g[0], g[1], device)
    else:
        down = complex_tensor(g_down[0], g_down[1])[:, :nx, :nx]
        up = complex_tensor(g_up[0], g_up[1])[:, :nx, :nx]
        nsteps = down.shape[0] - 1
        if nsteps != ny - 1 - m:
            raise ValueError(f"g_down holds {nsteps} steps, ny - 1 - m = "
                             f"{ny - 1 - m}")
        rows = torch.cat([down[:m], down[nsteps:nsteps + 1],
                          torch.flip(up[:nsteps], dims=(0,))]).to(device)
    if rows.shape != (ny, nx, nx):
        raise ValueError(f"g shape {tuple(rows.shape)} != {(ny, nx, nx)}")
    return TwistedFactor(g=rows.contiguous(), coeffs=coeffs, m=int(m))


def cr_factor(levels, dinv_root, coeffs_re: np.ndarray,
              coeffs_im: np.ndarray, device=None) -> CRFactor:
    """The port's CRFactor from a ``CRFactor`` of the JAX package:
    ``levels`` a sequence of levels, each the five (re, im) pairs of a
    ``CRLevel`` in field order (dinv, lt, ut, dl, du); ``dinv_root`` an
    (re, im) pair."""
    return CRFactor(
        levels=tuple(CRLevel(*(complex_tensor(re, im, device)
                               for re, im in level)) for level in levels),
        dinv_root=complex_tensor(dinv_root[0], dinv_root[1], device),
        coeffs=complex_tensor(coeffs_re, coeffs_im, device))


def inversion_state(state: dict) -> dict:
    """The port's checkpoint dict (:mod:`.utils.checkpoint`) from the numpy
    dict that the JAX package's ``utils.checkpoint.load_state`` returns, so
    that a run checkpointed by the JAX package resumes in the port's
    ``invert_dataset(resume_from=...)`` once saved with the port's
    ``save_state``: the (ny, nx) fields float32, stage and iteration int32,
    the frequency float64, the metrics histories float32."""

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype))

    out = {"velocity": t(state["velocity"], np.float32),
           "stage": t(state["stage"], np.int32),
           "iteration": t(state["iteration"], np.int32)}
    for key in ("search_dir", "grad_prev"):
        if key in state:
            out[key] = t(state[key], np.float32)
    if "frequency" in state:
        out["frequency"] = t(state["frequency"], np.float64)
    if "metrics" in state:
        out["metrics"] = {k: t(v, np.float32)
                          for k, v in state["metrics"].items()}
    return out


def velocity_3d(vel: np.ndarray, device=None) -> torch.Tensor:
    """An (nz, ny, nx) float32 tensor from a speed volume of the JAX
    package (numpy)."""
    return torch.from_numpy(np.array(vel, dtype=np.float32)).to(device)


def fwi_data_3d(src, rec_obs, rx_idx: np.ndarray, f, attenuation=None,
                rec_ref=None, device=None) -> FWIData3D:
    """The port's FWIData3D from the fields of the JAX package's one:
    ``src``, ``rec_obs`` and ``rec_ref`` each the (re, im) pair of a
    ``Cpx`` as numpy planes (``rec_ref`` None outside scattered-field
    mode), ``rx_idx`` (ntx, n_active, 3), ``f`` its float32 frequency and
    ``attenuation`` an optional (nz, ny, nx) alpha map."""
    return FWIData3D(
        src=complex_tensor(*src, device=device),
        rec_obs=complex_tensor(*rec_obs, device=device),
        rx_idx=torch.from_numpy(np.array(rx_idx, dtype=np.int64)).to(device),
        f=float(np.float32(f)),
        attenuation=(None if attenuation is None
                     else velocity_3d(attenuation, device)),
        rec_ref=None if rec_ref is None else complex_tensor(*rec_ref,
                                                            device=device))
