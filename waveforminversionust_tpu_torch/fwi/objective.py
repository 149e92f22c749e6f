"""FWI data and objective pieces (port of
``waveforminversionust_tpu.fwi.objective``): receiver sampling, adjoint
sources, source-strength estimation, the masked L2 misfit, the virtual
source, the mass spread of the exact Frechet derivative and illumination
preconditioning.

All receiver arrays are masked to the active receivers, (ntx, n_active);
receiver (tx, j) reads pixel (rx_y[tx, j], rx_x[tx, j]).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import default_device
from ..models.acquisition import RingAcquisition


class FWIData(NamedTuple):
    """Device-resident inversion inputs.

    src: (ntx, ny, nx) complex64 sources; rec_obs: (ntx, n_active)
    complex64 observed data; rx_y, rx_x: (ntx, n_active) int64 receiver
    pixels ((ntx, n_active, 4) corners in bilinear mode, with weights rx_w);
    f: frequency [Hz]; attenuation: optional fixed alpha map [Np/m].
    """

    src: torch.Tensor
    rec_obs: torch.Tensor
    rx_y: torch.Tensor
    rx_x: torch.Tensor
    f: float
    rx_w: torch.Tensor | None = None
    attenuation: torch.Tensor | None = None


def build_fwi_data(acq: RingAcquisition, rec_data: np.ndarray, f,
                   split: bool = False, attenuation=None,
                   device=None) -> FWIData:
    """FWIData from an acquisition and a recorded (tx, rx) data matrix
    (all elements, or already down-selected to ``acq.tx_include``), on
    ``device`` (default: the card, which raises when there is none; pass
    ``"cpu"`` for the CPU). ``split`` is accepted for signature parity: the
    port keeps complex64 everywhere."""
    if device is None:
        device = default_device()
    rec_data = np.asarray(rec_data)
    if rec_data.shape[0] == acq.num_tx:
        rec_rows = rec_data
    else:
        assert rec_data.shape[0] == acq.num_elements, rec_data.shape
        rec_rows = rec_data[acq.tx_include]
    rec = np.take_along_axis(rec_rows, acq.rx_indices, axis=1)

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    bilinear = acq.rx_w4 is not None
    return FWIData(
        src=t(acq.source_fields(), torch.complex64),
        rec_obs=t(rec.astype(np.complex64), torch.complex64),
        rx_y=t(acq.rx_y4 if bilinear else acq.rx_y, torch.long),
        rx_x=t(acq.rx_x4 if bilinear else acq.rx_x, torch.long),
        f=float(f),
        rx_w=t(acq.rx_w4, torch.float32) if bilinear else None,
        attenuation=(None if attenuation is None
                     else t(attenuation, torch.float32)))


def sample_receivers(fields, rx_y, rx_x, rx_w=None):
    """Gather (ntx, ny, nx) fields at the receivers -> (ntx, n_active); with
    bilinear stencils the weighted sum over the 4 enclosing pixels."""
    tx = torch.arange(fields.shape[0], device=fields.device)
    if rx_w is None:
        return fields[tx[:, None], rx_y, rx_x]
    return (fields[tx[:, None, None], rx_y, rx_x] * rx_w).sum(-1)


def scatter_to_fields(values, rx_y, rx_x, shape, rx_w=None):
    """Scatter (ntx, n_active) values onto zero (ntx, ny, nx) fields (the
    adjoint-source builder); bilinear stencils scatter-add with the
    sampling weights (the exact adjoint of bilinear sampling)."""
    ntx = values.shape[0]
    tx = torch.arange(ntx, device=values.device)
    out = torch.zeros((ntx,) + tuple(shape), dtype=values.dtype,
                      device=values.device)
    if rx_w is None:
        out[tx[:, None], rx_y, rx_x] = values
        return out
    idx = (tx[:, None, None].expand_as(rx_y), rx_y, rx_x)
    out.index_put_(idx, values[..., None] * rx_w, accumulate=True)
    return out


def estimate_source_strengths(rec_sim, rec_obs):
    """Per-transmitter least-squares source scale <u_sim, d>/<u_sim, u_sim>
    (nonlinearcg.py:14-20)."""
    num = torch.sum(torch.conj(rec_sim) * rec_obs, dim=1)
    den = torch.clamp(torch.sum(torch.abs(rec_sim) ** 2, dim=1), min=1e-38)
    return num / den


def misfit(rec_sim, rec_obs):
    """0.5 sum |u_sim - d|^2 over the active receivers."""
    return 0.5 * torch.sum(torch.abs(rec_sim - rec_obs) ** 2)


def illumination_map(wavefields):
    """sum_tx |u_tx|^2 over the (ntx, ny, nx) forward fields."""
    return torch.sum(wavefields.real ** 2 + wavefields.imag ** 2, dim=0)


def precondition_gradient(grad, illum, eps_frac):
    """grad / (illum + eps_frac * max(illum))."""
    return grad / (illum + eps_frac * torch.max(illum))


def mass_spread(fields, d, e):
    """The optimal 9-point scheme's mass-distribution stencil
    ``W = {center: 1-d-e, edges: d/4, corners: e/4}`` applied as a symmetric
    9-point correlation over the trailing (ny, nx) axes, zero outside. The
    operator carries ``C k^2`` on all nine legs, so the exact discrete
    Frechet derivative dH/dslowness spreads the virtual source with these
    weights; W is symmetric, so it is its own adjoint."""
    wc, wd, we = 1.0 - d - e, d / 4.0, e / 4.0
    pp = F.pad(fields, (1, 1, 1, 1))
    c = pp[..., 1:-1, 1:-1]
    edges = (pp[..., 1:-1, :-2] + pp[..., 1:-1, 2:]
             + pp[..., :-2, 1:-1] + pp[..., 2:, 1:-1])
    corners = (pp[..., :-2, :-2] + pp[..., :-2, 2:]
               + pp[..., 2:, :-2] + pp[..., 2:, 2:])
    return wc * c + wd * edges + we * corners


def virtual_source(slowness, wavefields, f, alpha_signed=None):
    """VIRT = dk^2/d(slowness) * u (nonlinearcg.py:120): lossless
    2 omega^2 slow u; with a fixed attenuation (k = omega slow + i sgn
    alpha) the factor is 2 omega (omega slow + i sgn alpha)."""
    omega = 2 * math.pi * float(f)
    fr = (2 * omega ** 2 * slowness)[None]
    if alpha_signed is None:
        return wavefields * fr
    fi = (2 * omega * alpha_signed)[None]
    return wavefields * torch.complex(fr, fi)
