"""The 3D broadband acquisition chain (port of
``waveforminversionust_tpu.data.timedomain3d``), the volumetric analogue
of :mod:`.timedomain`.

Synthesizes full-aperture (tx, rx, t) channel traces for a cylindrical or
hemispherical array by sweeping the 3D convergent Born solver over a
frequency comb (a host loop, one batched solve of every transmitter a
line) and one IDTFT product, then extracts frequencies from the traces
into per-frequency :class:`~..fwi.fwi3d.FWIData3D` for the 3D inversion.
The comb, the IDTFT, extraction and gating are the 2D module's.

The entry points take ``device=`` and run on the card unless the caller
asks for the CPU; the traces leave as numpy, (ntx, nrx, nt).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import PMLConfig
from ..models.acquisition3d import build_acquisition3d, snap_to_grid3d
from ..models.grid3d import Grid3D
from .timedomain import (_circular_gate_window, _device, _traces_from_comb,
                         extract_frequency_data, hanning_window)


class TimeDomainDataset3D(NamedTuple):
    """Broadband 3D acquisition (numpy): complex analytic channel traces of
    every transmit element at every element (full aperture; acceptance
    masking happens downstream), with the comb."""

    c: np.ndarray           # (nz, ny, nx) true sound speed [m/s]
    positions: np.ndarray   # (n_elements, 3) requested element xyz [m]
    # (n_elements, 3) element xyz snapped to the synthesis grid, where the
    # one-hot sources and receivers live.
    positions_snapped: np.ndarray
    freqs: np.ndarray       # (nf,) synthesis frequency comb [Hz]
    df: float               # comb spacing [Hz]
    spectrum: np.ndarray    # (nf,) transmit spectral weights
    times: np.ndarray       # (nt,) uniform over one comb period 1/df
    traces: np.ndarray      # (n_elements, n_elements, nt) complex64 [tx,rx,t]


def _sweep_record_3d(vel, src, freqs, rx_idx, grid: Grid3D, pml: PMLConfig,
                     solver3d: str, iter_cap: int, gmres_tol: float,
                     gmres_restart: int, spectral: str, attenuation=None):
    """Receiver data at every comb frequency, (nf, ntx, nrx) complex64: one
    batched multi-RHS 3D solve a line (the JAX package's ``lax.scan`` over
    the comb, as a host loop)."""
    from ..fwi.fwi3d import _make_solve_3d

    solve = _make_solve_3d(grid, pml, iter_cap, solver3d=solver3d,
                           gmres_tol=gmres_tol, gmres_restart=gmres_restart,
                           spectral=spectral)
    iz, iy, ix = rx_idx[:, 0], rx_idx[:, 1], rx_idx[:, 2]
    return torch.stack([solve(vel, src, float(f),
                              attenuation=attenuation)[0][:, iz, iy, ix]
                        for f in np.asarray(freqs, np.float32)])


def synthesize_time_domain_dataset_3d(
        vel, grid: Grid3D, positions,
        f_low: float = 0.25e6, f_high: float = 0.45e6, df: float = 0.025e6,
        nt: int | None = None,
        solver3d: str = "gmres", iter_cap: int = 2000,
        gmres_tol: float = 1e-5, gmres_restart: int = 16,
        spectral: str = "auto",
        pml: PMLConfig = PMLConfig(a0=20.0, l_pml=12e-3),
        seed: int = 0, random_amplitudes: bool = True,
        attenuation=None, device=None) -> TimeDomainDataset3D:
    """Simulate broadband (tx, rx, t) channel data over a known volume.

    Every element transmits (one batch, with seeded random complex
    amplitudes shared across the band, ``np.random.default_rng(seed)`` as
    in the JAX package); the 3D Helmholtz equation is solved on the comb
    ``f_low..f_high`` step ``df`` (GMRES on the CBS system by default) and
    the traces come from one IDTFT product with Hann weighting. On the
    comb's DFT time grid (``nt >= nf``, default ``4 nf``) extraction
    inverts the synthesis to round-off. Runs on ``device`` (default:
    ``vel``'s if it is a tensor, else the card).

    Args:
        vel: (nz, ny, nx) true speed volume [m/s].
        positions: (n_elements, 3) element xyz [m].
        solver3d: "gmres" or "cbs" (the plain series).
        attenuation: optional (nz, ny, nx) alpha [Np/m].
    """
    device = _device(vel, device)
    pos = np.asarray(positions, np.float64)
    n = pos.shape[0]
    freqs = np.arange(f_low, f_high + df / 2, df)
    nf = len(freqs)
    if nt is None:
        nt = 4 * nf
    if nt < nf:
        raise ValueError(f"nt={nt} < nf={nf}: comb lines alias; extraction "
                         "would mix frequencies")
    times = np.arange(nt) / (nt * df)
    spectrum = hanning_window(nf)

    idx = snap_to_grid3d(grid, pos)                      # (n, 3) iz, iy, ix
    pos_snap = np.stack([grid.x[idx[:, 2]], grid.y[idx[:, 1]],
                         grid.z[idx[:, 0]]], axis=1)

    rng = np.random.default_rng(seed)
    if random_amplitudes:
        amps = (rng.standard_normal(n)
                + 1j * rng.standard_normal(n)).astype(np.complex64)
    else:
        amps = np.ones(n, np.complex64)
    src = np.zeros((n,) + grid.shape, np.complex64)
    src[np.arange(n), idx[:, 0], idx[:, 1], idx[:, 2]] = amps

    vel_t = torch.as_tensor(vel, dtype=torch.float32).to(device)
    rec = _sweep_record_3d(
        vel_t, torch.as_tensor(src, device=device), freqs,
        torch.as_tensor(idx, dtype=torch.long, device=device), grid, pml,
        str(solver3d), int(iter_cap), float(gmres_tol), int(gmres_restart),
        str(spectral),
        attenuation=(None if attenuation is None else torch.as_tensor(
            attenuation, dtype=torch.float32).to(device)))
    traces = _traces_from_comb(rec, freqs, times, spectrum * df)
    traces = np.moveaxis(traces.cpu().numpy().astype(np.complex64), 0, -1)

    return TimeDomainDataset3D(
        c=np.asarray(vel_t.cpu().numpy(), np.float64), positions=pos,
        positions_snapped=pos_snap, freqs=freqs, df=float(df),
        spectrum=spectrum, times=times, traces=traces)


def direct_arrival_gate_3d(td: TimeDomainDataset3D, c_ref: float = 1500.0,
                           pre: float = 3e-6, post: float = 8e-6,
                           taper: float = 2e-6) -> TimeDomainDataset3D:
    """Cosine-tapered circular time gate around the straight-ray direct
    arrival between the snapped element positions (the semantics of
    :func:`.timedomain.direct_arrival_gate`; numpy)."""
    w = _circular_gate_window(td.positions_snapped, td.times, td.df,
                              c_ref, pre, post, taper)
    return td._replace(traces=(td.traces * w).astype(td.traces.dtype))


def timedomain_to_fwi_data_3d(td: TimeDomainDataset3D, freqs, grid: Grid3D,
                              min_angle: float = 0.5,
                              attenuation=None, deconvolve: bool = False,
                              device=None):
    """Extract ``freqs`` from the traces as per-frequency 3D datasets.

    Extraction is exact on the comb (standard narrowband bins elsewhere);
    the angular acceptance mask picks each transmitter's receivers; each
    gather is normalized to unit RMS and the one-hot sources are scaled by
    1e6, so that squared misfits and fields stay in FP32's normal range
    (the per-shot source estimate absorbs both scales).
    ``deconvolve=True`` divides out the synthesis spectrum (comb lines
    only). The datasets live on ``device`` (default: the card).

    Returns:
        (acq: Acquisition3D, datasets: list[FWIData3D]), one dataset per
        requested frequency.
    """
    from ..fwi.fwi3d import build_fwi_data_3d

    f = np.atleast_1d(np.asarray(freqs, np.float64))
    spec = None
    if deconvolve:
        comb = np.asarray(td.freqs, np.float64)
        pick = np.argmin(np.abs(comb[None, :] - f[:, None]), axis=1)
        if not np.allclose(comb[pick], f, rtol=0, atol=td.df * 1e-3):
            raise ValueError("deconvolve=True needs frequencies on the "
                             "synthesis comb (known spectrum)")
        spec = np.asarray(td.spectrum, np.float64)[pick]
    rec = extract_frequency_data(td.traces, td.times, f, td.df,
                                 spectrum=spec)           # (nf, ntx, nrx)

    acq = build_acquisition3d(grid, td.positions, min_angle=min_angle)
    tx = np.arange(acq.n_elements)[:, None]
    datasets = []
    for i, fi in enumerate(f):
        g = rec[i][tx, acq.rx_elem]
        rms = np.sqrt(np.mean(np.abs(g) ** 2))
        if rms > 0:
            g = g / rms
        d = build_fwi_data_3d(acq, g.astype(np.complex64), float(fi), grid,
                              attenuation=attenuation, device=device)
        datasets.append(d._replace(src=d.src * 1e6))
    return acq, datasets
