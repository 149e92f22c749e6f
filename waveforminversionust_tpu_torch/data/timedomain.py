"""Multi-frequency sweeps, time-domain synthesis and the broadband ring
acquisition chain (port of ``waveforminversionust_tpu.data.timedomain``,
2D, complex64 only).

Solve the Helmholtz equation over a comb of frequencies, weight by a
spectral window and synthesize time-domain wavefields or channel traces by
an inverse discrete-time Fourier transform (reference:
Lecture19_Fwi/TimeDomainSimulation.m). The JAX package scans the solve over
the comb; here the comb is a host loop, one factorization a line, each
solve batched over every transmitter (the CUDA factor and sweep kernels
on the card). The IDTFT is one dense complex product, a ``torch.matmul``.
Extraction and gating are host-side numpy, as in the JAX package.

The entry points take ``device=`` and run on the card unless the caller
asks for the CPU; the traces leave as numpy, (ntx, nrx, nt).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import AcquisitionConfig, SolverConfig
from ..device import default_device, resolve_device as _device
from ..models.acquisition import (build_ring_acquisition, ring_positions,
                                  snap_to_grid)
from ..models.grid import Grid2D
from ..ops.solve import solve_helmholtz
from .synthesize import RingDataset, dataclass_replace_tx_all


def hanning_window(n: int) -> np.ndarray:
    """MATLAB-style symmetric Hann window without zero endpoints:
    w[k] = 0.5 (1 - cos(2 pi k/(n+1))), k = 1..n (TimeDomainSimulation.m:34
    uses hanning(numel(f)))."""
    k = np.arange(1, n + 1)
    return 0.5 * (1 - np.cos(2 * np.pi * k / (n + 1)))


def frequency_sweep(vel, src, freqs, grid: Grid2D,
                    solver: SolverConfig = SolverConfig(), device=None):
    """Solve the Helmholtz equation at each frequency for one source field
    (one transmit element; TimeDomainSimulation.m:39-46).

    ``vel`` (ny, nx), ``src`` (ny, nx) complex, ``freqs`` (nf,) [Hz].
    Returns (nf, ny, nx) complex64 wavefields on ``device`` (default:
    ``vel``'s if it is a tensor, else the card)."""
    device = _device(vel, device)
    vel = torch.as_tensor(vel, dtype=torch.float32).to(device)
    src_b = torch.as_tensor(src).to(device=device, dtype=torch.complex64)[None]
    return torch.stack([solve_helmholtz(vel, src_b, float(f), grid,
                                        solver)[0][0]
                        for f in np.asarray(freqs, np.float32)])


def inverse_dtft_matrix(freqs, times, df, device=None) -> torch.Tensor:
    """IDTFT synthesis matrix exp(+i 2 pi f t) df, (nt, nf) complex64
    (TimeDomainSimulation.m:54), phases formed in float32 as in the JAX
    package; on ``device`` (default: the card)."""
    device = default_device() if device is None else device
    f = torch.as_tensor(np.asarray(freqs, np.float32), device=device)
    t = torch.as_tensor(np.asarray(times, np.float32), device=device)
    ph = (2 * math.pi * f)[None, :] * t[:, None]
    return torch.polar(torch.ones_like(ph), ph) * df


def synthesize_time_fields(fields_f, freqs, times, df, spectrum):
    """Time-domain wavefields from frequency-domain solves:
    wv_t[t] = sum_f exp(i 2 pi f t) df spectrum[f] wv_f[f], one dense
    (nt, nf) @ (nf, ny*nx) complex product on ``fields_f``'s device
    (TimeDomainSimulation.m:53-56)."""
    nf, ny, nx = fields_f.shape
    idtft = inverse_dtft_matrix(freqs, times, df, device=fields_f.device)
    w = torch.as_tensor(np.asarray(spectrum, np.float32),
                        device=fields_f.device)
    weighted = fields_f * w[:, None, None]
    return (idtft @ weighted.reshape(nf, ny * nx)).reshape(-1, ny, nx)


# ---------------------------------------------------------------------------
# The broadband ring acquisition: synthesize (tx, rx, t) channel traces over
# a frequency comb, then extract any inversion frequencies from the traces
# as the {frequency: RingDataset} mapping invert_dataset takes for
# multi-frequency continuation. Extraction needs no source-spectrum
# deconvolution for FWI: the objective's per-shot source estimate absorbs
# any per-frequency complex scale.
# ---------------------------------------------------------------------------

class TimeDomainDataset(NamedTuple):
    """Broadband ring acquisition: complex analytic channel traces for
    every transmit element, with the synthesis comb (the time-domain
    analogue of :class:`~.synthesize.RingDataset`; numpy arrays)."""

    x: np.ndarray        # (nx,) simulation-grid x coords [m]
    y: np.ndarray        # (ny,)
    c: np.ndarray        # (ny, nx) true sound speed [m/s]
    x_circ: np.ndarray   # (num_elements,) element x [m]
    y_circ: np.ndarray   # (num_elements,)
    freqs: np.ndarray    # (nf,) synthesis frequency comb [Hz]
    df: float            # comb spacing [Hz]
    spectrum: np.ndarray  # (nf,) transmit spectral weights
    times: np.ndarray    # (nt,) uniform over one comb period 1/df
    traces: np.ndarray   # (num_elements, num_elements, nt) complex64 [tx,rx,t]


def _sweep_record(vel, src, freqs, rx_y, rx_x, grid: Grid2D,
                  solver: SolverConfig) -> torch.Tensor:
    """Receiver data at every comb frequency, (nf, ntx, nrx) complex64: one
    batched multi-RHS solve (one factorization) a comb line."""
    ntx = src.shape[0]
    tx = torch.arange(ntx, device=src.device)[:, None]
    return torch.stack([solve_helmholtz(vel, src, float(f), grid,
                                        solver)[0][tx, rx_y[None], rx_x[None]]
                        for f in np.asarray(freqs, np.float32)])


def _traces_from_comb(rec, freqs, times, weights) -> torch.Tensor:
    """IDTFT of the weighted comb: traces[t] = sum_f w_f REC_f e^{+2 pi i f
    t}, one (nt, nf) x (nf, ntx*nrx) complex product; (nt, ntx, nrx)."""
    nf, ntx, nrx = rec.shape
    f = torch.as_tensor(np.asarray(freqs, np.float32), device=rec.device)
    t = torch.as_tensor(np.asarray(times, np.float32), device=rec.device)
    w = torch.as_tensor(np.asarray(weights, np.float32), device=rec.device)
    ph = (2 * math.pi * f)[None, :] * t[:, None]               # (nt, nf)
    kern = torch.polar(w[None, :].expand_as(ph), ph)
    return (kern @ rec.reshape(nf, ntx * nrx)).reshape(-1, ntx, nrx)


def synthesize_time_domain_dataset(
        vel, grid: Grid2D,
        acquisition=None,
        f_low: float = 0.25e6, f_high: float = 0.45e6, df: float = 0.025e6,
        nt: int | None = None,
        solver: SolverConfig = SolverConfig(),
        seed: int = 0, random_amplitudes: bool = True,
        x_elem=None, y_elem=None, device=None) -> TimeDomainDataset:
    """Simulate broadband (tx, rx, t) channel data over a known speed map.

    Every element transmits (one multi-RHS batch, like
    :func:`~.synthesize.synthesize_ring_dataset`, with the same seeded
    amplitudes); the Helmholtz equation is solved on the comb
    ``f_low..f_high`` step ``df`` and the complex analytic traces come from
    one IDTFT product with Hann spectral weighting.

    The time axis is the DFT grid of one comb period, ``t_k = k/(nt df)``,
    ``k < nt``: on it the comb lines are orthogonal, so
    :func:`extract_frequency_data` recovers each line's receiver matrix to
    round-off (``nt`` defaults to ``4 nf``; any ``nt >= nf`` keeps that).
    The solves run on ``device`` (default: ``vel``'s if it is a tensor,
    else the card)."""
    acquisition = (acquisition if acquisition is not None
                   else AcquisitionConfig())
    device = _device(vel, device)
    freqs = np.arange(f_low, f_high + df / 2, df)
    nf = len(freqs)
    if nt is None:
        nt = 4 * nf
    if nt < nf:
        raise ValueError(f"nt={nt} < nf={nf}: comb lines alias; extraction "
                         "would mix frequencies")
    times = np.arange(nt) / (nt * df)
    spectrum = hanning_window(nf)

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
    rec = _sweep_record(
        vel_t, src, freqs,
        torch.as_tensor(acq.y_idx, dtype=torch.long, device=device),
        torch.as_tensor(acq.x_idx, dtype=torch.long, device=device),
        grid, solver)
    traces = _traces_from_comb(rec, freqs, times, spectrum * df)
    traces = np.moveaxis(traces.cpu().numpy().astype(np.complex64), 0, -1)

    return TimeDomainDataset(
        x=grid.x.astype(np.float64), y=grid.y.astype(np.float64),
        c=np.asarray(vel_t.cpu().numpy(), np.float64),
        x_circ=acq.x_elem, y_circ=acq.y_elem,
        freqs=freqs, df=float(df), spectrum=spectrum, times=times,
        traces=traces)


def extract_frequency_data(traces, times, freqs, df,
                           spectrum=None) -> np.ndarray:
    """Per-frequency receiver matrices from channel traces: the DFT
    quadrature ``REC_f = mean_t traces(t) e^{-2 pi i f t} / df`` (numpy, on
    the host).

    On the synthesis DFT time grid this inverts the synthesis exactly for
    any comb line; for measured traces it is the standard narrowband bin
    extraction. ``spectrum``: the per-frequency transmit weights to divide
    out, or None to let the FWI objective's per-shot source estimate absorb
    the scale (for real traces the one-sided extraction returns
    spectrum * REC / 2).

    Args:
        traces: (..., nt) complex or real.
        times: (nt,) uniform sample times spanning one period 1/df.
        freqs: scalar or (nf_out,) frequencies to extract [Hz].
        df: comb spacing / frequency resolution [Hz].

    Returns:
        (nf_out, ...) complex64 receiver data.
    """
    traces = np.asarray(traces)
    t = np.asarray(times, np.float64)
    f = np.atleast_1d(np.asarray(freqs, np.float64))
    kern = np.exp(-2j * np.pi * f[:, None] * t[None, :]) / (len(t) * df)
    rec = np.einsum("ft,...t->f...", kern, traces)
    if spectrum is not None:
        s = np.atleast_1d(np.asarray(spectrum, np.float64))
        rec /= s.reshape((-1,) + (1,) * (rec.ndim - 1))
    return rec.astype(np.complex64)


def direct_arrival_gate(td: TimeDomainDataset, c_ref: float = 1500.0,
                        pre: float = 3e-6, post: float = 8e-6,
                        taper: float = 2e-6) -> TimeDomainDataset:
    """Cosine-tapered time gate around the direct transmission arrival (the
    UST preprocessing that isolates through-transmission energy from late
    reverberation before extraction; numpy, on the host).

    For each (tx, rx) pair the arrival is the straight-ray estimate
    ``|x_tx - x_rx| / c_ref``; the gate passes ``[t_arr - pre, t_arr +
    post]`` with half-cosine roll-offs of width ``taper``. The comb traces
    are periodic with period T = 1/df, so the gate is built on the circular
    offset ``((t - t_arr + T/2) mod T) - T/2``, which wraps both distant
    pairs and the window's edges. ``taper=0`` gives a hard gate; a window
    (``pre + post + 2 taper``) that does not fit in one period raises
    ``ValueError``. Returns a new dataset with gated traces."""
    pos = np.stack([td.x_circ, td.y_circ], axis=1)           # (ne, 2)
    w = _circular_gate_window(pos, td.times, td.df, c_ref, pre, post, taper)
    return td._replace(traces=(td.traces * w).astype(td.traces.dtype))


def _circular_gate_window(pos, times, df, c_ref, pre, post, taper):
    """(ne, ne, nt) circular cosine-tapered gate weights around the
    straight-ray arrival between every element pair."""
    if taper < 0 or pre < 0 or post < 0:
        raise ValueError("pre/post/taper must be non-negative")
    period = 1.0 / float(df)
    if pre + post + 2 * taper >= period:
        raise ValueError(
            f"gate window pre+post+2*taper = {pre + post + 2 * taper:.3g} s "
            f"does not fit in one comb period 1/df = {period:.3g} s")
    pos = np.asarray(pos, np.float64)
    dist = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    t_arr = (dist / c_ref)[..., None]                        # (ntx, nrx, 1)
    t = np.asarray(times)[None, None, :]
    # signed circular offset from the (wrapped) arrival, in [-T/2, T/2)
    d = np.mod(t - t_arr + 0.5 * period, period) - 0.5 * period
    d = d.astype(np.float32)
    if taper == 0.0:
        return ((d >= np.float32(-pre))
                & (d <= np.float32(post))).astype(np.float32)
    up = np.clip((d + np.float32(pre + taper)) / np.float32(taper),
                 np.float32(0), np.float32(1))
    dn = np.clip((np.float32(post + taper) - d) / np.float32(taper),
                 np.float32(0), np.float32(1))
    return ((0.5 * (1 - np.cos(np.pi * up)))
            * (0.5 * (1 - np.cos(np.pi * dn)))).astype(np.float32)


def timedomain_to_ring_datasets(td: TimeDomainDataset, freqs,
                                deconvolve: bool = True) -> dict:
    """Extract ``freqs`` from the traces as the ``{frequency: RingDataset}``
    mapping :func:`~..fwi.runner.invert_dataset` takes for multi-frequency
    continuation.

    ``deconvolve=True`` divides out the synthesis spectrum at each
    extracted comb line (the frequencies must sit on the comb: an exact
    round trip); ``False`` leaves the spectral scale in the data, the
    measured-data regime, absorbed by source estimation."""
    freqs = np.atleast_1d(np.asarray(freqs, np.float64))
    spec = None
    if deconvolve:
        line = np.rint((freqs - td.freqs[0]) / td.df).astype(int)
        on_comb = (np.abs(freqs - (td.freqs[0] + line * td.df)) < td.df * 1e-3)
        if not (on_comb.all() and (line >= 0).all()
                and (line < len(td.freqs)).all()):
            raise ValueError(f"deconvolve=True needs comb frequencies "
                             f"{td.freqs[0]}..{td.freqs[-1]} step {td.df}; "
                             f"got {freqs}")
        spec = td.spectrum[line]
    rec = extract_frequency_data(td.traces, td.times, freqs, td.df, spec)
    return {float(f): RingDataset(x=td.x, y=td.y, c=td.c,
                                  x_circ=td.x_circ, y_circ=td.y_circ,
                                  f=float(f), rec_data=rec[i])
            for i, f in enumerate(freqs)}


class TimeDomainResult(NamedTuple):
    times: np.ndarray            # (nt,)
    freqs: np.ndarray            # (nf,)
    wavefields_t: torch.Tensor   # (nt, ny, nx) complex64 (on the device)
    channel_data: np.ndarray     # (nt, num_elements) complex


def simulate_time_domain(vel, grid: Grid2D, element_idx: int = 64,
                         f_low: float = 0.1e6, f_high: float = 0.5e6,
                         df: float = 0.005e6, nt: int = 501,
                         num_elements: int = 256, radius: float = 110e-3,
                         c_ref: float = 1500.0,
                         solver: SolverConfig = SolverConfig(),
                         device=None) -> TimeDomainResult:
    """The reference's time-domain demo (TimeDomainSimulation.m:8-56):
    0.1-0.5 MHz in 5 kHz steps, Hann spectral weighting, time axis [0,
    2 xmax / c_ref], one ring element transmitting, channel data recorded
    at every element. Runs on ``device`` (default: ``vel``'s if it is a
    tensor, else the card)."""
    device = _device(vel, device)
    freqs = np.arange(f_low, f_high + df / 2, df)
    xmax = max(abs(grid.extent[0]), abs(grid.extent[1]))
    times = np.linspace(0.0, 2 * xmax / c_ref, nt)
    window = hanning_window(len(freqs))

    xe, ye = ring_positions(num_elements, radius)
    x_idx, y_idx = snap_to_grid(grid, xe, ye)
    src = np.zeros(grid.shape, np.complex64)
    src[y_idx[element_idx], x_idx[element_idx]] = 1.0

    fields_f = frequency_sweep(vel, src, freqs, grid, solver, device=device)
    fields_t = synthesize_time_fields(fields_f, freqs, times, df, window)
    channel = fields_t[:, torch.as_tensor(y_idx, dtype=torch.long,
                                          device=device),
                       torch.as_tensor(x_idx, dtype=torch.long,
                                       device=device)]
    return TimeDomainResult(times=times, freqs=freqs, wavefields_t=fields_t,
                            channel_data=channel.cpu().numpy())
