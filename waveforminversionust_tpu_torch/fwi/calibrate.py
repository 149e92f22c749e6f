"""Background (water) sound-speed calibration and receiver sensitivities
from the recorded data (port of ``waveforminversionust_tpu.fwi.calibrate``).

After per-shot variable projection of the unknown source strengths, the
homogeneous-medium misfit J(c) has a sharp minimum at the background speed,
because the transmit-receive paths are water-dominated. A multi-level zoom
over a candidate ladder plus a parabolic fit of the discrete minimum gives
the starting speed of the inversion (the reference hardcodes 1480 m/s:
fwi_script.py:90).

Each candidate is one forward solve of all transmitters through the port's
``solve_helmholtz`` (under ``factorization="auto"`` on the card: the CUDA
factor kernel, then the sweep kernel), then the receiver gather and the
source-strength projection on the same device; in 3D
(:func:`calibrate_background_speed_3d`) each candidate is one homogeneous
spectral 3D solve, where no kernel runs. The receiver-sensitivity fixed
point stays host-side numpy in complex128, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import AcquisitionConfig, SolverConfig
from ..device import default_device
from ..models.acquisition import build_ring_acquisition
from ..models.grid import Grid2D
from ..ops.solve import solve_helmholtz
from .objective import (FWIData, build_fwi_data, estimate_source_strengths,
                        misfit, sample_receivers)


class CalibrationResult(NamedTuple):
    """Outcome of :func:`calibrate_background_speed`.

    Attributes:
        c0: calibrated background speed [m/s] (parabolic sub-grid estimate).
        candidates: (n,) all candidate speeds evaluated, sorted ascending.
        misfits: (n,) relative misfit ``J(c) / (0.5 sum |d|^2)`` per candidate.
        c_grid_best: best discrete candidate (argmin of ``misfits`` over all
            levels' candidates).
    """

    c0: float
    candidates: np.ndarray
    misfits: np.ndarray
    c_grid_best: float


def background_misfit_fn(data: FWIData, grid: Grid2D,
                         solver: SolverConfig = SolverConfig()):
    """``J(c)``: the relative data misfit of a homogeneous medium at speed
    ``c`` [m/s], with per-shot source strengths projected out (the same
    variable projection as the CG loop, so J is on the inversion's loss
    scale), on the device of ``data``. Returns a 0-d tensor."""
    device = data.src.device

    def J(c):
        vel = torch.full(grid.shape, float(c), dtype=torch.float32,
                         device=device)
        u, _ = solve_helmholtz(vel, data.src, data.f, grid, solver,
                               attenuation=data.attenuation)
        rec = sample_receivers(u, data.rx_y, data.rx_x, data.rx_w)
        rec = rec * estimate_source_strengths(rec, data.rec_obs)[:, None]
        obs_energy = 0.5 * torch.sum(
            torch.real(torch.conj(data.rec_obs) * data.rec_obs))
        return misfit(rec, data.rec_obs) / torch.clamp(obs_energy, min=1e-38)

    return J


def _parabolic_min(c3, j3):
    """Vertex of the parabola through three (c, J) points; the middle point
    when the fit is degenerate, clipped to the bracket when the vertex
    escapes it (the discrete minimum was at an edge)."""
    (c0, c1, c2), (j0, j1, j2) = c3, j3
    denom = (c1 - c0) * (j1 - j2) - (c1 - c2) * (j1 - j0)
    if abs(denom) < 1e-30:
        return float(c1)
    c_star = c1 - 0.5 * ((c1 - c0) ** 2 * (j1 - j2)
                         - (c1 - c2) ** 2 * (j1 - j0)) / denom
    lo, hi = min(c0, c2), max(c0, c2)
    return float(np.clip(c_star, lo, hi))


def calibrate_background_speed(dataset=None, *, grid: Grid2D | None = None,
                               acquisition: AcquisitionConfig = AcquisitionConfig(),
                               solver: SolverConfig = SolverConfig(),
                               c_min: float = 1400.0, c_max: float = 1600.0,
                               num: int = 9, levels: int = 2,
                               data: FWIData | None = None,
                               attenuation=None,
                               device=None) -> CalibrationResult:
    """Estimate the background (water) sound speed from recorded ring data.

    Each level evaluates ``num`` equally spaced candidates over the current
    bracket, then zooms the bracket to one grid step around the discrete
    minimum; the last level's three points around it get a parabolic
    sub-grid fit: ``levels * num`` forward solves.

    Args:
        dataset: a :class:`~..data.synthesize.RingDataset` (anything with
            ``.x_circ/.y_circ/.f/.rec_data``), or pass a prebuilt ``data=``
            :class:`FWIData` (then ``grid`` is required, ``acquisition`` is
            ignored and the solves run on the data's device). Use
            ``AcquisitionConfig(tx_downsample=...)`` to calibrate on a
            transmitter subset.
        grid: reconstruction grid (default: the reference's 301x301).
        c_min / c_max / num / levels: search bracket and resolution; the
            bracket guards against the cycle-skip side lobes a few percent
            away from the truth.
        attenuation: optional known alpha map [Np/m] (or a scalar).
        device: where the data is built and solved when it is built here
            (default: the card, which raises when there is none; pass
            ``"cpu"`` for the plain PyTorch path).
    """
    if data is None:
        if dataset is None:
            raise ValueError("pass a dataset or a prebuilt data=FWIData")
        if device is None:
            device = default_device()
        from .runner import default_inversion_grid
        grid = grid or default_inversion_grid()
        acq = build_ring_acquisition(grid, acquisition,
                                     x_elem=dataset.x_circ,
                                     y_elem=dataset.y_circ)
        if attenuation is not None and np.ndim(attenuation) == 0:
            attenuation = np.full(grid.shape, float(attenuation), np.float32)
        data = build_fwi_data(acq, dataset.rec_data, dataset.f,
                              attenuation=attenuation, device=device)
    elif grid is None:
        raise ValueError("data= requires grid=")
    if num < 3:
        raise ValueError("num must be >= 3 for the parabolic refinement")
    return _zoom_search(background_misfit_fn(data, grid, solver),
                        c_min, c_max, num, levels)


def _zoom_search(J, c_min, c_max, num, levels) -> CalibrationResult:
    """Multi-level zoom grid search over a scalar misfit J(c). The zoomed
    bracket is clipped to [c_min, c_max] at every level: an argmin on a
    bracket endpoint must not take later levels outside the stated
    physical range."""
    all_c: list[float] = []
    all_j: list[float] = []
    lo, hi = float(c_min), float(c_max)
    cs = js = None
    for _ in range(max(1, int(levels))):
        cs = np.linspace(lo, hi, int(num))
        js = np.array([float(J(c)) for c in cs])
        all_c.extend(cs.tolist())
        all_j.extend(js.tolist())
        k = int(np.argmin(js))
        step = cs[1] - cs[0]
        lo = max(cs[k] - step, float(c_min))
        hi = min(cs[k] + step, float(c_max))
    k = int(np.argmin(js))
    k = min(max(k, 1), len(cs) - 2)
    c0 = _parabolic_min(cs[k - 1:k + 2], js[k - 1:k + 2])
    all_c_arr = np.asarray(all_c)
    all_j_arr = np.asarray(all_j)
    order = np.argsort(all_c_arr)
    return CalibrationResult(
        c0=float(c0),
        candidates=all_c_arr[order],
        misfits=all_j_arr[order],
        c_grid_best=float(all_c_arr[int(np.argmin(all_j_arr))]),
    )


def background_misfit_fn_3d(data, grid, pml=None, iter_cap: int = 400,
                            solver3d: str = "gmres", gmres_tol: float = 1e-4,
                            spectral: str = "auto"):
    """3D ``J(c)``: the relative projected misfit of a homogeneous volume
    at speed ``c`` through the spectral 3D solve (:mod:`.fwi3d`), on the
    device of the :class:`~.fwi3d.FWIData3D` ``data``. The homogeneous
    potential is near zero, so each solve converges in a few matvecs.
    ``gmres_tol`` is tighter than the FWI loop's 2e-3: the misfit
    differences between nearby candidates must stay above the solver's
    noise floor for the parabolic fit."""
    from ..config import PMLConfig
    from .fwi3d import FWIData3D, _make_solve_3d, sample_receivers_3d

    if not isinstance(data, FWIData3D):
        raise TypeError(f"data must be an FWIData3D, got {type(data)}")
    if data.rec_ref is not None:
        # The direct arrival, which carries the background speed, is
        # removed from scattered-field data: calibrate on the total field,
        # then convert with scattered_data_3d(c_ref=result.c0).
        raise ValueError("calibrate on total-field data (before "
                         "scattered_data_3d), not on scattered data")
    pml = pml or PMLConfig()
    solve = _make_solve_3d(grid, pml, iter_cap, solver3d=solver3d,
                           gmres_tol=gmres_tol, spectral=spectral)
    device = data.src.device

    def J(c):
        vel = torch.full(grid.shape, float(np.float32(c)),
                         dtype=torch.float32, device=device)
        u, _ = solve(vel, data.src, data.f, attenuation=data.attenuation)
        rec = sample_receivers_3d(u, data.rx_idx)
        rec = rec * estimate_source_strengths(rec, data.rec_obs)[:, None]
        obs_energy = 0.5 * torch.sum(data.rec_obs.real ** 2
                                     + data.rec_obs.imag ** 2)
        return misfit(rec, data.rec_obs) / torch.clamp(obs_energy, min=1e-38)

    return J


def calibrate_background_speed_3d(data, grid, *, pml=None,
                                  iter_cap: int = 400,
                                  solver3d: str = "gmres",
                                  gmres_tol: float = 1e-4,
                                  spectral: str = "auto",
                                  c_min: float = 1400.0,
                                  c_max: float = 1600.0,
                                  num: int = 9,
                                  levels: int = 2) -> CalibrationResult:
    """3D background-speed calibration over an :class:`~.fwi3d.FWIData3D`
    (the search of :func:`calibrate_background_speed`: ``levels * num``
    homogeneous 3D solves), on the data's device. Feed ``result.c0`` to
    ``invert_dataset_3d(c_init=...)`` or as the scattered-field ``c_ref``.
    Scale one-hot sources to O(1e6) on weak-contrast volumes: at unit
    scale the solves' squared norms fall into FP32's denormals."""
    if num < 3:
        raise ValueError("num must be >= 3 for the parabolic refinement")
    J = background_misfit_fn_3d(data, grid, pml=pml, iter_cap=iter_cap,
                                solver3d=solver3d, gmres_tol=gmres_tol,
                                spectral=spectral)
    return _zoom_search(J, c_min, c_max, num, levels)


def estimate_receiver_sensitivities(data: FWIData, acq, vel, grid: Grid2D,
                                    solver: SolverConfig = SolverConfig(),
                                    sweeps: int = 3):
    """Per-element receiver sensitivities from the data and a velocity
    model, by variable projection against one forward solve on the device
    of ``data``: alternate the per-shot source estimate with the
    per-element least-squares column factor ``s_e = sum_t <sim, obs>_e /
    sum_t |sim|^2_e`` (over the shots whose acceptance mask holds element
    ``e``), host-side in complex128.

    A per-receiver sensitivity scales every column of the data in a way no
    per-shot scalar explains, so it survives the inversion's source
    estimate and biases the misfit; reciprocity QC sees only the ratios
    ``q_e / s_e``.

    Args:
        data: FWIData whose observations may carry receiver sensitivities.
        acq: the RingAcquisition that built ``data`` (its (ntx, n_active)
            element ids).
        vel: (ny, nx) velocity model to linearize at.

    Returns:
        (s, data_compensated): ``s`` (num_elements,) complex128, unit
        magnitude-median, 1 for elements never observed; and FWIData whose
        ``rec_obs`` entries are divided by their element's sensitivity.
    """
    device = data.src.device
    u, _ = solve_helmholtz(
        torch.as_tensor(vel, dtype=torch.float32).to(device), data.src,
        data.f, grid, solver, attenuation=data.attenuation)
    rec = sample_receivers(u, data.rx_y, data.rx_x, data.rx_w)
    sim = rec.cpu().numpy().astype(np.complex128)
    obs = data.rec_obs.cpu().numpy().astype(np.complex128)

    elem = np.asarray(acq.rx_indices)               # (ntx, n_active) ids
    n_elem = int(acq.num_elements)
    s = np.ones(n_elem, np.complex128)
    for _ in range(max(1, int(sweeps))):
        # (a) per-shot source factors against the s-compensated obs
        obs_c = obs / s[elem]
        q = (np.sum(np.conj(sim) * obs_c, axis=1)
             / np.maximum(np.sum(np.abs(sim) ** 2, axis=1), 1e-300))
        model = q[:, None] * sim                    # q_t * sim, per entry
        # (b) per-element receiver factors: obs ~ s_e * model
        num = np.zeros(n_elem, np.complex128)
        den = np.zeros(n_elem, np.float64)
        np.add.at(num, elem, np.conj(model) * obs)
        np.add.at(den, elem, np.abs(model) ** 2)
        s = np.where(den > 0, num / np.maximum(den, 1e-300), 1.0)
        nz = np.abs(s[den > 0])
        if nz.size:
            s = np.where(den > 0, s / np.median(nz), s)
    comp = obs / s[elem]
    rec_obs = torch.as_tensor(comp.astype(np.complex64), device=device)
    return s, data._replace(rec_obs=rec_obs)
