"""Joint multi-frequency FWI on one device (port of the single-device part
of ``waveforminversionust_tpu.fwi.multifreq``): one nonlinear-CG inversion
fitting several frequencies at once,

    loss  = sum_f 0.5 ||residual_f||^2
    grad  = sum_f grad_f                       (adjoint state per frequency)
    step  = sum_f Re<drec_f, -residual_f> / sum_f ||drec_f||^2

The reference's ``lax.map`` over frequencies is a Python loop. Like the
reference, an iteration factors each frequency twice, once for its forward
and adjoint solves and once for the line search's linearized solve
(ROADMAP.md §B: reusing the first factor would give the same bits for one
factorization less a frequency). ``nonlinear_cg_multifreq_sharded`` is
ported with the multi-device slice (ROADMAP.md A7), and with it the
cross-device reduction of the step's sums (the reference's
``_step_size_reduced``; on one device it is :func:`.optimizers._step_size`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import FWIConfig, SolverConfig, StepSizeFormula
from ..models.grid import Grid2D
from ..ops.solve import helmholtz_operator_solve, make_helmholtz_operator
from .objective import (FWIData, estimate_source_strengths, illumination_map,
                        misfit, precondition_gradient, sample_receivers,
                        scatter_to_fields, virtual_source)
from .optimizers import CGMetrics, _momentum, _step_size
from .regularization import make_cg_regularizer


class MultiFreqData(NamedTuple):
    """Frequency-stacked inversion inputs: ``rec_obs`` (nf, ntx, n_active)
    complex64, ``freqs`` a tuple of nf frequencies [Hz]; the sources and
    receiver stencils are frequency-independent. Build one FWIData per
    frequency with :func:`.objective.build_fwi_data` and stack them with
    :func:`stack_frequencies`."""

    src: torch.Tensor          # (ntx, ny, nx) complex64
    rec_obs: torch.Tensor      # (nf, ntx, n_active) complex64
    rx_y: torch.Tensor
    rx_x: torch.Tensor
    freqs: tuple               # (nf,) floats
    rx_w: torch.Tensor | None = None
    # Known frequency-independent attenuation alpha [Np/m], or None.
    attenuation: torch.Tensor | None = None


def stack_frequencies(datas: list[FWIData]) -> MultiFreqData:
    """Stack per-frequency FWIData of one acquisition into MultiFreqData."""
    first = datas[0]
    return MultiFreqData(
        src=first.src, rec_obs=torch.stack([d.rec_obs for d in datas]),
        rx_y=first.rx_y, rx_x=first.rx_x,
        freqs=tuple(float(np.float32(d.f)) for d in datas),
        rx_w=first.rx_w, attenuation=first.attenuation)


def _multifreq_cg(vel_init, data: MultiFreqData, grid: Grid2D,
                  solver: SolverConfig, fwi: FWIConfig, n_iter: int):
    """The multi-frequency CG loop; returns (velocity, CGMetrics)."""
    if fwi.step_size == StepSizeFormula.BB:
        raise ValueError(
            "step_size=BB is not supported by the joint multi-frequency "
            "CG loop (only the reference's three linearized formulas); "
            "use nonlinear_cg per frequency or a continuation schedule")
    if fwi.reject_increase is not None:
        raise ValueError(
            "reject_increase (the nonmonotone watchdog) is not wired into "
            "the joint multi-frequency CG loop; unset it (the single-"
            "frequency 2D and 3D loops support it)")
    device = data.src.device
    vel = torch.as_tensor(vel_init, dtype=torch.float32).to(device)
    regularize = make_cg_regularizer(grid, fwi)
    alpha_signed = None
    if data.attenuation is not None:
        alpha_signed = (float(np.sign(solver.pml.sign_convention))
                        * data.attenuation)

    def solve(op, src, adjoint=False):
        return helmholtz_operator_solve(op, src, grid, solver,
                                        adjoint=adjoint)

    def per_freq_forward(vel, slow, f, rec_obs):
        """Forward solve and the adjoint-state gradient at one frequency."""
        op = make_helmholtz_operator(vel, f, grid, solver,
                                     attenuation=data.attenuation)
        wv = solve(op, data.src)
        rec_sim = sample_receivers(wv, data.rx_y, data.rx_x, data.rx_w)
        if fwi.estimate_source_strength:
            s_est = estimate_source_strengths(rec_sim, rec_obs)
            wv = wv * s_est[:, None, None]
            rec_sim = rec_sim * s_est[:, None]
        residual = rec_sim - rec_obs
        adj_wv = solve(op, scatter_to_fields(residual, data.rx_y, data.rx_x,
                                             grid.shape, data.rx_w),
                       adjoint=True)
        virt = virtual_source(slow, wv, f, alpha_signed)
        grad = -torch.sum(virt.real * adj_wv.real + virt.imag * adj_wv.imag,
                          dim=0)
        illum = (illumination_map(wv) if fwi.precondition == "illumination"
                 else None)
        return misfit(rec_sim, rec_obs), grad, illum, virt, rec_sim

    def per_freq_linesearch(vel, f, virt, sd):
        op = make_helmholtz_operator(vel, f, grid, solver,
                                     attenuation=data.attenuation)
        pert = solve(op, -virt * sd[None])
        return sample_receivers(pert, data.rx_y, data.rx_x, data.rx_w)

    slow = 1.0 / vel
    sd = torch.zeros(grid.shape, dtype=torch.float32, device=device)
    gprev = torch.zeros_like(sd)
    history = []
    for it in range(n_iter):
        per_f = [per_freq_forward(vel, slow, f, data.rec_obs[i])
                 for i, f in enumerate(data.freqs)]
        loss = torch.sum(torch.stack([p[0] for p in per_f]))
        grad = torch.sum(torch.stack([p[1] for p in per_f]), dim=0)
        if fwi.precondition == "illumination":
            # Illumination summed over frequencies and shots.
            illum = torch.sum(torch.stack([p[2] for p in per_f]), dim=0)
            grad = precondition_gradient(grad, illum, fwi.precondition_eps)
        if regularize is not None:
            grad = grad + regularize(slow, grad)
        beta = _momentum(fwi.momentum, it, grad, gprev, sd,
                         fwi.eps_stabilizer)
        sd_new = beta * sd - grad
        drecs = torch.stack([per_freq_linesearch(vel, f, p[3], sd_new)
                             for f, p in zip(data.freqs, per_f)])
        rec_sims = torch.stack([p[4] for p in per_f])
        del per_f
        # The linearized step with its receiver sums over the frequencies
        # too (the reference's _step_size_reduced on one device).
        step_sz = _step_size(fwi.step_size, drecs, data.rec_obs, rec_sims,
                             grad, sd_new, fwi.eps_stabilizer)
        slow_new = slow + step_sz * sd_new
        vel_new = 1.0 / slow_new
        if fwi.clip_velocity is not None:
            lo, hi = fwi.clip_velocity
            vel_new = torch.clamp(vel_new, lo, hi)
            slow_new = 1.0 / vel_new
        if fwi.reject_nonfinite:
            ok = (torch.isfinite(step_sz) & torch.isfinite(beta)
                  & torch.all(torch.isfinite(slow_new)))
            vel_new = torch.where(ok, vel_new, vel)
            slow_new = torch.where(ok, slow_new, slow)
            sd_new = torch.where(ok, sd_new, sd)
            step_sz = torch.where(ok, step_sz, torch.zeros_like(step_sz))
        history.append(CGMetrics(loss=loss, grad_norm=torch.linalg.norm(grad),
                                 beta=beta, step_size=step_sz))
        vel, slow, sd, gprev = vel_new, slow_new, sd_new, grad
    metrics = CGMetrics(*(torch.stack([getattr(m, f) for m in history])
                          if history else torch.zeros(0, device=device)
                          for f in CGMetrics._fields))
    return vel, metrics


def nonlinear_cg_multifreq(vel_init, data: MultiFreqData, grid: Grid2D,
                           solver: SolverConfig = SolverConfig(),
                           fwi: FWIConfig = FWIConfig(),
                           num_iterations: int | None = None):
    """Joint multi-frequency nonlinear-CG inversion on the data's device.
    Returns (velocity, CGMetrics history); an iteration costs two
    factorizations and three solves a frequency."""
    n_iter = fwi.num_iterations if num_iterations is None else num_iterations
    return _multifreq_cg(vel_init, data, grid, solver, fwi, n_iter)
