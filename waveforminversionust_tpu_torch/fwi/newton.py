"""Truncated Gauss-Newton FWI (inexact Newton-CG; port of
``waveforminversionust_tpu.fwi.newton``).

No autograd: the Frechet derivative and its adjoint are each one Helmholtz
solve against the outer iteration's one factored operator,

    J dm   = sample(H^-1 (-VIRT .* dm))                  (one solve)
    J^H r  = -sum_tx Re(conj(VIRT) .* H^-H scatter(r))   (one solve)

(VIRT the virtual source of objective.virtual_source). Each outer
iteration: the gradient (one adjoint solve), a fixed-length preconditioned
linear CG on the Levenberg-Marquardt-damped normal equations (two solves a
live inner iteration), the reference's linearized step along the result
(one solve), and halve-until-decrease backtracking (a factorization and a
forward solve a trial).

The reference's compiled scan becomes a host loop: its ``jnp.where(ok,
new, old)`` over the whole carry, factor included, is an ``if``, and its
backtracking ``while_loop`` a Python loop. The host reads one scalar an
inner iteration (its convergence test), one an outer iteration and one a
trial (the losses). The inner CG stops at the first converged iteration:
the reference freezes the rest and discards their solves, so the port
skips them (same result, fewer launches). ``run_gauss_newton_3d`` is the
same loop over the 3D spectral solve, every J and J^H product a 3D solve;
``mesh`` is ported with the multi-device slice (ROADMAP.md A7).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..config import FWIConfig, SolverConfig
from ..models.grid import Grid2D
from ..ops.solve import helmholtz_operator_solve, make_helmholtz_operator
from ..ops.stencil import boundary_mask, pml_stretch_fields, stencil_params
from .objective import (FWIData, estimate_source_strengths, illumination_map,
                        mass_spread, misfit, sample_receivers,
                        scatter_to_fields, virtual_source)


class GNMetrics(NamedTuple):
    loss: torch.Tensor        # (outer,) misfit BEFORE the iteration's update
    grad_norm: torch.Tensor   # (outer,)
    step_size: torch.Tensor   # (outer,) accepted step along dm (0 = rejected)
    cg_relres: torch.Tensor   # (outer,) inner-CG relative residual at exit
    backtracks: torch.Tensor  # (outer,) step halvings the globalization took


class GNResult(NamedTuple):
    velocity: torch.Tensor    # (ny, nx)
    metrics: GNMetrics


def _mul_fields(fields, scalar_map):
    """fields * scalar_map[None] for complex64 fields."""
    return fields * scalar_map[None]


def _laplacian_ltl(m):
    """L^T L for first-order forward differences along every axis (the
    Hessian of regularization.tikhonov_value, dimension-generic)."""
    out = torch.zeros_like(m)
    for ax in range(m.dim()):
        lo = tuple(slice(None, -1) if a == ax else slice(None)
                   for a in range(m.dim()))
        hi = tuple(slice(1, None) if a == ax else slice(None)
                   for a in range(m.dim()))
        d = m[hi] - m[lo]
        out[lo] -= d
        out[hi] += d
    return out


def _pcg(hvp, b, diag, cg_iters: int, cg_tol: float):
    """Diagonally preconditioned linear CG of at most ``cg_iters``
    iterations on the damped normal equations; returns (x, relres). It
    stops at the first iteration whose residual is within ``cg_tol`` (the
    reference freezes such iterations: updates on subnormal residuals can
    NaN), so a converged solve skips the rest of its Hessian products."""
    x = torch.zeros_like(b)
    r = b
    z = r / diag
    p = z
    rz = torch.sum(r * z)
    b2 = torch.clamp(torch.sum(b * b), min=1e-38)
    tol2 = cg_tol ** 2 * b2
    for _ in range(cg_iters):
        if not bool(torch.sum(r * r) > tol2):
            break
        ap = hvp(p)
        alpha = rz / torch.clamp(torch.sum(p * ap), min=1e-38)
        x = x + alpha * p
        r = r - alpha * ap
        z = r / diag
        rz1 = torch.sum(r * z)
        p = z + (rz1 / torch.clamp(rz, min=1e-38)) * p
        rz = rz1
    return x, torch.sqrt(torch.sum(r * r) / b2)


def _linearized_step(drec, residual):
    """The reference's RESIDUAL step along a direction whose receiver
    response is ``drec`` (nonlinearcg.py:22-32); 0 where not finite."""
    num = -torch.sum(drec.real * residual.real + drec.imag * residual.imag)
    den = torch.sum(drec.real ** 2 + drec.imag ** 2)
    step = num / torch.clamp(den, min=1e-38)
    return torch.where(torch.isfinite(step), step, torch.zeros_like(step))


def _data_normalization(rec_obs):
    """O(1)-data scale factor (FP32 conditioning; see run_gauss_newton)."""
    d2 = torch.mean(torch.abs(rec_obs) ** 2)
    return 1.0 / torch.sqrt(torch.clamp(d2, min=1e-38))


def _grad_contract(virt, adj_wv):
    """-sum_tx Re(conj(VIRT) * adjoint field) (nonlinearcg.py:126-127)."""
    return -torch.sum(virt.real * adj_wv.real + virt.imag * adj_wv.imag,
                      dim=0)


def make_frechet_operators(op, data: FWIData, grid: Grid2D,
                           solver: SolverConfig, slow, wv,
                           exact: bool = True, mesh=None,
                           grid_axis: str = "grid"):
    """(j_apply, jt_apply, virt): the Frechet derivative of the receiver
    data and its adjoint, one solve each against the prepared operator
    ``op``; ``wv`` the forward wavefield at the linearization point (with
    any per-shot source scales applied).

        j_apply(dm) = J dm        (ntx, n_active) receiver perturbation
        jt_apply(r) = Re(J^H r)   (ny, nx) real model cotangent

    ``exact=True`` differentiates the discrete 9-point operator: the mass
    term rides all nine legs weighted (1-d-e, d/4, e/4) and the PML field
    C, and the Dirichlet border rows do not depend on the model, so the
    perturbation source is masked and spread by objective.mass_spread.
    ``exact=False`` is the classical lumped virtual source, the reference
    CG loop's gradient formula. ``mesh`` is ported with the multi-device
    slice and raises until then."""
    if mesh is not None:
        raise NotImplementedError("mesh= (multi-device) is ported in a later "
                                  "slice (ROADMAP.md A, slice 7)")
    device = wv.device
    alpha_signed = None
    if data.attenuation is not None:
        alpha_signed = (float(np.sign(solver.pml.sign_convention))
                        * data.attenuation)
    virt = virtual_source(slow, wv, data.f, alpha_signed)
    solve = partial(helmholtz_operator_solve, grid=grid, cfg=solver)

    if exact:
        vel = 1.0 / slow
        _, d_w, e_w = stencil_params(vel.min(), vel.max(), data.f, grid.h,
                                     grid.aspect, solver.stencil)
        interior = 1.0 - boundary_mask(grid, device)
        # the mass rows carry C k^2, so dH/dslow does too
        C = pml_stretch_fields(grid, data.f, solver.pml, device=device)[2]
        cvirt = C[None] * virt

        def j_apply(dm):
            pert = mass_spread(_mul_fields(cvirt, dm), d_w, e_w)
            du = solve(op, src=_mul_fields(pert, -interior))
            return sample_receivers(du, data.rx_y, data.rx_x, data.rx_w)

        def jt_apply(r):
            a = solve(op, src=scatter_to_fields(r, data.rx_y, data.rx_x,
                                                grid.shape, data.rx_w),
                      adjoint=True)
            aw = mass_spread(_mul_fields(a, interior), d_w, e_w)
            return _grad_contract(cvirt, aw)

        return j_apply, jt_apply, virt

    def j_apply(dm):
        du = solve(op, src=_mul_fields(virt, -dm))
        return sample_receivers(du, data.rx_y, data.rx_x, data.rx_w)

    def jt_apply(r):
        a = solve(op, src=scatter_to_fields(r, data.rx_y, data.rx_x,
                                            grid.shape, data.rx_w),
                  adjoint=True)
        return _grad_contract(virt, a)

    return j_apply, jt_apply, virt


def _backtrack(forward, project, cur, dm, step, max_bt: int = 4):
    """Halve the step along ``dm`` until the true misfit decreases (one
    device sync a trial reads its loss), up to ``max_bt`` times, then
    reject: (the accepted trial's forward state or ``cur``, GNMetrics with
    the iteration's loss, the accepted step (0 when rejected) and the
    halvings)."""
    loss = float(cur.loss)

    def accept(c):
        new_loss = float(c.loss)
        return bool(np.isfinite(new_loss) and new_loss < loss)

    k_bt, t = 0, step
    cand = forward(project(cur.slow + t * dm))
    ok = accept(cand)
    while not ok and k_bt < max_bt:
        k_bt, t = k_bt + 1, 0.5 * t
        cand = forward(project(cur.slow + t * dm))
        ok = accept(cand)
    metrics = GNMetrics(
        loss=cur.loss, grad_norm=None,
        step_size=t if ok else torch.zeros_like(t), cg_relres=None,
        backtracks=torch.tensor(k_bt, dtype=torch.int32,
                                device=cur.slow.device))
    return (cand if ok else cur), metrics


def _stack_metrics(history, device) -> GNMetrics:
    """The per-iteration GNMetrics stacked into (outer,) histories."""
    return GNMetrics(*(torch.stack([getattr(m, f) for m in history])
                       if history else torch.zeros(0, device=device)
                       for f in GNMetrics._fields))


class _Forward(NamedTuple):
    slow: torch.Tensor
    op: object
    wv: torch.Tensor
    rec: torch.Tensor
    loss: torch.Tensor


def run_gauss_newton(vel_init, data: FWIData, grid: Grid2D,
                     solver: SolverConfig = SolverConfig(),
                     fwi: FWIConfig = FWIConfig(),
                     num_iterations: int = 5, cg_iters: int = 8,
                     lm_damping: float = 0.1,
                     reg_smooth: float = 1.0,
                     cg_tol: float = 1e-3,
                     exact_frechet: bool = True,
                     mesh=None, grid_axis: str = "grid") -> GNResult:
    """Truncated Gauss-Newton inversion on the data's device.

    Args:
        num_iterations: outer iterations (one factorization each, plus one
            a backtracking trial).
        cg_iters: inner linear-CG iterations on the damped normal equations
            (two solves each against the outer factor).
        lm_damping: Levenberg-Marquardt damping as a fraction of the
            illumination diagonal.
        reg_smooth: weight of the smoothing term L^T L in the curvature,
            scaled by mean(diag) / 8.
        cg_tol: inner-CG relative residual at which it stops.

    Respects ``fwi.estimate_source_strength`` (per-shot scales frozen per
    outer iteration), ``fwi.clip_velocity`` and ``fwi.precondition_eps``;
    non-finite or non-decreasing steps are halved up to 4 times and then
    rejected, so the loss is monotone. ``mesh`` raises (multi-device
    slice)."""
    if mesh is not None:
        raise NotImplementedError("mesh= (multi-device) is ported in a later "
                                  "slice (ROADMAP.md A, slice 7)")
    device = data.src.device
    slow0 = 1.0 / torch.as_tensor(vel_init, dtype=torch.float32).to(device)

    # FP32 conditioning: unit-amplitude ring data is O(1e-10), so the
    # normal-equation products underflow and the linearized step becomes
    # inf. Scaling src and rec_obs by the same factor is an equivalent
    # problem (rec_sim is linear in src, source estimation is scale-free);
    # the reported losses are scaled back.
    s_d = _data_normalization(data.rec_obs)
    data = data._replace(src=data.src * s_d, rec_obs=data.rec_obs * s_d)
    loss_unscale = 1.0 / (s_d * s_d)
    pml_fields = pml_stretch_fields(grid, data.f, solver.pml, device=device)

    def project(slow_x):
        if fwi.clip_velocity is None:
            return slow_x
        lo, hi = fwi.clip_velocity
        return 1.0 / torch.clamp(1.0 / slow_x, lo, hi)

    def forward(slow_x) -> _Forward:
        """Operator, forward solve, frozen source scales and misfit at a
        model point: the outer iteration's and every trial's."""
        op = make_helmholtz_operator(1.0 / slow_x, data.f, grid, solver,
                                     attenuation=data.attenuation,
                                     pml_fields=pml_fields)
        wv = helmholtz_operator_solve(op, data.src, grid, solver)
        rec = sample_receivers(wv, data.rx_y, data.rx_x, data.rx_w)
        if fwi.estimate_source_strength:
            s_est = estimate_source_strengths(rec, data.rec_obs)
            wv = wv * s_est[:, None, None]
            rec = rec * s_est[:, None]
        return _Forward(slow_x, op, wv, rec, misfit(rec, data.rec_obs))

    # The carry is the whole forward state: an accepted trial's evaluation
    # is the next iteration's forward work.
    cur = forward(slow0)
    history = []
    for _ in range(num_iterations):
        residual = cur.rec - data.rec_obs
        j_apply, jt_apply, virt = make_frechet_operators(
            cur.op, data, grid, solver, cur.slow, cur.wv,
            exact=exact_frechet)
        grad = jt_apply(residual)
        # Shin pseudo-Hessian sum_tx |VIRT|^2 as the diagonal surrogate of
        # J^H J, and the smoothing term in the curvature only.
        illum = illumination_map(virt)
        diag = illum + fwi.precondition_eps * torch.max(illum)
        s_reg = reg_smooth * torch.mean(diag) / 8.0

        def hvp(dm):
            return (jt_apply(j_apply(dm)) + lm_damping * diag * dm
                    + s_reg * _laplacian_ltl(dm))

        dm, cg_relres = _pcg(hvp, -grad, diag, cg_iters, cg_tol)
        step = _linearized_step(j_apply(dm), residual)
        # a factorization and a forward solve a trial
        cur, metrics = _backtrack(forward, project, cur, dm, step)
        history.append(metrics._replace(
            grad_norm=torch.linalg.norm(grad) * loss_unscale,
            loss=metrics.loss * loss_unscale, cg_relres=cg_relres))
    return GNResult(velocity=1.0 / cur.slow,
                    metrics=_stack_metrics(history, device))


class _Forward3D(NamedTuple):
    slow: torch.Tensor
    wv: torch.Tensor
    rec: torch.Tensor
    loss: torch.Tensor


def run_gauss_newton_3d(vel_init, data, grid, fwi: FWIConfig = FWIConfig(),
                        num_iterations: int = 5, cg_iters: int = 6,
                        lm_damping: float = 0.1, reg_smooth: float = 1.0,
                        cg_tol: float = 1e-3, pml=None, iter_cap: int = 600,
                        solver3d: str = "gmres", gmres_tol: float = 2e-3,
                        gmres_restart: int = 8, spectral: str = "auto"):
    """Truncated Gauss-Newton over the 3D spectral solver on the data's
    device: :func:`run_gauss_newton`'s scheme, where every J or J^H
    application is a full 3D solve (no factorization to amortize), so an
    outer iteration costs 3 + 2 * cg_iters + backtracks solves. The 3D
    operator applies k^2 pointwise, so the classical virtual source is the
    exact discrete Frechet derivative. The accepted trial's forward state
    is the next iteration's.

    Args:
        data: :class:`~.fwi3d.FWIData3D`.
        pml: default PMLConfig(a0=20, l_pml=12e-3), the 3D solvers'.

    Returns:
        (velocity (nz, ny, nx), GNMetrics history).
    """
    from ..config import PMLConfig
    from .fwi3d import (_make_solve_3d, sample_receivers_3d,
                        scatter_to_volumes_3d)

    if pml is None:
        pml = PMLConfig(a0=20.0, l_pml=12e-3)
    solve = _make_solve_3d(grid, pml, iter_cap, solver3d=solver3d,
                           gmres_tol=gmres_tol, gmres_restart=gmres_restart,
                           spectral=spectral)
    device = data.src.device
    slow0 = 1.0 / torch.as_tensor(vel_init, dtype=torch.float32).to(device)
    s_d = _data_normalization(data.rec_obs)
    data = data._replace(src=data.src * s_d, rec_obs=data.rec_obs * s_d)
    loss_unscale = 1.0 / (s_d * s_d)

    def project(slow_x):
        if fwi.clip_velocity is None:
            return slow_x
        lo, hi = fwi.clip_velocity
        return 1.0 / torch.clamp(1.0 / slow_x, lo, hi)

    def forward(slow_x) -> _Forward3D:
        wv, _ = solve(1.0 / slow_x, data.src, data.f,
                      attenuation=data.attenuation)
        rec = sample_receivers_3d(wv, data.rx_idx)
        if fwi.estimate_source_strength:
            s_est = estimate_source_strengths(rec, data.rec_obs)
            wv = wv * s_est[:, None, None, None]
            rec = rec * s_est[:, None]
        return _Forward3D(slow_x, wv, rec, misfit(rec, data.rec_obs))

    alpha_signed = None
    if data.attenuation is not None:
        alpha_signed = (float(np.sign(pml.sign_convention))
                        * data.attenuation)
    cur = forward(slow0)
    history = []
    for _ in range(num_iterations):
        vel = 1.0 / cur.slow
        residual = cur.rec - data.rec_obs
        virt = virtual_source(cur.slow, cur.wv, data.f, alpha_signed)

        def j_apply(dm):
            du, _ = solve(vel, _mul_fields(virt, -dm), data.f,
                          attenuation=data.attenuation)
            return sample_receivers_3d(du, data.rx_idx)

        def jt_apply(r):
            a, _ = solve(vel, scatter_to_volumes_3d(r, data.rx_idx,
                                                    grid.shape),
                         data.f, adjoint=True, attenuation=data.attenuation)
            return _grad_contract(virt, a)

        grad = jt_apply(residual)
        illum = illumination_map(virt)
        diag = illum + fwi.precondition_eps * torch.max(illum)
        s_reg = reg_smooth * torch.mean(diag) / 12.0  # ||L^T L||_inf

        def hvp(dm):
            return (jt_apply(j_apply(dm)) + lm_damping * diag * dm
                    + s_reg * _laplacian_ltl(dm))

        dm, cg_relres = _pcg(hvp, -grad, diag, cg_iters, cg_tol)
        step = _linearized_step(j_apply(dm), residual)
        # a 3D forward solve a trial
        cur, metrics = _backtrack(forward, project, cur, dm, step)
        history.append(metrics._replace(
            grad_norm=torch.linalg.norm(grad) * loss_unscale,
            loss=metrics.loss * loss_unscale, cg_relres=cg_relres))
    return 1.0 / cur.slow, _stack_metrics(history, device)
