"""Nonlinear conjugate-gradient FWI on one device (port of
``waveforminversionust_tpu.fwi.optimizers``; the reference's ``lax.scan``
is a Python loop here).

Per iteration (nonlinearcg.py:71-169, FrequencyDomainFWI.m:76-189):
  1. forward Helmholtz solve for all transmitters
  2. per-tx complex source-strength estimation
  3. adjoint solve on the scattered receiver residuals
  4. gradient = -sum_tx Re(conj(VIRT) * adjoint field)
  5. CG momentum (5 formulas) -> search direction
  6. linearized solve of the search direction (the third solve)
  7. step size (3 line-search formulas, or BB) and the slowness update
All three solves share one prepared operator: under the banded method one
factorization; with ``refactor_every = K > 1`` the factorization runs only
when it % K == 0 (and at the first iteration of each call) and the whole
stale factor, of whichever direct engine built it (block-Thomas, twisted
or cyclic reduction), is reused in between. GMRES and Born prepare their
operator every iteration and refuse ``refactor_every > 1``, as the
reference does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import (FWIConfig, MomentumFormula, SolverConfig, SolverMethod,
                      StepSizeFormula)
from ..models.grid import Grid2D
from ..ops.solve import (HelmholtzOperator, factor_operator,
                         helmholtz_operator_solve, make_helmholtz_operator)
from ..ops.stencil import d_map as _d_map
from ..ops.stencil import helmholtz_coefficients, pml_stretch_fields
from .objective import (FWIData, estimate_source_strengths, illumination_map,
                        misfit, precondition_gradient, sample_receivers,
                        scatter_to_fields, virtual_source)
from .regularization import make_cg_regularizer


class CGState(NamedTuple):
    velocity: torch.Tensor       # (ny, nx) float32
    slowness: torch.Tensor       # (ny, nx) float32
    search_dir: torch.Tensor     # (ny, nx) float32
    grad_prev: torch.Tensor      # (ny, nx) float32
    wavefield: torch.Tensor      # (ntx, ny, nx) complex64 (latest)
    adjoint_field: torch.Tensor  # (ntx, ny, nx) complex64 (latest)


class CGMetrics(NamedTuple):
    loss: torch.Tensor
    grad_norm: torch.Tensor
    beta: torch.Tensor
    step_size: torch.Tensor


class CGResult(NamedTuple):
    velocity: torch.Tensor
    search_dir: torch.Tensor
    gradient: torch.Tensor
    adjoint_field: torch.Tensor  # (ntx, ny, nx) complex64, last iteration
    wavefield: torch.Tensor      # (ntx, ny, nx) complex64, last iteration
    metrics: CGMetrics           # per-iteration, leading axis = iterations


def _dot(a, b):
    return torch.sum(a * b)


def _momentum(formula: MomentumFormula, it: int, grad, grad_prev, search_dir,
              eps: float):
    """CG momentum beta (FrequencyDomainFWI.m:119-148); 0 at the first
    iteration for every formula."""
    dg = grad - grad_prev
    zero = torch.zeros((), dtype=grad.dtype, device=grad.device)
    if formula == MomentumFormula.GRADIENT_DESCENT:
        return zero
    if formula == MomentumFormula.FLETCHER_REEVES:
        beta = _dot(grad, grad) / (_dot(grad_prev, grad_prev) + eps)
    elif formula == MomentumFormula.POLAK_RIBIERE:
        beta = _dot(grad, dg) / (_dot(grad_prev, grad_prev) + eps)
    elif formula == MomentumFormula.PR_FR_CLAMPED:
        gp2 = _dot(grad_prev, grad_prev) + eps
        beta = torch.minimum(torch.clamp(_dot(grad, dg) / gp2, min=0.0),
                             _dot(grad, grad) / gp2)
    elif formula == MomentumFormula.HESTENES_STIEFEL:
        beta = _dot(grad, dg) / (_dot(search_dir, dg) + eps)
    else:
        raise ValueError(f"unknown momentum formula {formula}")
    return zero if it == 0 else beta


def _re_inner(a, b):
    """sum Re(conj(a) * b)."""
    return torch.sum(a.real * b.real + a.imag * b.imag)


def _step_size(formula: StepSizeFormula, drec, rec_obs, rec_sim, grad,
               search_dir, eps: float):
    """Linearized line-search step (FrequencyDomainFWI.m:149-172)."""
    den = _re_inner(drec, drec) + eps
    if formula == StepSizeFormula.RESIDUAL:
        return _re_inner(drec, rec_obs - rec_sim) / den
    if formula == StepSizeFormula.GRADIENT:
        return _dot(grad, grad) / den
    if formula == StepSizeFormula.GRADIENT_SD:
        return -_dot(grad, search_dir) / den
    raise ValueError(f"unknown step-size formula {formula}")


def _bb_step_size(slow, slow_prev, grad, gprev, sd_new, eps):
    """BB2 step alpha = -sigma <g,p>/<p,p>, sigma = <dm,dg>/<dg,dg>, and its
    validity (num > 0 also covers the cold start and a watchdog revert,
    both with dm = 0)."""
    dm = slow - slow_prev
    dg = grad - gprev
    num = torch.sum(dm * dg)
    sigma = num / (torch.sum(dg * dg) + eps)
    gp = torch.sum(grad * sd_new)
    bb_sz = -sigma * gp / (torch.sum(sd_new * sd_new) + eps)
    valid = (num > 0) & (gp < 0) & torch.isfinite(bb_sz)
    return bb_sz, valid


def _watchdog_apply(ratio, loss, prev_loss, slow, slow_prev, slow_new,
                    vel_new):
    """Nonmonotone watchdog: a loss above ratio x the baseline reverts to
    the pre-misstep iterate, keeps the baseline and flags a restart.

    Reproduces the reference as it is (fwi/optimizers.py:154): a
    non-finite loss is not ``bad`` (NaN > x is false), so it becomes the
    new baseline and every later comparison with it is false too, which
    disables the watchdog for the rest of the run.

    Returns (bad, slow_new, vel_new, slow_next_prev, prev_loss_new)."""
    bad = loss > float(ratio) * prev_loss
    slow_new = torch.where(bad, slow_prev, slow_new)
    vel_new = torch.where(bad, 1.0 / slow_prev, vel_new)
    slow_next_prev = torch.where(bad, slow_prev, slow)
    prev_loss_new = torch.where(bad, prev_loss, loss)
    return bad, slow_new, vel_new, slow_next_prev, prev_loss_new


def _validate_watchdog(fwi: FWIConfig):
    if fwi.reject_increase is not None and not fwi.reject_increase > 1.0:
        raise ValueError(
            f"reject_increase must be > 1 (a loss-RATIO threshold); "
            f"{fwi.reject_increase} would re-trigger forever after the "
            f"first revert (loss == baseline at the restored model) and "
            f"freeze the inversion at the initial iterate")


class _Carry(NamedTuple):
    state: CGState
    factor: object = None          # frozen-factor CG: the whole stale factor
    slow_prev: torch.Tensor | None = None   # BB and watchdog
    prev_loss: torch.Tensor | None = None   # watchdog baseline
    restart: torch.Tensor | None = None     # watchdog restart flag


def make_cg_step(data: FWIData, grid: Grid2D, solver: SolverConfig,
                 fwi: FWIConfig, mesh=None, grid_axis: str = "grid"):
    """The body of one CG iteration: ``step(carry, it, local) -> (carry,
    metrics)``, ``it`` the global and ``local`` the in-call iteration
    index. ``mesh`` / ``grid_axis`` come with the multi-device slice;
    ``mesh`` raises until then."""
    if mesh is not None:
        raise NotImplementedError("mesh= (multi-device) is ported in a later "
                                  "slice (ROADMAP.md A, slice 7)")
    _validate_watchdog(fwi)
    regularize = make_cg_regularizer(grid, fwi)
    K = solver.refactor_every
    frozen = K > 1
    banded = solver.method == SolverMethod.BANDED
    if frozen and not banded:
        # The reference's guard (fwi/optimizers.py:190-196); the port runs
        # the frozen factor with every direct engine (ROADMAP.md C4).
        raise ValueError("refactor_every > 1 (frozen-factor CG) requires the "
                         "banded method")
    bb = fwi.step_size == StepSizeFormula.BB
    guard = fwi.reject_increase is not None
    device = data.src.device
    dmap = _d_map(grid, device)
    # The PML fields depend only on (grid, f, pml): hoisted out of the loop.
    pml_fields = pml_stretch_fields(grid, data.f, solver.pml, device=device)
    alpha_signed = None
    if data.attenuation is not None:
        sgn = -1.0 if solver.pml.sign_convention < 0 else 1.0
        alpha_signed = sgn * data.attenuation

    def step(carry: _Carry, it: int, local: int):
        st = carry.state
        vel, slow, sd, gprev = (st.velocity, st.slowness, st.search_dir,
                                st.grad_prev)
        stale = False
        if banded:
            coeffs = helmholtz_coefficients(
                vel, grid, data.f, solver.pml, solver.stencil,
                attenuation=data.attenuation, pml_fields=pml_fields)
            do_factor = not frozen or local == 0 or it % K == 0
            factor = (factor_operator(coeffs, solver) if do_factor
                      else carry.factor)
            # A stale factor is reused whole; refinement targets the
            # current planes (op.coeffs) on stale iterations.
            stale = frozen and solver.stale_refine and not do_factor
            op = HelmholtzOperator(vel=vel, f=data.f, coeffs=coeffs,
                                   precond=None, factor=factor, d_map=dmap)
        else:
            # GMRES (the preconditioner's parameters, and the coarse
            # factor when two-level) or Born: one operator an iteration.
            op = make_helmholtz_operator(vel, data.f, grid, solver,
                                         attenuation=data.attenuation,
                                         pml_fields=pml_fields)

        def solve(src, adjoint=False, extra_refine=None):
            return helmholtz_operator_solve(op, src, grid, solver,
                                            adjoint=adjoint,
                                            extra_refine=extra_refine)

        # (1) forward solve, all transmitters
        wv = solve(data.src, extra_refine=stale)
        rec_sim = sample_receivers(wv, data.rx_y, data.rx_x, data.rx_w)
        # (2) source-strength estimation
        if fwi.estimate_source_strength:
            s_est = estimate_source_strengths(rec_sim, data.rec_obs)
            wv = wv * s_est[:, None, None]
            rec_sim = rec_sim * s_est[:, None]
        residual = rec_sim - data.rec_obs
        loss = misfit(rec_sim, data.rec_obs)
        # (3) adjoint solve on the scattered residuals
        adj_src = scatter_to_fields(residual, data.rx_y, data.rx_x,
                                    grid.shape, data.rx_w)
        adj_wv = solve(adj_src, adjoint=True, extra_refine=stale)
        # (4) adjoint-state gradient
        virt = virtual_source(slow, wv, data.f, alpha_signed)
        grad = -torch.sum(virt.real * adj_wv.real + virt.imag * adj_wv.imag,
                          dim=0)
        if fwi.precondition == "illumination":
            grad = precondition_gradient(grad, illumination_map(wv),
                                         fwi.precondition_eps)
        if regularize is not None:
            grad = grad + regularize(slow, grad)
        # (5) momentum and search direction
        beta = _momentum(fwi.momentum, it, grad, gprev, sd, fwi.eps_stabilizer)
        if guard:
            beta = torch.where(carry.restart, torch.zeros_like(beta), beta)
        sd_new = beta * sd - grad
        # (6) linearized solve of the search direction
        pert_src = -virt * sd_new[None]

        def linearized_step():
            pert = solve(pert_src)
            drec = sample_receivers(pert, data.rx_y, data.rx_x, data.rx_w)
            formula = StepSizeFormula.RESIDUAL if bb else fwi.step_size
            return _step_size(formula, drec, data.rec_obs, rec_sim, grad,
                              sd_new, fwi.eps_stabilizer)

        # (7) step size and slowness update
        if bb:
            bb_sz, valid = _bb_step_size(slow, carry.slow_prev, grad, gprev,
                                         sd_new, fwi.eps_stabilizer)
            step_sz = bb_sz if bool(valid) else linearized_step()
        else:
            step_sz = linearized_step()
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

        slow_next_prev, prev_loss, restart = slow, carry.prev_loss, carry.restart
        if guard:
            (restart, slow_new, vel_new, slow_next_prev,
             prev_loss) = _watchdog_apply(fwi.reject_increase, loss,
                                          carry.prev_loss, slow,
                                          carry.slow_prev, slow_new, vel_new)
        metrics = CGMetrics(loss=loss, grad_norm=torch.linalg.norm(grad),
                            beta=beta, step_size=step_sz)
        new = _Carry(
            state=CGState(vel_new, slow_new, sd_new, grad, wv, adj_wv),
            factor=op.factor if frozen else None,
            slow_prev=slow_next_prev if (bb or guard) else None,
            prev_loss=prev_loss, restart=restart)
        return new, metrics

    return step


def nonlinear_cg(vel_init, data: FWIData, grid: Grid2D,
                 solver: SolverConfig = SolverConfig(),
                 fwi: FWIConfig = FWIConfig(),
                 num_iterations: int | None = None,
                 init_search_dir=None, init_grad_prev=None,
                 iteration_offset: int = 0, mesh=None,
                 grid_axis: str = "grid") -> CGResult:
    """Run the nonlinear-CG inversion (nonlinearcg.py:41-180) with a
    metrics history. ``vel_init``: (ny, nx) starting model on the data's
    device; ``init_search_dir`` / ``init_grad_prev`` / ``iteration_offset``
    resume a run mid-stage."""
    n_iter = fwi.num_iterations if num_iterations is None else num_iterations
    device = data.src.device
    vel0 = torch.as_tensor(vel_init, dtype=torch.float32).to(device)
    ntx = data.src.shape[0]
    zfield = torch.zeros((ntx,) + grid.shape, dtype=torch.complex64,
                         device=device)
    zgrid = torch.zeros(grid.shape, dtype=torch.float32, device=device)

    def init(v):
        return zgrid if v is None else torch.as_tensor(
            v, dtype=torch.float32).to(device)

    state = CGState(vel0, 1.0 / vel0, init(init_search_dir),
                    init(init_grad_prev), zfield, zfield)
    guard = fwi.reject_increase is not None
    carry = _Carry(
        state=state,
        slow_prev=(state.slowness if (fwi.step_size == StepSizeFormula.BB
                                      or guard) else None),
        # +inf baseline: the first iteration can never read as a spike.
        prev_loss=(torch.tensor(float("inf"), device=device) if guard
                   else None),
        restart=torch.tensor(False, device=device) if guard else None)
    step = make_cg_step(data, grid, solver, fwi, mesh=mesh)
    history = []
    for local in range(n_iter):
        carry, m = step(carry, int(iteration_offset) + local, local)
        history.append(m)
    final = carry.state
    metrics = CGMetrics(*(torch.stack([getattr(m, f) for m in history])
                          if history else torch.zeros(0, device=device)
                          for f in CGMetrics._fields))
    return CGResult(velocity=final.velocity, search_dir=final.search_dir,
                    gradient=final.grad_prev,
                    adjoint_field=final.adjoint_field,
                    wavefield=final.wavefield, metrics=metrics)
