"""L-BFGS FWI over the differentiable solve (port of
``waveforminversionust_tpu.fwi.lbfgs``), in 2D and in 3D.

The loss rides :func:`..ops.solve.solve_helmholtz`, whose backward is one
adjoint solve through the forward's own factor, so a value and gradient
costs one factorization, one forward and one adjoint solve.

The reference runs ``optax.lbfgs(memory_size)`` in a compiled scan: the
two-loop recursion of ``optax.scale_by_lbfgs`` (scaled initial
preconditioner) and ``optax.scale_by_zoom_linesearch(max_linesearch_steps=
20, initial_guess_strategy="one")``. The port carries its own copy of that
algorithm as a host loop: the vectors stay on the device in float32, the
line search's scalars come to the host as ``np.float32`` and its branches
are Python ``if``s, one device sync per trial. ``torch.optim.LBFGS`` runs
another line search and would not follow the reference's trajectories.

Each iteration does a value-and-grad at the current point, then one more
for every line-search trial (the reference re-evaluates the point the line
search accepted at the top of the next iteration; so does the port).

The 3D functions ride :func:`..ops.born3d.born_solve_3d_diff`, whose
backward is one adjoint 3D solve, on the same host loop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import FWIConfig, SolverConfig
from ..models.grid import Grid2D
from ..ops.solve import solve_helmholtz
from .objective import (FWIData, estimate_source_strengths, misfit,
                        sample_receivers)
from .regularization import penalty_value

# optax's zoom line search as optax.lbfgs configures it (optax 0.2.6:
# alias.py lbfgs, linesearch.py zoom_linesearch and scale_by_zoom_linesearch).
MAX_LINESEARCH_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INCREASE_FACTOR = 2.0
STEPSIZE_PRECISION = 1e-5
TOL = 0.0

f32 = np.float32


class LBFGSResult(NamedTuple):
    velocity: torch.Tensor      # (ny, nx)
    loss_history: torch.Tensor  # (num_iterations,)


def fwi_loss(slowness_flat, data: FWIData, grid: Grid2D,
             solver: SolverConfig, estimate_sources: bool = True):
    """Masked L2 misfit with per-shot source-strength estimation
    (fwi_loss_function.py:29-103), differentiable in the (ny*nx,) real
    slowness [s/m] (and in ``data.attenuation``)."""
    vel = 1.0 / slowness_flat.reshape(grid.shape)
    u, _ = solve_helmholtz(vel, data.src, data.f, grid, solver,
                           attenuation=data.attenuation)
    rec_sim = sample_receivers(u, data.rx_y, data.rx_x, data.rx_w)
    if estimate_sources:
        s_est = estimate_source_strengths(rec_sim, data.rec_obs)
        rec_sim = rec_sim * s_est[:, None]
    return misfit(rec_sim, data.rec_obs)


# -- the L-BFGS direction (optax.scale_by_lbfgs) -----------------------------

class _Memory(NamedTuple):
    count: int
    params: torch.Tensor        # the last call's parameters
    grad: torch.Tensor          # and gradient
    diff_params: torch.Tensor   # (m, n) parameter differences
    diff_grads: torch.Tensor    # (m, n) gradient differences
    weights: torch.Tensor       # (m,) 1 / <dg, dp>


def _memory(params: torch.Tensor, memory_size: int) -> _Memory:
    if memory_size < 1:
        raise ValueError("memory_size must be >= 1")
    z = torch.zeros((memory_size,) + params.shape, dtype=params.dtype,
                    device=params.device)
    return _Memory(0, torch.zeros_like(params), torch.zeros_like(params), z,
                   z.clone(), torch.zeros(memory_size, dtype=torch.float32,
                                          device=params.device))


def _direction(grad, mem: _Memory, params):
    """(P grad, memory): store the newest difference pair, then the
    two-loop recursion from a scaled identity (<dg, dp> / <dg, dg>; at the
    first call min(1, 1 / |grad|))."""
    m = mem.weights.shape[0]
    idx, prev = mem.count % m, (mem.count - 1) % m
    diff_params, diff_grads = mem.diff_params.clone(), mem.diff_grads.clone()
    weights = mem.weights.clone()
    if mem.count > 0:
        dp, dg = params - mem.params, grad - mem.grad
        curv = torch.dot(dg, dp)
        diff_params[prev], diff_grads[prev] = dp, dg
        weights[prev] = torch.where(curv == 0.0, torch.zeros_like(curv),
                                    1.0 / curv)
        den = torch.dot(dg, dg)
        scale = torch.where(den > 0.0, curv / den, torch.ones_like(den))
    else:
        diff_params[prev] = 0.0
        diff_grads[prev] = 0.0
        weights[prev] = 0.0
        scale = torch.clamp(1.0 / torch.linalg.norm(grad), max=1.0)
    order = [(idx + i) % m for i in range(m)]
    vec, alphas = grad, {}
    for i in reversed(order):
        alphas[i] = weights[i] * torch.dot(diff_params[i], vec)
        vec = vec - alphas[i] * diff_grads[i]
    vec = scale * vec
    for i in order:
        beta = weights[i] * torch.dot(diff_grads[i], vec)
        vec = vec + (alphas[i] - beta) * diff_params[i]
    return vec, _Memory(mem.count + 1, params, grad, diff_params, diff_grads,
                        weights)


# -- the zoom line search (optax.zoom_linesearch) ----------------------------

def _value_and_grad(loss_fn: Callable, params: torch.Tensor):
    """(value, gradient) of ``loss_fn`` at ``params``, both detached."""
    p = params.detach().requires_grad_(True)
    with torch.enable_grad():
        value = loss_fn(p)
        (grad,) = torch.autograd.grad(value, p)
    return value.detach(), grad


def _host(t) -> np.float32:
    return f32(t.item())


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    """Armijo error, relaxed to the approximate-Wolfe condition of Hager and
    Zhang; 0 when met, inf when not a number."""
    err = value - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = np.maximum(slope - (2 * SLOPE_RTOL - 1.0) * slope_init,
                        value - value_init - APPROX_DEC_RTOL * np.abs(value_init))
    err = np.maximum(np.minimum(approx, err), f32(0.0))
    return f32(np.inf) if np.isnan(err) else err


def _curvature_error(slope, slope_init):
    err = np.maximum(np.abs(slope) - CURV_RTOL * np.abs(slope_init), f32(0.0))
    return f32(np.inf) if np.isnan(err) else err


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN when there is none)."""
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0, r1 = fb - fa - fpa * db, fc - fa - fpa * dc
    A = (dc ** 2 * r0 + -(db ** 2) * r1) / denom
    B = (-(dc ** 3) * r0 + db ** 3 * r1) / denom
    return a + (-B + np.sqrt(B * B - 3.0 * A * fpa)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    db = b - a
    B = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * B)


class _Point(NamedTuple):
    stepsize: np.float32
    value: np.float32
    grad: torch.Tensor
    slope: np.float32


class _LineSearch(NamedTuple):
    stepsize: np.float32
    trials: int


def _zoom_linesearch(loss_fn, params, updates, value, grad) -> _LineSearch:
    """A step along ``updates`` meeting the decrease and curvature
    conditions (Nocedal and Wright, algorithms 3.5 and 3.6): first an
    interval search from a unit step, doubling, then a zoom into it by
    cubic, quadratic or bisection steps; after 20 trials, or on an
    interval below 1e-5, the best step with sufficient decrease."""

    def at(stepsize):
        v, g = _value_and_grad(loss_fn, params + float(stepsize) * updates)
        return _Point(stepsize, _host(v), g, _host(torch.dot(g, updates)))

    value_init, slope_init = _host(value), _host(torch.dot(updates, grad))
    cur = _Point(f32(0.0), value_init, grad, slope_init)
    low = high = cubic_ref = cur
    safe = cur
    dec_err = f32(np.inf)
    interval_found = done = failed = False
    count = 0
    with np.errstate(all="ignore"):
        while not (done or failed):
            if not interval_found:
                new = at(f32(1.0) if count == 0
                         else f32(INCREASE_FACTOR * cur.stepsize))
                dec_err = _decrease_error(new.stepsize, new.value, new.slope,
                                          value_init, slope_init)
                err = max(dec_err, _curvature_error(new.slope, slope_init))
                if dec_err <= TOL:
                    safe = new
                set_high = dec_err > 0.0 or (new.value >= cur.value
                                             and count > 0)
                set_low = new.slope >= 0.0 and not set_high
                low, high = (new, cur) if set_low else (cur, new)
                cubic_ref = low
                interval_found = set_high or set_low or err <= TOL
                done = err <= TOL
                failed = count + 1 >= MAX_LINESEARCH_STEPS and not done
                cur = new
            else:
                delta = np.abs(high.stepsize - low.stepsize)
                left = np.minimum(high.stepsize, low.stepsize)
                right = np.maximum(high.stepsize, low.stepsize)
                mid_c = _cubicmin(low.stepsize, low.value, low.slope,
                                  high.stepsize, high.value,
                                  cubic_ref.stepsize, cubic_ref.value)
                mid_q = _quadmin(low.stepsize, low.value, low.slope,
                                 high.stepsize, high.value)
                if left + 0.2 * delta < mid_c < right - 0.2 * delta:
                    middle = mid_c
                elif left + 0.1 * delta < mid_q < right - 0.1 * delta:
                    middle = mid_q
                else:
                    middle = (low.stepsize + high.stepsize) / f32(2.0)
                new = at(f32(middle))
                dec_err = _decrease_error(new.stepsize, new.value, new.slope,
                                          value_init, slope_init)
                err = max(dec_err, _curvature_error(new.slope, slope_init))
                if dec_err <= TOL and new.value < safe.value:
                    safe = new
                done = err <= TOL
                set_high_mid = dec_err > 0.0 or new.value >= low.value
                set_high_low = (new.slope * (high.stepsize - low.stepsize)
                                >= 0.0 and not set_high_mid)
                cubic_ref = high if (set_high_mid or set_high_low) else low
                if set_high_mid:
                    high = new
                elif set_high_low:
                    high = low
                if not set_high_mid:
                    low = new
                failed = ((count + 1 >= MAX_LINESEARCH_STEPS
                           or (delta <= STEPSIZE_PRECISION
                               and safe.stepsize > 0.0)) and not done)
                cur = new
            count += 1
            if failed and (safe.stepsize > 0.0 or np.isinf(dec_err)):
                cur = safe
    return _LineSearch(cur.stepsize, count)


class _Run(NamedTuple):
    params: torch.Tensor
    history: torch.Tensor  # (num_iterations,) record(params, value)
    trials: list           # line-search trials per iteration


def _minimize(loss_fn: Callable, params: torch.Tensor, num_iterations: int,
              memory_size: int, record: Callable = lambda p, v: v) -> _Run:
    """optax.lbfgs(memory_size) with its default zoom line search, one
    value-and-grad at the current point an iteration and one per trial."""
    mem = _memory(params, memory_size)
    history, trials = [], []
    for _ in range(num_iterations):
        value, grad = _value_and_grad(loss_fn, params)
        precond, mem = _direction(grad, mem, params)
        updates = -precond
        ls = _zoom_linesearch(loss_fn, params, updates, value, grad)
        history.append(record(params, value))
        trials.append(ls.trials)
        params = params + float(ls.stepsize) * updates
    return _Run(params, torch.stack(history) if history
                else torch.zeros(0, device=params.device), trials)


def run_lbfgs(vel_init, data: FWIData, grid: Grid2D,
              solver: SolverConfig = SolverConfig(),
              num_iterations: int = 10, memory_size: int = 10,
              estimate_sources: bool = True,
              fwi: FWIConfig | None = None) -> LBFGSResult:
    """L-BFGS inversion (fwi_loss_function.py:106-132) on the data's
    device, over dimensionless slowness (relative to the starting model's
    mean) and a data-normalized misfit: the raw problem (slowness ~7e-4
    s/m, misfit ~1e-16) is too badly scaled for an FP32 line search, and
    both rescalings leave the minimizer unchanged.

    ``fwi`` (optional) adds its regularization: the objective is then
    ``misfit/|d|^2 + lam * R(vel)/(ny*nx)``. The returned history is the
    un-normalized data term at each iteration's starting point."""
    device = data.src.device
    slow0 = (1.0 / torch.as_tensor(vel_init, dtype=torch.float32)
             .to(device)).reshape(-1)
    slow_ref = torch.mean(slow0)
    data_norm = 0.5 * torch.sum(torch.abs(data.rec_obs) ** 2)
    n_pix = grid.ny * grid.nx
    regularized = fwi is not None and bool(fwi.reg_tikhonov or fwi.reg_tv)

    def penalty(p):
        return penalty_value(1.0 / (p * slow_ref).reshape(grid.shape), grid,
                             fwi) / n_pix

    def loss_fn(p):
        total = fwi_loss(p * slow_ref, data, grid, solver,
                         estimate_sources) / data_norm
        return total + penalty(p) if regularized else total

    def record(p, loss):
        data_term = loss - penalty(p) if regularized else loss
        return data_term * data_norm

    run = _minimize(loss_fn, slow0 / slow_ref, num_iterations, memory_size,
                    record)
    vel = 1.0 / (run.params * slow_ref).reshape(grid.shape)
    return LBFGSResult(velocity=vel, loss_history=run.history)


class AttenuationResult(NamedTuple):
    velocity: torch.Tensor      # (ny, nx) [m/s]
    attenuation: torch.Tensor   # (ny, nx) [Np/m]
    loss_history: torch.Tensor  # (num_iterations,) data misfit


def run_lbfgs_attenuation(vel_init, alpha_init, data: FWIData, grid: Grid2D,
                          solver: SolverConfig = SolverConfig(),
                          num_iterations: int = 10, memory_size: int = 10,
                          estimate_sources: bool = True,
                          invert_velocity: bool = False,
                          alpha_scale: float = 50.0,
                          velocity_scale: float = 0.01) -> AttenuationResult:
    """Attenuation inversion by L-BFGS through the lossy differentiable
    solve (k = omega/c + i sgn alpha): the alpha map [Np/m] and, with
    ``invert_velocity``, jointly the sound speed. Parameters are
    dimensionless: alpha / ``alpha_scale`` and, jointly, slowness as
    slow0 (1 + ``velocity_scale`` q), so that both blocks see comparable
    gradient sensitivity. Alpha is clipped at 0 at evaluation."""
    device = data.src.device
    slow0 = (1.0 / torch.as_tensor(vel_init, dtype=torch.float32)
             .to(device)).reshape(-1)
    alpha0 = torch.as_tensor(alpha_init, dtype=torch.float32).to(device) \
        .reshape(-1)
    a_ref = float(f32(alpha_scale))
    vs = float(f32(velocity_scale))
    data_norm = 0.5 * torch.sum(torch.abs(data.rec_obs) ** 2)
    n_pix = slow0.numel()
    zero = torch.zeros((), dtype=torch.float32, device=device)

    def unpack(p):
        slow = slow0 * (1.0 + vs * p[:n_pix]) if invert_velocity else slow0
        alpha = torch.maximum(p[-n_pix:] * a_ref, zero)
        return slow.reshape(grid.shape), alpha.reshape(grid.shape)

    def loss_fn(p):
        slow, alpha = unpack(p)
        d = data._replace(attenuation=alpha)
        return fwi_loss(slow.reshape(-1), d, grid, solver,
                        estimate_sources) / data_norm

    params0 = (torch.cat([torch.zeros_like(slow0), alpha0 / a_ref])
               if invert_velocity else alpha0 / a_ref)
    run = _minimize(loss_fn, params0, num_iterations, memory_size,
                    lambda p, loss: loss * data_norm)
    slow, alpha = unpack(run.params)
    return AttenuationResult(velocity=1.0 / slow, attenuation=alpha,
                             loss_history=run.history)


# -- 3D: L-BFGS over the differentiable 3D solve ------------------------------

class LBFGS3DResult(NamedTuple):
    velocity: torch.Tensor      # (nz, ny, nx)
    loss_history: torch.Tensor  # (num_iterations,)


def fwi_loss_3d(slowness_flat, data, grid, pml, iter_cap: int = 600,
                spectral: str = "auto", use_gmres: bool = True,
                tol: float = 2e-3, restart: int = 8,
                estimate_sources: bool = True, shell_k0=None):
    """Volumetric masked L2 misfit over the differentiable 3D Born solve
    (:func:`..ops.born3d.born_solve_3d_diff`), the 3D form of
    :func:`fwi_loss`: differentiable in the (nz*ny*nx,) real slowness
    [s/m] and, through a ``data.attenuation`` map, in alpha. In
    scattered-field mode (``data.rec_ref``) the background gather is
    subtracted, held constant, and the source scales are not re-fitted."""
    from ..ops.born3d import born_solve_3d_diff
    from .fwi3d import sample_receivers_3d

    vel = 1.0 / slowness_flat.reshape(grid.shape)
    u = born_solve_3d_diff(vel, data.src, data.f, grid, pml, iter_cap,
                           spectral, use_gmres, tol, restart, False,
                           shell_k0, attenuation=data.attenuation)
    rec_sim = sample_receivers_3d(u, data.rx_idx)
    if data.rec_ref is not None:
        rec_sim = rec_sim - data.rec_ref.detach()
        estimate_sources = False
    if estimate_sources:
        s_est = estimate_source_strengths(rec_sim, data.rec_obs)
        rec_sim = rec_sim * s_est[:, None]
    return misfit(rec_sim, data.rec_obs)


def _data_norm_3d(rec_obs):
    return torch.clamp(0.5 * torch.sum(rec_obs.real ** 2 + rec_obs.imag ** 2),
                       min=1e-38)


def run_lbfgs_3d(vel_init, data, grid, pml, iter_cap: int = 600,
                 spectral: str = "auto", use_gmres: bool = True,
                 tol: float = 2e-3, restart: int = 8,
                 num_iterations: int = 10, memory_size: int = 10,
                 estimate_sources: bool = True) -> LBFGS3DResult:
    """3D L-BFGS inversion on the data's device (:func:`_minimize`, the
    port's optax L-BFGS with its zoom line search), with :func:`run_lbfgs`'s
    conditioning: slowness relative to the starting model's mean and a
    data-normalized misfit. A value and gradient costs one forward and one
    adjoint 3D solve; the history is the misfit at each iteration's
    starting point."""
    device = data.src.device
    slow0 = (1.0 / torch.as_tensor(vel_init, dtype=torch.float32)
             .to(device)).reshape(-1)
    slow_ref = torch.mean(slow0)
    data_norm = _data_norm_3d(data.rec_obs)

    def loss_fn(p):
        return fwi_loss_3d(p * slow_ref, data, grid, pml, iter_cap, spectral,
                           use_gmres, tol, restart,
                           estimate_sources) / data_norm

    run = _minimize(loss_fn, slow0 / slow_ref, num_iterations, memory_size,
                    lambda p, loss: loss * data_norm)
    vel = 1.0 / (run.params * slow_ref).reshape(grid.shape)
    return LBFGS3DResult(velocity=vel, loss_history=run.history)


class Attenuation3DResult(NamedTuple):
    velocity: torch.Tensor      # (nz, ny, nx) [m/s]
    attenuation: torch.Tensor   # (nz, ny, nx) [Np/m]
    loss_history: torch.Tensor  # (num_iterations,) data misfit


def run_lbfgs_attenuation_3d(vel_init, alpha_init, data, grid, pml,
                             iter_cap: int = 600, spectral: str = "auto",
                             use_gmres: bool = True, tol: float = 2e-3,
                             restart: int = 8, num_iterations: int = 10,
                             memory_size: int = 10,
                             estimate_sources: bool = True,
                             invert_velocity: bool = False,
                             alpha_scale: float = 50.0,
                             velocity_scale: float = 0.01
                             ) -> Attenuation3DResult:
    """3D attenuation inversion by L-BFGS through the lossy differentiable
    solve, the volumetric form of :func:`run_lbfgs_attenuation` with its
    scaling (alpha / ``alpha_scale``; jointly, slowness as slow0 (1 +
    ``velocity_scale`` q); alpha clipped at 0 at evaluation). The alpha
    gradient is the lossy backward: one adjoint solve an evaluation."""
    device = data.src.device
    slow0 = (1.0 / torch.as_tensor(vel_init, dtype=torch.float32)
             .to(device)).reshape(-1)
    alpha0 = torch.as_tensor(alpha_init, dtype=torch.float32).to(device) \
        .reshape(-1)
    a_ref = float(f32(alpha_scale))
    vs = float(f32(velocity_scale))
    data_norm = _data_norm_3d(data.rec_obs)
    n_pix = slow0.numel()
    zero = torch.zeros((), dtype=torch.float32, device=device)

    def unpack(p):
        slow = slow0 * (1.0 + vs * p[:n_pix]) if invert_velocity else slow0
        alpha = torch.maximum(p[-n_pix:] * a_ref, zero)
        return slow, alpha.reshape(grid.shape)

    def loss_fn(p):
        slow, alpha = unpack(p)
        d = data._replace(attenuation=alpha)
        return fwi_loss_3d(slow, d, grid, pml, iter_cap, spectral, use_gmres,
                           tol, restart, estimate_sources) / data_norm

    params0 = (torch.cat([torch.zeros_like(slow0), alpha0 / a_ref])
               if invert_velocity else alpha0 / a_ref)
    run = _minimize(loss_fn, params0, num_iterations, memory_size,
                    lambda p, loss: loss * data_norm)
    slow, alpha = unpack(run.params)
    return Attenuation3DResult(velocity=(1.0 / slow).reshape(grid.shape),
                               attenuation=alpha, loss_history=run.history)
