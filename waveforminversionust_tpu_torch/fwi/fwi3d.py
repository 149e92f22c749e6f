"""3D frequency-domain FWI (port of ``waveforminversionust_tpu.fwi.fwi3d``):
the adjoint-state gradient and nonlinear CG over a volume, on the 3D
convergent Born solver (:mod:`..ops.born3d`). The math is the 2D loop's
(reference: nonlinearcg.py:41-180):

    forward:   H(c) u_t = s_t          (all transmitters batched)
    adjoint:   H(c)^H lam_t = P^T r_t  (residual scattered to voxels)
    gradient:  g = -sum_t Re(conj(2 w^2 slow u_t) * lam_t)
    update:    slowness += step * search_dir

The JAX package runs the CG iterations as one ``lax.scan``; here they are
a host loop, and each ``lax.cond`` is a host branch (one flag read an
iteration for the BB step). No kernel of the port runs here: every solve
is the spectral one. ``mesh=`` (the grid-sharded solve) comes with the
multi-device slice and raises until then.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import FWIConfig, PMLConfig, StepSizeFormula
from ..models.acquisition3d import Acquisition3D, source_fields_3d
from ..models.grid3d import Grid3D
from ..ops.born3d import born_gmres_solve_3d, born_series_solve_3d
from .objective import (estimate_source_strengths, illumination_map, misfit,
                        precondition_gradient)
from .optimizers import (CGMetrics, _bb_step_size, _momentum, _step_size,
                         _validate_watchdog, _watchdog_apply)
from .resolution import _fold_in, _prng_key, _rademacher


class FWIData3D(NamedTuple):
    """Device-resident 3D inversion inputs: src (ntx, nz, ny, nx) and
    rec_obs (ntx, n_active) complex64, rx_idx (ntx, n_active, 3) int64
    receiver voxels (iz, iy, ix), f the frequency [Hz] (a float32 value),
    an optional fixed attenuation map alpha [Np/m] and, in scattered-field
    mode (:func:`scattered_data_3d`), the background receiver field
    ``rec_ref`` subtracted from every simulated gather."""

    src: torch.Tensor
    rec_obs: torch.Tensor
    rx_idx: torch.Tensor
    f: float
    attenuation: torch.Tensor | None = None
    rec_ref: torch.Tensor | None = None


def build_fwi_data_3d(acq: Acquisition3D, rec_obs, f, grid: Grid3D,
                      attenuation=None, device=None) -> FWIData3D:
    """FWIData3D from an acquisition and the (ntx, n_active) gathers, on
    ``device`` (default: ``rec_obs``'s if it is a tensor, else the card,
    which raises when there is none)."""
    if device is None and isinstance(rec_obs, torch.Tensor):
        device = rec_obs.device
    src = source_fields_3d(acq, grid, device=device)
    device = src.device
    return FWIData3D(
        src=src,
        rec_obs=torch.as_tensor(rec_obs).to(device=device,
                                            dtype=torch.complex64),
        rx_idx=torch.as_tensor(np.asarray(acq.rx_idx), dtype=torch.long,
                               device=device),
        f=float(np.float32(f)),
        attenuation=(None if attenuation is None else torch.as_tensor(
            attenuation, dtype=torch.float32).to(device)))


def sample_receivers_3d(fields, rx_idx):
    """Gather (ntx, n_active) receiver samples from (ntx, nz, ny, nx)."""
    tx = torch.arange(fields.shape[0], device=fields.device)[:, None]
    return fields[tx, rx_idx[..., 0], rx_idx[..., 1], rx_idx[..., 2]]


def scatter_to_volumes_3d(values, rx_idx, shape):
    """Scatter-add (ntx, n_active) values onto zero (ntx,) + shape volumes
    (the adjoint of :func:`sample_receivers_3d`)."""
    ntx = values.shape[0]
    tx = torch.arange(ntx, device=values.device)[:, None].expand(
        rx_idx.shape[:2])
    out = torch.zeros((ntx,) + tuple(shape), dtype=values.dtype,
                      device=values.device)
    out.index_put_((tx, rx_idx[..., 0], rx_idx[..., 1], rx_idx[..., 2]),
                   values, accumulate=True)
    return out


def encode_supershots(data: FWIData3D, code) -> FWIData3D:
    """Combine the transmit batch into m encoded supershots with the
    (ntx, m) code matrix (random source encoding, Krebs et al. 2009): by
    linearity u(S code) = U code, so the encoded misfit is, in expectation
    over Rademacher codes, the full misfit at m solves instead of ntx. That
    holds only when every transmitter shares one receiver set in one order
    (full aperture, ``build_acquisition3d(..., min_angle=0.0)``), which
    :func:`nonlinear_cg_3d` enforces."""
    code = torch.as_tensor(code, dtype=torch.float32).to(data.src.device)
    m = code.shape[1]
    c = code.to(torch.complex64)
    src = torch.tensordot(c.T, data.src, dims=1)
    rec = c.T @ data.rec_obs
    rx = data.rx_idx[:1].expand((m,) + tuple(data.rx_idx.shape[1:]))
    ref = None if data.rec_ref is None else c.T @ data.rec_ref
    return data._replace(src=src, rec_obs=rec, rx_idx=rx, rec_ref=ref)


def scattered_data_3d(data: FWIData3D, grid: Grid3D, c_ref: float = 1500.0,
                      pml: PMLConfig = PMLConfig(a0=20.0, l_pml=12e-3),
                      iter_cap: int = 600, solver3d: str = "gmres",
                      gmres_tol: float = 1e-5, gmres_restart: int = 16,
                      spectral: str = "auto") -> FWIData3D:
    """Background-subtracted (scattered-field) dataset: one solve in the
    homogeneous ``c_ref`` medium fits the per-shot source scales against
    the background gather; the returned dataset holds the scattered
    observations in simulation units (``rec_obs``) and the background
    gather (``rec_ref``) that :func:`objective_pieces_3d` subtracts. The
    defence when the misfit is dominated by the direct arrival, above all
    under ``encode=``. A tight tolerance (1e-5) keeps direct-wave residue
    out of the gathers."""
    solve = _make_solve_3d(grid, pml, int(iter_cap), solver3d=solver3d,
                           gmres_tol=float(gmres_tol),
                           gmres_restart=int(gmres_restart),
                           spectral=spectral)
    vel0 = torch.full(grid.shape, float(np.float32(c_ref)),
                      dtype=torch.float32, device=data.src.device)
    wv0, _ = solve(vel0, data.src, data.f, attenuation=data.attenuation)
    rec0 = sample_receivers_3d(wv0, data.rx_idx)
    s = estimate_source_strengths(rec0, data.rec_obs)
    return data._replace(rec_obs=data.rec_obs / s[:, None] - rec0,
                         rec_ref=rec0)


def _make_solve_3d(grid: Grid3D, pml: PMLConfig, iter_cap: int,
                   mesh=None, grid_axis: str = "grid",
                   solver3d: str = "cbs", gmres_tol: float = 2e-3,
                   gmres_restart: int = 8, spectral: str = "auto",
                   spectral_precision: str = "highest"):
    """Solver closure ``solve(vel, src, f, adjoint=False, attenuation=None
    [, x0=None])``: the plain CBS (``solver3d="cbs"``) or the
    Krylov-accelerated CBS (``"gmres"``, iter_cap its matvec cap; the only
    one that takes a warm start ``x0``). ``spectral_precision`` is the dft
    route's product precision (:func:`..ops.born3d._dft3`)."""
    if mesh is not None:
        raise NotImplementedError("mesh= (the grid-sharded 3D solve) is "
                                  "ported in a later slice (ROADMAP.md A, "
                                  "slice 7)")
    if solver3d == "gmres":
        return functools.partial(born_gmres_solve_3d, grid=grid, pml=pml,
                                 maxiter=iter_cap, tol=gmres_tol,
                                 restart=gmres_restart, spectral=spectral,
                                 spectral_precision=spectral_precision)
    return functools.partial(born_series_solve_3d, grid=grid, pml=pml,
                             iter_cap=iter_cap, spectral=spectral)


def _rhs_norm(rhs):
    """Per-shot right-hand-side norms, shape (batch, 1, 1, 1): each shot's
    warm start is scaled by its own norm, so shots whose right-hand sides
    shrink at different rates keep tight guesses."""
    axes = tuple(range(1, rhs.dim()))
    return torch.sqrt(torch.sum(rhs.real ** 2 + rhs.imag ** 2, dim=axes,
                                keepdim=True))


def _warm_x0(carry, rhs):
    """GMRES initial guess from an RHS-normalized warm carry, rescaled by
    the current per-shot norms (None without a carry). The first
    iteration's carry is zeros: a cold start plus one residual matvec."""
    if carry is None:
        return None
    return carry * _rhs_norm(rhs)


def _warm_carry(sol, rhs):
    """``sol`` per unit per-shot RHS norm, with every non-finite shot set
    to zero, so one bad solve costs only that shot's warmth instead of
    poisoning the chain (GMRES would return a NaN x0 unchanged)."""
    n = _rhs_norm(rhs)
    out = sol * torch.where(n > 0, 1.0 / n, torch.zeros_like(n))
    axes = tuple(range(1, out.dim()))
    tot = torch.sum(out.real ** 2 + out.imag ** 2, dim=axes, keepdim=True)
    return torch.where(torch.isfinite(tot), out, torch.zeros_like(out))


def objective_pieces_3d(vel, slow, data: FWIData3D, grid: Grid3D,
                        pml: PMLConfig, iter_cap: int,
                        estimate_source: bool = True,
                        fwi_precondition=None,
                        fwi_precondition_eps: float = 1e-2,
                        solve=None, warm=None):
    """One forward and one adjoint solve -> (loss, gradient, virt,
    rec_sim), the 2D adjoint-state identity (nonlinearcg.py:118-127) with
    the 3D Frechet factor 2 omega^2 slow (2 omega (omega slow + i sgn
    alpha) in a lossy medium). ``fwi_precondition="illumination"`` divides
    by the transmit-summed illumination; ``solve`` overrides the solver
    (:func:`_make_solve_3d`).

    ``warm``: optional (forward, adjoint) RHS-normalized carries from the
    previous iteration (``solver3d="gmres"`` only): the solves start from
    them, and the return gains a fifth element, the updated carries."""
    if solve is None:
        solve = _make_solve_3d(grid, pml, iter_cap)
    extra = {} if warm is None else {"x0": _warm_x0(warm[0], data.src)}
    wv, _ = solve(vel, data.src, data.f, attenuation=data.attenuation,
                  **extra)
    wv_raw = wv
    rec_sim = sample_receivers_3d(wv, data.rx_idx)
    if data.rec_ref is not None:
        # Scattered-field mode: the source scales were fitted once by
        # scattered_data_3d; refitting against the small scattered gather
        # would be unstable.
        rec_sim = rec_sim - data.rec_ref
        estimate_source = False
    if estimate_source:
        s_est = estimate_source_strengths(rec_sim, data.rec_obs)
        wv = wv * s_est[:, None, None, None]
        rec_sim = rec_sim * s_est[:, None]
    residual = rec_sim - data.rec_obs
    loss = misfit(rec_sim, data.rec_obs)

    adj_src = scatter_to_volumes_3d(residual, data.rx_idx, grid.shape)
    extra = {} if warm is None else {"x0": _warm_x0(warm[1], adj_src)}
    adj_wv, _ = solve(vel, adj_src, data.f, adjoint=True,
                      attenuation=data.attenuation, **extra)
    omega = 2 * math.pi * data.f
    fr = (2 * omega ** 2 * slow)[None]
    if data.attenuation is None:
        virt = wv * fr
    else:
        sgn = float(np.sign(pml.sign_convention))
        fi = (2 * omega * sgn * data.attenuation)[None]
        virt = wv * torch.complex(fr, fi)
    grad = -torch.sum(virt.real * adj_wv.real + virt.imag * adj_wv.imag,
                      dim=0)
    if fwi_precondition == "illumination":
        grad = precondition_gradient(grad, illumination_map(wv),
                                     fwi_precondition_eps)
    if warm is not None:
        return loss, grad, virt, rec_sim, (_warm_carry(wv_raw, data.src),
                                           _warm_carry(adj_wv, adj_src))
    return loss, grad, virt, rec_sim


def _encoding_code(encode_seed: int, it: int, ntx: int, m: int) -> np.ndarray:
    """The (ntx, m) Rademacher code of iteration ``it``: the bits of the
    JAX package's ``rademacher(fold_in(PRNGKey(encode_seed), it), (ntx,
    m))``."""
    return _rademacher(_fold_in(_prng_key(encode_seed), it), (ntx, m))


class _Carry(NamedTuple):
    vel: torch.Tensor
    slow: torch.Tensor
    search_dir: torch.Tensor
    grad_prev: torch.Tensor
    warm: tuple | None = None            # (forward, adjoint, line search)
    slow_prev: torch.Tensor | None = None  # BB and watchdog
    prev_loss: torch.Tensor | None = None  # watchdog baseline
    restart: torch.Tensor | None = None    # watchdog restart flag


def nonlinear_cg_3d(vel_init, data: FWIData3D, grid: Grid3D,
                    fwi: FWIConfig = FWIConfig(),
                    num_iterations: int | None = None,
                    pml: PMLConfig = PMLConfig(a0=20.0, l_pml=12e-3),
                    iter_cap: int = 600, mesh=None,
                    grid_axis: str = "grid", solver3d: str = "cbs",
                    gmres_tol: float = 2e-3, gmres_restart: int = 8,
                    spectral: str = "auto", encode: int | None = None,
                    encode_seed: int = 0,
                    chunk_iterations: int | None = None,
                    warm_start: bool | str = "auto",
                    spectral_precision: str = "auto"):
    """3D nonlinear-CG inversion on the data's device.

    ``solver3d="gmres"``: every solve Krylov-accelerated CBS (``iter_cap``
    its matvec cap). ``encode=m``: random source encoding, a fresh
    Rademacher code (ntx, m) each iteration from ``encode_seed`` (the JAX
    package's bits, :func:`_encoding_code`), every solve on m supershots;
    needs full aperture; the loss is the encoded misfit. ``warm_start``:
    carry each of the three solves' fields (RHS-normalized, non-finite
    shots zeroed) into the next iteration's GMRES as x0; ``"auto"`` turns it
    on for GMRES without encoding. BB (``fwi.step_size``) runs the
    line-search solve only where its curvature estimate is invalid; the
    watchdog (``fwi.reject_increase``) reverts a loss spike and restarts
    the recurrence. ``chunk_iterations`` is accepted and changes nothing:
    the JAX package splits its scan into programs of k iterations for
    runtimes that bound a program's device time, while this host loop
    carries its state from one iteration to the next anyway.
    ``spectral_precision="auto"`` is ``"high"``, the JAX package's choice
    for the inversion's solves; it acts on the dft route only.

    Returns (velocity (nz, ny, nx), CGMetrics history)."""
    if spectral_precision == "auto":
        spectral_precision = "high"
    if fwi.step_size == StepSizeFormula.BB and encode:
        raise ValueError(
            "step_size=BB is incompatible with encode=: the encoded "
            "gradient is stochastic (fresh code each iteration), so the "
            "previous-iteration curvature estimate is noise")
    _validate_watchdog(fwi)
    if fwi.reject_increase is not None and encode:
        raise ValueError(
            "reject_increase (the nonmonotone watchdog) is "
            "incompatible with encode=: the encoded misfit is a fresh "
            "random projection each iteration, so consecutive-loss "
            "ratios fluctuate without any misstep and the watchdog "
            "would revert good updates")
    if warm_start == "auto":
        warm_start = (solver3d == "gmres" and mesh is None and not encode)
    elif warm_start:
        if solver3d != "gmres":
            raise ValueError("warm_start needs solver3d='gmres' (the CBS "
                             "fixed-point solver takes no initial guess)")
        if mesh is not None:
            raise ValueError("warm_start is single-device only (the "
                             "sharded GMRES takes no x0)")
        if encode:
            raise ValueError("warm_start is incompatible with encode=: "
                             "the sources are redrawn every iteration")
    warm_start = bool(warm_start)
    if encode:
        rx = data.rx_idx
        if not bool(torch.all(rx == rx[:1])):
            raise ValueError(
                "encode= needs one shared receiver ordering across "
                "transmitters (full aperture, build_acquisition3d with "
                "min_angle=0.0); this acquisition has per-tx masks")
    n_iter = int(fwi.num_iterations if num_iterations is None
                 else num_iterations)
    solve = _make_solve_3d(grid, pml, iter_cap, mesh=mesh,
                           grid_axis=grid_axis, solver3d=solver3d,
                           gmres_tol=gmres_tol, gmres_restart=gmres_restart,
                           spectral=spectral,
                           spectral_precision=spectral_precision)
    device = data.src.device
    vel0 = torch.as_tensor(vel_init, dtype=torch.float32).to(device)
    zeros = torch.zeros(grid.shape, dtype=torch.float32, device=device)
    bb = fwi.step_size == StepSizeFormula.BB
    guard = fwi.reject_increase is not None
    zf = torch.zeros_like(data.src)
    carry = _Carry(
        vel=vel0, slow=1.0 / vel0, search_dir=zeros, grad_prev=zeros,
        warm=(zf, zf, zf) if warm_start else None,
        slow_prev=1.0 / vel0 if (bb or guard) else None,
        # +inf baseline: the first iteration can never read as a spike.
        prev_loss=(torch.tensor(float("inf"), device=device) if guard
                   else None),
        restart=torch.tensor(False, device=device) if guard else None)
    step = functools.partial(_cg_step_3d, data=data, grid=grid, fwi=fwi,
                             pml=pml, iter_cap=iter_cap, solve=solve,
                             encode=encode, encode_seed=encode_seed)
    history = []
    for it in range(n_iter):
        carry, m = step(carry, it)
        history.append(m)
    metrics = CGMetrics(*(torch.stack([getattr(m, f) for m in history])
                          if history else torch.zeros(0, device=device)
                          for f in CGMetrics._fields))
    return carry.vel, metrics


def _cg_step_3d(carry: _Carry, it: int, data, grid, fwi, pml, iter_cap,
                solve, encode, encode_seed):
    """One CG iteration (the body of the JAX package's scan)."""
    vel, slow, sd, gprev, warm = (carry.vel, carry.slow, carry.search_dir,
                                  carry.grad_prev, carry.warm)
    bb = fwi.step_size == StepSizeFormula.BB
    guard = fwi.reject_increase is not None
    if encode:
        code = _encoding_code(encode_seed, it, data.src.shape[0], encode)
        data = encode_supershots(data, code)
    pieces = objective_pieces_3d(
        vel, slow, data, grid, pml, iter_cap,
        estimate_source=fwi.estimate_source_strength,
        fwi_precondition=fwi.precondition,
        fwi_precondition_eps=fwi.precondition_eps,
        solve=solve, warm=None if warm is None else warm[:2])
    loss, grad, virt, rec_sim = pieces[:4]

    beta = _momentum(fwi.momentum, it, grad, gprev, sd, fwi.eps_stabilizer)
    if guard:
        # A watchdog restart on the previous iteration invalidates the
        # carried recurrence: steepest descent.
        beta = torch.where(carry.restart, torch.zeros_like(beta), beta)
    sd_new = beta * sd - grad
    # Linearized line search: the third solve, of -virt * sd
    # (nonlinearcg.py:140-159).
    pert_src = virt * (-sd_new)[None]

    def lin_step():
        extra = {} if warm is None else {"x0": _warm_x0(warm[2], pert_src)}
        pert, _ = solve(vel, pert_src, data.f, attenuation=data.attenuation,
                        **extra)
        drec = sample_receivers_3d(pert, data.rx_idx)
        formula = StepSizeFormula.RESIDUAL if bb else fwi.step_size
        sz = _step_size(formula, drec, data.rec_obs, rec_sim, grad, sd_new,
                        fwi.eps_stabilizer)
        return sz, None if warm is None else _warm_carry(pert, pert_src)

    if bb:
        # The line-search solve runs only where the BB2 estimate is invalid
        # (the cold start, a watchdog revert); the warm line-search carry
        # stays as it was on BB iterations.
        bb_sz, valid = _bb_step_size(slow, carry.slow_prev, grad, gprev,
                                     sd_new, fwi.eps_stabilizer)
        step_sz, pert_carry = ((bb_sz, None if warm is None else warm[2])
                               if bool(valid) else lin_step())
    else:
        step_sz, pert_carry = lin_step()

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
                                      carry.prev_loss, slow, carry.slow_prev,
                                      slow_new, vel_new)
    metrics = CGMetrics(loss=loss, grad_norm=torch.linalg.norm(grad),
                        beta=beta, step_size=step_sz)
    new = _Carry(vel=vel_new, slow=slow_new, search_dir=sd_new,
                 grad_prev=grad,
                 warm=None if warm is None else (*pieces[4], pert_carry),
                 slow_prev=slow_next_prev if (bb or guard) else None,
                 prev_loss=prev_loss, restart=restart)
    return new, metrics
