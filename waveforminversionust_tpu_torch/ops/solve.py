"""Helmholtz solves (port of ``waveforminversionust_tpu/ops/solve.py``):
through a direct factor (block-Thomas, twisted or cyclic reduction), by
GMRES on the 9-point system with a shifted-Laplacian preconditioner (one-
or two-level), or by the convergent Born series. ``solve_helmholtz`` is
differentiable by ``torch.autograd`` under every method (the reference's
custom VJPs as ``_FDSolve``, ``_GMRESSolve`` and ``_BornSolve``).

Boundary-row bookkeeping, as in the reference: the planes describe the
balanced operator H_s = D H, D = diag(1/h^2 on the border, 1 inside).
  * forward solve  H u = s   <=>  H_s u = D s        (scale the RHS by D)
  * adjoint solve  H^H u = s <=>  H_s^H w = s, u = D w  (balanced w-space)
The u-space H^H is the broken form for GMRES: its border unknowns carry
unit column weight inside an O(1e6) operator and FP32 GMRES stalls there;
H_s^H only rescales those columns up to the interior's magnitude.

Kernel dispatch (see ``config.py``): ``factorization`` "auto"/"pallas" runs
the CUDA factor and sweep kernels (their plain versions on CPU tensors),
"thomas" the plain PyTorch block-Thomas everywhere, "twisted" the CUDA
twisted factor and sweep kernels, "cr" cyclic reduction with the CUDA
batched pivot inverse; ``fused_apply`` "off" runs the plain apply, anything
else the CUDA stencil kernel, which is also every GMRES matvec. The sweeps
follow the type of the factor they are handed, not the configuration: the
frozen-factor CG carries a factor across iterations. No wrapper falls back:
a CUDA tensor launches the kernel or raises.

GMRES follows the JAX package's split path, the one it runs off the CPU:
the operator path honours ``gmres_two_level`` (the coarse factor is
block-Thomas, K1 and K2 on the card). Born follows its native path, which
honours ``born_krylov``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import SolverConfig, SolverMethod
from ..models.grid import Grid2D
from . import apply, banded, cyclic
from .banded import BandedFactor
from .born import born_gmres_solve, born_series_solve
from .cyclic import CRFactor
from .kernel_factor import banded_factor_kernel
from .kernel_stencil import h_apply_kernel
from .kernel_sweep import banded_solve_kernel
from .kernel_twisted import twisted_factor_kernel, twisted_solve_kernel
from .krylov import gmres
from .preconditioner import (PrecondParams, coarse_grid,
                             make_fft_preconditioner,
                             make_two_level_preconditioner, shifted_k2)
from .twisted import TwistedFactor
from .stencil import STENCIL_OFFSETS
from .stencil import d_map as _d_map
from .stencil import helmholtz_coefficients, stencil_params


class SolveInfo(NamedTuple):
    rel_residual: torch.Tensor  # (batch,) final relative residual
    iterations: int


class HelmholtzOperator(NamedTuple):
    """A prepared operator for one (vel, f): planes, factor and the
    boundary row-scale map. One factor serves the forward, adjoint and
    linearized solves of an FWI iteration."""

    vel: torch.Tensor
    f: float
    coeffs: torch.Tensor          # H_s planes (9, ny, nx) complex64
    precond: PrecondParams | None  # GMRES's shifted-Laplacian parameters
    # the direct factor (banded method), or the two-level GMRES's coarse
    # block-Thomas factor
    factor: BandedFactor | TwistedFactor | CRFactor | None
    d_map: torch.Tensor           # (ny, nx) float32
    attenuation: torch.Tensor | None = None


def factor_operator(coeffs: torch.Tensor, cfg: SolverConfig):
    """Direct factorization per ``cfg.factorization``: a
    :class:`BandedFactor`, :class:`TwistedFactor` or :class:`CRFactor`.

    Under "auto" and "thomas", ``factor_schulz_steps > 0`` or a true
    ``fast_sweeps`` takes the plain block-Thomas factorization with the
    Schulz hybrid and the precomputed sweep operators, on the card too, as
    the reference sends them to its scan path (its ``ops/solve.py:546-576``).
    "pallas", "twisted" and "cr" ignore both fields, as the reference does."""
    mode = cfg.factorization
    hybrid = cfg.factor_schulz_steps > 0 or bool(cfg.fast_sweeps)
    if mode == "thomas" or (mode == "auto" and hybrid):
        return banded.banded_factor(coeffs, cfg.factor_schulz_steps,
                                    precompute_sweeps=bool(cfg.fast_sweeps))
    if mode in ("auto", "pallas"):
        return banded_factor_kernel(coeffs)
    if mode == "twisted":
        return twisted_factor_kernel(coeffs)
    if mode == "cr":
        return cyclic.cr_factor(coeffs)
    if mode == "spike":
        raise NotImplementedError(
            "factorization='spike' (grid-sharded) is ported in a later slice "
            "(ROADMAP.md A, slice 7)")
    raise ValueError(f"unknown factorization {mode!r}")


def _sweeps(factor, cfg: SolverConfig):
    """The solve that goes with ``factor``, chosen by its type (a stale
    factor carried by the frozen-factor CG keeps its own engine)."""
    if isinstance(factor, TwistedFactor):
        return twisted_solve_kernel
    if isinstance(factor, CRFactor):
        return cyclic.cr_solve
    return (banded.banded_solve
            if factor.sweeps is not None or cfg.factorization == "thomas"
            else banded_solve_kernel)


def make_apply(coeffs: torch.Tensor, cfg: SolverConfig, adjoint: bool = False):
    """Operator-apply closure H v (or H^H v): the CUDA stencil kernel (fed
    the re-centred conjugate planes for the adjoint) unless
    ``cfg.fused_apply == "off"``."""
    if cfg.fused_apply == "off":
        if adjoint:
            return lambda v: apply.h_apply_adjoint(coeffs, v)
        return lambda v: apply.h_apply(coeffs, v)
    planes = apply.adjoint_coefficients(coeffs) if adjoint else coeffs
    return lambda v: h_apply_kernel(planes, v.contiguous())


def banded_solve_refined(factor, rhs: torch.Tensor,
                         cfg: SolverConfig, adjoint: bool,
                         extra_refine: bool | None = None,
                         refine_coeffs: torch.Tensor | None = None):
    """Sweeps through ``factor`` plus ``cfg.refine`` refinement passes, plus
    one more when ``extra_refine`` is true (the frozen-factor CG's stale
    iterations). The refinement residual targets ``refine_coeffs``
    (default: the factor's own planes) while the factor, G together with
    its own planes, stays whole: a stale G spliced with current planes is
    not a factorization of anything and its recurrences overflow f32 at
    601 rows."""
    base = _sweeps(factor, cfg)
    x = base(factor, rhs, adjoint=adjoint)
    passes = cfg.refine + (1 if extra_refine else 0)
    if passes:
        opfn = make_apply(factor.coeffs if refine_coeffs is None
                          else refine_coeffs, cfg, adjoint=adjoint)
        for _ in range(passes):
            x = x + base(factor, rhs - opfn(x), adjoint=adjoint)
    return x


def build_operator(vel, f, grid: Grid2D, cfg: SolverConfig = SolverConfig(),
                   adjoint: bool = False, attenuation=None, pml_fields=None):
    """Coefficient planes of H_s (or H_s^H) and the shifted-Laplacian
    parameters for the operator solved: the shift's sign is -1 for the
    forward operator and +1 for the adjoint (the two symbols are
    conjugates, S0 and S1 being real). The planes stay differentiable in
    ``vel`` and ``attenuation``; the parameters are taken from a detached
    ``vel``."""
    coeffs = helmholtz_coefficients(vel, grid, f, cfg.pml, cfg.stencil,
                                    attenuation=attenuation,
                                    pml_fields=pml_fields)
    if adjoint:
        coeffs = apply.adjoint_coefficients(coeffs)
    vel_sg = torch.as_tensor(vel, dtype=torch.float32).detach()
    b, d, e = stencil_params(vel_sg.min(), vel_sg.max(), f, grid.h,
                             grid.aspect, cfg.stencil)
    k2_ref = shifted_k2(vel_sg, f, cfg.shift_beta, 1.0 if adjoint else -1.0)
    return coeffs, PrecondParams(k2_ref=k2_ref, b=b, d=d, e=e)


def _coarse_factor(vel, f, grid: Grid2D, cfg: SolverConfig,
                   attenuation=None) -> BandedFactor:
    """Block-Thomas factor of the re-discretized 2h operator for the
    two-level preconditioner (see ``preconditioner.coarse_grid``): speed
    and attenuation restricted by injection, the same PML and stencil; one
    factorization an operator serves its forward and adjoint corrections.
    It is block-Thomas whatever ``factorization`` says, as in the JAX
    package: the CUDA factor kernel on the card.

    The coarse operator carries a small complex shift, ``cfg.
    coarse_shift_beta`` of k^2 through the attenuation channel (alpha =
    beta_c omega / (2 c)): the unshifted coarse operator is near-singular
    at wavenumbers slightly off the fine operator's, and its correction
    then amplifies those modes."""
    gc = coarse_grid(grid)
    vel_c = torch.as_tensor(vel, dtype=torch.float32).detach()[::2, ::2]
    if attenuation is None:
        att_c = torch.zeros_like(vel_c)
    else:
        att_c = torch.as_tensor(attenuation, dtype=torch.float32,
                                device=vel_c.device)[::2, ::2]
    if cfg.coarse_shift_beta:
        att_c = att_c + torch.tensor(cfg.coarse_shift_beta * math.pi * f,
                                     dtype=torch.float32,
                                     device=vel_c.device) / vel_c
    coeffs_c = helmholtz_coefficients(vel_c, gc, f, cfg.pml, cfg.stencil,
                                      attenuation=att_c)
    return banded_factor_kernel(coeffs_c)


def make_helmholtz_operator(vel, f, grid: Grid2D,
                            cfg: SolverConfig = SolverConfig(),
                            attenuation=None, pml_fields=None,
                            mesh=None, grid_axis: str = "grid"
                            ) -> HelmholtzOperator:
    """Build the planes of H(vel) once, and what the method needs beside
    them: the direct factor (banded), the preconditioner's parameters and,
    with ``gmres_two_level``, the coarse factor (GMRES); the Born solve
    re-derives its operator from ``vel``, ``f`` and ``attenuation``.
    ``mesh`` / ``grid_axis`` (grid-sharded solves) are ported with the
    multi-device slice; ``mesh`` raises until then."""
    if mesh is not None:
        raise NotImplementedError("mesh= (multi-device) is ported in a later "
                                  "slice (ROADMAP.md A, slice 7)")
    vel = torch.as_tensor(vel, dtype=torch.float32)
    precond = factor = None
    if cfg.method == SolverMethod.GMRES:
        coeffs, precond = build_operator(vel, f, grid, cfg,
                                         attenuation=attenuation,
                                         pml_fields=pml_fields)
        if cfg.gmres_two_level:
            factor = _coarse_factor(vel, f, grid, cfg, attenuation)
    else:
        coeffs = helmholtz_coefficients(vel, grid, f, cfg.pml, cfg.stencil,
                                        attenuation=attenuation,
                                        pml_fields=pml_fields)
        if cfg.method == SolverMethod.BANDED:
            factor = factor_operator(coeffs, cfg)
    return HelmholtzOperator(
        vel=vel, f=float(f), coeffs=coeffs, precond=precond,
        factor=factor, d_map=_d_map(grid, vel.device),
        attenuation=None if attenuation is None else torch.as_tensor(
            attenuation, dtype=torch.float32, device=vel.device))


def _gmres_operator_solve(op: HelmholtzOperator, src, grid: Grid2D,
                          cfg: SolverConfig, adjoint: bool, x0=None):
    """Preconditioned GMRES on the balanced system (H_s u = D s, or H_s^H
    w = s and u = D w): every matvec the stencil kernel on the card, the
    one- or two-level preconditioner per ``cfg.gmres_two_level``."""
    coeffs = apply.adjoint_coefficients(op.coeffs) if adjoint else op.coeffs
    a_op = make_apply(coeffs, cfg)
    if cfg.gmres_two_level and op.factor is not None:
        m_inv = make_two_level_preconditioner(
            grid, op.precond, a_op, op.factor, adjoint=adjoint,
            pml_margin=cfg.pml.l_pml + 2 * grid.dx)
    else:
        m_inv = make_fft_preconditioner(grid, op.precond, adjoint=adjoint)
    rhs = src if adjoint else src * op.d_map
    if x0 is not None:
        x0 = torch.as_tensor(x0).to(device=rhs.device, dtype=torch.complex64)
        if x0.dim() == 2:
            x0 = x0[None]
        if adjoint:
            x0 = x0 / op.d_map
    res = gmres(a_op, rhs, m_inv=m_inv, x0=x0, tol=cfg.tol,
                maxiter=cfg.maxiter)
    return res.x * op.d_map if adjoint else res.x


def helmholtz_operator_solve(op: HelmholtzOperator, src, grid: Grid2D,
                             cfg: SolverConfig = SolverConfig(),
                             adjoint: bool = False, x0=None, mesh=None,
                             grid_axis: str = "grid", precision=None,
                             extra_refine=None):
    """Solve H u = src (or H^H u = src) with a prepared operator; src is
    (batch, ny, nx) or (ny, nx) complex64.

    ``precision`` (the ``fast_*`` sweeps of the reference) is accepted and
    runs FP32 here. ``x0`` is GMRES's warm start (u-space) and unused by
    the banded and Born methods, as in the reference. ``extra_refine``: one
    more refinement pass against ``op.coeffs`` when true (frozen-factor CG,
    stale iterations; banded only). ``mesh`` / ``grid_axis`` come with the
    multi-device slice; ``mesh`` raises until then.
    """
    if mesh is not None:
        raise NotImplementedError("mesh= (multi-device) is ported in a later "
                                  "slice (ROADMAP.md A, slice 7)")
    src = torch.as_tensor(src).to(device=op.vel.device, dtype=torch.complex64)
    single = src.dim() == 2
    if single:
        src = src[None]
    if cfg.method == SolverMethod.BORN:
        u = _born_solve_impl(op.vel, src, op.f, grid, cfg, adjoint,
                             attenuation=op.attenuation)
    elif cfg.method == SolverMethod.GMRES:
        u = _gmres_operator_solve(op, src, grid, cfg, adjoint, x0)
    else:
        rhs = src if adjoint else src * op.d_map
        u = banded_solve_refined(op.factor, rhs.contiguous(), cfg,
                                 adjoint=adjoint, extra_refine=extra_refine,
                                 refine_coeffs=op.coeffs)
        if adjoint:
            u = u * op.d_map
    return u[0] if single else u


def _born_solve_impl(vel, rhs, f, grid: Grid2D, cfg: SolverConfig,
                     adjoint: bool, attenuation=None):
    """The Born solve of ``cfg``: GMRES on the CBS system
    (``born_krylov``, the default) or the plain series."""
    if cfg.born_krylov:
        u, _ = born_gmres_solve(vel, rhs, f, grid, cfg.born_pml,
                                adjoint=adjoint, tol=cfg.tol,
                                maxiter=cfg.born_iter_cap,
                                restart=cfg.born_restart,
                                attenuation=attenuation)
    else:
        u, _ = born_series_solve(vel, rhs, f, grid, cfg.born_pml,
                                 adjoint=adjoint, iter_cap=cfg.born_iter_cap,
                                 iter_scale=cfg.born_iter_scale,
                                 attenuation=attenuation)
    return u


def _plane_cotangent(lam: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """sum_b lam * conj(shift_s(u)) for each of the nine stencil slots
    (9, ny, nx): the cotangent of the planes of ``out = H u`` for an output
    cotangent ``lam`` (PyTorch's convention, the one the reference's split
    engine uses, ``ops/solve.py:220-247``)."""
    up = F.pad(torch.conj(u), (1, 1, 1, 1))
    ny, nx = u.shape[-2], u.shape[-1]
    return torch.stack([
        torch.sum(lam * up[:, 1 + dy:1 + dy + ny, 1 + dx:1 + dx + nx], dim=0)
        for dy, dx in STENCIL_OFFSETS])


def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` in plain memory for a kernel that reads its pointer: autograd
    may hand a backward a lazily conjugated or negated view."""
    return t.resolve_conj().resolve_neg().contiguous()


class _FDSolve(torch.autograd.Function):
    """u = H_s^-1 rhs through one direct factor, differentiable in the
    planes and the right-hand side (port of the reference's custom VJP,
    ``ops/solve.py:124-250``). The factor is kept for the backward, which
    is one solve through its ADJOINT sweeps, whatever its engine:

        lam = H_s^-H u_bar;  rhs_bar = lam;
        coeffs_bar[s] = -sum_b lam * conj(shift_s(u))

    PyTorch hands the backward dL/d conj(u), so this is the Hermitian
    solve of the reference's split engine, not the transpose solve of its
    native one. A planes argument that holds H_s^H (an adjoint solve) needs
    nothing else: (H_s^H)^H = H_s, and the factor's adjoint sweeps solve
    it."""

    @staticmethod
    def forward(ctx, coeffs, rhs, cfg):
        factor = factor_operator(_dense(coeffs), cfg)
        u = banded_solve_refined(factor, _dense(rhs), cfg, adjoint=False)
        ctx.factor, ctx.cfg = factor, cfg
        ctx.save_for_backward(u)
        return u

    @staticmethod
    def backward(ctx, u_bar):
        (u,) = ctx.saved_tensors
        factor, cfg = ctx.factor, ctx.cfg
        ctx.factor = None  # G is ~218 MB at 301^2: free it now
        lam = banded_solve_refined(factor, _dense(u_bar), cfg, adjoint=True)
        coeffs_bar = (-_plane_cotangent(lam, u) if ctx.needs_input_grad[0]
                      else None)
        return coeffs_bar, lam, None


class _GMRESSolve(torch.autograd.Function):
    """u = H_s^-1 rhs by right-preconditioned GMRES, differentiable in the
    planes and the right-hand side (the JAX package's split-engine custom
    VJP, ``ops/solve.py:189-250``). GMRES keeps no factor; the backward is
    a GMRES solve of the Hermitian planes with the conjugate-symbol
    preconditioner, which is the solve PyTorch's dL/d conj(u) asks for:

        lam = H_s^-H u_bar;  rhs_bar = lam;
        coeffs_bar[s] = -sum_b lam * conj(shift_s(u))

    Planes that hold H_s^H (an adjoint solve, whose parameters carry the
    adjoint shift) need nothing else: their Hermitian is H_s and the
    conjugate of their symbol is the forward one."""

    @staticmethod
    def forward(ctx, coeffs, rhs, precond, grid, cfg):
        coeffs = _dense(coeffs)
        u = gmres(make_apply(coeffs, cfg), _dense(rhs),
                  m_inv=make_fft_preconditioner(grid, precond),
                  tol=cfg.tol, maxiter=cfg.maxiter).x
        ctx.precond, ctx.grid, ctx.cfg = precond, grid, cfg
        ctx.save_for_backward(coeffs, u)
        return u

    @staticmethod
    def backward(ctx, u_bar):
        coeffs, u = ctx.saved_tensors
        cfg = ctx.cfg
        lam = gmres(make_apply(apply.adjoint_coefficients(coeffs), cfg),
                    _dense(u_bar),
                    m_inv=make_fft_preconditioner(ctx.grid, ctx.precond,
                                                  adjoint=True),
                    tol=cfg.tol, maxiter=cfg.maxiter).x
        coeffs_bar = (-_plane_cotangent(lam, u) if ctx.needs_input_grad[0]
                      else None)
        return coeffs_bar, lam, None, None, None


class _BornSolve(torch.autograd.Function):
    """The Born solve, differentiable in ``vel``, the attenuation map
    ``alpha`` (None for a lossless medium) and the right-hand side (the
    JAX package's ``_born_solve`` and ``_born_solve_lossy``,
    ``ops/solve.py:326-393``, in one function). The Born operator A is
    complex-symmetric (a diagonal potential and an even convolution
    kernel), so the JAX package's transpose solve is a solve with A
    itself; PyTorch hands dL/d conj(u), so here lam = conj(A^-1
    conj(u_bar)), the conjugate of the JAX package's lam. With the interior
    k^2 = (omega/c + i sgn alpha)^2 and s = sum_b conj(lam) u:

        vel_bar   = -Re(s dk2/dc),   dk2/dc     = -2 (omega/c^2) k_c
        alpha_bar = -Re(s dk2/dalpha), dk2/dalpha = 2 i sgn k_c

    (for alpha None the reference's lossless form, dk2/dc = -2 omega^2 /
    c^3). As in the reference, the boundary layer's and the shift's
    dependence on ``vel`` is not differentiated."""

    @staticmethod
    def forward(ctx, vel, alpha, rhs, f, grid, cfg, adjoint):
        u = _born_solve_impl(vel, _dense(rhs), f, grid, cfg, adjoint,
                             attenuation=alpha)
        ctx.save_for_backward(vel, alpha, u)
        ctx.args = (f, grid, cfg, adjoint)
        return u

    @staticmethod
    def backward(ctx, u_bar):
        vel, alpha, u = ctx.saved_tensors
        f, grid, cfg, adjoint = ctx.args
        lam = torch.conj(_born_solve_impl(
            vel, _dense(torch.conj(u_bar)), f, grid, cfg, adjoint,
            attenuation=alpha))
        s = torch.sum(torch.conj(lam) * u, dim=0)
        omega = 2 * math.pi * f
        alpha_bar = None
        if alpha is None:
            vel_bar = -s.real * (-2 * omega ** 2 / vel ** 3)
        else:
            sign = (float(cfg.born_pml.sign_convention)
                    * (-1.0 if adjoint else 1.0))
            k_c = torch.complex(omega / vel, sign * alpha)
            vel_bar = -(s * (-2.0 * (omega / vel ** 2) * k_c)).real
            alpha_bar = -(s * ((2j * sign) * k_c)).real
        return vel_bar, alpha_bar, lam.resolve_conj(), None, None, None, None


class _Apply(torch.autograd.Function):
    """out = H v through the CUDA stencil kernel (the plain apply on CPU
    tensors), differentiable in the planes and v: v_bar = H^H out_bar (the
    kernel on the adjoint planes), coeffs_bar[s] = sum_b out_bar *
    conj(shift_s(v))."""

    @staticmethod
    def forward(ctx, coeffs, v):
        ctx.save_for_backward(coeffs, v)
        return h_apply_kernel(_dense(coeffs), _dense(v))

    @staticmethod
    def backward(ctx, out_bar):
        coeffs, v = ctx.saved_tensors
        out_bar = _dense(out_bar)
        v_bar = coeffs_bar = None
        if ctx.needs_input_grad[1]:
            v_bar = h_apply_kernel(apply.adjoint_coefficients(coeffs), out_bar)
        if ctx.needs_input_grad[0]:
            coeffs_bar = _plane_cotangent(out_bar, v)
        return coeffs_bar, v_bar


def solve_helmholtz(vel, src, f, grid: Grid2D,
                    config: SolverConfig = SolverConfig(),
                    adjoint: bool = False, x0=None, attenuation=None):
    """Solve H(vel) u = src (or H^H u = src) for a batch of sources; returns
    (u, SolveInfo). The FD methods return the true relative residual per
    source; Born returns zeros, as the reference does. The adjoint solves
    the H_s^H planes in balanced w-space (u = D w), as the reference does.

    Differentiable in ``vel``, ``src`` and ``attenuation`` by
    ``torch.autograd`` under every method: the banded solve is
    :class:`_FDSolve` (its backward one adjoint solve through the forward's
    own factor), GMRES :class:`_GMRESSolve` (its backward a GMRES solve of
    the Hermitian planes), Born :class:`_BornSolve`; the planes' cotangent
    flows into ``vel`` and ``attenuation`` through
    :func:`helmholtz_coefficients`. A complex ``src`` receives
    dL/d conj(src), the conjugate of what ``jax.grad`` returns.

    ``x0``: warm start of the FD methods, held constant. The solve is then
    for the correction from x0, and the residual src - H x0 stays
    differentiable in the planes, so the gradient is that of the cold
    solve. Born ignores it, as the reference does. The residual diagnostic
    is computed outside the graph."""
    vel = torch.as_tensor(vel, dtype=torch.float32)
    src = torch.as_tensor(src).to(device=vel.device, dtype=torch.complex64)
    single = src.dim() == 2
    if single:
        src = src[None]
    if config.method == SolverMethod.BORN:
        alpha = (None if attenuation is None else torch.as_tensor(
            attenuation, dtype=torch.float32, device=vel.device))
        u = _BornSolve.apply(vel, alpha, src, float(f), grid, config,
                             bool(adjoint))
        info = SolveInfo(torch.zeros(src.shape[0], device=vel.device), -1)
        return (u[0] if single else u), info
    if config.method == SolverMethod.GMRES:
        coeffs, precond = build_operator(vel, f, grid, config, adjoint,
                                         attenuation)

        def solve(rhs):
            return _GMRESSolve.apply(coeffs, rhs, precond, grid, config)
    else:
        coeffs = helmholtz_coefficients(vel, grid, f, config.pml,
                                        config.stencil,
                                        attenuation=attenuation)
        if adjoint:
            coeffs = apply.adjoint_coefficients(coeffs)

        def solve(rhs):
            return _FDSolve.apply(coeffs, rhs, config)
    dmap = _d_map(grid, vel.device)
    rhs = src if adjoint else src * dmap
    if x0 is not None:
        x0 = torch.as_tensor(x0).detach().to(device=vel.device,
                                             dtype=torch.complex64)
        if x0.dim() == 2:
            x0 = x0[None]
        if adjoint:
            x0 = x0 / dmap
        r0 = rhs - (apply.h_apply(coeffs, x0) if config.fused_apply == "off"
                    else _Apply.apply(coeffs, x0))
        w = x0 + solve(r0)
    else:
        w = solve(rhs)
    with torch.no_grad():
        res = make_apply(coeffs.detach(), config)(w.detach()) - rhs.detach()
        rel = torch.sqrt(
            torch.sum(torch.abs(res) ** 2, dim=(1, 2))
            / torch.clamp(torch.sum(torch.abs(rhs.detach()) ** 2, dim=(1, 2)),
                          min=1e-38))
    u = w * dmap if adjoint else w
    return (u[0] if single else u), SolveInfo(rel, -1)
