"""Helmholtz solves through a direct factor: block-Thomas, twisted or
cyclic reduction (port of the banded subset of
``waveforminversionust_tpu/ops/solve.py``). ``solve_helmholtz`` is
differentiable by ``torch.autograd`` (the reference's custom VJP as
``_FDSolve``: the backward is one adjoint solve through the forward's
factor).

Boundary-row bookkeeping, as in the reference: the planes describe the
balanced operator H_s = D H, D = diag(1/h^2 on the border, 1 inside).
  * forward solve  H u = s   <=>  H_s u = D s        (scale the RHS by D)
  * adjoint solve  H^H u = s <=>  H_s^H w = s, u = D w  (balanced w-space)

Kernel dispatch (see ``config.py``): ``factorization`` "auto"/"pallas" runs
the CUDA factor and sweep kernels (their plain versions on CPU tensors),
"thomas" the plain PyTorch block-Thomas everywhere, "twisted" the CUDA
twisted factor and sweep kernels, "cr" cyclic reduction with the CUDA
batched pivot inverse; ``fused_apply`` "off" runs the plain apply, anything
else the CUDA stencil kernel. The sweeps follow the type of the factor they
are handed, not the configuration: the frozen-factor CG carries a factor
across iterations. No wrapper falls back: a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import SolverConfig, SolverMethod
from ..models.grid import Grid2D
from . import apply, banded, cyclic
from .banded import BandedFactor
from .cyclic import CRFactor
from .kernel_factor import banded_factor_kernel
from .kernel_stencil import h_apply_kernel
from .kernel_sweep import banded_solve_kernel
from .kernel_twisted import twisted_factor_kernel, twisted_solve_kernel
from .twisted import TwistedFactor
from .stencil import STENCIL_OFFSETS
from .stencil import d_map as _d_map
from .stencil import helmholtz_coefficients


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
    precond: None                 # GMRES preconditioner (not ported yet)
    factor: BandedFactor | TwistedFactor | CRFactor | None
    d_map: torch.Tensor           # (ny, nx) float32
    attenuation: torch.Tensor | None = None


def _check_method(cfg: SolverConfig):
    if cfg.method != SolverMethod.BANDED:
        raise NotImplementedError(
            f"method={cfg.method.value!r}: the GMRES and Born solvers are "
            f"ported in a later slice (ROADMAP.md A3); use the banded "
            f"method")


def factor_operator(coeffs: torch.Tensor, cfg: SolverConfig):
    """Direct factorization per ``cfg.factorization``: a
    :class:`BandedFactor`, :class:`TwistedFactor` or :class:`CRFactor`.

    Under "auto" and "thomas" the reference runs the Schulz hybrid or the
    embedded sweep operators when ``factor_schulz_steps > 0`` or
    ``fast_sweeps`` is true; neither is ported, so those raise. "pallas",
    "twisted" and "cr" ignore both fields, as the reference does."""
    mode = cfg.factorization
    if mode in ("auto", "thomas") and (cfg.factor_schulz_steps > 0
                                       or cfg.fast_sweeps is True):
        raise NotImplementedError(
            f"factorization={mode!r} with factor_schulz_steps="
            f"{cfg.factor_schulz_steps} / fast_sweeps={cfg.fast_sweeps}: the "
            f"Schulz hybrid and the embedded sweep operators are ported in a "
            f"later slice (ROADMAP.md C2); set both off or use "
            f"factorization='pallas'")
    if mode in ("auto", "pallas"):
        return banded_factor_kernel(coeffs)
    if mode == "thomas":
        return banded.banded_factor(coeffs)
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
    return (banded.banded_solve if cfg.factorization == "thomas"
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


def make_helmholtz_operator(vel, f, grid: Grid2D,
                            cfg: SolverConfig = SolverConfig(),
                            attenuation=None, pml_fields=None,
                            mesh=None, grid_axis: str = "grid"
                            ) -> HelmholtzOperator:
    """Build the planes of H(vel) and factor them once. ``mesh`` /
    ``grid_axis`` (grid-sharded solves) are ported with the multi-device
    slice; ``mesh`` raises until then."""
    _check_method(cfg)
    if mesh is not None:
        raise NotImplementedError("mesh= (multi-device) is ported in a later "
                                  "slice (ROADMAP.md A, slice 7)")
    vel = torch.as_tensor(vel, dtype=torch.float32)
    coeffs = helmholtz_coefficients(vel, grid, f, cfg.pml, cfg.stencil,
                                    attenuation=attenuation,
                                    pml_fields=pml_fields)
    return HelmholtzOperator(
        vel=vel, f=float(f), coeffs=coeffs, precond=None,
        factor=factor_operator(coeffs, cfg), d_map=_d_map(grid, vel.device),
        attenuation=None if attenuation is None else torch.as_tensor(
            attenuation, dtype=torch.float32, device=vel.device))


def helmholtz_operator_solve(op: HelmholtzOperator, src, grid: Grid2D,
                             cfg: SolverConfig = SolverConfig(),
                             adjoint: bool = False, x0=None, mesh=None,
                             grid_axis: str = "grid", precision=None,
                             extra_refine=None):
    """Solve H u = src (or H^H u = src) with a prepared operator; src is
    (batch, ny, nx) or (ny, nx) complex64.

    ``precision`` (the ``fast_*`` sweeps of the reference) is accepted and
    runs FP32 here. ``x0`` is a Krylov warm start and unused by the banded
    method, as in the reference. ``extra_refine``: one more refinement pass
    against ``op.coeffs`` when true (frozen-factor CG, stale iterations).
    ``mesh`` / ``grid_axis`` come with the multi-device slice; ``mesh``
    raises until then.
    """
    _check_method(cfg)
    if mesh is not None:
        raise NotImplementedError("mesh= (multi-device) is ported in a later "
                                  "slice (ROADMAP.md A, slice 7)")
    src = torch.as_tensor(src).to(torch.complex64)
    single = src.dim() == 2
    if single:
        src = src[None]
    rhs = src if adjoint else src * op.d_map
    u = banded_solve_refined(op.factor, rhs.contiguous(), cfg, adjoint=adjoint,
                             extra_refine=extra_refine,
                             refine_coeffs=op.coeffs)
    if adjoint:
        u = u * op.d_map
    return u[0] if single else u


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
    """Solve H(vel) u = src (or H^H u = src) for a batch of sources, one
    factorization per call; returns (u, SolveInfo) with the true relative
    residual per source. The adjoint factors the H_s^H planes and solves
    in balanced w-space (u = D w), as the reference does.

    Differentiable in ``vel``, ``src`` and ``attenuation`` by
    ``torch.autograd``: the solve is :class:`_FDSolve`, whose backward is
    one adjoint solve through the forward's own factor; the planes'
    cotangent flows into ``vel`` and ``attenuation`` through
    :func:`helmholtz_coefficients`. A complex ``src`` receives
    dL/d conj(src), the conjugate of what ``jax.grad`` returns.

    ``x0``: warm start, held constant. The solve is then for the
    correction from x0, and the residual src - H x0 stays differentiable
    in the planes, so the gradient is that of the cold solve. The residual
    diagnostic is computed outside the graph."""
    _check_method(config)
    vel = torch.as_tensor(vel, dtype=torch.float32)
    src = torch.as_tensor(src).to(device=vel.device, dtype=torch.complex64)
    single = src.dim() == 2
    if single:
        src = src[None]
    coeffs = helmholtz_coefficients(vel, grid, f, config.pml, config.stencil,
                                    attenuation=attenuation)
    if adjoint:
        coeffs = apply.adjoint_coefficients(coeffs)
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
        w = x0 + _FDSolve.apply(coeffs, r0, config)
    else:
        w = _FDSolve.apply(coeffs, rhs, config)
    with torch.no_grad():
        res = make_apply(coeffs.detach(), config)(w.detach()) - rhs.detach()
        rel = torch.sqrt(
            torch.sum(torch.abs(res) ** 2, dim=(1, 2))
            / torch.clamp(torch.sum(torch.abs(rhs.detach()) ** 2, dim=(1, 2)),
                          min=1e-38))
    u = w * dmap if adjoint else w
    return (u[0] if single else u), SolveInfo(rel, -1)
