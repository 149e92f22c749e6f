"""Shifted-Laplacian preconditioners for the 9-point Helmholtz system (port
of ``waveforminversionust_tpu.ops.preconditioner``, complex64 only).

The Helmholtz matrix is indefinite and unpreconditioned Krylov methods
stall. A complex-shifted constant-coefficient Helmholtz operator is
diagonal in Fourier space on a uniform grid, M^-1 v = IFFT(FFT(v) /
symbol), with the discrete symbol of the same 9-point stencil; its Green's
function decays within a few cells, so the FFT grid is padded only to an
efficient size. The FFTs are cuFFT calls on the card (the JAX package left
them to XLA). The two-level form adds a direct coarse-grid correction
through a block-Thomas factor of the re-discretized 2h operator, solved by
the CUDA sweep kernel on the card.

The split (re, im) forms of the JAX package (``shifted_k2_cpx``,
``restrict_cpx``, ``prolong_cpx``, ``make_fft_preconditioner_cpx``) exist
for its TPU runtime and are not ported; the two-level preconditioner here
is the complex64 form of ``make_two_level_preconditioner_cpx``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from ..models.grid import Grid2D
from .kernel_sweep import banded_solve_kernel
from .stencil import constant_stencil_symbol


def good_fft_size(n: int) -> int:
    """Smallest 5-smooth integer >= n (an efficient FFT size)."""
    m = n
    while True:
        k = m
        for p in (2, 3, 5):
            while k % p == 0:
                k //= p
        if k == 1:
            return m
        m += 1


class PrecondParams(NamedTuple):
    """The scalars the preconditioner depends on (0-d tensors)."""

    k2_ref: torch.Tensor  # complex shifted reference wavenumber^2
    b: torch.Tensor
    d: torch.Tensor
    e: torch.Tensor


def shifted_k2(vel, f, beta: float, sign: float) -> torch.Tensor:
    """Complex-shifted reference k^2 = (2 pi f / c_ref)^2 (1 + i beta sign),
    c_ref the mean of the extreme speeds; complex64 0-d. ``sign`` makes the
    shifted operator absorbing for the operator solved: -1 for the forward
    operator, +1 for the adjoint, under the exp(-ikr) convention."""
    vel = torch.as_tensor(vel, dtype=torch.float32)
    c_ref = (torch.min(vel) + torch.max(vel)) / 2
    w = torch.tensor(2 * math.pi * float(f), dtype=torch.float32,
                     device=vel.device)
    k = w / c_ref
    k2 = k * k
    return torch.complex(k2, k2 * torch.tensor(beta * sign,
                                               dtype=torch.float32,
                                               device=vel.device))


def make_fft_preconditioner(grid: Grid2D, params: PrecondParams,
                            adjoint: bool = False) -> Callable:
    """M_inv(v) for fields (..., ny, nx) complex64: zero-pad to a 5-smooth
    size, divide by the symbol in Fourier space, crop. ``adjoint=True``
    applies (M^H)^-1, whose symbol is the conjugate (the constant stencil
    is symmetric)."""
    ny, nx = grid.ny, grid.nx
    nfy, nfx = good_fft_size(ny), good_fft_size(nx)
    symbol = constant_stencil_symbol(params.k2_ref, params.b, params.d,
                                     params.e, grid.h, grid.aspect, nfy, nfx)
    if adjoint:
        symbol = torch.conj(symbol).resolve_conj()
    inv_symbol = 1.0 / symbol

    def m_inv(v):
        w = torch.fft.ifft2(torch.fft.fft2(v, s=(nfy, nfx)) * inv_symbol)
        return w[..., :ny, :nx]

    return m_inv


def coarse_grid(grid: Grid2D) -> Grid2D:
    """The 2h grid on the even fine nodes (the fine nx, ny must be odd so
    that the domain corners coincide, as every ``Grid2D.centered`` grid's
    are)."""
    if grid.nx % 2 == 0 or grid.ny % 2 == 0:
        raise ValueError("two-level coarsening needs odd fine dimensions")
    return Grid2D(nx=(grid.nx + 1) // 2, ny=(grid.ny + 1) // 2,
                  dx=2 * grid.dx, dy=2 * grid.dy, x0=grid.x0, y0=grid.y0)


def _restrict_axis(p, axis):
    """Full-weighting [1/4, 1/2, 1/4] + stride-2 sampling along ``axis``."""
    p = torch.movedim(p, axis, -1)
    n = p.shape[-1]
    pp = F.pad(p, (1, 1))
    out = (0.25 * pp[..., 0:n:2] + 0.5 * pp[..., 1:n + 1:2]
           + 0.25 * pp[..., 2:n + 2:2])
    return torch.movedim(out, -1, axis)


def _prolong_axis(p, axis, n_fine):
    """Linear interpolation of the coarse nodes back to ``n_fine`` points."""
    mid = torch.movedim(p, axis, -1)
    odd = 0.5 * (mid[..., :-1] + mid[..., 1:])
    out = torch.zeros(mid.shape[:-1] + (n_fine,), dtype=p.dtype,
                      device=p.device)
    out[..., 0::2] = mid
    out[..., 1::2] = odd
    return torch.movedim(out, -1, axis)


def make_two_level_preconditioner(grid: Grid2D, params: PrecondParams,
                                  a_op: Callable, coarse_factor,
                                  adjoint: bool = False,
                                  pml_margin: float = 0.0) -> Callable:
    """Two-level (deflated) shifted-Laplacian preconditioner, ADEF form:

        P^-1 v = y + M^-1 (v - A y),   y = P A_c^-1 R v,

    a direct coarse-grid correction through ``coarse_factor`` (the
    block-Thomas factor of the re-discretized 2h operator, one per
    operator; its forward sweeps for the forward operator, its adjoint
    sweeps for the adjoint) followed by the one-level FFT preconditioner on
    the corrected residual. ``a_op``: the fine operator the GMRES solve
    targets. The correction is restricted to the physical region, farther
    than ``pml_margin`` from the border: the coarse PML and the coarse
    border rows' scale differ from the fine ones, and an unmasked
    correction amplifies those components (the JAX package's docstring has
    the measurements)."""
    m_inv = make_fft_preconditioner(grid, params, adjoint=adjoint)
    ny, nx = grid.ny, grid.nx
    dev = coarse_factor.g.device
    x = torch.arange(nx, dtype=torch.float32, device=dev) * grid.dx
    y = torch.arange(ny, dtype=torch.float32, device=dev) * grid.dy
    lx, ly = x[-1], y[-1]
    dist = torch.minimum(torch.minimum(x, lx - x)[None, :],
                         torch.minimum(y, ly - y)[:, None])
    interior = (dist > pml_margin).to(torch.float32)

    def p_inv(v):
        vc = _restrict_axis(_restrict_axis(v * interior, -2), -1)
        yc = banded_solve_kernel(coarse_factor, vc.contiguous(),
                                 adjoint=adjoint)
        yf = _prolong_axis(_prolong_axis(yc, -2, ny), -1, nx) * interior
        return yf + m_inv(v - a_op(yf))

    return p_inv
