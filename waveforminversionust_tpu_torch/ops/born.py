"""Convergent Born series (CBS) Helmholtz solver, spectral and matrix-free
(port of ``waveforminversionust_tpu.ops.born``).

After Osnabrugge, Leedumrongwatthanakun & Vellekoop (J. Comput. Phys.
2016; reference: Functions/solveHelmholtzBornSeries.m): split the
heterogeneous operator into a constant absorbing background, solved
exactly by FFT, plus a scattering potential V, and iterate the
preconditioned fixed point

    u <- u - gamma (u - G(V u - src)),   gamma = i V / eps,

which converges when eps >= max|k^2 - k0^2|. The Green's operator G is one
FFT pair (cuFFT on the card) over the unpadded grid: padding would change
the periodic operator and so the answer. No kernel of the port runs here.

The solver discretizes the continuous operator spectrally, so it does not
reproduce the 9-point stencil's solutions; the absorbing boundary is the
polynomial boundary curve of Osnabrugge et al. (N = 9), as the reference's.
"""

from __future__ import annotations

import math

import torch

from ..config import PMLConfig
from ..models.grid import Grid2D
from .krylov import gmres


def _boundary_curve(r, c, n_order: int, k0, sign):
    """Polynomial absorbing-boundary k^2 increment:
    f(r) = c^2 (N - c r + 2 i k0 r sign) (c r)^(N-1) / (N! P(c r)), P the
    exponential's Taylor polynomial of order N (solveHelmholtzBornSeries.m:
    28-31)."""
    cr = c * r
    # Truncated exponential sum_{m=0..N} (cr)^m / m! via Horner.
    trunc_exp = torch.ones_like(cr)
    for m in range(n_order, 0, -1):
        trunc_exp = 1 + trunc_exp * cr / m
    num = (c ** 2) * torch.complex(n_order - cr, 2 * k0 * r * sign) \
        * cr ** (n_order - 1)
    return num / (math.factorial(n_order) * trunc_exp)


def born_operator(vel, f, grid: Grid2D, pml: PMLConfig = PMLConfig(),
                  adjoint: bool = False, n_order: int = 9,
                  attenuation=None):
    """The CBS split: (greens, v_pot, gamma, n_iter_heuristic), with
    ``greens(w) = IFFT(g0 * FFT(w))`` on ``vel``'s device and the
    physics-derived iteration count (0-d float32) per unit ``iter_scale``.

    ``attenuation``: optional (ny, nx) alpha map [Np/m]; the interior
    wavenumber becomes k = omega/c + i sgn alpha, as in the FD engines. The
    adjoint operator is the conjugate, through the same sign flip."""
    vel = torch.as_tensor(vel, dtype=torch.float32)
    dev = vel.device
    ny, nx = grid.ny, grid.nx
    dx, dy = grid.dx, grid.dy
    sign = float(pml.sign_convention) * (-1.0 if adjoint else 1.0)

    k_real = torch.tensor(2 * math.pi * float(f), dtype=torch.float32,
                          device=dev) / vel
    k = k_real.to(torch.complex64)
    if attenuation is not None:
        alpha = torch.as_tensor(attenuation, dtype=torch.float32, device=dev)
        k = k + torch.complex(torch.zeros_like(alpha), sign * alpha)

    # Fourier grid (angular wavenumbers), fftfreq convention.
    kx = 2 * math.pi * torch.fft.fftfreq(nx, d=dx, dtype=torch.float32,
                                         device=dev)
    ky = 2 * math.pi * torch.fft.fftfreq(ny, d=dy, dtype=torch.float32,
                                         device=dev)
    p2 = (kx[None, :] ** 2 + ky[:, None] ** 2).to(torch.complex64)

    # The boundary layer is tuned on the real background wavenumber.
    c_att = pml.a0 / pml.l_pml
    k0_b = torch.sqrt(torch.mean(k_real * k_real))
    x = torch.as_tensor(grid.x, dtype=torch.float32, device=dev)
    y = torch.as_tensor(grid.y, dtype=torch.float32, device=dev)
    x_pml = torch.clamp(torch.abs(x) + pml.l_pml - (nx - 1) * dx / 2, min=0.0)
    y_pml = torch.clamp(torch.abs(y) + pml.l_pml - (ny - 1) * dy / 2, min=0.0)
    r_b = torch.sqrt(x_pml[None, :] ** 2 + y_pml[:, None] ** 2)
    k = torch.sqrt(k * k + _boundary_curve(r_b, c_att, n_order, k0_b, sign))

    # Scattering potential and convergence shift
    # (solveHelmholtzBornSeries.m:39-49).
    k_0 = (torch.min(k.real) + torch.max(k.real)) / 2
    v_pot = k * k - k_0 * k_0
    eps = torch.max(torch.abs(v_pot)) * sign
    v_pot = v_pot - 1j * eps
    gamma = 1j / eps * v_pot

    pseudo_prop_len = 2 * k_0 / torch.abs(eps)
    n_iter = torch.ceil(torch.tensor(grid.diagonal, dtype=torch.float32,
                                     device=dev) / pseudo_prop_len)

    g0_k = 1.0 / (p2 - (k_0 * k_0 + 1j * eps))

    def greens(w):
        return torch.fft.ifft2(g0_k * torch.fft.fft2(w))

    return greens, v_pot, gamma, n_iter


def born_series_solve(vel, src, f, grid: Grid2D, pml: PMLConfig = PMLConfig(),
                      adjoint: bool = False, n_order: int = 9,
                      iter_cap: int = 1000, iter_scale: float = 1.0,
                      attenuation=None):
    """Solve the Helmholtz equation by the plain convergent Born series (the
    reference's Richardson loop, solveHelmholtzBornSeries.m:66-70).

    ``src``: (batch, ny, nx) complex sources; ``adjoint`` solves the
    conjugated equation. The iteration count, min(iter_scale * heuristic,
    iter_cap), is read on the host once. Returns (wavefield complex64,
    iterations int)."""
    greens, v_pot, gamma, n_heur = born_operator(vel, f, grid, pml, adjoint,
                                                 n_order,
                                                 attenuation=attenuation)
    n_iter = min(int((iter_scale * n_heur).to(torch.int32)), int(iter_cap))
    src = torch.as_tensor(src).to(device=v_pot.device, dtype=torch.complex64)
    u = torch.zeros_like(src)
    for _ in range(n_iter):
        u = u - gamma * (u - greens(v_pot * u - src))
    return u, n_iter


def born_gmres_solve(vel, src, f, grid: Grid2D, pml: PMLConfig = PMLConfig(),
                     adjoint: bool = False, n_order: int = 9,
                     tol: float = 1e-5, maxiter: int = 600,
                     restart: int = 16, attenuation=None):
    """Krylov-accelerated convergent Born series: restarted GMRES on the
    CBS fixed point's linear system A u = b, A = gamma (I - G V), b = -gamma
    G src, whose spectrum lies in the unit disk centred at 1. Each matvec is
    one FFT pair, the cost of one CBS iteration. Returns (wavefield,
    matvecs)."""
    greens, v_pot, gamma, _ = born_operator(vel, f, grid, pml, adjoint,
                                            n_order, attenuation=attenuation)
    src = torch.as_tensor(src).to(device=v_pot.device, dtype=torch.complex64)

    def a_op(u):
        return gamma * (u - greens(v_pot * u))

    res = gmres(a_op, -gamma * greens(src), tol=tol, maxiter=maxiter,
                restart=restart)
    return res.x, res.iterations
