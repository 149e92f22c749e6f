"""3D convergent Born series Helmholtz solver (port of
``waveforminversionust_tpu.ops.born3d``), the volumetric extension of
:mod:`.born`.

One iteration, or one GMRES matvec, is a 3D spectral transform pair and
elementwise work over the whole batch of volumes. Two routes compute the
transform: ``"fft"``, ``torch.fft.fftn`` over the last three axes (cuFFT
on the card), and ``"dft"``, the DFT as one dense (n, n) product per
axis, which was the JAX package's MXU route on the TPU. The dft route runs
its products on the real and imaginary planes, at a precision the caller
names (:func:`_dft3`). No kernel of the port runs here.

``born_solve_3d_diff`` is the differentiable solve of the 3D L-BFGS,
attenuation and joint inversions: its backward is one adjoint solve.
"""

from __future__ import annotations

import contextlib
import functools
import math

import numpy as np
import torch

from ..config import PMLConfig
from ..models.grid3d import Grid3D
from .krylov import gmres

_AXES = (-3, -2, -1)
_PRECISIONS = ("highest", "high", "default")


@functools.lru_cache(maxsize=None)
def _dft_mats(n: int, device: str):
    """The (n, n) DFT matrix exp(-2 pi i jk / n) as float32 (re, im)
    planes on ``device``; both are symmetric."""
    k = np.arange(n)
    w = np.exp(-2j * np.pi * np.outer(k, k) / n)
    return (torch.as_tensor(w.real.astype(np.float32), device=device),
            torch.as_tensor(w.imag.astype(np.float32), device=device))


@contextlib.contextmanager
def _tf32(on: bool):
    """TF32 tensor-core products for the duration of the block, restoring
    the flag after it (PyTorch has no per-call switch; the package keeps
    TF32 off everywhere else)."""
    if not on:
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _axis_product(p: torch.Tensor, w: torch.Tensor, axis: int):
    """Contract axis ``axis`` of ``p`` (..., nz, ny, nx) with the symmetric
    matrix ``w``: one matmul with no transposed copy."""
    if axis == -1:
        return p @ w
    if axis == -2:
        return w @ p
    lead, (nz, ny, nx) = p.shape[:-3], p.shape[-3:]
    return (w @ p.reshape(*lead, nz, ny * nx)).reshape(p.shape)


def _dft3(x: torch.Tensor, inverse: bool = False,
          precision: str = "highest") -> torch.Tensor:
    """3D DFT over the last three axes of complex64 ``x`` as three dense
    products, one per axis, on the stacked (re, im) planes: two real
    matmuls an axis (by the matrix's real and imaginary planes) and their
    combination, as the JAX package's four real contractions
    (born3d.py:86-89). ``precision``: "highest" full FP32; "high" the card's
    TF32 tensor-core mode (FP32 on the CPU); "default" BF16 operands and
    outputs. Numerically the transform of ``torch.fft.fftn`` / ``ifftn``."""
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got "
                         f"{precision!r}")
    dims = x.shape[-3:]
    p = torch.stack([x.real, x.imag])
    low = precision == "default"
    with _tf32(precision == "high" and x.is_cuda):
        for axis, n in zip(_AXES, dims):
            wr, wi = _dft_mats(int(n), str(x.device))
            if inverse:
                wi = -wi
            if low:
                q = p.to(torch.bfloat16)
                a = _axis_product(q, wr.to(torch.bfloat16), axis).float()
                b = _axis_product(q, wi.to(torch.bfloat16), axis).float()
            else:
                a, b = _axis_product(p, wr, axis), _axis_product(p, wi, axis)
            p = torch.stack([a[0] - b[1], b[0] + a[1]])
    out = torch.complex(p[0], p[1])
    if inverse:
        out = out * (1.0 / float(np.prod(dims)))
    return out


def _use_dft(spectral: str) -> bool:
    """Whether a solve takes the dft route: ``spectral`` "dft" or "fft" as
    named; "auto" the fft route on every device. On the CPU that is the JAX
    package's own choice there. On the card it is the A/B of chip_smoke.py's
    fwi3d phase at the bench's 64^3 x 16 volumes (NVIDIA H100 80GB HBM3,
    700.00 W): a transform pair with the Green's multiply took 0.21-0.28 ms
    by cuFFT, 1.05-1.24 ms by the dft products in FP32 and 0.89 ms in TF32;
    a matvec 0.29-0.37, 1.13-1.18 and 0.97 ms (PERF.md, section 6)."""
    if spectral == "dft":
        return True
    if spectral in ("fft", "auto"):
        return False
    raise ValueError(f"spectral must be auto|fft|dft, got {spectral!r}")


def born_operator_3d(vel, f, grid: Grid3D, pml: PMLConfig,
                     adjoint: bool = False, n_order: int = 9,
                     attenuation=None, spectral: str = "auto",
                     shell_k0=None, spectral_precision="highest",
                     eps_scale: float = 1.0):
    """The 3D CBS split: (greens, v_pot, gamma, n_iter_heuristic) on
    ``vel``'s device, ``greens(w)`` one transform pair by the ``spectral``
    route (``spectral_precision`` applies to the dft route only).

    ``attenuation``: optional (nz, ny, nx) alpha [Np/m]; k = omega/c +
    i sgn alpha, so k^2 gains Re -= alpha^2 and Im += 2 sgn alpha omega/c.
    The adjoint operator is the conjugate, through the sign flip.

    ``shell_k0``: fixed wavenumber [rad/m] of the absorbing shell's tuning;
    None derives it from the medium (sqrt of the mean k^2), detached, as
    are k_0 and eps: the shell and the splitting are the discretization's,
    so no gradient flows through them. ``eps_scale`` rescales eps from the
    classical contraction bound max|V| (the fixed point needs >= 1; GMRES
    needs only a nonsingular system). It is not validated, as in the JAX
    package."""
    nz, ny, nx = grid.shape
    sign = float(pml.sign_convention) * (-1.0 if adjoint else 1.0)
    vel = torch.as_tensor(vel, dtype=torch.float32)
    dev = vel.device
    f32 = dict(dtype=torch.float32, device=dev)
    k_real = torch.tensor(2 * math.pi * float(f), **f32) / vel

    kx = 2 * math.pi * torch.fft.fftfreq(nx, d=grid.dx, **f32)
    ky = 2 * math.pi * torch.fft.fftfreq(ny, d=grid.dy, **f32)
    kz = 2 * math.pi * torch.fft.fftfreq(nz, d=grid.dz, **f32)
    p2 = (kz[:, None, None] ** 2 + ky[None, :, None] ** 2
          + kx[None, None, :] ** 2)

    # Polynomial absorbing shell on all six faces.
    c_att = pml.a0 / pml.l_pml
    if shell_k0 is None:
        k0_b = torch.sqrt(torch.mean(k_real ** 2)).detach()
    else:
        k0_b = torch.tensor(float(shell_k0), **f32)
    x = torch.as_tensor(grid.x, **f32)
    y = torch.as_tensor(grid.y, **f32)
    z = torch.as_tensor(grid.z, **f32)
    x_p = torch.clamp(torch.abs(x) + pml.l_pml - (nx - 1) * grid.dx / 2, min=0.0)
    y_p = torch.clamp(torch.abs(y) + pml.l_pml - (ny - 1) * grid.dy / 2, min=0.0)
    z_p = torch.clamp(torch.abs(z) + pml.l_pml - (nz - 1) * grid.dz / 2, min=0.0)
    r_b = torch.sqrt(z_p[:, None, None] ** 2 + y_p[None, :, None] ** 2
                     + x_p[None, None, :] ** 2)
    cr = c_att * r_b
    trunc_exp = torch.ones_like(cr)
    for m in range(n_order, 0, -1):
        trunc_exp = 1 + trunc_exp * cr / m
    denom = math.factorial(n_order) * trunc_exp
    curve_re = (c_att ** 2) * (n_order - cr) * cr ** (n_order - 1) / denom
    curve_im = ((c_att ** 2) * (2 * k0_b * r_b * sign) * cr ** (n_order - 1)
                / denom)
    if attenuation is not None:
        alpha = torch.as_tensor(attenuation, **f32)
        k2 = torch.complex(k_real ** 2 - alpha ** 2 + curve_re,
                           curve_im + 2 * sign * alpha * k_real)
    else:
        k2 = torch.complex(k_real ** 2 + curve_re, curve_im)
    k = torch.sqrt(k2)

    # k_0 and eps shape only the splitting: the converged solution does
    # not depend on them.
    k_0 = ((torch.min(k.real) + torch.max(k.real)) / 2).detach()
    v_pot0 = torch.complex(k2.real - k_0 ** 2, k2.imag)
    eps = (torch.max(torch.abs(v_pot0)).detach() * sign
           * torch.tensor(eps_scale, **f32))
    v_pot = torch.complex(v_pot0.real, v_pot0.imag - eps)
    inv_eps = 1.0 / eps
    gamma = torch.complex(-inv_eps * v_pot.imag, inv_eps * v_pot.real)

    pseudo_prop_len = 2 * k_0 / torch.abs(eps)
    n_iter = torch.ceil(torch.tensor(grid.diagonal, **f32) / pseudo_prop_len)

    g0 = 1.0 / torch.complex(p2 - k_0 ** 2, -eps * torch.ones_like(p2))

    if _use_dft(spectral):
        def greens(w):
            return _dft3(g0 * _dft3(w, precision=spectral_precision),
                         inverse=True, precision=spectral_precision)
    else:
        def greens(w):
            return torch.fft.ifftn(g0 * torch.fft.fftn(w, dim=_AXES),
                                   dim=_AXES)

    return greens, v_pot, gamma, n_iter


def born_series_solve_3d(vel, src, f, grid: Grid3D,
                         pml: PMLConfig = PMLConfig(a0=20.0, l_pml=12e-3),
                         adjoint: bool = False, n_order: int = 9,
                         iter_cap: int = 2000, iter_scale: float = 1.0,
                         attenuation=None, spectral: str = "auto",
                         shell_k0=None):
    """Solve the 3D Helmholtz equation by the plain convergent Born series.

    ``vel`` (nz, ny, nx) [m/s]; ``src`` (batch, nz, ny, nx) complex. The
    iteration count, min(iter_scale * heuristic, iter_cap), is read on the
    host once; the JAX package's ``fori_loop`` is a Python loop. Returns
    (wavefield complex64, iterations int)."""
    greens, v_pot, gamma, n_heur = born_operator_3d(
        vel, f, grid, pml, adjoint, n_order, attenuation=attenuation,
        spectral=spectral, shell_k0=shell_k0)
    n_iter = min(int((iter_scale * n_heur).to(torch.int32)), int(iter_cap))
    src = torch.as_tensor(src).to(device=v_pot.device, dtype=torch.complex64)
    u = torch.zeros_like(src)
    for _ in range(n_iter):
        u = u - gamma * (u - greens(v_pot * u - src))
    return u, n_iter


def born_gmres_solve_3d(vel, src, f, grid: Grid3D,
                        pml: PMLConfig = PMLConfig(a0=20.0, l_pml=12e-3),
                        adjoint: bool = False, n_order: int = 9,
                        tol: float = 1e-5, maxiter: int = 600,
                        restart: int = 16, attenuation=None,
                        spectral: str = "auto", shell_k0=None,
                        x0=None, spectral_precision="highest",
                        eps_scale: float = 1.0):
    """Krylov-accelerated 3D convergent Born series: restarted GMRES on the
    CBS fixed point's system A u = b, A = gamma (I - G V), b = -gamma G
    src (:func:`..ops.krylov.gmres`); each matvec is one transform pair,
    the cost of one CBS iteration. ``x0``: optional warm start (a previous
    solution, e.g. the last CG iteration's field). Returns (wavefield
    complex64 (batch, nz, ny, nx), matvecs int)."""
    greens, v_pot, gamma, _ = born_operator_3d(
        vel, f, grid, pml, adjoint, n_order, attenuation=attenuation,
        spectral=spectral, shell_k0=shell_k0,
        spectral_precision=spectral_precision, eps_scale=eps_scale)
    src = torch.as_tensor(src).to(device=v_pot.device, dtype=torch.complex64)

    def a_op(u):
        return gamma * (u - greens(v_pot * u))

    res = gmres(a_op, -gamma * greens(src), x0=x0, tol=tol, maxiter=maxiter,
                restart=restart)
    return res.x, res.iterations


def _born3d_impl(vel, rhs, alpha, f, grid, pml, iter_cap, spectral,
                 use_gmres, tol, restart, adjoint, shell_k0):
    if use_gmres:
        u, _ = born_gmres_solve_3d(vel, rhs, f, grid, pml, adjoint=adjoint,
                                   tol=tol, maxiter=iter_cap,
                                   restart=restart, spectral=spectral,
                                   shell_k0=shell_k0, attenuation=alpha)
    else:
        u, _ = born_series_solve_3d(vel, rhs, f, grid, pml, adjoint=adjoint,
                                    iter_cap=iter_cap, spectral=spectral,
                                    shell_k0=shell_k0, attenuation=alpha)
    return u


def _adjoint_state(ctx, g):
    """(lam, s, omega): lam = A^-H g by one solve
    with the ``adjoint`` flag flipped (the sign flip conjugates the lossy
    operator too), and s = sum_b conj(lam) u."""
    vel, alpha, u = ctx.saved_tensors
    args = ctx.args
    lam = _born3d_impl(vel, g.resolve_conj(), alpha, *args[:-2],
                       not args[-2], args[-1])
    s = torch.sum(torch.conj(lam) * u, dim=0)
    return lam, s, 2 * math.pi * args[0]


class _Born3DLossless(torch.autograd.Function):
    """The lossless 3D solve, differentiable in ``vel`` and the right-hand
    side (the JAX package's ``_born3d_diff_lossless``, born3d.py:323-354).
    PyTorch hands the backward g = dL/d(re) + i dL/d(im), which is the JAX
    package's split (re, im) cotangent read as one complex number, so the
    backward is its adjoint-state rule as it stands:

        lam = A^-H g;  rhs_bar = lam;
        vel_bar = -Re(sum_b conj(lam) u) dk^2/dvel,  dk^2/dvel = -2 w^2/c^3.

    The absorbing shell (``shell_k0`` or the medium's detached mean) and
    the splitting are not differentiated; ``f`` gets no gradient."""

    @staticmethod
    def forward(ctx, vel, rhs, *args):
        u = _born3d_impl(vel, rhs, None, *args)
        ctx.save_for_backward(vel, None, u)
        ctx.args = args
        return u

    @staticmethod
    def backward(ctx, g):
        lam, s, omega = _adjoint_state(ctx, g)
        vel = ctx.saved_tensors[0]
        vel_bar = -s.real * (-2.0 * omega ** 2 / vel ** 3)
        return (vel_bar, lam) + (None,) * len(ctx.args)


class _Born3DLossy(torch.autograd.Function):
    """The lossy 3D solve (k = omega/c + i sgn alpha), differentiable in
    ``vel``, the attenuation map ``alpha`` and the right-hand side (the JAX
    package's ``_born3d_diff_lossy``, born3d.py:357-410). k^2 is
    complex-analytic in both real fields, so with s = sum_b conj(lam) u and
    k_c = omega/c + i sgn alpha, sgn the solve's sign convention:

        vel_bar   = -Re(s dk2/dc),     dk2/dc     = -2 (omega/c^2) k_c
        alpha_bar = -Re(s dk2/dalpha), dk2/dalpha = 2 i sgn k_c."""

    @staticmethod
    def forward(ctx, vel, alpha, rhs, *args):
        u = _born3d_impl(vel, rhs, alpha, *args)
        ctx.save_for_backward(vel, alpha, u)
        ctx.args = args
        return u

    @staticmethod
    def backward(ctx, g):
        lam, s, omega = _adjoint_state(ctx, g)
        vel, alpha, _ = ctx.saved_tensors
        pml, adjoint = ctx.args[2], ctx.args[-2]
        sgn = float(pml.sign_convention) * (-1.0 if adjoint else 1.0)
        k_c = torch.complex(omega / vel, sgn * alpha)
        vel_bar = -(s * (-2.0 * (omega / vel ** 2) * k_c)).real
        alpha_bar = -(s * ((2j * sgn) * k_c)).real
        return (vel_bar, alpha_bar, lam) + (None,) * len(ctx.args)


def born_solve_3d_diff(vel, rhs, f, grid: Grid3D,
                       pml: PMLConfig = PMLConfig(a0=20.0, l_pml=12e-3),
                       iter_cap: int = 600, spectral: str = "auto",
                       use_gmres: bool = True, tol: float = 2e-3,
                       restart: int = 8, adjoint: bool = False,
                       shell_k0=None, attenuation=None):
    """Differentiable 3D Helmholtz solve on ``vel``'s device: the GMRES
    (``use_gmres``, ``iter_cap`` its matvec cap) or plain-series solve of
    (batch, nz, ny, nx) complex64 ``rhs``, whose backward is ONE adjoint
    solve (the continuous adjoint-state identity; :class:`_Born3DLossless`,
    :class:`_Born3DLossy` when an ``attenuation`` map is given, which is
    then differentiable too). Returns the wavefield."""
    vel = torch.as_tensor(vel, dtype=torch.float32)
    rhs = torch.as_tensor(rhs).to(device=vel.device, dtype=torch.complex64)
    args = (f, grid, pml, int(iter_cap), spectral, bool(use_gmres),
            float(tol), int(restart), bool(adjoint), shell_k0)
    if attenuation is None:
        return _Born3DLossless.apply(vel, rhs, *args)
    alpha = torch.as_tensor(attenuation, dtype=torch.float32).to(vel.device)
    return _Born3DLossy.apply(vel, alpha, rhs, *args)
