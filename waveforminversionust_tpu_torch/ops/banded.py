"""Block-tridiagonal (block-Thomas) direct solver: the plain PyTorch factor
and sweeps (port of ``ops/banded.py`` / ``ops/split_engine.py:279-332,
447-527``).

Row-major ordering makes the 9-point operator block-tridiagonal with ny
blocks of size nx. Within a row the coupling is tridiagonal (C/L/R planes),
between rows tridiagonal as well (D/DL/DR below, U/UL/UR above):

    factor:  G_0 = tri(D_0)^-1;  S_i = tri(D_i) - tri(L_i) G_{i-1} tri(U_{i-1});
             G_i = S_i^-1
    forward solve        adjoint solve (H^H)
    z_0 = b_0            w_0 = G_0^H b_0
    z_i = b_i - L_i G_{i-1} z_{i-1}
                         w_i = G_i^H (b_i - U_{i-1}^H w_{i-1})
    x_e = G_e z_e        x_e = w_e
    x_i = G_i (z_i - U_i x_{i+1})
                         x_i = w_i - G_i^H L_{i+1}^H x_{i+1}

These are the plain versions of the CUDA factor kernel
(:mod:`.kernel_factor`) and sweep kernel (:mod:`.kernel_sweep`): the
inverse is ``torch.linalg.inv`` in a Python loop over rows, the sweeps are
Python loops of batched gemvs. One factor serves the forward, adjoint and
linearized solves of an FWI iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class BandedFactor(NamedTuple):
    g: torch.Tensor       # (ny, nx, nx) complex64 Schur-complement inverses
    coeffs: torch.Tensor  # (9, ny, nx) complex64 planes the factor eliminates


def _shift_x(v: torch.Tensor, d: int) -> torch.Tensor:
    """shift_x(v, d)[..., i] = v[..., i + d], zero padded."""
    if d > 0:
        return F.pad(v[..., d:], (0, d))
    return F.pad(v[..., :d], (-d, 0))


def _tri_matvec(main, sub, sup, v):
    """T v with T[i,i]=main[i], T[i,i-1]=sub[i], T[i,i+1]=sup[i]."""
    return main * v + sub * _shift_x(v, -1) + sup * _shift_x(v, 1)


def _tri_matvec_h(main, sub, sup, v):
    """T^H v for T as in :func:`_tri_matvec` (scatter form)."""
    return (torch.conj(main) * v + _shift_x(torch.conj(sub) * v, 1)
            + _shift_x(torch.conj(sup) * v, -1))


def _tri_dense(main, sub, sup):
    """The tridiagonal block as a dense (nx, nx) matrix."""
    return (torch.diag(main) + torch.diag(sub[1:], -1)
            + torch.diag(sup[:-1], 1))


def _col_op_gu(gmat, main, sub, sup):
    """G @ tri(U): (G U)[:, j] = G[:, j] main[j] + G[:, j+1] sub[j+1]
    + G[:, j-1] sup[j-1]."""
    g_right = F.pad(gmat[:, 1:], (0, 1))
    g_left = F.pad(gmat[:, :-1], (1, 0))
    return (gmat * main[None, :] + g_right * _shift_x(sub, 1)[None, :]
            + g_left * _shift_x(sup, -1)[None, :])


def _row_op_lm(main, sub, sup, m):
    """tri(L) @ M by row combinations."""
    m_up = F.pad(m[:-1, :], (0, 0, 1, 0))     # M[i-1, :]
    m_down = F.pad(m[1:, :], (0, 0, 0, 1))    # M[i+1, :]
    return main[:, None] * m + sub[:, None] * m_up + sup[:, None] * m_down


def schur_complement(coeffs: torch.Tensor, i: int,
                     g_prev: torch.Tensor | None) -> torch.Tensor:
    """S_i = tri(D_i) - tri(L_i) G_{i-1} tri(U_{i-1}) (S_0 = tri(D_0))."""
    c = coeffs
    s = _tri_dense(c[0, i], c[1, i], c[2, i])
    if i == 0:
        return s
    gu = _col_op_gu(g_prev, c[4, i - 1], c[7, i - 1], c[8, i - 1])
    return s - _row_op_lm(c[3, i], c[5, i], c[6, i], gu)


def banded_factor(coeffs: torch.Tensor) -> BandedFactor:
    """Plain block-Thomas factorization of the (9, ny, nx) planes."""
    ny, nx = coeffs.shape[1], coeffs.shape[2]
    g = torch.empty((ny, nx, nx), dtype=coeffs.dtype, device=coeffs.device)
    for i in range(ny):
        g[i] = torch.linalg.inv(
            schur_complement(coeffs, i, g[i - 1] if i else None))
    return BandedFactor(g=g, coeffs=coeffs)


def banded_solve(factor: BandedFactor, b: torch.Tensor,
                 adjoint: bool = False) -> torch.Tensor:
    """Plain sweeps: solve H x = b (or H^H x = b) for b of shape
    (batch, ny, nx) through the stored factor."""
    c, g = factor.coeffs, factor.g
    ny = c.shape[1]
    b = b.to(c.dtype)
    x = torch.empty_like(b)
    if not adjoint:
        z = torch.empty_like(b)
        z[:, 0] = b[:, 0]
        for i in range(1, ny):
            w = z[:, i - 1] @ g[i - 1].T
            z[:, i] = b[:, i] - _tri_matvec(c[3, i], c[5, i], c[6, i], w)
        x[:, -1] = z[:, -1] @ g[-1].T
        for i in range(ny - 2, -1, -1):
            rhs = z[:, i] - _tri_matvec(c[4, i], c[7, i], c[8, i], x[:, i + 1])
            x[:, i] = rhs @ g[i].T
    else:
        w = torch.empty_like(b)
        w[:, 0] = b[:, 0] @ torch.conj(g[0])
        for i in range(1, ny):
            rhs = b[:, i] - _tri_matvec_h(c[4, i - 1], c[7, i - 1],
                                          c[8, i - 1], w[:, i - 1])
            w[:, i] = rhs @ torch.conj(g[i])
        x[:, -1] = w[:, -1]
        for i in range(ny - 2, -1, -1):
            v = _tri_matvec_h(c[3, i + 1], c[5, i + 1], c[6, i + 1],
                              x[:, i + 1])
            x[:, i] = w[:, i] - v @ torch.conj(g[i])
    return x
