"""Twisted (two-sided) block-tridiagonal factorization and solve: the plain
PyTorch versions (port of ``waveforminversionust_tpu/ops/twisted.py``).

Block-Thomas (:mod:`.banded`) eliminates the ny block rows strictly
downward, one serial chain of ny dependent steps. A twisted factorization
eliminates from both ends toward a middle row m:

    downward (rows y < m):   S_y = D_y - L_y G_{y-1} U_{y-1},  G_y = S_y^-1
    upward   (rows y > m):   T_y = D_y - U_y B_{y+1} L_{y+1},  B_y = T_y^-1
    middle   (row m):        S_m = D_m - L_m G_{m-1} U_{m-1}
                                       - U_m B_{m+1} L_{m+1},  G_m = S_m^-1

and each solve eliminates inward, then substitutes outward:

    inward:   z_y = b_y - L_y G_{y-1} z_{y-1}        (top,    y = 1..m-1)
              t_y = b_y - U_y B_{y+1} t_{y+1}        (bottom, y = ny-2..m+1)
    middle:   x_m = G_m (b_m - L_m G_{m-1} z_{m-1} - U_m B_{m+1} t_{m+1})
    outward:  x_y = G_y (z_y - U_y x_{y+1})          (top,    y = m-1..0)
              x_y = B_y (t_y - L_y x_{y-1})          (bottom, y = m+1..ny-1)

The two half-chains are independent, so the dependent chain halves at no
extra flops and with no fill-in. The adjoint system H^H x = b has
sub-blocks U_{y-1}^H, diagonals D_y^H and super-blocks L_{y+1}^H; its
downward Schur complements are S_y^H, its upward ones T_y^H and its middle
S_m^H, so the stored inverses serve it conjugate-transposed, with the L and
U planes swapped and shifted one row.

These are the plain versions of the CUDA kernels of :mod:`.kernel_twisted`:
Python loops over rows with ``torch.linalg.inv`` and batched gemvs, in the
style of :mod:`.banded`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .banded import (_col_op_gu, _row_op_lm, _tri_dense, _tri_matvec,
                     _tri_matvec_h)

L_PLANES = (3, 5, 6)  # (main, sub, sup) of tri(L_y)
U_PLANES = (4, 7, 8)  # (main, sub, sup) of tri(U_y)


class TwistedFactor(NamedTuple):
    """``g`` (ny, nx, nx) complex64 in row order: rows < m hold the downward
    inverses G_y, row m the middle inverse, rows > m the upward inverses
    B_y. ``coeffs``: the (9, ny, nx) planes the factor eliminates."""
    g: torch.Tensor
    coeffs: torch.Tensor
    m: int


def middle_row(ny: int) -> int:
    """Default twist row: balances the two chains (ny = 301 -> 150/150)."""
    return (ny - 1) // 2


def check_middle_row(ny: int, m: int | None) -> int:
    if m is None:
        m = middle_row(ny)
    if not 0 < m < ny - 1:
        raise ValueError(f"middle row {m} out of range for ny={ny}")
    return m


def _planes(c, ks, row):
    return c[ks[0], row], c[ks[1], row], c[ks[2], row]


def _schur_term(c, outer, row, g, inner, inner_row):
    """tri(O_row) @ (G @ tri(I_inner_row)) for plane triples O and I."""
    return _row_op_lm(*_planes(c, outer, row),
                      _col_op_gu(g, *_planes(c, inner, inner_row)))


def twisted_factor(coeffs: torch.Tensor, m: int | None = None) -> TwistedFactor:
    """Plain twisted factorization of the (9, ny, nx) planes, for any
    middle row 0 < m < ny - 1 (default :func:`middle_row`)."""
    c = coeffs
    ny, nx = c.shape[1], c.shape[2]
    m = check_middle_row(ny, m)
    g = torch.empty((ny, nx, nx), dtype=c.dtype, device=c.device)

    def diag(y):
        return _tri_dense(c[0, y], c[1, y], c[2, y])

    def down(y):  # L_y G_{y-1} U_{y-1}
        return _schur_term(c, L_PLANES, y, g[y - 1], U_PLANES, y - 1)

    def up(y):    # U_y B_{y+1} L_{y+1}
        return _schur_term(c, U_PLANES, y, g[y + 1], L_PLANES, y + 1)

    g[0] = torch.linalg.inv(diag(0))
    for y in range(1, m):
        g[y] = torch.linalg.inv(diag(y) - down(y))
    g[ny - 1] = torch.linalg.inv(diag(ny - 1))
    for y in range(ny - 2, m, -1):
        g[y] = torch.linalg.inv(diag(y) - up(y))
    g[m] = torch.linalg.inv(diag(m) - down(m) - up(m))
    return TwistedFactor(g=g, coeffs=coeffs, m=m)


def twisted_solve(factor: TwistedFactor, b: torch.Tensor,
                  adjoint: bool = False) -> torch.Tensor:
    """Plain twisted solve of H x = b (or H^H x = b) for b of shape
    (batch, ny, nx) through the stored factor."""
    c, g, m = factor.coeffs, factor.g, factor.m
    ny = c.shape[1]
    b = b.to(c.dtype)
    x = torch.empty_like(b)
    z = torch.empty_like(b)   # z_y on rows < m, t_y on rows > m

    # Which plane triple each pass multiplies by, and on which row relative
    # to the row y it computes. H^H has L'_y = U_{y-1}^H, U'_y = L_{y+1}^H.
    if not adjoint:
        in_top, in_bot = (L_PLANES, 0), (U_PLANES, 0)
        out_top, out_bot = (U_PLANES, 0), (L_PLANES, 0)
    else:
        in_top, in_bot = (U_PLANES, -1), (L_PLANES, 1)
        out_top, out_bot = (L_PLANES, 1), (U_PLANES, -1)

    def gemv(y, v):
        return v @ (torch.conj(g[y]) if adjoint else g[y].T)

    def tri(which, y, v):
        ks, shift = which
        op = _tri_matvec_h if adjoint else _tri_matvec
        return op(*_planes(c, ks, y + shift), v)

    z[:, 0] = b[:, 0]
    for y in range(1, m):
        z[:, y] = b[:, y] - tri(in_top, y, gemv(y - 1, z[:, y - 1]))
    z[:, ny - 1] = b[:, ny - 1]
    for y in range(ny - 2, m, -1):
        z[:, y] = b[:, y] - tri(in_bot, y, gemv(y + 1, z[:, y + 1]))

    r_mid = (b[:, m] - tri(in_top, m, gemv(m - 1, z[:, m - 1]))
             - tri(in_bot, m, gemv(m + 1, z[:, m + 1])))
    x[:, m] = gemv(m, r_mid)

    for y in range(m - 1, -1, -1):
        x[:, y] = gemv(y, z[:, y] - tri(out_top, y, x[:, y + 1]))
    for y in range(m + 1, ny):
        x[:, y] = gemv(y, z[:, y] - tri(out_bot, y, x[:, y - 1]))
    return x
