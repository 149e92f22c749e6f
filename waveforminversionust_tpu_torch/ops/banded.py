"""Block-tridiagonal (block-Thomas) direct solver: the plain PyTorch factor
and sweeps (port of ``ops/banded.py`` / ``ops/split_engine.py:256-527``),
with the reference's two scan hybrids in complex64: the warm-started
Newton-Schulz row inverse (``schulz_steps``) and the precomputed sweep
operators (``precompute_sweeps``).

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

The hybrids fold the banded factors into dense per-row operators
(:func:`prepare_sweep_ops`), so that a sweep step is one product:

    forward:  z_i = b_i - M_i z_{i-1};  x_i = (G z)_i - N_i x_{i+1}
    adjoint:  w_i = (G^H b)_i - R_i^H w_{i-1};  x_i = w_i - M_{i+1}^H x_{i+1}

    M_i = L_i G_{i-1},  N_i = G_i U_i,  R_i = U_{i-1} G_i

The reference builds them as real embeddings [[Re, -Im], [Im, Re]] for its
matrix unit; here they are complex64 and the adjoint takes A^H directly.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class SweepOps(NamedTuple):
    """The dense per-row sweep operators (see the module docstring), each
    (ny, nx, nx) complex64."""

    m: torch.Tensor  # M_i = L_i G_{i-1}   (m[0] = 0)
    n: torch.Tensor  # N_i = G_i U_i       (n[-1] = 0)
    r: torch.Tensor  # R_i = U_{i-1} G_i   (r[0] = 0)


class BandedFactor(NamedTuple):
    g: torch.Tensor       # (ny, nx, nx) complex64 Schur-complement inverses
    coeffs: torch.Tensor  # (9, ny, nx) complex64 planes the factor eliminates
    # precomputed sweep operators (3x the memory of g), SolverConfig.
    # fast_sweeps; the sweeps use them when present
    sweeps: SweepOps | None = None


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
    + G[:, j-1] sup[j-1] (batched over leading dimensions)."""
    g_right = F.pad(gmat[..., 1:], (0, 1))
    g_left = F.pad(gmat[..., :-1], (1, 0))
    return (gmat * main[..., None, :]
            + g_right * _shift_x(sub, 1)[..., None, :]
            + g_left * _shift_x(sup, -1)[..., None, :])


def _row_op_lm(main, sub, sup, m):
    """tri(L) @ M by row combinations (batched over leading dimensions)."""
    m_up = F.pad(m[..., :-1, :], (0, 0, 1, 0))     # M[i-1, :]
    m_down = F.pad(m[..., 1:, :], (0, 0, 0, 1))    # M[i+1, :]
    return (main[..., :, None] * m + sub[..., :, None] * m_up
            + sup[..., :, None] * m_down)


def schur_complement(coeffs: torch.Tensor, i: int,
                     g_prev: torch.Tensor | None) -> torch.Tensor:
    """S_i = tri(D_i) - tri(L_i) G_{i-1} tri(U_{i-1}) (S_0 = tri(D_0))."""
    c = coeffs
    s = _tri_dense(c[0, i], c[1, i], c[2, i])
    if i == 0:
        return s
    gu = _col_op_gu(g_prev, c[4, i - 1], c[7, i - 1], c[8, i - 1])
    return s - _row_op_lm(c[3, i], c[5, i], c[6, i], gu)


def _schulz_refine(g: torch.Tensor, s_mat: torch.Tensor, steps: int):
    """Newton-Schulz iteration X <- X (2I - S X) from X0 = ``g``: quadratic
    convergence to S^-1 when ||I - S X0|| < 1 (the previous row's inverse
    is such a start where the Schur complements change slowly along y).

    Returns (X, err2): err2 is mean |I - S X_{k-1}|^2 of the last step's
    own product; the residual squares each step, so the returned iterate's
    is ~err2, which the caller uses to take the exact inverse instead when
    the start was outside the convergence basin."""
    eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
    err2 = torch.tensor(float("inf"), device=g.device)
    for _ in range(steps):
        t = 2.0 * eye - s_mat @ g
        err2 = torch.mean(torch.abs(t - eye) ** 2)
        g = g @ t
    return g, err2


# The Schulz hybrid's exact rows, the defaults of the reference's
# banded_factor_cpx (ops/split_engine.py:280): the first _EXACT_HEAD rows,
# the last _EXACT_TAIL, and every _EXACT_EVERY-th row in between.
_EXACT_HEAD = 12
_EXACT_TAIL = 2
_EXACT_EVERY = 16


def banded_factor(coeffs: torch.Tensor, schulz_steps: int = 0,
                  precompute_sweeps: bool = False) -> BandedFactor:
    """Plain block-Thomas factorization of the (9, ny, nx) planes.

    ``schulz_steps > 0`` is the reference's hybrid factorization
    (``ops/split_engine.py:279``): a row's inverse is ``schulz_steps``
    warm-started Newton-Schulz steps from the previous row's, except on
    the first ``_EXACT_HEAD`` rows, the last ``_EXACT_TAIL``, every
    ``_EXACT_EVERY``-th row (an error-compounding reset) and any row whose
    iterate's residual ``err2`` is non-finite or above 1e-6, which take
    the exact inverse. The row loop is a host loop (one read of ``err2`` a
    Schulz row). ``precompute_sweeps`` attaches :func:`prepare_sweep_ops`.
    """
    ny, nx = coeffs.shape[1], coeffs.shape[2]
    g = torch.empty((ny, nx, nx), dtype=coeffs.dtype, device=coeffs.device)
    for i in range(ny):
        s_mat = schur_complement(coeffs, i, g[i - 1] if i else None)
        if (schulz_steps > 0 and _EXACT_HEAD <= i < ny - _EXACT_TAIL
                and i % _EXACT_EVERY):
            g_try, err2 = _schulz_refine(g[i - 1], s_mat, schulz_steps)
            err2 = float(err2)
            if math.isfinite(err2) and err2 <= 1e-6:
                g[i] = g_try
                continue
        g[i] = torch.linalg.inv(s_mat)
    factor = BandedFactor(g=g, coeffs=coeffs)
    if precompute_sweeps:
        factor = factor._replace(sweeps=prepare_sweep_ops(factor))
    return factor


def prepare_sweep_ops(factor: BandedFactor) -> SweepOps:
    """The dense per-row sweep operators M, N, R of ``factor`` (the module
    docstring; reference ``ops/split_engine.py:342``): tridiagonal-times-
    dense products by row and column combinations, all rows at once."""
    g, c = factor.g, factor.coeffs
    zero = torch.zeros_like(g[:1])
    m = _row_op_lm(c[3, 1:], c[5, 1:], c[6, 1:], g[:-1])
    n = _col_op_gu(g[:-1], c[4, :-1], c[7, :-1], c[8, :-1])
    r = _row_op_lm(c[4, :-1], c[7, :-1], c[8, :-1], g[1:])
    return SweepOps(m=torch.cat([zero, m]), n=torch.cat([n, zero]),
                    r=torch.cat([zero, r]))


def _banded_solve_fast(factor: BandedFactor, b: torch.Tensor,
                       adjoint: bool) -> torch.Tensor:
    """The sweeps through the precomputed operators (reference
    ``_banded_solve_fast_cpx``): one batched product a row step, the G z
    (or G^H b) products of all rows in one batched product."""
    ops, g = factor.sweeps, factor.g
    bt = b.to(g.dtype).movedim(1, 0)           # (ny, batch, nx)
    ny = bt.shape[0]
    out = torch.empty_like(bt)
    if not adjoint:
        z = torch.empty_like(bt)
        z[0] = bt[0]
        for i in range(1, ny):
            z[i] = bt[i] - z[i - 1] @ ops.m[i].T
        gz = z @ g.transpose(-1, -2)
        out[-1] = gz[-1]
        for i in range(ny - 2, -1, -1):
            out[i] = gz[i] - out[i + 1] @ ops.n[i].T
    else:
        gb = bt @ torch.conj(g)
        w = torch.empty_like(bt)
        w[0] = gb[0]
        for i in range(1, ny):
            w[i] = gb[i] - w[i - 1] @ torch.conj(ops.r[i])
        out[-1] = w[-1]
        for i in range(ny - 2, -1, -1):
            out[i] = w[i] - out[i + 1] @ torch.conj(ops.m[i + 1])
    return out.movedim(0, 1).contiguous()


def banded_solve(factor: BandedFactor, b: torch.Tensor,
                 adjoint: bool = False) -> torch.Tensor:
    """Plain sweeps: solve H x = b (or H^H x = b) for b of shape
    (batch, ny, nx) through the stored factor (through its precomputed
    sweep operators when it carries them)."""
    if factor.sweeps is not None:
        return _banded_solve_fast(factor, b, adjoint)
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
