"""Block cyclic-reduction factorization of the Helmholtz system (port of
``waveforminversionust_tpu/ops/cyclic.py``).

The system is block tridiagonal over grid rows (tridiagonal (nx, nx)
blocks from the 9-point stencil). Cyclic reduction eliminates all odd
block rows at once: their diagonal inverses are independent, so each level
does one batched inversion (:func:`.batched_inv.batched_inv`, whose pivot
inverse is the CUDA kernel of :mod:`.kernel_inv`) plus batched products,
then recurses on the even rows. log2(ny) levels replace ny sequential
steps, for the factorization and for the solve.

Level 0: the original D/L/U blocks are tridiagonal, so every level-0
product is a banded row/column combination (elementwise, no dense
products). Deeper levels are ``torch.bmm``; these products sit outside any
kernel in the reference too.

One factor serves forward and adjoint (H^H) solves: the conjugate
transpose of a cyclic-reduction factor of H is the cyclic-reduction factor
of H^H,
  down:  b'_t = b_{2t} - Lt_t b_{2t-1} - Ut_t b_{2t+1}
  (adjoint:   b'_t = b_{2t} - DU^H_{t-1} b_{2t-1} - DL^H_t b_{2t+1})
  up:    u_{2t+1} = Dinv_t b - DL_t u_{2t} - DU_t u_{2t+2}
  (adjoint:   u_{2t+1} = Dinv^H_t b - Ut^H_t u_{2t} - Lt^H_{t+1} u_{2t+2})
with Lt = L_even Dinv_left, Ut = U_even Dinv_right, DL = Dinv L_odd,
DU = Dinv U_odd. Unpivoted, like the rest of the direct-solver stack.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .batched_inv import batched_inv


class CRLevel(NamedTuple):
    """One reduction level over m rows: n_odd = m // 2, n_even = m - n_odd."""
    dinv: torch.Tensor  # (n_odd, nx, nx)  inverses of the odd diagonal blocks
    lt: torch.Tensor    # (n_even, nx, nx) L_even @ Dinv(left odd);  lt[0] = 0
    ut: torch.Tensor    # (n_even, nx, nx) U_even @ Dinv(right odd); 0 if unpaired
    dl: torch.Tensor    # (n_odd, nx, nx)  Dinv @ L_odd
    du: torch.Tensor    # (n_odd, nx, nx)  Dinv @ U_odd


class CRFactor(NamedTuple):
    levels: tuple            # tuple[CRLevel, ...], its length set by ny
    dinv_root: torch.Tensor  # (1, nx, nx) inverse of the last reduced block
    coeffs: torch.Tensor     # the (9, ny, nx) planes


# -- batched tridiagonal helpers ----------------------------------------------

def _btri_dense(main, sub, sup):
    """(B, nx) tridiagonal vectors -> (B, nx, nx) dense blocks; row r couples
    to r-1 through sub[r] and to r+1 through sup[r] (as banded._tri_dense)."""
    return (torch.diag_embed(main) + torch.diag_embed(sub[:, 1:], offset=-1)
            + torch.diag_embed(sup[:, :-1], offset=1))


def _btri_left(main, sub, sup, m):
    """Batched tri(T) @ M: (T M)[r, :] = sub_r M[r-1, :] + main_r M[r, :]
    + sup_r M[r+1, :]."""
    m_up = F.pad(m[:, :-1, :], (0, 0, 1, 0))    # M[r-1, :]
    m_down = F.pad(m[:, 1:, :], (0, 0, 0, 1))   # M[r+1, :]
    return (main[:, :, None] * m + sub[:, :, None] * m_up
            + sup[:, :, None] * m_down)


def _btri_right(m, main, sub, sup):
    """Batched M @ tri(T): (M T)[:, c] = M[:, c] main_c + M[:, c+1] sub_{c+1}
    + M[:, c-1] sup_{c-1}."""
    sub_sh = F.pad(sub[:, 1:], (0, 1))[:, None, :]
    sup_sh = F.pad(sup[:, :-1], (1, 0))[:, None, :]
    m_right = F.pad(m[:, :, 1:], (0, 1))
    m_left = F.pad(m[:, :, :-1], (1, 0))
    return m * main[:, None, :] + m_right * sub_sh + m_left * sup_sh


def _pad_tail(m, count: int):
    """Append ``count`` zero entries along the leading axis."""
    if count == 0:
        return m
    return F.pad(m, (0, 0) * (m.dim() - 1) + (0, count))


def _pad_head(m, count: int):
    if count == 0:
        return m
    return F.pad(m, (0, 0) * (m.dim() - 1) + (count, 0))


# -- factorization -------------------------------------------------------------

def _reduce_level(d, l, u, block: int):
    """One dense reduction level: eliminate the odd rows of the (m, nx, nx)
    block-tridiagonal system (l[0] and u[-1] are zero blocks). Returns
    (level, d_new, l_new, u_new) over the m - m // 2 even rows."""
    m = d.shape[0]
    n_odd = m // 2
    n_even = m - n_odd

    l_odd, u_odd = l[1::2], u[1::2]
    dinv = batched_inv(d[1::2], block=block)

    # Dinv of the odd neighbour to the left of even row t (odd index t-1)
    # and to the right (odd index t); zero blocks where unpaired.
    dinv_left = _pad_head(dinv, 1)[:n_even]
    dinv_right = _pad_tail(dinv, n_even - n_odd)[:n_even]

    lt = torch.bmm(l[0::2], dinv_left)
    ut = torch.bmm(u[0::2], dinv_right)
    dl = torch.bmm(dinv, l_odd)
    du = torch.bmm(dinv, u_odd)

    u_odd_left = _pad_head(u_odd, 1)[:n_even]
    l_odd_right = _pad_tail(l_odd, n_even - n_odd)[:n_even]
    l_odd_left = _pad_head(l_odd, 1)[:n_even]
    u_odd_right = _pad_tail(u_odd, n_even - n_odd)[:n_even]

    d_new = d[0::2] - torch.bmm(lt, u_odd_left) - torch.bmm(ut, l_odd_right)
    l_new = -torch.bmm(lt, l_odd_left)
    u_new = -torch.bmm(ut, u_odd_right)
    return CRLevel(dinv, lt, ut, dl, du), d_new, l_new, u_new


def _reduce_level0(coeffs, block: int):
    """Level 0, on the tridiagonal D/L/U blocks: every product is a banded
    row/column combination."""
    c = coeffs
    ny = c.shape[1]
    n_odd = ny // 2
    n_even = ny - n_odd

    # Tridiagonal vectors per block row: D (c0, c1, c2), L (c3, c5, c6),
    # U (c4, c7, c8). L[0] and U[-1] are structurally absent: zeroed below.
    def vecs(slot_m, slot_s, slot_p, rows):
        return [c[slot_m, rows], c[slot_s, rows], c[slot_p, rows]]

    odd = slice(1, None, 2)
    even = slice(0, None, 2)

    dinv = batched_inv(_btri_dense(*vecs(0, 1, 2, odd)), block=block)

    lo = vecs(3, 5, 6, odd)
    uo = vecs(4, 7, 8, odd)
    le = vecs(3, 5, 6, even)
    ue = vecs(4, 7, 8, even)

    def zero_row(t, row):
        out = []
        for v in t:
            v = v.clone()
            v[row] = 0
            out.append(v)
        return out

    le = zero_row(le, 0)        # the first block row has no left neighbour
    if ny % 2 == 1:             # the last row is even iff ny is odd
        ue = zero_row(ue, -1)
    else:
        uo = zero_row(uo, -1)

    dinv_left = _pad_head(dinv, 1)[:n_even]
    dinv_right = _pad_tail(dinv, n_even - n_odd)[:n_even]

    lt = _btri_left(*le, dinv_left)     # L_even @ Dinv_left
    ut = _btri_left(*ue, dinv_right)
    dl = _btri_right(dinv, *lo)         # Dinv @ L_odd
    du = _btri_right(dinv, *uo)

    def head(t):
        return [_pad_head(v, 1)[:n_even] for v in t]

    def tail(t):
        return [_pad_tail(v, n_even - n_odd)[:n_even] for v in t]

    d_even = _btri_dense(*vecs(0, 1, 2, even))
    d_new = (d_even - _btri_right(lt, *head(uo))    # U of the odd-left row
             - _btri_right(ut, *tail(lo)))          # L of the odd-right row
    l_new = -_btri_right(lt, *head(lo))
    u_new = -_btri_right(ut, *tail(uo))
    return CRLevel(dinv, lt, ut, dl, du), d_new, l_new, u_new


def cr_factor(coeffs: torch.Tensor, block: int = 64) -> CRFactor:
    """Cyclic-reduction factorization of the (9, ny, nx) complex64 planes."""
    ny = coeffs.shape[1]
    if ny == 1:
        d = _btri_dense(coeffs[0], coeffs[1], coeffs[2])
        return CRFactor(levels=(), dinv_root=batched_inv(d, block=block),
                        coeffs=coeffs)
    levels = []
    level, d, l, u = _reduce_level0(coeffs, block)
    levels.append(level)
    while d.shape[0] > 1:
        level, d, l, u = _reduce_level(d, l, u, block)
        levels.append(level)
    return CRFactor(levels=tuple(levels),
                    dinv_root=batched_inv(d, block=block), coeffs=coeffs)


# -- solve ---------------------------------------------------------------------

def _gemv(mats, v, adjoint: bool):
    """(B, nx, nx) blocks applied to (B, R, nx) row vectors: M v, or M^H v."""
    if adjoint:
        return torch.bmm(v, torch.conj(mats))
    return torch.bmm(v, mats.transpose(1, 2))


def _fit(v, out_len: int):
    """(B, R, nx) zero-padded or cropped to ``out_len`` along the batch."""
    return _pad_tail(v, max(0, out_len - v.shape[0]))[:out_len]


def cr_solve(factor: CRFactor, b: torch.Tensor,
             adjoint: bool = False) -> torch.Tensor:
    """Solve H x = b (or H^H x = b) through a cyclic-reduction factor; b is
    (batch, ny, nx), as for :func:`.banded.banded_solve`."""
    cur = b.to(factor.coeffs.dtype).transpose(0, 1)   # (ny, R, nx)

    # Down: reduce through the levels, keeping each level's odd RHS.
    odd_rhs = []
    for lev in factor.levels:
        b_odd, b_even = cur[1::2], cur[0::2]
        n_even = b_even.shape[0]
        odd_rhs.append(b_odd)
        b_left = _fit(_pad_head(b_odd, 1), n_even)    # odd row 2t-1
        b_right = _fit(b_odd, n_even)                 # odd row 2t+1
        if not adjoint:
            left = _gemv(lev.lt, b_left, False)
            right = _gemv(lev.ut, b_right, False)
        else:
            # the adjoint down-pass uses (DU_left)^H and (DL_right)^H
            du_l = _pad_head(lev.du, 1)[:n_even]
            dl_r = _pad_tail(lev.dl, n_even - lev.dl.shape[0])[:n_even]
            left = _gemv(du_l, b_left, True)
            right = _gemv(dl_r, b_right, True)
        cur = b_even - left - right

    u = _gemv(factor.dinv_root, cur, adjoint)

    # Up: back-substitute the odd rows of each level, innermost first.
    for lev, b_odd in zip(reversed(factor.levels), reversed(odd_rhs)):
        n_odd = b_odd.shape[0]
        u_left = u[:n_odd]                # even row 2t
        u_right = _fit(u[1:], n_odd)      # even row 2t+2 (or 0)
        if not adjoint:
            u_odd = (_gemv(lev.dinv, b_odd, False)
                     - _gemv(lev.dl, u_left, False)
                     - _gemv(lev.du, u_right, False))
        else:
            lt_next = _pad_tail(lev.lt[1:], 1)[:n_odd]
            u_odd = (_gemv(lev.dinv, b_odd, True)
                     - _gemv(lev.ut[:n_odd], u_left, True)
                     - _gemv(lt_next, u_right, True))
        both = torch.empty((n_odd + u.shape[0],) + tuple(u.shape[1:]),
                           dtype=u.dtype, device=u.device)
        both[0::2] = u
        both[1::2] = u_odd
        u = both

    return u.transpose(0, 1).contiguous()
