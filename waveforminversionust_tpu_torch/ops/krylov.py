"""Batched restarted GMRES for matrix-free complex systems (port of
``waveforminversionust_tpu.ops.krylov.gmres``, complex64).

GMRES minimizes the true residual over the Krylov space each cycle, so it
is monotone by construction and degrades gracefully in FP32; restarts
double as iterative refinement, since each cycle recomputes the true
residual b - A x. Right preconditioning keeps the monitored residual equal
to the true one, and the update needs only the Arnoldi basis V: x +=
M^-1 (V y), so the preconditioned basis is never stored.

The JAX package runs the whole solve as one ``lax.while_loop``. Here the
cycles are a host loop: the host reads whether any lane is unconverged
once a cycle, and solves the cycle's (m+1) x m least-squares problems
(one per right-hand side) on the CPU, where they cost microseconds. The
basis, (m+1) fields a right-hand side (3.2 GB at 256 x 301^2 and m = 16),
is allocated once a solve. The matvecs are the caller's: the CUDA stencil
kernel for the 9-point operator, cuFFT for the preconditioner and the Born
operator. The split form ``gmres_cpx`` is not ported (complex64 only).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class KrylovResult(NamedTuple):
    x: torch.Tensor             # (batch, ...) solution
    rel_residual: torch.Tensor  # (batch,) final true relative residual
    iterations: int             # total matvecs


def _norm2(a: torch.Tensor) -> torch.Tensor:
    """Squared norm of each lane, (batch,) float32: one pass over the
    fields."""
    v = torch.view_as_real(a.reshape(a.shape[0], -1)).reshape(a.shape[0], -1)
    return torch.square(torch.linalg.vector_norm(v, dim=1))


def _least_squares(h: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """min || beta e1 - H y || for each lane, H (batch, m+1, m), by QR with
    the reference's 1e-30 guard on the triangle's diagonal (a lane whose
    basis broke down gives a non-finite y, which the caller's monotone
    guard rejects). Solved on the CPU in complex64; returns y on H's
    device."""
    dev = h.device
    h = h.cpu()
    m = h.shape[-1]
    q, rr = torch.linalg.qr(h, mode="reduced")
    rhs = torch.conj(q[:, 0, :]) * beta.cpu().to(h.dtype)[:, None]
    diag = torch.abs(torch.diagonal(rr, dim1=1, dim2=2))
    eps = 1e-30 * torch.clamp(torch.max(diag, dim=1, keepdim=True).values,
                              min=1e-38)
    rr = rr + torch.eye(m, dtype=h.dtype) * eps[:, :, None]
    y = torch.linalg.solve_triangular(rr, rhs[..., None], upper=True)[..., 0]
    return y.to(dev)


def _gmres_cycle(a_op: Callable, m_inv: Callable, x, r, basis, m: int):
    """One GMRES(m) cycle from iterate x with residual r; ``basis`` is the
    (batch, m+1, n) complex64 scratch for V. Returns the candidate x."""
    batch = r.shape[0]
    n = basis.shape[-1]
    beta = torch.sqrt(_norm2(r))
    h = torch.zeros((batch, m + 1, m), dtype=r.dtype, device=r.device)
    basis[:, 0] = r.reshape(batch, n) / torch.clamp(beta, min=1e-38)[:, None]
    for j in range(m):
        w = a_op(m_inv(basis[:, j].reshape(r.shape))).reshape(batch, n)
        # Modified Gram-Schmidt against v_0 .. v_j.
        for i in range(j + 1):
            hij = torch.linalg.vecdot(basis[:, i], w)   # sum conj(v_i) w
            w = torch.addcmul(w, basis[:, i], hij[:, None], value=-1)
            h[:, i, j] = hij
        hnext = torch.sqrt(_norm2(w))
        h[:, j + 1, j] = hnext.to(h.dtype)
        basis[:, j + 1] = w / torch.clamp(hnext, min=1e-38)[:, None]
    y = _least_squares(h, beta)
    vy = torch.bmm(y[:, None, :], basis[:, :m]).reshape(r.shape)
    return x + m_inv(vy)


def gmres(a_op: Callable, b: torch.Tensor, m_inv: Callable | None = None,
          x0: torch.Tensor | None = None, tol: float = 1e-5,
          maxiter: int = 1000, restart: int = 16) -> KrylovResult:
    """Restarted GMRES, batched over axis 0.

    Args:
        a_op: operator, (batch, ny, nx) -> (batch, ny, nx).
        b: right-hand sides (batch, ny, nx) complex64.
        m_inv: right preconditioner (identity if None).
        x0: warm start (zeros if None).
        tol: true relative-residual target per lane.
        maxiter: matvec cap; cycles run while a lane is unconverged and
            fewer than ``maxiter`` matvecs have run, each counting
            ``restart + 1`` (its Arnoldi steps and the true residual).
        restart: Krylov subspace size per cycle.

    A cycle is accepted per lane only if its true residual is finite and
    no worse than before (the QR of a lane that has already converged can
    give NaN, and NaN > x is false).
    """
    if m_inv is None:
        m_inv = lambda v: v  # noqa: E731
    b = torch.as_tensor(b)
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    r = b - a_op(x) if x0 is not None else b
    bnorm2 = torch.clamp(_norm2(b), min=1e-38)
    tol2 = torch.tensor(tol, dtype=torch.float32) ** 2 * bnorm2
    res = _norm2(r)
    basis = torch.empty((b.shape[0], restart + 1, b[0].numel()),
                        dtype=b.dtype, device=b.device)
    lane = (b.shape[0],) + (1,) * (b.dim() - 1)
    matvecs = 0
    while matvecs < maxiter and bool(torch.any((res > tol2)
                                               & torch.isfinite(res))):
        x_new = _gmres_cycle(a_op, m_inv, x, r, basis, restart)
        r_new = b - a_op(x_new)
        res_new = _norm2(r_new)
        accept = (res_new <= res) & torch.isfinite(res_new)
        x = torch.where(accept.reshape(lane), x_new, x)
        r = torch.where(accept.reshape(lane), r_new, r)
        res = torch.where(accept, res_new, res)
        matvecs += restart + 1
    return KrylovResult(x=x, rel_residual=torch.sqrt(res / bnorm2),
                        iterations=matvecs)
