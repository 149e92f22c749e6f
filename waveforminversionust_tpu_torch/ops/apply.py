"""Matrix-free application of the 9-point Helmholtz operator (port of
``waveforminversionust_tpu.ops.apply`` and the split-engine applies).

``(H u)[y, x] = sum_s coeffs[s, y, x] * u[y + dy_s, x + dx_s]`` with a zero
halo. These are the plain PyTorch versions: the CUDA stencil kernel
(:mod:`.kernel_stencil`) is held against :func:`h_apply`, and its adjoint
form is the same kernel fed :func:`adjoint_coefficients` planes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .stencil import STENCIL_OFFSETS


def _shift(u: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """shift(u)[..., y, x] = u[..., y+dy, x+dx], zero outside the domain."""
    ny, nx = u.shape[-2], u.shape[-1]
    up = F.pad(u, (1, 1, 1, 1))
    return up[..., 1 + dy:1 + dy + ny, 1 + dx:1 + dx + nx]


def h_apply(coeffs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Apply H to fields u of shape (..., ny, nx) (gather form)."""
    out = coeffs[0] * u
    for s in range(1, 9):
        dy, dx = STENCIL_OFFSETS[s]
        out = out + coeffs[s] * _shift(u, dy, dx)
    return out


def h_apply_transpose(coeffs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Apply H^T without materializing transposed planes (scatter form)."""
    out = coeffs[0] * u
    for s in range(1, 9):
        dy, dx = STENCIL_OFFSETS[s]
        out = out + _shift(coeffs[s] * u, -dy, -dx)
    return out


def h_apply_adjoint(coeffs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Apply H^H without materializing transposed planes (scatter form)."""
    out = torch.conj(coeffs[0]) * u
    for s in range(1, 9):
        dy, dx = STENCIL_OFFSETS[s]
        out = out + _shift(torch.conj(coeffs[s]) * u, -dy, -dx)
    return out


def transpose_coefficients(coeffs: torch.Tensor) -> torch.Tensor:
    """Planes of H^T in the same 9-plane form: the plane for offset
    -delta_s is coeffs[s] shifted by -delta_s."""
    offset_to_slot = {off: i for i, off in enumerate(STENCIL_OFFSETS)}
    out = [None] * 9
    for s, (dy, dx) in enumerate(STENCIL_OFFSETS):
        out[offset_to_slot[(-dy, -dx)]] = _shift(coeffs[s], -dy, -dx)
    return torch.stack(out)


def adjoint_coefficients(coeffs: torch.Tensor) -> torch.Tensor:
    """Planes of H^H (conjugate transpose), for the gather-form apply."""
    return torch.conj(transpose_coefficients(coeffs)).resolve_conj()


def dense_matrix(coeffs: torch.Tensor) -> torch.Tensor:
    """H as a dense (ny*nx, ny*nx) matrix. Test and debug only."""
    ny, nx = coeffs.shape[-2], coeffs.shape[-1]
    n = ny * nx
    eye = torch.eye(n, dtype=coeffs.dtype, device=coeffs.device)
    cols = h_apply(coeffs, eye.reshape(n, ny, nx))  # H on every basis field
    return cols.reshape(n, n).T
