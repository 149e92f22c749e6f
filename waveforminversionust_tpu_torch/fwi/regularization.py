"""Model-space regularization for the CG loop (port of
``waveforminversionust_tpu.fwi.regularization``): first-order Tikhonov and
smoothed total variation on the VELOCITY map, differentiated with
``torch.autograd`` through vel = 1/slow.

In nonlinear CG the data misfit has an arbitrary absolute scale, so each
regularizer's gradient is rescaled to the current data-gradient norm:
``grad += lam * |g_data| * g_reg / |g_reg|``. The reported loss stays the
pure data misfit.
"""

from __future__ import annotations

import torch

from ..config import FWIConfig
from ..models.grid import Grid2D


def tikhonov_value(vel, grid: Grid2D):
    """0.5 * sum |grad v|^2 with per-pixel differences."""
    dx = vel[:, 1:] - vel[:, :-1]
    dy = vel[1:, :] - vel[:-1, :]
    return 0.5 * (torch.sum(dx * dx) + torch.sum(dy * dy))


def tv_value(vel, grid: Grid2D, eps: float = 1.0):
    """sum sqrt(|grad v|^2 + eps^2) - eps, forward differences with a
    zero-flux last row/column."""
    dx = torch.diff(vel, dim=1, append=vel[:, -1:])
    dy = torch.diff(vel, dim=0, append=vel[-1:, :])
    return torch.sum(torch.sqrt(dx * dx + dy * dy + float(eps) ** 2)
                     - float(eps))


def penalty_value(vel, grid: Grid2D, fwi: FWIConfig):
    """lam_tik * Tikhonov + lam_tv * TV."""
    val = torch.zeros((), dtype=torch.float32, device=vel.device)
    if fwi.reg_tikhonov:
        val = val + fwi.reg_tikhonov * tikhonov_value(vel, grid)
    if fwi.reg_tv:
        val = val + fwi.reg_tv * tv_value(vel, grid, fwi.reg_tv_eps)
    return val


def make_cg_regularizer(grid: Grid2D, fwi: FWIConfig):
    """``fn(slowness, data_grad) -> extra_grad`` in slowness space, or None
    when no regularization is configured. A zero regularization gradient
    contributes exactly zero."""
    if not (fwi.reg_tikhonov or fwi.reg_tv):
        return None
    terms = [(lam, fn) for lam, fn in (
        (fwi.reg_tikhonov, lambda v: tikhonov_value(v, grid)),
        (fwi.reg_tv, lambda v: tv_value(v, grid, fwi.reg_tv_eps))) if lam]

    def fn(slow, data_grad):
        gnorm = torch.linalg.norm(data_grad)
        extra = torch.zeros_like(slow)
        for lam, value in terms:
            with torch.enable_grad():
                s = slow.detach().requires_grad_(True)
                (g,) = torch.autograd.grad(value(1.0 / s), s)
            rnorm = torch.linalg.norm(g)
            scale = torch.where(rnorm > 0,
                                lam * gnorm / torch.clamp(rnorm, min=1e-30),
                                torch.zeros_like(rnorm))
            extra = extra + scale * g
        return extra

    return fn
