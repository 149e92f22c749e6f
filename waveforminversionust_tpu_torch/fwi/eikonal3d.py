"""3D first-arrival eikonal solver and bent-ray tracing (port of
``waveforminversionust_tpu.fwi.eikonal3d``), the volumetric form of
:mod:`.eikonal` for the 3D acquisitions.

The same Jacobi iteration with per-source freezing (:func:`.eikonal._jacobi`)
over a (ns, nz, ny, nx) stack. The 3D local solver sorts the three
axis-neighbour minima with three compare-swaps and falls through the
1-, 2- and 3-sided quadratics without branches. Ray tracing and receiver
sampling are :mod:`.eikonal`'s dimension-generic ones with trilinear
interpolation. No kernel of the port runs here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..models.grid3d import Grid3D
from . import eikonal
from .eikonal import _INF

f32 = np.float32
# the +INF clamp of the missing neighbours, 2 * INF * 1e-6 in FP32
_CLAMP = float(f32(f32(2.0) * f32(_INF)) * f32(1e-6))


def _sort3(m1, w1, m2, w2, m3, w3):
    """Sort three (value, weight) pairs by value: 3 compare-swaps."""
    def cswap(ma, wa, mb, wb):
        c = ma > mb
        return (torch.where(c, mb, ma), torch.where(c, wb, wa),
                torch.where(c, ma, mb), torch.where(c, wa, wb))

    m1, w1, m2, w2 = cswap(m1, w1, m2, w2)
    m2, w2, m3, w3 = cswap(m2, w2, m3, w3)
    m1, w1, m2, w2 = cswap(m1, w1, m2, w2)
    return m1, w1, m2, w2, m3, w3


def _upwind_update_3d(t, slowness, dx: float, dy: float, dz: float):
    """One Jacobi sweep of the 3D upwind Godunov local solver (all voxels)
    on (..., nz, ny, nx) times: ``sum_i w_i (T - m_i)+^2 = s^2`` by the
    sorted fall-through (the 1-sided root off the smallest neighbour; if it
    exceeds the next neighbour, the 2-sided root; if that exceeds the
    largest, the 3-sided root)."""
    pad_z = F.pad(t, (0, 0, 0, 0, 1, 1), value=_INF)
    pad_y = F.pad(t, (0, 0, 1, 1), value=_INF)
    pad_x = F.pad(t, (1, 1), value=_INF)
    mz = torch.minimum(pad_z[..., :-2, :, :], pad_z[..., 2:, :, :])
    my = torch.minimum(pad_y[..., :-2, :], pad_y[..., 2:, :])
    mx = torch.minimum(pad_x[..., :-2], pad_x[..., 2:])
    s2 = slowness * slowness
    m1, w1, m2, w2, m3, w3 = _sort3(
        mz, torch.full_like(mz, float(f32(1.0 / dz ** 2))),
        my, torch.full_like(my, float(f32(1.0 / dy ** 2))),
        mx, torch.full_like(mx, float(f32(1.0 / dx ** 2))))
    # clamp the +INF neighbours so the quadratics stay finite; the
    # fall-through conditions still pick the lower-order root where a
    # neighbour is missing
    m2c = torch.minimum(m2, m1 + _CLAMP)
    m3c = torch.minimum(m3, m1 + _CLAMP)

    t1 = m1 + slowness / torch.sqrt(w1)
    # 2-sided (axes 1, 2): A t^2 - 2 B t + C = 0
    a2 = w1 + w2
    b2 = w1 * m1 + w2 * m2c
    c2 = w1 * m1 * m1 + w2 * m2c * m2c - s2
    t2 = (b2 + torch.sqrt(torch.clamp(b2 * b2 - a2 * c2, min=0.0))) / a2
    # 3-sided
    a3 = a2 + w3
    b3 = b2 + w3 * m3c
    c3 = c2 + w3 * m3c * m3c
    t3 = (b3 + torch.sqrt(torch.clamp(b3 * b3 - a3 * c3, min=0.0))) / a3

    cand = torch.where(t1 <= m2, t1, torch.where(t2 <= m3, t2, t3))
    return torch.minimum(t, cand)


def eikonal_solve_batch_3d(slowness, src_pos, grid: Grid3D,
                           max_iters: int | None = None,
                           tol: float | None = None, device=None):
    """First-arrival travel-time volumes of a stack of point sources:
    (ns, nz, ny, nx) float32 [s] for the (ns, 3) physical (x, y, z)
    ``src_pos``; see :func:`eikonal_solve_3d`."""
    return eikonal._solve(slowness, src_pos, grid,
                          lambda t, s: _upwind_update_3d(t, s, grid.dx,
                                                         grid.dy, grid.dz),
                          max_iters, tol, device)[0]


def eikonal_solve_3d(slowness, src_pos, grid: Grid3D,
                     max_iters: int | None = None, tol: float | None = None,
                     device=None):
    """First-arrival travel-time volume of a point source: |grad T| = s.

    Args:
        slowness: (nz, ny, nx) [s/m], strictly positive.
        src_pos: (3,) physical (x, y, z) source location [m].
        max_iters: Jacobi cap (default ``2 * (nx + ny + nz)``).
        tol: convergence threshold on ``max |T_new - T|`` [s] (default
            1e-5 * min(dx, dy, dz) * min(s)).
        device: where the solve runs (default: ``slowness``'s device if it
            is a tensor, else the card, which raises when there is none).

    Returns:
        (nz, ny, nx) float32 travel times [s].
    """
    src = torch.as_tensor(src_pos, dtype=torch.float32)
    return eikonal_solve_batch_3d(slowness, src[None], grid, max_iters, tol,
                                  device)[0]


def eikonal_receiver_times_3d(t_fields, src_idx, rx_pos, grid: Grid3D):
    """Sample per-source travel-time volumes at receiver positions, on the
    volumes' device.

    Args:
        t_fields: (ns, nz, ny, nx) from :func:`eikonal_solve_batch_3d`.
        src_idx: (npair,) int source index of each pair.
        rx_pos: (npair, 3) physical receiver points.

    Returns:
        (npair,) float32 predicted first-arrival times [s].
    """
    return eikonal.eikonal_receiver_times(t_fields, src_idx, rx_pos, grid)


def trace_rays_3d(t_fields, src_idx, src_pos, rx_pos, grid: Grid3D,
                  n_steps: int, step: float, n_samples: int = 256):
    """Fermat ray paths by steepest descent on 3D travel-time volumes, on
    the volumes' device: :func:`.eikonal.trace_rays` with trilinear
    interpolation of the central differences.

    Returns:
        pts: (npair, n_samples, 3) points along each path.
        lengths: (npair,) path arc lengths [m].
    """
    return eikonal._trace(t_fields, src_idx, src_pos, rx_pos, grid,
                          int(n_steps), step, int(n_samples))
