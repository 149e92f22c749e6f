"""3D travel-time tomography starting models (port of
``waveforminversionust_tpu.fwi.traveltime3d``): straight-ray and bent-ray
(eikonal) tomography over (nz, ny, nx) slowness volumes, producing starting
volumes for the 3D FWI paths.

Everything but the pair geometry is :mod:`.traveltime`'s
dimension-generic machinery: the ray map with trilinear rows, the smoothed,
ray-density-preconditioned normal-equations PCG (its Laplacian scale
follows the dimension) and the bent-ray loop over :mod:`.eikonal3d`. No
kernel of the port runs here.
"""

from __future__ import annotations

import numpy as np

from ..models.grid3d import Grid3D
from . import eikonal3d
from .traveltime import (_bent, invert_travel_times, pick_arrival_times,
                         straight_ray_times)


def straight_ray_times_3d(slowness, tx_pos, rx_pos, grid: Grid3D,
                          n_samples: int = 512, device=None):
    """Travel times of straight 3D rays (midpoint rule, trilinear).

    Args:
        slowness: (nz, ny, nx) [s/m].
        tx_pos, rx_pos: (npair, 3) physical (x, y, z) endpoints [m].
        device: where it runs (default: ``slowness``'s device if it is a
            tensor, else the card, which raises when there is none).

    Returns:
        (npair,) float32 travel times [s]. LINEAR in ``slowness``.
    """
    return straight_ray_times(slowness, tx_pos, rx_pos, grid, n_samples,
                              device)


def invert_travel_times_3d(t_obs, tx_pos, rx_pos, grid: Grid3D,
                           c_ref: float = 1500.0, lam_smooth: float = 1.0,
                           n_samples: int | None = None,
                           cg_iters: int = 100,
                           clip_velocity: tuple[float, float] | None = None,
                           device=None):
    """Linear straight-ray tomography in 3D: travel times -> speed volume,
    :func:`.traveltime.invert_travel_times` with trilinear rows (n_samples
    default 2 * max(nz, ny, nx)).

    Returns:
        (velocity (nz, ny, nx) float32 [m/s], CG relative residual).
    """
    return invert_travel_times(t_obs, tx_pos, rx_pos, grid, c_ref,
                               lam_smooth, n_samples, cg_iters,
                               clip_velocity, device)


def invert_travel_times_bent_3d(t_obs, tx_pos, rx_pos, grid: Grid3D,
                                c_ref: float = 1500.0,
                                lam_smooth: float = 1.0,
                                n_outer: int = 3, cg_iters: int = 100,
                                n_samples: int | None = None,
                                step: float | None = None,
                                clip_velocity: tuple[float, float]
                                = (1300.0, 1800.0), device=None):
    """Bent-ray (eikonal) travel-time tomography in 3D: the outer fixed
    point of :func:`.traveltime.invert_travel_times_bent` over per-source
    eikonal volumes (:func:`.eikonal3d.eikonal_solve_batch_3d`) and
    steepest-descent rays (:func:`.eikonal3d.trace_rays_3d`).

    Returns:
        (velocity (nz, ny, nx) float32 [m/s], final CG relative residual).
    """
    return _bent(t_obs, tx_pos, rx_pos, grid, c_ref, lam_smooth, n_outer,
                 cg_iters, n_samples, step, clip_velocity, device,
                 eikonal3d.eikonal_solve_batch_3d, eikonal3d.trace_rays_3d)


def traveltime_init_3d(td, grid: Grid3D, min_angle: float = 0.5,
                       c_ref: float = 1500.0, lam_smooth: float = 10.0,
                       search_halfwidth: float | None = None,
                       cg_iters: int = 100,
                       clip_velocity: tuple[float, float] | None = None,
                       snap_to_dataset_grid: bool = True,
                       return_times: bool = False,
                       method: str = "straight", n_outer: int = 3,
                       device=None):
    """3D travel-time starting model from broadband channel data:
    straight-ray predictions over the element cloud -> picks
    (:func:`.traveltime.pick_arrival_times`) on every pair the angular
    acceptance rule keeps -> the straight or bent tomogram on the
    inversion grid.

    Args:
        td: :class:`~..data.timedomain3d.TimeDomainDataset3D`.
        grid: INVERSION grid of the starting volume.
        min_angle: minimum tx-rx angular separation [rad].
        snap_to_dataset_grid: ray endpoints at ``td.positions_snapped``;
            pass False for measured data.
        return_times: also return (t_picked, tx_pos, rx_pos).
        method: "straight" or "bent".
        device: where the tomography runs (default: the card, which raises
            when there is none; the picks are host numpy).

    Returns:
        c_init (nz, ny, nx) float32 numpy [m/s]; with ``return_times=True``,
        (c_init, t_picked, tx_pos, rx_pos).
    """
    from ..models.acquisition3d import build_acquisition3d

    pos = np.asarray(td.positions_snapped if snap_to_dataset_grid
                     else td.positions, np.float64)
    acq = build_acquisition3d(grid, td.positions, min_angle=min_angle)
    rx_elem = np.asarray(acq.rx_elem)                 # (n, n_active)
    n, n_active = rx_elem.shape
    tx_e = np.repeat(np.arange(n), n_active)
    rx_e = rx_elem.ravel()
    tx_pos = pos[tx_e]
    rx_pos = pos[rx_e]
    t_ref = np.linalg.norm(rx_pos - tx_pos, axis=-1) / c_ref
    t_obs = pick_arrival_times(td.traces[tx_e, rx_e], td.times, td.df,
                               t_ref, search_halfwidth=search_halfwidth)
    if method == "bent":
        vel, _relres = invert_travel_times_bent_3d(
            t_obs, tx_pos, rx_pos, grid, c_ref=c_ref,
            lam_smooth=lam_smooth, cg_iters=cg_iters, n_outer=n_outer,
            clip_velocity=clip_velocity or (1300.0, 1800.0), device=device)
    elif method == "straight":
        vel, _relres = invert_travel_times_3d(
            t_obs, tx_pos, rx_pos, grid, c_ref=c_ref,
            lam_smooth=lam_smooth, cg_iters=cg_iters,
            clip_velocity=clip_velocity, device=device)
    else:
        raise ValueError(f"unknown travel-time method {method!r} "
                         "(expected 'straight' or 'bent')")
    vel = vel.cpu().numpy()
    if return_times:
        return vel, t_obs, tx_pos, rx_pos
    return vel
