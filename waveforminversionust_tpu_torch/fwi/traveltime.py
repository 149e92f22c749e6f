"""Travel-time tomography starting models (port of
``waveforminversionust_tpu.fwi.traveltime``).

  1. :func:`pick_arrival_times`: sub-sample direct-arrival picks from the
     complex analytic channel traces (host numpy, as in the JAX package).
  2. :func:`straight_ray_times`: t = integral of slowness along straight
     tx->rx rays (midpoint rule, bilinear interpolation).
  3. :func:`invert_travel_times`: ray-density-preconditioned linear CG on
     the smoothed normal equations for the slowness perturbation.
  4. :func:`invert_travel_times_bent`: the same linear problem along bent
     rays, re-traced from eikonal fields (:mod:`.eikonal`) each outer pass.
  5. :func:`traveltime_init`: TimeDomainDataset -> starting model for
     :func:`~.runner.invert_dataset`.

The ray map B (each row the mean of the slowness along one path) is a
gather of precomputed linear-interpolation corners, and its transpose,
which the JAX package takes from ``jax.linear_transpose``, is the scatter of
the same weights (``index_add_``). On the card that scatter is atomic
adds, so B^T is reproducible only to rounding. The PCG runs its fixed
number of iterations with a per-iteration ``live`` mask on the device, as
the JAX package's scan does: no host sync inside. No kernel of the port
runs here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..models.grid import Grid2D
from . import eikonal
from .eikonal import _corners
from .newton import _laplacian_ltl

f32 = np.float32


def _predicted_times(x_elem, y_elem, c_ref: float) -> np.ndarray:
    """(ne, ne) straight-ray arrival predictions |pos_tx - pos_rx| / c_ref."""
    pos = np.stack([np.asarray(x_elem), np.asarray(y_elem)], axis=1)
    dist = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    return dist / c_ref


def pick_arrival_times(traces, times, df, t_ref,
                       search_halfwidth: float | None = None) -> np.ndarray:
    """Sub-sample direct-arrival times from complex analytic channel traces.

    The pick is the peak of the envelope ``|trace|`` on the circular time
    axis (the comb-synthesized record is periodic with ``T = 1/df``),
    refined by a parabola through its two circular neighbours, then
    unwrapped to an absolute time by the multiple of T closest to the
    straight-ray prediction: ``t_abs = t_peak + round((t_ref - t_peak) / T)
    * T``.

    Args:
        traces: (..., nt) complex analytic traces (gate them first with
            data.timedomain.direct_arrival_gate when late reverberation can
            out-peak the direct arrival).
        times: (nt,) uniform sample times spanning one period 1/df.
        df: comb spacing [Hz].
        t_ref: (...,) straight-ray predictions, broadcastable to the trace
            batch shape: the unwrap reference and the search centre.
        search_halfwidth: restrict the peak search to ``t_ref +-
            search_halfwidth`` [s] on the circle (None: the whole period).

    Returns:
        (...,) float64 absolute arrival times [s] (host numpy).
    """
    env = np.abs(np.asarray(traces))
    t = np.asarray(times, np.float64)
    nt = env.shape[-1]
    if nt < 3:
        raise ValueError("picking needs at least 3 time samples")
    period = 1.0 / float(df)
    dt = period / nt
    t_ref = np.asarray(t_ref, np.float64)

    if search_halfwidth is not None:
        # circular distance from each sample to the (wrapped) prediction
        tr = np.broadcast_to(t_ref, env.shape[:-1]).reshape(-1)
        d = np.mod(t[None, :] - tr[:, None] + 0.5 * period,
                   period) - 0.5 * period
        masked = np.where(np.abs(d) <= search_halfwidth,
                          env.reshape(-1, nt), -np.inf)
        k = np.argmax(masked, axis=-1).reshape(env.shape[:-1])
    else:
        k = np.argmax(env, axis=-1)

    # parabolic sub-sample refinement through the circular neighbours
    flat = env.reshape(-1, nt)
    idx = np.arange(flat.shape[0])
    kf = k.reshape(-1)
    e0 = flat[idx, (kf - 1) % nt]
    e1 = flat[idx, kf]
    e2 = flat[idx, (kf + 1) % nt]
    denom = e0 - 2 * e1 + e2
    offs = np.where(np.abs(denom) > 1e-30 * np.maximum(e1, 1e-300),
                    0.5 * (e0 - e2) / denom, 0.0)
    offs = np.clip(offs, -0.5, 0.5).reshape(k.shape)

    t_peak = (k + offs) * dt  # in [0, T)
    wraps = np.round((t_ref - t_peak) / period)
    return t_peak + wraps * period


class _RayMap:
    """The linear map B: slowness (grid.shape) -> (npair,) means of its
    linear interpolation at the (npair, n_samples, D) points ``pts``, each
    row times ``row_scale`` when given, and its transpose. The corners'
    flat indices and weights are computed once (for 49408 rays of 602
    samples on a 301^2 grid: 0.95 GB of indices, 0.48 GB of weights)."""

    def __init__(self, pts, grid, row_scale=None):
        npair, ns, nd = pts.shape
        corners = _corners(pts.reshape(-1, nd), grid)
        self.idx = torch.stack([i for i, _ in corners], -1)
        self.w = torch.stack([w for _, w in corners], -1)
        self.shape, self.n_samples = tuple(grid.shape), ns
        self.npair, self.row_scale = npair, row_scale

    def apply(self, s):
        vals = s.reshape(-1)[self.idx] * self.w
        acc = vals[:, 0]
        for k in range(1, vals.shape[1]):
            acc = acc + vals[:, k]
        out = torch.mean(acc.reshape(self.npair, self.n_samples), dim=-1)
        return out if self.row_scale is None else out * self.row_scale

    def transpose(self, r):
        if self.row_scale is not None:
            r = r * self.row_scale
        per_sample = (r / self.n_samples).repeat_interleave(self.n_samples)
        out = torch.zeros(int(np.prod(self.shape)), dtype=torch.float32,
                          device=r.device)
        out.index_add_(0, self.idx.reshape(-1),
                       (self.w * per_sample[:, None]).reshape(-1))
        return out.reshape(self.shape)


def _chords(tx, rx, n_samples: int):
    """(npair, n_samples, D) midpoint-rule points on the straight chords
    and the chord lengths (npair,), in FP32 on the endpoints' device."""
    alpha = ((torch.arange(n_samples, dtype=torch.float32, device=tx.device)
              + 0.5) / n_samples)
    d = rx - tx
    pts = tx[:, None, :] + alpha[None, :, None] * d[:, None, :]
    return pts, torch.sqrt(torch.sum(d * d, dim=-1))


def straight_ray_times(slowness, tx_pos, rx_pos, grid: Grid2D,
                       n_samples: int = 512, device=None):
    """Travel times of straight rays through a slowness map (midpoint rule):

        t_i = |rx_i - tx_i| * mean_k slowness(tx_i + a_k (rx_i - tx_i)),
        a_k = (k + 1/2) / n_samples

    with bilinear interpolation of ``slowness``; LINEAR in ``slowness``.

    Args:
        slowness: (ny, nx) [s/m].
        tx_pos, rx_pos: (npair, 2) physical (x, y) endpoints [m].
        n_samples: quadrature points per ray (>= 2 * max(ny, nx) resolves
            the grid).
        device: where it runs (default: ``slowness``'s device if it is a
            tensor, else the card, which raises when there is none).

    Returns:
        (npair,) float32 travel times [s].
    """
    dev = resolve_device(slowness, device)
    s = torch.as_tensor(slowness, dtype=torch.float32).to(dev)
    tx = torch.as_tensor(tx_pos, dtype=torch.float32, device=dev)
    rx = torch.as_tensor(rx_pos, dtype=torch.float32, device=dev)
    pts, dist = _chords(tx, rx, int(n_samples))
    return dist * _RayMap(pts, grid).apply(s)


def _normal_eq_solve(ray: _RayMap, r0, grid, lam_smooth, cg_iters: int):
    """Smoothed normal equations (B^T B + reg L^T L) ds = B^T r0 by PCG.

    ``ray`` must be a NORMALIZED ray map (each row a mean along its path),
    so diag(B^T B) is O(coverage) and one smoothing knob serves every
    geometry. Preconditioner: the ray-coverage map B^T 1. ``cg_iters``
    iterations, each masked by whether the residual is still above 1e-5 of
    the right-hand side's (the JAX package's fixed-length scan). Returns
    (ds, relres), both on the device."""
    rhs = ray.transpose(r0)
    density = ray.transpose(torch.ones_like(r0))   # ray-coverage map
    diag = density + 1e-3 * torch.max(density)
    # ||L^T L||_inf = 4 * ndim (the core is shared with traveltime3d)
    s_reg = lam_smooth * torch.mean(density) / (4.0 * len(grid.shape))

    def hvp(ds):
        return ray.transpose(ray.apply(ds)) + s_reg * _laplacian_ltl(ds)

    x = torch.zeros(grid.shape, dtype=torch.float32, device=r0.device)
    r = rhs
    z = r / diag
    p = z
    rz = torch.sum(r * z)
    b2 = torch.clamp(torch.sum(rhs * rhs), min=1e-38)
    tol2 = 1e-10 * b2
    for _ in range(int(cg_iters)):
        live = torch.sum(r * r) > tol2
        ap = hvp(p)
        alpha = rz / torch.clamp(torch.sum(p * ap), min=1e-38)
        x1 = x + alpha * p
        r1 = r - alpha * ap
        z1 = r1 / diag
        rz1 = torch.sum(r1 * z1)
        p1 = z1 + (rz1 / torch.clamp(rz, min=1e-38)) * p
        x, r, p, rz = (torch.where(live, a, b) for a, b in
                       zip((x1, r1, p1, rz1), (x, r, p, rz)))
    return x, torch.sqrt(torch.sum(r * r) / b2)


def invert_travel_times(t_obs, tx_pos, rx_pos, grid: Grid2D,
                        c_ref: float = 1500.0, lam_smooth: float = 1.0,
                        n_samples: int | None = None, cg_iters: int = 100,
                        clip_velocity: tuple[float, float] | None = None,
                        device=None):
    """Linear straight-ray tomography: travel times -> sound-speed map.

    Solves the smoothed normal equations for the slowness perturbation
    ``ds`` about the homogeneous background ``1/c_ref``

        (B^T B + lam * mean(density)/8 * L^T L) ds = B^T (t_obs/d - 1/c_ref)

    with B the per-ray MEAN-slowness map (scale-free, so ``lam_smooth`` is
    geometry-portable), L^T L the forward-difference Laplacian and
    ray-density-preconditioned linear CG.

    Args:
        t_obs: (npair,) picked absolute travel times [s].
        tx_pos, rx_pos: (npair, 2) physical endpoints [m].
        lam_smooth: smoothing weight.
        n_samples: quadrature points per ray (default 2 * max(ny, nx)).
        cg_iters: CG iterations (frozen once the relative residual is
            below 1e-5).
        clip_velocity: optional (lo, hi) bounds on the returned map [m/s].
        device: where it runs (default: ``t_obs``'s device if it is a
            tensor, else the card, which raises when there is none).

    Returns:
        (velocity (ny, nx) float32 [m/s], CG relative residual), tensors.
    """
    if n_samples is None:
        n_samples = 2 * max(grid.shape)
    dev = resolve_device(t_obs, device)
    t_obs, tx, rx = (torch.as_tensor(a, dtype=torch.float32).to(dev)
                     for a in (t_obs, tx_pos, rx_pos))
    s0 = 1.0 / torch.tensor(f32(c_ref), device=dev)
    pts, dist = _chords(tx, rx, int(n_samples))
    dist_c = torch.clamp(dist, min=1e-12)
    # rows of the straight-ray times over the ray length: the mean along
    # the chord (0 for a chord of no length)
    ray = _RayMap(pts, grid, row_scale=dist / dist_c)
    # mean-slowness residuals of the homogeneous background
    x, relres = _normal_eq_solve(ray, t_obs / dist_c - s0, grid,
                                 float(lam_smooth), int(cg_iters))
    vel = 1.0 / (s0 + x)
    if clip_velocity is not None:
        vel = torch.clamp(vel, *clip_velocity)
    return vel, relres


def _bent_step(t_obs, pts, lengths, s_cur, grid, lam_smooth, cg_iters: int):
    """One linearized re-solve along fixed paths: (slowness, relres)."""
    lengths = torch.clamp(lengths, min=1e-12)
    ray = _RayMap(pts, grid)
    # residual of the CURRENT model along the current paths, in
    # mean-slowness units
    r0 = t_obs / lengths - ray.apply(s_cur)
    ds, relres = _normal_eq_solve(ray, r0, grid, lam_smooth, cg_iters)
    return s_cur + ds, relres


def _bent(t_obs, tx_pos, rx_pos, grid, c_ref, lam_smooth, n_outer,
          cg_iters, n_samples, step, clip_velocity, device, solve_batch,
          trace):
    """The bent-ray loop of either dimension, with its eikonal batch
    solver and tracer."""
    nd = len(grid.shape)
    if n_samples is None:
        n_samples = 2 * max(grid.shape)
    if step is None:
        step = 0.5 * min(d for _, d, _, _ in eikonal._axes(grid))
    dev = resolve_device(t_obs, device)
    tx = np.asarray(tx_pos, np.float32)
    rx = np.asarray(rx_pos, np.float32)
    t_obs = torch.as_tensor(t_obs, dtype=torch.float32).to(dev)

    # unique transmitter positions -> one eikonal field each
    src_unique, src_idx = np.unique(tx, axis=0, return_inverse=True)
    src_idx = src_idx.reshape(-1).astype(np.int32)
    # march length: the longest straight chord with a 1.6x bending margin
    max_d = float(np.max(np.linalg.norm(rx - tx, axis=-1)))
    n_steps = int(np.ceil(1.6 * max_d / step)) + 16

    # Pass 1 rays are straight (homogeneous start): EXACT chords, not
    # traced ones, whose per-pair arc-length noise (~0.5 %) would inject a
    # slowness bias comparable to weak anomalies.
    alpha = (np.arange(int(n_samples), dtype=np.float32) + 0.5) / n_samples
    pts = torch.as_tensor(tx[:, None, :] + alpha[None, :, None]
                          * (rx - tx)[:, None, :], device=dev)
    lengths = torch.as_tensor(np.linalg.norm(rx - tx, axis=-1), device=dev)

    vel = torch.full(grid.shape, float(f32(c_ref)), dtype=torch.float32,
                     device=dev)
    relres = torch.tensor(np.inf, dtype=torch.float32, device=dev)
    for outer in range(int(n_outer)):
        slowness = 1.0 / vel
        if outer > 0:
            t_fields = solve_batch(slowness, src_unique.reshape(-1, nd), grid)
            pts, lengths = trace(t_fields, src_idx, tx, rx, grid,
                                 n_steps=n_steps, step=float(step),
                                 n_samples=int(n_samples))
            del t_fields
        s_new, relres = _bent_step(t_obs, pts, lengths, slowness, grid,
                                   float(f32(lam_smooth)), int(cg_iters))
        vel = torch.clamp(1.0 / s_new, *clip_velocity)
    return vel, relres


def invert_travel_times_bent(t_obs, tx_pos, rx_pos, grid: Grid2D,
                             c_ref: float = 1500.0, lam_smooth: float = 1.0,
                             n_outer: int = 3, cg_iters: int = 100,
                             n_samples: int | None = None,
                             step: float | None = None,
                             clip_velocity: tuple[float, float] = (1300.0, 1800.0),
                             device=None):
    """Bent-ray (eikonal) travel-time tomography.

    Outer fixed point over the ray geometry: solve ``|grad T| = s`` per
    unique source (:func:`.eikonal.eikonal_solve_batch`), trace the Fermat
    paths by steepest descent on T (:func:`.eikonal.trace_rays`), then
    re-solve the linearized problem with the paths FIXED: the smoothed,
    ray-density-preconditioned normal equations of
    :func:`invert_travel_times` with path-mean rows along the bent rays.
    The first pass starts from the homogeneous ``c_ref`` on the exact
    chords.

    Args:
        t_obs: (npair,) picked absolute first-arrival times [s].
        tx_pos, rx_pos: (npair, 2) physical endpoints [m]; rays are traced
            from each receiver back to its transmitter (one eikonal field
            per UNIQUE transmitter position).
        n_outer: ray-geometry refinements.
        step: ray-march step [m] (default ``min(dx, dy) / 2``).
        clip_velocity: (lo, hi) bounds applied between passes.
        device: where it runs (default: ``t_obs``'s device if it is a
            tensor, else the card, which raises when there is none).

    Returns:
        (velocity (ny, nx) float32 [m/s], final CG relative residual).
    """
    return _bent(t_obs, tx_pos, rx_pos, grid, c_ref, lam_smooth, n_outer,
                 cg_iters, n_samples, step, clip_velocity, device,
                 eikonal.eikonal_solve_batch, eikonal.trace_rays)


def traveltime_init(td, grid: Grid2D, num_excluded_each_side: int = 31,
                    c_ref: float = 1500.0, lam_smooth: float = 10.0,
                    search_halfwidth: float | None = None,
                    cg_iters: int = 100,
                    clip_velocity: tuple[float, float] | None = None,
                    snap_to_dataset_grid: bool = True,
                    return_times: bool = False,
                    method: str = "straight", n_outer: int = 3,
                    device=None):
    """Travel-time starting model from broadband channel data: straight-ray
    predictions over the ring -> :func:`pick_arrival_times` on every pair
    of the acceptance mask (the reference's +-31-element exclusion) -> the
    straight (:func:`invert_travel_times`) or bent
    (:func:`invert_travel_times_bent`) tomogram on the inversion grid.

    Args:
        td: :class:`~..data.timedomain.TimeDomainDataset` (gate it first
            with direct_arrival_gate when reverberation is strong).
        grid: INVERSION grid of the starting model.
        lam_smooth: smoothing weight; 10 suits PICKED times, whose
            sub-sample noise maps into slowness streaks under weak
            smoothing.
        snap_to_dataset_grid: ray endpoints at the element positions
            snapped to the dataset's grid (td.x/td.y), where the
            synthesizer placed them; pass False for measured data.
        return_times: also return (t_picked, tx_pos, rx_pos).
        method: "straight" or "bent".
        n_outer: ray-geometry refinements for ``method="bent"``.
        device: where the tomography runs (default: the card, which raises
            when there is none; the picks are host numpy).

    Returns:
        c_init (ny, nx) float32 numpy [m/s]; with ``return_times=True``,
        (c_init, t_picked, tx_pos, rx_pos).
    """
    from ..models.acquisition import acceptance_mask

    ne = len(td.x_circ)
    mask = acceptance_mask(ne, num_excluded_each_side)
    xe = np.asarray(td.x_circ, np.float64)
    ye = np.asarray(td.y_circ, np.float64)
    if snap_to_dataset_grid:
        xg = np.asarray(td.x, np.float64)
        yg = np.asarray(td.y, np.float64)
        xe = xg[np.argmin(np.abs(xg[None, :] - xe[:, None]), axis=1)]
        ye = yg[np.argmin(np.abs(yg[None, :] - ye[:, None]), axis=1)]
    t_ref = _predicted_times(xe, ye, c_ref)
    t_all = pick_arrival_times(td.traces, td.times, td.df, t_ref,
                               search_halfwidth=search_halfwidth)
    ti, ri = np.nonzero(mask)
    pos = np.stack([xe, ye], axis=1)
    tx_pos = pos[ti]
    rx_pos = pos[ri]
    t_obs = t_all[ti, ri]
    if method == "bent":
        vel, _relres = invert_travel_times_bent(
            t_obs, tx_pos, rx_pos, grid, c_ref=c_ref, lam_smooth=lam_smooth,
            cg_iters=cg_iters, n_outer=n_outer,
            clip_velocity=clip_velocity or (1300.0, 1800.0), device=device)
    elif method == "straight":
        vel, _relres = invert_travel_times(
            t_obs, tx_pos, rx_pos, grid, c_ref=c_ref, lam_smooth=lam_smooth,
            cg_iters=cg_iters, clip_velocity=clip_velocity, device=device)
    else:
        raise ValueError(f"unknown travel-time method {method!r} "
                         "(expected 'straight' or 'bent')")
    vel = vel.cpu().numpy()
    if return_times:
        return vel, t_obs, tx_pos, rx_pos
    return vel
