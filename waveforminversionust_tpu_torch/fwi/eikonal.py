"""First-arrival eikonal solver and bent-ray tracing (port of
``waveforminversionust_tpu.fwi.eikonal``).

Solves |grad T| = s(x) for the first-arrival travel-time field T of a point
source by JACOBI iterations of the upwind Godunov update: every node
updates at once from its neighbours' previous values, elementwise work on
the whole (batch, ny, nx) stack an iteration. From an upper-bound start the
update is monotone nonincreasing, so it converges to the viscosity solution
in about as many iterations as the longest ray has cells.

A batch of sources is one (ns, ny, nx) stack. The JAX package runs one
``while_loop`` per source under ``vmap``, where a source whose change fell
to the tolerance is frozen while the others go on; here every source
carries an ``active`` flag on the device with the same effect. A frozen
source does not change, so the host reads whether any source is still
active only every few iterations (one sync per ``_CHECK_EVERY``) and the
fields are those of the per-source loop, bit for bit.

Ray tracing is a fixed-length host loop of constant-step steepest descent
on the interpolated gradient of T, batched over all pairs, with a latch at
the source; the trajectory is subsampled uniformly in arc length. Samples
gather straight out of the (ns, ny, nx) stack by flat index: the per-pair
fields are never materialised. The helpers here are dimension-generic and
serve :mod:`.eikonal3d` too. No kernel of the port runs here.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.grid import Grid2D

_INF = 1e9
# Iterations between the host's reads of the active flags.
_CHECK_EVERY = 8
f32 = np.float32


def _axes(grid):
    """(origin, spacing, count, coordinates) per axis in a point's (x, y[,
    z]) order; the field axis of coordinate a is -1 - a."""
    names = ("x", "y", "z")[:len(grid.shape)]
    return [(getattr(grid, n + "0"), getattr(grid, "d" + n),
             getattr(grid, "n" + n), getattr(grid, n)) for n in names]


def _upwind_update(t, slowness, dx: float, dy: float):
    """One Jacobi sweep of the upwind Godunov local solver (all nodes) on
    (..., ny, nx) times."""
    pad_y = F.pad(t, (0, 0, 1, 1), value=_INF)
    pad_x = F.pad(t, (1, 1), value=_INF)
    p = torch.minimum(pad_y[..., :-2, :], pad_y[..., 2:, :])  # y-neighbours
    q = torch.minimum(pad_x[..., :-2], pad_x[..., 2:])        # x-neighbours
    alpha, beta = f32(1.0 / dy ** 2), f32(1.0 / dx ** 2)
    s2 = slowness * slowness
    # two-sided quadratic: alpha (T-p)^2 + beta (T-q)^2 = s^2
    disc = float(alpha + beta) * s2 - float(alpha * beta) * (p - q) ** 2
    t2 = ((float(alpha) * p + float(beta) * q
           + torch.sqrt(torch.clamp(disc, min=0.0))) / float(alpha + beta))
    # one-sided fallback: the two-sided root must dominate both upwind
    # values, else only the smaller neighbour is upwind
    t1 = torch.minimum(p + slowness * dy, q + slowness * dx)
    cand = torch.where((disc >= 0.0) & (t2 >= torch.maximum(p, q)), t2, t1)
    return torch.minimum(t, cand)


def _start(slowness, src, grid):
    """The (ns, ...) initial times: ``|x - x_src| * s(src)`` on a ball of
    two cells around each source (the nearest node's slowness), +INF
    elsewhere."""
    axes = _axes(grid)
    nd = len(axes)
    lanes = [-1] + [1] * nd
    r2 = 0.0
    node = []
    for a, (o, d, n, coords) in enumerate(axes):
        shape = [1] * (nd + 1)
        shape[nd - a] = n
        c = torch.as_tensor(coords, dtype=torch.float32,
                            device=slowness.device).reshape(shape)
        r2 = r2 + (c - src[:, a].reshape(lanes)) ** 2
        node.append(torch.clamp(torch.round((src[:, a] - o) / d), 0, n - 1)
                    .to(torch.int64))
    r = torch.sqrt(r2)
    s_src = slowness[tuple(reversed(node))].reshape(lanes)
    r_ball = 2.0 * max(d for _, d, _, _ in axes)
    return torch.where(r <= r_ball, r * s_src, torch.full_like(r, _INF))


def _jacobi(update, t0, tol_v, max_iters: int):
    """Jacobi iterations of ``update`` on the (ns, ...) stack, each source
    frozen from the iteration whose change ``max(T - T_new)`` fell to
    ``tol_v`` or whose count reached ``max_iters`` (the JAX package's
    ``vmap`` of its ``while_loop``). Returns (times, iterations per
    source)."""
    t = t0
    ns, dev = t.shape[0], t.device
    lanes = [-1] + [1] * (t.dim() - 1)
    dims = tuple(range(1, t.dim()))
    delta = torch.full((ns,), _INF, dtype=torch.float32, device=dev)
    it = torch.zeros(ns, dtype=torch.int32, device=dev)
    done = 0
    while done < max_iters:
        for _ in range(min(_CHECK_EVERY, max_iters - done)):
            active = (delta > tol_v) & (it < max_iters)
            t_new = update(t)
            change = torch.amax(t - t_new, dim=dims)
            t = torch.where(active.reshape(lanes), t_new, t)
            delta = torch.where(active, change, delta)
            it = it + active.to(torch.int32)
            done += 1
        if not bool(((delta > tol_v) & (it < max_iters)).any()):
            break
    return t, it


def _solve(slowness, src_pos, grid, update, max_iters, tol, device):
    """The batched solve of either dimension: (times (ns, ...), iterations
    (ns,))."""
    dev = resolve_device(slowness, device)
    s = torch.as_tensor(slowness, dtype=torch.float32).to(dev)
    src = torch.as_tensor(src_pos, dtype=torch.float32).to(dev)
    if max_iters is None:
        max_iters = 2 * sum(grid.shape)
    if tol is None:
        tol_v = torch.min(s) * (1e-5 * min(d for _, d, _, _ in _axes(grid)))
    else:
        tol_v = torch.tensor(f32(tol), device=dev)
    return _jacobi(lambda t: update(t, s), _start(s, src, grid), tol_v,
                   int(max_iters))


def eikonal_solve_batch(slowness, src_pos, grid: Grid2D,
                        max_iters: int | None = None,
                        tol: float | None = None, device=None):
    """First-arrival travel-time fields of a stack of point sources.

    Args:
        slowness: (ny, nx) [s/m], strictly positive.
        src_pos: (ns, 2) physical (x, y) source locations [m].
        max_iters: Jacobi iteration cap (default ``2 * (nx + ny)``).
        tol: convergence threshold on ``max |T_new - T|`` [s] (default
            1e-5 * min(dx, dy) * min(s)).
        device: where the solve runs (default: ``slowness``'s device if it
            is a tensor, else the card, which raises when there is none).

    Returns:
        (ns, ny, nx) float32 travel times [s].
    """
    return _solve(slowness, src_pos, grid,
                  lambda t, s: _upwind_update(t, s, grid.dx, grid.dy),
                  max_iters, tol, device)[0]


def eikonal_solve(slowness, src_pos, grid: Grid2D,
                  max_iters: int | None = None, tol: float | None = None,
                  device=None):
    """First-arrival travel-time field of one point source at the (2,)
    physical ``src_pos``: (ny, nx) float32 [s]; see
    :func:`eikonal_solve_batch`. The initialization seeds a 2-cell disk
    around the source with the locally homogeneous times and +INF
    elsewhere."""
    src = torch.as_tensor(src_pos, dtype=torch.float32)
    return eikonal_solve_batch(slowness, src[None], grid, max_iters, tol,
                               device)[0]


def _corners(p, grid, offset=None):
    """Linear-interpolation corners of the (N, D) physical points ``p``:
    a list of (flat index (N,), weight (N,)) over the 2^D nodes, x fastest,
    into a field stack whose (N,) ``offset`` (the field of each point times
    the field's size) is added to every index."""
    axes = _axes(grid)
    base, stride = 0, 1
    lo_hi = []
    for a, (o, d, n, _) in enumerate(axes):
        f = torch.clamp((p[:, a] - o) / d, 0.0, float(f32(n - 1 - 1e-6)))
        i = torch.clamp(f.to(torch.int64), 0, n - 2)
        w = f - i
        base = base + i * stride
        lo_hi.append(((1 - w, 0), (w, stride)))
        stride *= n
    if offset is not None:
        base = base + offset
    out = []
    # corners in the JAX package's order: the last axis (x) fastest
    for combo in itertools.product(*reversed(lo_hi)):
        combo = combo[::-1]   # back to (x, y[, z])
        w = combo[0][0]
        for fac, _ in combo[1:]:
            w = w * fac
        out.append((base + sum(s for _, s in combo), w))
    return out


def _sample(flat, corners):
    """sum_k w_k * flat[idx_k], summed in corner order."""
    acc = None
    for idx, w in corners:
        term = w * flat[idx]
        acc = term if acc is None else acc + term
    return acc


def eikonal_receiver_times(t_fields, src_idx, rx_pos, grid: Grid2D):
    """Sample per-source travel-time fields at receiver positions, on the
    fields' device.

    Args:
        t_fields: (ns, ny, nx) from :func:`eikonal_solve_batch`.
        src_idx: (npair,) int source index of each pair.
        rx_pos: (npair, 2) physical receiver points.

    Returns:
        (npair,) float32 predicted first-arrival times [s].
    """
    t = torch.as_tensor(t_fields, dtype=torch.float32)
    dev = t.device
    idx = torch.as_tensor(src_idx, dtype=torch.int64, device=dev)
    rx = torch.as_tensor(rx_pos, dtype=torch.float32, device=dev)
    nvox = int(np.prod(t.shape[1:]))
    return _sample(t.reshape(-1), _corners(rx, grid, idx * nvox))


def _gradient(t, grid):
    """The spatial gradient of the (ns, ...) stack per axis in (x, y[, z])
    order: central differences inside, one-sided first-order differences on
    the edge planes (``jnp.gradient``'s formulas)."""
    out = []
    for a, (_, h, n, _) in enumerate(_axes(grid)):
        dim = t.dim() - 1 - a
        upper = (t.narrow(dim, 1, 1) - t.narrow(dim, 0, 1)) / h
        lower = (t.narrow(dim, n - 1, 1) - t.narrow(dim, n - 2, 1)) / h
        inner = (t.narrow(dim, 2, n - 2) - t.narrow(dim, 0, n - 2)) * 0.5 / h
        out.append(torch.cat([upper, inner, lower], dim=dim))
    return out


def _trace(t_fields, src_idx, src_pos, rx_pos, grid, n_steps: int,
           step: float, n_samples: int):
    """Steepest descent from each receiver on its source's field, either
    dimension; see :func:`trace_rays`."""
    t = torch.as_tensor(t_fields, dtype=torch.float32)
    dev = t.device
    grads = [g.reshape(-1) for g in _gradient(t, grid)]
    nvox = int(np.prod(t.shape[1:]))
    offset = torch.as_tensor(src_idx, dtype=torch.int64, device=dev) * nvox
    src = torch.as_tensor(src_pos, dtype=torch.float32, device=dev)
    p = torch.as_tensor(rx_pos, dtype=torch.float32, device=dev)
    npair, nd = p.shape
    stepf = f32(step)
    latch2 = float((f32(1.5) * stepf) ** 2)
    done = torch.zeros(npair, dtype=torch.bool, device=dev)
    arc = torch.zeros(npair, dtype=torch.float32, device=dev)
    traj = torch.empty((n_steps, npair, nd), dtype=torch.float32, device=dev)
    done_hist = torch.empty((n_steps, npair), dtype=torch.bool, device=dev)
    for k in range(n_steps):
        corners = _corners(p, grid, offset)
        v = [_sample(g, corners) for g in grads]
        norm2 = v[0] * v[0]
        for vi in v[1:]:
            norm2 = norm2 + vi * vi
        norm = torch.sqrt(torch.clamp(norm2, min=1e-24))
        p_next = p - float(stepf) * torch.stack([vi / norm for vi in v], -1)
        reach = torch.sum((p_next - src) ** 2, dim=-1) <= latch2
        p_next = torch.where(reach[:, None], src, p_next)
        p_out = torch.where(done[:, None], p, p_next)
        # exact hop length: the step, the remaining distance on the latch
        # hop, 0 once done
        hop = torch.sqrt(torch.sum((p_out - p) ** 2, dim=-1))
        arc = arc + torch.where(done, torch.zeros_like(hop), hop)
        traj[k] = p_out
        done_hist[k] = done
        p, done = p_out, done | reach
    # steps taken before the latch, for the arc-uniform subsample
    n_active = torch.sum(~done_hist, dim=0).to(torch.float32)
    frac = ((torch.arange(n_samples, dtype=torch.float32, device=dev) + 0.5)
            / n_samples)
    sub = torch.clamp((frac[None, :] * n_active[:, None]).to(torch.int64),
                      0, n_steps - 1)
    pair = torch.arange(npair, device=dev)[:, None]
    return traj[sub, pair, :], arc


def trace_rays(t_fields, src_idx, src_pos, rx_pos, grid: Grid2D,
               n_steps: int, step: float, n_samples: int = 256):
    """Fermat ray paths by steepest descent on the travel-time fields, on
    the fields' device.

    From each receiver, marches ``p <- p - step * grad T / |grad T|`` (the
    gradient bilinearly interpolated from central differences of the pair's
    own source field) until within ``1.5 * step`` of the source, where the
    path latches onto the exact source point. Every step has arc length
    ``step`` until the latch, so a uniform-in-index subsample of the
    trajectory is uniform in arc length.

    Args:
        t_fields: (ns, ny, nx) :func:`eikonal_solve_batch` output.
        src_idx: (npair,) int source index per pair.
        src_pos: (npair, 2) physical source endpoints.
        rx_pos: (npair, 2) physical receiver endpoints.
        n_steps: march length; must exceed the longest path in steps.
        step: march step [m] (typically ``min(dx, dy) / 2``).
        n_samples: quadrature points per ray returned for path integrals.

    Returns:
        pts: (npair, n_samples, 2) points uniformly spaced along each path.
        lengths: (npair,) path arc lengths [m].
    """
    return _trace(t_fields, src_idx, src_pos, rx_pos, grid, int(n_steps),
                  step, int(n_samples))
