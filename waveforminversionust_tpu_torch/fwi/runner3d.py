"""The 3D inversion entry point (port of
``waveforminversionust_tpu.fwi.runner3d``): multi-frequency continuation
over the volumetric methods.

Takes the ``{frequency: FWIData3D}`` mapping (or a list, or one dataset)
that :func:`~..data.timedomain3d.timedomain_to_fwi_data_3d` produces, runs
the stages low to high, each warm-started from the last (the attenuation
map too, under "alpha" and "joint"), and collects the histories. The
inversion runs where the datasets live.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import ContinuationConfig, FWIConfig, PMLConfig
from ..models.grid3d import Grid3D
from ..utils import checkpoint
from .fwi3d import FWIData3D, nonlinear_cg_3d
from .lbfgs import run_lbfgs_3d, run_lbfgs_attenuation_3d
from .newton import run_gauss_newton_3d

_METHODS = ("cg", "gn", "lbfgs", "alpha", "joint")


class InversionResult3D(NamedTuple):
    velocity: np.ndarray          # (nz, ny, nx) reconstructed speed [m/s]
    metrics: dict                 # per-iteration scalar histories (numpy)
    grid: Grid3D
    frequencies: tuple            # the continuation schedule run


def reconstruction_rmse_3d(velocity, grid: Grid3D, true_map,
                           true_grid: Grid3D | None = None,
                           radius: float = 100e-3,
                           z_halfspan: float | None = None) -> float:
    """RMSE between a recovered volume and a truth on the same or another
    grid (trilinear resampling), inside the array cylinder (|r_xy| <
    radius, |z| < z_halfspan), where the data constrain the model (numpy)."""
    v = np.asarray(velocity)
    if true_grid is None or true_grid == grid:
        interp = np.asarray(true_map)
    else:
        t = np.asarray(true_map)
        fz = np.clip((grid.z - true_grid.z0) / true_grid.dz, 0,
                     true_grid.nz - 1 - 1e-6)
        fy = np.clip((grid.y - true_grid.y0) / true_grid.dy, 0,
                     true_grid.ny - 1 - 1e-6)
        fx = np.clip((grid.x - true_grid.x0) / true_grid.dx, 0,
                     true_grid.nx - 1 - 1e-6)
        iz, iy, ix = (f.astype(int) for f in (fz, fy, fx))
        wz = (fz - iz)[:, None, None]
        wy = (fy - iy)[None, :, None]
        wx = (fx - ix)[None, None, :]

        def g(dz_, dy_, dx_):
            return t[np.ix_(iz + dz_, iy + dy_, ix + dx_)]

        interp = ((g(0, 0, 0) * (1 - wx) + g(0, 0, 1) * wx) * (1 - wy)
                  + (g(0, 1, 0) * (1 - wx) + g(0, 1, 1) * wx) * wy
                  ) * (1 - wz) + (
                  (g(1, 0, 0) * (1 - wx) + g(1, 0, 1) * wx) * (1 - wy)
                  + (g(1, 1, 0) * (1 - wx) + g(1, 1, 1) * wx) * wy) * wz
    Z, Y, X = grid.meshgrid()
    inside = np.hypot(X, Y) < radius
    if z_halfspan is not None:
        inside &= np.abs(Z) < z_halfspan
    return float(np.sqrt(np.mean((v - interp)[inside] ** 2)))


def _initial_velocity_3d(c_init, fwi: FWIConfig, grid: Grid3D, device):
    """None -> homogeneous fwi.c_init; scalar -> homogeneous; an (nz, ny,
    nx) volume -> as given."""
    if c_init is None:
        c_init = fwi.c_init
    c = torch.as_tensor(c_init, dtype=torch.float32)
    if c.dim() == 0:
        return torch.full(grid.shape, float(c), dtype=torch.float32,
                          device=device)
    if tuple(c.shape) != grid.shape:
        raise ValueError(f"c_init shape {tuple(c.shape)} != grid "
                         f"{grid.shape}")
    return c.to(device)


def invert_dataset_3d(datasets, grid: Grid3D,
                      fwi: FWIConfig = FWIConfig(),
                      continuation: ContinuationConfig | None = None,
                      method: str = "cg",
                      c_init=None,
                      pml: PMLConfig = PMLConfig(a0=20.0, l_pml=12e-3),
                      iter_cap: int = 600,
                      solver3d: str = "gmres", gmres_tol: float = 2e-3,
                      gmres_restart: int = 8, spectral: str = "auto",
                      mesh=None, grid_axis: str = "grid",
                      encode: int | None = None, encode_seed: int = 0,
                      chunk_iterations: int | None = None,
                      callback: Callable | None = None,
                      cg_iters: int = 6, lm_damping: float = 0.1,
                      reg_smooth: float = 1.0,
                      num_iterations: int | None = None,
                      checkpoint_dir: str | None = None,
                      resume_from: str | None = None) -> InversionResult3D:
    """Invert one or many per-frequency 3D datasets.

    Args:
        datasets: one :class:`~.fwi3d.FWIData3D`, a list of them, or a
            ``{frequency: FWIData3D}`` mapping.
        method: "cg" (:func:`~.fwi3d.nonlinear_cg_3d`; takes ``encode``),
            "gn" (:func:`~.newton.run_gauss_newton_3d`; ``cg_iters``,
            ``lm_damping``, ``reg_smooth`` are its knobs), "lbfgs"
            (:func:`~.lbfgs.run_lbfgs_3d`), or "alpha" / "joint"
            (:func:`~.lbfgs.run_lbfgs_attenuation_3d`: the attenuation map
            in the fixed starting medium, or jointly with the velocity; the
            map lands in ``metrics['attenuation']``). Scattered-field data
            (``rec_ref``) takes "cg" and "lbfgs" only; ``mesh`` and
            ``encode`` are "cg" options.
        continuation: optional schedule; each listed frequency (matched to
            a dataset key to a relative 1e-6, since keys are float32 values)
            runs ``iterations_per_frequency`` iterations from the previous
            stage's model. None: every dataset once in ascending frequency
            with ``num_iterations`` (default: ``fwi.num_iterations`` for
            "cg", 5 for "gn", 10 for the others).
        c_init: None (homogeneous ``fwi.c_init``), a scalar, or an (nz, ny,
            nx) volume.
        callback: ``callback(stage_idx, frequency, velocity, metrics)``
            after every stage.
        checkpoint_dir: save the driver state (velocity, attenuation,
            histories, completed stage) to ``<dir>/latest`` after every
            stage; ``resume_from`` such a file restarts at the next stage
            with the same trajectory.

    Returns:
        :class:`InversionResult3D`, ``metrics['loss']`` and
        ``metrics['frequency']`` concatenated over the stages.
    """
    if isinstance(datasets, FWIData3D):
        datasets = {float(datasets.f): datasets}
    elif isinstance(datasets, (list, tuple)):
        datasets = {float(d.f): d for d in datasets}
    if continuation is not None and continuation.frequencies:
        keys = np.array(sorted(datasets))
        schedule = []
        for f in continuation.frequencies:
            i = int(np.argmin(np.abs(keys - float(f))))
            if abs(keys[i] - float(f)) > 1e-6 * max(abs(float(f)), 1.0):
                raise ValueError(f"continuation frequency {f} not in "
                                 f"datasets ({sorted(datasets)})")
            schedule.append((float(keys[i]),
                             continuation.iterations_per_frequency))
    else:
        schedule = [(f, num_iterations) for f in sorted(datasets)]
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r} (expected 'cg', "
                         "'gn', 'lbfgs', 'alpha' or 'joint')")

    device = next(iter(datasets.values())).src.device
    vel = _initial_velocity_3d(c_init, fwi, grid, device)
    alpha = torch.zeros(grid.shape, dtype=torch.float32, device=device)
    losses, freq_trace = [], []
    start_stage = 0
    if resume_from is not None:
        st = checkpoint.load_state(resume_from)
        vel = st["velocity"].to(device=device, dtype=torch.float32)
        alpha = st["attenuation"].to(device=device, dtype=torch.float32)
        start_stage = int(st["stage"]) + 1        # that stage completed
        losses = [st["loss"].numpy()]
        freq_trace = [st["freq_trace"].numpy()]
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)

    for stage_idx, (f, iters) in enumerate(schedule):
        if stage_idx < start_stage:
            continue
        data = datasets[f]
        if data.rec_ref is not None and method not in ("cg", "lbfgs"):
            raise ValueError(
                "scattered-field data (rec_ref) is supported by the "
                "cg and lbfgs methods; gn/alpha/joint would compare the "
                "total simulation against scattered observations")
        if method != "cg" and (mesh is not None or encode is not None):
            raise ValueError("mesh/encode are CG-path options; pre-encode "
                             "the data with fwi3d.encode_supershots instead")
        if method == "cg":
            vel, metrics = nonlinear_cg_3d(
                vel, data, grid, fwi, num_iterations=iters, pml=pml,
                iter_cap=iter_cap, mesh=mesh, grid_axis=grid_axis,
                solver3d=solver3d, gmres_tol=gmres_tol,
                gmres_restart=gmres_restart, spectral=spectral,
                encode=encode, encode_seed=encode_seed + stage_idx,
                chunk_iterations=chunk_iterations)
            history = metrics.loss
        elif method == "gn":
            vel, metrics = run_gauss_newton_3d(
                vel, data, grid, fwi,
                num_iterations=(iters if iters is not None else 5),
                cg_iters=cg_iters, lm_damping=lm_damping,
                reg_smooth=reg_smooth, pml=pml, iter_cap=iter_cap,
                solver3d=solver3d, gmres_tol=gmres_tol,
                gmres_restart=gmres_restart, spectral=spectral)
            history = metrics.loss
        elif method == "lbfgs":
            metrics = run_lbfgs_3d(
                vel, data, grid, pml, iter_cap=iter_cap, spectral=spectral,
                use_gmres=(solver3d == "gmres"), tol=gmres_tol,
                restart=gmres_restart,
                num_iterations=(iters if iters is not None else 10))
            vel, history = metrics.velocity, metrics.loss_history
        else:
            metrics = run_lbfgs_attenuation_3d(
                vel, alpha, data, grid, pml, iter_cap=iter_cap,
                spectral=spectral, use_gmres=(solver3d == "gmres"),
                tol=gmres_tol, restart=gmres_restart,
                num_iterations=(iters if iters is not None else 10),
                invert_velocity=(method == "joint"))
            vel, alpha = metrics.velocity, metrics.attenuation
            history = metrics.loss_history
        stage_loss = history.cpu().numpy()
        if fwi.clip_velocity is not None:
            vel = torch.clamp(vel, *fwi.clip_velocity)
        losses.append(stage_loss)
        freq_trace.append(np.full(len(stage_loss), f))
        if checkpoint_dir is not None:
            checkpoint.save_state(os.path.join(checkpoint_dir, "latest"), {
                "velocity": vel, "attenuation": alpha,
                "stage": np.int32(stage_idx),
                "loss": np.concatenate(losses),
                "freq_trace": np.concatenate(freq_trace),
            })
        if callback is not None:
            callback(stage_idx, f, vel, metrics)

    metrics_out = {"loss": np.concatenate(losses),
                   "frequency": np.concatenate(freq_trace)}
    if method in ("alpha", "joint"):
        metrics_out["attenuation"] = alpha.cpu().numpy()
    return InversionResult3D(
        velocity=vel.cpu().numpy(), metrics=metrics_out, grid=grid,
        frequencies=tuple(f for f, _ in schedule))
