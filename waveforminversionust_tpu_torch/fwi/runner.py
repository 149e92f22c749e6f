"""The inversion entry point: dataset -> reconstruction (port of the 2D
single-device path of ``waveforminversionust_tpu.fwi.runner``): nonlinear
CG, L-BFGS or Gauss-Newton over one stage or a multi-frequency
continuation, on one RingDataset or a {frequency: RingDataset} mapping,
with receiver calibration at every stage boundary and, for CG, resumable
checkpoints and live callbacks; or a joint inversion of all frequencies of
a mapping at once. ``mesh`` is ported with the multi-device slice
(ROADMAP.md A7) and raises until then.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import (AcquisitionConfig, ContinuationConfig, FWIConfig,
                      SolverConfig)
from ..device import default_device
from ..models.acquisition import build_ring_acquisition
from ..models.grid import Grid2D
from ..utils import checkpoint
from .calibrate import estimate_receiver_sensitivities
from .lbfgs import run_lbfgs
from .multifreq import nonlinear_cg_multifreq, stack_frequencies
from .newton import run_gauss_newton
from .objective import build_fwi_data
from .optimizers import CGMetrics, nonlinear_cg

METHODS = ("cg", "lbfgs", "gn", "joint-multifreq")


class InversionResult(NamedTuple):
    velocity: np.ndarray          # (ny, nx) reconstructed speed [m/s]
    metrics: dict                 # per-iteration scalar histories (numpy)
    grid: Grid2D
    frequencies: tuple            # the continuation schedule run


def default_inversion_grid() -> Grid2D:
    """The reference's 301x301 / 0.8 mm reconstruction grid
    (fwi_script.py:46-49)."""
    return Grid2D.centered(120e-3, 0.8e-3)


def _initial_velocity(c_init, fwi: FWIConfig, grid: Grid2D, device):
    """None -> homogeneous fwi.c_init; scalar -> homogeneous; map -> as is."""
    if c_init is None:
        c_init = fwi.c_init
    c = torch.as_tensor(c_init, dtype=torch.float32)
    if c.dim() == 0:
        return torch.full(grid.shape, float(c), dtype=torch.float32,
                          device=device)
    if tuple(c.shape) != grid.shape:
        raise ValueError(f"c_init shape {tuple(c.shape)} != grid shape "
                         f"{grid.shape}")
    return c.to(device)


def _numpy_metrics(m):
    """A metrics NamedTuple of tensors as one of numpy arrays."""
    return type(m)(*(v.cpu().numpy() for v in m))


def _cat_metrics(parts: list[CGMetrics]) -> CGMetrics:
    return CGMetrics(*(np.concatenate([getattr(p, f) for p in parts])
                       for f in CGMetrics._fields))


def invert_dataset(dataset, grid: Grid2D | None = None,
                   acquisition: AcquisitionConfig = AcquisitionConfig(),
                   solver: SolverConfig = SolverConfig(),
                   fwi: FWIConfig = FWIConfig(),
                   continuation: ContinuationConfig | None = None,
                   method: str = "cg",
                   callback: Callable | None = None,
                   attenuation=None,
                   checkpoint_dir: str | None = None,
                   checkpoint_every: int | None = None,
                   resume_from: str | None = None,
                   live_every: int | None = None,
                   live_callback: Callable | None = None,
                   c_init=None,
                   mesh=None, grid_axis: str = "grid",
                   receiver_calibration: bool = False,
                   device=None) -> InversionResult:
    """Invert a RingDataset on ``device`` (default: the card,
    :func:`..device.default_device`, which raises when there is none; pass
    ``"cpu"`` for the plain PyTorch path).

    Args:
        dataset: a RingDataset, or a {frequency: RingDataset} mapping whose
            stages each fit their own recording.
        grid: reconstruction grid (default: the reference's 301x301).
        method: "cg" (nonlinear CG, the reference's primary path), "lbfgs"
            (:func:`.lbfgs.run_lbfgs` over the differentiable solve), "gn"
            (:func:`.newton.run_gauss_newton`) or "joint-multifreq" (all
            frequencies of a {frequency: dataset} mapping inverted jointly
            by :func:`.multifreq.nonlinear_cg_multifreq`, in place of the
            continuation).
        continuation: multi-frequency schedule; each stage runs
            ``iterations_per_frequency`` iterations at one frequency, warm
            started from the previous stage. None: one stage at
            ``dataset.f`` (the first mapping entry's) of
            ``fwi.num_iterations``.
        callback: ``callback(stage, frequency, velocity, stage_metrics)``
            after each stage (numpy velocity; CGMetrics or GNMetrics of
            numpy arrays, or L-BFGS's numpy loss history); for
            "joint-multifreq" once, with the tuple of frequencies.
        attenuation: known alpha [Np/m], a scalar or an (ny, nx) map on the
            reconstruction grid.
        checkpoint_dir / checkpoint_every: when both are set (method "cg"),
            each stage runs in chunks of ``checkpoint_every`` iterations and
            the whole resumable CG state (velocity, search direction,
            previous gradient, stage and iteration, frequency, metrics so
            far) is written to ``checkpoint_dir/latest`` after every chunk.
        resume_from: a ``latest`` checkpoint written as above; completed
            stages are skipped and the interrupted stage restarts at the
            saved iteration with the saved CG carry. The returned metrics
            hold the restored history of the interrupted stage onward.
        live_every / live_callback: ``live_callback(stage, frequency,
            iteration, velocity, chunk_metrics)`` every ``live_every`` CG
            iterations and at each stage's end (method "cg";
            ``live_every=1`` is the MATLAB script's redraw cadence,
            FrequencyDomainFWI.m:176-188).
        c_init: None (homogeneous ``fwi.c_init``), a scalar [m/s] or an
            (ny, nx) map.
        receiver_calibration: estimate and divide out per-element receiver
            sensitivities (:func:`.calibrate.estimate_receiver_sensitivities`)
            against the current model at every stage boundary.
        mesh / grid_axis: grid-sharded inversion, ported with the
            multi-device slice; ``mesh`` raises until then.

    Metrics: CG's four histories, or ``{"loss": ...}`` for "lbfgs" and
    "gn". A CG chunk is one ``nonlinear_cg`` call carrying the search
    direction, the previous gradient and the global iteration index, so
    momentum restarts only at a stage's first iteration. With
    ``refactor_every > 1`` each chunk factors on its first iteration, as in
    the reference, so a chunk that starts on a stale iteration refactors
    there.
    """
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if mesh is not None:
        raise NotImplementedError("mesh= (multi-device) is ported in a later "
                                  "slice (ROADMAP.md A, slice 7)")
    if device is None:
        device = default_device()
    per_freq = isinstance(dataset, dict)
    grid = grid or default_inversion_grid()
    if attenuation is not None and np.ndim(attenuation) == 0:
        attenuation = (None if float(attenuation) == 0.0 else
                       np.full(grid.shape, float(attenuation), np.float32))
    ds0 = next(iter(dataset.values())) if per_freq else dataset
    acq = build_ring_acquisition(grid, acquisition, x_elem=ds0.x_circ,
                                 y_elem=ds0.y_circ)

    if method == "joint-multifreq":
        if not per_freq:
            raise ValueError("method='joint-multifreq' needs a "
                             "{frequency: RingDataset} mapping")
        freqs = tuple(sorted(dataset))
        mf = stack_frequencies([
            build_fwi_data(acq, dataset[f].rec_data, f,
                           attenuation=attenuation, device=device)
            for f in freqs])
        vel, m = nonlinear_cg_multifreq(
            _initial_velocity(c_init, fwi, grid, device), mf, grid, solver,
            fwi)
        m = _numpy_metrics(m)
        if callback is not None:
            callback(0, freqs, vel.cpu().numpy(), m)
        return InversionResult(velocity=vel.cpu().numpy(),
                               metrics=m._asdict(), grid=grid,
                               frequencies=freqs)

    if continuation is None or not continuation.frequencies:
        stages = [(float(ds0.f), int(fwi.num_iterations))]
    else:
        stages = [(float(f), int(continuation.iterations_per_frequency))
                  for f in continuation.frequencies]

    vel = _initial_velocity(c_init, fwi, grid, device)
    start_stage, start_iter = 0, 0
    init_sd = init_gp = None
    resumed_parts: list[CGMetrics] = []
    if resume_from is not None:
        st = checkpoint.load_state(resume_from)
        vel = st["velocity"].to(device=device, dtype=torch.float32)
        start_stage = int(st["stage"])
        start_iter = int(st["iteration"])
        init_sd = st.get("search_dir")
        init_gp = st.get("grad_prev")
        m = st.get("metrics")
        if m is not None and start_iter > 0:
            resumed_parts = [CGMetrics(*(m[f].numpy()
                                         for f in CGMetrics._fields))]

    cg = method == "cg"
    checkpointing = cg and checkpoint_dir is not None and bool(checkpoint_every)
    live = cg and live_callback is not None and bool(live_every)
    histories: list[CGMetrics] = []
    losses: list[np.ndarray] = []
    for stage_idx, (freq, n_iter) in enumerate(stages):
        if stage_idx < start_stage:
            continue
        resuming_here = stage_idx == start_stage and resume_from is not None
        stage_it = start_iter if resuming_here else 0
        sd = init_sd if resuming_here else None
        gp = init_gp if resuming_here else None
        parts = list(resumed_parts) if resuming_here else []
        if resuming_here and stage_it >= n_iter:
            # The checkpoint landed on this stage's boundary: the stage is
            # complete; carry its restored history forward.
            if parts:
                histories.append(_cat_metrics(parts))
            continue
        stage_ds = dataset[freq] if per_freq else dataset
        data = build_fwi_data(acq, stage_ds.rec_data, freq,
                              attenuation=attenuation, device=device)
        if receiver_calibration:
            # Against the current model: residual model error in the
            # estimate shrinks as continuation sharpens the model.
            _, data = estimate_receiver_sensitivities(data, acq, vel, grid,
                                                      solver)
        if method == "lbfgs":
            res = run_lbfgs(vel, data, grid, solver, num_iterations=n_iter,
                            fwi=fwi)
            vel = res.velocity
            stage_metrics = res.loss_history.cpu().numpy()
            losses.append(stage_metrics)
        elif method == "gn":
            res = run_gauss_newton(vel, data, grid, solver, fwi=fwi,
                                   num_iterations=n_iter)
            vel = res.velocity
            stage_metrics = _numpy_metrics(res.metrics)
            losses.append(stage_metrics.loss)
        else:
            while stage_it < n_iter:
                chunk = n_iter - stage_it
                if checkpointing:
                    chunk = min(chunk, int(checkpoint_every))
                if live:
                    chunk = min(chunk, int(live_every))
                res = nonlinear_cg(vel, data, grid, solver, fwi,
                                   num_iterations=chunk, init_search_dir=sd,
                                   init_grad_prev=gp,
                                   iteration_offset=stage_it)
                vel, sd, gp = res.velocity, res.search_dir, res.gradient
                chunk_metrics = _numpy_metrics(res.metrics)
                parts.append(chunk_metrics)
                stage_it += chunk
                if live and (stage_it % int(live_every) == 0
                             or stage_it >= n_iter):
                    live_callback(stage_idx, freq, stage_it,
                                  vel.cpu().numpy(), chunk_metrics)
                if checkpointing:
                    so_far = _cat_metrics(parts)
                    checkpoint.save_state(
                        os.path.join(checkpoint_dir, "latest"), {
                            "velocity": vel, "search_dir": sd,
                            "grad_prev": gp, "stage": np.int32(stage_idx),
                            "iteration": np.int32(stage_it),
                            "frequency": np.float64(freq),
                            "metrics": so_far._asdict()})
            stage_metrics = _cat_metrics(parts)
            histories.append(stage_metrics)
        if callback is not None:
            callback(stage_idx, freq, vel.cpu().numpy(), stage_metrics)

    if cg:
        metrics = {f: np.concatenate([getattr(m, f) for m in histories])
                   for f in CGMetrics._fields}
    else:
        metrics = {"loss": np.concatenate(losses)}
    return InversionResult(velocity=vel.cpu().numpy(), metrics=metrics,
                           grid=grid, frequencies=tuple(f for f, _ in stages))


def reconstruction_rmse(velocity, grid: Grid2D, true_map, true_grid: Grid2D,
                        radius: float = 100e-3) -> float:
    """RMSE inside the ring between a reconstruction and a (finer-grid)
    truth map, bilinearly resampled onto the reconstruction grid."""
    tx = (grid.x - true_grid.x0) / true_grid.dx
    ty = (grid.y - true_grid.y0) / true_grid.dy
    ix = np.clip(tx.astype(int), 0, true_grid.nx - 2)
    iy = np.clip(ty.astype(int), 0, true_grid.ny - 2)
    wx = np.clip(tx - ix, 0, 1)[None, :]
    wy = np.clip(ty - iy, 0, 1)[:, None]
    t = np.asarray(true_map)
    interp = (t[np.ix_(iy, ix)] * (1 - wx) * (1 - wy)
              + t[np.ix_(iy, ix + 1)] * wx * (1 - wy)
              + t[np.ix_(iy + 1, ix)] * (1 - wx) * wy
              + t[np.ix_(iy + 1, ix + 1)] * wx * wy)
    X, Y = grid.meshgrid()
    inside = np.hypot(X, Y) < radius
    return float(np.sqrt(np.mean((np.asarray(velocity) - interp)[inside] ** 2)))


def make_logging_callback(every: int = 1, prefix: str = "[fwi]"):
    """A stage callback printing each stage's loss trajectory."""

    def callback(stage_idx, freq, velocity, stage_metrics):
        if stage_idx % every:
            return
        loss = np.asarray(getattr(stage_metrics, "loss", stage_metrics))
        print(f"{prefix} stage {stage_idx} f={freq / 1e3:.0f} kHz "
              f"loss {loss[0]:.3e} -> {loss[-1]:.3e}")

    return callback
