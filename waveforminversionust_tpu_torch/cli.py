"""Command-line interface (port of ``waveforminversionust_tpu.cli``):
``python -m waveforminversionust_tpu_torch.cli <cmd>`` or ``wiust-torch
<cmd>``.

Subcommands cover the reference's entry points (reference: README.md:36-39
'python fwi_script.py'; SimulateData.m; TimeDomainSimulation.m) with the
JAX package's flags and defaults. Every subcommand runs on the card unless
``--device cpu`` (or another device) is given; without a card and without
``--device`` it raises (``device.default_device``). Plots need matplotlib
and are imported only when a plot is asked for.

  run        invert a recorded dataset (CG or L-BFGS, optional continuation)
  simulate   synthesize a ring-array dataset from a phantom
  timedomain multi-frequency sweep -> time-domain movie + channel data
  broadband  time-domain acquisition synthesis -> frequency extraction ->
             multi-frequency continuation FWI (the full broadband workflow)
  broadband3d  the same workflow volumetrically: cylinder-array (tx, rx, t)
             synthesis -> optional 3D travel-time init -> 3D FWI
  qc         acquisition QC: reciprocity, element responses, bad channels
  bench      the headline benchmark: not ported yet (raises)
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .device import default_device
from .utils.host import fetch


def _parse_calibrate_spec(spec: str):
    """Parse the --calibrate CMIN:CMAX[:NUM] spec; exit with a usage error
    (not a raw traceback) on a malformed value."""
    usage = (f"--calibrate expects CMIN:CMAX[:NUM] with CMIN < CMAX "
             f"(e.g. 1400:1600:9); got {spec!r}")
    parts = spec.split(":")
    try:
        if len(parts) not in (2, 3):
            raise ValueError(usage)
        c_lo, c_hi = float(parts[0]), float(parts[1])
        n_cand = int(parts[2]) if len(parts) == 3 else 9
    except ValueError:
        raise SystemExit(usage)
    if not (c_lo < c_hi) or n_cand < 3:
        raise SystemExit(usage + " and NUM >= 3")
    return c_lo, c_hi, n_cand


def _run_alpha_inversion(args, ds, grid, solver, fwi):
    """--method alpha/joint: attenuation(-and-velocity) inversion through
    the differentiable lossy solve (no reference counterpart)."""
    from .config import AcquisitionConfig
    from .fwi.lbfgs import run_lbfgs_attenuation
    from .fwi.objective import build_fwi_data
    from .fwi.runner import default_inversion_grid
    from .models.acquisition import build_ring_acquisition

    grid = grid or default_inversion_grid()
    acq = build_ring_acquisition(
        grid, AcquisitionConfig(num_elements=args.elements or 256,
                                radius=args.radius or 110e-3,
                                num_excluded_each_side=args.exclude,
                                interpolation=args.interpolation),
        x_elem=ds.x_circ, y_elem=ds.y_circ)
    data = build_fwi_data(acq, ds.rec_data, ds.f,
                          split=solver.split_complex, device=args.device)
    vel0 = np.full(grid.shape, args.c_init, np.float32)
    res = run_lbfgs_attenuation(vel0, np.zeros(grid.shape, np.float32),
                                data, grid, solver,
                                num_iterations=args.iterations,
                                invert_velocity=args.method == "joint")
    res = res._replace(**{k: fetch(v) for k, v in res._asdict().items()})
    print("loss history:", np.array2string(np.asarray(res.loss_history),
                                           precision=3))
    print(f"alpha range: {float(np.min(res.attenuation)):.1f} .. "
          f"{float(np.max(res.attenuation)):.1f} Np/m")
    if args.out:
        if args.out.endswith(".mat"):
            from .data.matio import save_mat
            save_mat(args.out, {
                "ALPHA_F": np.asarray(res.attenuation, np.float64),
                "VEL_F": np.asarray(res.velocity, np.float64),
                "xi": np.asarray(grid.x, np.float64),
                "yi": np.asarray(grid.y, np.float64),
            })
        else:
            np.save(args.out, np.asarray(res.attenuation))
        print("attenuation map written to", args.out)
    if args.plot:
        from . import viz
        plt = viz.plt
        n = 2 if args.method == "joint" else 1
        fig, axs = plt.subplots(1, n, figsize=(5.5 * n, 4.5), squeeze=False)
        viz.imagesc(axs[0, 0], grid, np.asarray(res.attenuation),
                    cmap="magma", title="recovered alpha [Np/m]")
        if n == 2:
            viz.imagesc(axs[0, 1], grid, np.asarray(res.velocity),
                        title="recovered velocity [m/s]")
        fig.tight_layout()
        fig.savefig(args.plot, dpi=110)
        print("plots written to", args.plot)


def _cmd_run(args):
    from .config import ContinuationConfig, FWIConfig, MomentumFormula, StepSizeFormula
    from .data.matio import load_recorded_dataset
    from .fwi.runner import invert_dataset, reconstruction_rmse
    from .models.grid import Grid2D

    ds = load_recorded_dataset(args.data)
    if args.qc_compensate:
        # Reciprocity QC + per-element response compensation (data.qc) —
        # equalizes the synthesizer's random |a_t| shot weighting before
        # calibration/inversion. Stacks with --calibrate into the measured
        # quality-record intake chain (PERF_NOTES round 3: 15.09 -> 4.20
        # m/s on the reference dataset with bilinear + illumination).
        from .data.qc import compensate_reciprocity, qc_report
        rep = qc_report(ds.rec_data, exclude_each_side=args.exclude)
        print(f"qc: reciprocity asymmetry {rep.asymmetry_raw:.3g} -> "
              f"{rep.asymmetry_compensated:.3g}; bad channels: "
              f"{rep.bad_elements.tolist() or 'none'}")
        ds = ds._replace(rec_data=compensate_reciprocity(ds.rec_data,
                                                         rep.ratios))
    grid = None
    if args.grid_xmax:
        grid = Grid2D.centered(args.grid_xmax, args.grid_dx)
    fwi = FWIConfig(c_init=args.c_init, num_iterations=args.iterations,
                    momentum=MomentumFormula(args.momentum),
                    step_size=StepSizeFormula(args.step_formula),
                    reject_increase=args.reject_increase,
                    reg_tikhonov=args.reg_tikhonov, reg_tv=args.reg_tv,
                    precondition=args.precondition,
                    precondition_eps=args.precondition_eps)
    continuation = None
    if args.frequencies:
        continuation = ContinuationConfig(
            frequencies=tuple(float(f) for f in args.frequencies),
            iterations_per_frequency=args.iterations)
    callback = None
    if args.checkpoint_dir:
        from .utils.checkpoint import make_stage_checkpointer
        callback = make_stage_checkpointer(args.checkpoint_dir)
    from .config import AcquisitionConfig, SolverConfig, SolverMethod
    solver = SolverConfig(method=SolverMethod(args.solver_method))
    if args.full_precision:
        import dataclasses
        solver = dataclasses.replace(solver, fast_linesearch=False,
                                     fast_adjoint=False, fast_forward=False)
    acq_kwargs = {"acquisition": AcquisitionConfig(
        num_elements=args.elements or 256,
        radius=args.radius or 110e-3,
        num_excluded_each_side=args.exclude,
        interpolation=args.interpolation)}
    if args.calibrate:
        # Background (water) speed calibration before inversion — replaces
        # the reference's hardcoded c_init=1480 (fwi_script.py:90) with the
        # data's own projected-misfit minimum (fwi.calibrate).
        import dataclasses
        from .fwi.calibrate import calibrate_background_speed
        c_lo, c_hi, n_cand = _parse_calibrate_spec(args.calibrate)
        cal = calibrate_background_speed(
            ds, grid=grid, acquisition=acq_kwargs["acquisition"],
            solver=solver, c_min=c_lo, c_max=c_hi, num=n_cand,
            device=args.device)
        print(f"calibrated background speed: {cal.c0:.2f} m/s "
              f"(grid best {cal.c_grid_best:.1f}, "
              f"relative misfit {cal.misfits.min():.3e})")
        fwi = dataclasses.replace(fwi, c_init=float(cal.c0))
    if args.method in ("alpha", "joint"):
        _run_alpha_inversion(args, ds, grid, solver, fwi)
        return
    if args.receiver_calibration:
        acq_kwargs["receiver_calibration"] = True
    if args.attenuation:
        acq_kwargs["attenuation"] = float(args.attenuation)  # expanded below
    if args.live_plot:
        # the reference's live redraw cadence (FrequencyDomainFWI.m:176-188)
        from . import viz
        from .fwi.runner import default_inversion_grid
        acq_kwargs["live_every"] = args.live_every
        acq_kwargs["live_callback"] = viz.make_live_plot_callback(
            args.live_plot, grid or default_inversion_grid(), true_map=ds.c,
            true_grid=(Grid2D.from_arrays(ds.x, ds.y)
                       if ds.c is not None else None),
            overwrite=not args.live_filmstrip)
    if args.profile:
        from .utils.profiling import trace
        with trace(args.profile):
            res = invert_dataset(ds, grid=grid, solver=solver, fwi=fwi,
                                 method=args.method,
                                 continuation=continuation, callback=callback,
                                 device=args.device, **acq_kwargs)
        print("profiler trace written to", args.profile)
    else:
        res = invert_dataset(ds, grid=grid, solver=solver, fwi=fwi,
                             method=args.method,
                             continuation=continuation, callback=callback,
                             device=args.device, **acq_kwargs)
    print("loss history:", np.array2string(res.metrics["loss"], precision=3))
    if ds.c is not None:
        true_grid = Grid2D.from_arrays(ds.x, ds.y)
        rmse = reconstruction_rmse(res.velocity, res.grid, ds.c, true_grid)
        print(f"reconstruction RMSE vs true map: {rmse:.2f} m/s")
    if args.plot:
        from . import viz
        viz.plot_reconstruction(res.grid, res.velocity, true_map=ds.c,
                                true_grid=Grid2D.from_arrays(ds.x, ds.y),
                                path=args.plot)
        viz.plot_convergence(res.metrics,
                             path=args.plot.replace(".png", "_conv.png"))
        print("plots written to", args.plot)
    if args.out:
        if args.out.endswith(".mat"):
            # MATLAB-compatible export mirroring the reference's workspace
            # variables (VEL_F the recovered map; xi/yi the inversion grid —
            # reference: FrequencyDomainFWI.m:49-55, nonlinearcg.py:41-55).
            from .data.matio import save_mat
            save_mat(args.out, {
                "VEL_F": np.asarray(res.velocity, np.float64),
                "xi": np.asarray(res.grid.x, np.float64),
                "yi": np.asarray(res.grid.y, np.float64),
                "loss": np.asarray(res.metrics["loss"], np.float64),
            })
        else:
            np.save(args.out, res.velocity)
        print("velocity saved to", args.out)


def _cmd_simulate(args):
    from .config import AcquisitionConfig, SolverConfig
    from .data.matio import save_recorded_dataset
    from .data.synthesize import synthesize_ring_dataset
    from .models.grid import Grid2D
    from .models.phantom import breast_phantom

    grid = Grid2D.centered(args.xmax, args.dx)
    vel = breast_phantom(grid, seed=args.seed)
    acq = AcquisitionConfig(num_elements=args.elements, radius=args.radius)
    ds = synthesize_ring_dataset(vel, grid, acq, f=args.frequency,
                                 seed=args.seed, solver=SolverConfig(),
                                 device=args.device)
    save_recorded_dataset(args.out, ds)
    print(f"dataset written to {args.out}: grid {grid.shape}, "
          f"{args.elements} elements, f={args.frequency / 1e3:.0f} kHz")


def _cmd_timedomain(args):
    from .config import SolverConfig
    from .data.timedomain import simulate_time_domain
    from .models.grid import Grid2D
    from .models.phantom import breast_phantom

    grid = Grid2D.centered(args.xmax, args.dx)
    vel = breast_phantom(grid, seed=args.seed)
    res = simulate_time_domain(vel, grid, element_idx=args.element,
                               num_elements=args.elements,
                               radius=args.radius,
                               solver=SolverConfig(), device=args.device)
    print(f"synthesized {res.wavefields_t.shape[0]} time frames over "
          f"{len(res.freqs)} frequencies")
    if args.plot or args.gif:
        from . import viz
    if args.plot:
        viz.plot_time_snapshots(grid, res, path=args.plot)
        print("plot written to", args.plot)
    if args.gif:
        viz.save_time_animation(grid, res, args.gif)
        print("animation written to", args.gif)


def _cmd_broadband(args):
    """Full broadband workflow: time-domain acquisition synthesis ->
    frequency extraction -> multi-frequency continuation inversion (no
    reference counterpart — it inverts externally-prepared single-frequency
    data; see data/timedomain.py)."""
    from .config import (AcquisitionConfig, ContinuationConfig, FWIConfig,
                         SolverConfig)
    from .data.timedomain import (synthesize_time_domain_dataset,
                                  timedomain_to_ring_datasets)
    from .fwi.runner import invert_dataset, reconstruction_rmse
    from .models.acquisition import ring_positions, snap_to_grid
    from .models.grid import Grid2D
    from .models.phantom import breast_phantom

    coarse = Grid2D.centered(args.xmax, args.inv_dx)
    fine = Grid2D.centered(args.xmax, args.fine_dx)
    # snap elements to the INVERSION grid so both grids place them
    # identically (see data.synthesize.synthesize_ring_dataset)
    xi, yi = snap_to_grid(coarse, *ring_positions(args.elements, args.radius))
    xs, ys = coarse.x[xi], coarse.y[yi]
    vel = breast_phantom(fine, seed=args.seed)
    acq = AcquisitionConfig(num_elements=args.elements, radius=args.radius,
                            num_excluded_each_side=args.exclude,
                            interpolation=args.interpolation)
    solver = SolverConfig()

    td = synthesize_time_domain_dataset(
        vel, fine, acq, f_low=args.f_low, f_high=args.f_high, df=args.df,
        solver=solver, seed=args.seed, x_elem=xs, y_elem=ys,
        device=args.device)
    print(f"traces {td.traces.shape} [tx, rx, t] over "
          f"{len(td.freqs)} comb lines")

    freqs = tuple(float(f) for f in (args.freqs or
                                     (args.f_low, (args.f_low + args.f_high) / 2,
                                      args.f_high)))
    c_init_map = None
    if args.traveltime_init:
        from .data.timedomain import direct_arrival_gate
        from .fwi.traveltime import traveltime_init
        pre, post, taper = args.gate
        gated = direct_arrival_gate(td, c_ref=args.c_init, pre=pre,
                                    post=post, taper=taper)
        c_init_map = traveltime_init(gated, coarse,
                                     num_excluded_each_side=args.exclude,
                                     c_ref=args.c_init,
                                     method=args.traveltime_method,
                                     device=args.device)
        rmse0 = reconstruction_rmse(c_init_map, coarse, np.asarray(vel), fine)
        print(f"travel-time starting model RMSE {rmse0:.2f} m/s")

    # deconvolve=False: the per-shot source estimate absorbs the transmit
    # spectrum (the measured-data regime)
    datasets = timedomain_to_ring_datasets(td, freqs, deconvolve=False)
    res = invert_dataset(
        datasets, grid=coarse, acquisition=acq, solver=solver,
        fwi=FWIConfig(c_init=args.c_init), c_init=c_init_map,
        continuation=ContinuationConfig(frequencies=freqs,
                                        iterations_per_frequency=args.iterations),
        device=args.device)
    print("loss history:", np.array2string(res.metrics["loss"], precision=3))
    rmse = reconstruction_rmse(res.velocity, coarse, np.asarray(vel), fine)
    print(f"reconstruction RMSE vs phantom: {rmse:.2f} m/s")
    if args.plot:
        from . import viz
        viz.plot_reconstruction(coarse, res.velocity, true_map=np.asarray(vel),
                                true_grid=fine, path=args.plot)
        print("plot written to", args.plot)


def _cmd_broadband3d(args):
    """Volumetric broadband workflow: cylinder-array (tx, rx, t) synthesis
    -> optional travel-time starting volume -> multi-frequency 3D FWI
    through the turnkey entry point (no reference counterpart — it is
    strictly 2D; see data/timedomain3d.py, fwi/runner3d.py)."""
    from .config import ContinuationConfig, FWIConfig, PMLConfig
    from .data.timedomain3d import (direct_arrival_gate_3d,
                                    synthesize_time_domain_dataset_3d,
                                    timedomain_to_fwi_data_3d)
    from .fwi.runner3d import invert_dataset_3d
    from .models.acquisition3d import cylinder_positions
    from .models.grid3d import Grid3D

    grid = Grid3D.centered(args.xmax, args.dx)
    pos = cylinder_positions(args.rings, args.per_ring, args.radius,
                             args.z_span)
    pml = PMLConfig(a0=20.0, l_pml=args.l_pml)

    Z, Y, X = grid.meshgrid()
    r2 = (X - 0.15 * args.radius) ** 2 + Y ** 2 + Z ** 2
    vel = (args.c_init + args.dv
           * np.exp(-r2 / (2 * (args.blob_radius / 2) ** 2))
           ).astype(np.float32)

    td = synthesize_time_domain_dataset_3d(
        vel, grid, pos, f_low=args.f_low, f_high=args.f_high, df=args.df,
        pml=pml, seed=args.seed, device=args.device)
    print(f"traces {td.traces.shape} [tx, rx, t] over "
          f"{len(td.freqs)} comb lines")

    rmse = lambda v: float(np.sqrt(np.mean((fetch(v) - vel) ** 2)))
    c_init_map = None
    if args.traveltime_init:
        from .fwi.traveltime3d import traveltime_init_3d
        pre, post, taper = args.gate
        gated = direct_arrival_gate_3d(td, c_ref=args.c_init, pre=pre,
                                       post=post, taper=taper)
        c_init_map = traveltime_init_3d(
            gated, grid, min_angle=args.min_angle, c_ref=args.c_init,
            method=args.traveltime_method,
            clip_velocity=(args.c_init - 2 * args.dv,
                           args.c_init + 2 * args.dv),
            device=args.device)
        print(f"travel-time starting volume RMSE {rmse(c_init_map):.2f} "
              f"(homogeneous {rmse(np.full(grid.shape, args.c_init)):.2f})"
              " m/s")

    freqs = tuple(float(f) for f in (
        args.freqs or (args.f_low, (args.f_low + args.f_high) / 2,
                       args.f_high)))
    _, datasets = timedomain_to_fwi_data_3d(td, freqs, grid,
                                            min_angle=args.min_angle,
                                            device=args.device)
    if args.scattered:
        from .fwi.fwi3d import scattered_data_3d
        datasets = [scattered_data_3d(d, grid, c_ref=args.c_init, pml=pml)
                    for d in datasets]
    res = invert_dataset_3d(
        datasets, grid,
        FWIConfig(c_init=args.c_init,
                  clip_velocity=(args.c_init - 2.5 * args.dv,
                                 args.c_init + 2.5 * args.dv)),
        continuation=ContinuationConfig(
            frequencies=freqs, iterations_per_frequency=args.iterations),
        method=args.method, c_init=c_init_map, pml=pml,
        solver3d="gmres", iter_cap=400, encode=args.encode,
        chunk_iterations=args.chunk)
    print("loss history:", np.array2string(res.metrics["loss"], precision=3))
    print(f"reconstruction RMSE vs phantom: {rmse(res.velocity):.2f} m/s")
    if args.out:
        np.save(args.out, res.velocity)
        print("velocity volume written to", args.out)
    if args.plot:
        from . import viz
        plt = viz.plt
        fig, axs = plt.subplots(2, 3, figsize=(13, 8))
        mids = [grid.nz // 2, grid.ny // 2, grid.nx // 2]
        for col, (name, tr, rc) in enumerate((
                ("z", vel[mids[0]], res.velocity[mids[0]]),
                ("y", vel[:, mids[1]], res.velocity[:, mids[1]]),
                ("x", vel[..., mids[2]], res.velocity[..., mids[2]]))):
            vmin, vmax = float(vel.min()), float(vel.max())
            axs[0, col].imshow(tr, vmin=vmin, vmax=vmax, cmap="viridis")
            axs[0, col].set_title(f"true, mid-{name} slice")
            im = axs[1, col].imshow(rc, vmin=vmin, vmax=vmax, cmap="viridis")
            axs[1, col].set_title(f"recovered, mid-{name} slice")
        fig.colorbar(im, ax=axs.ravel().tolist(), label="m/s")
        fig.savefig(args.plot, dpi=110)
        print("plot written to", args.plot)


def _cmd_bench(args):
    raise NotImplementedError(
        "bench: the JAX package's bench.py is not ported; the port's "
        "benchmark comes with its benchmark harness (ROADMAP.md A0). "
        "python3 chip_smoke.py drives the port on the card meanwhile")


def _cmd_qc(args):
    from .data.matio import load_recorded_dataset
    from .data.qc import compensate_reciprocity, qc_report
    ds = load_recorded_dataset(args.data)
    rep = qc_report(ds.rec_data, exclude_each_side=args.exclude,
                    residual_threshold=args.residual_threshold,
                    energy_threshold=args.energy_threshold)
    print(f"reciprocity asymmetry: raw {rep.asymmetry_raw:.4g} -> "
          f"compensated {rep.asymmetry_compensated:.4g}")
    print(f"element response ratios |c|: min {np.abs(rep.ratios).min():.3g} "
          f"median 1 max {np.abs(rep.ratios).max():.3g}")
    if rep.bad_elements.size:
        print("BAD elements:", rep.bad_elements.tolist())
        for e in rep.bad_elements:
            print(f"  element {e}: residual {rep.element_residual[e]:.3g}, "
                  f"energy {rep.element_energy[e]:.3g}x median")
    else:
        print("all channels healthy")
    if args.out:
        from .data.matio import save_mat
        mc = compensate_reciprocity(ds.rec_data, rep.ratios)
        arrays = {
            "REC_DATA": mc.astype(np.complex64),
            "x": np.asarray(ds.x, np.float64),
            "y": np.asarray(ds.y, np.float64),
            "x_circ": np.asarray(ds.x_circ, np.float64),
            "y_circ": np.asarray(ds.y_circ, np.float64),
            "f": np.float64(ds.f),
        }
        if ds.c is not None:
            arrays["C"] = np.asarray(ds.c, np.float64)
        save_mat(args.out, arrays)
        print("reciprocity-compensated dataset written to", args.out)


def main(argv=None):
    p = argparse.ArgumentParser(prog="waveforminversionust_tpu_torch",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="invert a recorded dataset")
    pr.add_argument("data", help=".mat file in the RecordedData schema")
    pr.add_argument("--method", choices=["cg", "lbfgs", "gn", "alpha",
                                         "joint"],
                    default="cg",
                    help="cg/lbfgs invert velocity (reference paths); 'gn' "
                         "is truncated Gauss-Newton (framework addition — "
                         "fewer iterations to a given misfit); "
                         "'alpha' inverts the attenuation map in a medium "
                         "at --c-init, 'joint' inverts velocity and alpha "
                         "together (framework additions; L-BFGS through "
                         "the differentiable lossy solve)")
    pr.add_argument("--iterations", type=int, default=10)
    pr.add_argument("--c-init", type=float, default=1480.0)
    pr.add_argument("--receiver-calibration", action="store_true",
                    help="estimate + divide out per-element receiver "
                         "sensitivities at every continuation stage "
                         "(fwi.calibrate.estimate_receiver_sensitivities)")
    pr.add_argument("--calibrate", nargs="?", const="1400:1600:9",
                    default=None, metavar="CMIN:CMAX[:NUM]",
                    help="calibrate the background (water) speed from the "
                         "data before inverting (overrides --c-init with "
                         "the projected-misfit minimum; fwi.calibrate)")
    pr.add_argument("--qc-compensate", action="store_true",
                    help="run reciprocity QC on the data matrix and divide "
                         "out the estimated per-element response ratios "
                         "before inverting (data.qc; with --calibrate this "
                         "is the measured quality-record intake chain, "
                         "PERF_NOTES round 3)")
    pr.add_argument("--momentum", type=int, default=4,
                    help="0=GD 1=FR 2=PR 3=PR^FR 4=HS")
    pr.add_argument("--reject-increase", type=float, default=None,
                    metavar="R",
                    help="nonmonotone watchdog: revert an iteration whose "
                         "misfit exceeds R x the previous baseline and "
                         "restart the CG recurrence (e.g. 1.5; neutral on "
                         "clean runs — PERF_NOTES round 5)")
    pr.add_argument("--step-formula", type=int, default=1,
                    help="1|2|3 (reference linearized line searches) | 4 "
                         "(BB curvature-scalar: skips the third solve per "
                         "iteration, 1.11x — use with --calibrate or a good "
                         "--c-init; PERF_NOTES round 5)")
    pr.add_argument("--frequencies", nargs="*", type=float, default=None,
                    help="multi-frequency continuation schedule [Hz]")
    pr.add_argument("--checkpoint-dir", default=None)
    pr.add_argument("--plot", default=None, help="output PNG path")
    pr.add_argument("--out", default=None,
                    help="output velocity path: .npy, or .mat for a "
                         "MATLAB-compatible export (VEL_F/xi/yi/loss, "
                         "mirroring the reference's workspace variables)")
    pr.add_argument("--grid-xmax", type=float, default=None,
                    help="reconstruction grid half-width [m] (default 120e-3)")
    pr.add_argument("--grid-dx", type=float, default=0.8e-3)
    pr.add_argument("--elements", type=int, default=None,
                    help="number of ring elements (default 256)")
    pr.add_argument("--radius", type=float, default=None)
    pr.add_argument("--exclude", type=int, default=31,
                    help="receivers excluded each side of tx")
    pr.add_argument("--interpolation", choices=["nearest", "bilinear"],
                    default="nearest",
                    help="element placement; bilinear removes snapping error")
    pr.add_argument("--profile", default=None,
                    help="capture a torch.profiler trace (CPU and card) "
                         "to DIR/trace.json")
    pr.add_argument("--solver-method", choices=["banded", "born", "gmres"],
                    default="banded", help="Helmholtz solver")
    pr.add_argument("--precondition", choices=["illumination"], default=None,
                    help="gradient preconditioning: 'illumination' divides "
                         "the gradient by the source-illumination map (the "
                         "diagonal pseudo-Hessian; reaches baseline quality "
                         "in half the iterations on the reference workload)")
    pr.add_argument("--precondition-eps", type=float, default=1e-2,
                    help="illumination floor as a fraction of its maximum")
    pr.add_argument("--reg-tikhonov", type=float, default=0.0,
                    help="smoothing regularization weight (0-1, rel. to data gradient)")
    pr.add_argument("--reg-tv", type=float, default=0.0,
                    help="total-variation regularization weight")
    pr.add_argument("--live-plot", default=None, metavar="DIR",
                    help="redraw the reconstruction panel every "
                         "--live-every iterations into DIR (the MATLAB "
                         "script's live-plot cadence)")
    pr.add_argument("--live-every", type=int, default=1)
    pr.add_argument("--live-filmstrip", action="store_true",
                    help="keep one PNG per redraw instead of overwriting")
    pr.add_argument("--attenuation", type=float, default=0.0,
                    help="uniform known attenuation alpha [Np/m]")
    pr.add_argument("--full-precision", action="store_true",
                    help="disable the mixed-precision CG inner loop "
                         "(SolverConfig.fast_linesearch/fast_adjoint/"
                         "fast_forward). The port runs every solve in "
                         "FP32 either way today: the reduced-precision "
                         "tensor-core mode these flags select is not "
                         "written yet (ROADMAP.md B2), so this flag "
                         "changes nothing on the port")
    pr.set_defaults(fn=_cmd_run)

    ps = sub.add_parser("simulate", help="synthesize a ring dataset")
    ps.add_argument("out", help="output .mat path")
    ps.add_argument("--xmax", type=float, default=120e-3)
    ps.add_argument("--dx", type=float, default=0.3e-3)
    ps.add_argument("--elements", type=int, default=256)
    ps.add_argument("--radius", type=float, default=110e-3)
    ps.add_argument("--frequency", type=float, default=350e3)
    ps.add_argument("--seed", type=int, default=0)
    ps.set_defaults(fn=_cmd_simulate)

    pt = sub.add_parser("timedomain", help="time-domain wavefield demo")
    pt.add_argument("--xmax", type=float, default=120e-3)
    pt.add_argument("--dx", type=float, default=1.0e-3)
    pt.add_argument("--elements", type=int, default=256)
    pt.add_argument("--radius", type=float, default=110e-3)
    pt.add_argument("--element", type=int, default=64)
    pt.add_argument("--seed", type=int, default=0)
    pt.add_argument("--plot", default=None)
    pt.add_argument("--gif", default=None, metavar="OUT.gif",
                    help="write the animated wavefield playback (the "
                         "reference's live imagesc movie, "
                         "TimeDomainSimulation.m:58-91, as a file)")
    pt.set_defaults(fn=_cmd_timedomain)

    pbb = sub.add_parser(
        "broadband",
        help="time-domain acquisition -> frequency extraction -> "
             "multi-frequency FWI (full broadband workflow)")
    pbb.add_argument("--xmax", type=float, default=120e-3)
    pbb.add_argument("--fine-dx", type=float, default=0.6e-3,
                     help="synthesis grid spacing (anti inverse crime)")
    pbb.add_argument("--inv-dx", type=float, default=0.8e-3)
    pbb.add_argument("--elements", type=int, default=64)
    pbb.add_argument("--radius", type=float, default=110e-3)
    pbb.add_argument("--exclude", type=int, default=7,
                     help="receivers excluded each side of the transmitter")
    pbb.add_argument("--interpolation", choices=["nearest", "bilinear"],
                     default="nearest")
    pbb.add_argument("--f-low", type=float, default=0.15e6)
    pbb.add_argument("--f-high", type=float, default=0.35e6)
    pbb.add_argument("--df", type=float, default=0.025e6,
                     help="synthesis comb spacing")
    pbb.add_argument("--freqs", nargs="*", type=float, default=None,
                     help="inversion frequencies (default: band edges+center)")
    pbb.add_argument("--iterations", type=int, default=5,
                     help="CG iterations per continuation stage")
    pbb.add_argument("--c-init", type=float, default=1480.0)
    pbb.add_argument("--traveltime-init", action="store_true",
                     help="start the inversion from a straight-ray "
                          "travel-time tomogram picked off the gated "
                          "broadband traces (fwi.traveltime) instead of "
                          "the homogeneous --c-init — the cycle-skipping "
                          "defense at strong contrasts")
    pbb.add_argument("--traveltime-method", choices=("straight", "bent"),
                     default="straight",
                     help="tomography ray model for --traveltime-init: "
                          "linear straight rays, or eikonal bent (Fermat) "
                          "rays for contrasts above ~10%%")
    pbb.add_argument("--gate", nargs=3, type=float, default=(3e-6, 8e-6, 2e-6),
                     metavar=("PRE", "POST", "TAPER"),
                     help="direct-arrival gate window [s] around the "
                          "straight-ray arrival used for picking "
                          "(data.timedomain.direct_arrival_gate)")
    pbb.add_argument("--seed", type=int, default=0)
    pbb.add_argument("--plot", default=None)
    pbb.set_defaults(fn=_cmd_broadband)

    p3 = sub.add_parser(
        "broadband3d",
        help="volumetric broadband workflow: cylinder-array (tx, rx, t) "
             "synthesis -> optional travel-time starting volume -> "
             "multi-frequency 3D FWI")
    p3.add_argument("--xmax", type=float, default=24e-3)
    p3.add_argument("--dx", type=float, default=0.75e-3)
    p3.add_argument("--rings", type=int, default=3)
    p3.add_argument("--per-ring", type=int, default=16)
    p3.add_argument("--radius", type=float, default=18e-3)
    p3.add_argument("--z-span", type=float, default=12e-3)
    p3.add_argument("--min-angle", type=float, default=0.7,
                    help="tx-rx angular acceptance [rad] (the 3D analogue "
                         "of the 2D exclusion arc)")
    p3.add_argument("--l-pml", type=float, default=9e-3)
    p3.add_argument("--dv", type=float, default=90.0,
                    help="phantom blob amplitude [m/s]")
    p3.add_argument("--blob-radius", type=float, default=8e-3)
    p3.add_argument("--f-low", type=float, default=0.15e6)
    p3.add_argument("--f-high", type=float, default=0.40e6)
    p3.add_argument("--df", type=float, default=0.025e6)
    p3.add_argument("--freqs", nargs="*", type=float, default=None,
                    help="inversion frequencies (default: band "
                         "edges+center)")
    p3.add_argument("--iterations", type=int, default=4)
    p3.add_argument("--method", choices=("cg", "gn", "lbfgs"), default="cg")
    p3.add_argument("--c-init", type=float, default=1500.0)
    p3.add_argument("--traveltime-init", action="store_true",
                    help="start from a 3D travel-time tomogram picked off "
                         "the gated traces (fwi.traveltime3d)")
    p3.add_argument("--traveltime-method", choices=("straight", "bent"),
                    default="straight")
    p3.add_argument("--gate", nargs=3, type=float,
                    default=(3e-6, 8e-6, 2e-6), metavar=("PRE", "POST",
                                                         "TAPER"))
    p3.add_argument("--encode", type=int, default=None,
                    help="random source encoding: m supershots per "
                         "iteration (needs --min-angle 0; pair with "
                         "--scattered at weak contrast)")
    p3.add_argument("--scattered", action="store_true",
                    help="scattered-field misfit: subtract a homogeneous "
                         "--c-init background solve from both sides "
                         "(fwi3d.scattered_data_3d)")
    p3.add_argument("--chunk", type=int, default=None,
                    help="run the CG scan as k-iteration programs "
                         "(exact carry; for runtimes bounding per-program "
                         "device time)")
    p3.add_argument("--seed", type=int, default=0)
    p3.add_argument("--out", default=None, help=".npy velocity volume")
    p3.add_argument("--plot", default=None)
    p3.set_defaults(fn=_cmd_broadband3d)

    pb = sub.add_parser("bench", help="headline benchmark (JSON line)")
    pb.set_defaults(fn=_cmd_bench)

    pq = sub.add_parser(
        "qc", help="acquisition QC: reciprocity check, element-response "
                   "calibration, bad-channel screen (data.qc)")
    pq.add_argument("data", help=".mat file in the RecordedData schema")
    pq.add_argument("--exclude", type=int, default=0,
                    help="exclude +-K ring neighbors from the pair set")
    pq.add_argument("--residual-threshold", type=float, default=4.0,
                    help="flag channels above K x median residual")
    pq.add_argument("--energy-threshold", type=float, default=0.05,
                    help="flag channels below K x median row energy")
    pq.add_argument("--out", default=None,
                    help="write the reciprocity-compensated dataset (.mat)")
    pq.set_defaults(fn=_cmd_qc)

    for sp in sub.choices.values():
        sp.add_argument("--device", default=None,
                        help="torch device to run on (default: the CUDA "
                             "card; raises without one). 'cpu' runs the "
                             "plain PyTorch path")
    args = p.parse_args(argv)
    args.device = (torch.device(args.device) if args.device is not None
                   else default_device())
    args.fn(args)


if __name__ == "__main__":
    main()
