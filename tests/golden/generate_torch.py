"""Generate the JAX package's reference outputs that the PyTorch port's
tests hold their methods and solvers against:

    python tests/golden/generate_torch.py            # torch_methods.npz
    python tests/golden/generate_torch.py solvers    # torch_solvers.npz
    python tests/golden/generate_torch.py 3d         # torch_3d.npz
    python tests/golden/generate_torch.py traveltime # torch_traveltime.npz
    python tests/golden/generate_torch.py methods3d  # torch_methods3d.npz
    python tests/golden/generate_torch.py cli        # torch_cli.npz
    python tests/golden/generate_torch.py engines    # torch_engines.npz

Each of those JAX functions compiles for 5-20 s on one CPU core, which the
tests cannot afford one by one (each test module keeps one live JAX
comparison). The problems are small and seeded, and the tests import the
constants and the problem builders from this file.

torch_methods.npz (tests/test_torch_autodiff.py, test_torch_newton.py):
the 21x21 loss of tests/test_adjoint_vjp.py for the differentiable solve,
and a 41x41 ring of 8 elements over a blob (data synthesized here by the
JAX package at 250 and 300 kHz) for the inversions, 2-3 iterations each.

torch_solvers.npz (tests/test_torch_krylov.py, test_torch_born.py,
test_torch_timedomain.py): GMRES through the JAX package's split path (the
one the port follows), one- and two-level, on the 21x21 planes, and its
gradient; the Born solves and their gradients on tests/test_solvers.py's
61x61 blob; 2 CG iterations with GMRES and with Born on a 21x21 ring of 8
elements; and tests/test_timedomain.py's broadband chain.

torch_3d.npz (tests/test_torch_born3d.py, test_torch_fwi3d.py,
test_torch_timedomain3d.py): the volumetric path on a 15^3 grid (1.5 mm):
the 3D Born solves, GMRES and the plain series, forward, adjoint and lossy;
the 3D objective, the scattered-field data and 2-3 iterations of 3D CG
(the plain series, GMRES cold and warm, encoded, BB with the watchdog) on
an 8-element ring; the 3D broadband traces of an 8-element cylinder and a
two-stage invert_dataset_3d over them.

torch_traveltime.npz (tests/test_torch_traveltime.py,
test_torch_traveltime3d.py): eikonal fields, receiver times and bent rays
of a Gaussian blob on a 41^2 grid (0.8 mm) and a 15^3 grid (1 mm); the
straight and bent tomograms of a 12-element ring's (a 12-element
cylinder's) straight-ray times through it; traveltime_init over synthetic
traces whose envelopes peak at those times.

torch_methods3d.npz (tests/test_torch_methods3d.py): on main_3d's 15^3 blob
and ring, the gradient of fwi_loss_3d (lossless, and lossy in both fields)
at converged solves with a frozen shell, 2 iterations of 3D L-BFGS, one
Gauss-Newton iteration, one of the attenuation and joint inversions over
data with a Gaussian absorber, and the 3D background-speed calibration.

torch_cli.npz (tests/test_torch_cli.py): the JAX CLI at tests/test_misc.py's
tiny ring: simulate's dataset, the .mat exports of run (cg, gn,
--qc-compensate, alpha; 2 iterations) and qc's compensated data.

torch_engines.npz (tests/test_torch_engines.py): the twisted and
cyclic-reduction references of that file (factors, solves, the fused
twisted layout, the pivot and blocked inverses, solve_helmholtz and 3
frozen-factor CG iterations through each engine, and the tiny ring's data).
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from waveforminversionust_tpu import (AcquisitionConfig,  # noqa: E402
                                      ContinuationConfig, FWIConfig, Grid2D,
                                      PMLConfig, SolverConfig,
                                      solve_helmholtz)
from waveforminversionust_tpu.data.synthesize import \
    synthesize_ring_dataset  # noqa: E402
from waveforminversionust_tpu.fwi import (lbfgs, multifreq,  # noqa: E402
                                          newton, objective, resolution,
                                          runner)
from waveforminversionust_tpu.fwi.newton import \
    make_frechet_operators  # noqa: E402
from waveforminversionust_tpu.models.acquisition import \
    build_ring_acquisition  # noqa: E402
from waveforminversionust_tpu.models.phantom import \
    smooth_blob_phantom  # noqa: E402
from waveforminversionust_tpu.ops.solve import (  # noqa: E402
    helmholtz_operator_solve, make_helmholtz_operator)

OUT = os.path.join(os.path.dirname(__file__), "torch_methods.npz")
OUT_SOLVERS = os.path.join(os.path.dirname(__file__), "torch_solvers.npz")

# -- the differentiable solve (tests/test_adjoint_vjp.py::_small_problem) ----
SOLVE_F = 350e3
SOLVE_EXTENT, SOLVE_H = 8e-3, 0.8e-3
SOLVE_PML = dict(l_pml=2e-3)
SOLVE_REFINE = 2
ALPHA = 3.0  # Np/m, the lossy medium of the attenuation gradient


def solve_problem():
    """(vel, src, weight) of the 21x21 loss sum |u|^2 * weight."""
    grid = Grid2D.centered(SOLVE_EXTENT, SOLVE_H)
    vel = np.asarray(smooth_blob_phantom(grid, radius=3e-3, dc=60),
                     np.float32)
    ny, nx = grid.shape
    src = np.zeros((2, ny, nx), np.complex64)
    src[0, ny // 2, nx // 2 + 3] = 1.0
    src[1, ny // 2 - 2, nx // 2] = 0.5 - 0.25j
    weight = 1.0 + 0.3 * np.cos(np.arange(src.size, dtype=np.float32)
                                ).reshape(src.shape)
    return vel, src, weight


# -- the ring of the inversions ---------------------------------------------
EXTENT, H = 16e-3, 0.8e-3
FREQS = (250e3, 300e3)      # the single-frequency paths run at FREQS[1]
PML = dict(l_pml=3.2e-3)
ACQ = dict(num_elements=8, radius=12e-3, num_excluded_each_side=1)
C_INIT = 1480.0
ITERS = 2                   # L-BFGS and GN outer iterations
MF_ITERS = 3                # joint multi-frequency iterations
CG_ITERS = 4                # GN inner iterations
# A clip box 100 m/s below the start: every GN trial lands there, far
# worse than the start, so each step is halved 4 times and rejected.
CLIP_ALL = (C_INIT - 100.0, C_INIT - 99.0)
SLOW_AT = 1.0 / 1490.0       # where fwi_loss and the Frechet pair are taken
PROBE_PIXELS = ((20, 20), (15, 25))
N_HUTCHINSON = 3


def probes(shape):
    p = np.zeros((len(PROBE_PIXELS),) + tuple(shape), np.float32)
    for i, (y, x) in enumerate(PROBE_PIXELS):
        p[i, y, x] = 1.0
    return p


def frechet_inputs(shape, rec_shape):
    """Seeded model perturbation dm and receiver residual r."""
    rng = np.random.default_rng(5)
    dm = rng.standard_normal(shape).astype(np.float32)
    r = (rng.standard_normal(rec_shape)
         + 1j * rng.standard_normal(rec_shape)).astype(np.complex64)
    return dm, r


def _ring():
    grid = Grid2D.centered(EXTENT, H)
    vel = smooth_blob_phantom(grid, radius=6e-3, dc=40, c_bkgnd=1500.0)
    solver = SolverConfig(pml=PMLConfig(**PML))
    dss = {f: synthesize_ring_dataset(vel, grid, AcquisitionConfig(**ACQ),
                                      f=f, seed=3, solver=solver)
           for f in FREQS}
    ds = dss[FREQS[1]]
    acq = build_ring_acquisition(grid, AcquisitionConfig(**ACQ),
                                 x_elem=ds.x_circ, y_elem=ds.y_circ)
    datas = {f: objective.build_fwi_data(acq, dss[f].rec_data, f)
             for f in FREQS}
    return grid, solver, dss, datas


def main():
    out = {}
    vel, src, weight = solve_problem()
    sgrid = Grid2D.centered(SOLVE_EXTENT, SOLVE_H)
    scfg = SolverConfig(refine=SOLVE_REFINE, pml=PMLConfig(**SOLVE_PML))
    alpha = np.full(vel.shape, ALPHA, np.float32)
    for adjoint in (False, True):
        def loss(v, s, a=None):
            u, _ = solve_helmholtz(v, s, SOLVE_F, sgrid, scfg,
                                   adjoint=adjoint, attenuation=a)
            return jnp.sum(jnp.abs(u) ** 2 * weight)

        # Eager, as tests/test_adjoint_vjp.py takes it: under jax.jit the
        # src gradient sits 1.4e-4 from a complex128 solve of the same
        # planes (eager 3.2e-5).
        k = int(adjoint)
        gv, gs = jax.grad(loss, argnums=(0, 1))(vel, src)
        lv, la = jax.grad(loss, argnums=(0, 2))(vel, src, alpha)
        out.update({f"solve_gv_{k}": gv, f"solve_gs_{k}": gs,
                    f"lossy_gv_{k}": lv, f"lossy_ga_{k}": la})

    grid, solver, dss, datas = _ring()
    ds, data = dss[FREQS[1]], datas[FREQS[1]]
    for f in FREQS:
        out[f"rec_{int(f)}"] = dss[f].rec_data
    out.update(x=ds.x, y=ds.y, c=ds.c, x_circ=ds.x_circ, y_circ=ds.y_circ)
    vel0 = jnp.full(grid.shape, C_INIT, jnp.float32)
    acq = AcquisitionConfig(**ACQ)
    fwi = FWIConfig(num_iterations=ITERS, c_init=C_INIT)

    slow = jnp.full(grid.ny * grid.nx, SLOW_AT, jnp.float32)
    out["fwi_loss"], out["fwi_loss_grad"] = jax.jit(
        jax.value_and_grad(lbfgs.fwi_loss), static_argnums=(2, 3))(
            slow, data, grid, solver)

    res = runner.invert_dataset(ds, grid=grid, acquisition=acq, solver=solver,
                                fwi=fwi, method="lbfgs")
    out.update(runner_lbfgs_loss=res.metrics["loss"],
               runner_lbfgs_velocity=res.velocity)
    res = lbfgs.run_lbfgs(vel0, data, grid, solver, num_iterations=ITERS,
                          fwi=fwi)
    out.update(lbfgs_loss=res.loss_history, lbfgs_velocity=res.velocity)
    res = lbfgs.run_lbfgs_attenuation(vel0, jnp.zeros(grid.shape), data,
                                      grid, solver, num_iterations=ITERS,
                                      invert_velocity=True)
    out.update(att_loss=res.loss_history, att_velocity=res.velocity,
               att_alpha=res.attenuation)

    slow2 = 1.0 / jnp.full(grid.shape, 1.0 / SLOW_AT, jnp.float32)
    op = make_helmholtz_operator(1.0 / slow2, data.f, grid, solver)
    wv = helmholtz_operator_solve(op, data.src, grid, solver)
    dm, r = frechet_inputs(grid.shape, data.rec_obs.shape)
    for exact in (True, False):
        jv, jt, _ = make_frechet_operators(op, data, grid, solver, slow2, wv,
                                           exact=exact)
        out[f"jv_{int(exact)}"] = jv(jnp.asarray(dm))
        out[f"jt_{int(exact)}"] = jt(jnp.asarray(r))

    for name, fw in (("gn", fwi),
                     ("gn_clip", FWIConfig(num_iterations=ITERS,
                                           c_init=C_INIT,
                                           clip_velocity=CLIP_ALL))):
        res = newton.run_gauss_newton(vel0, data, grid, solver, fwi=fw,
                                      num_iterations=ITERS,
                                      cg_iters=CG_ITERS)
        out[f"{name}_velocity"] = res.velocity
        for field in newton.GNMetrics._fields:
            out[f"{name}_{field}"] = getattr(res.metrics, field)
    res = runner.invert_dataset(ds, grid=grid, acquisition=acq, solver=solver,
                                fwi=fwi, method="gn")
    out.update(runner_gn_loss=res.metrics["loss"],
               runner_gn_velocity=res.velocity)

    vel_at = jnp.full(grid.shape, 1.0 / SLOW_AT, jnp.float32)
    out["psf"] = resolution.psf_probe(vel_at, data, grid, solver,
                                      probes=jnp.asarray(probes(grid.shape)),
                                      cg_iters=CG_ITERS)
    out["hdiag"] = resolution.hessian_diag_probe(vel_at, data, grid, solver,
                                                 num_probes=N_HUTCHINSON)

    mf = multifreq.stack_frequencies([datas[f] for f in FREQS])
    for name, fw in (("mf", FWIConfig(num_iterations=MF_ITERS)),
                     ("mf_reg", FWIConfig(num_iterations=MF_ITERS,
                                          precondition="illumination",
                                          reg_tikhonov=0.1))):
        v, m = multifreq.nonlinear_cg_multifreq(vel0, mf, grid, solver, fw)
        out[f"{name}_velocity"] = v
        for field in m._fields:
            out[f"{name}_{field}"] = getattr(m, field)
    res = runner.invert_dataset(dss, grid=grid, acquisition=acq,
                                solver=solver,
                                fwi=FWIConfig(num_iterations=MF_ITERS,
                                              c_init=C_INIT),
                                method="joint-multifreq")
    out.update(runner_mf_loss=res.metrics["loss"],
               runner_mf_velocity=res.velocity,
               runner_mf_frequencies=np.asarray(res.frequencies))
    np.savez_compressed(OUT, **{k: np.asarray(v) for k, v in out.items()})
    print(f"wrote {OUT}: {len(out)} arrays")


# -- the iterative solvers (torch_solvers.npz) -------------------------------
GMRES_TOL, GMRES_MAXITER = 1e-5, 4000      # tests/test_solvers.py:264
GRAD_TOL, GRAD_MAXITER = 1e-7, 6000        # tests/test_solvers.py:327
BORN_EXTENT = 24e-3                         # tests/test_solvers.py::_problem
ALPHA_BORN = 3.0
# The 21x21 ring of the CG comparisons: small enough that every GMRES solve
# converges within its cap at the tolerance below, where the CG trajectory
# no longer moves with the last digits of the solves.
KRING_EXTENT, KRING_PML, KRING_F = 8e-3, 2e-3, 300e3
KRING_ACQ = dict(num_elements=8, radius=5e-3, num_excluded_each_side=1)
KRING_TOL, KRING_MAXITER = 1e-6, 4000
# tests/test_timedomain.py::TestTimeDomainAcquisition
TD_ACQ = dict(num_elements=32, radius=18e-3, num_excluded_each_side=5)
TD_PML = dict(l_pml=4e-3)
TD_BAND = dict(f_low=0.12e6, f_high=0.2e6, df=0.04e6)
TD_FREQS = (0.12e6, 0.2e6)
TD_SEED = 3


def born_problem():
    """(vel, src) of tests/test_solvers.py::_problem: 61x61, 2 sources."""
    grid = Grid2D.centered(BORN_EXTENT, 0.8e-3)
    vel = np.asarray(smooth_blob_phantom(grid, radius=8e-3, dc=60),
                     np.float32)
    ny, nx = grid.shape
    src = np.zeros((2, ny, nx), np.complex64)
    src[0, ny // 2, nx // 2] = 1.0
    src[1, ny // 3, 2 * nx // 3] = 1.0 + 0.5j
    return vel, src


def kring_velocity(grid):
    return smooth_blob_phantom(grid, radius=3.2e-3, dc=40, c_bkgnd=1500.0)


def td_grids():
    """(coarse 61x61, fine 121x121, snapped element x, y)."""
    from waveforminversionust_tpu.models.acquisition import (ring_positions,
                                                             snap_to_grid)
    coarse = Grid2D.centered(24e-3, 0.8e-3)
    xi, yi = snap_to_grid(coarse, *ring_positions(TD_ACQ["num_elements"],
                                                  TD_ACQ["radius"]))
    fine = Grid2D.centered(24e-3, 0.4e-3)
    return coarse, fine, coarse.x[xi], coarse.y[yi]


def main_solvers():
    import dataclasses

    from waveforminversionust_tpu import SolverMethod
    from waveforminversionust_tpu.data import timedomain
    from waveforminversionust_tpu.ops import born, cpx

    out = {}
    vel, src, weight = solve_problem()
    grid = Grid2D.centered(SOLVE_EXTENT, SOLVE_H)
    for two in (False, True):
        cfg = SolverConfig(method=SolverMethod.GMRES, tol=GMRES_TOL,
                           maxiter=GMRES_MAXITER, split_complex=True,
                           gmres_two_level=two, pml=PMLConfig(**SOLVE_PML))
        op = make_helmholtz_operator(vel, SOLVE_F, grid, cfg)
        for adjoint in (False, True):
            out[f"gmres_op_{int(two)}_{int(adjoint)}"] = cpx.to_numpy(
                helmholtz_operator_solve(op, src, grid, cfg, adjoint=adjoint))
    cfg = SolverConfig(method=SolverMethod.GMRES, tol=GRAD_TOL,
                       maxiter=GRAD_MAXITER, split_complex=True,
                       pml=PMLConfig(**SOLVE_PML))

    def gloss(v):
        u, _ = solve_helmholtz(v, src, SOLVE_F, grid, cfg)
        return jnp.sum(cpx.abs2(u) * weight)

    out["gmres_gv"] = jax.grad(gloss)(vel)

    bvel, bsrc = born_problem()
    bgrid = Grid2D.centered(BORN_EXTENT, 0.8e-3)
    bcfg = SolverConfig(method=SolverMethod.BORN)
    alpha = np.full(bvel.shape, ALPHA_BORN, np.float32)
    bweight = 1.0 + 0.3 * np.cos(np.arange(bsrc.size, dtype=np.float32)
                                 ).reshape(bsrc.shape)
    for adjoint in (False, True):
        k = int(adjoint)
        for lossy, att in ((0, None), (1, alpha)):
            u, n = born.born_gmres_solve(bvel, bsrc, SOLVE_F, bgrid,
                                         bcfg.born_pml, adjoint=adjoint,
                                         attenuation=att)
            out[f"born_gmres_{k}_{lossy}"] = u
            out[f"born_gmres_n_{k}_{lossy}"] = n
        u, n = born.born_series_solve(bvel, bsrc, SOLVE_F, bgrid,
                                      bcfg.born_pml, adjoint=adjoint)
        out[f"born_series_{k}"], out[f"born_series_n_{k}"] = u, n

        def bloss(v, s, a=None):
            u, _ = solve_helmholtz(v, s, SOLVE_F, bgrid, bcfg,
                                   adjoint=adjoint, attenuation=a)
            return jnp.sum(jnp.abs(u) ** 2 * bweight)

        gv, gs = jax.grad(bloss, argnums=(0, 1))(bvel, bsrc)
        lv, la = jax.grad(bloss, argnums=(0, 2))(bvel, bsrc, alpha)
        out.update({f"born_gv_{k}": gv, f"born_gs_{k}": gs,
                    f"born_lossy_gv_{k}": lv, f"born_lossy_ga_{k}": la})

    kgrid = Grid2D.centered(KRING_EXTENT, H)
    ksolver = SolverConfig(pml=PMLConfig(l_pml=KRING_PML))
    ds = synthesize_ring_dataset(kring_velocity(kgrid), kgrid,
                                 AcquisitionConfig(**KRING_ACQ), f=KRING_F,
                                 seed=3, solver=ksolver)
    out.update(kring_rec=ds.rec_data, kring_x_circ=ds.x_circ,
               kring_y_circ=ds.y_circ, kring_c=ds.c)
    for name, method, extra in (
            ("cg_gmres", SolverMethod.GMRES,
             dict(tol=KRING_TOL, maxiter=KRING_MAXITER)),
            ("cg_born", SolverMethod.BORN, {})):
        res = runner.invert_dataset(
            ds, grid=kgrid, acquisition=AcquisitionConfig(**KRING_ACQ),
            solver=dataclasses.replace(ksolver, method=method, **extra),
            fwi=FWIConfig(num_iterations=2))
        out.update({f"{name}_loss": res.metrics["loss"],
                    f"{name}_step": res.metrics["step_size"],
                    f"{name}_velocity": res.velocity})

    coarse, fine, xs, ys = td_grids()
    tsolver = SolverConfig(pml=PMLConfig(**TD_PML))
    td = timedomain.synthesize_time_domain_dataset(
        smooth_blob_phantom(fine, radius=8e-3, dc=30), fine,
        AcquisitionConfig(**TD_ACQ), solver=tsolver, seed=TD_SEED,
        x_elem=xs, y_elem=ys, **TD_BAND)
    res = runner.invert_dataset(
        timedomain.timedomain_to_ring_datasets(td, TD_FREQS,
                                               deconvolve=False),
        grid=coarse, acquisition=AcquisitionConfig(**TD_ACQ),
        solver=tsolver, fwi=FWIConfig(c_init=1500.0),
        continuation=ContinuationConfig(frequencies=TD_FREQS,
                                        iterations_per_frequency=2))
    out.update(td_traces=td.traces, td_loss=res.metrics["loss"],
               td_step=res.metrics["step_size"], td_velocity=res.velocity)
    np.savez_compressed(OUT_SOLVERS,
                        **{k: np.asarray(v) for k, v in out.items()})
    print(f"wrote {OUT_SOLVERS}: {len(out)} arrays")


# -- the 3D path (torch_3d.npz) ------------------------------------------------
OUT_3D = os.path.join(os.path.dirname(__file__), "torch_3d.npz")
# 15^3: a smooth FFT length (a 17-point FFT, prime, costs ~10x as much
# a voxel on the CPU).
G3_EXTENT, G3_H = 10.5e-3, 1.5e-3             # 15^3
F3, C3 = 200e3, 1500.0
PML3 = dict(a0=20.0, l_pml=4.5e-3)
ALPHA3 = 3.0                                  # Np/m, the lossy cases
B3_TOL, B3_MAXITER, B3_RESTART = 1e-6, 600, 8  # the single solves
B3_SERIES_CAP = 2000
RING3 = dict(n_rings=1, n_per_ring=8, radius=6e-3, z_span=0.0)
MIN_ANGLE3 = 0.8
SRC_SCALE3 = 1e6        # keeps |rhs|^2 in FP32's normal range (bench.py)
CG3_CAP, CG3_TOL = 500, 1e-4
# The objective is taken at the inversions' default start (FWIConfig.c_init)
# rather than at C3, where the residual is 9% of the gathers and its float32
# rounding, amplified ~20x, would be all the misfit's last digits carry.
OBJ3_C = 1480.0
CG3_CLIP = (C3 - 100.0, C3 + 100.0)
ENC3_M, ENC3_SEED = 2, 5
TD3_POS = dict(n_rings=2, n_per_ring=4, radius=6e-3, z_span=6e-3)
TD3_BAND = dict(f_low=0.2e6, f_high=0.3e6, df=0.05e6)
TD3_SEED = 3
TD3_FREQS = (0.2e6, 0.3e6)
TD3_CAP, TD3_ITERS = 400, 2


def blob3d(grid, dc=40.0, radius=4e-3):
    """The 3D tests' Gaussian blob on C3 (tests/test_fwi3d.py::_blob);
    either package's Grid3D."""
    Z, Y, X = grid.meshgrid()
    return (C3 + dc * np.exp(-(X ** 2 + Y ** 2 + Z ** 2) / radius ** 2)
            ).astype(np.float32)


def born3d_sources(shape):
    """Two seeded random complex sources (2,) + shape."""
    rng = np.random.default_rng(11)
    return (rng.standard_normal((2,) + tuple(shape))
            + 1j * rng.standard_normal((2,) + tuple(shape))
            ).astype(np.complex64)


def main_3d():
    from waveforminversionust_tpu import StepSizeFormula
    from waveforminversionust_tpu.data import timedomain3d
    from waveforminversionust_tpu.fwi import fwi3d, runner3d
    from waveforminversionust_tpu.models import acquisition3d
    from waveforminversionust_tpu.models.grid3d import Grid3D
    from waveforminversionust_tpu.ops import born3d, cpx

    out = {}
    grid = Grid3D.centered(G3_EXTENT, G3_H)
    pml = PMLConfig(**PML3)
    vel = blob3d(grid)
    alpha = np.full(grid.shape, ALPHA3, np.float32)
    src = born3d_sources(grid.shape)
    for adjoint in (False, True):
        for lossy in (False, True):
            key = f"{int(adjoint)}_{int(lossy)}"
            u, n = born3d.born_gmres_solve_3d(
                vel, cpx.of(src), F3, grid, pml, adjoint=adjoint,
                tol=B3_TOL, maxiter=B3_MAXITER, restart=B3_RESTART,
                attenuation=alpha if lossy else None)
            out[f"b3_gmres_{key}"] = cpx.to_numpy(u)
            out[f"b3_gmres_n_{key}"] = int(n)
        u, n = born3d.born_series_solve_3d(vel, cpx.of(src), F3, grid, pml,
                                           adjoint=adjoint,
                                           iter_cap=B3_SERIES_CAP)
        out[f"b3_series_{int(adjoint)}"] = cpx.to_numpy(u)
        out[f"b3_series_n_{int(adjoint)}"] = int(n)

    def dataset(min_angle):
        pos = acquisition3d.cylinder_positions(**RING3)
        acq = acquisition3d.build_acquisition3d(grid, pos,
                                                min_angle=min_angle)
        s = cpx.scale(acquisition3d.source_fields_3d(acq, grid), SRC_SCALE3)
        wv, _ = born3d.born_series_solve_3d(vel, s, F3, grid, pml,
                                            iter_cap=CG3_CAP)
        rec = fwi3d.sample_receivers_3d(wv, jnp.asarray(acq.rx_idx))
        return fwi3d.build_fwi_data_3d(acq, rec, F3, grid)._replace(src=s)

    data, full = dataset(MIN_ANGLE3), dataset(0.0)
    out.update(f3_rec=cpx.to_numpy(data.rec_obs),
               f3_rec_full=cpx.to_numpy(full.rec_obs))
    lossy = data._replace(attenuation=jnp.asarray(alpha))
    vobj = jnp.full(grid.shape, OBJ3_C, jnp.float32)
    loss, grad, _, _ = fwi3d.objective_pieces_3d(
        vobj, 1.0 / vobj, lossy, grid, pml, CG3_CAP)
    vel0 = jnp.full(grid.shape, C3, jnp.float32)
    out.update(f3_obj_loss=loss, f3_obj_grad=grad)
    scat = fwi3d.scattered_data_3d(data, grid, c_ref=C3, pml=pml)
    out.update(f3_scat_rec=cpx.to_numpy(scat.rec_obs),
               f3_scat_ref=cpx.to_numpy(scat.rec_ref))
    base = dict(clip_velocity=CG3_CLIP)
    bb = FWIConfig(num_iterations=3, step_size=StepSizeFormula.BB,
                   reject_increase=1.5, **base)
    for name, d, fwi, kw in (
            ("cbs", data, FWIConfig(**base), {}),
            ("gmres", data, FWIConfig(**base),
             dict(solver3d="gmres", warm_start=False)),
            ("warm", data, FWIConfig(**base),
             dict(solver3d="gmres", warm_start=True)),
            ("enc", full, FWIConfig(**base),
             dict(encode=ENC3_M, encode_seed=ENC3_SEED)),
            ("bb", data, bb, dict(solver3d="gmres", warm_start=True))):
        v, m = fwi3d.nonlinear_cg_3d(
            vel0, d, grid, fwi, num_iterations=fwi.num_iterations
            if name == "bb" else 2, pml=pml, iter_cap=CG3_CAP,
            gmres_tol=CG3_TOL, **kw)
        out.update({f"f3_{name}_loss": m.loss, f"f3_{name}_step": m.step_size,
                    f"f3_{name}_velocity": v})

    pos = acquisition3d.cylinder_positions(**TD3_POS)
    td = timedomain3d.synthesize_time_domain_dataset_3d(
        vel, grid, pos, pml=pml, seed=TD3_SEED, **TD3_BAND)
    _, datasets = timedomain3d.timedomain_to_fwi_data_3d(
        td, TD3_FREQS, grid, min_angle=MIN_ANGLE3)
    res = runner3d.invert_dataset_3d(
        datasets, grid, FWIConfig(),
        continuation=ContinuationConfig(frequencies=TD3_FREQS,
                                        iterations_per_frequency=TD3_ITERS),
        pml=pml, solver3d="cbs", iter_cap=TD3_CAP)
    out.update(td3_traces=td.traces, td3_loss=res.metrics["loss"],
               td3_velocity=res.velocity)
    np.savez_compressed(OUT_3D, **{k: np.asarray(v) for k, v in out.items()})
    print(f"wrote {OUT_3D}: {len(out)} arrays")


OUT_TT = os.path.join(os.path.dirname(__file__), "torch_traveltime.npz")
TT_EXTENT, TT_H = 16e-3, 0.8e-3               # 41^2
TT3_EXTENT, TT3_H = 7e-3, 1e-3                # 15^3
TT_C, TT_DV = 1500.0, 60.0                    # the blob's background, peak
TT_SRC = ((-12e-3, 3e-3), (10e-3, -9e-3), (0.0, 14e-3))
TT3_SRC = ((-6e-3, 2e-3, 1e-3), (5e-3, -5e-3, -3e-3))
TT_RING = dict(n=12, radius=14e-3)            # the tomography's ring
TT_EXCLUDE = 2                                # elements excluded each side
TT3_POS = dict(n_rings=2, n_per_ring=6, radius=6e-3, z_span=4e-3)
TT3_MIN_ANGLE = 0.5
TT_STEPS, TT_SAMPLES = 120, 32                # trace_rays on the 41^2 grid
TT3_STEPS, TT3_SAMPLES = 60, 16
TT_DF, TT_NT, TT_SIGMA = 25e3, 256, 0.4e-6    # the synthetic traces
TT_LAM = 1.0                                  # invert_travel_times' default
TT_OUTER = 2                                  # bent-ray passes


def tt_blob(grid, radius=5e-3):
    """The travel-time tests' Gaussian blob of TT_DV on TT_C (either
    package's Grid2D or Grid3D)."""
    r2 = sum(c ** 2 for c in grid.meshgrid())
    return (TT_C + TT_DV * np.exp(-r2 / radius ** 2)).astype(np.float32)


def tt_ring():
    ang = 2 * np.pi * np.arange(TT_RING["n"]) / TT_RING["n"]
    return TT_RING["radius"] * np.stack([np.cos(ang), np.sin(ang)], 1)


def tt_pairs(n, exclude):
    """(tx, rx) element indices of the ring pairs at least ``exclude`` + 1
    elements apart (the acceptance mask's pairs)."""
    d = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
    return np.nonzero(np.minimum(d, n - d) > exclude)


def tt_traces(t_arr, times):
    """Complex analytic traces whose envelope peaks at ``t_arr`` on the
    circular time axis of one comb period: a Gaussian envelope of width
    TT_SIGMA under a 200 kHz carrier."""
    period = 1.0 / TT_DF
    d = np.mod(times - t_arr[..., None] + 0.5 * period, period) - 0.5 * period
    return (np.exp(-(d / TT_SIGMA) ** 2) * np.exp(2j * np.pi * 2e5 * d)
            ).astype(np.complex64)


def tt_snap(coords, values):
    """Nearest grid coordinate of each value."""
    return coords[np.argmin(np.abs(coords[None, :] - values[:, None]), axis=1)]


def main_traveltime():
    from waveforminversionust_tpu.fwi import (eikonal, eikonal3d, traveltime,
                                              traveltime3d)
    from waveforminversionust_tpu.models.grid3d import Grid3D

    out = {}
    grid = Grid2D.centered(TT_EXTENT, TT_H)
    slow = 1.0 / tt_blob(grid)
    src = np.asarray(TT_SRC, np.float32)
    t = eikonal.eikonal_solve_batch(slow, src, grid)
    rng = np.random.default_rng(5)
    rx = rng.uniform(-14e-3, 14e-3, (6, 2)).astype(np.float32)
    si = np.arange(6, dtype=np.int32) % len(src)
    pts, lengths = eikonal.trace_rays(t, si, src[si], rx, grid,
                                      n_steps=TT_STEPS, step=0.5 * TT_H,
                                      n_samples=TT_SAMPLES)
    out.update(tt_eik=t, tt_eik_rx=rx,
               tt_eik_times=eikonal.eikonal_receiver_times(t, si, rx, grid),
               tt_pts=pts, tt_lengths=lengths)
    # the snapped ring, exact straight-ray times through the blob, and
    # traces peaking at them
    pos = tt_ring()
    pos = np.stack([tt_snap(grid.x, pos[:, 0]), tt_snap(grid.y, pos[:, 1])], 1)
    ti, ri = tt_pairs(TT_RING["n"], TT_EXCLUDE)
    t_obs = np.asarray(traveltime.straight_ray_times(slow, pos[ti], pos[ri],
                                                     grid))
    for name, fn in (("straight", traveltime.invert_travel_times),
                     ("bent", traveltime.invert_travel_times_bent)):
        kw = dict(n_outer=TT_OUTER) if name == "bent" else {}
        v, r = fn(t_obs, pos[ti], pos[ri], grid, c_ref=TT_C,
                  lam_smooth=TT_LAM, **kw)
        out.update({f"tt_{name}": v, f"tt_{name}_relres": r})
    times = np.arange(TT_NT) / (TT_NT * TT_DF)
    t_all = np.zeros((TT_RING["n"], TT_RING["n"]))
    t_all[ti, ri] = t_obs
    out.update(tt_traces=tt_traces(t_all, times), tt_times=times)
    td = _tt_dataset(grid, pos, out["tt_traces"], times)
    for method in ("straight", "bent"):
        out[f"tt_init_{method}"] = traveltime.traveltime_init(
            td, grid, num_excluded_each_side=TT_EXCLUDE, c_ref=TT_C,
            method=method, n_outer=TT_OUTER)

    grid3 = Grid3D.centered(TT3_EXTENT, TT3_H)
    slow3 = 1.0 / tt_blob(grid3, radius=3e-3)
    src3 = np.asarray(TT3_SRC, np.float32)
    t3 = eikonal3d.eikonal_solve_batch_3d(slow3, src3, grid3)
    rx3 = rng.uniform(-6e-3, 6e-3, (4, 3)).astype(np.float32)
    si3 = np.arange(4, dtype=np.int32) % len(src3)
    pts3, lengths3 = eikonal3d.trace_rays_3d(
        t3, si3, src3[si3], rx3, grid3, n_steps=TT3_STEPS, step=0.5 * TT3_H,
        n_samples=TT3_SAMPLES)
    out.update(tt3_eik=t3, tt3_eik_rx=rx3,
               tt3_eik_times=eikonal3d.eikonal_receiver_times_3d(t3, si3, rx3,
                                                                 grid3),
               tt3_pts=pts3, tt3_lengths=lengths3)
    from waveforminversionust_tpu.models import acquisition3d
    pos3 = acquisition3d.cylinder_positions(**TT3_POS)
    snapped = np.stack([tt_snap(grid3.x, pos3[:, 0]),
                        tt_snap(grid3.y, pos3[:, 1]),
                        tt_snap(grid3.z, pos3[:, 2])], 1)
    acq3 = acquisition3d.build_acquisition3d(grid3, pos3,
                                             min_angle=TT3_MIN_ANGLE)
    n3, n_act = np.asarray(acq3.rx_elem).shape
    tx_e = np.repeat(np.arange(n3), n_act)
    rx_e = np.asarray(acq3.rx_elem).ravel()
    t_obs3 = np.asarray(traveltime3d.straight_ray_times_3d(
        slow3, snapped[tx_e], snapped[rx_e], grid3))
    for name, fn in (("straight", traveltime3d.invert_travel_times_3d),
                     ("bent", traveltime3d.invert_travel_times_bent_3d)):
        kw = dict(n_outer=TT_OUTER) if name == "bent" else {}
        v, r = fn(t_obs3, snapped[tx_e], snapped[rx_e], grid3, c_ref=TT_C,
                  lam_smooth=TT_LAM, **kw)
        out.update({f"tt3_{name}": v, f"tt3_{name}_relres": r})
    t_all3 = np.zeros((n3, n3))
    t_all3[tx_e, rx_e] = t_obs3
    out.update(tt3_traces=tt_traces(t_all3, times))
    td3 = _tt_dataset_3d(grid3, pos3, snapped, out["tt3_traces"], times)
    for method in ("straight", "bent"):
        out[f"tt3_init_{method}"] = traveltime3d.traveltime_init_3d(
            td3, grid3, min_angle=TT3_MIN_ANGLE, c_ref=TT_C, method=method,
            n_outer=TT_OUTER)
    np.savez_compressed(OUT_TT, **{k: np.asarray(v) for k, v in out.items()})
    print(f"wrote {OUT_TT}: {len(out)} arrays")


def _tt_dataset(grid, pos, traces, times, cls=None):
    """A TimeDomainDataset (either package's ``cls``) over the synthetic
    traces; only its geometry, comb period and traces are read."""
    if cls is None:
        from waveforminversionust_tpu.data.timedomain import \
            TimeDomainDataset as cls
    nf = 3
    return cls(x=np.asarray(grid.x), y=np.asarray(grid.y),
               c=tt_blob(grid), x_circ=pos[:, 0], y_circ=pos[:, 1],
               freqs=TT_DF * np.arange(1, nf + 1), df=TT_DF,
               spectrum=np.ones(nf), times=times, traces=traces)


def _tt_dataset_3d(grid, pos, snapped, traces, times, cls=None):
    """The 3D counterpart of :func:`_tt_dataset`."""
    if cls is None:
        from waveforminversionust_tpu.data.timedomain3d import \
            TimeDomainDataset3D as cls
    nf = 3
    return cls(c=tt_blob(grid, radius=3e-3), positions=pos,
               positions_snapped=snapped,
               freqs=TT_DF * np.arange(1, nf + 1), df=TT_DF,
               spectrum=np.ones(nf), times=times, traces=traces)


OUT_M3 = os.path.join(os.path.dirname(__file__), "torch_methods3d.npz")
M3_C = OBJ3_C                   # the gradient's point and the starts
M3_GRAD = dict(iter_cap=2000, use_gmres=True, tol=1e-5, restart=16,
               estimate_sources=False)
M3_ALPHA0 = 10.0                # Np/m, the lossy gradient's point
M3_ABSORBER = (40.0, 3e-3)      # peak [Np/m] and radius of the absorber
M3_ITERS = 2                    # L-BFGS iterations (GMRES tol CG3_TOL)
M3_ATT_ITERS = 1                # alpha and joint iterations
M3_TOL = 2e-3                   # GN's, alpha's and joint's GMRES tolerance
M3_GN = dict(num_iterations=1, cg_iters=2)
M3_ATT = dict(estimate_sources=False, alpha_scale=40.0)
M3_CAL = dict(gmres_tol=1e-5, c_min=1440.0, c_max=1560.0, num=4, levels=1)


def m3_absorber(grid):
    r2 = sum(c ** 2 for c in grid.meshgrid())
    return (M3_ABSORBER[0] * np.exp(-r2 / M3_ABSORBER[1] ** 2)
            ).astype(np.float32)


def main_methods3d():
    """torch_methods3d.npz: the 3D methods on the 15^3 blob of main_3d."""
    from waveforminversionust_tpu.fwi import calibrate, fwi3d, lbfgs, newton
    from waveforminversionust_tpu.models import acquisition3d
    from waveforminversionust_tpu.models.grid3d import Grid3D
    from waveforminversionust_tpu.ops import born3d, cpx

    out = {}
    grid = Grid3D.centered(G3_EXTENT, G3_H)
    pml = PMLConfig(**PML3)
    vel = blob3d(grid)
    pos = acquisition3d.cylinder_positions(**RING3)
    acq = acquisition3d.build_acquisition3d(grid, pos, min_angle=MIN_ANGLE3)
    s = cpx.scale(acquisition3d.source_fields_3d(acq, grid), SRC_SCALE3)

    def dataset(alpha=None):
        wv, _ = born3d.born_series_solve_3d(vel, s, F3, grid, pml,
                                            iter_cap=CG3_CAP,
                                            attenuation=alpha)
        rec = fwi3d.sample_receivers_3d(wv, jnp.asarray(acq.rx_idx))
        return fwi3d.build_fwi_data_3d(acq, rec, F3, grid)._replace(src=s)

    data, lossy = dataset(), dataset(jnp.asarray(m3_absorber(grid)))
    out.update(m3_rec=cpx.to_numpy(data.rec_obs),
               m3_lossy_rec=cpx.to_numpy(lossy.rec_obs))
    n = grid.nx * grid.ny * grid.nz
    slow = jnp.full((n,), 1.0 / M3_C, jnp.float32)
    k0 = 2.0 * np.pi * F3 / M3_C

    def loss_fn(sl, a):
        return lbfgs.fwi_loss_3d(sl, data._replace(attenuation=a), grid, pml,
                                 shell_k0=k0, **M3_GRAD)

    out["m3_grad"] = jax.grad(loss_fn)(slow, None)
    gs, ga = jax.grad(loss_fn, argnums=(0, 1))(
        slow, jnp.full(grid.shape, M3_ALPHA0, jnp.float32))
    out.update(m3_grad_lossy=gs, m3_grad_alpha=ga)

    vel0 = np.full(grid.shape, M3_C, np.float32)
    res = lbfgs.run_lbfgs_3d(vel0, data, grid, pml, iter_cap=CG3_CAP,
                             tol=CG3_TOL, num_iterations=M3_ITERS)
    out.update(m3_lbfgs_loss=res.loss_history, m3_lbfgs_velocity=res.velocity)
    v, m = newton.run_gauss_newton_3d(
        vel0, data, grid, FWIConfig(clip_velocity=CG3_CLIP), pml=pml,
        iter_cap=CG3_CAP, gmres_tol=M3_TOL, **M3_GN)
    out.update(m3_gn_velocity=v, m3_gn_loss=m.loss, m3_gn_step=m.step_size,
               m3_gn_backtracks=m.backtracks, m3_gn_relres=m.cg_relres)
    for name, v0, joint in (("alpha", vel, False), ("joint", vel0, True)):
        res = lbfgs.run_lbfgs_attenuation_3d(
            v0, np.zeros(grid.shape, np.float32), lossy, grid, pml,
            iter_cap=CG3_CAP, tol=M3_TOL, num_iterations=M3_ATT_ITERS,
            invert_velocity=joint, **M3_ATT)
        out.update({f"m3_{name}_loss": res.loss_history,
                    f"m3_{name}_velocity": res.velocity,
                    f"m3_{name}_attenuation": res.attenuation})
    cal = calibrate.calibrate_background_speed_3d(data, grid, pml=pml,
                                                  **M3_CAL)
    out.update(m3_cal_c0=cal.c0, m3_cal_candidates=cal.candidates,
               m3_cal_misfits=cal.misfits)
    np.savez_compressed(OUT_M3, **{k: np.asarray(v) for k, v in out.items()})
    print(f"wrote {OUT_M3}: {len(out)} arrays")


# -- the command-line interface (tests/test_torch_cli.py) -------------------

OUT_CLI = os.path.join(os.path.dirname(__file__), "torch_cli.npz")
# tests/test_misc.py's tiny ring widened from 12 to 24 mm: there the CLI's
# default 9 mm PML covers the 9 mm ring, the data are ~1e-7 and CG does not
# move. A 121^2 / 0.4 mm synthesis, 61^2 / 0.8 mm inversions, 16 elements on
# a 12 mm ring at 200 kHz.
CLI_SIMULATE = ["--xmax", "24e-3", "--dx", "0.4e-3", "--elements", "16",
                "--radius", "12e-3", "--frequency", "200e3"]
CLI_RUN = ["--iterations", "2", "--grid-xmax", "24e-3", "--grid-dx",
           "0.8e-3", "--elements", "16", "--radius", "12e-3", "--exclude",
           "2"]
# run's variants held against the JAX CLI: name -> extra flags
CLI_RUNS = {"cg": [], "gn": ["--method", "gn"],
            "qc_compensate": ["--qc-compensate"],
            "alpha": ["--method", "alpha"]}
CLI_DATASET = ("REC_DATA", "C", "x", "y", "x_circ", "y_circ", "f")


def main_cli():
    """torch_cli.npz: the JAX CLI's outputs at the tiny ring: the
    simulate dataset, each run variant's .mat export and qc's compensated
    data."""
    import tempfile

    from waveforminversionust_tpu.cli import main as cli
    from waveforminversionust_tpu.data.matio import load_mat

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "tiny.mat")
        cli(["simulate", data] + CLI_SIMULATE)
        out.update({f"sim_{k}": v for k, v in load_mat(data).items()})
        for name, extra in CLI_RUNS.items():
            path = os.path.join(tmp, f"{name}.mat")
            cli(["run", data, "--out", path] + CLI_RUN + extra)
            out.update({f"{name}_{k}": v for k, v in load_mat(path).items()})
        path = os.path.join(tmp, "qc.mat")
        cli(["qc", data, "--out", path])
        out["qc_REC_DATA"] = load_mat(path)["REC_DATA"]
    np.savez_compressed(OUT_CLI, **{k: np.asarray(v) for k, v in out.items()})
    print(f"wrote {OUT_CLI}: {len(out)} arrays")


# -- the opt-in direct engines (tests/test_torch_engines.py) ---------------

OUT_ENGINES = os.path.join(os.path.dirname(__file__), "torch_engines.npz")
EN_F = 350e3
EN_TWISTED = [(12, 9, None), (13, 9, None), (13, 9, 3), (13, 9, 11),
              (12, 9, 1)]                  # (ny, nx, middle row)
EN_PIVOT = [16, 40]                        # pivot block widths
EN_BATCHED = [(16, 16), (40, 16), (40, 32), (70, 16), (70, 32)]
EN_CR = [1, 2, 7, 12, 13]                  # cyclic reduction heights
EN_EXTENT = 16e-3                          # 41x41 at 0.8 mm
EN_PML = dict(l_pml=3.2e-3)
EN_TINY_F = 300e3
EN_TINY_ACQ = dict(num_elements=8, radius=12e-3, num_excluded_each_side=1)


def en_cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def en_random_planes(ny, nx, seed=0, diag_boost=4.0):
    """The well-conditioned random planes of tests/test_twisted.py."""
    rng = np.random.default_rng(seed)

    def part():
        a = rng.standard_normal((9, ny, nx)).astype(np.float32)
        a[0] += diag_boost * np.sign(a[0]) + 2 * diag_boost
        return a

    return (part() + 0.5j * part()).astype(np.complex64)


def en_random_batch(rng, batch, n, diag_boost=2.0):
    a = en_cplx(rng, (batch, n, n)) / np.sqrt(n) + diag_boost * np.eye(n)
    return a.astype(np.complex64)


def en_cr_planes(rng, ny, nx):
    """The random planes of tests/test_cyclic.py: structural zeros on the
    border and a dominant centre."""
    c = en_cplx(rng, (9, ny, nx))
    c[0] += 6.0
    for s in range(1, 9):
        c[s, 0, :] = c[s, -1, :] = 0
        c[s, :, 0] = c[s, :, -1] = 0
    return c


def en_twisted_case(ny, nx, m):
    """(planes, right-hand sides) of a twisted case."""
    return (en_random_planes(ny, nx),
            en_cplx(np.random.default_rng(1), (3, ny, nx)))


def en_cr_case(ny, nx=8):
    rng = np.random.default_rng(6)
    planes = en_cr_planes(rng, ny, nx)
    return planes, en_cplx(rng, (3, ny, nx))


def en_twisted_reference(planes, b, m):
    """The JAX twisted factor and its forward and adjoint solves."""
    from waveforminversionust_tpu.ops import cpx
    from waveforminversionust_tpu.ops.twisted import (twisted_factor_cpx,
                                                      twisted_solve_cpx)

    @jax.jit
    def reference(c, rhs):
        jfac = twisted_factor_cpx(c, m=m)
        return jfac, [twisted_solve_cpx(jfac, rhs, adjoint=a)
                      for a in (False, True)]

    return reference(cpx.of(planes), cpx.of(b))


def en_cr_reference(planes, b):
    """The JAX cyclic-reduction factor and its two solves."""
    from waveforminversionust_tpu.ops import cpx
    from waveforminversionust_tpu.ops.cyclic import cr_factor_cpx, cr_solve_cpx

    @jax.jit
    def reference(c, rhs):
        jfac = cr_factor_cpx(c, block=8)
        return jfac, [cr_solve_cpx(jfac, rhs, adjoint=a)
                      for a in (False, True)]

    return reference(cpx.of(planes), cpx.of(b))


def _np_cpx(c):
    from waveforminversionust_tpu.ops import cpx
    return cpx.to_numpy(c)


def en_tiny_ring():
    """The 41x41 grid and 8-element ring of tests/test_torch_fwi.py, data
    synthesized by the JAX package."""
    grid = Grid2D.centered(EN_EXTENT, 0.8e-3)
    vel = smooth_blob_phantom(grid, radius=6e-3, dc=40, c_bkgnd=1500.0)
    solver = SolverConfig(split_complex=True, pml=PMLConfig(**EN_PML))
    ds = synthesize_ring_dataset(vel, grid, AcquisitionConfig(**EN_TINY_ACQ),
                                 f=EN_TINY_F, seed=3, solver=solver)
    return grid, solver, ds


def main_engines():
    """torch_engines.npz: twisted factors and solves (the oracle and the
    Pallas kernel's block-step layout in interpret mode), the pivot and
    blocked batched inverses, cyclic reduction level by level, both
    engines' solve_helmholtz and 3 frozen-factor CG iterations on the tiny
    ring, with that ring's data."""
    import dataclasses

    from waveforminversionust_tpu.fwi import optimizers
    from waveforminversionust_tpu.ops import batched_inv, cpx
    from waveforminversionust_tpu.ops.pallas_inv import \
        batched_small_inv_pallas
    from waveforminversionust_tpu.ops.pallas_twisted import \
        twisted_factor_pallas
    from waveforminversionust_tpu.ops.solve import solve_helmholtz
    from waveforminversionust_tpu.ops.twisted import twisted_factor_cpx

    out = {}
    for ny, nx, m in EN_TWISTED:
        key = f"tw_{ny}_{nx}_{m}"
        jfac, refs = en_twisted_reference(*en_twisted_case(ny, nx, m), m)
        out[f"{key}_m"] = jfac.m
        out[f"{key}_g"] = _np_cpx(jfac.g)
        out[f"{key}_fwd"], out[f"{key}_adj"] = map(_np_cpx, refs)
    for ny in (12, 13):
        jplanes = cpx.of(en_random_planes(ny, 9, seed=5))
        ref = twisted_factor_cpx(jplanes)
        fused = twisted_factor_pallas(jplanes, interpret=True)
        out.update({f"lay_{ny}_m": ref.m, f"lay_{ny}_g": _np_cpx(ref.g),
                    f"lay_{ny}_fused_m": fused.m,
                    f"lay_{ny}_g_down": _np_cpx(fused.g_down),
                    f"lay_{ny}_g_up": _np_cpx(fused.g_up)})
    for b in EN_PIVOT:
        ja = cpx.of(jnp.asarray(en_random_batch(np.random.default_rng(3), 6,
                                                b)))
        out[f"piv_{b}_pallas"] = _np_cpx(batched_small_inv_pallas(
            ja, interpret=True))
        out[f"piv_{b}_xla"] = _np_cpx(batched_inv._batched_pivot_inv(ja))
    for n, block in EN_BATCHED:
        a = en_random_batch(np.random.default_rng(4), 5, n)
        out[f"inv_{n}_{block}"] = _np_cpx(batched_inv.batched_inv(
            cpx.of(jnp.asarray(a)), block=block, pivot="xla"))
    for ny in EN_CR:
        jfac, refs = en_cr_reference(*en_cr_case(ny))
        out[f"cr_{ny}_levels"] = len(jfac.levels)
        for i, lev in enumerate(jfac.levels):
            for j, part in enumerate(lev):
                out[f"cr_{ny}_lev{i}_{j}"] = _np_cpx(part)
        out[f"cr_{ny}_dinv_root"] = _np_cpx(jfac.dinv_root)
        out[f"cr_{ny}_fwd"], out[f"cr_{ny}_adj"] = map(_np_cpx, refs)
    grid = Grid2D.centered(EN_EXTENT, 0.8e-3)
    vel = smooth_blob_phantom(grid, radius=EN_EXTENT / 3, dc=60)
    src = en_cplx(np.random.default_rng(7), (2,) + grid.shape)
    for engine in ("twisted", "cr"):
        cfg = SolverConfig(split_complex=True, factorization=engine,
                           pml=PMLConfig(**EN_PML))

        def reference(v, s):
            return [solve_helmholtz(v, s, jnp.float32(EN_F), grid, cfg,
                                    adjoint=a)[0] for a in (False, True)]

        # op by op for twisted: see test_solve_helmholtz_engines_match_jax
        if engine == "cr":
            reference = jax.jit(reference)
        refs = reference(jnp.asarray(vel), cpx.of(src))
        out[f"solve_{engine}_fwd"], out[f"solve_{engine}_adj"] = \
            map(_np_cpx, refs)
    tgrid, solver, ds = en_tiny_ring()
    out.update({f"ring_{k}": np.asarray(getattr(ds, k))
                for k in ("x", "y", "c", "x_circ", "y_circ", "f",
                          "rec_data")})
    acq = build_ring_acquisition(tgrid, AcquisitionConfig(**EN_TINY_ACQ),
                                 x_elem=ds.x_circ, y_elem=ds.y_circ)
    data = objective.build_fwi_data(acq, ds.rec_data, EN_TINY_F, split=True)
    for engine in ("twisted", "cr"):
        res = optimizers.nonlinear_cg(
            jnp.full(tgrid.shape, 1500.0, jnp.float32), data, tgrid,
            dataclasses.replace(solver, refactor_every=2,
                                factorization=engine),
            FWIConfig(num_iterations=3))
        out.update({f"cg_{engine}_loss": res.metrics.loss,
                    f"cg_{engine}_step_size": res.metrics.step_size,
                    f"cg_{engine}_velocity": res.velocity})
    np.savez_compressed(OUT_ENGINES, **{k: np.asarray(v)
                                        for k, v in out.items()})
    print(f"wrote {OUT_ENGINES}: {len(out)} arrays")


if __name__ == "__main__":
    commands = {"solvers": main_solvers, "3d": main_3d,
                "traveltime": main_traveltime, "methods3d": main_methods3d,
                "cli": main_cli, "engines": main_engines}
    commands[sys.argv[1]]() if sys.argv[1:] else main()
