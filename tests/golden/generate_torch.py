"""Generate the JAX package's reference outputs that the PyTorch port's
tests hold their L-BFGS, Gauss-Newton, resolution and joint multi-frequency
paths against (tests/golden/torch_methods.npz):

    python tests/golden/generate_torch.py

Each of those JAX functions compiles for 5-20 s on one CPU core, which the
tests cannot afford one by one (tests/test_torch_autodiff.py and
tests/test_torch_newton.py keep one live JAX comparison a module). The
problems are small and seeded: the 21x21 loss of tests/test_adjoint_vjp.py
for the differentiable solve, and a 41x41 ring of 8 elements over a blob
(data synthesized here by the JAX package at 250 and 300 kHz) for the
inversions, 2-3 iterations each. The tests import the constants and the
problem builders from this file.
"""

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from waveforminversionust_tpu import (AcquisitionConfig, FWIConfig,  # noqa: E402
                                      Grid2D, PMLConfig, SolverConfig,
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


if __name__ == "__main__":
    main()
