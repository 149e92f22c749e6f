"""The port's Gauss-Newton, resolution and joint multi-frequency paths
held against the JAX package on the CPU.

Live against the JAX functions (one comparison a module, cheap to
compile): the mass spread, the Tikhonov curvature, the inner PCG and the
linearized step of fwi/newton.py; the Rademacher probes of
fwi/resolution.py (JAX's threefry, bit for bit); stack_frequencies and the
frequency-summed step of fwi/multifreq.py. Against tests/golden/torch_methods.npz, which
tests/golden/generate_torch.py writes with the JAX package: the Frechet
pair, run_gauss_newton (a plain run and one whose clip box makes the
misfit reject every trial, 4 backtracks each), psf_probe, hessian_diag_probe,
nonlinear_cg_multifreq (two configurations) and invert_dataset's "gn" and
"joint-multifreq", on the generator's 41x41, 8-element ring.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveforminversionust_tpu.config import StepSizeFormula as JStep
from waveforminversionust_tpu.fwi import multifreq as jmf
from waveforminversionust_tpu.fwi import newton as jnewton
from waveforminversionust_tpu.fwi import objective as jobj
from waveforminversionust_tpu_torch import interop
from waveforminversionust_tpu_torch.config import (AcquisitionConfig,
                                                   FWIConfig, PMLConfig,
                                                   SolverConfig,
                                                   StepSizeFormula)
from waveforminversionust_tpu_torch.fwi import multifreq, newton, resolution
from waveforminversionust_tpu_torch.fwi import objective as tobj
from waveforminversionust_tpu_torch.fwi import optimizers as topt
from waveforminversionust_tpu_torch.fwi.runner import invert_dataset
from waveforminversionust_tpu_torch.models.acquisition import \
    build_ring_acquisition
from waveforminversionust_tpu_torch.models.grid import Grid2D
from waveforminversionust_tpu_torch.ops.solve import (
    helmholtz_operator_solve, make_helmholtz_operator)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _load_generator():
    spec = importlib.util.spec_from_file_location(
        "generate_torch", os.path.join(GOLDEN, "generate_torch.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


GEN = _load_generator()
SOLVER = SolverConfig(pml=PMLConfig(**GEN.PML))
ACQ = AcquisitionConfig(**GEN.ACQ)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _golden(port_loss, ref_loss, port_vel, ref_vel):
    """The golden bounds (tests/test_golden.py): loss rtol 1e-2, velocity
    atol 0.5 m/s."""
    np.testing.assert_allclose(np.asarray(port_loss), np.asarray(ref_loss),
                               rtol=1e-2)
    np.testing.assert_allclose(np.asarray(port_vel), np.asarray(ref_vel),
                               atol=0.5)


@pytest.fixture(scope="module")
def ref():
    return np.load(os.path.join(GOLDEN, "torch_methods.npz"))


@pytest.fixture(scope="module")
def ring(ref):
    """(grid, {frequency: dataset}, {frequency: FWIData}) from the
    generator's recorded data."""
    grid = Grid2D.centered(GEN.EXTENT, GEN.H)
    dss, datas = {}, {}
    for f in GEN.FREQS:
        dss[f] = interop.ring_dataset(ref["x"], ref["y"], ref["c"],
                                      ref["x_circ"], ref["y_circ"], f,
                                      ref[f"rec_{int(f)}"])
    acq = build_ring_acquisition(grid, ACQ, x_elem=ref["x_circ"],
                                 y_elem=ref["y_circ"])
    for f in GEN.FREQS:
        datas[f] = tobj.build_fwi_data(acq, dss[f].rec_data, f, device="cpu")
    return grid, dss, datas


# -- live: the pieces ----------------------------------------------------------

def test_newton_pieces_match():
    """mass_spread, _laplacian_ltl, _linearized_step, _data_normalization,
    _grad_contract and _pcg (on an SPD operator, with a frozen tail) ==
    the JAX package's: rtol 1e-5 (the PCG 1e-4, FP32 recurrences)."""
    rng = np.random.default_rng(31)
    fields = (rng.standard_normal((3, 9, 11))
              + 1j * rng.standard_normal((3, 9, 11))).astype(np.complex64)
    d, e = np.float32(0.09), np.float32(0.02)
    np.testing.assert_allclose(
        tobj.mass_spread(torch.as_tensor(fields), torch.tensor(d),
                         torch.tensor(e)).numpy(),
        jobj.mass_spread(jnp.asarray(fields), d, e), rtol=1e-5, atol=1e-6)
    m = rng.standard_normal((9, 11)).astype(np.float32)
    np.testing.assert_allclose(newton._laplacian_ltl(torch.as_tensor(m)),
                               jnewton._laplacian_ltl(jnp.asarray(m)),
                               rtol=1e-5, atol=1e-5)
    drec, res = fields[0], fields[1]
    np.testing.assert_allclose(
        float(newton._linearized_step(torch.as_tensor(drec),
                                      torch.as_tensor(res))),
        float(jnewton._linearized_step(jnp.asarray(drec), jnp.asarray(res))),
        rtol=1e-5)
    np.testing.assert_allclose(
        float(newton._data_normalization(torch.as_tensor(res))),
        float(jnewton._data_normalization(jnp.asarray(res))), rtol=1e-5)
    np.testing.assert_allclose(
        newton._grad_contract(torch.as_tensor(fields),
                              torch.as_tensor(fields[::-1].copy())).numpy(),
        jnewton._grad_contract(jnp.asarray(fields),
                               jnp.asarray(fields[::-1].copy())),
        rtol=1e-5, atol=1e-5)

    a = rng.standard_normal((99, 99)).astype(np.float32)
    spd = (a @ a.T / 99 + np.eye(99)).astype(np.float32)
    b = rng.standard_normal((9, 11)).astype(np.float32)
    diag = np.diag(spd).reshape(9, 11).copy()
    for iters, tol in ((30, 1e-3), (5, 1e-3)):  # converges early / not
        x, rr = newton._pcg(lambda v: (torch.as_tensor(spd)
                                       @ v.reshape(-1)).reshape(9, 11),
                            torch.as_tensor(b), torch.as_tensor(diag),
                            iters, tol)
        jx, jrr = jnewton._pcg(lambda v: (spd @ v.reshape(-1)).reshape(9, 11),
                               jnp.asarray(b), jnp.asarray(diag), iters, tol)
        np.testing.assert_allclose(x.numpy(), jx, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(rr), float(jrr), rtol=1e-3)


def test_pcg_skips_frozen_iterations():
    """A converged inner CG stops: no Hessian product after the residual
    is within tolerance (the reference computes and discards them)."""
    calls = []

    def hvp(v):
        calls.append(1)
        return 2.0 * v

    b = torch.ones(4, 5)
    x, rr = newton._pcg(hvp, b, torch.full((4, 5), 2.0), 8, 1e-3)
    assert len(calls) == 1 and float(rr) == 0.0
    torch.testing.assert_close(x, b / 2)


def test_rademacher_matches_jax():
    """The port's threefry draws == jax.random's bits: split keys and
    Rademacher fields, several seeds and shapes."""
    for seed in (0, 3, 12345):
        keys = jax.random.split(jax.random.PRNGKey(seed), 4)
        mine = resolution._split(resolution._prng_key(seed), 4)
        np.testing.assert_array_equal(np.asarray(keys),
                                      np.array(mine, np.uint32))
        for key, my_key in zip(keys, mine):
            np.testing.assert_array_equal(
                resolution._rademacher(my_key, (7, 9)),
                np.asarray(jax.random.rademacher(key, (7, 9),
                                                 dtype=jnp.float32)))
        np.testing.assert_array_equal(
            resolution._rademacher(resolution._prng_key(seed), (41, 41)),
            np.asarray(jax.random.rademacher(jax.random.PRNGKey(seed),
                                             (41, 41), dtype=jnp.float32)))


@pytest.mark.parametrize("formula", ["RESIDUAL", "GRADIENT", "GRADIENT_SD"])
def test_frequency_summed_step_matches(ring, formula):
    """stack_frequencies == the JAX package's on the same recordings, and
    the joint loop's step, optimizers._step_size over the stacked
    frequencies, == the reference's _step_size_reduced on one device:
    rtol 1e-5."""
    grid, _, datas = ring
    mf = multifreq.stack_frequencies([datas[f] for f in GEN.FREQS])
    jmfd = jmf.stack_frequencies([jobj.FWIData(
        src=None, rec_obs=jnp.asarray(datas[f].rec_obs.numpy()), rx_y=None,
        rx_x=None, f=jnp.float32(f)) for f in GEN.FREQS])
    np.testing.assert_array_equal(mf.rec_obs.numpy(), np.asarray(jmfd.rec_obs))
    assert mf.freqs == tuple(float(f) for f in np.asarray(jmfd.freqs))
    rng = np.random.default_rng(32)

    def c(shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    drec, obs, sim = c((2, 3, 5)), c((2, 3, 5)), c((2, 3, 5))
    grad = rng.standard_normal((6, 7)).astype(np.float32)
    sd = rng.standard_normal((6, 7)).astype(np.float32)
    port = topt._step_size(StepSizeFormula[formula],
                           *(torch.as_tensor(a) for a in
                             (drec, obs, sim, grad, sd)), 1e-20)
    want = jmf._step_size_reduced(JStep[formula],
                                  *(jnp.asarray(a) for a in
                                    (drec, obs, sim, grad, sd)),
                                  1e-20, lambda x: x)
    np.testing.assert_allclose(float(port), float(want), rtol=1e-5)


# -- against the generator's JAX runs -------------------------------------------

def test_frechet_operators_match(ring, ref):
    """J dm and J^H r at 1490 m/s == the JAX package's, relative error:
    the exact pair (run_gauss_newton's default) < 1e-4 (measured 2.5e-5,
    2.0e-5); the lumped pair < 3e-4 (measured 1.0e-4, 1.5e-4: against a
    complex128 solve the lumped J of each package is already 5e-5 to 9e-5
    off in FP32, so the two differ by their sum). Both pairs meet
    Re<J dm, r> == <dm, J^H r> to 2e-3 (tests/test_newton.py:121)."""
    grid, _, datas = ring
    data = datas[GEN.FREQS[1]]
    vel = torch.full(grid.shape, 1.0 / GEN.SLOW_AT)
    op = make_helmholtz_operator(vel, data.f, grid, SOLVER)
    wv = helmholtz_operator_solve(op, data.src, grid, SOLVER)
    dm, r = GEN.frechet_inputs(grid.shape, tuple(data.rec_obs.shape))
    for exact in (True, False):
        jv, jt, _ = newton.make_frechet_operators(op, data, grid, SOLVER,
                                                  1.0 / vel, wv, exact=exact)
        jdm, jtr = jv(torch.as_tensor(dm)), jt(torch.as_tensor(r))
        bound = 1e-4 if exact else 3e-4
        assert _rel(jdm.numpy(), ref[f"jv_{int(exact)}"]) < bound
        assert _rel(jtr.numpy(), ref[f"jt_{int(exact)}"]) < bound
        lhs = float(np.sum(jdm.real.numpy() * r.real + jdm.imag.numpy()
                           * r.imag))
        rhs = float(torch.sum(torch.as_tensor(dm) * jtr))
        assert lhs == pytest.approx(rhs, rel=2e-3)
    with pytest.raises(NotImplementedError, match="slice 7"):
        newton.make_frechet_operators(op, data, grid, SOLVER, 1.0 / vel, wv,
                                      mesh=object())


@pytest.mark.parametrize("name,fwi", [
    ("gn", FWIConfig(num_iterations=GEN.ITERS, c_init=GEN.C_INIT)),
    ("gn_clip", FWIConfig(num_iterations=GEN.ITERS, c_init=GEN.C_INIT,
                          clip_velocity=GEN.CLIP_ALL)),
])
def test_run_gauss_newton_matches(ring, ref, name, fwi):
    """run_gauss_newton, 2 outer iterations of 4 inner == the JAX
    package's: golden bounds on the loss, the step and the velocity;
    gradient norm and inner relative residual rtol 1e-2; the same
    backtracks (0 a step for "gn"; for "gn_clip", whose clip box puts
    every trial 100 m/s below the start, 4 halvings and a rejected step)."""
    grid, _, datas = ring
    res = newton.run_gauss_newton(torch.full(grid.shape, GEN.C_INIT),
                                  datas[GEN.FREQS[1]], grid, SOLVER, fwi=fwi,
                                  num_iterations=GEN.ITERS,
                                  cg_iters=GEN.CG_ITERS)
    m = res.metrics
    _golden(m.loss, ref[f"{name}_loss"], res.velocity,
            ref[f"{name}_velocity"])
    np.testing.assert_array_equal(m.backtracks.numpy(),
                                  ref[f"{name}_backtracks"])
    np.testing.assert_allclose(m.step_size.numpy(), ref[f"{name}_step_size"],
                               rtol=1e-2)
    for field in ("grad_norm", "cg_relres"):
        np.testing.assert_allclose(getattr(m, field).numpy(),
                                   ref[f"{name}_{field}"], rtol=1e-2)
    assert np.all(np.diff(m.loss.numpy()) <= 0)


def test_invert_dataset_gn_matches(ring, ref):
    """invert_dataset(method="gn") == the JAX package's: golden bounds,
    metrics {"loss": ...} alone."""
    grid, dss, _ = ring
    res = invert_dataset(dss[GEN.FREQS[1]], grid=grid, acquisition=ACQ,
                         solver=SOLVER,
                         fwi=FWIConfig(num_iterations=GEN.ITERS,
                                       c_init=GEN.C_INIT),
                         method="gn", device="cpu")
    assert set(res.metrics) == {"loss"}
    _golden(res.metrics["loss"], ref["runner_gn_loss"], res.velocity,
            ref["runner_gn_velocity"])


def test_resolution_probes_match(ring, ref):
    """psf_probe (2 one-hot probes, 4 inner iterations) and
    hessian_diag_probe (3 Rademacher probes) at 1490 m/s == the JAX
    package's: relative error 1e-2 (measured 3.8e-5 and 3.5e-5)."""
    grid, _, datas = ring
    data = datas[GEN.FREQS[1]]
    vel = torch.full(grid.shape, 1.0 / GEN.SLOW_AT)
    psf = resolution.psf_probe(vel, data, grid, SOLVER,
                               probes=GEN.probes(grid.shape),
                               cg_iters=GEN.CG_ITERS)
    assert _rel(psf.numpy(), ref["psf"]) < 1e-2
    hdiag = resolution.hessian_diag_probe(vel, data, grid, SOLVER,
                                          num_probes=GEN.N_HUTCHINSON)
    assert _rel(hdiag.numpy(), ref["hdiag"]) < 1e-2
    with pytest.raises(ValueError, match="explicit model-space probes"):
        resolution.psf_probe(vel, data, grid, SOLVER)


@pytest.mark.parametrize("name,fwi", [
    ("mf", FWIConfig(num_iterations=GEN.MF_ITERS)),
    ("mf_reg", FWIConfig(num_iterations=GEN.MF_ITERS,
                         precondition="illumination", reg_tikhonov=0.1)),
])
def test_multifreq_matches(ring, ref, name, fwi):
    """nonlinear_cg_multifreq over 250 and 300 kHz, 3 iterations, plain
    and with illumination preconditioning and Tikhonov regularization ==
    the JAX package's: golden bounds on the loss, the step and the
    velocity; beta (a ratio of gradient differences) atol 1e-2."""
    grid, _, datas = ring
    mf = multifreq.stack_frequencies([datas[f] for f in GEN.FREQS])
    assert mf.freqs == GEN.FREQS and mf.rec_obs.shape[0] == 2
    vel, m = multifreq.nonlinear_cg_multifreq(
        torch.full(grid.shape, GEN.C_INIT), mf, grid, SOLVER, fwi)
    _golden(m.loss, ref[f"{name}_loss"], vel, ref[f"{name}_velocity"])
    np.testing.assert_allclose(m.step_size.numpy(), ref[f"{name}_step_size"],
                               rtol=1e-2)
    np.testing.assert_allclose(m.grad_norm.numpy(), ref[f"{name}_grad_norm"],
                               rtol=1e-2)
    np.testing.assert_allclose(m.beta.numpy(), ref[f"{name}_beta"],
                               atol=1e-2)


def test_invert_dataset_joint_multifreq_matches(ring, ref):
    """invert_dataset(method="joint-multifreq") over the {frequency:
    dataset} mapping == the JAX package's: frequencies sorted, the CG
    metrics, golden bounds; the callback fires once with the tuple."""
    grid, dss, _ = ring
    seen = []
    res = invert_dataset({f: dss[f] for f in reversed(GEN.FREQS)},
                         grid=grid, acquisition=ACQ, solver=SOLVER,
                         fwi=FWIConfig(num_iterations=GEN.MF_ITERS,
                                       c_init=GEN.C_INIT),
                         method="joint-multifreq", device="cpu",
                         callback=lambda *a: seen.append(a[:2]))
    assert res.frequencies == GEN.FREQS == tuple(ref["runner_mf_frequencies"])
    assert seen == [(0, GEN.FREQS)]
    assert set(res.metrics) == {"loss", "grad_norm", "beta", "step_size"}
    _golden(res.metrics["loss"], ref["runner_mf_loss"], res.velocity,
            ref["runner_mf_velocity"])


@pytest.mark.parametrize("fwi,match", [
    (FWIConfig(step_size=StepSizeFormula.BB), "step_size=BB"),
    (FWIConfig(reject_increase=2.0), "reject_increase"),
])
def test_multifreq_refuses_bb_and_the_watchdog(ring, fwi, match):
    """BB steps and the watchdog raise ValueError with the reference's
    messages, directly and through invert_dataset; a single dataset is no
    mapping for the joint method."""
    grid, dss, datas = ring
    mf = multifreq.stack_frequencies([datas[f] for f in GEN.FREQS])
    with pytest.raises(ValueError, match=match):
        multifreq.nonlinear_cg_multifreq(torch.full(grid.shape, 1480.0), mf,
                                         grid, SOLVER, fwi)
    with pytest.raises(ValueError, match=match):
        invert_dataset(dss, grid=grid, acquisition=ACQ, solver=SOLVER,
                       fwi=fwi, method="joint-multifreq", device="cpu")
    with pytest.raises(ValueError, match="mapping"):
        invert_dataset(dss[GEN.FREQS[0]], grid=grid, acquisition=ACQ,
                       solver=SOLVER, method="joint-multifreq", device="cpu")
