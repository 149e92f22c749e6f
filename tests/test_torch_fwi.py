"""The port's FWI layer held against the JAX package on the CPU.

Unit pieces (objective, momentum, step sizes, BB, watchdog, regularizer)
take the same numpy inputs made from a seed; the CG loop runs 2 frozen-
factor iterations on a tiny ring beside the JAX split path; the golden
fixture is reproduced by the port alone.
"""

import dataclasses
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveforminversionust_tpu import (AcquisitionConfig as JAcq,
                                      FWIConfig as JFWI, Grid2D as JGrid,
                                      MomentumFormula as JMom,
                                      PMLConfig as JPML,
                                      SolverConfig as JSolver,
                                      StepSizeFormula as JStep)
from waveforminversionust_tpu.data.synthesize import \
    synthesize_ring_dataset as jsynthesize
from waveforminversionust_tpu.fwi import objective as jobj
from waveforminversionust_tpu.fwi import optimizers as jopt
from waveforminversionust_tpu.fwi import regularization as jreg
from waveforminversionust_tpu.models.acquisition import \
    build_ring_acquisition as jbuild_acq
from waveforminversionust_tpu.models.phantom import smooth_blob_phantom
from waveforminversionust_tpu_torch import interop
from waveforminversionust_tpu_torch.config import (AcquisitionConfig,
                                                   FWIConfig, MomentumFormula,
                                                   PMLConfig, SolverConfig,
                                                   StepSizeFormula)
from waveforminversionust_tpu_torch.data.synthesize import \
    synthesize_ring_dataset
from waveforminversionust_tpu_torch.fwi import objective as tobj
from waveforminversionust_tpu_torch.fwi import optimizers as topt
from waveforminversionust_tpu_torch.fwi import regularization as treg
from waveforminversionust_tpu_torch.fwi.runner import invert_dataset
from waveforminversionust_tpu_torch.models.acquisition import \
    build_ring_acquisition
from waveforminversionust_tpu_torch.models.grid import Grid2D

RNG_SHAPE = (3, 9, 11)  # (ntx, ny, nx) of the unit-test fields


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(port, ref, rtol=1e-5, atol=0.0):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol,
                               atol=atol)


# -- objective -------------------------------------------------------------

def _receivers(rng, bilinear):
    ntx, ny, nx = RNG_SHAPE
    n = 5
    if not bilinear:
        # distinct pixels per transmitter: a scatter with .set is only
        # defined without duplicates
        flat = np.stack([rng.choice(ny * nx, n, replace=False)
                         for _ in range(ntx)])
        return flat // nx, flat % nx, None
    ry = rng.integers(0, ny, (ntx, n, 4))
    rx = rng.integers(0, nx, (ntx, n, 4))
    w = rng.uniform(0, 1, (ntx, n, 4)).astype(np.float32)
    return ry, rx, w


@pytest.mark.parametrize("bilinear", [False, True])
def test_sample_and_scatter_match(bilinear):
    """Receiver gather and the adjoint scatter (scatter-add with weights in
    bilinear mode) == the JAX package: rtol 1e-6 (f32 sums of <= 4 terms)."""
    rng = np.random.default_rng(10)
    ry, rx, w = _receivers(rng, bilinear)
    fields = _cplx(rng, RNG_SHAPE)
    vals = _cplx(rng, ry.shape[:2])
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else _t(w)
    _close(tobj.sample_receivers(_t(fields), _t(ry), _t(rx), tw).numpy(),
           jobj.sample_receivers(jnp.asarray(fields), jnp.asarray(ry),
                                 jnp.asarray(rx), jw), rtol=1e-6)
    _close(tobj.scatter_to_fields(_t(vals), _t(ry), _t(rx), RNG_SHAPE[1:],
                                  tw).numpy(),
           jobj.scatter_to_fields(jnp.asarray(vals), jnp.asarray(ry),
                                  jnp.asarray(rx), RNG_SHAPE[1:], jw),
           rtol=1e-6, atol=1e-7)


def test_objective_functions_match():
    """Source strengths, misfit, illumination, preconditioning and the
    virtual source (lossless and lossy) == the JAX package: rtol 1e-5
    (f32 reductions taken in another order)."""
    rng = np.random.default_rng(11)
    sim, obs = _cplx(rng, (3, 7)), _cplx(rng, (3, 7))
    fields = _cplx(rng, RNG_SHAPE)
    slow = rng.uniform(1 / 1600, 1 / 1400, RNG_SHAPE[1:]).astype(np.float32)
    alpha = rng.uniform(-5, 5, RNG_SHAPE[1:]).astype(np.float32)
    grad = rng.standard_normal(RNG_SHAPE[1:]).astype(np.float32)
    f = 350e3

    _close(tobj.estimate_source_strengths(_t(sim), _t(obs)).numpy(),
           jobj.estimate_source_strengths(jnp.asarray(sim), jnp.asarray(obs)))
    _close(float(tobj.misfit(_t(sim), _t(obs))),
           float(jobj.misfit(jnp.asarray(sim), jnp.asarray(obs))))
    illum = tobj.illumination_map(_t(fields))
    _close(illum.numpy(), jobj.illumination_map(jnp.asarray(fields)))
    _close(tobj.precondition_gradient(_t(grad), illum, 1e-2).numpy(),
           jobj.precondition_gradient(jnp.asarray(grad),
                                      jnp.asarray(illum.numpy()), 1e-2))
    for a in (None, alpha):
        _close(tobj.virtual_source(_t(slow), _t(fields), f,
                                   None if a is None else _t(a)).numpy(),
               jobj.virtual_source(jnp.asarray(slow), jnp.asarray(fields),
                                   jnp.float32(f),
                                   None if a is None else jnp.asarray(a)))


# -- CG helpers ------------------------------------------------------------

def _vectors(seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((6, 7)).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("formula", list(MomentumFormula))
@pytest.mark.parametrize("it", [0, 3])
def test_momentum_matches(formula, it):
    """beta of every momentum formula == the JAX package (0 at it == 0):
    rtol 1e-5."""
    g, gp, sd, _ = _vectors(20 + formula.value)
    port = topt._momentum(formula, it, _t(g), _t(gp), _t(sd), 1e-9)
    ref = jopt._momentum(JMom(formula.value), it, jnp.asarray(g),
                         jnp.asarray(gp), jnp.asarray(sd), 1e-9)
    _close(float(port), float(ref))


@pytest.mark.parametrize("formula", [StepSizeFormula.RESIDUAL,
                                     StepSizeFormula.GRADIENT,
                                     StepSizeFormula.GRADIENT_SD])
def test_step_size_matches(formula):
    """Every linearized line-search formula == the JAX package: rtol 1e-5."""
    rng = np.random.default_rng(30 + formula.value)
    drec, obs, sim = (_cplx(rng, (3, 7)) for _ in range(3))
    g, sd, _, _ = _vectors(31)
    port = topt._step_size(formula, _t(drec), _t(obs), _t(sim), _t(g), _t(sd),
                           0.0)
    ref = jopt._step_size(JStep(formula.value), jnp.asarray(drec),
                          jnp.asarray(obs), jnp.asarray(sim), jnp.asarray(g),
                          jnp.asarray(sd), 0.0)
    _close(float(port), float(ref))


@pytest.mark.parametrize("case", ["valid", "cold", "ascent"])
def test_bb_step_size_matches(case):
    """BB2 step and validity == the JAX package: a valid step, a cold start
    (dm = 0) and an ascent direction (<g, p> > 0)."""
    slow, g, gp, sd = _vectors(40)
    slow_prev = slow.copy() if case == "cold" else slow - 0.1 * (g - gp)
    if case == "ascent":
        sd = g.copy()
    else:
        sd = -g
    port_sz, port_ok = topt._bb_step_size(_t(slow), _t(slow_prev), _t(g),
                                          _t(gp), _t(sd), 1e-12)
    ref_sz, ref_ok = jopt._bb_step_size(*(jnp.asarray(a) for a in (
        slow, slow_prev, g, gp, sd)), 1e-12)
    assert bool(port_ok) == bool(ref_ok) == (case == "valid")
    _close(float(port_sz), float(ref_sz), atol=1e-30)


@pytest.mark.parametrize("loss", [1.0, 2.0, float("nan")])
def test_watchdog_apply_matches(loss):
    """The watchdog == the JAX package: no revert below the ratio, a revert
    above it, and the reference's quirk (fwi/optimizers.py:154) reproduced:
    a NaN loss is not ``bad`` and becomes the new baseline."""
    slow, slow_prev, slow_new, vel_new = _vectors(50)
    prev_loss = 1.2
    port = topt._watchdog_apply(1.5, torch.tensor(loss), torch.tensor(prev_loss),
                                *(_t(a) for a in (slow, slow_prev, slow_new,
                                                  vel_new)))
    ref = jopt._watchdog_apply(1.5, jnp.float32(loss), jnp.float32(prev_loss),
                               *(jnp.asarray(a) for a in (slow, slow_prev,
                                                          slow_new, vel_new)))
    assert bool(port[0]) == bool(ref[0]) == (loss == 2.0)
    for p, r in zip(port[1:], ref[1:]):
        np.testing.assert_allclose(np.asarray(p), np.asarray(r), rtol=1e-6,
                                   equal_nan=True)
    if np.isnan(loss):
        # the baseline is now NaN, so no later loss can ever read as a spike
        assert np.isnan(float(port[4]))
        again = topt._watchdog_apply(1.5, torch.tensor(1e30), port[4],
                                     *(_t(a) for a in (slow, slow_prev,
                                                       slow_new, vel_new)))
        assert not bool(again[0])


def test_watchdog_rejects_nonratio_threshold():
    with pytest.raises(ValueError, match="reject_increase"):
        topt._validate_watchdog(FWIConfig(reject_increase=1.0))


@pytest.mark.parametrize("reg", [dict(reg_tikhonov=0.3),
                                 dict(reg_tv=0.2, reg_tv_eps=2.0)])
def test_cg_regularizer_matches(reg):
    """The rescaled regularization gradient == the JAX package: rtol 1e-4
    (autodiff through 1/slow in f32)."""
    rng = np.random.default_rng(60)
    slow = rng.uniform(1 / 1600, 1 / 1400, (12, 13)).astype(np.float32)
    dgrad = rng.standard_normal((12, 13)).astype(np.float32)
    grid = Grid2D.centered(6e-3, 0.5e-3)
    port = treg.make_cg_regularizer(grid, FWIConfig(**reg))(_t(slow), _t(dgrad))
    ref = jreg.make_cg_regularizer(JGrid.centered(6e-3, 0.5e-3),
                                   JFWI(**reg))(jnp.asarray(slow),
                                                jnp.asarray(dgrad))
    _close(port.numpy(), ref, rtol=1e-4, atol=1e-6 * float(np.abs(ref).max()))
    assert treg.make_cg_regularizer(grid, FWIConfig()) is None


# -- the CG loop -----------------------------------------------------------

TINY_F = 300e3
TINY_PML = dict(l_pml=3.2e-3)
TINY_ACQ = dict(num_elements=8, radius=12e-3, num_excluded_each_side=1)


@pytest.fixture(scope="module")
def tiny_ring():
    """41x41 grid, 8-element ring, data synthesized by the JAX package."""
    jgrid = JGrid.centered(16e-3, 0.8e-3)
    vel = smooth_blob_phantom(jgrid, radius=6e-3, dc=40, c_bkgnd=1500.0)
    jsolver = JSolver(split_complex=True, pml=JPML(**TINY_PML))
    ds = jsynthesize(vel, jgrid, JAcq(**TINY_ACQ), f=TINY_F, seed=3,
                     solver=jsolver)
    return jgrid, jsolver, ds


def test_synthesize_matches(tiny_ring):
    """The port's synthesizer == the JAX split path on the same grid,
    phantom and seed: rel 5e-5 (each builds its own planes; see
    test_torch_ops.py::test_solve_helmholtz_matches_split_path)."""
    jgrid, _, ds = tiny_ring
    vel = smooth_blob_phantom(jgrid, radius=6e-3, dc=40, c_bkgnd=1500.0)
    port = synthesize_ring_dataset(vel, Grid2D.centered(16e-3, 0.8e-3),
                                   AcquisitionConfig(**TINY_ACQ), f=TINY_F,
                                   seed=3,
                                   solver=SolverConfig(pml=PMLConfig(**TINY_PML)),
                                   device="cpu")
    for name in ("x", "y", "c", "x_circ", "y_circ"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ds, name))
    rel = (np.linalg.norm(port.rec_data - ds.rec_data)
           / np.linalg.norm(ds.rec_data))
    assert rel < 5e-5, rel


def test_nonlinear_cg_frozen_factor_matches(tiny_ring):
    """2 iterations with refactor_every=2 (a factored, then a stale step
    with the extra refinement pass) == the JAX split path on the same
    data. Measured: loss, step and gradient norm within 5e-4, beta (a
    ratio of gradient differences, -0.03 here) within 5e-3, velocity
    within 3e-3 m/s; held to 5e-3, 2e-2 and 0.05 m/s, inside the golden
    bounds (rtol 1e-2, 0.5 m/s). The two packages differ only by f32
    rounding and their (d, e) fits (see test_torch_ops.py)."""
    jgrid, jsolver, ds = tiny_ring
    jacq = jbuild_acq(jgrid, JAcq(**TINY_ACQ), x_elem=ds.x_circ,
                      y_elem=ds.y_circ)
    jdata = jobj.build_fwi_data(jacq, ds.rec_data, TINY_F, split=True)
    fwi = dict(num_iterations=2)
    ref = jopt.nonlinear_cg(jnp.full(jgrid.shape, 1500.0, jnp.float32), jdata,
                            jgrid, dataclasses.replace(jsolver, refactor_every=2),
                            JFWI(**fwi))

    grid = Grid2D.centered(16e-3, 0.8e-3)
    tds = interop.ring_dataset(ds.x, ds.y, ds.c, ds.x_circ, ds.y_circ, ds.f,
                               ds.rec_data)
    acq = build_ring_acquisition(grid, AcquisitionConfig(**TINY_ACQ),
                                 x_elem=tds.x_circ, y_elem=tds.y_circ)
    data = tobj.build_fwi_data(acq, tds.rec_data, TINY_F, device="cpu")
    port = topt.nonlinear_cg(torch.full(grid.shape, 1500.0), data, grid,
                             SolverConfig(pml=PMLConfig(**TINY_PML),
                                          refactor_every=2),
                             FWIConfig(**fwi))
    for f, rtol in (("loss", 5e-3), ("step_size", 5e-3), ("grad_norm", 5e-3),
                    ("beta", 2e-2)):
        _close(getattr(port.metrics, f).numpy(),
               np.asarray(getattr(ref.metrics, f)), rtol=rtol)
    _close(port.velocity.numpy(), np.asarray(ref.velocity), rtol=0, atol=0.05)


# -- the golden fixture ----------------------------------------------------

_GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def test_golden_fixture_reproduced():
    """tests/golden/ring16.npz (the JAX package's frozen 89x89, 16-element,
    4-iteration inversion) reproduced by the port's invert_dataset with no
    JAX in the loop: the golden bounds of tests/test_golden.py, loss and
    step rtol 1e-2, velocity atol 0.5 m/s."""
    spec = importlib.util.spec_from_file_location(
        "golden_generate", os.path.join(_GOLDEN, "generate.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    golden = np.load(os.path.join(_GOLDEN, "ring16.npz"))
    ds = interop.ring_dataset(golden["x"], golden["y"], golden["c"],
                              golden["x_circ"], golden["y_circ"],
                              float(golden["f"]),
                              golden["rec_re"] + 1j * golden["rec_im"])

    def port_cfg(cls, ref):
        return cls(**{f.name: getattr(ref, f.name)
                      for f in dataclasses.fields(ref)})

    solver = SolverConfig(pml=port_cfg(PMLConfig, gen.SOLVER.pml))
    acq = port_cfg(AcquisitionConfig, gen.ACQ)
    fwi = FWIConfig(num_iterations=gen.FWI.num_iterations, c_init=gen.FWI.c_init)
    grid = Grid2D.centered(44e-3, 1.0e-3)
    assert grid.shape == gen.COARSE.shape
    res = invert_dataset(ds, grid=grid, acquisition=acq, solver=solver, fwi=fwi,
                         device="cpu")
    np.testing.assert_allclose(res.metrics["loss"], golden["loss"], rtol=1e-2)
    np.testing.assert_allclose(res.metrics["step_size"], golden["step"],
                               rtol=1e-2)
    np.testing.assert_allclose(res.velocity, golden["velocity"], atol=0.5)
