"""The port's 3D methods held against the JAX package on the CPU, on the
15^3 blob and 8-element ring of tests/golden/generate_torch.py: the
differentiable 3D solve's gradient of fwi_loss_3d, lossless and lossy in
both fields (converged GMRES, a frozen shell), 3D L-BFGS, one Gauss-Newton
iteration, the attenuation and joint inversions and the 3D background
calibration (from tests/golden/torch_methods3d.npz); the solve's gradient in
its right-hand side (live); its forward against the plain solve.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveforminversionust_tpu import PMLConfig as JPMLConfig
from waveforminversionust_tpu.models.grid3d import Grid3D as JGrid3D
from waveforminversionust_tpu.ops import born3d as jborn3d
from waveforminversionust_tpu.ops import cpx
from waveforminversionust_tpu_torch.config import FWIConfig, PMLConfig
from waveforminversionust_tpu_torch.fwi import calibrate, fwi3d, lbfgs, newton
from waveforminversionust_tpu_torch.models import acquisition3d
from waveforminversionust_tpu_torch.models.grid3d import Grid3D
from waveforminversionust_tpu_torch.ops import born3d

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _load_generator():
    spec = importlib.util.spec_from_file_location(
        "generate_torch", os.path.join(GOLDEN, "generate_torch.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


GEN = _load_generator()
GRID = Grid3D.centered(GEN.G3_EXTENT, GEN.G3_H)
PML = PMLConfig(**GEN.PML3)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's outputs (tests/golden/generate_torch.py
    methods3d)."""
    return np.load(os.path.join(GOLDEN, "torch_methods3d.npz"))


def _data(rec):
    acq = acquisition3d.build_acquisition3d(
        GRID, acquisition3d.cylinder_positions(**GEN.RING3),
        min_angle=GEN.MIN_ANGLE3)
    d = fwi3d.build_fwi_data_3d(acq, rec, GEN.F3, GRID, device="cpu")
    return d._replace(src=d.src * GEN.SRC_SCALE3)


def _vel0():
    return torch.full(GRID.shape, GEN.M3_C)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("lossy", [False, True])
def test_gradient_matches_jax(ref, lossy):
    """The gradient of fwi_loss_3d through born_solve_3d_diff (one adjoint
    solve) against jax.grad of the JAX package's custom VJP, at GMRES tol
    1e-5 with a frozen shell: rel 1e-3 in norm, in slowness and, lossy, in
    the attenuation map."""
    data = _data(ref["m3_rec"])
    slow = torch.full((GRID.nx * GRID.ny * GRID.nz,), 1.0 / GEN.M3_C,
                      requires_grad=True)
    alpha = (torch.full(GRID.shape, GEN.M3_ALPHA0, requires_grad=True)
             if lossy else None)
    loss = lbfgs.fwi_loss_3d(slow, data._replace(attenuation=alpha), GRID,
                             PML, shell_k0=2 * np.pi * GEN.F3 / GEN.M3_C,
                             **GEN.M3_GRAD)
    loss.backward()
    assert _rel(slow.grad, ref["m3_grad_lossy" if lossy else "m3_grad"]) \
        < 1e-3
    if lossy:
        assert _rel(alpha.grad, ref["m3_grad_alpha"]) < 1e-3


def test_rhs_gradient_and_forward():
    """Live: the gradient in the complex right-hand side of a lossy adjoint
    solve (the sign flips of the backward) is lam = A^-H g, the JAX
    package's split cotangent (re, im) read as one complex number (rel
    1e-3); the forward, lossless and lossy, is the plain GMRES solve's,
    bit for bit."""
    grid = Grid3D.centered(4.5e-3, 1.5e-3)                     # 7^3
    jgrid = JGrid3D.centered(4.5e-3, 1.5e-3)
    pml, jpml = PMLConfig(a0=20.0, l_pml=3e-3), JPMLConfig(a0=20.0,
                                                           l_pml=3e-3)
    vel = GEN.blob3d(grid, radius=2e-3)
    rng = np.random.default_rng(7)
    rhs = (rng.standard_normal((1,) + grid.shape)
           + 1j * rng.standard_normal((1,) + grid.shape)).astype(np.complex64)
    w = rng.standard_normal(grid.shape).astype(np.float32)
    alpha = np.full(grid.shape, 5.0, np.float32)
    kw = dict(tol=1e-6, iter_cap=600, restart=16)
    r = torch.tensor(rhs, requires_grad=True)
    u = born3d.born_solve_3d_diff(vel, r, GEN.F3, grid, pml, adjoint=True,
                                  attenuation=alpha, **kw)
    torch.sum(torch.as_tensor(w) * torch.abs(u[0]) ** 2).backward()

    def jloss(re, im):
        uj = jborn3d.born_solve_3d_diff(vel, cpx.Cpx(re, im), GEN.F3, jgrid,
                                        jpml, adjoint=True,
                                        attenuation=alpha, **kw)
        return jnp.sum(w * (uj.re[0] ** 2 + uj.im[0] ** 2))

    gre, gim = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jnp.asarray(rhs.real), jnp.asarray(rhs.imag))
    assert _rel(r.grad.numpy(), np.asarray(gre) + 1j * np.asarray(gim)) \
        < 1e-3
    for adjoint, att in ((False, None), (True, alpha)):
        u = born3d.born_solve_3d_diff(vel, rhs, GEN.F3, grid, pml,
                                      adjoint=adjoint, attenuation=att, **kw)
        plain, _ = born3d.born_gmres_solve_3d(
            vel, rhs, GEN.F3, grid, pml, adjoint=adjoint, tol=1e-6,
            maxiter=600, restart=16, attenuation=att)
        assert torch.equal(u, plain)


def test_lbfgs_3d_matches_jax(ref):
    """2 iterations of 3D L-BFGS: loss rtol 1e-2, velocity atol 0.5 m/s.
    Its second step is long (the peak moves ~85 m/s), so the solves are
    held at GMRES tol 1e-4: at the FWI default 2e-3 the two packages'
    solver errors move the velocity up to 0.73 m/s apart."""
    res = lbfgs.run_lbfgs_3d(_vel0(), _data(ref["m3_rec"]), GRID, PML,
                             iter_cap=GEN.CG3_CAP, tol=GEN.CG3_TOL,
                             num_iterations=GEN.M3_ITERS)
    np.testing.assert_allclose(res.loss_history.numpy(), ref["m3_lbfgs_loss"],
                               rtol=1e-2)
    np.testing.assert_allclose(res.velocity.numpy(), ref["m3_lbfgs_velocity"],
                               atol=0.5)


def test_gauss_newton_3d_matches_jax(ref):
    """One Gauss-Newton iteration over the 3D solve: loss, step and inner
    residual rtol 1e-2, equal backtracks, velocity atol 0.5 m/s."""
    vel, m = newton.run_gauss_newton_3d(
        _vel0(), _data(ref["m3_rec"]), GRID,
        FWIConfig(clip_velocity=GEN.CG3_CLIP), pml=PML,
        iter_cap=GEN.CG3_CAP, gmres_tol=GEN.M3_TOL, **GEN.M3_GN)
    np.testing.assert_allclose(m.loss.numpy(), ref["m3_gn_loss"], rtol=1e-2)
    np.testing.assert_allclose(m.step_size.numpy(), ref["m3_gn_step"],
                               rtol=1e-2)
    np.testing.assert_allclose(m.cg_relres.numpy(), ref["m3_gn_relres"],
                               rtol=1e-2)
    np.testing.assert_array_equal(m.backtracks.numpy(),
                                  ref["m3_gn_backtracks"])
    np.testing.assert_allclose(vel.numpy(), ref["m3_gn_velocity"], atol=0.5)


@pytest.mark.parametrize("method", ["alpha", "joint"])
def test_attenuation_3d_matches_jax(ref, method):
    """An iteration of the attenuation ("alpha", in the true medium) and
    joint inversions over data with a Gaussian absorber: loss rtol 1e-2,
    the velocity at atol 0.5 m/s and the attenuation map at atol 0.5 Np/m
    (of a 40 Np/m absorber)."""
    v0 = (torch.as_tensor(GEN.blob3d(GRID)) if method == "alpha"
          else _vel0())
    res = lbfgs.run_lbfgs_attenuation_3d(
        v0, torch.zeros(GRID.shape), _data(ref["m3_lossy_rec"]), GRID, PML,
        iter_cap=GEN.CG3_CAP, tol=GEN.M3_TOL,
        num_iterations=GEN.M3_ATT_ITERS, invert_velocity=(method == "joint"),
        **GEN.M3_ATT)
    np.testing.assert_allclose(res.loss_history.numpy(),
                               ref[f"m3_{method}_loss"], rtol=1e-2)
    np.testing.assert_allclose(res.velocity.numpy(),
                               ref[f"m3_{method}_velocity"], atol=0.5)
    np.testing.assert_allclose(res.attenuation.numpy(),
                               ref[f"m3_{method}_attenuation"], atol=0.5)


def test_calibration_3d_matches_jax(ref):
    """calibrate_background_speed_3d: c0 within 0.1 m/s, misfits rtol 1e-4
    at the same candidates; scattered-field data and a non-3D dataset
    raise."""
    data = _data(ref["m3_rec"])
    res = calibrate.calibrate_background_speed_3d(data, GRID, pml=PML,
                                                  **GEN.M3_CAL)
    np.testing.assert_array_equal(res.candidates, ref["m3_cal_candidates"])
    np.testing.assert_allclose(res.misfits, ref["m3_cal_misfits"], rtol=1e-4)
    assert res.c0 == pytest.approx(float(ref["m3_cal_c0"]), abs=0.1)
    with pytest.raises(ValueError, match="total-field"):
        calibrate.calibrate_background_speed_3d(
            data._replace(rec_ref=data.rec_obs), GRID, pml=PML)
    with pytest.raises(ValueError, match="num"):
        calibrate.calibrate_background_speed_3d(data, GRID, num=2)
    with pytest.raises(TypeError, match="FWIData3D"):
        calibrate.background_misfit_fn_3d(tuple(data), GRID)
