"""The port's GMRES and its shifted-Laplacian preconditioners held against
the JAX package on the CPU.

* The stencil symbol and the one-level preconditioner's parts against the
  JAX functions, live (eager, no compile).
* The GMRES operator solve, one- and two-level, forward and adjoint, on
  the 21x21 planes of tests/test_adjoint_vjp.py, against the JAX package's
  split path (the one the port follows) and against the port's banded
  direct solve, at the JAX package's bounds (tests/test_solvers.py:272,
  :304: forward 5e-3, adjoint 5e-2 on the interior).
* The gradient through the differentiable GMRES solve against the JAX
  package's and the banded one (tests/test_solvers.py:341: 2e-3 of the
  largest).
* GMRES's restart accounting, warm start and per-lane monotone guard.
* Two CG iterations with GMRES against the JAX package's CG on a 21x21
  ring, at the golden bounds.

The JAX results come from tests/golden/torch_solvers.npz (written by
``python tests/golden/generate_torch.py solvers``).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveforminversionust_tpu.ops import preconditioner as jpre
from waveforminversionust_tpu.ops import stencil as jstencil
from waveforminversionust_tpu_torch.config import (AcquisitionConfig,
                                                   FWIConfig, PMLConfig,
                                                   SolverConfig, SolverMethod)
from waveforminversionust_tpu_torch.data.synthesize import RingDataset
from waveforminversionust_tpu_torch.fwi.runner import invert_dataset
from waveforminversionust_tpu_torch.models.grid import Grid2D
from waveforminversionust_tpu_torch.ops import krylov, preconditioner
from waveforminversionust_tpu_torch.ops import solve as tsolve
from waveforminversionust_tpu_torch.ops.stencil import (
    boundary_mask, constant_stencil_symbol, constant_stencil_symbol_parts,
    stencil_params)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _load_generator():
    spec = importlib.util.spec_from_file_location(
        "generate_torch", os.path.join(GOLDEN, "generate_torch.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


GEN = _load_generator()
F = GEN.SOLVE_F


@pytest.fixture(scope="module")
def ref():
    """The JAX package's outputs (tests/golden/generate_torch.py solvers)."""
    return np.load(os.path.join(GOLDEN, "torch_solvers.npz"))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _grid():
    return Grid2D.centered(GEN.SOLVE_EXTENT, GEN.SOLVE_H)


def _gmres_cfg(**kw):
    return SolverConfig(method=SolverMethod.GMRES,
                        pml=PMLConfig(**GEN.SOLVE_PML), **kw)


def _interior(grid):
    return ~(boundary_mask(grid).numpy() > 0)


def test_stencil_symbol_matches_jax():
    """S0, S1 and the symbol of a shifted k^2 == the JAX package's (the
    same float32 DFT angles and cosines): rel < 1e-6."""
    grid = _grid()
    vel, _, _ = GEN.solve_problem()
    b, d, e = stencil_params(float(vel.min()), float(vel.max()), F, grid.h,
                             grid.aspect)
    nfy, nfx = 24, 30
    s0, s1 = constant_stencil_symbol_parts(b, d, e, grid.h, grid.aspect,
                                           nfy, nfx)
    j0, j1 = jstencil.constant_stencil_symbol_parts(
        float(b), float(d), float(e), grid.h, grid.aspect, nfy, nfx)
    assert s0.dtype == s1.dtype == torch.float32
    assert _rel(s0, j0) < 1e-6 and _rel(s1, j1) < 1e-6
    k2 = np.complex64(2.1e6 - 1.05e6j)
    sym = constant_stencil_symbol(torch.tensor(k2), b, d, e, grid.h,
                                  grid.aspect, nfy, nfx)
    jsym = jstencil.constant_stencil_symbol(jnp.asarray(k2), float(b),
                                            float(d), float(e), grid.h,
                                            grid.aspect, nfy, nfx)
    assert sym.dtype == torch.complex64 and _rel(sym, jsym) < 1e-6


@pytest.mark.parametrize("adjoint", [False, True])
def test_fft_preconditioner_matches_jax(adjoint):
    """shifted_k2 and M^-1 (or M^-H) on seeded fields == the JAX package's:
    rel < 1e-6 and < 1e-5; the FFT grid is the 5-smooth size."""
    grid = _grid()
    vel, _, _ = GEN.solve_problem()
    sign = 1.0 if adjoint else -1.0
    k2 = preconditioner.shifted_k2(torch.as_tensor(vel), F, 0.5, sign)
    jk2 = jpre.shifted_k2(jnp.asarray(vel), F, 0.5, sign)
    assert _rel(k2, jk2) < 1e-6
    _, params = tsolve.build_operator(torch.as_tensor(vel), F, grid,
                                      _gmres_cfg(), adjoint=adjoint)
    jparams = jpre.PrecondParams(*(jnp.asarray(p.numpy()) for p in params))
    rng = np.random.default_rng(1)
    v = (rng.standard_normal((2,) + grid.shape)
         + 1j * rng.standard_normal((2,) + grid.shape)).astype(np.complex64)
    got = preconditioner.make_fft_preconditioner(grid, params, adjoint)(
        torch.as_tensor(v))
    want = jpre.make_fft_preconditioner(grid, jparams, adjoint)(
        jnp.asarray(v))
    assert got.shape == v.shape and _rel(got, want) < 1e-5
    assert [preconditioner.good_fft_size(n) for n in (21, 61, 151, 301)] \
        == [jpre.good_fft_size(n) for n in (21, 61, 151, 301)] \
        == [24, 64, 160, 320]


def test_restrict_prolong_match_jax():
    """Full weighting and bilinear prolongation == the JAX package's axis
    operators (exact arithmetic on the same float32 values: rel < 1e-7);
    the coarse grid keeps the corners and odd fine dimensions only."""
    grid = _grid()
    rng = np.random.default_rng(2)
    v = (rng.standard_normal((2,) + grid.shape)
         + 1j * rng.standard_normal((2,) + grid.shape)).astype(np.complex64)
    t = torch.as_tensor(v)
    rc = preconditioner._restrict_axis(preconditioner._restrict_axis(t, -2),
                                       -1)
    jrc = jpre._restrict_axis(jpre._restrict_axis(jnp.asarray(v), -2), -1)
    assert rc.shape == (2, 11, 11) and _rel(rc, jrc) < 1e-7
    pf = preconditioner._prolong_axis(
        preconditioner._prolong_axis(rc, -2, grid.ny), -1, grid.nx)
    jpf = jpre._prolong_axis(jpre._prolong_axis(jrc, -2, grid.ny), -1,
                             grid.nx)
    assert pf.shape == v.shape and _rel(pf, jpf) < 1e-7
    gc = preconditioner.coarse_grid(grid)
    assert (gc.nx, gc.ny, gc.dx, gc.x0) == (11, 11, 2 * grid.dx, grid.x0)
    with pytest.raises(ValueError, match="odd"):
        preconditioner.coarse_grid(Grid2D.centered(8e-3, 0.8e-3, 8.4e-3))


# Bound against the JAX package's split path, measured 2.1e-6 to 6.2e-6
# (both runs stop at the same 1e-5 residual; their iterates differ by FP32
# sums taken in other orders).
JAX_BOUND = 1e-4


@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("two_level", [False, True])
def test_gmres_operator_solve_matches_jax_and_banded(ref, two_level,
                                                     adjoint):
    """helmholtz_operator_solve with GMRES (tol 1e-5) == the JAX package's
    split GMRES operator path within JAX_BOUND, and == the port's banded
    solve within the JAX package's bounds (forward 5e-3; adjoint 5e-2 on
    the interior: the Dirichlet ring of an iterative adjoint solve is
    solver-floor noise, tests/test_solvers.py:208-253). Two-level: the
    operator carries the coarse 11x11 block-Thomas factor."""
    grid = _grid()
    vel, src, _ = GEN.solve_problem()
    cfg = _gmres_cfg(tol=GEN.GMRES_TOL, maxiter=GEN.GMRES_MAXITER,
                     gmres_two_level=two_level)
    op = tsolve.make_helmholtz_operator(torch.as_tensor(vel), F, grid, cfg)
    assert op.precond is not None
    if two_level:
        assert tuple(op.factor.g.shape) == (11, 11, 11)
    else:
        assert op.factor is None
    u = tsolve.helmholtz_operator_solve(op, torch.as_tensor(src), grid, cfg,
                                        adjoint=adjoint).numpy()
    banded = SolverConfig(pml=cfg.pml)
    opb = tsolve.make_helmholtz_operator(torch.as_tensor(vel), F, grid,
                                         banded)
    ub = tsolve.helmholtz_operator_solve(opb, torch.as_tensor(src), grid,
                                         banded, adjoint=adjoint).numpy()
    want = ref[f"gmres_op_{int(two_level)}_{int(adjoint)}"]
    if adjoint:
        inner = _interior(grid)
        u, ub, want = u[:, inner], ub[:, inner], want[:, inner]
    assert _rel(u, want) < JAX_BOUND
    assert _rel(u, ub) < (5e-2 if adjoint else 5e-3)


def test_gmres_warm_start_and_x0(monkeypatch):
    """A warm start x0 at the converged solution needs no cycle: the
    operator solve returns it after one residual check."""
    grid = _grid()
    vel, src, _ = GEN.solve_problem()
    cfg = _gmres_cfg(tol=GEN.GMRES_TOL, maxiter=GEN.GMRES_MAXITER)
    op = tsolve.make_helmholtz_operator(torch.as_tensor(vel), F, grid, cfg)
    u = tsolve.helmholtz_operator_solve(op, torch.as_tensor(src), grid, cfg)
    calls = []
    real = krylov.gmres

    def spy(*a, **k):
        res = real(*a, **k)
        calls.append(res.iterations)
        return res

    monkeypatch.setattr(tsolve, "gmres", spy)
    again = tsolve.helmholtz_operator_solve(op, torch.as_tensor(src), grid,
                                            cfg, x0=u)
    assert calls == [0] and torch.equal(again, u)


def test_gmres_gradient_matches_jax_and_banded(ref):
    """d/dvel of sum |u|^2 w through the differentiable GMRES solve == the
    JAX package's split GMRES gradient (tol 1e-7, the JAX test's) and the
    port's banded one, within 2e-3 of the largest entry
    (tests/test_solvers.py:341). The port solves to 1e-6, which FP32
    reaches within the cap; measured 2.8e-6 and 5.0e-7 of the largest at
    1e-7."""
    grid = _grid()
    vel, src, weight = GEN.solve_problem()

    def grad(cfg):
        v = torch.tensor(vel, requires_grad=True)
        u, _ = tsolve.solve_helmholtz(v, torch.as_tensor(src), F, grid, cfg)
        torch.sum(torch.abs(u) ** 2 * torch.as_tensor(weight)).backward()
        return v.grad.numpy()

    g = grad(_gmres_cfg(tol=1e-6, maxiter=GEN.GRAD_MAXITER))
    gb = grad(SolverConfig(pml=PMLConfig(**GEN.SOLVE_PML)))
    want = ref["gmres_gv"]
    np.testing.assert_allclose(g, want, atol=2e-3 * np.abs(want).max())
    np.testing.assert_allclose(g, gb, atol=2e-3 * np.abs(gb).max())


def test_gmres_restarts_and_monotone_guard():
    """GMRES on a diagonal system: the matvec count advances restart + 1 a
    cycle and stops at the first count >= maxiter; a zero right-hand side
    stays zero and finite (its QR breaks down and the monotone guard keeps
    the old iterate); a converged lane meets tol; a warm start at the
    solution runs no cycle."""
    rng = np.random.default_rng(3)
    diag = torch.as_tensor((1.0 + rng.uniform(0, 1e3, (4, 5, 6))
                            ).astype(np.complex64))
    b = torch.as_tensor((rng.standard_normal((4, 5, 6))
                         + 1j * rng.standard_normal((4, 5, 6))
                         ).astype(np.complex64))
    b[2] = 0
    res = krylov.gmres(lambda v: diag * v, b, tol=1e-5, maxiter=34,
                       restart=4)
    assert res.iterations == 35
    assert torch.all(torch.isfinite(res.x)) and torch.all(res.x[2] == 0)
    full = krylov.gmres(lambda v: diag * v, b, tol=1e-5, maxiter=10000,
                        restart=4)
    assert full.iterations % 5 == 0
    x = full.x
    lanes = [0, 1, 3]
    assert float(torch.max(full.rel_residual[lanes])) <= 1e-5
    assert _rel(x[lanes], (b / diag)[lanes]) < 1e-4
    warm = krylov.gmres(lambda v: diag * v, b, x0=b / diag, tol=1e-5)
    assert warm.iterations == 0


def test_cg_gmres_matches_jax(ref):
    """invert_dataset, 2 CG iterations with GMRES (tol 1e-6, every solve
    converged) on the 21x21 ring == the JAX package's at the golden bounds
    (loss and step rtol 1e-2, velocity atol 0.5 m/s). Velocity is compared
    off the Dirichlet ring, where GMRES's adjoint is solver-floor noise
    (tests/test_solvers.py:208-253): there the two runs differ by up to
    0.63 m/s, in the interior by 0.0056 m/s; losses by 2.4e-5, steps by
    5.4e-5."""
    grid = Grid2D.centered(GEN.KRING_EXTENT, GEN.H)
    ds = RingDataset(x=grid.x, y=grid.y, c=ref["kring_c"],
                     x_circ=ref["kring_x_circ"], y_circ=ref["kring_y_circ"],
                     f=GEN.KRING_F, rec_data=ref["kring_rec"])
    res = invert_dataset(
        ds, grid=grid, acquisition=AcquisitionConfig(**GEN.KRING_ACQ),
        solver=SolverConfig(method=SolverMethod.GMRES, tol=GEN.KRING_TOL,
                            maxiter=GEN.KRING_MAXITER,
                            pml=PMLConfig(l_pml=GEN.KRING_PML)),
        fwi=FWIConfig(num_iterations=2), device="cpu")
    np.testing.assert_allclose(res.metrics["loss"], ref["cg_gmres_loss"],
                               rtol=1e-2)
    np.testing.assert_allclose(res.metrics["step_size"],
                               ref["cg_gmres_step"], rtol=1e-2)
    inner = _interior(grid)
    np.testing.assert_allclose(res.velocity[inner],
                               ref["cg_gmres_velocity"][inner], atol=0.5)
