"""The port's convergent Born series held against the JAX package on the
CPU: the Born operator (live), the plain and Krylov series solves forward
and adjoint, lossless and lossy, and the gradients of the differentiable
Born solve in vel, src and the attenuation map (from
tests/golden/torch_solvers.npz), all on tests/test_solvers.py's 61x61 blob;
the adjoint dot-product identity (tests/test_solvers.py:153-175); the
operator path; and two CG iterations with Born on a 21x21 ring at the
golden bounds.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveforminversionust_tpu import Grid2D as JGrid
from waveforminversionust_tpu.ops import born as jborn
from waveforminversionust_tpu_torch.config import (AcquisitionConfig,
                                                   FWIConfig, PMLConfig,
                                                   SolverConfig, SolverMethod)
from waveforminversionust_tpu_torch.data.synthesize import RingDataset
from waveforminversionust_tpu_torch.fwi.runner import invert_dataset
from waveforminversionust_tpu_torch.models.grid import Grid2D
from waveforminversionust_tpu_torch.ops import born
from waveforminversionust_tpu_torch.ops import solve as tsolve

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _load_generator():
    spec = importlib.util.spec_from_file_location(
        "generate_torch", os.path.join(GOLDEN, "generate_torch.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


GEN = _load_generator()
F = GEN.SOLVE_F
CFG = SolverConfig(method=SolverMethod.BORN)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's outputs (tests/golden/generate_torch.py solvers)."""
    return np.load(os.path.join(GOLDEN, "torch_solvers.npz"))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _grid():
    return Grid2D.centered(GEN.BORN_EXTENT, 0.8e-3)


def _alpha(vel):
    return np.full(vel.shape, GEN.ALPHA_BORN, np.float32)


@pytest.mark.parametrize("adjoint", [False, True])
def test_born_operator_matches_jax(adjoint):
    """The potential, gamma, the iteration heuristic and the Green's
    operator on seeded fields == the JAX package's born_operator (lossy):
    rel < 1e-5 (measured 2e-7 to 8e-7)."""
    vel, _ = GEN.born_problem()
    alpha = _alpha(vel)
    greens, v_pot, gamma, n = born.born_operator(
        torch.as_tensor(vel), F, _grid(), CFG.born_pml, adjoint,
        attenuation=torch.as_tensor(alpha))
    jg, jv, jgam, jn = jborn.born_operator(
        vel, F, JGrid.centered(GEN.BORN_EXTENT, 0.8e-3), CFG.born_pml,
        adjoint, attenuation=alpha)
    assert _rel(v_pot, jv) < 1e-5 and _rel(gamma, jgam) < 1e-5
    assert float(n) == float(jn)
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((2,) + vel.shape)
         + 1j * rng.standard_normal((2,) + vel.shape)).astype(np.complex64)
    got = greens(torch.as_tensor(w))
    assert got.dtype == torch.complex64
    assert _rel(got, jg(jnp.asarray(w))) < 1e-5


@pytest.mark.parametrize("lossy", [False, True])
@pytest.mark.parametrize("adjoint", [False, True])
def test_born_gmres_solve_matches_jax(ref, adjoint, lossy):
    """born_gmres_solve == the JAX package's (tol 1e-5, cap 600): the same
    matvec count, fields within rel 1e-4 (measured ~4e-6)."""
    vel, src = GEN.born_problem()
    u, n = born.born_gmres_solve(
        torch.as_tensor(vel), torch.as_tensor(src), F, _grid(), CFG.born_pml,
        adjoint=adjoint,
        attenuation=torch.as_tensor(_alpha(vel)) if lossy else None)
    key = f"{int(adjoint)}_{int(lossy)}"
    assert n == int(ref[f"born_gmres_n_{key}"])
    assert _rel(u, ref[f"born_gmres_{key}"]) < 1e-4


@pytest.mark.parametrize("adjoint", [False, True])
def test_born_series_solve_matches_jax(ref, adjoint):
    """The plain series: the same host-read iteration count, fields within
    rel 1e-4 (measured ~4e-6)."""
    vel, src = GEN.born_problem()
    u, n = born.born_series_solve(torch.as_tensor(vel), torch.as_tensor(src),
                                  F, _grid(), CFG.born_pml, adjoint=adjoint)
    assert n == int(ref[f"born_series_n_{int(adjoint)}"])
    assert _rel(u, ref[f"born_series_{int(adjoint)}"]) < 1e-4


def test_born_adjoint_dot_identity():
    """<A^-1 s, t> == <s, A^-H t> for the series solve (the JAX package's
    bound, tests/test_solvers.py:153-175: rel < 2e-2)."""
    grid = Grid2D.centered(24e-3, 0.8e-3)
    vel, _ = GEN.born_problem()
    rng = np.random.default_rng(5)
    shape = (1,) + grid.shape
    s, t = ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
             ).astype(np.complex64) for _ in range(2))
    u, _ = born.born_series_solve(torch.as_tensor(vel), torch.as_tensor(s),
                                  F, grid, CFG.born_pml)
    w, _ = born.born_series_solve(torch.as_tensor(vel), torch.as_tensor(t),
                                  F, grid, CFG.born_pml, adjoint=True)
    lhs = complex(torch.vdot(torch.as_tensor(t).reshape(-1), u.reshape(-1)))
    rhs = complex(torch.vdot(w.reshape(-1), torch.as_tensor(s).reshape(-1)))
    assert abs(lhs - rhs) / abs(lhs) < 2e-2


@pytest.mark.parametrize("adjoint", [False, True])
def test_born_gradients_match_jax(ref, adjoint):
    """d/dvel and d/dsrc of sum |u|^2 w through the differentiable Born
    solve, and d/dvel and d/dalpha in the lossy medium (alpha 3 Np/m) ==
    jax.grad through the JAX package's custom VJPs: rel < 1e-4 (measured
    ~1e-6). PyTorch hands back dL/d conj(src), the conjugate of
    jax.grad's."""
    vel, src = GEN.born_problem()
    weight = torch.as_tensor(
        1.0 + 0.3 * np.cos(np.arange(src.size, dtype=np.float32)
                           ).reshape(src.shape))

    def grads(lossy):
        v = torch.tensor(vel, requires_grad=True)
        s = torch.tensor(src, requires_grad=True)
        a = torch.tensor(_alpha(vel), requires_grad=True)
        u, info = tsolve.solve_helmholtz(v, s, F, _grid(), CFG,
                                         adjoint=adjoint,
                                         attenuation=a if lossy else None)
        assert torch.all(info.rel_residual == 0)
        torch.sum(torch.abs(u) ** 2 * weight).backward()
        return v.grad.numpy(), s.grad.numpy(), a.grad

    k = int(adjoint)
    gv, gs, ga = grads(False)
    assert ga is None
    assert _rel(gv, ref[f"born_gv_{k}"]) < 1e-4
    assert _rel(gs, np.conj(ref[f"born_gs_{k}"])) < 1e-4
    gv, _, ga = grads(True)
    assert _rel(gv, ref[f"born_lossy_gv_{k}"]) < 1e-4
    assert _rel(ga.numpy(), ref[f"born_lossy_ga_{k}"]) < 1e-4


@pytest.mark.parametrize("krylov", [True, False])
def test_born_operator_path(krylov):
    """make_helmholtz_operator + helmholtz_operator_solve under Born give
    solve_helmholtz's fields bit for bit, forward and adjoint; the operator
    carries no factor and no preconditioner, and ``born_krylov=False``
    runs the plain series."""
    vel, src = GEN.born_problem()
    cfg = SolverConfig(method=SolverMethod.BORN, born_krylov=krylov)
    grid = _grid()
    op = tsolve.make_helmholtz_operator(torch.as_tensor(vel), F, grid, cfg)
    assert op.factor is None and op.precond is None
    fields = []
    for adjoint in (False, True):
        u = tsolve.helmholtz_operator_solve(op, torch.as_tensor(src), grid,
                                            cfg, adjoint=adjoint)
        v, _ = tsolve.solve_helmholtz(torch.as_tensor(vel),
                                      torch.as_tensor(src), F, grid, cfg,
                                      adjoint=adjoint)
        assert torch.equal(u, v)
        fields.append(u)
    if not krylov:
        want, _ = born.born_series_solve(torch.as_tensor(vel),
                                         torch.as_tensor(src), F, grid,
                                         cfg.born_pml)
        assert torch.equal(fields[0], want)


def test_cg_born_matches_jax(ref):
    """invert_dataset, 2 CG iterations with Born on the 21x21 ring == the
    JAX package's at the golden bounds (loss and step rtol 1e-2, velocity
    atol 0.5 m/s; measured 3.0e-6, 1.1e-5 and 0.014 m/s)."""
    grid = Grid2D.centered(GEN.KRING_EXTENT, GEN.H)
    ds = RingDataset(x=grid.x, y=grid.y, c=ref["kring_c"],
                     x_circ=ref["kring_x_circ"], y_circ=ref["kring_y_circ"],
                     f=GEN.KRING_F, rec_data=ref["kring_rec"])
    res = invert_dataset(
        ds, grid=grid, acquisition=AcquisitionConfig(**GEN.KRING_ACQ),
        solver=SolverConfig(method=SolverMethod.BORN,
                            pml=PMLConfig(l_pml=GEN.KRING_PML)),
        fwi=FWIConfig(num_iterations=2), device="cpu")
    np.testing.assert_allclose(res.metrics["loss"], ref["cg_born_loss"],
                               rtol=1e-2)
    np.testing.assert_allclose(res.metrics["step_size"], ref["cg_born_step"],
                               rtol=1e-2)
    np.testing.assert_allclose(res.velocity, ref["cg_born_velocity"],
                               atol=0.5)
