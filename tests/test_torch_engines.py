"""The port's opt-in direct engines (twisted, cyclic reduction) held against
the JAX package on the CPU.

Inputs are made with numpy from a seed (the input functions of
tests/golden/generate_torch.py) and fed to both packages (the port through
``interop``). Where the JAX side has a Pallas kernel it ran in interpret
mode, as tests/test_twisted.py and tests/test_batched_inv.py run it. On CPU
tensors the port's wrappers take their plain versions; the CUDA kernels are
held against those on a card (tests/test_torch_kernels.py).

The JAX results come from tests/golden/torch_engines.npz (``python
tests/golden/generate_torch.py engines``), but for one live comparison an
engine: ``test_twisted_matches_jax[12-9-1]`` and ``test_cr_matches_jax[2]``
run the JAX package here, each reference call under one ``jax.jit``.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from waveforminversionust_tpu.models.phantom import smooth_blob_phantom
from waveforminversionust_tpu_torch import interop
from waveforminversionust_tpu_torch.config import (AcquisitionConfig,
                                                   FWIConfig, PMLConfig,
                                                   SolverConfig)
from waveforminversionust_tpu_torch.fwi import objective as tobj
from waveforminversionust_tpu_torch.fwi import optimizers as topt
from waveforminversionust_tpu_torch.fwi.runner import invert_dataset
from waveforminversionust_tpu_torch.models.acquisition import \
    build_ring_acquisition
from waveforminversionust_tpu_torch.models.grid import Grid2D
from waveforminversionust_tpu_torch.ops import apply, batched_inv, cyclic
from waveforminversionust_tpu_torch.ops import solve as tsolve
from waveforminversionust_tpu_torch.ops import twisted
from waveforminversionust_tpu_torch.ops.stencil import helmholtz_coefficients

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _load_generator():
    spec = importlib.util.spec_from_file_location(
        "generate_torch", os.path.join(GOLDEN, "generate_torch.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


GEN = _load_generator()
F = GEN.EN_F
LIVE_TWISTED = (12, 9, 1)   # the live JAX comparison of each engine
LIVE_CR = 2


@pytest.fixture(scope="module")
def ref():
    """The JAX package's outputs (tests/golden/generate_torch.py
    engines)."""
    return np.load(os.path.join(GOLDEN, "torch_engines.npz"))


_cplx = GEN.en_cplx


def _t(z):
    return interop.complex_tensor(np.asarray(z))


def _pair(z):
    """A complex array as the (re, im) float32 pair interop takes."""
    z = np.asarray(z)
    return z.real.astype(np.float32), z.imag.astype(np.float32)


def _max_rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _fro_rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


_random_planes = GEN.en_random_planes


# -- twisted ---------------------------------------------------------------

@pytest.mark.parametrize("ny,nx,m", GEN.EN_TWISTED)
def test_twisted_matches_jax(ref, ny, nx, m):
    """Plain twisted factor and solves == twisted_factor_cpx /
    twisted_solve_cpx on the same random planes, every middle row the
    reference tests, forward and adjoint: max-rel 5e-5 (its own bound
    against block-Thomas). LIVE_TWISTED runs the JAX package here."""
    planes, b = GEN.en_twisted_case(ny, nx, m)
    if (ny, nx, m) == LIVE_TWISTED:
        from waveforminversionust_tpu.ops import cpx
        jfac, refs = GEN.en_twisted_reference(planes, b, m)
        m_ref, g_ref = jfac.m, cpx.to_numpy(jfac.g)
        refs = [cpx.to_numpy(r) for r in refs]
    else:
        key = f"tw_{ny}_{nx}_{m}"
        m_ref, g_ref = int(ref[f"{key}_m"]), ref[f"{key}_g"]
        refs = [ref[f"{key}_fwd"], ref[f"{key}_adj"]]
    fac = twisted.twisted_factor(_t(planes), m)
    assert fac.m == m_ref
    assert _max_rel(fac.g.numpy(), g_ref) < 5e-5
    for adjoint, want in zip((False, True), refs):
        out = twisted.twisted_solve(fac, _t(b), adjoint).numpy()
        assert _max_rel(out, want) < 5e-5, adjoint


def test_twisted_rejects_middle_rows_out_of_range():
    planes = _t(_random_planes(9, 8))
    for bad in (0, 8):
        with pytest.raises(ValueError, match="out of range"):
            twisted.twisted_factor(planes, bad)


@pytest.mark.parametrize("adjoint", [False, True])
def test_twisted_residual_helmholtz(adjoint):
    """True residual of the plain twisted solve on Helmholtz planes (the
    indefinite operator; the 41x37 grid, blob and PML of
    tests/test_twisted.py): < 2e-5."""
    ny, nx = 41, 37
    grid = Grid2D(nx=nx, ny=ny, dx=0.8e-3, dy=0.8e-3,
                  x0=-(nx - 1) * 0.4e-3, y0=-(ny - 1) * 0.4e-3)
    vel = 1500.0 + 40.0 * np.exp(
        -((np.arange(ny)[:, None] - ny / 2) ** 2
          + (np.arange(nx)[None, :] - nx / 2) ** 2) / 40.0)
    coeffs = helmholtz_coefficients(torch.as_tensor(vel, dtype=torch.float32),
                                    grid, F, PMLConfig(l_pml=4e-3))
    b = _t(_cplx(np.random.default_rng(1), (2, ny, nx)))
    x = twisted.twisted_solve(twisted.twisted_factor(coeffs), b, adjoint)
    hx = (apply.h_apply_adjoint if adjoint else apply.h_apply)(coeffs, x)
    assert _fro_rel(hx.numpy(), b.numpy()) < 2e-5


@pytest.mark.parametrize("ny", [12, 13])
def test_interop_twisted_factor_layouts(ref, ny):
    """interop.twisted_factor from the fused kernel's g_down / g_up
    block-step layout (interpret mode; padded to the panel width) == the
    one from the oracle's row-ordered g, and both solve like the port's own
    factor: 5e-5."""
    nx = 9
    planes = _random_planes(ny, nx, seed=5)
    key = f"lay_{ny}"
    g_down = ref[f"{key}_g_down"]
    assert g_down.shape[-1] > nx
    rows = interop.twisted_factor(*_pair(planes), int(ref[f"{key}_m"]),
                                  g=_pair(ref[f"{key}_g"]))
    steps = interop.twisted_factor(*_pair(planes), int(ref[f"{key}_fused_m"]),
                                   g_down=_pair(g_down),
                                   g_up=_pair(ref[f"{key}_g_up"]))
    assert rows.m == steps.m == twisted.middle_row(ny)
    assert steps.g.shape == rows.g.shape == (ny, nx, nx)
    for y in range(ny):
        assert _max_rel(steps.g[y].numpy(), rows.g[y].numpy()) < 5e-5, y
    b = _t(_cplx(np.random.default_rng(2), (2, ny, nx)))
    own = twisted.twisted_solve(twisted.twisted_factor(_t(planes)), b)
    assert _max_rel(twisted.twisted_solve(steps, b).numpy(), own.numpy()) < 5e-5


# -- batched inverse -------------------------------------------------------

_random_batch = GEN.en_random_batch


def _batch_rel(got, want):
    n = got.shape[0]
    return float((np.linalg.norm((got - want).reshape(n, -1), axis=1)
                  / np.linalg.norm(want.reshape(n, -1), axis=1)).max())


@pytest.mark.parametrize("b", GEN.EN_PIVOT)
def test_pivot_inverse_matches_jax(ref, b):
    """_batched_pivot_inv (K5's plain version) == the Pallas kernel in
    interpret mode, the XLA pivot loop and numpy complex128: 5e-5; and a
    Dirichlet-scale pivot (1.5625e6) is inverted without cancellation."""
    a = _random_batch(np.random.default_rng(3), 6, b)
    out = batched_inv._batched_pivot_inv(_t(a)).numpy()
    want = np.linalg.inv(a.astype(np.complex128))
    assert _batch_rel(out, want) < 5e-5
    assert _batch_rel(out, ref[f"piv_{b}_pallas"]) < 5e-5
    assert _batch_rel(out, ref[f"piv_{b}_xla"]) < 5e-5
    d = (1.5625e6 * np.eye(b)).astype(np.complex64)[None]
    got = batched_inv._batched_pivot_inv(_t(d)).numpy()[0]
    np.testing.assert_allclose(got, np.eye(b) / 1.5625e6, rtol=1e-6)


@pytest.mark.parametrize("n,block", GEN.EN_BATCHED)
def test_batched_inv_matches_jax(ref, n, block):
    """The blocked Gauss-Jordan (identity padding, panels, overwrites) ==
    batched_inv(pivot="xla") and numpy complex128: 5e-5. The port's own
    pivot="xla" gives the bits of its default on a CPU tensor."""
    a = _random_batch(np.random.default_rng(4), 5, n)
    out = batched_inv.batched_inv(_t(a), block=block).numpy()
    np.testing.assert_array_equal(
        batched_inv.batched_inv(_t(a), block=block, pivot="xla").numpy(), out)
    assert out.shape == a.shape
    assert _batch_rel(out, np.linalg.inv(a.astype(np.complex128))) < 5e-5
    assert _batch_rel(out, ref[f"inv_{n}_{block}"]) < 5e-5


# -- cyclic reduction ------------------------------------------------------

@pytest.mark.parametrize("ny", GEN.EN_CR)
def test_cr_matches_jax(ref, ny):
    """cr_factor / cr_solve == cr_factor_cpx / cr_solve_cpx, level by level
    and in the solution, forward and adjoint: 1e-4 (tests/test_cyclic.py's
    bound). The JAX factor carried across by interop.cr_factor solves the
    same through the port's cr_solve. LIVE_CR runs the JAX package here."""
    planes, b = GEN.en_cr_case(ny)
    if ny == LIVE_CR:
        from waveforminversionust_tpu.ops import cpx
        jfac, refs = GEN.en_cr_reference(planes, b)
        levels = [[_pair(cpx.to_numpy(part)) for part in lev]
                  for lev in jfac.levels]
        dinv_root = cpx.to_numpy(jfac.dinv_root)
        refs = [cpx.to_numpy(r) for r in refs]
    else:
        key = f"cr_{ny}"
        levels = [[_pair(ref[f"{key}_lev{i}_{j}"])
                   for j in range(len(cyclic.CRLevel._fields))]
                  for i in range(int(ref[f"{key}_levels"]))]
        dinv_root = ref[f"{key}_dinv_root"]
        refs = [ref[f"{key}_fwd"], ref[f"{key}_adj"]]
    fac = cyclic.cr_factor(_t(planes), block=8)
    carried = interop.cr_factor(levels, _pair(dinv_root), *_pair(planes))
    assert len(fac.levels) == len(levels) == len(carried.levels)
    for lev, clev in zip(fac.levels, carried.levels):
        for name in cyclic.CRLevel._fields:
            got, ref = getattr(lev, name).numpy(), getattr(clev, name).numpy()
            assert got.shape == ref.shape
            assert np.abs(got - ref).max() < 1e-4 * max(np.abs(ref).max(), 1.0)
    assert _max_rel(fac.dinv_root.numpy(), carried.dinv_root.numpy()) < 1e-4
    for adjoint, want in zip((False, True), refs):
        assert _fro_rel(cyclic.cr_solve(fac, _t(b), adjoint).numpy(),
                        want) < 1e-4
        assert _fro_rel(cyclic.cr_solve(carried, _t(b), adjoint).numpy(),
                        want) < 1e-4


# -- the solves ------------------------------------------------------------

EXTENT = GEN.EN_EXTENT   # 41x41 at 0.8 mm
PML = GEN.EN_PML
ENGINE_TOL = {"twisted": 5e-5, "cr": 5e-4}  # the JAX tests' own bounds


@pytest.mark.parametrize("factorization", ["twisted", "cr"])
def test_solve_helmholtz_engines_match_jax(ref, factorization):
    """solve_helmholtz through each engine == the JAX package's through the
    same engine (split_complex=True), forward and adjoint: 5e-5 twisted,
    5e-4 cr (the bounds of tests/test_twisted.py and tests/test_cyclic.py);
    the reported true residual < 1e-4.

    Each package builds its own planes, and the JAX package's FP32 fit of
    the stencil's (d, e) moves by a few 1e-5 with the order XLA takes its
    sums in (test_torch_ops.py::test_stencil_params_match): compiled whole,
    its twisted solve sits 5.2e-5 from the port's, past the twisted bound,
    so the generator runs that reference op by op, as test_torch_ops.py
    runs it (1.4e-5)."""
    tg = Grid2D.centered(EXTENT, 0.8e-3)
    vel = smooth_blob_phantom(tg, radius=EXTENT / 3, dc=60)
    src = _cplx(np.random.default_rng(7), (2,) + tg.shape)
    tcfg = SolverConfig(factorization=factorization, pml=PMLConfig(**PML))
    for adjoint in (False, True):
        want = ref[f"solve_{factorization}_{'adj' if adjoint else 'fwd'}"]
        out, info = tsolve.solve_helmholtz(torch.as_tensor(vel), _t(src), F,
                                           tg, tcfg, adjoint=adjoint)
        assert _fro_rel(out.numpy(), want) < ENGINE_TOL[factorization]
        assert float(info.rel_residual.max()) < 1e-4


@pytest.mark.parametrize("factorization", ["auto", "twisted", "cr"])
def test_operator_api_serves_every_factor_type(monkeypatch, factorization):
    """The operator API with each factor type: forward and adjoint solves
    agree with block-Thomas (5e-4), and the frozen-factor structure holds
    (test_torch_ops.py::test_stale_factor_is_reused_whole, per engine): a
    stale factor is swept whole, by the solve of its own type whatever the
    configuration says, while refinement targets the current planes and
    brings the stale solve closer to the current operator's."""
    tg = Grid2D.centered(EXTENT, 0.8e-3)
    cfg = SolverConfig(factorization=factorization, pml=PMLConfig(**PML))
    thomas = dataclasses.replace(cfg, factorization="thomas")
    vel0 = torch.as_tensor(smooth_blob_phantom(tg, radius=EXTENT / 3, dc=60))
    stale = tsolve.make_helmholtz_operator(vel0, F, tg, cfg)
    current = tsolve.make_helmholtz_operator(vel0 * 1.01, F, tg, cfg)
    want = {"auto": tsolve.BandedFactor, "twisted": tsolve.TwistedFactor,
            "cr": tsolve.CRFactor}[factorization]
    assert isinstance(stale.factor, want)
    src = _t(_cplx(np.random.default_rng(8), (2,) + tg.shape))
    op = current._replace(factor=stale.factor)  # what the CG loop builds
    # a factor keeps its engine under another configuration's dispatch
    assert tsolve._sweeps(stale.factor, SolverConfig()) is \
        tsolve._sweeps(stale.factor, cfg)

    seen = []
    make_apply = tsolve.make_apply

    def spy_apply(coeffs, cfg_, adjoint=False):
        seen.append(coeffs)
        return make_apply(coeffs, cfg_, adjoint)

    monkeypatch.setattr(tsolve, "make_apply", spy_apply)
    ref_op = tsolve.make_helmholtz_operator(vel0 * 1.01, F, tg, thomas)
    for adjoint in (False, True):
        exact = tsolve.helmholtz_operator_solve(current, src, tg, cfg,
                                                adjoint=adjoint)
        ref = tsolve.helmholtz_operator_solve(ref_op, src, tg, thomas,
                                              adjoint=adjoint)
        assert _fro_rel(exact.numpy(), ref.numpy()) < 5e-4
        seen.clear()
        refined = tsolve.helmholtz_operator_solve(op, src, tg, cfg,
                                                  adjoint=adjoint,
                                                  extra_refine=True)
        assert len(seen) == 1 and seen[0] is current.coeffs
        plain = tsolve.helmholtz_operator_solve(op, src, tg, cfg,
                                                adjoint=adjoint)
        assert _fro_rel(refined.numpy(), exact.numpy()) < \
            0.5 * _fro_rel(plain.numpy(), exact.numpy())


# -- the slice as a whole ----------------------------------------------------

TINY_F = GEN.EN_TINY_F
TINY_ACQ = GEN.EN_TINY_ACQ


@pytest.fixture(scope="module")
def tiny_ring(ref):
    """41x41 grid, 8-element ring, data synthesized by the JAX package (the
    ring of tests/test_torch_fwi.py), as the port's RingDataset."""
    return interop.ring_dataset(*(ref[f"ring_{k}"] for k in (
        "x", "y", "c", "x_circ", "y_circ", "f", "rec_data")))


@pytest.mark.parametrize("factorization", ["twisted", "cr"])
def test_nonlinear_cg_engines_match_jax(ref, tiny_ring, factorization):
    """3 iterations with refactor_every=2 (factored, stale with the extra
    refinement pass, factored) through each engine == the JAX package's
    nonlinear_cg through the same engine on the same data: loss and step
    rtol 1e-2, velocity atol 0.5 m/s (the golden bounds)."""
    grid = Grid2D.centered(EXTENT, 0.8e-3)
    tds = tiny_ring
    acq = build_ring_acquisition(grid, AcquisitionConfig(**TINY_ACQ),
                                 x_elem=tds.x_circ, y_elem=tds.y_circ)
    data = tobj.build_fwi_data(acq, tds.rec_data, TINY_F, device="cpu")
    port = topt.nonlinear_cg(
        torch.full(grid.shape, 1500.0), data, grid,
        SolverConfig(pml=PMLConfig(**PML), refactor_every=2,
                     factorization=factorization),
        FWIConfig(num_iterations=3))
    for f in ("loss", "step_size"):
        np.testing.assert_allclose(getattr(port.metrics, f).numpy(),
                                   ref[f"cg_{factorization}_{f}"], rtol=1e-2)
    np.testing.assert_allclose(port.velocity.numpy(),
                               ref[f"cg_{factorization}_velocity"], atol=0.5)


# -- where the entry points run ----------------------------------------------

def test_entry_points_default_to_the_card(tiny_ring):
    """With no ``device=`` the entry points run on the card; where there is
    none they raise, naming CUDA, rather than run on the CPU."""
    tds = tiny_ring
    grid = Grid2D.centered(EXTENT, 0.8e-3)
    acq_cfg = AcquisitionConfig(**TINY_ACQ)
    if torch.cuda.is_available():
        acq = build_ring_acquisition(grid, acq_cfg, x_elem=tds.x_circ,
                                     y_elem=tds.y_circ)
        assert tobj.build_fwi_data(acq, tds.rec_data, TINY_F).src.is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        invert_dataset(tds, grid=grid, acquisition=acq_cfg,
                       fwi=FWIConfig(num_iterations=1))
    acq = build_ring_acquisition(grid, acq_cfg, x_elem=tds.x_circ,
                                 y_elem=tds.y_circ)
    with pytest.raises(RuntimeError, match="CUDA"):
        tobj.build_fwi_data(acq, tds.rec_data, TINY_F)
    from waveforminversionust_tpu_torch.data.synthesize import \
        synthesize_ring_dataset
    with pytest.raises(RuntimeError, match="CUDA"):
        synthesize_ring_dataset(np.full(grid.shape, 1500.0, np.float32), grid,
                                acq_cfg, f=TINY_F)
    # a tensor already on a device keeps the solve there
    out = synthesize_ring_dataset(torch.full(grid.shape, 1500.0), grid,
                                  acq_cfg, f=TINY_F,
                                  solver=SolverConfig(pml=PMLConfig(**PML)))
    assert np.isfinite(out.rec_data).all()
