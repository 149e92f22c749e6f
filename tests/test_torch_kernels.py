"""The CUDA kernel wrappers of the port: dispatch on the CPU, and the
kernels against their plain versions on a card.

On a CPU tensor each wrapper runs its plain PyTorch version and launches
nothing; the ``cuda``-marked cases build ``csrc/*.cu`` with nvcc and hold
each kernel against its plain version, and skip where there is no card.
``python3 chip_smoke.py`` runs the same checks at the main path's shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from waveforminversionust_tpu_torch.config import (PMLConfig, SolverConfig,
                                                   SolverMethod)
from waveforminversionust_tpu_torch.models.grid import Grid2D
from waveforminversionust_tpu_torch.models.phantom import smooth_blob_phantom
from waveforminversionust_tpu_torch.ops import (_build, apply, banded,
                                                batched_inv, kernel_factor,
                                                kernel_inv,
                                                kernel_launch_counts,
                                                kernel_stencil, kernel_sweep,
                                                kernel_twisted,
                                                reset_kernel_launch_counts,
                                                twisted)
from waveforminversionust_tpu_torch.ops import solve as tsolve
from waveforminversionust_tpu_torch.ops.stencil import helmholtz_coefficients

F = 350e3


def _planes(extent=12e-3, device="cpu"):
    grid = Grid2D.centered(extent, 0.8e-3)
    vel = smooth_blob_phantom(grid, radius=extent / 3, dc=60)
    return helmholtz_coefficients(torch.as_tensor(vel, device=device), grid, F,
                                  PMLConfig(l_pml=2.4e-3))


def _fields(seed, shape, device="cpu"):
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
    return torch.as_tensor(z.astype(np.complex64), device=device)


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


NO_LAUNCHES = {"factor": 0, "sweep": 0, "stencil": 0, "twisted_factor": 0,
               "twisted_sweep": 0, "batched_inv": 0}


def test_cpu_wrappers_run_the_plain_versions():
    """On CPU tensors every wrapper returns exactly its plain version's
    result and counts no launch."""
    coeffs = _planes()
    b = _fields(0, (2,) + tuple(coeffs.shape[1:]))
    reset_kernel_launch_counts()
    fac = kernel_factor.banded_factor_kernel(coeffs)
    assert torch.equal(fac.g, banded.banded_factor(coeffs).g)
    tfac = kernel_twisted.twisted_factor_kernel(coeffs, m=5)
    assert tfac.m == 5
    assert torch.equal(tfac.g, twisted.twisted_factor(coeffs, m=5).g)
    for adjoint in (False, True):
        assert torch.equal(kernel_sweep.banded_solve_kernel(fac, b, adjoint),
                           banded.banded_solve(fac, b, adjoint))
        assert torch.equal(kernel_twisted.twisted_solve_kernel(tfac, b, adjoint),
                           twisted.twisted_solve(tfac, b, adjoint))
    assert torch.equal(kernel_stencil.h_apply_kernel(coeffs, b),
                       apply.h_apply(coeffs, b))
    blocks = _fields(5, (3, 8, 8)) + 4 * torch.eye(8)
    assert torch.equal(kernel_inv.batched_small_inv_kernel(blocks),
                       batched_inv._batched_pivot_inv(blocks))
    assert torch.equal(kernel_inv.pivot_inverse_kernel(blocks),
                       batched_inv._batched_pivot_inv(blocks))
    assert kernel_inv.pivot_launches == 0
    assert kernel_launch_counts() == NO_LAUNCHES


@pytest.mark.parametrize("factorization,fused_apply",
                         [("auto", "auto"), ("pallas", "on"),
                          ("thomas", "off")])
def test_solver_config_dispatch(monkeypatch, factorization, fused_apply):
    """``factorization`` "auto"/"pallas" and any ``fused_apply`` but "off"
    route through the kernel wrappers; "thomas" and "off" through the
    plain versions."""
    calls = []

    def spy(name, fn):
        def wrapped(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tsolve, "banded_factor_kernel",
                        spy("factor", kernel_factor.banded_factor_kernel))
    monkeypatch.setattr(tsolve, "banded_solve_kernel",
                        spy("sweep", kernel_sweep.banded_solve_kernel))
    monkeypatch.setattr(tsolve, "h_apply_kernel",
                        spy("stencil", kernel_stencil.h_apply_kernel))
    cfg = SolverConfig(factorization=factorization, fused_apply=fused_apply,
                       refine=1, pml=PMLConfig(l_pml=2.4e-3))
    grid = Grid2D.centered(12e-3, 0.8e-3)
    vel = torch.as_tensor(smooth_blob_phantom(grid, radius=4e-3, dc=60))
    op = tsolve.make_helmholtz_operator(vel, F, grid, cfg)
    tsolve.helmholtz_operator_solve(op, _fields(1, (1,) + grid.shape), grid,
                                    cfg)
    kernels = factorization != "thomas"
    assert calls == (["factor", "sweep", "stencil", "sweep"] if kernels
                     else [])


@pytest.mark.parametrize("cfg", [SolverConfig(factorization="spike",
                                              refactor_every=2),
                                 SolverConfig(factorization="spike")]
                         + [SolverConfig(factorization=mode, **hybrid)
                            for mode in ("auto", "thomas")
                            for hybrid in (dict(factor_schulz_steps=2),
                                           dict(fast_sweeps=True))])
def test_later_slices_raise(cfg, monkeypatch):
    """The name is kept from when all six cases raised; now only the two
    spike (grid-sharded) cases still raise, until the multi-device slice.
    The four others pin that under "auto" and "thomas" the scan hybrids,
    factor_schulz_steps=2 and fast_sweeps=True, solve through the plain block-Thomas factor (no
    factor kernel wrapper is called, as the JAX package sends them to its
    scan path) and match the exact factor's solve: rel 1e-4 (the hybrid's
    bound in tests/test_split_engine.py), forward and adjoint."""
    if cfg.factorization == "spike":
        grid = Grid2D.centered(4e-3, 0.8e-3)
        with pytest.raises(NotImplementedError, match="later slice"):
            tsolve.make_helmholtz_operator(torch.full(grid.shape, 1500.0), F,
                                           grid, cfg)
        return
    monkeypatch.setattr(tsolve, "banded_factor_kernel", None)
    grid = Grid2D.centered(16e-3, 0.8e-3)
    vel = torch.as_tensor(smooth_blob_phantom(grid, radius=5e-3, dc=60))
    cfg = dataclasses.replace(cfg, pml=PMLConfig(l_pml=3.2e-3))
    exact = dataclasses.replace(cfg, factorization="thomas",
                                factor_schulz_steps=0, fast_sweeps=None)
    op = tsolve.make_helmholtz_operator(vel, F, grid, cfg)
    assert isinstance(op.factor, tsolve.BandedFactor)
    assert (op.factor.sweeps is not None) == bool(cfg.fast_sweeps)
    want_op = tsolve.make_helmholtz_operator(vel, F, grid, exact)
    src = _fields(21, (2,) + grid.shape)
    for adjoint in (False, True):
        u = tsolve.helmholtz_operator_solve(op, src, grid, cfg,
                                            adjoint=adjoint)
        want = tsolve.helmholtz_operator_solve(want_op, src, grid, exact,
                                               adjoint=adjoint)
        assert _rel(u, want) < 1e-4, adjoint


@pytest.mark.parametrize("method", [SolverMethod.GMRES, SolverMethod.BORN])
def test_gmres_and_born_operators_run(monkeypatch, method):
    """The operator API runs GMRES and Born: a GMRES operator carries the
    preconditioner's parameters and every matvec goes through the stencil
    kernel's wrapper (its plain version on CPU tensors, no launch), its
    solve within the JAX package's 5e-3 of the banded one
    (tests/test_solvers.py:272); Born's solve is finite and touches no
    kernel wrapper."""
    calls = []

    def spy(planes, v):
        calls.append(1)
        return kernel_stencil.h_apply_kernel(planes, v)

    monkeypatch.setattr(tsolve, "h_apply_kernel", spy)
    grid = Grid2D.centered(8e-3, 0.8e-3)
    vel = torch.as_tensor(smooth_blob_phantom(grid, radius=3e-3, dc=60))
    cfg = SolverConfig(method=method, pml=PMLConfig(l_pml=2e-3))
    src = _fields(14, (2,) + grid.shape)
    reset_kernel_launch_counts()
    op = tsolve.make_helmholtz_operator(vel, F, grid, cfg)
    u = tsolve.helmholtz_operator_solve(op, src, grid, cfg)
    assert op.factor is None and bool(torch.all(torch.isfinite(u)))
    assert kernel_launch_counts() == NO_LAUNCHES
    if method == SolverMethod.GMRES:
        assert op.precond is not None and len(calls) > 16
        banded_cfg = SolverConfig(pml=cfg.pml)
        ub = tsolve.helmholtz_operator_solve(
            tsolve.make_helmholtz_operator(vel, F, grid, banded_cfg), src,
            grid, banded_cfg)
        assert _rel(u, ub) < 5e-3
    else:
        assert op.precond is None and not calls


@pytest.mark.parametrize("factorization", ["pallas", "twisted", "cr"])
def test_engines_ignore_the_scan_hybrids(factorization):
    """The Schulz and embedded-sweep options only steer the reference's scan
    path: "pallas", "twisted" and "cr" build and solve as without them."""
    grid = Grid2D.centered(4e-3, 0.8e-3)
    vel = torch.as_tensor(smooth_blob_phantom(grid, radius=1.5e-3, dc=60))
    cfg = SolverConfig(factorization=factorization, factor_schulz_steps=2,
                       fast_sweeps=True, pml=PMLConfig(l_pml=1.6e-3))
    op = tsolve.make_helmholtz_operator(vel, F, grid, cfg)
    src = _fields(10, (2,) + grid.shape)
    u = tsolve.helmholtz_operator_solve(op, src, grid, cfg)
    plain = SolverConfig(factorization=factorization, pml=cfg.pml)
    want = tsolve.helmholtz_operator_solve(
        tsolve.make_helmholtz_operator(vel, F, grid, plain), src, grid, plain)
    assert _rel(u, want) < 1e-6


def test_build_key_follows_the_sources(monkeypatch, tmp_path):
    """The build directory is keyed by the sources: an edited source gets a
    new key, so a stale library is never loaded."""
    key = _build._key()
    assert len(key) == 16 and key == _build._key()
    assert set(_build.SOURCES) == {p.stem for p in _build.CSRC.glob("*.cu")}
    for name in _build.SOURCES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert 'extern "C"' in src
        (tmp_path / f"{name}.cu").write_text(src)
    headers = sorted(_build.CSRC.glob("*.cuh"))
    for header in headers:
        (tmp_path / header.name).write_text(header.read_text())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build._key() == key
    # an edited source or an edited shared header gets a new key
    for edited in (tmp_path / "sweep.cu", tmp_path / headers[0].name):
        before = _build._key()
        edited.write_text(edited.read_text() + "\n// edited\n")
        assert _build._key() != before
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# -- on a card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


# Grids whose last Gauss-Jordan panel (64) and sub-panel (8) are ragged in
# every way: 31 = 3 x 8 + 7, 61 = 7 x 8 + 5, 67 = a panel and 3, 129 = two
# panels and 1.
RAGGED = [pytest.param(12e-3, id="31"), pytest.param(24e-3, id="61"),
          pytest.param(26.4e-3, id="67"), pytest.param(51.2e-3, id="129")]


@pytest.mark.cuda
@pytest.mark.parametrize("extent", RAGGED)
def test_factor_kernel_matches_plain(cuda, extent):
    """K1 on grids whose width is no multiple of a panel or a sub-panel vs
    the plain factor in complex128: rel < 5e-6
    (tests/test_pallas_factor.py's bound)."""
    coeffs = _planes(extent, cuda)
    g = kernel_factor.banded_factor_kernel(coeffs).g
    g64 = banded.banded_factor(coeffs.to(torch.complex128)).g
    torch.cuda.synchronize()
    assert _rel(g.to(torch.complex128), g64) < 5e-6


def _random_planes(seed, ny, nx, device):
    """Seeded planes with a dominant main diagonal: a block-tridiagonal
    system of any shape, ny = 1 and 2 included."""
    c = _fields(seed, (9, ny, nx), device) / 4
    c[0] += 4
    return c


# K2's cluster kernel, each of its three instantiations through shapes that
# take it: 16 right-hand sides a cluster (nx <= 384) on ragged output slices
# (31, 61 over 8 blocks), a grid narrower than a cluster (6 < 8 blocks),
# ny = 1 and 2, and the main path's width 301; 8 (385 <= nx <= 624) at the
# data's width 401; 4 (nx >= 625) at 701. Batch 1, 9, 17 and 40: ragged
# right-hand-side groups (batch % 16 and % 8 not 0).
SWEEP_SHAPES = [pytest.param(12e-3, id="31"), pytest.param(24e-3, id="61"),
                pytest.param(4e-3, id="6"), pytest.param((1, 9), id="1x9"),
                pytest.param((2, 5), id="2x5"),
                pytest.param((5, 301), id="5x301"),
                pytest.param((5, 401), id="5x401"),
                pytest.param((3, 701), id="3x701")]


@pytest.mark.cuda
@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("shape", SWEEP_SHAPES)
def test_sweep_kernel_matches_plain(cuda, adjoint, shape):
    """K2 vs the plain sweeps through the same factor, batch 1, 9, 17 and
    40: rel < 1e-5, through the instantiation its width selects."""
    if isinstance(shape, tuple):
        coeffs = _random_planes(11, *shape, cuda)
    else:
        coeffs = _planes(shape, cuda)
    fac = banded.banded_factor(coeffs)
    nx = coeffs.shape[2]
    for batch in (1, 9, 17, 40):
        b = _fields(2, (batch,) + tuple(coeffs.shape[1:]), cuda)
        x = kernel_sweep.banded_solve_kernel(fac, b, adjoint)
        torch.cuda.synchronize()
        assert kernel_sweep.last_launch["rhs"] == (
            16 if nx <= 384 else 8 if nx <= 624 else 4)
        assert _rel(x, banded.banded_solve(fac, b, adjoint)) < 1e-5, batch


@pytest.mark.cuda
def test_sweep_kernel_launch(cuda):
    """A 301-wide solve of 256 right-hand sides (the main path's) takes
    clusters of 2 to 8 blocks, each G element read serving 16 right-hand
    sides, all resident at once; a grid wider than 1264 raises."""
    coeffs = _random_planes(3, 2, 301, cuda)
    fac = banded.banded_factor(coeffs)
    b = _fields(4, (256, 2, 301), cuda)
    for adjoint in (False, True):
        kernel_sweep.banded_solve_kernel(fac, b, adjoint)
        p = kernel_sweep.last_launch
        assert 2 <= p["cluster"] <= 8 and p["rhs"] == 16, p
        assert p["clusters"] == 256 // p["rhs"], p
        assert p["max_active_clusters"] >= p["clusters"], p
    wide = _random_planes(3, 1, 1265, cuda)
    with pytest.raises(RuntimeError, match="nx=1265"):
        kernel_sweep.banded_solve_kernel(
            banded.banded_factor(wide), _fields(4, (1, 1, 1265), cuda))


# K3's tiles are 32 x 16 points, a block's fields a group of 8: grids on and
# off every tile edge (1 x 1, a single row, a single column, a width and
# height no multiple of the tile, an exact tile), batch 1 (a group of one)
# and 11 (a group and a ragged group of 3).
STENCIL_SHAPES = [pytest.param(24e-3, id="61"), pytest.param((1, 1), id="1x1"),
                  pytest.param((1, 37), id="1x37"),
                  pytest.param((37, 1), id="37x1"),
                  pytest.param((17, 33), id="17x33"),
                  pytest.param((16, 32), id="16x32"),
                  pytest.param((45, 70), id="45x70")]


@pytest.mark.cuda
@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("shape", STENCIL_SHAPES)
def test_stencil_kernel_matches_plain(cuda, adjoint, shape):
    """K3 (fed the adjoint planes for H^H) vs the plain apply: rel < 1e-6,
    at batch 1 and 11."""
    if isinstance(shape, tuple):
        coeffs = _random_planes(13, *shape, cuda)
    else:
        coeffs = _planes(shape, cuda)
    planes = apply.adjoint_coefficients(coeffs) if adjoint else coeffs
    plain = apply.h_apply_adjoint if adjoint else apply.h_apply
    for batch in (1, 11):
        u = _fields(3, (batch,) + tuple(coeffs.shape[1:]), cuda)
        want = plain(coeffs, u)
        out = kernel_stencil.h_apply_kernel(planes, u)
        torch.cuda.synchronize()
        assert _rel(out, want) < 1e-6, batch


@pytest.mark.cuda
def test_launch_counts_are_kernel_launches(cuda):
    """Each wrapper counts the kernels its C entry point launched: on 31x31
    (one masked Gauss-Jordan panel) a factorization is 3 launches per row
    (build_s, pivot_gj, panel_update), a solve 1 (both passes in one
    cluster launch), an apply 1."""
    coeffs = _planes(12e-3, cuda)
    ny = coeffs.shape[1]
    b = _fields(4, (3,) + tuple(coeffs.shape[1:]), cuda)
    reset_kernel_launch_counts()
    fac = kernel_factor.banded_factor_kernel(coeffs)
    kernel_sweep.banded_solve_kernel(fac, b, True)
    kernel_stencil.h_apply_kernel(coeffs, b)
    torch.cuda.synchronize()
    assert kernel_launch_counts() == dict(NO_LAUNCHES, factor=3 * ny, sweep=1,
                                          stencil=1)


def _twisted_middles(ny):
    """The default middle row, both extremes and an off-centre one."""
    return [None, 1, ny - 2, ny // 3]


@pytest.mark.cuda
@pytest.mark.parametrize("extent", RAGGED)
def test_twisted_factor_kernel_matches_plain(cuda, extent):
    """K4a on the same ragged grids vs the plain twisted factor in
    complex128, for the default middle row and for m past the centre (which
    the TPU kernel refuses and this one takes): rel < 5e-6 (K1's bound).
    Rows above the middle are block-Thomas's G: held against K1's kernel to
    1e-5."""
    coeffs = _planes(extent, cuda)
    ny = coeffs.shape[1]
    g1 = kernel_factor.banded_factor_kernel(coeffs).g
    for m in _twisted_middles(ny):
        fac = kernel_twisted.twisted_factor_kernel(coeffs, m)
        ref = twisted.twisted_factor(coeffs.to(torch.complex128), m)
        torch.cuda.synchronize()
        assert fac.m == ref.m
        assert _rel(fac.g.to(torch.complex128), ref.g) < 5e-6, m
        assert _rel(fac.g[:fac.m], g1[:fac.m]) < 1e-5, m
    for bad in (0, ny - 1):
        with pytest.raises(ValueError, match="out of range"):
            kernel_twisted.twisted_factor_kernel(coeffs, bad)


# K4b's cluster kernel, each of its three instantiations through shapes that
# take it: 8 right-hand sides a cluster and 160 gemv rows a block (nx <=
# 432) on ragged slices (31, 61), grids narrower than a cluster (6, 7 < 8
# blocks), the main path's width 301 and the data's 401; 8 and 80 (433 <=
# nx <= 624) at 501; 4 and 160 (nx >= 625) at 701. ny = 3 and 5, so that
# every middle row of _twisted_middles is an edge case.
TWISTED_SHAPES = [pytest.param(12e-3, id="31"), pytest.param(24e-3, id="61"),
                  pytest.param(4e-3, id="6"),
                  pytest.param((3, 7), id="3x7"),
                  pytest.param((5, 301), id="5x301"),
                  pytest.param((5, 401), id="5x401"),
                  pytest.param((3, 501), id="3x501"),
                  pytest.param((3, 701), id="3x701")]


@pytest.mark.cuda
@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("shape", TWISTED_SHAPES)
def test_twisted_sweep_kernel_matches_plain(cuda, adjoint, shape):
    """K4b vs the plain twisted solve through the same factor, batch 1, 9,
    17 and 40 (ragged last groups), every middle row of the factor test:
    rel < 1e-5; true residual through the plain apply < 2e-5; through the
    instantiation its width selects."""
    if isinstance(shape, tuple):
        coeffs = _random_planes(11, *shape, cuda)
    else:
        coeffs = _planes(shape, cuda)
    nx = coeffs.shape[2]
    op = apply.h_apply_adjoint if adjoint else apply.h_apply
    for m in _twisted_middles(coeffs.shape[1]):
        fac = twisted.twisted_factor(coeffs, m)
        for batch in (1, 9, 17, 40):
            b = _fields(6, (batch,) + tuple(coeffs.shape[1:]), cuda)
            x = kernel_twisted.twisted_solve_kernel(fac, b, adjoint)
            torch.cuda.synchronize()
            p = kernel_twisted.last_sweep_launch
            assert (p["rhs"], p["rows"]) == (
                (8, 160) if nx <= 432 else (8, 80) if nx <= 624 else (4, 160))
            assert _rel(x, twisted.twisted_solve(fac, b, adjoint)) < 1e-5, (m, batch)
            assert _rel(op(coeffs, x), b) < 2e-5, (m, batch)


@pytest.mark.cuda
def test_twisted_sweep_kernel_launch(cuda):
    """A 301-wide twisted solve of 256 right-hand sides (the main path's)
    keeps the clusters of both chains, 2 x 256 / R, on the card at once: one
    wave; a grid wider than 1264 raises."""
    coeffs = _random_planes(3, 3, 301, cuda)
    fac = twisted.twisted_factor(coeffs)
    b = _fields(4, (256, 3, 301), cuda)
    for adjoint in (False, True):
        kernel_twisted.twisted_solve_kernel(fac, b, adjoint)
        p = kernel_twisted.last_sweep_launch
        assert p["clusters"] == 2 * 256 // p["rhs"], p
        assert p["max_active_clusters"] >= p["clusters"], p
    wide = _random_planes(3, 3, 1265, cuda)
    with pytest.raises(RuntimeError, match="nx=1265"):
        kernel_twisted.twisted_solve_kernel(
            twisted.twisted_factor(wide), _fields(4, (1, 3, 1265), cuda))


# Every batch the cyclic reduction of a 301-row grid inverts at b = 64 (a
# level's odd rows: 150, 75, 38, 19, 9, 5, 2, 1), and ragged widths.
@pytest.mark.cuda
@pytest.mark.parametrize("batch,b", [(150, 64), (75, 64), (38, 64), (19, 64),
                                     (9, 64), (5, 64), (2, 64), (1, 64),
                                     (5, 16), (3, 40), (1, 1), (4, 17),
                                     (2, 63)])
def test_batched_inv_kernel_matches_plain(cuda, batch, b):
    """K5 vs numpy-grade complex128 inverses of a seeded batch with a
    boosted diagonal: rel < 5e-5 (tests/test_batched_inv.py's bound); and
    the Dirichlet-scale pivot 1.5625e6 inverted without cancellation."""
    a = _fields(7, (batch, b, b), cuda) / np.sqrt(b) + 2 * torch.eye(b, device=cuda)
    out = kernel_inv.batched_small_inv_kernel(a)
    torch.cuda.synchronize()
    want = torch.linalg.inv(a.to(torch.complex128))
    rel = (torch.linalg.norm((out - want).reshape(batch, -1), dim=1)
           / torch.linalg.norm(want.reshape(batch, -1), dim=1))
    assert float(rel.max()) < 5e-5
    assert _rel(out, batched_inv._batched_pivot_inv(a)) < 5e-5
    d = (1.5625e6 * torch.eye(b, device=cuda)).to(torch.complex64)[None]
    got = kernel_inv.batched_small_inv_kernel(d)[0]
    torch.testing.assert_close(got, (torch.eye(b, device=cuda) / 1.5625e6
                                     ).to(torch.complex64), rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,b", [(150, 64), (2, 45), (5, 16), (3, 40),
                                     (1, 1), (4, 17), (2, 63), (3, 8),
                                     (3, 9)])
def test_pivot_inverse_kernel_matches_plain(cuda, batch, b):
    """The factorizations' blocked pivot inverse, launched alone, at every
    kind of ragged width (of the block and of its sub-panels of 8), held as
    K5 is: rel < 5e-5 against complex128 inverses and against the plain
    version; the Dirichlet-scale pivot without cancellation. It counts its
    launches apart from K5's."""
    a = _fields(9, (batch, b, b), cuda) / np.sqrt(b) + 2 * torch.eye(b, device=cuda)
    reset_kernel_launch_counts()
    before = kernel_inv.pivot_launches
    out = kernel_inv.pivot_inverse_kernel(a)
    torch.cuda.synchronize()
    assert kernel_inv.pivot_launches == before + 1
    assert kernel_launch_counts() == NO_LAUNCHES
    want = torch.linalg.inv(a.to(torch.complex128))
    rel = (torch.linalg.norm((out - want).reshape(batch, -1), dim=1)
           / torch.linalg.norm(want.reshape(batch, -1), dim=1))
    assert float(rel.max()) < 5e-5
    assert _rel(out, batched_inv._batched_pivot_inv(a)) < 5e-5
    d = (1.5625e6 * torch.eye(b, device=cuda)).to(torch.complex64)[None]
    got = kernel_inv.pivot_inverse_kernel(d)[0]
    torch.testing.assert_close(got, (torch.eye(b, device=cuda) / 1.5625e6
                                     ).to(torch.complex64), rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("factorization", ["twisted", "cr"])
def test_engine_launch_counts(cuda, factorization):
    """A solve through each opt-in engine launches its own kernels and
    none of block-Thomas's: on 31x31 a twisted factorization is 3 launches
    per step of both chains plus 3 for the middle, a twisted solve 2; a
    cyclic-reduction factorization one batched pivot inverse per level and
    root (31 < 64: one panel each)."""
    coeffs = _planes(12e-3, cuda)
    ny = coeffs.shape[1]
    cfg = SolverConfig(factorization=factorization, pml=PMLConfig(l_pml=2.4e-3))
    b = _fields(8, (3,) + tuple(coeffs.shape[1:]), cuda)
    reset_kernel_launch_counts()
    fac = tsolve.factor_operator(coeffs, cfg)
    x = tsolve.banded_solve_refined(fac, b, cfg, adjoint=False)
    torch.cuda.synchronize()
    assert _rel(apply.h_apply(coeffs, x), b) < 1e-4
    if factorization == "twisted":
        steps = max(fac.m, ny - 1 - fac.m) + 1
        want = dict(NO_LAUNCHES, twisted_factor=3 * steps, twisted_sweep=2)
    else:
        want = dict(NO_LAUNCHES, batched_inv=len(fac.levels) + 1)
    assert kernel_launch_counts() == want


# -- the differentiable solve through the kernels (on a card) ----------------

def _plain_engine(monkeypatch, factorization):
    """The plain configuration of ``factorization`` with every kernel
    wrapper that engine reaches routed to its plain version, so that the
    plain functions run on the same CUDA tensors."""
    monkeypatch.setattr(tsolve, "twisted_factor_kernel", twisted.twisted_factor)
    monkeypatch.setattr(tsolve, "twisted_solve_kernel", twisted.twisted_solve)
    monkeypatch.setattr(batched_inv, "batched_small_inv_kernel",
                        batched_inv._batched_pivot_inv)
    return SolverConfig(factorization="thomas" if factorization == "auto"
                        else factorization, fused_apply="off",
                        pml=PMLConfig(l_pml=2.4e-3))


def _solve_grads(cuda, cfg, adjoint, warm):
    """d/dvel and d/dsrc of a weighted |u|^2 through solve_helmholtz on a
    31x31 grid, 3 sources; with ``warm`` from a warm start 2% off."""
    grid = Grid2D.centered(12e-3, 0.8e-3)
    vel = torch.tensor(smooth_blob_phantom(grid, radius=4e-3, dc=60),
                       device=cuda, requires_grad=True)
    src = _fields(11, (3,) + grid.shape, cuda).requires_grad_(True)
    x0 = None
    if warm:
        with torch.no_grad():
            x0 = 1.02 * tsolve.solve_helmholtz(vel, src, F, grid, cfg,
                                               adjoint=adjoint)[0]
    u, _ = tsolve.solve_helmholtz(vel, src, F, grid, cfg, adjoint=adjoint,
                                  x0=x0)
    w = 1.0 + 0.3 * torch.cos(torch.arange(u.numel(), device=cuda,
                                           dtype=torch.float32)).reshape(u.shape)
    torch.sum(torch.abs(u) ** 2 * w).backward()
    return vel.grad, src.grad


@pytest.mark.cuda
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("factorization", ["auto", "twisted", "cr"])
def test_solve_gradient_through_kernels_matches_plain(cuda, monkeypatch,
                                                      factorization, adjoint,
                                                      warm):
    """The gradient of a loss through each engine's kernels (the forward
    factor and sweeps, the backward's adjoint sweeps, K3 in the warm
    start's differentiable residual) == the plain path's on the same CUDA
    tensors: relative error < 1e-4."""
    cfg = SolverConfig(factorization=factorization, pml=PMLConfig(l_pml=2.4e-3))
    reset_kernel_launch_counts()
    kv, ks = _solve_grads(cuda, cfg, adjoint, warm)
    torch.cuda.synchronize()
    counts = kernel_launch_counts()
    if factorization == "auto":
        assert counts["factor"] > 0 and counts["sweep"] >= 2
    elif factorization == "twisted":
        assert counts["twisted_factor"] > 0 and counts["twisted_sweep"] >= 4
    else:
        assert counts["batched_inv"] > 0
    plain = _plain_engine(monkeypatch, factorization)
    reset_kernel_launch_counts()
    pv, ps = _solve_grads(cuda, plain, adjoint, warm)
    torch.cuda.synchronize()
    assert kernel_launch_counts() == NO_LAUNCHES
    assert _rel(kv, pv) < 1e-4
    assert _rel(ks, ps) < 1e-4


@pytest.mark.cuda
def test_lbfgs_evaluation_launch_counts(cuda):
    """One L-BFGS value-and-grad through the kernels: one factorization
    (3 launches a row on 31x31), a forward and an adjoint solve (one
    launch each) and the residual diagnostic's apply, nothing of the
    other engines; its gradient is finite."""
    from waveforminversionust_tpu_torch.fwi import lbfgs
    from waveforminversionust_tpu_torch.fwi.objective import FWIData

    grid = Grid2D.centered(12e-3, 0.8e-3)
    ny, nx = grid.shape
    ntx = 4
    src = _fields(12, (ntx, ny, nx), cuda)
    rx_y = torch.tensor([[3, 5, ny - 4]] * ntx, device=cuda)
    rx_x = torch.tensor([[4, nx - 5, 7]] * ntx, device=cuda)
    data = FWIData(src=src, rec_obs=_fields(13, (ntx, 3), cuda), rx_y=rx_y,
                   rx_x=rx_x, f=F)
    cfg = SolverConfig(pml=PMLConfig(l_pml=2.4e-3))
    reset_kernel_launch_counts()
    value, grad = lbfgs._value_and_grad(
        lambda s: lbfgs.fwi_loss(s, data, grid, cfg),
        torch.full((ny * nx,), 1 / 1500.0, device=cuda))
    torch.cuda.synchronize()
    assert kernel_launch_counts() == dict(NO_LAUNCHES, factor=3 * ny, sweep=2,
                                          stencil=1)
    assert bool(torch.isfinite(value)) and bool(torch.all(torch.isfinite(grad)))


# -- the iterative solvers and the comb sweep on a card -----------------------

@pytest.mark.cuda
@pytest.mark.parametrize("adjoint", [False, True])
@pytest.mark.parametrize("two_level", [False, True])
def test_gmres_through_kernels_matches_plain(cuda, monkeypatch, two_level,
                                             adjoint):
    """A GMRES operator solve capped at two cycles (maxiter 34), every
    matvec through the stencil kernel, == the same solve with
    ``fused_apply="off"`` on the same CUDA tensors: the same matvec count,
    iterates within rel 5e-3, the JAX package's bound between its two GMRES
    paths (tests/test_solvers.py:244). Two cycles of this indefinite
    system amplify a change of summation order alone: on the CPU, the
    plain apply with its nine terms summed in reverse moves these iterates
    by 8.4e-5 to 1.1e-3. Two-level: the coarse 16x16 factor is K1 (3
    launches a row, in both runs) and each preconditioner application a K2
    solve."""
    grid = Grid2D.centered(12e-3, 0.8e-3)
    vel = torch.as_tensor(smooth_blob_phantom(grid, radius=4e-3, dc=60),
                          device=cuda)
    src = _fields(15, (3,) + grid.shape, cuda)
    counts = []
    real = tsolve.gmres

    def spy(*a, **k):
        res = real(*a, **k)
        counts.append(res.iterations)
        return res

    monkeypatch.setattr(tsolve, "gmres", spy)
    out = []
    for fused in ("auto", "off"):
        cfg = SolverConfig(method=SolverMethod.GMRES, maxiter=34,
                           gmres_two_level=two_level, fused_apply=fused,
                           pml=PMLConfig(l_pml=2.4e-3))
        reset_kernel_launch_counts()
        op = tsolve.make_helmholtz_operator(vel, F, grid, cfg)
        out.append(tsolve.helmholtz_operator_solve(op, src, grid, cfg,
                                                   adjoint=adjoint))
        torch.cuda.synchronize()
        launched = kernel_launch_counts()
        # A cycle: 16 Arnoldi matvecs and the true residual, and 17
        # preconditioner applications, each with a residual matvec and a
        # coarse solve when two-level.
        assert launched["stencil"] == ((34 + 34 * two_level)
                                       if fused == "auto" else 0)
        assert launched["factor"] == 3 * 16 * two_level
        assert launched["sweep"] == 34 * two_level
    assert counts == [34, 34]
    assert _rel(out[0], out[1]) < 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("krylov", [True, False])
def test_born_on_card_matches_cpu(cuda, krylov):
    """A Born solve on the card (cuFFT) == the same solve on the CPU: rel <
    1e-4; no kernel wrapper launches."""
    grid = Grid2D.centered(12e-3, 0.8e-3)
    vel = smooth_blob_phantom(grid, radius=4e-3, dc=60)
    src = _fields(16, (3,) + grid.shape)
    cfg = SolverConfig(method=SolverMethod.BORN, born_krylov=krylov)
    reset_kernel_launch_counts()
    u, _ = tsolve.solve_helmholtz(torch.as_tensor(vel, device=cuda),
                                  src.to(cuda), F, grid, cfg)
    torch.cuda.synchronize()
    assert kernel_launch_counts() == NO_LAUNCHES
    want, _ = tsolve.solve_helmholtz(torch.as_tensor(vel), src, F, grid, cfg)
    assert _rel(u.cpu(), want) < 1e-4


@pytest.mark.cuda
def test_frequency_sweep_on_card(cuda):
    """frequency_sweep on the card == one solve_helmholtz a frequency on
    the card (atol 2e-5 of the largest, tests/test_timedomain.py:23-35):
    one factorization (3 launches a row on 31x31) and one sweep a line."""
    from waveforminversionust_tpu_torch.data.timedomain import frequency_sweep

    grid = Grid2D.centered(12e-3, 0.8e-3)
    solver = SolverConfig(pml=PMLConfig(l_pml=2.4e-3))
    vel = torch.as_tensor(smooth_blob_phantom(grid, radius=4e-3, dc=30),
                          device=cuda)
    src = torch.zeros(grid.shape, dtype=torch.complex64, device=cuda)
    src[15, 15] = 1.0
    freqs = np.array([200e3, 300e3, 400e3])
    reset_kernel_launch_counts()
    fields = frequency_sweep(vel, src, freqs, grid, solver)
    torch.cuda.synchronize()
    assert kernel_launch_counts() == dict(NO_LAUNCHES, factor=3 * 31 * 3,
                                          sweep=3, stencil=3)
    for i, f in enumerate(freqs):
        u, _ = tsolve.solve_helmholtz(vel, src[None], f, grid, solver)
        torch.testing.assert_close(fields[i], u[0], rtol=0,
                                   atol=2e-5 * float(u.abs().max()))


# -- the volumetric path on a card: cuFFT and dense DFT products, no kernel --

@pytest.mark.cuda
def test_3d_entry_points_default_to_the_card(cuda):
    """With no device named, the 3D sources, datasets and the broadband
    synthesis run on the card; the inversion runs where its datasets live;
    no kernel wrapper launches."""
    from waveforminversionust_tpu_torch.data import timedomain3d
    from waveforminversionust_tpu_torch.fwi import fwi3d, runner3d
    from waveforminversionust_tpu_torch.models import acquisition3d
    from waveforminversionust_tpu_torch.models.grid3d import Grid3D

    grid = Grid3D.centered(6e-3, 1.5e-3)                       # 9^3
    pos = acquisition3d.cylinder_positions(1, 4, 4.5e-3, 0.0)
    acq = acquisition3d.build_acquisition3d(grid, pos, min_angle=0.5)
    assert acquisition3d.source_fields_3d(acq, grid).is_cuda
    data = fwi3d.build_fwi_data_3d(
        acq, np.ones(acq.rx_idx.shape[:2], np.complex64), 200e3, grid)
    assert data.src.is_cuda and data.rec_obs.is_cuda and data.rx_idx.is_cuda
    pml = PMLConfig(a0=20.0, l_pml=3e-3)
    reset_kernel_launch_counts()
    td = timedomain3d.synthesize_time_domain_dataset_3d(
        np.full(grid.shape, 1510.0, np.float32), grid, pos, f_low=0.2e6,
        f_high=0.25e6, df=0.05e6, pml=pml)
    _, datas = timedomain3d.timedomain_to_fwi_data_3d(td, [0.2e6], grid)
    assert datas[0].src.is_cuda
    res = runner3d.invert_dataset_3d(datas, grid, num_iterations=1, pml=pml,
                                     iter_cap=50)
    torch.cuda.synchronize()
    assert np.all(np.isfinite(res.velocity))
    assert kernel_launch_counts() == NO_LAUNCHES


@pytest.mark.cuda
@pytest.mark.parametrize("interpolation", ["nearest", "bilinear"])
def test_2d_source_cubes_built_on_the_card(cuda, interpolation, monkeypatch):
    """``build_fwi_data``'s sources and the cube ``synthesize_ring_dataset``
    hands to the solve are built on the card, bit for bit the CPU cube
    (151^2, 256 transmitters)."""
    from waveforminversionust_tpu_torch.config import AcquisitionConfig
    from waveforminversionust_tpu_torch.data import synthesize
    from waveforminversionust_tpu_torch.fwi.objective import build_fwi_data
    from waveforminversionust_tpu_torch.models import acquisition

    def bits(x):
        return x.cpu().numpy().view(np.uint64)

    grid = Grid2D.centered(120e-3, 1.6e-3)
    config = AcquisitionConfig(interpolation=interpolation)
    acq = acquisition.build_ring_acquisition(grid, config)
    seen = []

    def solve(vel, src, *args, **kwargs):
        seen.append(src)
        return tsolve.solve_helmholtz(vel, src, *args, **kwargs)

    monkeypatch.setattr(synthesize, "solve_helmholtz", solve)
    data = build_fwi_data(acq, np.ones((256, 256), np.complex64), 200e3)
    synthesize.synthesize_ring_dataset(
        np.full(grid.shape, 1500.0, np.float32), grid, config, f=200e3,
        seed=2**31 + 5)
    torch.cuda.synchronize()
    assert data.src.is_cuda and len(seen) == 1 and seen[0].is_cuda

    np.testing.assert_array_equal(bits(data.src),
                                  bits(acq.source_cube(device="cpu")))
    synth_acq = acquisition.build_ring_acquisition(
        grid, synthesize.dataclass_replace_tx_all(config))
    rng = np.random.default_rng(2**31 + 5)
    amps = (rng.standard_normal(256)
            + 1j * rng.standard_normal(256)).astype(np.complex64)
    np.testing.assert_array_equal(
        bits(seen[0]), bits(synth_acq.source_cube(amps, device="cpu")))


@pytest.mark.cuda
def test_born3d_dft_route_on_card(cuda):
    """On the card the dft route's transform is cuFFT's: rel < 1e-5 at
    "highest" (FP32 products), < 1e-3 at "high" (TF32 tensor cores; that
    it differs from FP32 shows the mode reached the products), forward and
    inverse, at the bench's 64^3 width; TF32 is off again afterwards."""
    from waveforminversionust_tpu_torch.ops import born3d

    x = _fields(21, (4, 64, 64, 64), cuda)
    axes = (-3, -2, -1)
    for inverse, ref in ((False, torch.fft.fftn(x, dim=axes)),
                         (True, torch.fft.ifftn(x, dim=axes))):
        assert _rel(born3d._dft3(x, inverse), ref) < 1e-5
        high = _rel(born3d._dft3(x, inverse, precision="high"), ref)
        assert 1e-6 < high < 1e-3, high
    assert torch.backends.cuda.matmul.allow_tf32 is False
