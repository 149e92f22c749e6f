"""The port's 3D grid, acquisition and convergent Born solver held against
the JAX package on the CPU: Grid3D, the cylinder and bowl arrays, their
masks and one-hot sources (live, exact); the 3D Born operator (live); the
GMRES and plain-series solves forward, adjoint and lossy on a 15^3 blob
(from tests/golden/torch_3d.npz); the dft route against the fft route;
and the solve that raises until the 3D methods come.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from waveforminversionust_tpu import PMLConfig as JPMLConfig
from waveforminversionust_tpu.models import acquisition3d as jacq
from waveforminversionust_tpu.models.grid3d import Grid3D as JGrid3D
from waveforminversionust_tpu.ops import born3d as jborn3d
from waveforminversionust_tpu.ops import cpx
from waveforminversionust_tpu_torch.config import PMLConfig
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
PML = PMLConfig(**GEN.PML3)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's outputs (tests/golden/generate_torch.py 3d)."""
    return np.load(os.path.join(GOLDEN, "torch_3d.npz"))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _grid():
    return Grid3D.centered(GEN.G3_EXTENT, GEN.G3_H)


def test_grid3d_matches_jax():
    """Grid3D.centered, its shape, axes, diagonal and meshgrid == the JAX
    package's, exactly; frozen and hashable."""
    for args in ((12e-3, 1.5e-3), (24e-3, 0.75e-3), (10e-3, 1e-3, 6e-3, 4e-3)):
        g, j = Grid3D.centered(*args), JGrid3D.centered(*args)
        assert g.shape == j.shape and g.diagonal == j.diagonal
        for a, b in zip((g.x, g.y, g.z, *g.meshgrid()),
                        (j.x, j.y, j.z, *j.meshgrid())):
            np.testing.assert_array_equal(a, b)
    assert Grid3D.centered(24e-3, 0.75e-3).shape == (65, 65, 65)
    assert hash(_grid()) == hash(_grid())
    with pytest.raises(AttributeError):
        _grid().nx = 3


@pytest.mark.parametrize("layout,min_angle", [
    ("cylinder", 0.8), ("cylinder", 0.0), ("hemisphere", 0.7)])
def test_acquisition3d_matches_jax(layout, min_angle):
    """Positions, snapped voxels, receiver voxels and elements, and the
    one-hot sources == the JAX package's, exactly."""
    if layout == "cylinder":
        pos = acquisition3d.cylinder_positions(2, 8, 8e-3, 6e-3)
        jpos = jacq.cylinder_positions(2, 8, 8e-3, 6e-3)
    else:
        pos = acquisition3d.hemisphere_positions(12, 8e-3)
        jpos = jacq.hemisphere_positions(12, 8e-3)
    np.testing.assert_array_equal(pos, jpos)
    grid = _grid()
    acq = acquisition3d.build_acquisition3d(grid, pos, min_angle=min_angle)
    jac = jacq.build_acquisition3d(JGrid3D.centered(GEN.G3_EXTENT, GEN.G3_H),
                                   jpos, min_angle=min_angle)
    np.testing.assert_array_equal(acq.src_idx, np.asarray(jac.src_idx))
    np.testing.assert_array_equal(acq.rx_idx, np.asarray(jac.rx_idx))
    np.testing.assert_array_equal(acq.rx_elem, jac.rx_elem)
    assert acq.n_elements == jac.n_elements
    src = acquisition3d.source_fields_3d(acq, grid, device="cpu")
    assert src.dtype == torch.complex64 and src.device.type == "cpu"
    np.testing.assert_array_equal(
        src.numpy(), cpx.to_numpy(jacq.source_fields_3d(jac, JGrid3D.centered(
            GEN.G3_EXTENT, GEN.G3_H))))


def test_acquisition3d_rejects_a_closed_aperture():
    pos = acquisition3d.cylinder_positions(1, 8, 8e-3, 0.0)
    with pytest.raises(ValueError, match="min_angle"):
        acquisition3d.build_acquisition3d(_grid(), pos, min_angle=3.2)


@pytest.mark.parametrize("adjoint,lossy", [(False, False), (True, True)])
def test_born_operator_3d_matches_jax(adjoint, lossy):
    """The potential, gamma, the iteration heuristic and the Green's
    operator on seeded fields == the JAX package's at a fixed shell
    wavenumber: rel < 1e-5 (measured ~1e-7 to 3e-7)."""
    vel = GEN.blob3d(_grid())
    alpha = np.full(vel.shape, GEN.ALPHA3, np.float32) if lossy else None
    shell = 2 * np.pi * GEN.F3 / GEN.C3
    greens, v_pot, gamma, n = born3d.born_operator_3d(
        torch.as_tensor(vel), GEN.F3, _grid(), PML, adjoint,
        attenuation=None if alpha is None else torch.as_tensor(alpha),
        shell_k0=shell)
    jg, jv, jgam, jn = jborn3d.born_operator_3d(
        vel, GEN.F3, JGrid3D.centered(GEN.G3_EXTENT, GEN.G3_H),
        JPMLConfig(**GEN.PML3), adjoint, attenuation=alpha, shell_k0=shell)
    assert _rel(v_pot, cpx.to_numpy(jv)) < 1e-5
    assert _rel(gamma, cpx.to_numpy(jgam)) < 1e-5
    assert float(n) == float(jn)
    w = GEN.born3d_sources(vel.shape)
    got = greens(torch.as_tensor(w))
    assert got.dtype == torch.complex64
    assert _rel(got, cpx.to_numpy(jg(cpx.of(w)))) < 1e-5


def test_born_operator_3d_derives_the_shell_in_float32():
    """With no ``shell_k0`` the shell is tuned on sqrt(mean(k^2)) of the
    medium: the port's operator equals the one built on that value taken in
    float64, rel < 1e-6. (The JAX package's float32 mean on the CPU is
    1.7e-5 off on this 15^3 volume and 3.3e-5 on a 25^3 one, which moves
    its eps by as much; hence the fixed shell of the comparison above.)"""
    vel = GEN.blob3d(_grid())
    k = 2 * np.pi * np.float32(GEN.F3) / vel.astype(np.float64)
    shell = float(np.sqrt(np.mean(k ** 2)))
    auto = born3d.born_operator_3d(torch.as_tensor(vel), GEN.F3, _grid(), PML)
    fixed = born3d.born_operator_3d(torch.as_tensor(vel), GEN.F3, _grid(),
                                    PML, shell_k0=shell)
    for a, b in zip(auto[1:3], fixed[1:3]):
        assert _rel(a, b) < 1e-6


@pytest.mark.parametrize("adjoint,lossy", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_born_gmres_solve_3d_matches_jax(ref, adjoint, lossy):
    """born_gmres_solve_3d == the JAX package's (tol 1e-6, restart 8): the
    same matvec count, fields within rel 1e-4."""
    vel = GEN.blob3d(_grid())
    alpha = np.full(vel.shape, GEN.ALPHA3, np.float32)
    u, n = born3d.born_gmres_solve_3d(
        torch.as_tensor(vel), torch.as_tensor(GEN.born3d_sources(vel.shape)),
        GEN.F3, _grid(), PML, adjoint=adjoint, tol=GEN.B3_TOL,
        maxiter=GEN.B3_MAXITER, restart=GEN.B3_RESTART,
        attenuation=torch.as_tensor(alpha) if lossy else None)
    key = f"{int(adjoint)}_{int(lossy)}"
    assert u.dtype == torch.complex64
    assert n == int(ref[f"b3_gmres_n_{key}"])
    assert _rel(u, ref[f"b3_gmres_{key}"]) < 1e-4


@pytest.mark.parametrize("adjoint", [False, True])
def test_born_series_solve_3d_matches_jax(ref, adjoint):
    """The plain series: the same host-read iteration count, fields within
    rel 1e-4."""
    vel = GEN.blob3d(_grid())
    u, n = born3d.born_series_solve_3d(
        torch.as_tensor(vel), torch.as_tensor(GEN.born3d_sources(vel.shape)),
        GEN.F3, _grid(), PML, adjoint=adjoint, iter_cap=GEN.B3_SERIES_CAP)
    assert n == int(ref[f"b3_series_n_{int(adjoint)}"])
    assert _rel(u, ref[f"b3_series_{int(adjoint)}"]) < 1e-4


def test_dft_route_matches_fft_route():
    """_dft3 is torch.fft.fftn / ifftn over the last three axes (rel <
    1e-5, the bound of tests/test_born3d.py:134) on a ragged volume, and a
    GMRES solve by the dft route gives the fft route's field (rel 1e-5,
    the same matvec count). BF16 ("default") is ~1e-3 off; "high" is FP32
    on the CPU."""
    rng = np.random.default_rng(7)
    x = torch.as_tensor((rng.standard_normal((2, 12, 10, 14))
                         + 1j * rng.standard_normal((2, 12, 10, 14))
                         ).astype(np.complex64))
    axes = (-3, -2, -1)
    assert _rel(born3d._dft3(x), torch.fft.fftn(x, dim=axes)) < 1e-5
    assert _rel(born3d._dft3(x, inverse=True),
                torch.fft.ifftn(x, dim=axes)) < 1e-5
    assert torch.equal(born3d._dft3(x, precision="high"), born3d._dft3(x))
    low = _rel(born3d._dft3(x, precision="default"),
               torch.fft.fftn(x, dim=axes))
    assert 1e-4 < low < 3e-2
    with pytest.raises(ValueError, match="precision"):
        born3d._dft3(x, precision="bf16")

    vel = torch.as_tensor(GEN.blob3d(_grid()))
    src = torch.as_tensor(GEN.born3d_sources(vel.shape))
    kw = dict(tol=1e-5, maxiter=GEN.B3_MAXITER, restart=GEN.B3_RESTART)
    uf, nf = born3d.born_gmres_solve_3d(vel, src, GEN.F3, _grid(), PML,
                                        spectral="fft", **kw)
    ud, nd = born3d.born_gmres_solve_3d(vel, src, GEN.F3, _grid(), PML,
                                        spectral="dft", **kw)
    assert nd == nf and _rel(ud, uf) < 1e-5


def test_spectral_auto_is_the_fft_route():
    """"auto" takes the fft route (the JAX package's choice on its CPU
    backend, and the card's A/B at 64^3); an unknown route raises."""
    assert not born3d._use_dft("auto") and not born3d._use_dft("fft")
    assert born3d._use_dft("dft")
    with pytest.raises(ValueError, match="spectral"):
        born3d._use_dft("mxu")


def test_born_solve_3d_diff_waits_for_the_3d_methods():
    """The differentiable 3D solve, which the 3D methods ride, runs: its
    forward is the plain solve's, by GMRES and by the series, lossless and
    lossy, bit for bit."""
    vel = torch.as_tensor(GEN.blob3d(_grid()))
    src = torch.as_tensor(GEN.born3d_sources(vel.shape))
    alpha = torch.full(vel.shape, GEN.ALPHA3)
    for att in (None, alpha):
        u = born3d.born_solve_3d_diff(vel, src, GEN.F3, _grid(), PML,
                                      tol=1e-4, attenuation=att)
        plain, _ = born3d.born_gmres_solve_3d(vel, src, GEN.F3, _grid(), PML,
                                              tol=1e-4, maxiter=600,
                                              restart=8, attenuation=att)
        assert torch.equal(u, plain)
    u = born3d.born_solve_3d_diff(vel, src, GEN.F3, _grid(), PML,
                                  iter_cap=50, use_gmres=False)
    plain, _ = born3d.born_series_solve_3d(vel, src, GEN.F3, _grid(), PML,
                                           iter_cap=50)
    assert torch.equal(u, plain)
