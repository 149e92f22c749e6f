"""The port's operators held against the JAX package on the CPU.

Inputs are made with numpy from a seed and fed to both packages (the port
through ``interop``). Where the JAX side reaches a Pallas kernel, the
comparison is with its plain split-engine reference, as
tests/test_pallas_factor.py does. The grid is that test's 61x61 one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveforminversionust_tpu import (Grid2D as JGrid, PMLConfig as JPML,
                                      SolverConfig as JSolver,
                                      StencilConfig as JStencil)
from waveforminversionust_tpu.models.phantom import smooth_blob_phantom
from waveforminversionust_tpu.ops import cpx
from waveforminversionust_tpu.ops import solve as jsolve
from waveforminversionust_tpu.ops.split_engine import (
    adjoint_coefficients_cpx, banded_factor_cpx, banded_solve_cpx,
    h_apply_adjoint_cpx, h_apply_cpx, helmholtz_coefficients_cpx)
from waveforminversionust_tpu.ops.stencil import helmholtz_coefficients as jcoeffs_native
from waveforminversionust_tpu.ops.stencil import stencil_params as jstencil_params
from waveforminversionust_tpu_torch import interop
from waveforminversionust_tpu_torch.config import (PMLConfig, SolverConfig,
                                                   StencilConfig)
from waveforminversionust_tpu_torch.models.grid import Grid2D
from waveforminversionust_tpu_torch.ops import apply, banded, batched_inv
from waveforminversionust_tpu_torch.ops import solve as tsolve
from waveforminversionust_tpu_torch.ops.stencil import (d_map,
                                                        helmholtz_coefficients,
                                                        stencil_params)

F = 350e3
EXTENT = 24e-3


def _grids():
    return JGrid.centered(EXTENT, 0.8e-3), Grid2D.centered(EXTENT, 0.8e-3)


def _vel():
    jg, _ = _grids()
    return smooth_blob_phantom(jg, radius=EXTENT / 3, dc=60)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _planes_np(c):
    return cpx.to_numpy(c).astype(np.complex64)


def _to_t(z):
    return interop.complex_tensor(np.asarray(z))


def _random_fields(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.fixture(scope="module")
def jax_planes():
    jg, _ = _grids()
    return helmholtz_coefficients_cpx(jnp.asarray(_vel()), jg, jnp.float32(F),
                                      JPML(l_pml=2.4e-3))


@pytest.mark.parametrize("corner_mode", ["matlab", "jax_port"])
@pytest.mark.parametrize("attenuation", [False, True])
def test_coefficient_planes_match(corner_mode, attenuation):
    """Port planes == the JAX split builder and the native builder: rtol
    1e-5 per entry, with an absolute floor of 1e-5 of the largest entry
    (the planes sum terms of ~1/h^2, so small entries carry cancellation
    error at that scale)."""
    jg, tg = _grids()
    vel = _vel()
    alpha = (np.random.default_rng(5).uniform(0, 20, jg.shape)
             .astype(np.float32) if attenuation else None)
    kw = dict(attenuation=alpha)
    ref_split = _planes_np(helmholtz_coefficients_cpx(
        jnp.asarray(vel), jg, jnp.float32(F), JPML(l_pml=2.4e-3),
        JStencil(corner_mode=corner_mode), **kw))
    ref_native = np.asarray(jcoeffs_native(
        jnp.asarray(vel), jg, jnp.float32(F), JPML(l_pml=2.4e-3),
        JStencil(corner_mode=corner_mode), **kw))
    out = helmholtz_coefficients(
        torch.as_tensor(vel), tg, F, PMLConfig(l_pml=2.4e-3),
        StencilConfig(corner_mode=corner_mode),
        attenuation=None if alpha is None else torch.as_tensor(alpha)).numpy()
    for ref in (ref_split, ref_native):
        np.testing.assert_allclose(out, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())


def test_apply_and_adjoint_apply_match(jax_planes):
    """Plain apply / adjoint apply == split_engine h_apply_cpx /
    h_apply_adjoint_cpx: rel 1e-6; and the gather form with the adjoint
    planes (the stencil kernel's adjoint feed) == the scatter form."""
    planes = _planes_np(jax_planes)
    u = _random_fields(0, (3,) + planes.shape[1:])
    ct, ut = _to_t(planes), _to_t(u)
    for jfn, tfn in ((h_apply_cpx, apply.h_apply),
                     (h_apply_adjoint_cpx, apply.h_apply_adjoint)):
        ref = cpx.to_numpy(jfn(jax_planes, cpx.of(u)))
        assert _rel(tfn(ct, ut).numpy(), ref) < 1e-6
    adj_ref = _planes_np(adjoint_coefficients_cpx(jax_planes))
    adj = apply.adjoint_coefficients(ct)
    np.testing.assert_allclose(adj.numpy(), adj_ref, rtol=0, atol=0)
    assert _rel(apply.h_apply(adj, ut).numpy(),
                apply.h_apply_adjoint(ct, ut).numpy()) < 1e-6


@pytest.mark.parametrize("site", ["whole", "tiled"])
def test_stencil_kernel_wrapper_matches_pallas(site):
    """The port's stencil wrapper on CPU tensors (its plain path) == the
    JAX package's Pallas apply in interpret mode, at the whole-field call
    site (h_apply_pallas_cpx) and the y-tiled one (h_apply_tiled_cpx, tile
    8: 24 rows are three tiles), forward and, through each side's adjoint
    planes, adjoint: rel 1e-6, on seeded 24 x 20 planes and 3 fields."""
    from waveforminversionust_tpu.ops.pallas_stencil import (h_apply_pallas_cpx,
                                                             h_apply_tiled_cpx)
    from waveforminversionust_tpu_torch.ops import kernel_stencil

    def pallas(c, u):
        if site == "whole":
            return h_apply_pallas_cpx(c, u, interpret=True)
        return h_apply_tiled_cpx(c, u, interpret=True, tile=8)

    planes = _random_fields(11, (9, 24, 20))
    u = _random_fields(12, (3, 24, 20))
    jp, ct, ut = cpx.of(planes), _to_t(planes), _to_t(u)
    for jplanes, tplanes in ((jp, ct),
                             (adjoint_coefficients_cpx(jp),
                              apply.adjoint_coefficients(ct))):
        ref = cpx.to_numpy(pallas(jplanes, cpx.of(u)))
        out = kernel_stencil.h_apply_kernel(tplanes, ut)
        assert _rel(out.numpy(), ref) < 1e-6


def test_plain_factor_matches(jax_planes):
    """Plain block-Thomas G == split_engine.banded_factor_cpx on the 61x61
    grid (nx not a panel multiple): rel < 5e-6 (tests/test_pallas_factor.py)."""
    g_ref = cpx.to_numpy(banded_factor_cpx(jax_planes, 0).g)
    fac = banded.banded_factor(_to_t(_planes_np(jax_planes)))
    assert _rel(fac.g.numpy(), g_ref) < 5e-6


@pytest.mark.parametrize("adjoint", [False, True])
def test_plain_sweeps_match(jax_planes, adjoint):
    """Sweeps through the JAX factor's G == banded_solve_cpx: rel < 1e-5;
    the true residual of the port's solve < 2e-5."""
    jfac = banded_factor_cpx(jax_planes, 0)
    tfac = interop.banded_factor(np.asarray(jfac.g.re), np.asarray(jfac.g.im),
                                 np.asarray(jax_planes.re),
                                 np.asarray(jax_planes.im))
    b = _random_fields(1, (3,) + tfac.coeffs.shape[1:])
    ref = cpx.to_numpy(banded_solve_cpx(jfac, cpx.of(b), adjoint=adjoint))
    x = banded.banded_solve(tfac, _to_t(b), adjoint=adjoint)
    assert _rel(x.numpy(), ref) < 1e-5
    op = apply.h_apply_adjoint if adjoint else apply.h_apply
    assert _rel(op(tfac.coeffs, x).numpy(), b) < 2e-5


@pytest.mark.parametrize("steps", [2, 4])
def test_schulz_hybrid_factor_matches(jax_planes, monkeypatch, steps):
    """banded_factor(schulz_steps=...) against the JAX package's
    banded_factor_cpx with the same steps, on the 61x61 operator: the
    solves through each hybrid factor agree within the hybrid's bound of
    tests/test_split_engine.py (1e-4), as does the port's true residual. At
    4 steps the warm-started rows are taken (their err2 <= 1e-6) on all
    but a few of the rows the head/tail/every-16th rule leaves to Schulz;
    at 2 steps none pass and every row takes the exact inverse."""
    from waveforminversionust_tpu_torch.ops import banded as tbanded
    tried, taken = [], []
    refine = tbanded._schulz_refine

    def spy(g, s, k):
        out = refine(g, s, k)
        tried.append(1)
        taken.append(float(out[1]) <= 1e-6)
        return out

    monkeypatch.setattr(tbanded, "_schulz_refine", spy)
    planes = _planes_np(jax_planes)
    fac = banded.banded_factor(_to_t(planes), schulz_steps=steps)
    ny = planes.shape[1]
    assert len(tried) == ny - 12 - 2 - len(range(16, ny - 2, 16))
    assert sum(taken) >= (len(tried) - 2 if steps == 4 else 0)
    b = _random_fields(2, (3,) + planes.shape[1:])
    ref = cpx.to_numpy(banded_solve_cpx(
        banded_factor_cpx(jax_planes, schulz_steps=steps), cpx.of(b)))
    x = banded.banded_solve(fac, _to_t(b))
    assert _rel(x.numpy(), ref) < 1e-4
    assert _rel(apply.h_apply(fac.coeffs, x).numpy(), b) < 1e-4


@pytest.mark.parametrize("adjoint", [False, True])
def test_fast_sweeps_match(jax_planes, adjoint):
    """The precomputed sweep operators (complex64 M, N, R) against the JAX
    package's real-embedded ones (banded_factor_cpx(precompute_sweeps=
    True)) and against the port's own stock sweeps, forward and adjoint:
    rel 1e-5 (tests/test_split_engine.py's bound)."""
    planes = _to_t(_planes_np(jax_planes))
    fast = banded.banded_factor(planes, precompute_sweeps=True)
    assert fast.sweeps is not None
    assert fast.sweeps.m.shape == fast.g.shape
    b = _random_fields(3, (3,) + planes.shape[1:])
    ref = cpx.to_numpy(banded_solve_cpx(
        banded_factor_cpx(jax_planes, precompute_sweeps=True), cpx.of(b),
        adjoint=adjoint))
    x = banded.banded_solve(fast, _to_t(b), adjoint=adjoint).numpy()
    stock = banded.banded_solve(fast._replace(sweeps=None), _to_t(b),
                                adjoint=adjoint).numpy()
    assert _rel(x, ref) < 1e-5
    assert _rel(x, stock) < 1e-5


def _stencil_params_f64(vmin, vmax, h):
    """The dispersion fit of ops/stencil.py (fix_b) in float64 numpy."""
    l, r = 100, 10
    gmin, gmax = vmin / (F * h), vmax / (F * h)
    theta = np.arange(l) * np.pi / (4 * (l - 1))
    G = 1 / (1 / gmax + np.arange(r) / (r - 1) * (1 / gmin - 1 / gmax))
    TH, GG = np.meshgrid(theta, G)
    P, Q = np.cos(2 * np.pi * np.cos(TH) / GG), np.cos(2 * np.pi * np.sin(TH) / GG)
    S1 = 2 * GG ** 2 * (1 - P - Q + P * Q)
    S4 = 2 * np.pi ** 2 + GG ** 2 * (2 * P * Q - P - Q)
    M = np.stack([(np.pi ** 2 * (2 - P - Q)).ravel(),
                  (2 * np.pi ** 2 * (1 - P * Q)).ravel()], 1)
    return np.linalg.lstsq(M, S4.ravel() - 5 / 6 * S1.ravel(), rcond=None)[0]


@pytest.mark.parametrize("w", [8, 16, 32])
def test_two_level_blocking_keeps_fp32_accuracy(jax_planes, w):
    """The blocked Gauss-Jordan at width 64 with its pivot blocks inverted
    by the same routine at width w (what the factor kernels' pivot step does
    inside a thread block) on Schur rows of the 61x61 operator (first,
    second, a middle one, last; the Dirichlet rows carry pivots ~1.6e6), in
    complex64, against torch.linalg.inv in complex128: rel < 5e-6, the
    factor's own bound (tests/test_pallas_factor.py)."""
    c128 = _to_t(_planes_np(jax_planes)).to(torch.complex128)
    g128 = banded.banded_factor(c128).g
    ny = c128.shape[1]
    for i in (0, 1, ny // 2, ny - 1):
        s128 = banded.schur_complement(c128, i, g128[i - 1] if i else None)
        got = batched_inv.batched_inv(
            s128.to(torch.complex64)[None], block=64,
            pivot_inv=lambda p: batched_inv.batched_inv(p, block=w))[0]
        want = torch.linalg.inv(s128)
        rel = float(torch.linalg.norm(got.to(torch.complex128) - want)
                    / torch.linalg.norm(want))
        assert rel < 5e-6, (i, rel)


def test_stencil_params_match():
    """(d, e) of the port's FP32 QR fit within 1e-5 of the float64 fit, and
    within 1e-4 of the JAX package's, whose FP32 normal equations square
    cond(M) (~1.5e3) and sit ~4e-5 from the float64 fit."""
    vel = _vel()
    vmin, vmax = float(vel.min()), float(vel.max())
    _, d, e = stencil_params(torch.tensor(vmin), torch.tensor(vmax), F, 0.8e-3,
                             1.0)
    _, jd, je = jstencil_params(jnp.float32(vmin), jnp.float32(vmax),
                                jnp.float32(F), jnp.float32(0.8e-3),
                                jnp.float32(1.0))
    ref = _stencil_params_f64(vmin, vmax, 0.8e-3)
    port = np.array([float(d), float(e)])
    assert np.max(np.abs(port - ref) / ref) < 1e-5
    assert np.max(np.abs(port - [float(jd), float(je)]) / ref) < 1e-4


@pytest.mark.parametrize("adjoint", [False, True])
def test_operator_solve_matches_split_path(adjoint):
    """helmholtz_operator_solve with the d_map row scaling, the balanced
    w-space adjoint and a runtime extra_refine pass == the JAX split path
    on the same planes (carried across): rel < 1e-5."""
    jg, tg = _grids()
    vel = _vel()
    src = _random_fields(2, (2,) + jg.shape)
    jcfg = JSolver(split_complex=True, pml=JPML(l_pml=2.4e-3))
    jop = jsolve.make_helmholtz_operator(jnp.asarray(vel), jnp.float32(F), jg,
                                         jcfg)
    ref = cpx.to_numpy(jsolve.helmholtz_operator_solve(
        jop, cpx.of(src), jg, jcfg, adjoint=adjoint,
        extra_refine=jnp.asarray(True)))
    tcfg = SolverConfig(pml=PMLConfig(l_pml=2.4e-3))
    coeffs = interop.complex_tensor(np.asarray(jop.coeffs.re),
                                    np.asarray(jop.coeffs.im))
    top = tsolve.HelmholtzOperator(
        vel=torch.as_tensor(vel), f=F, coeffs=coeffs, precond=None,
        factor=tsolve.factor_operator(coeffs, tcfg), d_map=d_map(tg))
    out = tsolve.helmholtz_operator_solve(top, _to_t(src), tg, tcfg,
                                          adjoint=adjoint, extra_refine=True)
    assert _rel(out.numpy(), ref) < 1e-5
    # and it solves the balanced system: H_s u = D s, or H_s^H (u / D) = s
    if adjoint:
        res, rhs = apply.h_apply_adjoint(coeffs, out / top.d_map), src
    else:
        res, rhs = apply.h_apply(coeffs, out), src * top.d_map.numpy()
    assert _rel(res.numpy(), rhs) < 2e-5


def test_solve_helmholtz_matches_split_path():
    """solve_helmholtz (the synthesizer's entry, velocity in) == the JAX
    split path, forward and adjoint: rel < 5e-5, because each package
    builds its own planes and their (d, e) fits differ by ~4e-5 (see
    test_stencil_params_match), which moves the planes by ~5e-6 and the
    solution by ~2e-5; the reported residual stays < 2e-5. Cold, and warm
    from x0 = 0.9 x the cold solution (a warm start far from the answer
    makes the correction's RHS, and its f32 error, large)."""
    jg, tg = _grids()
    vel = _vel()
    src = _random_fields(3, (2,) + jg.shape)
    jcfg = JSolver(split_complex=True, pml=JPML(l_pml=2.4e-3))
    tcfg = SolverConfig(pml=PMLConfig(l_pml=2.4e-3))
    for adjoint in (False, True):
        x0 = None
        for _ in ("cold", "warm"):
            ref, _ = jsolve.solve_helmholtz(
                jnp.asarray(vel), cpx.of(src), jnp.float32(F), jg, jcfg,
                adjoint=adjoint, x0=None if x0 is None else cpx.of(x0))
            out, info = tsolve.solve_helmholtz(
                torch.as_tensor(vel), _to_t(src), F, tg, tcfg,
                adjoint=adjoint, x0=None if x0 is None else _to_t(x0))
            ref = cpx.to_numpy(ref)
            assert _rel(out.numpy(), ref) < 5e-5
            assert float(info.rel_residual.max()) < 2e-5
            x0 = 0.9 * ref


def test_stale_factor_is_reused_whole(monkeypatch):
    """Frozen-factor structure: a stale operator keeps the factor's G with
    its OWN planes for the sweeps, while the refinement residual targets
    the CURRENT planes; and one refinement pass brings the stale solve
    closer to the current operator's solution."""
    _, tg = _grids()
    cfg = SolverConfig(pml=PMLConfig(l_pml=2.4e-3))
    vel0 = torch.as_tensor(_vel())
    vel1 = vel0 * 1.01
    stale = tsolve.make_helmholtz_operator(vel0, F, tg, cfg)
    current = tsolve.make_helmholtz_operator(vel1, F, tg, cfg)
    op = current._replace(factor=stale.factor)  # what the CG loop builds
    src = _to_t(_random_fields(4, (2,) + tg.shape))

    seen = []
    sweeps = tsolve._sweeps(stale.factor, cfg)

    def spy_sweeps(factor, rhs, adjoint=False):
        seen.append(("sweep", factor.coeffs))
        return sweeps(factor, rhs, adjoint=adjoint)

    make_apply = tsolve.make_apply

    def spy_apply(coeffs, cfg_, adjoint=False):
        seen.append(("apply", coeffs))
        return make_apply(coeffs, cfg_, adjoint)

    monkeypatch.setattr(tsolve, "_sweeps", lambda factor, cfg_: spy_sweeps)
    monkeypatch.setattr(tsolve, "make_apply", spy_apply)
    for adjoint in (False, True):
        seen.clear()
        refined = tsolve.helmholtz_operator_solve(op, src, tg, cfg,
                                                  adjoint=adjoint,
                                                  extra_refine=True)
        assert [k for k, _ in seen] == ["sweep", "apply", "sweep"]
        assert all(c is stale.coeffs for k, c in seen if k == "sweep")
        assert all(c is current.coeffs for k, c in seen if k == "apply")
        plain = tsolve.helmholtz_operator_solve(op, src, tg, cfg,
                                                adjoint=adjoint)
        exact = tsolve.helmholtz_operator_solve(current, src, tg, cfg,
                                                adjoint=adjoint)
        assert _rel(refined.numpy(), exact.numpy()) < \
            0.5 * _rel(plain.numpy(), exact.numpy())
