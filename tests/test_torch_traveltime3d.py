"""The port's 3D travel-time tomography held against the JAX package on the
CPU (fwi/eikonal3d.py, fwi/traveltime3d.py), on the 15^3 blob of
tests/golden/generate_torch.py: the eikonal volumes of two sources, their
receiver times and bent rays, the straight and bent tomograms of a
12-element cylinder and traveltime_init_3d over synthetic traces (from
tests/golden/torch_traveltime.npz); the straight-ray times (live); the
per-source freeze, the local solver's fall-through on missing neighbours
and the ray map's adjoint pair in 3D.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from waveforminversionust_tpu.fwi import traveltime3d as jtraveltime3d
from waveforminversionust_tpu.models.grid3d import Grid3D as JGrid3D
from waveforminversionust_tpu_torch.data.timedomain3d import \
    TimeDomainDataset3D
from waveforminversionust_tpu_torch.fwi import (eikonal, eikonal3d,
                                                traveltime, traveltime3d)
from waveforminversionust_tpu_torch.models import acquisition3d
from waveforminversionust_tpu_torch.models.grid3d import Grid3D

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _load_generator():
    spec = importlib.util.spec_from_file_location(
        "generate_torch", os.path.join(GOLDEN, "generate_torch.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


GEN = _load_generator()
GRID = Grid3D.centered(GEN.TT3_EXTENT, GEN.TT3_H)
SRC = np.asarray(GEN.TT3_SRC, np.float32)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's outputs (tests/golden/generate_torch.py
    traveltime)."""
    return np.load(os.path.join(GOLDEN, "torch_traveltime.npz"))


@pytest.fixture(scope="module")
def volumes():
    """The port's eikonal batch of the blob and its per-source iterations."""
    slow = 1.0 / GEN.tt_blob(GRID, radius=3e-3)
    t, it = eikonal._solve(
        slow, SRC, GRID,
        lambda t, s: eikonal3d._upwind_update_3d(t, s, GRID.dx, GRID.dy,
                                                 GRID.dz),
        None, None, "cpu")
    return slow, t, it


def _pairs():
    """(tx, rx) snapped positions of the cylinder's accepted pairs, and
    the element positions and their snapped twins."""
    pos = acquisition3d.cylinder_positions(**GEN.TT3_POS)
    snapped = np.stack([GEN.tt_snap(GRID.x, pos[:, 0]),
                        GEN.tt_snap(GRID.y, pos[:, 1]),
                        GEN.tt_snap(GRID.z, pos[:, 2])], 1)
    acq = acquisition3d.build_acquisition3d(GRID, pos,
                                            min_angle=GEN.TT3_MIN_ANGLE)
    n, n_act = acq.rx_elem.shape
    tx_e = np.repeat(np.arange(n), n_act)
    return snapped[tx_e], snapped[acq.rx_elem.ravel()], pos, snapped


def test_eikonal_volumes_match_jax(ref, volumes):
    """The volumes at 1e-5 of their largest time, and the receiver times at
    max relative 1e-5. The 3-sided root's b^2 - a c cancels, and the JAX
    package's CPU code rounds its products otherwise from the first sweep
    (one ulp, amplified there), so near the source, where the times are a
    few cells' worth, an entry may differ by ~1e-5 of itself: the volumes
    are held against the largest time instead."""
    _, t, _ = volumes
    assert t.shape == (len(SRC),) + GRID.shape
    tj = ref["tt3_eik"]
    assert np.abs(t.numpy() - tj).max() < 1e-5 * np.abs(tj).max()
    si = np.arange(4) % len(SRC)
    te = eikonal3d.eikonal_receiver_times_3d(t, si, ref["tt3_eik_rx"], GRID)
    np.testing.assert_allclose(te.numpy(), ref["tt3_eik_times"], rtol=1e-5)


def test_each_source_freezes_on_its_own(volumes):
    """A batch gives each source alone's volume, bit for bit."""
    slow, t, it = volumes
    for k, src in enumerate(SRC):
        one = eikonal3d.eikonal_solve_3d(slow, src, GRID, device="cpu")
        assert torch.equal(one, t[k])
    assert int(it.max()) < 2 * sum(GRID.shape)


def test_missing_neighbours_fall_through():
    """A voxel whose only finite neighbour is along one axis takes the
    1-sided root off it; the +INF neighbours, clamped, never select the
    2- or 3-sided roots."""
    t = torch.full((1,) + GRID.shape, eikonal._INF)
    t[0, 7, 7, 7] = 0.0
    s = torch.full(GRID.shape, 1 / 1500.0)
    out = eikonal3d._upwind_update_3d(t, s, GRID.dx, GRID.dy, GRID.dz)
    h_over_c = np.float32(GRID.dx) / np.float32(1500.0)
    for idx in ((7, 7, 8), (7, 8, 7), (8, 7, 7), (6, 7, 7)):
        assert float(out[(0,) + idx]) == pytest.approx(h_over_c, rel=1e-6)
    assert float(out[0, 8, 8, 7]) == eikonal._INF


def test_trace_rays_3d_matches_jax(ref, volumes):
    """Bent rays: points within 1e-2 of a step, lengths at relative
    1e-4."""
    _, t, _ = volumes
    si = np.arange(4) % len(SRC)
    step = 0.5 * GEN.TT3_H
    pts, lengths = eikonal3d.trace_rays_3d(
        t, si, SRC[si], ref["tt3_eik_rx"], GRID, n_steps=GEN.TT3_STEPS,
        step=step, n_samples=GEN.TT3_SAMPLES)
    assert pts.shape == (4, GEN.TT3_SAMPLES, 3)
    assert np.abs(pts.numpy() - ref["tt3_pts"]).max() < 1e-2 * step
    np.testing.assert_allclose(lengths.numpy(), ref["tt3_lengths"], rtol=1e-4)


def test_straight_ray_times_3d_matches_jax():
    """Live: the straight-ray times through the blob at rtol 1e-5, and the
    3D ray map's adjoint pair to FP32 accuracy."""
    tx, rx, _, _ = _pairs()
    slow = 1.0 / GEN.tt_blob(GRID, radius=3e-3)
    mine = traveltime3d.straight_ray_times_3d(slow, tx, rx, GRID,
                                              n_samples=40, device="cpu")
    theirs = jtraveltime3d.straight_ray_times_3d(
        slow, tx, rx, JGrid3D.centered(GEN.TT3_EXTENT, GEN.TT3_H),
        n_samples=40)
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-5)

    pts, _ = traveltime._chords(torch.as_tensor(tx, dtype=torch.float32),
                                torch.as_tensor(rx, dtype=torch.float32), 40)
    ray = traveltime._RayMap(pts, GRID)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal(GRID.shape), dtype=torch.float32)
    y = torch.as_tensor(rng.standard_normal(len(tx)), dtype=torch.float32)
    lhs = float(torch.dot(ray.apply(x).double(), y.double()))
    rhs = float(torch.sum(x.double() * ray.transpose(y).double()))
    assert lhs == pytest.approx(rhs, rel=1e-5)


@pytest.mark.parametrize("method", ["straight", "bent"])
def test_tomograms_3d_match_jax(ref, method):
    """The straight and bent tomograms of the cylinder's exact times (the
    port's, held to the JAX package's above) at atol 0.5 m/s, their CG
    residuals at rtol 1e-2."""
    tx, rx, _, _ = _pairs()
    t_obs = traveltime3d.straight_ray_times_3d(
        1.0 / GEN.tt_blob(GRID, radius=3e-3), tx, rx, GRID, device="cpu")
    fn, kw = ((traveltime3d.invert_travel_times_3d, {})
              if method == "straight"
              else (traveltime3d.invert_travel_times_bent_3d,
                    dict(n_outer=GEN.TT_OUTER)))
    vel, relres = fn(t_obs.numpy(), tx, rx, GRID, c_ref=GEN.TT_C,
                     lam_smooth=GEN.TT_LAM, device="cpu", **kw)
    np.testing.assert_allclose(vel.numpy(), ref[f"tt3_{method}"], atol=0.5)
    assert float(relres) == pytest.approx(
        float(ref[f"tt3_{method}_relres"]), rel=1e-2)


@pytest.mark.parametrize("method", ["straight", "bent"])
def test_traveltime_init_3d_matches_jax(ref, method):
    """traveltime_init_3d over traces whose envelopes peak at the exact
    times, at atol 0.5 m/s; an unknown method raises."""
    _, _, pos, snapped = _pairs()
    td = GEN._tt_dataset_3d(GRID, pos, snapped, ref["tt3_traces"],
                            ref["tt_times"], cls=TimeDomainDataset3D)
    c0 = traveltime3d.traveltime_init_3d(
        td, GRID, min_angle=GEN.TT3_MIN_ANGLE, c_ref=GEN.TT_C, method=method,
        n_outer=GEN.TT_OUTER, device="cpu")
    assert isinstance(c0, np.ndarray) and c0.shape == GRID.shape
    np.testing.assert_allclose(c0, ref[f"tt3_init_{method}"], atol=0.5)
    if method == "straight":
        with pytest.raises(ValueError, match="travel-time method"):
            traveltime3d.traveltime_init_3d(td, GRID, method="curved",
                                            device="cpu")
