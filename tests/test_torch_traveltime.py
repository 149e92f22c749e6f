"""The port's 2D travel-time tomography held against the JAX package on the
CPU (fwi/eikonal.py, fwi/traveltime.py), on the 41^2 blob of
tests/golden/generate_torch.py: the eikonal fields of a batch of sources,
their receiver times and bent rays, the straight and bent tomograms of a
12-element ring and traveltime_init over synthetic traces (from
tests/golden/torch_traveltime.npz); the straight-ray times and the picks
(live); the per-source freeze of the batched solve, the ray map's adjoint
pair, the gradient's edge formulas and the default device.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from waveforminversionust_tpu import Grid2D as JGrid2D
from waveforminversionust_tpu.fwi import traveltime as jtraveltime
from waveforminversionust_tpu_torch.data.timedomain import TimeDomainDataset
from waveforminversionust_tpu_torch.fwi import eikonal, traveltime
from waveforminversionust_tpu_torch.models.grid import Grid2D

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _load_generator():
    spec = importlib.util.spec_from_file_location(
        "generate_torch", os.path.join(GOLDEN, "generate_torch.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


GEN = _load_generator()
GRID = Grid2D.centered(GEN.TT_EXTENT, GEN.TT_H)
SRC = np.asarray(GEN.TT_SRC, np.float32)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's outputs (tests/golden/generate_torch.py
    traveltime)."""
    return np.load(os.path.join(GOLDEN, "torch_traveltime.npz"))


@pytest.fixture(scope="module")
def fields():
    """The port's eikonal batch of the blob and its per-source iterations."""
    slow = 1.0 / GEN.tt_blob(GRID)
    t, it = eikonal._solve(
        slow, SRC, GRID,
        lambda t, s: eikonal._upwind_update(t, s, GRID.dx, GRID.dy),
        None, None, "cpu")
    return slow, t, it


def _rel_max(a, b):
    """max |a - b| / |b| over the nonzero entries of b."""
    a, b = np.asarray(a), np.asarray(b)
    nz = b != 0
    return float(np.max(np.abs(a - b)[nz] / np.abs(b[nz])))


def _ring_positions():
    """The ring's elements snapped to the grid, (n, 2)."""
    pos = GEN.tt_ring()
    return np.stack([GEN.tt_snap(GRID.x, pos[:, 0]),
                     GEN.tt_snap(GRID.y, pos[:, 1])], 1)


def _ring():
    """(tx, rx) positions of the ring's accepted pairs."""
    pos = _ring_positions()
    ti, ri = GEN.tt_pairs(GEN.TT_RING["n"], GEN.TT_EXCLUDE)
    return pos[ti], pos[ri]


def test_eikonal_batch_matches_jax(ref, fields):
    """The batched fields and their receiver times at max relative 1e-5."""
    _, t, _ = fields
    assert t.shape == (len(SRC),) + GRID.shape and t.dtype == torch.float32
    assert _rel_max(t, ref["tt_eik"]) < 1e-5
    si = np.arange(6) % len(SRC)
    te = eikonal.eikonal_receiver_times(t, si, ref["tt_eik_rx"], GRID)
    assert _rel_max(te, ref["tt_eik_times"]) < 1e-5


def test_each_source_freezes_on_its_own(fields):
    """The JAX package's vmap of a while_loop stops each source at its own
    iteration: a batch gives each source alone's field, bit for bit, and
    the sources stop at different counts."""
    slow, t, it = fields
    for k, src in enumerate(SRC):
        one = eikonal.eikonal_solve(slow, src, GRID, device="cpu")
        assert torch.equal(one, t[k])
    assert len(set(it.tolist())) > 1
    assert int(it.max()) < 2 * (GRID.nx + GRID.ny)


def test_trace_rays_matches_jax(ref, fields):
    """Bent rays of the batch: points within 1e-2 of a step, lengths at
    relative 1e-4."""
    _, t, _ = fields
    si = np.arange(6) % len(SRC)
    step = 0.5 * GEN.TT_H
    pts, lengths = eikonal.trace_rays(t, si, SRC[si], ref["tt_eik_rx"], GRID,
                                      n_steps=GEN.TT_STEPS, step=step,
                                      n_samples=GEN.TT_SAMPLES)
    assert pts.shape == (6, GEN.TT_SAMPLES, 2)
    assert np.abs(pts.numpy() - ref["tt_pts"]).max() < 1e-2 * step
    assert _rel_max(lengths, ref["tt_lengths"]) < 1e-4


def test_gradient_edges_are_first_order():
    """jnp.gradient's formulas: central differences inside, one-sided
    first-order differences on the edge rows and columns (numpy's
    edge_order=1)."""
    rng = np.random.default_rng(0)
    t = rng.standard_normal((2,) + GRID.shape).astype(np.float32)
    gx, gy = eikonal._gradient(torch.as_tensor(t), GRID)
    ny, nx = np.gradient(t.astype(np.float64), GRID.dy, GRID.dx,
                         axis=(-2, -1), edge_order=1)
    np.testing.assert_allclose(gx.numpy(), nx, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(gy.numpy(), ny, rtol=1e-5, atol=1e-3)


def test_straight_ray_times_matches_jax():
    """Live: the straight-ray times through the blob at rtol 1e-5
    (tests/test_traveltime.py:33)."""
    tx, rx = _ring()
    slow = 1.0 / GEN.tt_blob(GRID)
    mine = traveltime.straight_ray_times(slow, tx, rx, GRID, n_samples=96,
                                         device="cpu")
    theirs = jtraveltime.straight_ray_times(
        slow, tx, rx, JGrid2D.centered(GEN.TT_EXTENT, GEN.TT_H),
        n_samples=96)
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-5)


def test_ray_map_adjoint_pair():
    """<B x, y> = <x, B^T y> of the ray map (its transpose a scatter of the
    gather's weights) to FP32 accuracy, with and without row scales."""
    tx, rx = _ring()
    pts, dist = traveltime._chords(torch.as_tensor(tx, dtype=torch.float32),
                                   torch.as_tensor(rx, dtype=torch.float32),
                                   64)
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal(GRID.shape), dtype=torch.float32)
    y = torch.as_tensor(rng.standard_normal(len(tx)), dtype=torch.float32)
    for scale in (None, dist / 2):
        ray = traveltime._RayMap(pts, GRID, row_scale=scale)
        lhs = float(torch.dot(ray.apply(x).double(), y.double()))
        rhs = float(torch.sum(x.double() * ray.transpose(y).double()))
        assert lhs == pytest.approx(rhs, rel=1e-5)


@pytest.mark.parametrize("method", ["straight", "bent"])
def test_tomograms_match_jax(ref, method):
    """The straight and bent tomograms of the ring's exact times (the port's,
    held to the JAX package's above) at atol 0.5 m/s (the golden velocity
    bound), their CG residuals at rtol 1e-2."""
    tx, rx = _ring()
    t_obs = traveltime.straight_ray_times(1.0 / GEN.tt_blob(GRID), tx, rx,
                                          GRID, device="cpu")
    fn, kw = ((traveltime.invert_travel_times, {}) if method == "straight"
              else (traveltime.invert_travel_times_bent,
                    dict(n_outer=GEN.TT_OUTER)))
    vel, relres = fn(t_obs.numpy(), tx, rx, GRID, c_ref=GEN.TT_C,
                     lam_smooth=GEN.TT_LAM, device="cpu", **kw)
    np.testing.assert_allclose(vel.numpy(), ref[f"tt_{method}"], atol=0.5)
    assert float(relres) == pytest.approx(float(ref[f"tt_{method}_relres"]),
                                          rel=1e-2)


@pytest.mark.parametrize("method", ["straight", "bent"])
def test_traveltime_init_matches_jax(ref, method):
    """traveltime_init over traces whose envelopes peak at the exact times:
    the picks (host numpy, the JAX package's code) and the tomogram, at
    atol 0.5 m/s."""
    td = GEN._tt_dataset(GRID, _ring_positions(),
                         ref["tt_traces"], ref["tt_times"],
                         cls=TimeDomainDataset)
    c0, t_obs, _, _ = traveltime.traveltime_init(
        td, GRID, num_excluded_each_side=GEN.TT_EXCLUDE, c_ref=GEN.TT_C,
        method=method, n_outer=GEN.TT_OUTER, return_times=True,
        device="cpu")
    assert isinstance(c0, np.ndarray) and c0.shape == GRID.shape
    np.testing.assert_allclose(c0, ref[f"tt_init_{method}"], atol=0.5)
    if method == "straight":
        t_ref = traveltime._predicted_times(td.x_circ, td.y_circ, GEN.TT_C)
        np.testing.assert_array_equal(
            traveltime.pick_arrival_times(td.traces, td.times, td.df, t_ref),
            jtraveltime.pick_arrival_times(td.traces, td.times, td.df, t_ref))
        with pytest.raises(ValueError, match="travel-time method"):
            traveltime.traveltime_init(td, GRID, method="curved",
                                       device="cpu")


def test_entry_points_default_to_the_card():
    """Without a device named, a numpy input runs on the card, and raises
    where there is none; a tensor runs where it lives."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    slow = np.full(GRID.shape, 1 / 1500.0, np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eikonal.eikonal_solve_batch(slow, SRC, GRID)
    tx, rx = _ring()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        traveltime.invert_travel_times(np.ones(len(tx)), tx, rx, GRID)
    t = eikonal.eikonal_solve_batch(torch.as_tensor(slow), SRC[:1], GRID)
    assert t.device.type == "cpu"
