"""The port's broadband acquisition chain held against the JAX package on
the CPU, at tests/test_timedomain.py's sizes: the Hann window, the comb
sweep and the time synthesis, the (tx, rx, t) traces (live, one JAX
compile), extraction inverting synthesis exactly
(tests/test_timedomain.py:101-118), the gates (the JAX package's numpy
functions, live) and the chain from synthesis to a two-stage continuation
inversion against tests/golden/torch_solvers.npz.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from waveforminversionust_tpu import (AcquisitionConfig as JAcq,
                                      Grid2D as JGrid, PMLConfig as JPML,
                                      SolverConfig as JSolver)
from waveforminversionust_tpu.data import timedomain as jtd
from waveforminversionust_tpu_torch.config import (AcquisitionConfig,
                                                   ContinuationConfig,
                                                   FWIConfig, PMLConfig,
                                                   SolverConfig)
from waveforminversionust_tpu_torch.data import timedomain as td
from waveforminversionust_tpu_torch.data.synthesize import \
    synthesize_ring_dataset
from waveforminversionust_tpu_torch.fwi.runner import invert_dataset
from waveforminversionust_tpu_torch.models.grid import Grid2D
from waveforminversionust_tpu_torch.models.phantom import smooth_blob_phantom
from waveforminversionust_tpu_torch.ops.solve import solve_helmholtz

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GRID = Grid2D.centered(12e-3, 1.0e-3)
PML = dict(l_pml=2e-3)
ACQ = dict(num_elements=8, radius=9e-3)
BAND = dict(f_low=0.2e6, f_high=0.3e6, df=0.05e6, seed=5)


def _load_generator():
    spec = importlib.util.spec_from_file_location(
        "generate_torch", os.path.join(GOLDEN, "generate_torch.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


GEN = _load_generator()


@pytest.fixture(scope="module")
def ref():
    """The JAX package's outputs (tests/golden/generate_torch.py solvers)."""
    return np.load(os.path.join(GOLDEN, "torch_solvers.npz"))


@pytest.fixture(scope="module")
def dataset():
    """The port's broadband dataset over tests/test_timedomain.py's blob,
    and the blob."""
    vel = smooth_blob_phantom(GRID, radius=4e-3, dc=30)
    return td.synthesize_time_domain_dataset(
        vel, GRID, AcquisitionConfig(**ACQ),
        solver=SolverConfig(pml=PMLConfig(**PML)), device="cpu",
        **BAND), vel


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_hanning_window_matches_jax():
    assert np.array_equal(td.hanning_window(9), jtd.hanning_window(9))
    np.testing.assert_allclose(td.hanning_window(5),
                               [0.25, 0.75, 1.0, 0.75, 0.25], atol=1e-12)


def test_traces_match_jax(dataset):
    """synthesize_time_domain_dataset == the JAX package's: the same comb,
    spectrum, times and geometry, traces (8, 8, 12) within rel 1e-5
    (measured 7.9e-6: FP32 solves and an FP32 IDTFT in other orders)."""
    ds, vel = dataset
    want = jtd.synthesize_time_domain_dataset(
        vel, JGrid.centered(12e-3, 1.0e-3), JAcq(**ACQ),
        solver=JSolver(pml=JPML(**PML)), **BAND)
    for field in ("x", "y", "c", "x_circ", "y_circ", "freqs", "spectrum",
                  "times"):
        assert np.array_equal(getattr(ds, field), getattr(want, field)), field
    assert ds.df == want.df
    assert ds.traces.shape == (8, 8, 12) and ds.traces.dtype == np.complex64
    assert _rel(ds.traces, want.traces) < 1e-5


def test_extraction_inverts_synthesis_exactly(dataset):
    """Comb orthogonality: a comb line extracted from the traces (with the
    spectrum divided out) == the directly synthesized frequency-domain
    dataset, atol 1e-4 of its largest entry (tests/test_timedomain.py:
    101-118); the same through extract_frequency_data at every line."""
    ds, vel = dataset
    got = td.timedomain_to_ring_datasets(ds, [0.25e6])[0.25e6]
    direct = synthesize_ring_dataset(vel, GRID, AcquisitionConfig(**ACQ),
                                     f=0.25e6, seed=5,
                                     solver=SolverConfig(pml=PMLConfig(**PML)),
                                     device="cpu")
    np.testing.assert_allclose(got.rec_data, direct.rec_data,
                               atol=1e-4 * np.abs(direct.rec_data).max())
    lines = td.extract_frequency_data(ds.traces, ds.times, ds.freqs, ds.df,
                                      ds.spectrum)
    assert lines.shape == (3, 8, 8)
    np.testing.assert_allclose(lines[1], direct.rec_data,
                               atol=1e-4 * np.abs(direct.rec_data).max())
    with pytest.raises(ValueError, match="comb"):
        td.timedomain_to_ring_datasets(ds, [0.26e6])


def test_frequency_sweep_and_time_synthesis():
    """frequency_sweep == one solve a frequency (atol 2e-5 of the largest,
    tests/test_timedomain.py:23-35), and a single comb line synthesizes to
    u_f exp(i 2 pi f t) df (rtol 1e-4)."""
    grid = Grid2D.centered(12e-3, 0.8e-3)
    solver = SolverConfig(pml=PMLConfig(l_pml=2.4e-3))
    vel = smooth_blob_phantom(grid, radius=4e-3, dc=30)
    src = np.zeros(grid.shape, np.complex64)
    src[15, 15] = 1.0
    freqs = np.array([200e3, 300e3, 400e3])
    fields = td.frequency_sweep(vel, src, freqs, grid, solver, device="cpu")
    assert fields.shape == (3,) + grid.shape
    for i, f in enumerate(freqs):
        u, _ = solve_helmholtz(torch.as_tensor(vel), src[None], f, grid,
                               solver)
        np.testing.assert_allclose(fields[i].numpy(), u[0].numpy(),
                                   atol=2e-5 * float(u.abs().max()))
    rng = np.random.default_rng(0)
    uf = (rng.standard_normal((1, 8, 8))
          + 1j * rng.standard_normal((1, 8, 8))).astype(np.complex64)
    times = np.array([0.0, 1e-6, 2e-6])
    out = td.synthesize_time_fields(torch.as_tensor(uf), [2.0e5], times,
                                    5e3, np.ones(1))
    expect = uf[0][None] * np.exp(2j * np.pi * 2.0e5 * times)[:, None,
                                                               None] * 5e3
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-4)


def test_simulate_time_domain_causal():
    """The reference demo in miniature (tests/test_timedomain.py:52-71): the
    far element's energy arrives no earlier than distance / c."""
    grid = Grid2D.centered(12e-3, 1.0e-3)
    res = td.simulate_time_domain(
        np.full(grid.shape, 1500.0, np.float32), grid, element_idx=0,
        f_low=0.2e6, f_high=0.4e6, df=0.02e6, nt=41, num_elements=16,
        radius=9e-3, solver=SolverConfig(pml=PMLConfig(l_pml=2e-3)),
        device="cpu")
    assert res.wavefields_t.shape == (41,) + grid.shape
    assert res.channel_data.shape == (41, 16)
    assert np.isfinite(res.channel_data).all()
    t_arr = 18e-3 / 1500.0
    early = np.abs(res.channel_data[res.times < 0.4 * t_arr, 8]).max()
    late = np.abs(res.channel_data[res.times > t_arr, 8]).max()
    assert late > 4 * early


@pytest.mark.parametrize("taper", [0.0, 2e-6])
def test_gates_match_jax(taper):
    """The circular direct-arrival gate == the JAX package's (the same
    numpy), on the reference's 110 mm ring whose arrivals wrap the 40 us
    period; a window wider than the period raises."""
    ne, nt, df = 8, 400, 2.5e4
    theta = 2 * np.pi * np.arange(ne) / ne
    pos = np.stack([110e-3 * np.cos(theta), 110e-3 * np.sin(theta)], 1)
    times = np.arange(nt) / (nt * df)
    got = td._circular_gate_window(pos, times, df, 1500.0, 3e-6, 5e-6, taper)
    want = jtd._circular_gate_window(pos, times, df, 1500.0, 3e-6, 5e-6,
                                     taper)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    rng = np.random.default_rng(6)
    traces = (rng.standard_normal((ne, ne, nt))
              + 1j * rng.standard_normal((ne, ne, nt))).astype(np.complex64)
    ds = td.TimeDomainDataset(
        x=np.zeros(2), y=np.zeros(2), c=np.zeros((2, 2)), x_circ=pos[:, 0],
        y_circ=pos[:, 1], freqs=np.array([2e5]), df=df, spectrum=np.ones(1),
        times=times, traces=traces)
    gated = td.direct_arrival_gate(ds, pre=3e-6, post=5e-6, taper=taper)
    assert np.array_equal(gated.traces, traces * want)
    with pytest.raises(ValueError):
        td.direct_arrival_gate(ds, pre=30e-6, post=30e-6, taper=2e-6)


def test_broadband_chain_matches_jax(ref):
    """Synthesis at 121x121 (32 elements, 120-200 kHz), extraction at 120
    and 200 kHz without deconvolution, and a two-stage continuation of 2
    iterations a stage at 61x61 == the JAX package's chain: traces within
    rel 1e-4, losses and steps within rtol 1e-2, velocity atol 0.5 m/s
    (the golden bounds); losses fall within each stage."""
    coarse, fine, xs, ys = GEN.td_grids()
    coarse = Grid2D(**vars(coarse))
    fine = Grid2D(**vars(fine))
    solver = SolverConfig(pml=PMLConfig(**GEN.TD_PML))
    acq = AcquisitionConfig(**GEN.TD_ACQ)
    ds = td.synthesize_time_domain_dataset(
        smooth_blob_phantom(fine, radius=8e-3, dc=30), fine, acq,
        solver=solver, seed=GEN.TD_SEED, x_elem=xs, y_elem=ys, device="cpu",
        **GEN.TD_BAND)
    assert _rel(ds.traces, ref["td_traces"]) < 1e-4
    res = invert_dataset(
        td.timedomain_to_ring_datasets(ds, GEN.TD_FREQS, deconvolve=False),
        grid=coarse, acquisition=acq, solver=solver,
        fwi=FWIConfig(c_init=1500.0),
        continuation=ContinuationConfig(frequencies=GEN.TD_FREQS,
                                        iterations_per_frequency=2),
        device="cpu")
    loss = res.metrics["loss"]
    assert np.all(np.isfinite(loss)) and loss[1] < loss[0] and loss[3] < loss[2]
    np.testing.assert_allclose(loss, ref["td_loss"], rtol=1e-2)
    np.testing.assert_allclose(res.metrics["step_size"], ref["td_step"],
                               rtol=1e-2)
    np.testing.assert_allclose(res.velocity, ref["td_velocity"], atol=0.5)
