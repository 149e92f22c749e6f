"""The port's 3D broadband chain and 3D inversion entry held against the
JAX package on the CPU, on the 15^3 blob of tests/golden/generate_torch.py
with an 8-element cylinder: the synthesized traces (from
tests/golden/torch_3d.npz), extraction against the comb's own receiver
matrices, the FWI bridge, the gate and the RMSE (live), a two-stage
invert_dataset_3d (from the golden file), its resume, its schedule and the
methods that raise until the 3D methods come.
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest

from waveforminversionust_tpu.data import timedomain3d as jtd3
from waveforminversionust_tpu.fwi import runner3d as jrunner3d
from waveforminversionust_tpu.models.grid3d import Grid3D as JGrid3D
from waveforminversionust_tpu.ops import cpx
from waveforminversionust_tpu_torch.config import (ContinuationConfig,
                                                   FWIConfig, PMLConfig)
from waveforminversionust_tpu_torch.data import timedomain, timedomain3d
from waveforminversionust_tpu_torch.fwi import runner3d
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
PML = PMLConfig(**GEN.PML3)
GRID = Grid3D.centered(GEN.G3_EXTENT, GEN.G3_H)
POS = acquisition3d.cylinder_positions(**GEN.TD3_POS)
SCHEDULE = ContinuationConfig(frequencies=GEN.TD3_FREQS,
                              iterations_per_frequency=GEN.TD3_ITERS)
INVERT = dict(pml=PML, solver3d="cbs", iter_cap=GEN.TD3_CAP)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's outputs (tests/golden/generate_torch.py 3d)."""
    return np.load(os.path.join(GOLDEN, "torch_3d.npz"))


@pytest.fixture(scope="module")
def td3():
    """The port's synthesis (3 comb lines, GMRES tol 1e-5) and the comb's
    receiver matrices it recorded, (nf, ntx, nrx)."""
    lines = []
    real = timedomain3d._sweep_record_3d

    def record(*args, **kwargs):
        rec = real(*args, **kwargs)
        lines.append(rec.numpy())
        return rec

    timedomain3d._sweep_record_3d = record
    try:
        td = timedomain3d.synthesize_time_domain_dataset_3d(
            GEN.blob3d(GRID), GRID, POS, pml=PML, seed=GEN.TD3_SEED,
            device="cpu", **GEN.TD3_BAND)
    finally:
        timedomain3d._sweep_record_3d = real
    return td, lines[0]


@pytest.fixture(scope="module")
def datasets(ref, td3):
    """The golden traces (the JAX package's) bridged by the port: both
    packages invert the same data."""
    td = td3[0]._replace(traces=ref["td3_traces"])
    return timedomain3d.timedomain_to_fwi_data_3d(
        td, GEN.TD3_FREQS, GRID, min_angle=GEN.MIN_ANGLE3, device="cpu")[1]


@pytest.fixture(scope="module")
def full_run(datasets, tmp_path_factory):
    """The two-stage inversion, checkpointing; the checkpoint after stage 0
    is kept for the resume test."""
    ckpt = tmp_path_factory.mktemp("ck")
    calls = []

    def callback(stage, f, vel, metrics):
        calls.append((stage, f))
        if stage == 0:
            shutil.copy(ckpt / "latest", ckpt / "after_stage_0")

    res = runner3d.invert_dataset_3d(
        datasets, GRID, FWIConfig(), continuation=SCHEDULE,
        checkpoint_dir=str(ckpt), callback=callback, **INVERT)
    return res, calls, ckpt / "after_stage_0"


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_traces_match_jax(ref, td3):
    """synthesize_time_domain_dataset_3d == the JAX package's: the (tx, rx,
    t) traces within rel 1e-4 (GMRES tol 1e-5 a line), the comb, the
    snapped positions and the truth exactly."""
    td = td3[0]
    assert td.traces.shape == ref["td3_traces"].shape
    assert td.traces.dtype == np.complex64
    assert _rel(td.traces, ref["td3_traces"]) < 1e-4
    np.testing.assert_array_equal(td.freqs,
                                  np.arange(0.2e6, 0.3e6 + 0.025e6, 0.05e6))
    idx = acquisition3d.snap_to_grid3d(GRID, POS)
    np.testing.assert_array_equal(
        td.positions_snapped,
        np.stack([GRID.x[idx[:, 2]], GRID.y[idx[:, 1]], GRID.z[idx[:, 0]]],
                 axis=1))
    np.testing.assert_array_equal(td.c, GEN.blob3d(GRID).astype(np.float64))


def test_extraction_inverts_synthesis(td3):
    """On the comb's DFT time grid, extraction with the spectrum divided
    out returns each line's receiver matrix: rel < 1e-4 a line
    (tests/test_timedomain3d.py:41)."""
    td, lines = td3
    rec = timedomain.extract_frequency_data(td.traces, td.times, td.freqs,
                                            td.df, td.spectrum)
    for i in range(len(td.freqs)):
        assert _rel(rec[i], lines[i]) < 1e-4, i


def test_fwi_bridge_and_gate_match_jax(ref, td3, datasets):
    """timedomain_to_fwi_data_3d on the golden traces == the JAX package's
    (live): unit-RMS gathers, sources x 1e6, receivers, frequencies; the
    deconvolving bridge and direct_arrival_gate_3d too."""
    td = td3[0]._replace(traces=ref["td3_traces"])
    jtd = jtd3.TimeDomainDataset3D(*td)
    jgrid = JGrid3D.centered(GEN.G3_EXTENT, GEN.G3_H)
    _, jdatas = jtd3.timedomain_to_fwi_data_3d(jtd, GEN.TD3_FREQS, jgrid,
                                               min_angle=GEN.MIN_ANGLE3)
    for d, j in zip(datasets, jdatas):
        np.testing.assert_allclose(d.rec_obs.numpy(), cpx.to_numpy(j.rec_obs),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(d.src.numpy(), cpx.to_numpy(j.src))
        np.testing.assert_array_equal(d.rx_idx.numpy(), np.asarray(j.rx_idx))
        assert d.f == float(j.f)
    _, dec = timedomain3d.timedomain_to_fwi_data_3d(
        td, [td.freqs[1]], GRID, deconvolve=True, device="cpu")
    _, jdec = jtd3.timedomain_to_fwi_data_3d(jtd, [td.freqs[1]], jgrid,
                                             deconvolve=True)
    np.testing.assert_allclose(dec[0].rec_obs.numpy(),
                               cpx.to_numpy(jdec[0].rec_obs), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError, match="comb"):
        timedomain3d.timedomain_to_fwi_data_3d(td, [0.21e6], GRID,
                                               deconvolve=True, device="cpu")
    gated = timedomain3d.direct_arrival_gate_3d(td, c_ref=1480.0)
    np.testing.assert_array_equal(
        gated.traces, jtd3.direct_arrival_gate_3d(jtd, c_ref=1480.0).traces)


def test_reconstruction_rmse_3d_matches_jax():
    """Same grid and a 2x finer truth (trilinear), with and without the z
    window: the JAX package's numbers to rel 1e-6."""
    true = GEN.blob3d(GRID)
    fine = Grid3D.centered(GEN.G3_EXTENT, GEN.G3_H / 2)
    true_f = GEN.blob3d(fine)
    jgrid = JGrid3D.centered(GEN.G3_EXTENT, GEN.G3_H)
    jfine = JGrid3D.centered(GEN.G3_EXTENT, GEN.G3_H / 2)
    v = true + np.random.default_rng(1).standard_normal(true.shape) * 2
    for args, jargs, kw in (((true, GRID, true), (true, jgrid, true), {}),
                            ((v, GRID, true_f, fine), (v, jgrid, true_f, jfine),
                             dict(radius=8e-3)),
                            ((v, GRID, true), (v, jgrid, true),
                             dict(radius=8e-3, z_halfspan=3e-3))):
        assert np.isclose(runner3d.reconstruction_rmse_3d(*args, **kw),
                          jrunner3d.reconstruction_rmse_3d(*jargs, **kw),
                          rtol=1e-6, atol=0)


def test_invert_dataset_3d_matches_jax(ref, full_run):
    """Two stages (200, 300 kHz) of 2 CG iterations (the plain series) ==
    the JAX package's at the golden bounds (loss rtol 1e-2, velocity atol
    0.5 m/s); the schedule, the frequency trace and the callbacks."""
    res, calls, _ = full_run
    np.testing.assert_allclose(res.metrics["loss"], ref["td3_loss"],
                               rtol=1e-2)
    np.testing.assert_allclose(res.velocity, ref["td3_velocity"], atol=0.5)
    assert res.frequencies == GEN.TD3_FREQS
    assert res.velocity.shape == GRID.shape
    np.testing.assert_array_equal(res.metrics["frequency"],
                                  [GEN.TD3_FREQS[0]] * 2
                                  + [GEN.TD3_FREQS[1]] * 2)
    assert calls == [(0, GEN.TD3_FREQS[0]), (1, GEN.TD3_FREQS[1])]


def test_invert_dataset_3d_resume(datasets, full_run):
    """Resumed from the checkpoint after stage 0, the run gives the
    unbroken run's model and histories (atol 1e-6, rtol 1e-6)."""
    res, _, after0 = full_run
    resumed = runner3d.invert_dataset_3d(
        datasets, GRID, FWIConfig(), continuation=SCHEDULE,
        resume_from=str(after0), **INVERT)
    np.testing.assert_allclose(resumed.velocity, res.velocity, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(resumed.metrics["loss"], res.metrics["loss"],
                               rtol=1e-6)
    np.testing.assert_array_equal(resumed.metrics["frequency"],
                                  res.metrics["frequency"])


def test_invert_dataset_3d_schedule_and_methods(datasets):
    """A scheduled frequency matches a dataset key to a relative 1e-6 and
    raises beyond; a single dataset and a list are accepted; "gn",
    "lbfgs", "alpha" and "joint" run an iteration each (the attenuation
    map lands in the metrics of the last two) and raise the JAX package's
    ValueErrors for scattered-field data (gn, alpha, joint) and for
    ``mesh`` and ``encode``; an unknown method raises ValueError, ``mesh``
    under "cg" NotImplementedError, and a c_init of the wrong shape
    ValueError."""
    f0 = GEN.TD3_FREQS[0]
    res = runner3d.invert_dataset_3d(
        datasets, GRID, continuation=ContinuationConfig(
            frequencies=(f0 * (1 + 1e-8),), iterations_per_frequency=0),
        **INVERT)
    assert res.frequencies == (f0,) and res.metrics["loss"].shape == (0,)
    res = runner3d.invert_dataset_3d(datasets[1], GRID, num_iterations=0,
                                     **INVERT)
    assert res.frequencies == (GEN.TD3_FREQS[1],)
    with pytest.raises(ValueError, match="not in datasets"):
        runner3d.invert_dataset_3d(datasets, GRID, continuation=
                                   ContinuationConfig(frequencies=(9e9,)),
                                   **INVERT)
    one = datasets[1]
    for method, kw in (("gn", dict(cg_iters=1)), ("lbfgs", {}),
                       ("alpha", {}), ("joint", {})):
        res = runner3d.invert_dataset_3d(one, GRID, method=method,
                                         num_iterations=1, **kw, **INVERT)
        loss = res.metrics["loss"]
        assert loss.shape == (1,) and np.all(np.isfinite(loss)), method
        assert np.all(np.isfinite(res.velocity)), method
        assert ("attenuation" in res.metrics) == (method in ("alpha",
                                                             "joint"))
        if method != "lbfgs":
            with pytest.raises(ValueError, match="rec_ref"):
                runner3d.invert_dataset_3d(
                    one._replace(rec_ref=one.rec_obs), GRID, method=method,
                    **INVERT)
        for bad in (dict(mesh=object()), dict(encode=2)):
            with pytest.raises(ValueError, match="mesh/encode"):
                runner3d.invert_dataset_3d(one, GRID, method=method, **bad,
                                           **INVERT)
    with pytest.raises(ValueError, match="unknown method"):
        runner3d.invert_dataset_3d(datasets, GRID, method="nope", **INVERT)
    with pytest.raises(NotImplementedError, match="slice 7"):
        runner3d.invert_dataset_3d(datasets, GRID, mesh=object(), **INVERT)
    with pytest.raises(ValueError, match="c_init shape"):
        runner3d.invert_dataset_3d(datasets, GRID, c_init=np.ones((3, 3, 3)),
                                   **INVERT)
