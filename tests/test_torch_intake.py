"""The port's intake chain held against the JAX package on the CPU:
reciprocity QC, measurement noise, phantoms, the transpose apply and the
dense operator, .mat intake, background-speed calibration, and the bench's
intake chain (QC, compensation, calibrated start, bilinear receivers,
illumination preconditioning) in miniature. Receiver sensitivities are held
in tests/test_torch_runner.py, beside the runner's receiver calibration,
which compiles the same JAX solve.

The tiny ring of tests/test_calibrate.py: a 24 mm grid at 0.8 mm, 32
elements snapped to it, 200 kHz, data synthesized by the port on the 0.4 mm
grid (numpy out, into both packages).
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch

from waveforminversionust_tpu import (AcquisitionConfig as JAcq,
                                      FWIConfig as JFWI, Grid2D as JGrid,
                                      PMLConfig as JPML,
                                      SolverConfig as JSolver)
from waveforminversionust_tpu.data import matio as jmatio
from waveforminversionust_tpu.data import qc as jqc
from waveforminversionust_tpu.data.synthesize import \
    add_complex_noise as jnoise
from waveforminversionust_tpu.fwi import calibrate as jcal
from waveforminversionust_tpu.fwi.runner import invert_dataset as jinvert
from waveforminversionust_tpu.models import phantom as jphantom
from waveforminversionust_tpu.ops import apply as japply
from waveforminversionust_tpu_torch.config import (AcquisitionConfig,
                                                   FWIConfig, PMLConfig,
                                                   SolverConfig)
from waveforminversionust_tpu_torch.data import matio, qc
from waveforminversionust_tpu_torch.data.synthesize import (
    add_complex_noise, synthesize_ring_dataset)
from waveforminversionust_tpu_torch.fwi import calibrate
from waveforminversionust_tpu_torch.fwi.objective import build_fwi_data
from waveforminversionust_tpu_torch.fwi.runner import invert_dataset
from waveforminversionust_tpu_torch.models import phantom
from waveforminversionust_tpu_torch.models.acquisition import (
    build_ring_acquisition, ring_positions, snap_to_grid)
from waveforminversionust_tpu_torch.models.grid import Grid2D
from waveforminversionust_tpu_torch.ops import apply

F = 200e3
C0 = 1520.0
ACQ = dict(num_elements=32, radius=18e-3, num_excluded_each_side=5)
PML = dict(l_pml=4e-3)
SEARCH = dict(c_min=1440.0, c_max=1600.0, num=9, levels=2)


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.fixture(scope="module")
def ring():
    """(coarse port grid, its JAX twin, dataset): a blob in water seen by
    the 32-element ring, synthesized on the 0.4 mm grid."""
    coarse = Grid2D.centered(24e-3, 0.8e-3)
    xi, yi = snap_to_grid(coarse, *ring_positions(ACQ["num_elements"],
                                                  ACQ["radius"]))
    fine = Grid2D.centered(24e-3, 0.4e-3)
    ds = synthesize_ring_dataset(
        phantom.smooth_blob_phantom(fine, radius=6e-3, dc=25, c_bkgnd=C0),
        fine, AcquisitionConfig(**ACQ), f=F, seed=5,
        solver=SolverConfig(pml=PMLConfig(**PML)),
        x_elem=coarse.x[xi], y_elem=coarse.y[yi], device="cpu")
    return coarse, JGrid.centered(24e-3, 0.8e-3), ds


def _responses(n, seed):
    """Per-element transmit and receive responses, one dead transmitter."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.5, 2.0, n) * np.exp(1j * rng.uniform(-np.pi, np.pi, n))
    s = rng.uniform(0.5, 2.0, n) * np.exp(1j * rng.uniform(-np.pi, np.pi, n))
    q[3] = 1e-4
    return q, s


# -- QC and noise (numpy, bit for bit) --------------------------------------

@pytest.mark.parametrize("exclude", [0, 5])
def test_qc_matches_bitwise(ring, exclude):
    """qc_report (ratios, compensation, residual and energy screens, bad
    channels), estimate_element_ratios, compensate_reciprocity and
    reciprocity_asymmetry == the JAX package bit for bit, on data with
    per-element responses and one dead transmitter."""
    _, _, ds = ring
    q, s = _responses(ds.rec_data.shape[0], 7)
    m = (q[:, None] * ds.rec_data * s[None, :]).astype(np.complex64)
    port, ref = (qc.qc_report(m, exclude_each_side=exclude),
                 jqc.qc_report(m, exclude_each_side=exclude))
    for name in qc.QCReport._fields:
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    assert 3 in port.bad_elements
    ratios = qc.estimate_element_ratios(m, exclude)
    np.testing.assert_array_equal(ratios, jqc.estimate_element_ratios(m, exclude))
    np.testing.assert_array_equal(qc.compensate_reciprocity(m, ratios),
                                  jqc.compensate_reciprocity(m, ratios))
    assert (qc.reciprocity_asymmetry(m, exclude)
            == jqc.reciprocity_asymmetry(m, exclude))
    with pytest.raises(ValueError, match="admits no element pairs"):
        qc._pair_mask(8, 4)


@pytest.mark.parametrize("exclude", [0, 3])
def test_add_complex_noise_matches_bitwise(exclude):
    """The same seed gives the reference's bits, with and without the
    excluded ring band setting the signal power."""
    m = _cplx(np.random.default_rng(8), (16, 16))
    port = add_complex_noise(m, 20.0, seed=4, exclude_each_side=exclude)
    np.testing.assert_array_equal(port, jnoise(m, 20.0, seed=4,
                                               exclude_each_side=exclude))
    assert port.dtype == np.complex64


# -- models and ops ---------------------------------------------------------

def test_phantoms_match_bitwise():
    """disk_phantom and phantom_from_image (a seeded RGB image: channel
    mean, threshold floor, rotation, bilinear resampling) == the JAX
    package bit for bit."""
    grid = Grid2D.centered(30e-3, 0.5e-3)
    jgrid = JGrid.centered(30e-3, 0.5e-3)
    np.testing.assert_array_equal(
        phantom.disk_phantom(grid, 6e-3, dc=30, center=(1e-3, -2e-3)),
        jphantom.disk_phantom(jgrid, 6e-3, dc=30, center=(1e-3, -2e-3)))
    image = np.random.default_rng(9).uniform(0, 255, (40, 50, 3))
    port = phantom.phantom_from_image(grid, image)
    np.testing.assert_array_equal(port, jphantom.phantom_from_image(jgrid, image))
    assert port.dtype == np.float32


def test_transpose_apply_and_dense_matrix_match():
    """h_apply_transpose and dense_matrix == the JAX package: rtol 1e-6
    (f32 sums of 9 terms); the dense matrix's transpose applied to u is
    h_apply_transpose."""
    rng = np.random.default_rng(12)
    coeffs, u = _cplx(rng, (9, 6, 7)), _cplx(rng, (2, 6, 7))
    port = apply.h_apply_transpose(torch.as_tensor(coeffs), torch.as_tensor(u))
    ref = japply.h_apply_transpose(jnp.asarray(coeffs), jnp.asarray(u))
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    dense = apply.dense_matrix(torch.as_tensor(coeffs)).numpy()
    np.testing.assert_allclose(dense, np.asarray(japply.dense_matrix(
        jnp.asarray(coeffs))), rtol=1e-6, atol=0)
    np.testing.assert_allclose((dense.T @ u.reshape(2, -1).T).T.reshape(u.shape),
                               port.numpy(), rtol=1e-5, atol=1e-5)


# -- .mat intake ------------------------------------------------------------

def test_load_recorded_dataset_written_by_jax(ring, tmp_path):
    """A v7.3 file written by the JAX package's save_recorded_dataset loads
    into the port's RingDataset unchanged, and the port's own v7.3 file
    loads into the JAX package."""
    _, _, ds = ring
    path = str(tmp_path / "recorded.mat")
    jmatio.save_recorded_dataset(path, ds)
    got = matio.load_recorded_dataset(path)
    for name in ds._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(ds, name))
    back = str(tmp_path / "back.mat")
    matio.save_recorded_dataset(back, got)
    for name, want in jmatio.load_mat(back).items():
        np.testing.assert_array_equal(want, matio.load_mat(path)[name])


def test_load_mat_v5_and_without_h5py(tmp_path, monkeypatch):
    """A classic v5 file (scipy.io.savemat) loads through scipy with h5py
    unavailable, as on a host without it; a v7.3 file then raises and
    names h5py."""
    rng = np.random.default_rng(13)
    arrays = {"REC": _cplx(rng, (4, 5)).astype(np.complex128),
              "f": np.array([[350e3]])}
    v5 = str(tmp_path / "rec_v5.mat")
    scipy.io.savemat(v5, arrays)
    v73 = str(tmp_path / "rec_v73.mat")
    jmatio.save_mat(v73, arrays)
    monkeypatch.setitem(sys.modules, "h5py", None)
    got = matio.load_mat(v5)
    assert set(got) == set(arrays)
    for name, want in arrays.items():
        np.testing.assert_array_equal(got[name], want)
    with pytest.raises(RuntimeError, match="h5py"):
        matio.load_mat(v73)


# -- calibration and the slice: bench_intake in miniature ------------------

@pytest.fixture(scope="module")
def intake(ring):
    """bench.py::bench_intake's chain up to the calibration, through both
    packages: transmit responses on the data (which reciprocity
    compensation removes up to one global scale; receive sensitivities
    would survive it), QC, compensation, then each package's
    calibrate_background_speed on the compensated data."""
    coarse, jgrid, ds = ring
    q, _ = _responses(ds.rec_data.shape[0], 14)
    q[3] = 1.0
    ds = ds._replace(rec_data=(q[:, None] * ds.rec_data).astype(np.complex64))
    rep = qc.qc_report(ds.rec_data,
                       exclude_each_side=ACQ["num_excluded_each_side"])
    ds = ds._replace(rec_data=qc.compensate_reciprocity(ds.rec_data,
                                                        rep.ratios))
    kw = dict(tx_downsample=2, **ACQ)
    port = calibrate.calibrate_background_speed(
        ds, grid=coarse, acquisition=AcquisitionConfig(**kw),
        solver=SolverConfig(pml=PMLConfig(**PML)), device="cpu", **SEARCH)
    ref = jcal.calibrate_background_speed(
        ds, grid=jgrid, acquisition=JAcq(**kw),
        solver=JSolver(pml=JPML(**PML)), **SEARCH)
    return ds, port, ref


def test_calibrate_background_speed_matches(intake):
    """Candidates equal, misfits rtol 1e-3, c0 within 0.5 m/s of the JAX
    package, and near the water speed (tests/test_calibrate.py's bracket
    for a +25 m/s blob)."""
    _, port, ref = intake
    np.testing.assert_array_equal(port.candidates, ref.candidates)
    np.testing.assert_allclose(port.misfits, ref.misfits, rtol=1e-3)
    assert abs(port.c0 - ref.c0) < 0.5, (port.c0, ref.c0)
    assert port.c_grid_best == ref.c_grid_best
    assert C0 - 3.0 < port.c0 < C0 + 12.0


def test_calibrate_entry_checks(ring):
    """data= needs grid=, one of dataset / data= is needed, num >= 3, and
    the default device is the card: without one it raises."""
    coarse, _, ds = ring
    with pytest.raises(ValueError):
        calibrate.calibrate_background_speed()
    acq = build_ring_acquisition(coarse, AcquisitionConfig(**ACQ),
                                 x_elem=ds.x_circ, y_elem=ds.y_circ)
    data = build_fwi_data(acq, ds.rec_data, ds.f, device="cpu")
    with pytest.raises(ValueError):
        calibrate.calibrate_background_speed(data=data)
    with pytest.raises(ValueError, match="num"):
        calibrate.calibrate_background_speed(data=data, grid=coarse, num=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            calibrate.calibrate_background_speed(ds, grid=coarse)


def test_intake_chain_matches(ring, intake):
    """The chain's end: invert_dataset from the calibrated speed with
    bilinear receivers and illumination preconditioning, 3 CG iterations,
    through both packages. Held with the golden bounds of
    tests/test_golden.py: loss and step rtol 1e-2, velocity atol 0.5 m/s."""
    coarse, jgrid, _ = ring
    ds, cal, _ = intake
    acq = dict(interpolation="bilinear", **ACQ)
    fwi = dict(num_iterations=3, precondition="illumination")
    port = invert_dataset(ds, grid=coarse, acquisition=AcquisitionConfig(**acq),
                          solver=SolverConfig(pml=PMLConfig(**PML)),
                          fwi=FWIConfig(**fwi), c_init=cal.c0, device="cpu")
    ref = jinvert(ds, grid=jgrid, acquisition=JAcq(**acq),
                  solver=JSolver(pml=JPML(**PML)), fwi=JFWI(**fwi),
                  c_init=cal.c0)
    np.testing.assert_allclose(port.metrics["loss"], ref.metrics["loss"],
                               rtol=1e-2)
    np.testing.assert_allclose(port.metrics["step_size"],
                               ref.metrics["step_size"], rtol=1e-2)
    np.testing.assert_allclose(port.velocity, np.asarray(ref.velocity),
                               atol=0.5)
    assert port.metrics["loss"][-1] < port.metrics["loss"][0]
