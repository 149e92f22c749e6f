"""The port's 3D FWI held against the JAX package on the CPU, on the 15^3
blob of tests/golden/generate_torch.py with an 8-element ring: the
receiver gathers (live, and their adjoint pair), the source-encoding bits
and supershots (live), the objective and the scattered-field data, and
2-3 iterations of nonlinear_cg_3d by the plain series, by GMRES cold and
warm, encoded, and by BB under the watchdog (from
tests/golden/torch_3d.npz); warm against cold, chunked against one run,
and every ValueError the JAX package raises.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waveforminversionust_tpu import FWIConfig as JFWIConfig
from waveforminversionust_tpu import PMLConfig as JPMLConfig
from waveforminversionust_tpu.config import StepSizeFormula as JStep
from waveforminversionust_tpu.fwi import fwi3d as jfwi3d
from waveforminversionust_tpu.models import acquisition3d as jacq
from waveforminversionust_tpu.models.grid3d import Grid3D as JGrid3D
from waveforminversionust_tpu.ops import cpx
from waveforminversionust_tpu_torch import interop
from waveforminversionust_tpu_torch.config import (FWIConfig, PMLConfig,
                                                   StepSizeFormula)
from waveforminversionust_tpu_torch.fwi import fwi3d
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
BASE = dict(clip_velocity=GEN.CG3_CLIP)
# name -> (dataset, FWIConfig, iterations, nonlinear_cg_3d keywords), as
# generate_torch.py::main_3d runs them.
RUNS = {
    "cbs": ("ring", FWIConfig(**BASE), 2, {}),
    "gmres": ("ring", FWIConfig(**BASE), 2,
              dict(solver3d="gmres", warm_start=False)),
    "warm": ("ring", FWIConfig(**BASE), 2,
             dict(solver3d="gmres", warm_start=True)),
    "enc": ("full", FWIConfig(**BASE), 2,
            dict(encode=GEN.ENC3_M, encode_seed=GEN.ENC3_SEED)),
    "bb": ("ring", FWIConfig(step_size=StepSizeFormula.BB,
                             reject_increase=1.5, **BASE), 3,
           dict(solver3d="gmres", warm_start=True)),
}


@pytest.fixture(scope="module")
def ref():
    """The JAX package's outputs (tests/golden/generate_torch.py 3d)."""
    return np.load(os.path.join(GOLDEN, "torch_3d.npz"))


def _grid():
    return Grid3D.centered(GEN.G3_EXTENT, GEN.G3_H)


def _acq(min_angle=GEN.MIN_ANGLE3):
    return acquisition3d.build_acquisition3d(
        _grid(), acquisition3d.cylinder_positions(**GEN.RING3),
        min_angle=min_angle)


def _data(ref, which="ring"):
    """The port's dataset of generate_torch.py: the ring's masked gathers
    ("ring") or the full aperture's ("full"), sources scaled as there."""
    full = which == "full"
    d = fwi3d.build_fwi_data_3d(_acq(0.0 if full else GEN.MIN_ANGLE3),
                                ref["f3_rec_full" if full else "f3_rec"],
                                GEN.F3, _grid(), device="cpu")
    return d._replace(src=d.src * GEN.SRC_SCALE3)


def _vel0():
    return torch.full(_grid().shape, GEN.C3)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def runs(ref):
    """The port's CG runs of RUNS (each used by two tests)."""
    out = {}
    for name, (which, fwi, n, kw) in RUNS.items():
        v, m = fwi3d.nonlinear_cg_3d(_vel0(), _data(ref, which), _grid(),
                                     fwi, num_iterations=n, pml=PML,
                                     iter_cap=GEN.CG3_CAP,
                                     gmres_tol=GEN.CG3_TOL, **kw)
        out[name] = (v.numpy(), m)
    return out


def test_gathers_match_jax_and_are_adjoint(ref):
    """sample_receivers_3d and scatter_to_volumes_3d == the JAX package's
    (live); <S u, r> == <u, S^T r> to rel 1e-6, receivers shared by
    several transmitters included."""
    acq, grid = _acq(), _grid()
    rng = np.random.default_rng(2)
    u = (rng.standard_normal((8,) + grid.shape)
         + 1j * rng.standard_normal((8,) + grid.shape)).astype(np.complex64)
    r = (rng.standard_normal(acq.rx_idx.shape[:2])
         + 1j * rng.standard_normal(acq.rx_idx.shape[:2])).astype(np.complex64)
    rx = torch.as_tensor(acq.rx_idx, dtype=torch.long)
    su = fwi3d.sample_receivers_3d(torch.as_tensor(u), rx)
    st_r = fwi3d.scatter_to_volumes_3d(torch.as_tensor(r), rx, grid.shape)
    jrx = jnp.asarray(acq.rx_idx)
    np.testing.assert_array_equal(
        su.numpy(), cpx.to_numpy(jfwi3d.sample_receivers_3d(cpx.of(u), jrx)))
    np.testing.assert_allclose(
        st_r.numpy(), cpx.to_numpy(jfwi3d.scatter_to_volumes_3d(
            cpx.of(r), jrx, grid.shape)), rtol=1e-6, atol=0)
    lhs = complex(torch.vdot(su.reshape(-1), torch.as_tensor(r).reshape(-1)))
    rhs = complex(torch.vdot(torch.as_tensor(u).reshape(-1),
                             st_r.reshape(-1)))
    assert abs(lhs - rhs) / abs(lhs) < 1e-6


@pytest.mark.parametrize("seed,it", [(0, 0), (5, 1), (5, 7), (123, 40)])
def test_encoding_bits_match_jax(seed, it):
    """The code of iteration ``it``: the bits of
    jax.random.rademacher(fold_in(PRNGKey(seed), it), (ntx, m))."""
    want = jax.random.rademacher(
        jax.random.fold_in(jax.random.PRNGKey(seed), it), (8, 3),
        jnp.float32)
    np.testing.assert_array_equal(fwi3d._encoding_code(seed, it, 8, 3),
                                  np.asarray(want))


def test_encode_supershots_matches_jax(ref):
    """encode_supershots on the JAX package's full-aperture dataset (with
    an attenuation map), carried over by interop.fwi_data_3d, == the JAX
    package's (live) for
    a given code: sources, gathers, receivers and the scattered-field
    reference (rel 1e-6)."""
    jgrid = JGrid3D.centered(GEN.G3_EXTENT, GEN.G3_H)
    jac = jacq.build_acquisition3d(
        jgrid, jacq.cylinder_positions(**GEN.RING3), min_angle=0.0)
    rec = cpx.of(ref["f3_rec_full"])
    alpha = np.full(jgrid.shape, GEN.ALPHA3, np.float32)
    jdata = jfwi3d.build_fwi_data_3d(jac, rec, GEN.F3, jgrid,
                                     attenuation=alpha)._replace(
        rec_ref=cpx.scale(rec, 0.5))
    planes = [(np.asarray(x.re), np.asarray(x.im))
              for x in (jdata.src, jdata.rec_obs, jdata.rec_ref)]
    data = interop.fwi_data_3d(planes[0], planes[1],
                               np.asarray(jdata.rx_idx), jdata.f,
                               attenuation=np.asarray(jdata.attenuation),
                               rec_ref=planes[2], device="cpu")
    assert torch.equal(data.attenuation, interop.velocity_3d(alpha))
    code = fwi3d._encoding_code(3, 2, 8, GEN.ENC3_M)
    got = fwi3d.encode_supershots(data, code)
    want = jfwi3d.encode_supershots(jdata, jnp.asarray(code))
    for a, b in ((got.src, want.src), (got.rec_obs, want.rec_obs),
                 (got.rec_ref, want.rec_ref)):
        np.testing.assert_allclose(a.numpy(), cpx.to_numpy(b), rtol=1e-6,
                                   atol=1e-6 * float(a.abs().max()))
    np.testing.assert_array_equal(got.rx_idx.numpy(), np.asarray(want.rx_idx))
    assert got.f == float(want.f)


def test_objective_pieces_3d_matches_jax(ref):
    """One forward and one adjoint series solve in the lossy medium (alpha
    3 Np/m) with source estimation at 1480 m/s: loss rel < 1e-4,
    gradient rel < 1e-3 (measured 3.9e-5 and 2.4e-5). At 1500 m/s, 9% off
    the data, the residual's float32 rounding amplified ~20x carries the
    loss's last digits (2e-4 apart)."""
    data = _data(ref)._replace(attenuation=torch.full(
        _grid().shape, GEN.ALPHA3))
    vel = torch.full(_grid().shape, GEN.OBJ3_C)
    loss, grad, virt, rec = fwi3d.objective_pieces_3d(
        vel, 1.0 / vel, data, _grid(), PML, GEN.CG3_CAP)
    assert virt.shape == data.src.shape and rec.shape == data.rec_obs.shape
    assert abs(float(loss) / float(ref["f3_obj_loss"]) - 1) < 1e-4
    assert _rel(grad, ref["f3_obj_grad"]) < 1e-3


def test_scattered_data_3d_matches_jax(ref):
    """scattered_data_3d (one GMRES solve at 1500 m/s, tol 1e-5): the
    scattered gathers and the background gather, rel < 1e-4 (measured
    4.8e-5 and 6.3e-6)."""
    scat = fwi3d.scattered_data_3d(_data(ref), _grid(), c_ref=GEN.C3,
                                   pml=PML)
    assert _rel(scat.rec_obs, ref["f3_scat_rec"]) < 1e-4
    assert _rel(scat.rec_ref, ref["f3_scat_ref"]) < 1e-4


@pytest.mark.parametrize("name", list(RUNS))
def test_cg_3d_matches_jax(ref, runs, name):
    """nonlinear_cg_3d == the JAX package's at the golden bounds (loss and
    step rtol 1e-2, velocity atol 0.5 m/s, tests/test_golden.py): the plain
    series, GMRES cold and warm (tol 1e-4), 2 encoded supershots (the JAX
    package's codes), and BB under the watchdog (3 iterations). Measured:
    loss 1.4e-4 to 4.7e-4, step 9.5e-5 to 8.1e-4, velocity 0.0016 to 0.13
    m/s apart."""
    vel, m = runs[name]
    np.testing.assert_allclose(m.loss.numpy(), ref[f"f3_{name}_loss"],
                               rtol=1e-2)
    np.testing.assert_allclose(m.step_size.numpy(), ref[f"f3_{name}_step"],
                               rtol=1e-2)
    np.testing.assert_allclose(vel, ref[f"f3_{name}_velocity"], atol=0.5)
    assert np.all(np.isfinite(m.loss.numpy()))


def test_warm_start_matches_cold(runs):
    """Warm-started GMRES solves stay within the tolerance of the cold
    ones: losses within rtol 0.15 (tests/test_fwi3d.py:271)."""
    np.testing.assert_allclose(runs["warm"][1].loss.numpy(),
                               runs["gmres"][1].loss.numpy(), rtol=0.15)


def test_chunked_equals_one_run(ref, runs):
    """chunk_iterations=1 gives the one-run trajectory (loss rtol 1e-4,
    velocity atol 1e-2, tests/test_fwi3d.py:277-279), the encoded run's
    redrawn codes included."""
    which, fwi, n, kw = RUNS["enc"]
    vel, m = fwi3d.nonlinear_cg_3d(_vel0(), _data(ref, which), _grid(), fwi,
                                   num_iterations=n, pml=PML,
                                   iter_cap=GEN.CG3_CAP, chunk_iterations=1,
                                   **kw)
    np.testing.assert_allclose(m.loss.numpy(), runs["enc"][1].loss.numpy(),
                               rtol=1e-4)
    np.testing.assert_allclose(vel.numpy(), runs["enc"][0], atol=1e-2)


BAD = {
    "bb_encode": (dict(step_size="BB"), dict(encode=2)),
    "ratio": (dict(reject_increase=1.0), {}),
    "watchdog_encode": (dict(reject_increase=1.5), dict(encode=2)),
    "warm_cbs": ({}, dict(warm_start=True)),
    "warm_encode": ({}, dict(warm_start=True, solver3d="gmres", encode=2)),
    "masks_encode": ({}, dict(encode=2)),
}


@pytest.mark.parametrize("case", list(BAD))
def test_value_errors_match_jax(ref, case):
    """Every ValueError of the JAX package's nonlinear_cg_3d, raised before
    any solve, with the JAX package's message."""
    fkw, kw = BAD[case]

    def config(fwi_cls, step_cls):
        extra = dict(fkw)
        if extra.pop("step_size", None):
            extra["step_size"] = step_cls.BB
        return fwi_cls(num_iterations=1, **extra)

    with pytest.raises(ValueError) as port:
        fwi3d.nonlinear_cg_3d(_vel0(), _data(ref), _grid(),
                              config(FWIConfig, StepSizeFormula), pml=PML,
                              iter_cap=60, **kw)
    jgrid = JGrid3D.centered(GEN.G3_EXTENT, GEN.G3_H)
    jac = jacq.build_acquisition3d(
        jgrid, jacq.cylinder_positions(**GEN.RING3),
        min_angle=GEN.MIN_ANGLE3)
    jdata = jfwi3d.build_fwi_data_3d(jac, cpx.of(ref["f3_rec"]), GEN.F3,
                                     jgrid)
    with pytest.raises(ValueError) as want:
        jfwi3d.nonlinear_cg_3d(jnp.full(jgrid.shape, GEN.C3), jdata, jgrid,
                               config(JFWIConfig, JStep),
                               pml=JPMLConfig(**GEN.PML3), iter_cap=60, **kw)
    assert str(port.value) == str(want.value)


def test_mesh_waits_for_the_multi_device_slice(ref):
    with pytest.raises(NotImplementedError, match="slice 7"):
        fwi3d.nonlinear_cg_3d(_vel0(), _data(ref), _grid(),
                              FWIConfig(num_iterations=1), pml=PML,
                              mesh=object())
