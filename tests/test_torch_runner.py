"""The port's inversion entry held against the JAX package on the CPU:
continuation over a {frequency: dataset} mapping with receiver calibration,
chunked checkpoints, live callbacks and the per-stage callback; receiver
sensitivities; chunks that start on a stale iteration; resume mid-stage
and on a stage boundary; a checkpoint written by the JAX package
resumed in the port (interop.inversion_state); the checkpoint files; the
raises of the later slices; and the public signatures the two packages
share (ROADMAP.md C6).

The tiny ring of tests/test_torch_intake.py (24 mm at 0.8 mm, 32 elements,
snapped), two recordings at 160 and 200 kHz synthesized by the port with
per-element receive sensitivities, so that receiver calibration has work to
do. One JAX continuation run and its resume serve the comparisons (module
scope); the receiver-sensitivity test reuses its compiled solve.
"""

import contextlib
import importlib
import inspect
import io
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from waveforminversionust_tpu import (AcquisitionConfig as JAcq,
                                      ContinuationConfig as JCont,
                                      FWIConfig as JFWI, Grid2D as JGrid,
                                      PMLConfig as JPML,
                                      SolverConfig as JSolver)
from waveforminversionust_tpu.fwi import runner as jrunner
from waveforminversionust_tpu.fwi.optimizers import CGMetrics as JMetrics
from waveforminversionust_tpu.fwi import calibrate as jcal
from waveforminversionust_tpu.fwi import objective as jobj
from waveforminversionust_tpu.models.acquisition import \
    build_ring_acquisition as jbuild_acq
from waveforminversionust_tpu.utils import checkpoint as jckpt
from waveforminversionust_tpu_torch import interop
from waveforminversionust_tpu_torch.config import (AcquisitionConfig,
                                                   ContinuationConfig,
                                                   FWIConfig, PMLConfig,
                                                   SolverConfig, SolverMethod)
from waveforminversionust_tpu_torch.data.synthesize import \
    synthesize_ring_dataset
from waveforminversionust_tpu_torch.fwi import calibrate, optimizers, runner
from waveforminversionust_tpu_torch.fwi.objective import build_fwi_data
from waveforminversionust_tpu_torch.fwi.optimizers import CGMetrics
from waveforminversionust_tpu_torch.models.acquisition import (
    build_ring_acquisition, ring_positions, snap_to_grid)
from waveforminversionust_tpu_torch.models.grid import Grid2D
from waveforminversionust_tpu_torch.models.phantom import smooth_blob_phantom
from waveforminversionust_tpu_torch.ops import batched_inv
from waveforminversionust_tpu_torch.utils import checkpoint

FREQS = (160e3, 200e3)
ITERS = 2        # iterations a stage
CHUNK = 1        # iterations a checkpoint and a live callback
ACQ = dict(num_elements=32, radius=18e-3, num_excluded_each_side=5)
PML = dict(l_pml=4e-3)


@pytest.fixture(scope="module")
def recordings():
    """(port grid, {frequency: RingDataset}) with receive sensitivities."""
    coarse = Grid2D.centered(24e-3, 0.8e-3)
    xi, yi = snap_to_grid(coarse, *ring_positions(ACQ["num_elements"],
                                                  ACQ["radius"]))
    fine = Grid2D.centered(24e-3, 0.4e-3)
    vel = smooth_blob_phantom(fine, radius=8e-3, dc=30, c_bkgnd=1520.0)
    rng = np.random.default_rng(21)
    n = ACQ["num_elements"]
    s = rng.uniform(0.7, 1.4, n) * np.exp(1j * rng.uniform(-0.5, 0.5, n))
    out = {}
    for f in FREQS:
        ds = synthesize_ring_dataset(
            vel, fine, AcquisitionConfig(**ACQ), f=f, seed=3,
            solver=SolverConfig(pml=PMLConfig(**PML)),
            x_elem=coarse.x[xi], y_elem=coarse.y[yi], device="cpu")
        out[f] = ds._replace(rec_data=(ds.rec_data * s[None, :]
                                       ).astype(np.complex64))
    return coarse, out


def _port_kw(**extra):
    return dict(acquisition=AcquisitionConfig(**ACQ),
                solver=SolverConfig(pml=PMLConfig(**PML)),
                fwi=FWIConfig(c_init=1500.0),
                continuation=ContinuationConfig(frequencies=FREQS,
                                                iterations_per_frequency=ITERS),
                receiver_calibration=True, device="cpu", **extra)


def _jax_kw():
    return dict(grid=JGrid.centered(24e-3, 0.8e-3), acquisition=JAcq(**ACQ),
                solver=JSolver(pml=JPML(**PML)),
                fwi=JFWI(c_init=1500.0),
                continuation=JCont(frequencies=FREQS,
                                   iterations_per_frequency=ITERS),
                receiver_calibration=True)


def _live(seen):
    return lambda s, f, it, vel, m: seen.append((s, f, it, len(m.loss)))


@pytest.fixture(scope="module")
def jax_receiver_solve():
    """The JAX package's estimate_receiver_sensitivities calls its
    solve_helmholtz eagerly, which costs ~10 s on one core at its first
    call and ~1.5 s at each later one; in this module it calls the same
    function under jax.jit (one compile, the frequency traced)."""
    from waveforminversionust_tpu.ops import solve as jsolve
    jitted = jax.jit(lambda vel, src, f, att, grid, config:
                     jsolve.solve_helmholtz(vel, src, f, grid, config,
                                            attenuation=att),
                     static_argnums=(4, 5))

    def solve(vel, src, f, grid, config, attenuation=None):
        return jitted(vel, src, f, attenuation, grid, config)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcal, "solve_helmholtz", solve)
        yield


@pytest.fixture(scope="module")
def jax_run(recordings, jax_receiver_solve, tmp_path_factory):
    """The JAX package's continuation run with a checkpoint and a live
    callback every iteration; its first checkpoint (stage 0, iteration 1)
    is copied aside before the second overwrites it, and the JAX package
    resumes from it."""
    _, recs = recordings
    root = tmp_path_factory.mktemp("jax_ckpt")
    first = str(root / "first")
    orig = jckpt.save_state
    saves = []

    def keep_first(path, state):
        orig(path, state)
        if not saves:
            shutil.copytree(path, first)
        saves.append(path)

    seen = []
    jckpt.save_state = keep_first
    try:
        res = jrunner.invert_dataset(
            recs, checkpoint_dir=str(root / "run"), checkpoint_every=CHUNK,
            live_every=CHUNK, live_callback=_live(seen), **_jax_kw())
    finally:
        jckpt.save_state = orig
    resumed = jrunner.invert_dataset(recs, resume_from=first, **_jax_kw())
    return res, seen, first, resumed


def _golden(port, ref):
    """tests/test_golden.py's bounds: loss and step rtol 1e-2, velocity
    atol 0.5 m/s."""
    np.testing.assert_allclose(port.metrics["loss"],
                               np.asarray(ref.metrics["loss"]), rtol=1e-2)
    np.testing.assert_allclose(port.metrics["step_size"],
                               np.asarray(ref.metrics["step_size"]), rtol=1e-2)
    np.testing.assert_allclose(port.velocity, np.asarray(ref.velocity),
                               atol=0.5)


def test_continuation_matches_jax(recordings, jax_run, tmp_path):
    """Two stages on the {f: dataset} mapping with receiver calibration, a
    checkpoint and a live callback every iteration == the JAX package's
    run within the golden bounds; the live-callback calls follow the
    reference's (stage, frequency, iteration) sequence with one
    iteration's metrics each, the per-stage callback fires once a stage,
    and the last checkpoint holds the last stage's history."""
    coarse, recs = recordings
    ref, ref_seen, _, _ = jax_run
    seen, stages = [], []
    port = runner.invert_dataset(
        recs, grid=coarse, checkpoint_dir=str(tmp_path), checkpoint_every=CHUNK,
        live_every=CHUNK, live_callback=_live(seen),
        callback=lambda s, f, v, m: stages.append((s, f, len(m.loss))),
        **_port_kw())
    _golden(port, ref)
    assert seen == ref_seen == [(0, FREQS[0], 1, 1), (0, FREQS[0], 2, 1),
                                (1, FREQS[1], 1, 1), (1, FREQS[1], 2, 1)]
    assert stages == [(0, FREQS[0], ITERS), (1, FREQS[1], ITERS)]
    assert port.frequencies == FREQS
    st = checkpoint.load_state(os.path.join(str(tmp_path), "latest"))
    assert (int(st["stage"]), int(st["iteration"])) == (1, ITERS)
    np.testing.assert_array_equal(st["velocity"].numpy(), port.velocity)
    np.testing.assert_array_equal(st["metrics"]["loss"].numpy(),
                                  port.metrics["loss"][ITERS:])


def test_estimate_receiver_sensitivities_matches(recordings,
                                                 jax_receiver_solve):
    """s rtol 1e-3 of the JAX package on the receiver-scaled recording at
    the true model, and the compensated observations with it."""
    coarse, recs = recordings
    ds = recs[FREQS[1]]
    jgrid = JGrid.centered(24e-3, 0.8e-3)
    acq = build_ring_acquisition(coarse, AcquisitionConfig(**ACQ),
                                 x_elem=ds.x_circ, y_elem=ds.y_circ)
    jacq = jbuild_acq(jgrid, JAcq(**ACQ), x_elem=ds.x_circ, y_elem=ds.y_circ)
    vel = smooth_blob_phantom(coarse, radius=8e-3, dc=30, c_bkgnd=1520.0)
    s, data_c = calibrate.estimate_receiver_sensitivities(
        build_fwi_data(acq, ds.rec_data, ds.f, device="cpu"), acq, vel,
        coarse, SolverConfig(pml=PMLConfig(**PML)))
    s_ref, jdata_c = jcal.estimate_receiver_sensitivities(
        jobj.build_fwi_data(jacq, ds.rec_data, ds.f), jacq, vel, jgrid,
        JSolver(pml=JPML(**PML)))
    np.testing.assert_allclose(s, s_ref, rtol=1e-3)
    np.testing.assert_allclose(data_c.rec_obs.numpy(),
                               np.asarray(jdata_c.rec_obs), rtol=1e-3,
                               atol=1e-3 * float(np.abs(ds.rec_data).max()))


def test_odd_chunks_factor_on_their_first_iteration(recordings, tmp_path,
                                                    monkeypatch):
    """With refactor_every=2, a chunk of the checkpointed run factors on
    its first iteration, as the reference's does (its scan never reads the
    zero factor it starts with): one stage of 4 in chunks of 3 factors at
    iterations 0, 2 and 3, the unchunked run at 0 and 2. The first chunk
    is the unchunked run's arithmetic (rtol 1e-6). The last iteration is
    another computation in each run (a fresh factor against a stale one
    and its refinement pass: 2.1% apart in step, 2.5 m/s in velocity on
    this ring), so it is held to nothing but a finite, lower loss."""
    coarse, recs = recordings
    factored = []
    orig = optimizers.factor_operator
    monkeypatch.setattr(optimizers, "factor_operator",
                        lambda c, cfg: factored.append(1) or orig(c, cfg))
    kw = dict(grid=coarse, acquisition=AcquisitionConfig(**ACQ),
              solver=SolverConfig(pml=PMLConfig(**PML), refactor_every=2),
              fwi=FWIConfig(num_iterations=4), device="cpu")
    whole = runner.invert_dataset(recs[FREQS[1]], **kw)
    assert len(factored) == 2
    chunked = runner.invert_dataset(recs[FREQS[1]], checkpoint_dir=str(tmp_path),
                                    checkpoint_every=3, **kw)
    assert len(factored) == 2 + 3
    np.testing.assert_allclose(chunked.metrics["loss"][:3],
                               whole.metrics["loss"][:3], rtol=1e-6)
    loss = chunked.metrics["loss"]
    assert np.all(np.isfinite(loss)) and loss[3] < loss[2]


def test_jax_checkpoint_resumes_in_port(recordings, jax_run, tmp_path):
    """A mid-stage checkpoint written by the JAX package (stage 0,
    iteration 1), carried over by interop.inversion_state and saved by the
    port, resumes in the port as it does in the JAX package: golden
    bounds against the JAX package's own resume."""
    coarse, recs = recordings
    _, _, first, ref = jax_run
    state = jckpt.load_state(first)
    path = str(tmp_path / "latest")
    checkpoint.save_state(path, interop.inversion_state(state))
    port = runner.invert_dataset(recs, grid=coarse, resume_from=path,
                                 **_port_kw())
    assert len(port.metrics["loss"]) == 2 * ITERS
    _golden(port, ref)


class _Killed(Exception):
    pass


def _kill_after(monkeypatch, n):
    """Make the n-th checkpoint save raise once it has written."""
    orig, calls = checkpoint.save_state, []

    def dying_save(path, state):
        orig(path, state)
        calls.append(path)
        if len(calls) == n:
            raise _Killed

    monkeypatch.setattr(checkpoint, "save_state", dying_save)
    return orig


@pytest.mark.parametrize("where", ["mid_stage", "stage_boundary"])
def test_resume_reproduces_uninterrupted(recordings, tmp_path, monkeypatch,
                                         where):
    """tests/test_fwi.py's kill-and-resume on the port, refactor_every=2: a
    run killed right after a checkpoint resumes from checkpoint_dir/latest
    and reproduces the uninterrupted run's losses and velocity (the same
    arithmetic, so rtol 1e-6). Mid-stage: one stage of 4, chunks of 2,
    killed at 2. Stage boundary: two stages of 2, killed at the end of the
    first, so the second starts with a fresh CG carry."""
    coarse, recs = recordings
    kw = dict(grid=coarse, acquisition=AcquisitionConfig(**ACQ),
              solver=SolverConfig(pml=PMLConfig(**PML), refactor_every=2),
              device="cpu")
    if where == "mid_stage":
        kw.update(dataset=recs[FREQS[1]], fwi=FWIConfig(num_iterations=4))
    else:
        kw.update(dataset=recs, continuation=ContinuationConfig(
            frequencies=FREQS, iterations_per_frequency=2))
    full = runner.invert_dataset(**kw)
    orig = _kill_after(monkeypatch, 1)
    with pytest.raises(_Killed):
        runner.invert_dataset(checkpoint_dir=str(tmp_path),
                              checkpoint_every=2, **kw)
    monkeypatch.setattr(checkpoint, "save_state", orig)
    st = checkpoint.load_state(str(tmp_path / "latest"))
    assert (int(st["stage"]), int(st["iteration"])) == (0, 2)
    resumed = runner.invert_dataset(resume_from=str(tmp_path / "latest"), **kw)
    tail = 4 if where == "mid_stage" else 2
    np.testing.assert_allclose(resumed.metrics["loss"][-tail:],
                               full.metrics["loss"][-tail:], rtol=1e-6)
    np.testing.assert_allclose(resumed.velocity, full.velocity, rtol=1e-6)


def test_make_logging_callback_matches(capsys):
    """The stage callback prints what the JAX package's prints, and skips
    the stages ``every`` leaves out."""
    loss = np.array([3.0e-3, 1.0e-3, 5.0e-4], np.float32)
    z = np.zeros(3, np.float32)
    outputs = []
    for make, metrics in (
            (runner.make_logging_callback, CGMetrics(loss, z, z, z)),
            (jrunner.make_logging_callback, JMetrics(loss, z, z, z))):
        cb = make(every=2, prefix="[t]")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            for stage in range(3):
                cb(stage, 350e3 + stage * 1e3, None, metrics)
            cb(4, 300e3, None, loss)  # a bare loss history, as L-BFGS gives
        outputs.append(buf.getvalue())
    assert outputs[0] == outputs[1]
    assert outputs[0].count("\n") == 3


def test_checkpoint_round_trip(tmp_path):
    """save_state writes CPU tensors only (torch.load with weights_only
    reads it), nested metrics survive, numpy scalars keep their dtypes, and
    the stage checkpointer writes one file a stage."""
    rng = np.random.default_rng(22)
    vel = torch.as_tensor(rng.uniform(1400, 1600, (5, 6)).astype(np.float32))
    state = {"velocity": vel, "stage": np.int32(1),
             "iteration": np.int32(3), "frequency": np.float64(2e5),
             "metrics": {"loss": np.arange(3, dtype=np.float32)}}
    path = str(tmp_path / "sub" / "latest")
    checkpoint.save_state(path, state)
    assert not os.path.exists(path + ".tmp")
    got = torch.load(path, weights_only=True)
    assert torch.equal(got["velocity"], vel)
    assert got["stage"].dtype == torch.int32 and int(got["iteration"]) == 3
    assert got["frequency"].dtype == torch.float64
    np.testing.assert_array_equal(got["metrics"]["loss"].numpy(),
                                  np.arange(3, dtype=np.float32))
    cb = checkpoint.make_stage_checkpointer(str(tmp_path / "stages"))
    cb(0, 150e3, vel.numpy(), None)
    cb(1, 200e3, vel, None)
    st = checkpoint.load_state(str(tmp_path / "stages" / "stage_001"))
    assert int(st["stage"]) == 1 and float(st["frequency"]) == 200e3
    assert sorted(os.listdir(tmp_path / "stages")) == ["stage_000", "stage_001"]


def test_inversion_state_converts_a_jax_state():
    """interop.inversion_state: numpy in (as orbax restores it), the port's
    dtypes out; optional fields stay optional."""
    rng = np.random.default_rng(23)
    state = {"velocity": rng.uniform(1400, 1600, (4, 4)),
             "search_dir": rng.standard_normal((4, 4)),
             "stage": np.asarray(1, np.int32), "iteration": np.asarray(2),
             "frequency": np.asarray(3e5),
             "metrics": {"loss": rng.uniform(size=2)}}
    out = interop.inversion_state(state)
    assert out["velocity"].dtype == out["search_dir"].dtype == torch.float32
    assert out["stage"].dtype == out["iteration"].dtype == torch.int32
    assert out["frequency"].dtype == torch.float64
    assert out["metrics"]["loss"].dtype == torch.float32
    assert "grad_prev" not in out
    bare = interop.inversion_state({k: state[k] for k in
                                    ("velocity", "stage", "iteration")})
    assert set(bare) == {"velocity", "stage", "iteration"}


@pytest.mark.parametrize("kw,exc,match", [
    (dict(mesh=object()), NotImplementedError, "slice 7"),
    (dict(method="newton"), ValueError, "unknown method"),
    (dict(method="gn", mesh=object()), NotImplementedError, "slice 7"),
    (dict(solver=SolverConfig(method=SolverMethod.GMRES, refactor_every=2)),
     ValueError, "frozen-factor"),
    (dict(solver=SolverConfig(method=SolverMethod.BORN, refactor_every=2)),
     ValueError, "frozen-factor"),
])
def test_later_slices_raise(recordings, kw, exc, match):
    """The mesh of a later slice raises and names it under every method
    (slice 7); an unknown method is a ValueError, as in the reference; so
    is the frozen-factor CG (``refactor_every > 1``) with GMRES or Born,
    the reference's guard (fwi/optimizers.py:190-196). The joint method
    runs on the {frequency: dataset} mapping."""
    coarse, recs = recordings
    data = recs if kw.get("method") == "joint-multifreq" else recs[FREQS[0]]
    with pytest.raises(exc, match=match):
        runner.invert_dataset(data, grid=coarse,
                              acquisition=AcquisitionConfig(**ACQ),
                              device="cpu", **kw)


@pytest.fixture(scope="module")
def small_recordings():
    """(grid, {250 kHz, 300 kHz: dataset}): a 17x17 ring of 6 elements,
    synthesized by the port on its own grid, where GMRES converges within
    its default cap."""
    grid = Grid2D.centered(6.4e-3, 0.8e-3)
    vel = smooth_blob_phantom(grid, radius=2.5e-3, dc=40, c_bkgnd=1500.0)
    acq = AcquisitionConfig(num_elements=6, radius=4e-3,
                            num_excluded_each_side=1)
    return grid, acq, {f: synthesize_ring_dataset(
        vel, grid, acq, f=f, seed=3,
        solver=SolverConfig(pml=PMLConfig(l_pml=1.6e-3)), device="cpu")
        for f in (250e3, 300e3)}


@pytest.mark.parametrize("method,solver_method", [
    ("lbfgs", SolverMethod.GMRES), ("gn", SolverMethod.BORN),
    ("joint-multifreq", SolverMethod.GMRES)])
def test_iterative_solvers_run_every_method(small_recordings, method,
                                            solver_method):
    """invert_dataset runs GMRES and Born under the methods the JAX
    package runs them with: 2 iterations, finite and decreasing losses
    (on the one intra-op thread tests/conftest.py sets)."""
    grid, acq, recs = small_recordings
    data = recs if method == "joint-multifreq" else recs[300e3]
    res = runner.invert_dataset(
        data, grid=grid, acquisition=acq,
        solver=SolverConfig(method=solver_method,
                            pml=PMLConfig(l_pml=1.6e-3)),
        fwi=FWIConfig(num_iterations=2), method=method, device="cpu")
    loss = np.asarray(res.metrics["loss"])
    assert loss.shape == (2,) and np.all(np.isfinite(loss))
    assert loss[1] < loss[0]
    assert np.all(np.isfinite(res.velocity))


# -- C6: signatures shared with the reference -------------------------------

MODULES = ["models.acquisition", "models.phantom", "models.grid3d",
           "models.acquisition3d", "data.synthesize", "data.qc", "data.matio",
           "data.timedomain", "data.timedomain3d",
           "ops.stencil", "ops.apply", "ops.banded", "ops.twisted",
           "ops.cyclic", "ops.batched_inv", "ops.krylov",
           "ops.preconditioner", "ops.born", "ops.born3d", "ops.solve",
           "fwi.objective", "fwi.optimizers", "fwi.regularization",
           "fwi.calibrate", "fwi.runner", "fwi.lbfgs", "fwi.newton",
           "fwi.resolution", "fwi.multifreq", "fwi.fwi3d", "fwi.runner3d",
           "fwi.eikonal", "fwi.traveltime", "fwi.eikonal3d",
           "fwi.traveltime3d", "utils.checkpoint", "cli", "viz",
           "utils.host", "utils.profiling", "utils.flops"]
# Parameters the port adds, beside the entry points' ``device=``, and why.
ALLOWED = {
    ("ops.batched_inv", "batched_inv"): {
        "pivot_inv": "the two-level blocking test passes its own pivot "
                     "inverse (tests/test_torch_ops.py)"},
    ("ops.banded", "banded_factor"): dict.fromkeys(
        ("schulz_steps", "precompute_sweeps"),
        "the scan hybrids, which the reference carries only in its split "
        "engine's banded_factor_cpx (ops/split_engine.py:279); the port's "
        "one complex64 factor takes them"),
}
SIMPLE = (bool, int, float, str, tuple, type(None))


def _shared(port, ref):
    """(name, port function, reference function) for every public function
    of the port module and every public method or classmethod of its
    public classes (``Grid3D.centered``) that the reference also has."""
    for name, fn in vars(port).items():
        if name.startswith("_") or getattr(fn, "__module__", None) != \
                port.__name__:
            continue
        if inspect.isclass(fn):
            twin_cls = getattr(ref, name, None)
            for meth, f in vars(fn).items():
                f = getattr(f, "__func__", f)
                twin = getattr(twin_cls, meth, None)
                twin = getattr(twin, "__func__", twin)
                if (not meth.startswith("_") and inspect.isfunction(f)
                        and inspect.isfunction(twin)):
                    yield f"{name}.{meth}", f, twin
            continue
        # The port carries complex64 where the reference has only its
        # split (re, im) form, named ``*_cpx`` (ops/cyclic.py).
        twin = getattr(ref, name, getattr(ref, f"{name}_cpx", None))
        if twin is not None and not inspect.isfunction(twin):
            twin = inspect.unwrap(twin)
        if inspect.isfunction(fn) and inspect.isfunction(twin):
            yield name, fn, twin


@pytest.mark.parametrize("module", MODULES)
def test_signatures_match_reference(module):
    """Every public function the port has in common with the JAX package,
    and every public method of its classes, takes the reference's
    parameters in the reference's order, with the same plain defaults; the
    port may add ``device`` and what ALLOWED lists. Functions of the JAX
    package the port does not have yet are not compared (they are queued
    in ROADMAP.md A). A twin wrapped in ``jax.jit`` is compared through the
    function it wraps."""
    port = importlib.import_module(f"waveforminversionust_tpu_torch.{module}")
    ref = importlib.import_module(f"waveforminversionust_tpu.{module}")
    compared = 0
    for name, fn, twin in _shared(port, ref):
        mine = inspect.signature(fn).parameters
        theirs = inspect.signature(twin).parameters
        extra = set(ALLOWED.get((module, name), {})) | {"device"}
        assert [p for p in mine if p not in extra] == list(theirs), name
        for p, par in theirs.items():
            if isinstance(par.default, SIMPLE):
                assert mine[p].default == par.default, (name, p)
            assert mine[p].kind == par.kind, (name, p)
        compared += 1
    assert compared


def test_batched_inv_pivot_choices():
    """batched_inv(pivot=...): "auto" and "xla" give the plain pivot
    inverse's bits on a CPU tensor, "pallas" raises there rather than fall
    back, an unknown name raises. (tests/test_torch_engines.py holds the
    result against the JAX package's pivot="xla".)"""
    rng = np.random.default_rng(24)
    a = (rng.standard_normal((3, 40, 40)) + 1j * rng.standard_normal((3, 40, 40))
         + 4 * np.eye(40)).astype(np.complex64)
    t = torch.as_tensor(a)
    auto = batched_inv.batched_inv(t, block=16)
    assert torch.equal(batched_inv.batched_inv(t, block=16, pivot="xla"), auto)
    with pytest.raises(ValueError, match="pallas"):
        batched_inv.batched_inv(t, block=16, pivot="pallas")
    with pytest.raises(ValueError, match="unknown pivot"):
        batched_inv.batched_inv(t, block=16, pivot="lu")
    rel = (np.linalg.norm(auto.numpy() - np.linalg.inv(a))
           / np.linalg.norm(np.linalg.inv(a)))
    assert rel < 5e-5, rel


def test_grid_axis_accepted():
    """grid_axis= is accepted wherever the reference takes it; it means
    nothing without mesh=, which still raises."""
    grid = Grid2D.centered(4e-3, 0.8e-3)
    cfg = SolverConfig(pml=PMLConfig(l_pml=1.6e-3))
    from waveforminversionust_tpu_torch.ops import solve
    op = solve.make_helmholtz_operator(torch.full(grid.shape, 1500.0), 3e5,
                                       grid, cfg, grid_axis="y")
    src = torch.zeros((1,) + grid.shape, dtype=torch.complex64)
    src[0, 2, 2] = 1
    u = solve.helmholtz_operator_solve(op, src, grid, cfg, grid_axis="y")
    assert torch.isfinite(u).all()
    with pytest.raises(NotImplementedError, match="slice 7"):
        solve.helmholtz_operator_solve(op, src, grid, cfg, mesh=object(),
                                       grid_axis="y")
