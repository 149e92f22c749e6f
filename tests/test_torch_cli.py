"""The port's command-line interface held against the JAX package's on the
CPU (``--device cpu``): every subcommand's options and defaults; simulate,
run (cg, gn, --qc-compensate, alpha) and qc against the JAX CLI's outputs
at the tiny ring of tests/golden/generate_torch.py (from
tests/golden/torch_cli.npz; ``simulate`` + ``run`` once live); broadband,
broadband3d and timedomain at toy flags; bench and a missing card raising.
"""

import argparse
import contextlib
import importlib.util
import io
import os
import re
import runpy
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from waveforminversionust_tpu_torch import cli
from waveforminversionust_tpu_torch.data import matio

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _load_generator():
    spec = importlib.util.spec_from_file_location(
        "generate_torch", os.path.join(GOLDEN, "generate_torch.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen


GEN = _load_generator()
CPU = ["--device", "cpu"]
SUBCOMMANDS = ["run", "simulate", "timedomain", "broadband", "broadband3d",
               "bench", "qc"]


@pytest.fixture(scope="module")
def ref():
    """The JAX CLI's outputs (tests/golden/generate_torch.py cli)."""
    return np.load(os.path.join(GOLDEN, "torch_cli.npz"))


@pytest.fixture(scope="module")
def recorded(ref, tmp_path_factory):
    """The JAX CLI's simulated dataset, written by the port's save_mat."""
    path = str(tmp_path_factory.mktemp("cli") / "tiny.mat")
    matio.save_mat(path, {k: ref[f"sim_{k}"] for k in GEN.CLI_DATASET})
    return path


# -- the parser -----------------------------------------------------------------

class _Parsed(Exception):
    pass


def _subparsers(main):
    """{subcommand: parser} as ``main`` builds them, caught at parse time."""
    seen = {}

    def catch(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    with mock.patch.object(argparse.ArgumentParser, "parse_args", catch), \
            pytest.raises(_Parsed):
        main(["qc", "x"])
    sub = next(a for a in seen["parser"]._actions
               if isinstance(a, argparse._SubParsersAction))
    return sub.choices


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.nargs, a.const,
                     a.type, None if a.choices is None else tuple(a.choices),
                     a.required, a.metavar)
            for a in parser._actions if a.dest not in ("help", "device")}


@pytest.mark.parametrize("cmd", SUBCOMMANDS)
def test_options_and_defaults_match_the_reference(cmd, capsys):
    """Each subcommand takes the JAX CLI's options with the same defaults,
    choices, nargs and types; the port adds only ``--device``. Its
    ``--help`` prints and exits 0."""
    from waveforminversionust_tpu.cli import main as jmain
    port, theirs = _subparsers(cli.main), _subparsers(jmain)
    assert set(port) == set(theirs) == set(SUBCOMMANDS)
    assert _options(port[cmd]) == _options(theirs[cmd])
    device = next(a for a in port[cmd]._actions if a.dest == "device")
    assert device.option_strings == ["--device"] and device.default is None
    with pytest.raises(SystemExit) as e:
        cli.main([cmd, "--help"])
    assert e.value.code == 0
    assert "--device" in capsys.readouterr().out


# -- against the JAX CLI ------------------------------------------------------

def _loss(out: str) -> np.ndarray:
    return np.array([float(v) for v in re.search(
        r"loss history: \[([^\]]*)\]", out).group(1).split()])


def test_simulate_matches_jax(ref, tmp_path):
    """simulate's .mat equals the JAX CLI's: the grid, ring, frequency and
    phantom exactly, the data at the synthesizer's rel 5e-5
    (tests/test_torch_fwi.py::test_synthesize_matches)."""
    path = str(tmp_path / "tiny.mat")
    cli.main(["simulate", path] + GEN.CLI_SIMULATE + CPU)
    got = matio.load_mat(path)
    assert set(got) == set(GEN.CLI_DATASET)
    for k in GEN.CLI_DATASET:
        if k != "REC_DATA":
            np.testing.assert_array_equal(got[k], ref[f"sim_{k}"])
    want = ref["sim_REC_DATA"]
    rel = np.linalg.norm(got["REC_DATA"] - want) / np.linalg.norm(want)
    assert rel < 5e-5, rel


@pytest.fixture(scope="module")
def runs(recorded, tmp_path_factory):
    """Each run variant of the port's CLI on the JAX CLI's dataset: its
    .mat export and printed output. The cg run also draws its plots and
    live panels, which change nothing in its result."""
    out_dir = tmp_path_factory.mktemp("runs")
    results = {}
    for name, extra in GEN.CLI_RUNS.items():
        path = str(out_dir / f"{name}.mat")
        more = []
        if name == "cg":
            more = ["--plot", str(out_dir / "rec.png"),
                    "--live-plot", str(out_dir / "live")]
        stdout = io.StringIO()
        with contextlib.redirect_stdout(stdout):
            cli.main(["run", recorded, "--out", path] + GEN.CLI_RUN + extra
                     + more + CPU)
        results[name] = (matio.load_mat(path), stdout.getvalue())
    results["dir"] = out_dir
    return results


@pytest.mark.parametrize("name", list(GEN.CLI_RUNS))
def test_run_matches_jax(ref, runs, name):
    """run's .mat export against the JAX CLI's on the same dataset, at the
    golden bounds of tests/test_golden.py: loss rtol 1e-2, velocity atol
    0.5 m/s (alpha: its attenuation map, atol 0.5 Np/m, and its velocity,
    the fixed start). --qc-compensate prints the asymmetry falling, as
    tests/test_misc.py::test_cli_qc_compensate holds it."""
    got, out = runs[name]
    for k in ("xi", "yi"):
        np.testing.assert_array_equal(got[k], ref[f"{name}_{k}"])
    np.testing.assert_allclose(got["VEL_F"], ref[f"{name}_VEL_F"], atol=0.5)
    if name == "alpha":
        np.testing.assert_allclose(got["ALPHA_F"], ref["alpha_ALPHA_F"],
                                   atol=0.5)
        assert np.isfinite(_loss(out)).all()
        return
    np.testing.assert_allclose(got["loss"], ref[f"{name}_loss"], rtol=1e-2)
    np.testing.assert_allclose(_loss(out), got["loss"].ravel(), rtol=2e-3)
    assert got["loss"].ravel()[-1] < got["loss"].ravel()[0]
    if name == "qc_compensate":
        m = re.search(r"asymmetry ([\d.eE+-]+) -> ([\d.eE+-]+)", out)
        assert m and float(m.group(2)) < 0.1 * float(m.group(1))


def test_run_out_mat_round_trips(runs):
    """run --out *.mat holds VEL_F / xi / yi / loss (the reference's
    workspace names) at the inversion grid's shape, read back by the
    port's load_mat; --plot and --live-plot wrote their figures."""
    got, _ = runs["cg"]
    assert set(got) == {"VEL_F", "xi", "yi", "loss"}
    assert got["VEL_F"].shape == (61, 61)
    assert got["xi"].size == got["yi"].size == 61
    assert got["loss"].size == 2 and np.isfinite(got["loss"]).all()
    for f in ("rec.png", "rec_conv.png", os.path.join("live", "live.png")):
        assert os.path.getsize(runs["dir"] / f) > 10_000, f


def test_mat_without_h5py_round_trips(ref, tmp_path, monkeypatch):
    """On a host without h5py, save_mat writes a MATLAB v5
    file through scipy, with a warning that names the format, that
    load_mat and load_recorded_dataset read back: scalars as 1x1, vectors
    as columns, complex data intact."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    path = str(tmp_path / "v5.mat")
    arrays = {k: ref[f"sim_{k}"] for k in GEN.CLI_DATASET}
    with pytest.warns(UserWarning, match="MATLAB v5"):
        matio.save_mat(path, dict(arrays, f=float(arrays["f"].ravel()[0]),
                                  x=arrays["x"].ravel()))
    with open(path, "rb") as fh:
        assert fh.read(10) == b"MATLAB 5.0"
    got = matio.load_mat(path)
    for k, want in arrays.items():
        np.testing.assert_array_equal(got[k], want)
    ds = matio.load_recorded_dataset(path)
    assert ds.f == 200e3 and ds.rec_data.dtype == np.complex64


def test_qc_matches_jax(ref, recorded, tmp_path, capsys):
    """qc --out writes the JAX CLI's compensated data (host numpy, the same
    bits) and reports the asymmetry falling."""
    path = str(tmp_path / "qc.mat")
    cli.main(["qc", recorded, "--out", path] + CPU)
    np.testing.assert_array_equal(matio.load_mat(path)["REC_DATA"],
                                  ref["qc_REC_DATA"])
    m = re.search(r"raw ([\d.eE+-]+) -> compensated ([\d.eE+-]+)",
                  capsys.readouterr().out)
    assert m and float(m.group(2)) < 0.1 * float(m.group(1))


def test_simulate_and_run_live_against_jax(tmp_path):
    """The one live comparison: the JAX CLI simulates and inverts (cg, 2
    iterations) here, and the port's run on that file, with --profile,
    lands at the golden bounds; the profile holds a Chrome trace."""
    from waveforminversionust_tpu.cli import main as jmain
    data = str(tmp_path / "tiny.mat")
    jmain(["simulate", data] + GEN.CLI_SIMULATE)
    jout, pout = str(tmp_path / "jax.mat"), str(tmp_path / "port.mat")
    jmain(["run", data, "--out", jout] + GEN.CLI_RUN)
    cli.main(["run", data, "--out", pout, "--profile", str(tmp_path / "prof")]
             + GEN.CLI_RUN + CPU)
    want, got = matio.load_mat(jout), matio.load_mat(pout)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-2)
    np.testing.assert_allclose(got["VEL_F"], want["VEL_F"], atol=0.5)
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0


# -- the port alone, at toy flags ---------------------------------------------

def test_broadband_toy(tmp_path, capsys):
    """broadband at tests/test_misc.py's toy flags with the straight
    travel-time start: finite losses, the plot written."""
    cli.main(["broadband", "--xmax", "12e-3", "--fine-dx", "0.4e-3",
              "--inv-dx", "0.8e-3", "--elements", "12", "--radius", "9e-3",
              "--exclude", "2", "--f-low", "0.15e6", "--f-high", "0.25e6",
              "--df", "0.05e6", "--freqs", "0.15e6", "0.25e6",
              "--iterations", "1", "--c-init", "1500", "--traveltime-init",
              "--gate", "2e-6", "5e-6", "2e-6",
              "--plot", str(tmp_path / "bb.png")] + CPU)
    out = capsys.readouterr().out
    assert np.isfinite(_loss(out)).all() and _loss(out).size == 2
    assert "travel-time starting model RMSE" in out
    assert os.path.getsize(tmp_path / "bb.png") > 10_000


def test_broadband3d_toy(tmp_path, capsys):
    """broadband3d at tests/test_misc.py's toy flags: finite losses, the
    slice plot and the volume written."""
    cli.main(["broadband3d", "--xmax", "12e-3", "--dx", "1e-3",
              "--rings", "2", "--per-ring", "8", "--radius", "8e-3",
              "--z-span", "6e-3", "--min-angle", "0.8", "--l-pml", "12e-3",
              "--f-low", "0.2e6", "--f-high", "0.3e6", "--df", "0.05e6",
              "--freqs", "0.25e6", "--iterations", "1",
              "--out", str(tmp_path / "vol.npy"),
              "--plot", str(tmp_path / "bb3.png")] + CPU)
    assert np.isfinite(_loss(capsys.readouterr().out)).all()
    assert os.path.getsize(tmp_path / "bb3.png") > 10_000
    v = np.load(tmp_path / "vol.npy")
    assert v.shape == (25, 25, 25) and np.all(np.isfinite(v))


def test_timedomain_toy(tmp_path, capsys):
    """timedomain at a 25^2 grid: the film strip written."""
    cli.main(["timedomain", "--xmax", "12e-3", "--dx", "1e-3",
              "--elements", "16", "--radius", "9e-3", "--element", "3",
              "--plot", str(tmp_path / "td.png")] + CPU)
    assert "time frames over 81 frequencies" in capsys.readouterr().out
    assert os.path.getsize(tmp_path / "td.png") > 10_000


# runpy warns that the module was imported before it runs as __main__
@pytest.mark.filterwarnings("ignore:.*found in sys.modules:RuntimeWarning")
def test_bench_raises(monkeypatch):
    """bench would import the JAX package's bench.py, which the port may
    not: it raises, naming the port's benchmark to come, also when the CLI
    runs as a module (``python -m waveforminversionust_tpu_torch.cli``)."""
    with pytest.raises(NotImplementedError, match="benchmark"):
        cli.main(["bench"] + CPU)
    monkeypatch.setattr(sys, "argv", ["cli", "bench"] + CPU)
    with pytest.raises(NotImplementedError, match="benchmark"):
        runpy.run_module("waveforminversionust_tpu_torch.cli",
                         run_name="__main__")


def test_without_a_card_the_cli_raises(recorded, monkeypatch):
    """Without --device the subcommands run on the card; with none, they
    raise rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["qc", recorded], ["run", recorded],
                 ["simulate", "x.mat"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)
