"""The PyTorch port's config mirror equals the JAX package's, and importing
the port leaves JAX out of the interpreter."""

import dataclasses
import enum
import os
import subprocess
import sys

import pytest

from waveforminversionust_tpu import config as jcfg
from waveforminversionust_tpu_torch import config as tcfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _norm(v):
    """Compare enums by (class name, member name, value) across packages."""
    if isinstance(v, enum.Enum):
        return (type(v).__name__, v.name, v.value)
    if dataclasses.is_dataclass(v):
        return {f.name: _norm(getattr(v, f.name)) for f in dataclasses.fields(v)}
    return v


@pytest.mark.parametrize("name", ["PMLConfig", "StencilConfig", "SolverConfig",
                                  "AcquisitionConfig", "FWIConfig",
                                  "ContinuationConfig"])
def test_dataclass_fields_and_defaults_match(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert _norm(t()) == _norm(j())
    assert t.__dataclass_params__.frozen


@pytest.mark.parametrize("name", ["MomentumFormula", "StepSizeFormula",
                                  "SolverMethod"])
def test_enums_match(name):
    j, t = getattr(jcfg, name), getattr(tcfg, name)
    assert [(m.name, m.value) for m in t] == [(m.name, m.value) for m in j]


def test_port_import_leaves_jax_out():
    """Every module of the port, and chip_smoke.py, import without JAX,
    without optax (the port keeps its own L-BFGS) and without the JAX
    package; the modules of the differentiable solve and of the L-BFGS,
    Gauss-Newton, resolution and joint multi-frequency paths and of the
    volumetric path, and interop, by name."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import waveforminversionust_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('ops.solve', 'fwi.lbfgs', 'fwi.newton', 'fwi.resolution',\n"
        "          'fwi.multifreq', 'fwi.runner', 'models.grid3d',\n"
        "          'models.acquisition3d', 'ops.born3d', 'fwi.fwi3d',\n"
        "          'fwi.runner3d', 'data.timedomain3d', 'interop'):\n"
        "    importlib.import_module('waveforminversionust_tpu_torch.' + m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('jaxlib') or m == 'optax'\n"
        "       or m.startswith('optax.') or m == 'waveforminversionust_tpu'\n"
        "       or m.startswith('waveforminversionust_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
