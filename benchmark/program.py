"""The system under test, the PyTorch/CUDA port, seen from the benchmark:
what every entry shares (the port's kernel build, its counters by name,
the configuration's settings as the port's objects) and the adapters of
the two ring entries, ``invert_dataset`` and ``synthesize_ring_dataset``.
The benchmark reaches the port through this module and the loops under
``entries/``."""

from __future__ import annotations

import importlib

import numpy as np

from waveforminversionust_tpu_torch.config import (AcquisitionConfig,
                                                   FWIConfig, MomentumFormula,
                                                   PMLConfig, SolverConfig,
                                                   StencilConfig,
                                                   StepSizeFormula)
from waveforminversionust_tpu_torch.data.synthesize import (
    RingDataset, synthesize_ring_dataset)
from waveforminversionust_tpu_torch.fwi.runner import invert_dataset
from waveforminversionust_tpu_torch.models.grid import Grid2D
from waveforminversionust_tpu_torch.ops import _build

PORT = "waveforminversionust_tpu_torch"


def build_kernels() -> None:
    """Build (or find built in the checkout) and load every CUDA kernel."""
    for name in _build.SOURCES:
        _build.load(name)


def launches(counters) -> dict:
    """Each counter's count so far. A counter is named
    ``"<module>:<attribute>"``, the module's path under the port's package
    (``ops.kernel_factor:launches``)."""
    out = {}
    for name in counters:
        mod, sep, attr = name.partition(":")
        if not (sep and mod and attr):
            raise ValueError(f"counter {name!r} is not <module>:<attribute>")
        out[name] = int(getattr(importlib.import_module(f"{PORT}.{mod}"), attr))
    return out


def _grid(spec: dict) -> Grid2D:
    return Grid2D.centered(float(spec["xmax"]), float(spec["dx"]))


def _acquisition(config: dict) -> AcquisitionConfig:
    r = config["ring"]
    return AcquisitionConfig(num_elements=int(r["num_elements"]),
                             radius=float(r["radius"]),
                             num_excluded_each_side=int(r["num_excluded_each_side"]))


def _solver(config: dict, traffic: dict) -> SolverConfig:
    s, p, st = config["solver"], config["pml"], config["stencil"]
    return SolverConfig(
        factorization=s["factorization"], factor_precision=s["factor_precision"],
        refactor_every=int(traffic.get("refactor_every", 1)),
        pml=PMLConfig(a0=float(p["a0"]), l_pml=float(p["l_pml"]),
                      sign_convention=int(p["sign_convention"])),
        stencil=StencilConfig(angular_resolution=int(st["angular_resolution"]),
                              range_resolution=int(st["range_resolution"]),
                              fix_b=bool(st["fix_b"]),
                              corner_mode=st["corner_mode"]))


def _fwi(config: dict, traffic: dict) -> FWIConfig:
    w = config["fwi"]
    return FWIConfig(c_init=float(w["c_init"]),
                     num_iterations=int(traffic["iterations"]),
                     momentum=MomentumFormula[w["momentum"].upper()],
                     step_size=StepSizeFormula[w["step_size"].upper()],
                     estimate_source_strength=bool(w["estimate_source_strength"]),
                     reject_nonfinite=bool(w["reject_nonfinite"]))


class Inversion:
    """``invert_dataset`` at a configuration and traffic's settings."""

    def __init__(self, config: dict, traffic: dict, x_elem, y_elem, device):
        self.grid = _grid(config["grid"])
        self.f = float(config["frequency"])
        self.acq = _acquisition(config)
        self.solver = _solver(config, traffic)
        self.fwi = _fwi(config, traffic)
        self.method = traffic["method"]
        self.live_every = traffic.get("live_every")
        self.x_elem, self.y_elem = x_elem, y_elem
        self.device = device

    def __call__(self, rec_data: np.ndarray, live_callback=None):
        """Invert one recorded (n_elem, n_elem) matrix; returns (velocity,
        loss history) as numpy."""
        empty = np.zeros(0)
        ds = RingDataset(x=empty, y=empty, c=empty, x_circ=self.x_elem,
                         y_circ=self.y_elem, f=self.f, rec_data=rec_data)
        res = invert_dataset(ds, grid=self.grid, acquisition=self.acq,
                             solver=self.solver, fwi=self.fwi,
                             method=self.method,
                             live_every=self.live_every if live_callback else None,
                             live_callback=live_callback, device=self.device)
        return res.velocity, np.asarray(res.metrics["loss"])


class Synthesis:
    """``synthesize_ring_dataset`` at a configuration's settings."""

    def __init__(self, config: dict, traffic: dict, device):
        self.grid = _grid(config["grid"])
        self.f = float(config["frequency"])
        self.acq = _acquisition(config)
        self.solver = _solver(config, traffic)
        self.device = device

    def __call__(self, vel: np.ndarray, seed: int) -> np.ndarray:
        """Receiver data (n_elem, n_elem) over ``vel`` with the random
        amplitudes of ``seed``."""
        ds = synthesize_ring_dataset(vel, self.grid, self.acq, f=self.f,
                                     solver=self.solver, seed=seed,
                                     random_amplitudes=True,
                                     device=self.device)
        return ds.rec_data
