"""The system under test, the PyTorch/CUDA port, seen from the benchmark:
its two timed entries called with the benchmark's inputs, its kernel build
and its launch counters. This is the only module of the benchmark that
imports the port."""

from __future__ import annotations

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
from waveforminversionust_tpu_torch.ops import (_build, kernel_factor,
                                                kernel_inv, kernel_stencil,
                                                kernel_sweep, kernel_twisted)

# the port's launch counters, by the name a kernel mapping file gives
_COUNTERS = {"kernel_factor": (kernel_factor, "launches"),
             "kernel_sweep": (kernel_sweep, "launches"),
             "kernel_stencil": (kernel_stencil, "launches"),
             "kernel_twisted_factor": (kernel_twisted, "factor_launches"),
             "kernel_twisted_sweep": (kernel_twisted, "sweep_launches"),
             "kernel_inv": (kernel_inv, "launches")}


def build_kernels() -> None:
    """Build (or find built in the checkout) and load every CUDA kernel."""
    for name in _build.SOURCES:
        _build.load(name)


def launches() -> dict:
    """Kernel launches so far, by counter name."""
    return {k: int(getattr(mod, attr, 0)) for k, (mod, attr) in _COUNTERS.items()}


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
