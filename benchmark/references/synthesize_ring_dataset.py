"""The plain reference of ``synthesize_ring_dataset``: the amplitudes
drawn from the unit's seed as SimulateData.m:23-27 draws them, and the
direct solve of ``reference.synthesize`` (plain PyTorch, TF32 off;
``precision="tf32"`` is the control). Imports nothing of the program."""

from __future__ import annotations

import numpy as np

import reference


def expected(vel: np.ndarray, amp_seed: int, config: dict, device,
             precision: str = "fp32") -> np.ndarray:
    """The receiver data over ``vel`` with the amplitudes of ``amp_seed``."""
    rng = np.random.default_rng(amp_seed)
    n = int(config["ring"]["num_elements"])
    amps = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    return reference.synthesize(vel, config, amps, device, precision)
