"""The plain reference of ``invert_dataset``: the CG reconstruction of
``reference.reconstruct`` (plain PyTorch, TF32 off; ``precision="tf32"``
is the control) over the loop's own input. Imports nothing of the
program."""

from __future__ import annotations

import reference


def expected(rec_data, config: dict, traffic: dict, device,
             precision: str = "fp32"):
    """(frames, losses) of the reconstruction of ``rec_data`` at the
    configuration's and the traffic's settings."""
    return reference.reconstruct(rec_data, config, traffic, device, precision)
