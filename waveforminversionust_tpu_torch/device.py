"""Where the port's entry points run when the caller names no device."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The CUDA device the entry points run on by default. The port is
    written for the card: without one this raises, it never returns the
    CPU. A caller that wants the CPU (the tests do) passes
    ``device="cpu"`` explicitly."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: the port's entry points run on the "
            "card by default; pass device='cpu' to run the plain PyTorch "
            "path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(x, device=None) -> torch.device:
    """Where an entry point runs: ``device`` when named, else the device of
    ``x`` when it is a tensor (port tensors run where they live), else the
    card (:func:`default_device`, which raises without one)."""
    if device is not None:
        return torch.device(device)
    return x.device if isinstance(x, torch.Tensor) else default_device()
