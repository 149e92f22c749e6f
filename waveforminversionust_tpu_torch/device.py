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
