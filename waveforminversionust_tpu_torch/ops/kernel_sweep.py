"""The block-Thomas solve sweeps as a hand-written CUDA kernel
(``csrc/sweep.cu``).

Replaces ``waveforminversionust_tpu/ops/pallas_sweep.py::banded_solve_pallas``
(``_fwd_kernel`` / ``_bwd_kernel``). The plain version is
:func:`.banded.banded_solve`; a CPU tensor takes it, a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .banded import BandedFactor, banded_solve

launches = 0  # kernel launches made through banded_solve_kernel


def _bind():
    fn = _build.load("sweep").sweep_solve
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def banded_solve_kernel(factor: BandedFactor, b: torch.Tensor,
                        adjoint: bool = False) -> torch.Tensor:
    """Solve H x = b (or H^H x = b) through ``factor`` for b of shape
    (batch, ny, nx) complex64: two launches, one per pass."""
    global launches
    if b.device.type == "cpu":
        return banded_solve(factor, b, adjoint=adjoint)
    g, coeffs = factor.g, factor.coeffs
    batch, ny, nx = b.shape
    if g.shape != (ny, nx, nx) or coeffs.shape != (9, ny, nx):
        raise ValueError(f"shapes g {tuple(g.shape)}, coeffs "
                         f"{tuple(coeffs.shape)}, b {tuple(b.shape)}")
    for t in (g, coeffs, b):
        if t.device != b.device or t.dtype != torch.complex64 or not t.is_contiguous():
            raise ValueError("sweep kernel takes contiguous complex64 tensors "
                             "on one CUDA device")
    z = torch.empty_like(b)
    x = torch.empty_like(b)
    n = ctypes.c_int(0)
    rc = _bind()(g.data_ptr(), coeffs.data_ptr(), b.data_ptr(), z.data_ptr(),
                 x.data_ptr(), batch, ny, nx, int(adjoint), ctypes.addressof(n),
                 _build.stream_handle(b.device))
    launches += n.value
    _build.check(rc, "sweep kernel")
    return x
