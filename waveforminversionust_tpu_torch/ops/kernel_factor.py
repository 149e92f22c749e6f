"""The block-Thomas factorization as hand-written CUDA kernels
(``csrc/factor.cu``).

Replaces ``waveforminversionust_tpu/ops/pallas_factor.py::factor_g_pallas``
(via ``banded_factor_pallas``). The plain version is
:func:`.banded.banded_factor`; a CPU tensor takes it, a CUDA tensor launches
the kernels or raises. One call issues the whole per-row series of
launches from C (see the source); ``launches`` counts each of them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .banded import BandedFactor, banded_factor

PANEL = 64  # Gauss-Jordan panel width of csrc/factor.cu

launches = 0  # kernel launches made through banded_factor_kernel


def _bind():
    fn = _build.load("factor").factor_g
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def banded_factor_kernel(coeffs: torch.Tensor) -> BandedFactor:
    """All Schur-complement inverses G (ny, nx, nx) complex64 of the
    (9, ny, nx) complex64 planes."""
    global launches
    if coeffs.device.type == "cpu":
        return banded_factor(coeffs)
    if coeffs.dim() != 3 or coeffs.shape[0] != 9:
        raise ValueError(f"coeffs shape {tuple(coeffs.shape)} != (9, ny, nx)")
    if coeffs.dtype != torch.complex64 or not coeffs.is_contiguous():
        raise ValueError("factor kernel takes contiguous complex64 planes")
    _, ny, nx = coeffs.shape
    g = torch.empty((ny, nx, nx), dtype=torch.complex64, device=coeffs.device)
    scratch = torch.empty(PANEL * PANEL + 4 * PANEL * nx, dtype=torch.complex64,
                          device=coeffs.device)
    n = ctypes.c_int(0)
    rc = _bind()(coeffs.data_ptr(), g.data_ptr(), scratch.data_ptr(), ny, nx,
                 ctypes.addressof(n), _build.stream_handle(coeffs.device))
    launches += n.value
    _build.check(rc, "factor kernel")
    return BandedFactor(g=g, coeffs=coeffs)
