"""The 9-point apply as a hand-written CUDA kernel (``csrc/stencil.cu``).

Replaces ``waveforminversionust_tpu/ops/pallas_stencil.py``'s
``h_apply_pallas_cpx`` and ``h_apply_tiled_cpx``: one kernel serves both
call sites. The plain version is :func:`.apply.h_apply`; a CPU tensor takes
it, a CUDA tensor launches the kernel or raises. A block of the kernel owns a
32 x 16 tile of the grid for a group of 8 fields, streamed through shared
memory.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .apply import h_apply

launches = 0  # kernel launches made through h_apply_kernel


def _bind():
    fn = _build.load("stencil").stencil9_apply
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def h_apply_kernel(coeffs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """out[b] = sum_s coeffs[s] * shift_s(u[b]) for coeffs (9, ny, nx) and
    u (batch, ny, nx), both complex64. Pass adjoint_coefficients planes for
    the adjoint apply."""
    global launches
    if u.device.type == "cpu":
        return h_apply(coeffs, u)
    if u.dim() != 3 or coeffs.shape != (9,) + tuple(u.shape[1:]):
        raise ValueError(f"shapes coeffs {tuple(coeffs.shape)}, u {tuple(u.shape)}")
    for t in (coeffs, u):
        if t.device != u.device or t.dtype != torch.complex64 or not t.is_contiguous():
            raise ValueError("stencil kernel takes contiguous complex64 tensors "
                             "on one CUDA device")
    batch, ny, nx = u.shape
    out = torch.empty_like(u)
    n = ctypes.c_int(0)
    rc = _bind()(coeffs.data_ptr(), u.data_ptr(), out.data_ptr(), batch, ny, nx,
                 ctypes.addressof(n), _build.stream_handle(u.device))
    launches += n.value
    _build.check(rc, "stencil kernel")
    return out
