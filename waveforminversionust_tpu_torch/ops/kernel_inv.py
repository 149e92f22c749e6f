"""Batched small-matrix Gauss-Jordan inverse as a hand-written CUDA kernel
(``csrc/inv.cu``).

Replaces ``waveforminversionust_tpu/ops/pallas_inv.py::batched_small_inv_pallas``
(``_gj_kernel``). The plain version is
:func:`.batched_inv._batched_pivot_inv`; a CPU tensor takes it, a CUDA
tensor launches the kernel or raises. One launch inverts the whole batch,
one thread block per matrix.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_B = 64  # largest block the kernel holds in one thread block's registers

launches = 0  # kernel launches made through batched_small_inv_kernel


def _bind():
    fn = _build.load("inv").batched_small_inv
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def batched_small_inv_kernel(p: torch.Tensor) -> torch.Tensor:
    """Inverse of every (b, b) block of p (B, b, b) complex64, b <= 64, by
    unpivoted Gauss-Jordan with the pivot row and column overwritten by
    directly computed values."""
    global launches
    if p.device.type == "cpu":
        from .batched_inv import _batched_pivot_inv
        return _batched_pivot_inv(p)
    if p.dim() != 3 or p.shape[1] != p.shape[2]:
        raise ValueError(f"p shape {tuple(p.shape)} != (B, b, b)")
    if p.shape[1] > MAX_B:
        raise ValueError(f"block size {p.shape[1]} > {MAX_B}")
    if p.dtype != torch.complex64 or not p.is_contiguous():
        raise ValueError("inverse kernel takes a contiguous complex64 batch")
    out = torch.empty_like(p)
    if p.shape[0] == 0:
        return out
    n = ctypes.c_int(0)
    rc = _bind()(p.data_ptr(), out.data_ptr(), p.shape[0], p.shape[1],
                 ctypes.addressof(n), _build.stream_handle(p.device))
    launches += n.value
    _build.check(rc, "batched inverse kernel")
    return out
