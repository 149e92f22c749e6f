"""Batched small-matrix Gauss-Jordan inverse as a hand-written CUDA kernel
(``csrc/inv.cu``).

Replaces ``waveforminversionust_tpu/ops/pallas_inv.py::batched_small_inv_pallas``
(``_gj_kernel``). The plain version is
:func:`.batched_inv._batched_pivot_inv`; a CPU tensor takes it, a CUDA
tensor launches the kernel or raises. One launch inverts the whole batch,
one thread block per matrix: 8 warps holding 4 x 4 tiles of it in registers.

``csrc/inv.cu`` has a second entry for the same function,
:func:`pivot_inverse_kernel`: the blocked inverse that the factorizations'
pivot step runs (``csrc/gj_pivot.cuh``) launched on its own, so that it can be
tested at every ragged width and timed without a profiler. No path of the
port calls it.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

MAX_B = 64  # largest block either kernel holds in one thread block

launches = 0        # kernel launches made through batched_small_inv_kernel
pivot_launches = 0  # and through pivot_inverse_kernel (no path's kernel)


def _launch(entry: str, p: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(inverse, kernels launched) of p (B, b, b) through a C entry point
    of ``csrc/inv.cu``."""
    if p.dim() != 3 or p.shape[1] != p.shape[2]:
        raise ValueError(f"p shape {tuple(p.shape)} != (B, b, b)")
    if p.shape[1] > MAX_B:
        raise ValueError(f"block size {p.shape[1]} > {MAX_B}")
    if p.dtype != torch.complex64 or not p.is_contiguous():
        raise ValueError("inverse kernel takes a contiguous complex64 batch")
    out = torch.empty_like(p)
    if p.shape[0] == 0:
        return out, 0
    fn = getattr(_build.load("inv"), entry)
    fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    rc = fn(p.data_ptr(), out.data_ptr(), p.shape[0], p.shape[1],
            ctypes.addressof(n), _build.stream_handle(p.device))
    _build.check(rc, f"inverse kernel {entry}")
    return out, n.value


def batched_small_inv_kernel(p: torch.Tensor) -> torch.Tensor:
    """Inverse of every (b, b) block of p (B, b, b) complex64, b <= 64, by
    unpivoted Gauss-Jordan with the pivot row and column overwritten by
    directly computed values."""
    global launches
    if p.device.type == "cpu":
        from .batched_inv import _batched_pivot_inv
        return _batched_pivot_inv(p)
    out, n = _launch("batched_small_inv", p)
    launches += n
    return out


def pivot_inverse_kernel(p: torch.Tensor) -> torch.Tensor:
    """The same inverse by the factorizations' blocked pivot step
    (sub-panels of 8 eliminated inside one warp), one block per matrix."""
    global pivot_launches
    if p.device.type == "cpu":
        from .batched_inv import _batched_pivot_inv
        return _batched_pivot_inv(p)
    out, n = _launch("blocked_small_inv", p)
    pivot_launches += n
    return out
