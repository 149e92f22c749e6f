"""The twisted (two-sided) factorization and its solve sweeps as
hand-written CUDA kernels (``csrc/twisted.cu``).

Replaces ``waveforminversionust_tpu/ops/pallas_twisted.py``:
``twisted_factor_pallas`` (``_tfactor_kernel``) and ``twisted_solve_pallas``
(``_in_kernel`` / ``_out_kernel``). The plain versions are
:func:`.twisted.twisted_factor` and :func:`.twisted.twisted_solve`; a CPU
tensor takes them, a CUDA tensor launches the kernels or raises.

The factor is the port's :class:`.twisted.TwistedFactor` with row-ordered,
unpadded ``g`` (ny, nx, nx), the type the plain version returns. The
reference kernel's ``g_down`` / ``g_up`` block-step layout, its padding to a
panel multiple and its refusal of ``m > ny - 1 - m`` follow from the TPU's
block pipeline and are not carried over: these kernels take any middle row
``0 < m < ny - 1``, like the plain versions.

The sweeps run the thread-block-cluster row step of the block-Thomas sweeps
(``csrc/sweep_cluster.cuh``), one cluster per (group of right-hand sides,
chain). They take grids up to nx = 1264 and raise above;
:data:`last_sweep_launch` tells which configuration the last solve took.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .kernel_factor import PANEL
from .kernel_sweep import LAUNCH_KEYS, NO_FIT
from .twisted import (TwistedFactor, check_middle_row, twisted_factor,
                      twisted_solve)

factor_launches = 0  # kernel launches made through twisted_factor_kernel
sweep_launches = 0   # kernel launches made through twisted_solve_kernel
# The configuration of the last solve's two launches, under
# kernel_sweep.LAUNCH_KEYS; "clusters" counts both chains' clusters.
last_sweep_launch: dict = {}


def _bind_factor():
    fn = _build.load("twisted").twisted_factor_g
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def _bind_sweep():
    fn = _build.load("twisted").twisted_sweep_solve
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def twisted_factor_kernel(coeffs: torch.Tensor,
                          m: int | None = None) -> TwistedFactor:
    """Twisted factorization of the (9, ny, nx) complex64 planes about the
    middle row ``m`` (default :func:`.twisted.middle_row`; any
    ``0 < m < ny - 1``, else ``ValueError``). One series of launches
    advances both chains a row; a last series inverts the middle."""
    global factor_launches
    if coeffs.device.type == "cpu":
        return twisted_factor(coeffs, m)
    if coeffs.dim() != 3 or coeffs.shape[0] != 9:
        raise ValueError(f"coeffs shape {tuple(coeffs.shape)} != (9, ny, nx)")
    if coeffs.dtype != torch.complex64 or not coeffs.is_contiguous():
        raise ValueError("twisted factor kernel takes contiguous complex64 "
                         "planes")
    _, ny, nx = coeffs.shape
    m = check_middle_row(ny, m)
    g = torch.empty((ny, nx, nx), dtype=torch.complex64, device=coeffs.device)
    # pinv, rs, cz, cs of the Gauss-Jordan panels, once per chain
    scratch = torch.empty(2 * (PANEL * PANEL + 4 * PANEL * nx),
                          dtype=torch.complex64, device=coeffs.device)
    n = ctypes.c_int(0)
    rc = _bind_factor()(coeffs.data_ptr(), g.data_ptr(), scratch.data_ptr(),
                        ny, nx, m, ctypes.addressof(n),
                        _build.stream_handle(coeffs.device))
    factor_launches += n.value
    _build.check(rc, "twisted factor kernel")
    return TwistedFactor(g=g, coeffs=coeffs, m=m)


def twisted_solve_kernel(factor: TwistedFactor, b: torch.Tensor,
                         adjoint: bool = False) -> torch.Tensor:
    """Solve H x = b (or H^H x = b) through ``factor`` for b of shape
    (batch, ny, nx) complex64: one launch walks both chains inward, a
    second forms the middle and walks both outward."""
    global sweep_launches, last_sweep_launch
    if b.device.type == "cpu":
        return twisted_solve(factor, b, adjoint=adjoint)
    g, coeffs, m = factor.g, factor.coeffs, factor.m
    batch, ny, nx = b.shape
    if g.shape != (ny, nx, nx) or coeffs.shape != (9, ny, nx):
        raise ValueError(f"shapes g {tuple(g.shape)}, coeffs "
                         f"{tuple(coeffs.shape)}, b {tuple(b.shape)}")
    check_middle_row(ny, m)
    for t in (g, coeffs, b):
        if t.device != b.device or t.dtype != torch.complex64 or not t.is_contiguous():
            raise ValueError("twisted sweep kernel takes contiguous complex64 "
                             "tensors on one CUDA device")
    if g.data_ptr() % 16:
        raise ValueError("twisted sweep kernel: g must be 16-byte aligned")
    # the inward vectors (batch, ny, nx), then both chains' vectors onto
    # the middle row (2, batch, nx)
    z = torch.empty(batch * (ny + 2) * nx, dtype=b.dtype, device=b.device)
    x = torch.empty_like(b)
    out = (ctypes.c_int * (1 + len(LAUNCH_KEYS)))()
    rc = _bind_sweep()(g.data_ptr(), coeffs.data_ptr(), b.data_ptr(),
                       z.data_ptr(), x.data_ptr(), batch, ny, nx, m,
                       int(adjoint), ctypes.addressof(out),
                       _build.stream_handle(b.device))
    sweep_launches += out[0]
    if rc == NO_FIT:
        raise RuntimeError(f"twisted sweep kernel: no thread-block-cluster "
                           f"configuration runs at nx={nx} on this card")
    _build.check(rc, "twisted sweep kernel")
    last_sweep_launch = dict(zip(LAUNCH_KEYS, list(out)[1:]))
    return x
