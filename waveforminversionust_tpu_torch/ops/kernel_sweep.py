"""The block-Thomas solve sweeps as a hand-written CUDA kernel
(``csrc/sweep.cu``).

Replaces ``waveforminversionust_tpu/ops/pallas_sweep.py::banded_solve_pallas``
(``_fwd_kernel`` / ``_bwd_kernel``). The plain version is
:func:`.banded.banded_solve`; a CPU tensor takes it, a CUDA tensor launches
the kernel or raises.

The kernel runs thread-block clusters: a cluster owns a group of
right-hand sides and walks both passes of the solve in one launch
(``csrc/sweep.cu``). It takes grids up to nx = 1264 (16 right-hand sides a
cluster up to nx = 384, 8 up to 624, 4 beyond) and raises above;
:data:`last_launch` tells which configuration the last solve took.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .banded import BandedFactor, banded_solve

launches = 0  # kernel launches made through banded_solve_kernel
# The configuration of the last launch: right-hand sides a cluster, gemv
# rows a block, blocks a cluster, threads and shared-memory bytes a block,
# the clusters the card holds at once (cudaOccupancyMaxActiveClusters) and
# the clusters launched.
last_launch: dict = {}
LAUNCH_KEYS = ("rhs", "rows", "cluster", "threads", "smem_bytes",
               "max_active_clusters", "clusters")
NO_FIT = -1  # sweep_solve's code when no cluster configuration runs


def _bind():
    fn = _build.load("sweep").sweep_solve
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def banded_solve_kernel(factor: BandedFactor, b: torch.Tensor,
                        adjoint: bool = False) -> torch.Tensor:
    """Solve H x = b (or H^H x = b) through ``factor`` for b of shape
    (batch, ny, nx) complex64: one launch for both passes."""
    global launches, last_launch
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
    if g.data_ptr() % 16:
        raise ValueError("sweep kernel: G must be 16-byte aligned")
    z = torch.empty_like(b)
    x = torch.empty_like(b)
    out = (ctypes.c_int * (1 + len(LAUNCH_KEYS)))()
    rc = _bind()(g.data_ptr(), coeffs.data_ptr(), b.data_ptr(), z.data_ptr(),
                 x.data_ptr(), batch, ny, nx, int(adjoint),
                 ctypes.addressof(out), _build.stream_handle(b.device))
    launches += out[0]
    if rc == NO_FIT:
        raise RuntimeError(f"sweep kernel: no thread-block-cluster "
                           f"configuration runs at nx={nx} on this card")
    _build.check(rc, "sweep kernel")
    last_launch = dict(zip(LAUNCH_KEYS, list(out)[1:]))
    return x
