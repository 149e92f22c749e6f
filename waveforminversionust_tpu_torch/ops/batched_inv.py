"""Batched dense complex inversion by blocked, unpivoted Gauss-Jordan (port
of ``waveforminversionust_tpu/ops/batched_inv.py``).

The cyclic-reduction factorization (:mod:`.cyclic`) inverts hundreds of
independent (nx, nx) blocks per level. Per panel of width ``block``:

  * the (block, block) pivot block is inverted by a scalar Gauss-Jordan,
    the CUDA kernel of :mod:`.kernel_inv` on a CUDA tensor and its plain
    version :func:`_batched_pivot_inv` on a CPU tensor;
  * the O(n^3) work is three batched products (``torch.bmm``), which sit
    outside any kernel in the reference as well.

Unpivoted elimination is safe for the Helmholtz Schur blocks this serves
(the whole direct-solver stack is unpivoted at ~1e-6 residuals).

Numerical note, as in the reference: the single rank-1 update
``W <- W - (C - E) P^-1 (R + E^T)`` computes the new pivot entry 1/p as
``p - (p^2 - 1)/p``, which cancels catastrophically in FP32 when |p| >> 1
(the Dirichlet rows have p ~ 1/h^2 ~ 1.6e6). So the plain elimination
update goes to the trailing part and the pivot row and column are
overwritten with directly computed values (R p^-1, -C p^-1, p^-1).
"""

from __future__ import annotations

import torch

from .kernel_inv import batched_small_inv_kernel


def _batched_pivot_inv(p: torch.Tensor) -> torch.Tensor:
    """Inverse of a batch of small complex matrices (B, b, b) by scalar
    Gauss-Jordan, one batched rank-1 update per elimination index. The plain
    version of the CUDA kernel (:func:`.kernel_inv.batched_small_inv_kernel`).
    """
    b = p.shape[-1]
    w = p.clone()
    for j in range(b):
        row = w[:, j:j + 1, :].clone()       # (B, 1, b)
        col = w[:, :, j:j + 1].clone()       # (B, b, 1)
        piv = row[:, :, j:j + 1]             # (B, 1, 1)
        # 1 / pivot, computed directly (no cancellation)
        den = torch.clamp(piv.real * piv.real + piv.imag * piv.imag,
                          min=1e-38)
        pinv = torch.complex(piv.real / den, -piv.imag / den)
        s = col * pinv                       # C p^-1
        w = w - s * row                      # trailing elimination
        w[:, :, j:j + 1] = -s
        w[:, j:j + 1, :] = row * pinv        # R p^-1
        w[:, j, j] = pinv[:, 0, 0]
    return w


def batched_inv(a: torch.Tensor, block: int = 32, pivot: str = "auto",
                pivot_inv=None) -> torch.Tensor:
    """Inverse of a batch of complex matrices, (B, n, n) -> (B, n, n).

    Unpivoted blocked Gauss-Jordan in place (no augmentation): per panel
    one batched pivot inversion plus three batched products. n is padded
    to a multiple of ``block`` with an identity extension (inverted
    exactly, then cropped).

    ``pivot`` selects the (block, block) pivot inverse, as in the
    reference: "auto" the CUDA kernel on a CUDA tensor and its plain
    version on a CPU tensor; "pallas" the CUDA kernel, which a CPU tensor
    cannot take (it raises); "xla" the plain version everywhere.
    ``pivot_inv`` replaces all three (this routine again at a smaller
    ``block`` is the two-level blocking that ``csrc/gj_pivot.cuh`` runs
    inside a thread block)."""
    if pivot_inv is None:
        if pivot == "auto":
            pivot_inv = batched_small_inv_kernel
        elif pivot == "pallas":
            if a.device.type != "cuda":
                raise ValueError(
                    f"pivot='pallas' runs the CUDA kernel, and the batch is "
                    f"on {a.device}; use 'auto' or 'xla' off the card")
            pivot_inv = batched_small_inv_kernel
        elif pivot == "xla":
            pivot_inv = _batched_pivot_inv
        else:
            raise ValueError(f"unknown pivot impl {pivot!r}")
    B, n, _ = a.shape
    npanels = -(-n // block)
    npad = npanels * block
    if npad != n:
        w = torch.zeros((B, npad, npad), dtype=a.dtype, device=a.device)
        w[:, :n, :n] = a
        idx = torch.arange(n, npad, device=a.device)
        w[:, idx, idx] = 1.0
    else:
        w = a.clone()

    for k in range(npanels):
        lo, hi = k * block, (k + 1) * block
        pinv = pivot_inv(w[:, lo:hi, lo:hi].contiguous())
        r = w[:, lo:hi, :]                                   # (B, b, n)
        # column block with the pivot rows zeroed: the rank-b update then
        # leaves rows [lo:hi) untouched (they are overwritten below)
        cz = w[:, :, lo:hi].clone()                          # (B, n, b)
        cz[:, lo:hi, :] = 0
        rs = torch.bmm(pinv, r)                              # P^-1 R
        cs = torch.bmm(cz, pinv)                             # C P^-1
        # trailing update (writes noise into the panel columns; overwritten)
        w = w - torch.bmm(cz, rs)
        w[:, :, lo:hi] = -cs          # panel columns outside the pivot rows
        rs[:, :, lo:hi] = pinv        # pivot rows: P^-1 R, P^-1 in the block
        w[:, lo:hi, :] = rs

    return w[:, :n, :n].contiguous() if npad != n else w
