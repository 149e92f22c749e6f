"""FLOP / memory-byte cost models and roofline accounting for the solvers
(port of ``waveforminversionust_tpu.utils.flops``).

Each stage is priced from first principles with the reference's own counts
(the same arguments give the same numbers, tests/test_torch_utils.py), so
that a measured time converts to achieved TFLOP/s, a fraction of the
card's peak and achieved memory GB/s with a named binding constraint.

Conventions:

* 1 complex multiply-add = 8 real flops (4 mul + 4 add); a lone complex
  multiply = 6. A real matrix product (m, k) @ (k, n) = 2*m*k*n flops; a
  complex one built from 4 real products = 8*m*k*n plus 4*m*n adds.
* ``flops_mxu`` counts the flops that are matrix products and
  ``flops_vpu`` the elementwise ones; the names are the reference's (its
  matrix unit and vector unit). On the H100 a matrix product can run on
  the tensor cores; every kernel of this package runs FP32 FMA code, so
  ``roofline`` prices ``flops_mxu`` against the peak of the precision the
  products are asked for ("highest": FP32; "high" / "default": TF32, the
  tensor-core mode SolverConfig's reduced-precision flags are to get).
* Counts are algorithmic at the shapes of the reference's kernels: the
  factor and sweep widths are padded to the panel width ``bk`` as there.
* Memory bytes count the main streamed arrays (the factor G is the giant:
  nx^2 complex64 values a grid row); small per-row vectors are ignored.

Card model: :class:`ChipSpec` holds a card's datasheet peaks (dense, no
sparsity). :data:`H100_SXM` is the NVIDIA H100 80GB HBM3 (SXM5) at its 700 W
limit, :data:`H100_PCIE` the H100 PCIe at 350 W; :func:`chip_spec` picks one
by the device's name and refuses a card it does not know.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple


@dataclass(frozen=True)
class ChipSpec:
    """One card's datasheet peaks: dense tensor-core BF16 and TF32, FP32
    outside the tensor cores, memory rate and size, at ``power_limit_w``."""

    name: str
    peak_bf16_flops: float
    hbm_bytes_per_s: float
    hbm_bytes: float
    peak_tf32_flops: float = 0.0
    peak_fp32_flops: float = 0.0
    power_limit_w: float = 0.0


# NVIDIA H100 datasheet, dense rates (the sparsity figures halved).
H100_SXM = ChipSpec(name="NVIDIA H100 80GB HBM3 (SXM5), 700 W",
                    peak_bf16_flops=989.4e12, hbm_bytes_per_s=3.35e12,
                    hbm_bytes=80e9, peak_tf32_flops=494.7e12,
                    peak_fp32_flops=66.9e12, power_limit_w=700.0)
H100_PCIE = ChipSpec(name="NVIDIA H100 PCIe, 350 W",
                     peak_bf16_flops=756.5e12, hbm_bytes_per_s=2.0e12,
                     hbm_bytes=80e9, peak_tf32_flops=378.0e12,
                     peak_fp32_flops=51.2e12, power_limit_w=350.0)
# torch.cuda.get_device_properties(...).name -> spec
_BY_DEVICE_NAME = {"NVIDIA H100 80GB HBM3": H100_SXM,
                   "NVIDIA H100 PCIe": H100_PCIE}

# The peak each matrix-product precision is held against (ChipSpec field).
PRECISION_PEAK = {"highest": "peak_fp32_flops", "high": "peak_tf32_flops",
                  "default": "peak_tf32_flops"}


def chip_spec(device=0) -> ChipSpec:
    """The :class:`ChipSpec` of CUDA ``device`` by its name; raises
    ``ValueError`` for a card this module has no datasheet for."""
    import torch
    name = torch.cuda.get_device_properties(device).name
    try:
        return _BY_DEVICE_NAME[name]
    except KeyError:
        raise ValueError(f"no ChipSpec for {name!r}: known cards are "
                         f"{sorted(_BY_DEVICE_NAME)}") from None


class StageCost(NamedTuple):
    """Cost of one pipeline stage.

    Attributes:
        flops_mxu: algorithmic flops executed as matrix products.
        flops_vpu: algorithmic flops executed as elementwise work.
        bytes_hbm: memory bytes streamed (reads + writes of the big arrays).
    """

    flops_mxu: float
    flops_vpu: float
    bytes_hbm: float

    @property
    def flops(self) -> float:
        return self.flops_mxu + self.flops_vpu

    def __add__(self, other: "StageCost") -> "StageCost":
        return StageCost(self.flops_mxu + other.flops_mxu,
                         self.flops_vpu + other.flops_vpu,
                         self.bytes_hbm + other.bytes_hbm)

    def scale(self, k: float) -> "StageCost":
        return StageCost(k * self.flops_mxu, k * self.flops_vpu,
                         k * self.bytes_hbm)


def _pad_up(n: int, mult: int) -> int:
    return -(-n // mult) * mult


# ---------------------------------------------------------------------------
# 2D banded direct method (ops.banded, csrc/factor.cu, csrc/sweep.cu)
# ---------------------------------------------------------------------------

def factor_cost(ny: int, nx: int, bk: int = 64) -> StageCost:
    """Block-Thomas factorization.

    Per grid row: the tridiagonal products GU and LGU (elementwise on
    (nxp, nxp)), then an unpivoted blocked Gauss-Jordan inverse: nxp/bk
    panels, each a pivot-block inverse plus three complex panel products:
    P^-1 R (bk, bk)@(bk, nxp), C P^-1 (nxp, bk)@(bk, bk), and the rank-bk
    update C @ (P^-1 R) (nxp, bk)@(bk, nxp), which dominates at
    8*nxp^2*bk a panel = 8*nxp^3 a row.
    """
    nxp = _pad_up(nx, bk)
    n_panels = nxp // bk
    # GU + LGU: each 3 complex elementwise muls + 2 complex adds on (nxp^2)
    vpu = 2 * (3 * 6 + 2 * 2) * nxp * nxp
    # pivot Gauss-Jordan: bk rank-1 steps on the (bk, 2bk) block, ~2
    # complex updates an element a step.
    vpu += n_panels * (12 * bk ** 3)
    # rank-bk update subtract + S assembly (2 planes each)
    vpu += n_panels * 4 * nxp * nxp + 4 * nxp * nxp
    # panel products: u = C @ rs dominates; rs and cs are the thin ones.
    mxu = n_panels * (8 * nxp * nxp * bk        # C @ (P^-1 R)
                      + 8 * bk * bk * nxp * 2)  # P^-1 R and C P^-1
    # memory: G written once (2 f32 planes a row); the planes are small.
    bytes_hbm = 2 * 4 * nxp * nxp
    return StageCost(mxu * ny, vpu * ny, float(bytes_hbm) * ny)


def solve_cost(ny: int, nx: int, batch: int, bk: int = 64) -> StageCost:
    """One banded direct solve = forward + backward sweep: a grid row of a
    sweep is one complex (batch, nxp) @ (nxp, nxp) product plus a
    tridiagonal matvec. Each sweep reads the whole factor G once, the
    dominant memory stream (arithmetic intensity ~batch flops a byte, so
    small batches are bandwidth-bound and large ones compute-bound).
    """
    nxp = _pad_up(nx, bk)
    per_row_sweep_mxu = 8 * batch * nxp * nxp
    per_row_sweep_vpu = (3 * 6 + 2 * 2) * batch * nxp
    bytes_per_sweep = 2 * 4 * nxp * nxp          # G read (2 f32 planes)
    bytes_fields = 2 * 2 * 4 * batch * nxp       # rhs read + x write
    return StageCost(2 * ny * per_row_sweep_mxu,
                     2 * ny * per_row_sweep_vpu,
                     float(2 * ny * bytes_per_sweep
                           + 2 * ny * bytes_fields))


def h_apply_cost(ny: int, nx: int, batch: int,
                 fused: bool = False, materialized: bool = False) -> StageCost:
    """One 9-point operator application (ops.apply, csrc/stencil.cu): 9
    complex muls + 8 complex adds a grid point a right-hand side, all
    elementwise.

    The apply streams the field in and out once beside the coefficient
    planes, whether it is one kernel or a fused library pass, so
    ``fused`` changes nothing: it is accepted and ignored, as in the
    reference (its ``utils/flops.py:154``). ``materialized=True`` prices
    the unfused bound of nine shifted copies written and read back (for
    comparison only).
    """
    n = ny * nx * batch
    vpu = (9 * 6 + 8 * 2) * n
    del fused  # the same bytes either way, as in the reference
    if materialized:
        # Unfused bound: 9 shifted copies written + read back, 2 planes.
        bytes_hbm = 9 * 2 * 2 * 4 * n + (2 + 2) * 4 * n
    else:
        bytes_hbm = (2 + 2) * 4 * n + 9 * 2 * 4 * ny * nx
    return StageCost(0.0, float(vpu), float(bytes_hbm))


def coefficient_cost(ny: int, nx: int) -> StageCost:
    """PML + stencil coefficient planes (ops.stencil): ~tens of
    elementwise ops a grid point building 9 complex planes."""
    n = ny * nx
    return StageCost(0.0, 80.0 * n, float(9 * 2 * 4 * n * 2))


def fwi_iteration_cost(ny: int, nx: int, batch: int, bk: int = 64,
                       refactor_every: int = 1,
                       refine: int = 0) -> StageCost:
    """One nonlinear-CG FWI iteration (fwi.optimizers): coefficient build
    + (amortized) factorization + 3 direct solves (forward, adjoint, line
    search) + gradient/update elementwise.

    ``refactor_every=K`` amortizes the factor over K iterations and adds
    one refinement pass (operator apply + extra solve) to the forward and
    adjoint solves of the K-1 stale iterations
    (SolverConfig.refactor_every). ``refine`` adds unconditional
    refinement passes to every solve (SolverConfig.refine).
    """
    k = max(1, int(refactor_every))
    cost = coefficient_cost(ny, nx)
    cost = cost + factor_cost(ny, nx, bk).scale(1.0 / k)
    one_solve = solve_cost(ny, nx, batch, bk)
    one_refine = h_apply_cost(ny, nx, batch) + one_solve
    cost = cost + one_solve.scale(3.0)
    if k > 1:
        cost = cost + one_refine.scale(2.0 * (k - 1) / k)
    if refine:
        cost = cost + one_refine.scale(3.0 * refine)
    # gradient, momentum, line-search scalars: ~30 elementwise passes
    cost = cost + StageCost(0.0, 30.0 * ny * nx * batch / max(batch, 1)
                            + 20.0 * ny * nx, 16.0 * 4 * ny * nx)
    return cost


# ---------------------------------------------------------------------------
# 3D spectral method (ops.born3d)
# ---------------------------------------------------------------------------

def transform3d_cost(nz: int, ny: int, nx: int, batch: int,
                     spectral: str = "dft") -> StageCost:
    """One 3D spectral transform over a (batch, nz, ny, nx) complex field.

    ``dft``: an (n, n) complex matrix product an axis over the whole
    volume (ops.born3d's dense DFT products) = 8*n*N*batch flops an axis.
    ``fft``: 5*N*log2(N) flops a volume (the classic radix-2 count).
    """
    n_vox = nz * ny * nx
    if spectral == "dft":
        mxu = 8.0 * (nz + ny + nx) * n_vox * batch
        return StageCost(mxu, 4.0 * 2 * n_vox * batch,
                         float(2 * 2 * 4 * n_vox * batch * 3))
    flops = 5.0 * n_vox * math.log2(max(n_vox, 2)) * batch
    return StageCost(0.0, flops, float(2 * 2 * 4 * n_vox * batch * 3))


def cbs_matvec_cost(nz: int, ny: int, nx: int, batch: int,
                    spectral: str = "dft") -> StageCost:
    """One CBS/GMRES operator application: forward + inverse 3D transform
    plus the elementwise Green's-function multiply and scattering-potential
    update (~30 real ops a voxel a right-hand side)."""
    t = transform3d_cost(nz, ny, nx, batch, spectral)
    n = nz * ny * nx * batch
    return t.scale(2.0) + StageCost(0.0, 30.0 * n, float(2 * 2 * 4 * n))


def gmres_cbs_solve_cost(nz: int, ny: int, nx: int, batch: int,
                         n_matvecs: int, restart: int = 8,
                         spectral: str = "dft") -> StageCost:
    """A GMRES-accelerated CBS solve: ``n_matvecs`` operator applications
    plus modified-Gram-Schmidt orthogonalization (~restart/2 basis dots a
    matvec, each 8 flops a voxel a right-hand side, reading the stored
    basis)."""
    mv = cbs_matvec_cost(nz, ny, nx, batch, spectral)
    n = nz * ny * nx * batch
    ortho_per_mv = StageCost(0.0, 8.0 * n * (restart / 2 + 1),
                             float(2 * 4 * n * (restart / 2 + 1)))
    return (mv + ortho_per_mv).scale(float(n_matvecs))


# ---------------------------------------------------------------------------
# Roofline accounting
# ---------------------------------------------------------------------------

def roofline(cost: StageCost, time_s: float, precision: str = "highest",
             chip: ChipSpec = H100_SXM) -> dict:
    """Convert a (cost, measured time) pair into utilization numbers.

    Returns a dict with:
        tflops: achieved algorithmic TFLOP/s (cost.flops / time).
        mfu: fraction of the card's dense BF16 tensor-core peak (the
            standard MFU; an FP32 kernel's ceiling is far below 1).
        mfu_precision_adjusted: the matrix-product flops a second over
            the peak at their precision (``PRECISION_PEAK``: "highest"
            FP32, "high" and "default" TF32): how close the products come
            to the best possible at that precision.
        gbs: achieved memory GB/s; hbm_frac: fraction of the memory peak.
        bound: the binding constraint: "mxu" (the products) or "hbm" (the
            memory) when that utilization exceeds 50%, "balanced
            (mxu+hbm)" when both are at 40% or more, else
            "latency/serial-chain" (neither is near its peak: launch and
            step latency or the sequential row recurrence dominate).
    """
    peak_adj = getattr(chip, PRECISION_PEAK[precision])
    tflops = cost.flops / time_s / 1e12
    mfu = cost.flops / time_s / chip.peak_bf16_flops
    mfu_adj = (cost.flops_mxu / time_s) / peak_adj
    gbs = cost.bytes_hbm / time_s / 1e9
    hbm_frac = cost.bytes_hbm / time_s / chip.hbm_bytes_per_s
    if mfu_adj >= 0.4 and hbm_frac >= 0.4:
        bound = "balanced (mxu+hbm)"
    elif mfu_adj >= 0.5 and mfu_adj >= hbm_frac:
        bound = "mxu"
    elif hbm_frac >= 0.5:
        bound = "hbm"
    else:
        bound = "latency/serial-chain"
    return {
        "flops": cost.flops,
        "tflops": tflops,
        "mfu": mfu,
        "mfu_precision_adjusted": mfu_adj,
        "gbs": gbs,
        "hbm_frac": hbm_frac,
        "bound": bound,
        "chip": chip.name,
        "precision": precision,
    }
