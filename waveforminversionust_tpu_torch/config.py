"""Configuration objects of the PyTorch port.

A torch-free mirror of ``waveforminversionust_tpu.config``: the same
dataclasses and enums with the same field names and defaults, so a
configuration written for the JAX package means the same thing here
(``tests/test_torch_config.py`` pins the equality). The JAX package's
``__init__`` imports JAX, so the port cannot import even its config module.

What the port does with each field in this slice:

* ``SolverConfig.method``: all three run. ``BANDED`` through a direct
  factor (``factorization`` below); ``GMRES`` by restarted GMRES on the
  9-point system (``tol``, ``maxiter``), every matvec the CUDA stencil
  kernel on CUDA tensors, with the shifted-Laplacian FFT preconditioner
  (``shift_beta``) or, with ``gmres_two_level``, its two-level form, whose
  coarse factor (``coarse_shift_beta``) is block-Thomas through the CUDA
  factor and sweep kernels whatever ``factorization`` says; ``BORN`` by the
  convergent Born series (``born_*``: GMRES on its system when
  ``born_krylov``, else the plain series), FFTs only. The frozen-factor CG
  (``refactor_every > 1``) takes the banded method only and raises
  ``ValueError`` for the others, as the reference does.
* ``SolverConfig.factorization``: ``"auto"`` and ``"pallas"`` run the
  hand-written CUDA factor and sweep kernels on CUDA tensors (their plain
  PyTorch versions on CPU tensors); ``"thomas"`` runs the plain PyTorch
  block-Thomas factor and sweeps on any device (the reference's XLA-scan
  path). ``"twisted"`` runs the two-sided elimination toward the middle
  row through the CUDA twisted factor and sweep kernels (plain versions on
  CPU tensors); ``"cr"`` runs block cyclic reduction, whose pivot-block
  inverses are the CUDA batched Gauss-Jordan kernel (plain version on CPU
  tensors) and whose dense products are ``torch.bmm``. A factor of any of
  the three types serves forward, adjoint and refined solves and the
  frozen-factor CG. ``"spike"`` raises.
* ``SolverConfig.fused_apply``: ``"off"`` runs the plain PyTorch 9-point
  apply; every other value runs the CUDA stencil kernel on CUDA tensors.
  One kernel serves the reference's whole-field and y-tiled call sites.
* ``SolverConfig.split_complex``: accepted and ignored. The port carries
  complex fields as ``torch.complex64`` everywhere; the kernels read that
  storage as interleaved ``float2``.
* ``fast_forward`` / ``fast_adjoint`` / ``fast_linesearch`` and
  ``factor_precision``: accepted; in this slice every solve and factor runs
  full FP32 (complex64), which is also what the JAX CPU path runs. Their
  reduced-precision Hopper mode is queued in ROADMAP.md.
* ``factor_schulz_steps`` and ``fast_sweeps``: under ``"auto"`` and
  ``"thomas"`` they select the reference's scan hybrids, the warm-started
  Schulz row inverse and the precomputed sweep operators, in the plain
  block-Thomas factorization (``ops/banded.py``; on the card too, so the
  factor kernel does not run). ``"pallas"``, ``"twisted"`` and ``"cr"``
  ignore both, as the reference does.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class MomentumFormula(enum.IntEnum):
    """CG momentum formulas (reference: FrequencyDomainFWI.m:36-41)."""

    GRADIENT_DESCENT = 0
    FLETCHER_REEVES = 1
    POLAK_RIBIERE = 2
    PR_FR_CLAMPED = 3
    HESTENES_STIEFEL = 4


class StepSizeFormula(enum.IntEnum):
    """Linearized line-search step formulas (FrequencyDomainFWI.m:42-45),
    plus the Barzilai-Borwein curvature-scalar step ``BB``, which skips the
    third solve on iterations where its estimate is valid."""

    RESIDUAL = 1
    GRADIENT = 2
    GRADIENT_SD = 3
    BB = 4


class SolverMethod(enum.Enum):
    """Which Helmholtz solver to use."""

    BANDED = "banded"
    GMRES = "gmres"
    BORN = "born"


@dataclasses.dataclass(frozen=True)
class PMLConfig:
    """Perfectly-matched-layer parameters (fwi_script.py:33-34)."""

    a0: float = 10.0
    l_pml: float = 9.0e-3
    sign_convention: int = -1


@dataclasses.dataclass(frozen=True)
class StencilConfig:
    """Dispersion-minimizing 9-point stencil fit parameters.

    ``corner_mode``: "matlab" follows the MATLAB original's corner gathers;
    "jax_port" replicates the reference JAX port's shifted, edge-clamped
    corner gathers (see ``ops.stencil.helmholtz_coefficients``).
    """

    angular_resolution: int = 100
    range_resolution: int = 10
    fix_b: bool = True
    corner_mode: str = "matlab"


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Helmholtz solver configuration (see the module docstring for what
    each field does in the port)."""

    method: SolverMethod = SolverMethod.BANDED
    split_complex: bool = False
    factorization: str = "auto"
    tol: float = 1e-5
    maxiter: int = 1000
    shift_beta: float = 0.5
    gmres_two_level: bool = False
    coarse_shift_beta: float = 0.1
    refine: int = 0  # iterative-refinement passes after a banded solve
    factor_precision: str = "highest"
    factor_schulz_steps: int = 0
    fast_sweeps: bool | None = None
    fast_linesearch: bool = True
    fast_adjoint: bool = True
    fast_forward: bool = True
    # Frozen-factor CG: factor only when it % K == 0 and reuse the WHOLE
    # stale factor (G with its own planes) in between; on stale iterations
    # the forward and adjoint solves take one refinement pass against the
    # CURRENT operator when stale_refine is set.
    refactor_every: int = 1
    stale_refine: bool = True
    fused_apply: str = "auto"
    born_iter_cap: int = 1000
    born_iter_scale: float = 1.0
    born_krylov: bool = True
    born_restart: int = 16
    born_pml: PMLConfig = PMLConfig(a0=20.0, l_pml=12.0e-3)
    pml: PMLConfig = PMLConfig()
    stencil: StencilConfig = StencilConfig()


@dataclasses.dataclass(frozen=True)
class AcquisitionConfig:
    """Ring-array acquisition geometry: 256 elements on a 110 mm ring,
    +/-31 elements excluded around each transmitter (SimulateData.m:15-20).
    ``interpolation``: "nearest" pixel snapping or exact "bilinear" weights."""

    num_elements: int = 256
    radius: float = 110.0e-3
    num_excluded_each_side: int = 31
    tx_downsample: int = 1
    interpolation: str = "nearest"


@dataclasses.dataclass(frozen=True)
class FWIConfig:
    """Outer-loop inversion configuration (fwi_script.py:90-91,
    FrequencyDomainFWI.m:35-46)."""

    c_init: float = 1480.0
    num_iterations: int = 10
    momentum: MomentumFormula = MomentumFormula.HESTENES_STIEFEL
    step_size: StepSizeFormula = StepSizeFormula.RESIDUAL
    eps_stabilizer: float = 0.0
    estimate_source_strength: bool = True
    reject_nonfinite: bool = True
    # Nonmonotone watchdog: a misfit above reject_increase x the baseline
    # reverts the model and restarts the recurrence. None = off.
    reject_increase: Optional[float] = None
    clip_velocity: Optional[Tuple[float, float]] = None
    reg_tikhonov: float = 0.0
    reg_tv: float = 0.0
    reg_tv_eps: float = 1.0
    precondition: Optional[str] = None  # None | "illumination"
    precondition_eps: float = 1e-2


@dataclasses.dataclass(frozen=True)
class ContinuationConfig:
    """Multi-frequency continuation schedule (not run by the port yet)."""

    frequencies: Tuple[float, ...] = ()
    iterations_per_frequency: int = 10
    simultaneous: int = 1
