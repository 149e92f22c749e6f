"""PyTorch/CUDA port of ``waveforminversionust_tpu``: frequency-domain
full-waveform inversion for ring-array ultrasound tomography on an NVIDIA
H100, with hand-written CUDA kernels for the block-Thomas and twisted
factorizations, their solve sweeps, the batched pivot inverse of cyclic
reduction and the 9-point operator apply (``csrc/``). The Helmholtz solve
runs by a direct factor, by preconditioned GMRES (every matvec the stencil
kernel) or by the convergent Born series, and is differentiable by
``torch.autograd`` under each. The broadband (time-domain) acquisition
chain synthesizes and extracts comb data for multi-frequency inversion.
The volumetric path (a 3D grid and cylinder or bowl arrays, the 3D
convergent Born solve by cuFFT or dense DFT products and its
differentiable form, 3D nonlinear CG, L-BFGS, attenuation and joint
inversion, Gauss-Newton and calibration, their continuation entry and the
3D broadband chain) and the travel-time starting models in 2D and 3D
(eikonal solves, straight and bent rays) run no kernel of their own.
The entry points, and the command line (``cli.py``, ``wiust-torch``), run
on the card unless the caller passes ``device="cpu"`` (``--device cpu``).

The JAX package beside it is the reference; this package imports ``torch``
and never ``jax``. All math is FP32 (complex64). TF32 is off for matrix
products and convolutions so that no library path rounds below FP32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import (AcquisitionConfig, ContinuationConfig,  # noqa: E402
                     FWIConfig, MomentumFormula, PMLConfig, SolverConfig,
                     SolverMethod, StencilConfig, StepSizeFormula)
from .data.qc import compensate_reciprocity, qc_report  # noqa: E402
from .data.synthesize import RingDataset, synthesize_ring_dataset  # noqa: E402
from .data.timedomain import (TimeDomainDataset,  # noqa: E402
                              direct_arrival_gate, extract_frequency_data,
                              frequency_sweep, simulate_time_domain,
                              synthesize_time_domain_dataset,
                              timedomain_to_ring_datasets)
from .data.timedomain3d import (TimeDomainDataset3D,  # noqa: E402
                                direct_arrival_gate_3d,
                                synthesize_time_domain_dataset_3d,
                                timedomain_to_fwi_data_3d)
from .device import default_device  # noqa: E402
from .fwi.calibrate import (CalibrationResult,  # noqa: E402
                            background_misfit_fn, background_misfit_fn_3d,
                            calibrate_background_speed,
                            calibrate_background_speed_3d)
from .fwi.eikonal import eikonal_solve, trace_rays  # noqa: E402
from .fwi.eikonal3d import (eikonal_receiver_times_3d,  # noqa: E402
                            eikonal_solve_3d, trace_rays_3d)
from .fwi.fwi3d import (FWIData3D, build_fwi_data_3d,  # noqa: E402
                        nonlinear_cg_3d, scattered_data_3d)
from .fwi.lbfgs import (run_lbfgs, run_lbfgs_3d,  # noqa: E402
                        run_lbfgs_attenuation_3d)
from .fwi.multifreq import (MultiFreqData,  # noqa: E402
                            nonlinear_cg_multifreq, stack_frequencies)
from .fwi.newton import (GNResult, make_frechet_operators,  # noqa: E402
                         run_gauss_newton, run_gauss_newton_3d)
from .fwi.objective import FWIData, build_fwi_data  # noqa: E402
from .fwi.optimizers import CGResult, nonlinear_cg  # noqa: E402
from .fwi.runner import (default_inversion_grid, invert_dataset,  # noqa: E402
                         make_logging_callback, reconstruction_rmse)
from .fwi.runner3d import (InversionResult3D, invert_dataset_3d,  # noqa: E402
                           reconstruction_rmse_3d)
from .fwi.traveltime import (invert_travel_times,  # noqa: E402
                             invert_travel_times_bent, pick_arrival_times,
                             straight_ray_times, traveltime_init)
from .fwi.traveltime3d import (invert_travel_times_3d,  # noqa: E402
                               invert_travel_times_bent_3d,
                               straight_ray_times_3d, traveltime_init_3d)
from .models.acquisition import (RingAcquisition,  # noqa: E402
                                 build_ring_acquisition)
from .models.acquisition3d import (Acquisition3D,  # noqa: E402
                                   build_acquisition3d, cylinder_positions,
                                   hemisphere_positions)
from .models.grid import Grid2D  # noqa: E402
from .models.grid3d import Grid3D  # noqa: E402
from .ops import kernel_launch_counts, reset_kernel_launch_counts  # noqa: E402
from .ops.born3d import (born_gmres_solve_3d,  # noqa: E402
                         born_series_solve_3d, born_solve_3d_diff)
from .ops.krylov import KrylovResult, gmres  # noqa: E402
from .ops.solve import (HelmholtzOperator, build_operator,  # noqa: E402
                        helmholtz_operator_solve, make_helmholtz_operator,
                        solve_helmholtz)

__version__ = "0.1.0"
