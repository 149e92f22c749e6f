"""Resolution and uncertainty analysis (port of
``waveforminversionust_tpu.fwi.resolution``): point-spread functions of
the damped Gauss-Newton inverse and a Hutchinson estimate of diag(J^H J),
a few solves each through the Frechet pair of :mod:`.newton`.

Both draw Rademacher probes exactly as the reference's
``jax.random.rademacher`` does (threefry2x32 in JAX's partitionable
counter mode, reproduced bit for bit in numpy below), so the port gives the
reference's estimates for the same seed. The 3D CG's source-encoding
codes come from the same functions, with ``fold_in`` (:mod:`.fwi3d`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SolverConfig
from ..models.grid import Grid2D
from ..ops.solve import helmholtz_operator_solve, make_helmholtz_operator
from .newton import (_data_normalization, _pcg, make_frechet_operators)
from .objective import (FWIData, estimate_source_strengths, illumination_map,
                        sample_receivers)

# -- JAX's threefry PRNG, numpy only ------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash of counter pairs (x1, x2) under key (k1, k2),
    20 rounds (Salmon et al. 2011; jax/_src/prng.py)."""
    u32 = np.uint32
    ks = [u32(k1), u32(k2), u32(k1) ^ u32(k2) ^ u32(0x1BD11BDA)]
    x = [np.asarray(x1, u32) + ks[0], np.asarray(x2, u32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = (x[1] << u32(r)) | (x[1] >> u32(32 - r))
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + u32(i + 1)
    return x[0], x[1]


def _prng_key(seed: int):
    """jax.random.PRNGKey(seed) for 0 <= seed < 2**32."""
    return np.uint32(0), np.uint32(seed)


def _split(key, num: int):
    """jax.random.split(key, num)."""
    b1, b2 = _threefry2x32(*key, np.zeros(num, np.uint32),
                           np.arange(num, dtype=np.uint32))
    return list(zip(b1, b2))


def _fold_in(key, data: int):
    """jax.random.fold_in(key, data): the hash of the counter pair (0,
    data) under ``key``, for 0 <= data < 2**32."""
    b1, b2 = _threefry2x32(*key, np.zeros(1, np.uint32),
                           np.array([data], np.uint32))
    return b1[0], b2[0]


def _rademacher(key, shape) -> np.ndarray:
    """jax.random.rademacher(key, shape, float32): +1 where the uniform
    float32 drawn from the 32 random bits is below 0.5 (its top bit is 0),
    -1 elsewhere."""
    n = int(np.prod(shape))
    b1, b2 = _threefry2x32(*key, np.zeros(n, np.uint32),
                           np.arange(n, dtype=np.uint32))
    bits = b1 ^ b2
    return np.where(bits >> np.uint32(31), -1.0, 1.0).astype(
        np.float32).reshape(shape)


# -- the probes ---------------------------------------------------------------

def _prepare(data: FWIData, grid: Grid2D, solver: SolverConfig, vel,
             estimate_sources: bool = True, exact: bool = True):
    """Operator, scaled wavefield and Frechet pair at a model point, with
    run_gauss_newton's O(1) data normalization ``s_d`` applied to src and
    rec_obs (PSFs do not depend on it; diag(J^H J) scales by s_d^2).
    Returns (j_apply, jt_apply, virt, s_d)."""
    s_d = _data_normalization(data.rec_obs)
    data = data._replace(src=data.src * s_d, rec_obs=data.rec_obs * s_d)
    vel = torch.as_tensor(vel, dtype=torch.float32).to(data.src.device)
    op = make_helmholtz_operator(vel, data.f, grid, solver,
                                 attenuation=data.attenuation)
    wv = helmholtz_operator_solve(op, data.src, grid, solver)
    if estimate_sources:
        rec = sample_receivers(wv, data.rx_y, data.rx_x, data.rx_w)
        wv = wv * estimate_source_strengths(rec, data.rec_obs)[:, None, None]
    j_apply, jt_apply, virt = make_frechet_operators(op, data, grid, solver,
                                                     1.0 / vel, wv,
                                                     exact=exact)
    return j_apply, jt_apply, virt, s_d


def psf_probe(vel, data: FWIData, grid: Grid2D,
              solver: SolverConfig = SolverConfig(),
              probes=None, cg_iters: int = 12, lm_damping: float = 0.1,
              precondition_eps: float = 1e-2,
              estimate_sources: bool = True):
    """Point-spread functions of the damped Gauss-Newton inverse: each
    (np, ny, nx) model-space probe pushed through J^H J and pulled back by
    ``cg_iters`` of the inner CG of :func:`.newton.run_gauss_newton`, with
    the pseudo-Hessian diagonal calibrated to the true curvature by one
    Rademacher probe. A perfectly resolved pixel returns its probe."""
    if probes is None:
        raise ValueError("psf_probe needs explicit model-space probes "
                         "(np, ny, nx) — e.g. one-hot pixels or Gaussian "
                         "bumps at the locations to appraise")
    j_apply, jt_apply, virt, _ = _prepare(data, grid, solver, vel,
                                          estimate_sources)
    device = virt.device
    illum = illumination_map(virt)
    z0 = torch.as_tensor(_rademacher(_prng_key(0), grid.shape), device=device)
    scale = (torch.clamp(torch.sum(z0 * jt_apply(j_apply(z0))), min=0.0)
             / torch.clamp(torch.sum(illum), min=1e-38))
    illum = illum * scale
    diag = illum + precondition_eps * torch.max(illum)

    def hvp(dm):
        return jt_apply(j_apply(dm)) + lm_damping * diag * dm

    probes = torch.as_tensor(probes, dtype=torch.float32).to(device)
    return torch.stack([_pcg(hvp, jt_apply(j_apply(p)), diag, cg_iters,
                             1e-6)[0] for p in probes])


def hessian_diag_probe(vel, data: FWIData, grid: Grid2D,
                       solver: SolverConfig = SolverConfig(),
                       num_probes: int = 8, seed: int = 0,
                       estimate_sources: bool = True):
    """Hutchinson estimate of diag(J^H J), E[z * (J^H J z)] over
    ``num_probes`` Rademacher z (two solves each), in the problem's own
    units: (ny, nx) float32, larger = better constrained by the data."""
    j_apply, jt_apply, _, s_d = _prepare(data, grid, solver, vel,
                                         estimate_sources)
    device = s_d.device
    total = torch.zeros(grid.shape, dtype=torch.float32, device=device)
    for key in _split(_prng_key(seed), num_probes):
        z = torch.as_tensor(_rademacher(key, grid.shape), device=device)
        total = total + z * jt_apply(j_apply(z))
    return total / num_probes / (s_d * s_d)
