"""Is cyclic reduction's FP32 inexactness at 301^2 (ROADMAP.md C3) the
port's or the algorithm's? The same planes and right-hand sides through the
JAX package's ``cr_factor_cpx`` / ``cr_solve_cpx`` and the port's plain
``cr_factor`` / ``cr_solve`` (the CPU path of the K5 kernel), the true
relative residual of each in complex128, forward and adjoint, with
block-Thomas (the port's plain factor) beside them:

    python tests/torch_cr_residuals.py            # 151^2 and 301^2
    python tests/torch_cr_residuals.py --sizes 61

The planes are the breast phantom's at 350 kHz on an n^2 grid of 0.8 mm
(``chip_smoke.py``'s at n = 301), built once by the port; 16 seeded complex
Gaussian right-hand sides. CPU only, a few GB at 301^2.
"""

import argparse
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from waveforminversionust_tpu.ops import cpx  # noqa: E402
from waveforminversionust_tpu.ops import cyclic as jcyclic  # noqa: E402
from waveforminversionust_tpu_torch.models.grid import Grid2D  # noqa: E402
from waveforminversionust_tpu_torch.models.phantom import \
    breast_phantom  # noqa: E402
from waveforminversionust_tpu_torch.ops import apply, banded, cyclic  # noqa: E402
from waveforminversionust_tpu_torch.ops.stencil import \
    helmholtz_coefficients  # noqa: E402


def residual(coeffs128, x, b, adjoint):
    op = apply.h_apply_adjoint if adjoint else apply.h_apply
    x = torch.as_tensor(np.asarray(x)).to(torch.complex128)
    r = op(coeffs128, x) - b
    return float(torch.linalg.norm(r) / torch.linalg.norm(b))


def run(n: int, n_rhs: int = 16):
    grid = Grid2D.centered(0.8e-3 * (n - 1), 0.8e-3)
    coeffs = helmholtz_coefficients(torch.as_tensor(breast_phantom(grid)),
                                    grid, 350e3)
    rng = np.random.default_rng(0)
    b = (rng.standard_normal((n_rhs,) + grid.shape)
         + 1j * rng.standard_normal((n_rhs,) + grid.shape)).astype(np.complex64)
    c128 = coeffs.to(torch.complex128)
    b128 = torch.as_tensor(b).to(torch.complex128)

    t0 = time.perf_counter()
    jfac = jax.jit(jcyclic.cr_factor_cpx)(cpx.of(jnp.asarray(coeffs.numpy())))
    jsolve = jax.jit(jcyclic.cr_solve_cpx, static_argnums=2)
    jb = cpx.of(jnp.asarray(b))
    jx = {adj: jsolve(jfac, jb, adj) for adj in (False, True)}
    jax_s = time.perf_counter() - t0
    del jfac

    t0 = time.perf_counter()
    pfac = cyclic.cr_factor(coeffs)
    px = {adj: cyclic.cr_solve(pfac, torch.as_tensor(b), adj)
          for adj in (False, True)}
    port_s = time.perf_counter() - t0
    del pfac

    tfac = banded.banded_factor(coeffs)
    tx = {adj: banded.banded_solve(tfac, torch.as_tensor(b), adj)
          for adj in (False, True)}
    del tfac

    for adj in (False, True):
        jr = residual(c128, np.asarray(jx[adj].re) + 1j * np.asarray(jx[adj].im),
                      b128, adj)
        pr = residual(c128, px[adj], b128, adj)
        tr = residual(c128, tx[adj], b128, adj)
        print(f"n={n} adjoint={adj}: true relative residual, {n_rhs} RHS: "
              f"JAX cr_solve_cpx {jr:.3e}, port cr_solve {pr:.3e}, port "
              f"block-Thomas {tr:.3e}; port/JAX {pr / jr:.2f}", flush=True)
    print(f"n={n}: JAX factor+solves {jax_s:.1f} s (compile included), port "
          f"{port_s:.1f} s (CPU)", flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", default="151,301")
    for size in ap.parse_args().sizes.split(","):
        run(int(size))
