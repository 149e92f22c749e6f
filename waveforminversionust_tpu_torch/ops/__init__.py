"""Operators of the port: stencil planes, applies, the block-Thomas,
twisted and cyclic-reduction direct engines, their CUDA kernels, GMRES with
its shifted-Laplacian preconditioners, the convergent Born series, and the
Helmholtz solves."""


def kernel_launch_counts() -> dict:
    """CUDA kernel launches made through each wrapper since the last reset,
    as the C entry points report them (a factorization is many launches, a
    solve two, an apply or a batched pivot inverse one)."""
    from . import (kernel_factor, kernel_inv, kernel_stencil, kernel_sweep,
                   kernel_twisted)
    return {"factor": kernel_factor.launches, "sweep": kernel_sweep.launches,
            "stencil": kernel_stencil.launches,
            "twisted_factor": kernel_twisted.factor_launches,
            "twisted_sweep": kernel_twisted.sweep_launches,
            "batched_inv": kernel_inv.launches}


def reset_kernel_launch_counts() -> None:
    from . import (kernel_factor, kernel_inv, kernel_stencil, kernel_sweep,
                   kernel_twisted)
    kernel_factor.launches = kernel_sweep.launches = kernel_stencil.launches = 0
    kernel_twisted.factor_launches = kernel_twisted.sweep_launches = 0
    kernel_inv.launches = 0
