"""Operators of the port: stencil planes, applies, the block-Thomas factor
and sweeps, their CUDA kernels, and the Helmholtz solves."""


def kernel_launch_counts() -> dict:
    """CUDA kernel launches made through each wrapper since the last reset
    (a factorization is many launches, a solve two, an apply one)."""
    from . import kernel_factor, kernel_stencil, kernel_sweep
    return {"factor": kernel_factor.launches, "sweep": kernel_sweep.launches,
            "stencil": kernel_stencil.launches}


def reset_kernel_launch_counts() -> None:
    from . import kernel_factor, kernel_stencil, kernel_sweep
    kernel_factor.launches = kernel_sweep.launches = kernel_stencil.launches = 0
