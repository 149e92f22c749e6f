"""Operations and bytes of the block-Thomas solver, and the card's peaks.

The arithmetic is that of the port's ``utils/flops.py`` (1 complex
multiply-add = 8 real operations, a complex multiply 6, an add 2; G is the
main memory stream), taken at the grid's own width: there the widths are
padded to the factor kernel's 64-wide panels and the blocked inverse's
panel products are counted beside the inverse, which is that
implementation's work and not the algorithm's. Each input byte is counted
read once and each output byte written once.
"""

from __future__ import annotations

from typing import NamedTuple

# NVIDIA H100 SXM5 data sheet, dense, at its 700 W limit: FP32 outside the
# tensor cores (every kernel of the port is FP32 FMA code) and HBM3.
PEAK_FP32_FLOPS = 66.9e12
PEAK_HBM_BYTES_PER_S = 3.35e12
C64 = 8  # bytes of a complex64


class Cost(NamedTuple):
    flops: float
    bytes: float

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.flops + other.flops, self.bytes + other.bytes)

    def scale(self, k: float) -> "Cost":
        return Cost(k * self.flops, k * self.bytes)


def factor_cost(ny: int, nx: int) -> Cost:
    """One factorization: per grid row the Schur complement S_i = tri(D_i)
    - tri(L_i) G_{i-1} tri(U_{i-1}) (the two tridiagonal products, 3
    complex multiplies and 2 adds an entry each, and the assembly, 4
    operations an entry) and its inverse (Gauss-Jordan, nx^3 complex
    multiply-adds). Bytes: the nine planes read, G written."""
    per_row = 8.0 * nx ** 3 + 2 * (3 * 6 + 2 * 2) * nx * nx + 4.0 * nx * nx
    return Cost(ny * per_row, float(C64 * (9 * ny * nx + ny * nx * nx)))


def solve_cost(ny: int, nx: int, batch: int) -> Cost:
    """One solve of ``batch`` right-hand sides: a forward and a backward
    sweep, each a row step of one (batch, nx) x (nx, nx) complex product
    and one tridiagonal product (3 complex multiplies, 2 adds an entry).
    Bytes: G and the planes read, the right-hand sides read and the
    solutions written."""
    per_row = 8.0 * batch * nx * nx + (3 * 6 + 2 * 2) * batch * nx
    nbytes = C64 * (ny * nx * nx + 9 * ny * nx + 2 * batch * ny * nx)
    return Cost(2 * ny * per_row, float(nbytes))


def apply_cost(ny: int, nx: int, batch: int) -> Cost:
    """One 9-point apply: 9 complex multiplies and 8 adds a point a field;
    the fields read and written, the planes read."""
    n = ny * nx
    return Cost((9 * 6 + 8 * 2) * n * batch,
                float(C64 * (2 * n * batch + 9 * n)))


def least_seconds(cost: Cost) -> float:
    """The least time the card could take: the operations over the FP32
    peak or the bytes over the memory rate, whichever is larger."""
    return max(cost.flops / PEAK_FP32_FLOPS, cost.bytes / PEAK_HBM_BYTES_PER_S)
