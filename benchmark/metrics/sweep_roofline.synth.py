"""K2's share of its roofline: the least time of the solves (one a
right-hand-side batch of every transmitter) in the traced window, over
K2's device time."""

from costs import least_seconds, solve_cost


def read(r):
    t, n = r.layer("K2 sweeps"), r.counts["solves"]
    if t <= 0 or n == 0:
        return None
    return 100.0 * n * least_seconds(solve_cost(r.ny, r.nx, r.batch)) / t
