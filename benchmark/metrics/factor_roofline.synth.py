"""K1's share of its roofline: the least time of the factorizations the
configuration asks for in the traced window, over K1's device time."""

from costs import factor_cost, least_seconds


def read(r):
    t, n = r.layer("K1 factor"), r.counts["factorizations"]
    if t <= 0 or n == 0:
        return None
    return 100.0 * n * least_seconds(factor_cost(r.ny, r.nx)) / t
