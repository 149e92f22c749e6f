"""K3's share of its roofline: the least time of the applies the
configuration asks for over K3's device time."""

from costs import apply_cost, least_seconds


def read(r):
    t, n = r.layer("K3 stencil"), r.counts["applies"]
    if t <= 0 or n == 0:
        return None
    return 100.0 * n * least_seconds(apply_cost(r.ny, r.nx, r.batch)) / t
