"""Device milliseconds an iteration outside K1, K2 and K3: the CG step's
planes, gathers, source estimation, gradient and update, and copies."""

KERNEL_LAYERS = ("K1 factor", "K2 sweeps", "K3 stencil")


def read(r):
    n = r.counts["iterations"]
    if n == 0 or r.summary.busy_s <= 0:
        return None
    other = sum(r.summary.kernel_s.values()) - sum(map(r.layer, KERNEL_LAYERS))
    return 1e3 * other / n
