"""Device milliseconds a synthesized dataset outside K1, K2 and K3: the
source cube's construction on the card, the planes, the residual's
bookkeeping and the receivers' gather and copy back."""

KERNEL_LAYERS = ("K1 factor", "K2 sweeps", "K3 stencil")


def read(r):
    n = r.counts["units"]
    if n == 0 or r.summary.busy_s <= 0:
        return None
    other = sum(r.summary.kernel_s.values()) - sum(map(r.layer, KERNEL_LAYERS))
    return 1e3 * other / n
