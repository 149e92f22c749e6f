"""K2's device milliseconds a solve (every transmitter's right-hand
side)."""


def read(r):
    t, n = r.layer("K2 sweeps"), r.counts["solves"]
    if t <= 0 or n == 0:
        return None
    return 1e3 * t / n
