"""K1's device milliseconds a factorization the configuration asks for."""


def read(r):
    t, n = r.layer("K1 factor"), r.counts["factorizations"]
    if t <= 0 or n == 0:
        return None
    return 1e3 * t / n
