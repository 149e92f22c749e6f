"""The whole traced window's share of the card's FP32 peak: the
operations of the factorizations, solves and applies the configuration
asks for, over the window's wall time."""

from costs import PEAK_FP32_FLOPS, apply_cost, factor_cost, solve_cost


def read(r):
    c = r.counts
    if (r.summary.window_s <= 0 or r.summary.busy_s <= 0
            or c["factorizations"] + c["solves"] == 0):
        return None
    flops = (c["factorizations"] * factor_cost(r.ny, r.nx).flops
             + c["solves"] * solve_cost(r.ny, r.nx, r.batch).flops
             + c["applies"] * apply_cost(r.ny, r.nx, r.batch).flops)
    return 100.0 * flops / (r.summary.window_s * PEAK_FP32_FLOPS)
