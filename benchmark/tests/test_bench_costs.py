"""The copied cost arithmetic against hand counts at 301 and 801."""

import pytest

import costs


@pytest.mark.parametrize("n", [301, 801])
def test_factor_cost_by_hand(n):
    # per row: an n x n complex inverse (n^3 multiply-adds of 8 operations),
    # two tridiagonal products (3 complex multiplies + 2 adds an entry,
    # 22 operations) and the assembly (4)
    c = costs.factor_cost(n, n)
    assert c.flops == n * (8 * n ** 3 + 44 * n * n + 4 * n * n)
    assert c.bytes == 8 * (9 * n * n + n * n * n)


@pytest.mark.parametrize("n,ms", [(301, 1.00116), (801, 49.5947)])
def test_factor_bound_by_hand(n, ms):
    # operations bound: (8 n^4 + 48 n^3) / 66.9 TFLOP/s; the inverse alone,
    # 8 n^4, is PERF.md's 0.9801 ms at 301 and 49.2 ms at 801
    assert costs.least_seconds(costs.factor_cost(n, n)) * 1e3 == pytest.approx(
        (8 * n ** 4 + 48 * n ** 3) / 66.9e9, rel=1e-12)
    assert costs.least_seconds(costs.factor_cost(n, n)) * 1e3 == pytest.approx(
        ms, rel=1e-5)


@pytest.mark.parametrize("n,batch,ms", [(301, 256, 1.68493), (801, 256, 31.5733)])
def test_solve_cost_by_hand(n, batch, ms):
    # two sweeps, a (batch, n) x (n, n) complex product and a tridiagonal
    # product a row step; bound by the operations
    c = costs.solve_cost(n, n, batch)
    assert c.flops == 2 * n * (8 * batch * n * n + 22 * batch * n)
    assert c.bytes == 8 * (n * n * n + 9 * n * n + 2 * batch * n * n)
    assert costs.least_seconds(c) == c.flops / costs.PEAK_FP32_FLOPS
    assert costs.least_seconds(c) * 1e3 == pytest.approx(ms, rel=1e-5)


def test_apply_is_bound_by_bytes():
    c = costs.apply_cost(801, 801, 256)
    assert c.flops == 70 * 801 * 801 * 256
    assert costs.least_seconds(c) == c.bytes / costs.PEAK_HBM_BYTES_PER_S
