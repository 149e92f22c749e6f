"""Each per-layer reader on a synthetic trace summary, and the reduction
of trace records to that summary."""

import pytest

import costs
import devtrace
import spec
from conftest import ROOT
from devtrace import Interval
from harness import Readings

LAYERS = {"build_s": "K1 factor", "pivot_gj": "K1 factor",
          "panel_update": "K1 factor", "sweep_cluster": "K2 sweeps",
          "stencil9_kernel": "K3 stencil"}


def readings(kernel_s, counts, window_s=2.0, n=301):
    layer_s = {}
    for k, t in kernel_s.items():
        if k in LAYERS:
            layer_s[LAYERS[k]] = layer_s.get(LAYERS[k], 0.0) + t
    busy = sum(kernel_s.values())
    return Readings(devtrace.Summary(window_s=window_s, busy_s=busy,
                                     kernel_s=kernel_s, layer_s=layer_s),
                    counts, n, n, 256)


# two reconstructions of 10 iterations at 301^2: 20 factorizations, 60 solves
RECON = readings({"build_s": 0.03, "pivot_gj": 0.6, "panel_update": 0.4,
                  "sweep_cluster": 0.6, "elementwise": 0.06, "Memcpy HtoD": 0.04},
                 {"units": 2, "iterations": 20, "factorizations": 20,
                  "solves": 60, "applies": 0})
SYNTH = readings({"pivot_gj": 0.5, "panel_update": 0.3, "sweep_cluster": 0.15,
                  "stencil9_kernel": 0.001, "Memcpy HtoD": 0.12},
                 {"units": 1, "iterations": 0, "factorizations": 1,
                  "solves": 1, "applies": 1}, window_s=1.4, n=801)


def read(name, r):
    return spec.reader(ROOT, name)(r)


def test_factor_readers():
    k1 = 0.03 + 0.6 + 0.4
    assert read("factor_ms.recon", RECON) == pytest.approx(1e3 * k1 / 20)
    assert read("factor_roofline.recon", RECON) == pytest.approx(
        100 * 20 * costs.least_seconds(costs.factor_cost(301, 301)) / k1)
    assert read("factor_ms.synth", SYNTH) == pytest.approx(800.0)
    assert read("factor_roofline.synth", SYNTH) == pytest.approx(
        100 * 0.0495947 / 0.8, rel=1e-5)


def test_sweep_readers():
    assert read("sweep_ms.recon", RECON) == pytest.approx(10.0)
    assert read("sweep_roofline.recon", RECON) == pytest.approx(
        100 * 1.68493e-3 / 10e-3, rel=1e-5)
    assert read("sweep_roofline.synth", SYNTH) == pytest.approx(
        100 * 31.5733e-3 / 0.15, rel=1e-5)


def test_glue_idle_and_mfu_readers():
    assert read("glue_ms.recon", RECON) == pytest.approx(1e3 * 0.10 / 20)
    assert read("glue_ms.synth", SYNTH) == pytest.approx(120.0)
    assert read("idle_share.recon", RECON) == pytest.approx(100 * (1 - 1.73 / 2))
    assert read("idle_share.synth", SYNTH) == pytest.approx(100 * (1 - 1.071 / 1.4))
    flops = (20 * costs.factor_cost(301, 301).flops
             + 60 * costs.solve_cost(301, 301, 256).flops)
    assert read("step_mfu.recon", RECON) == pytest.approx(
        100 * flops / 2.0 / costs.PEAK_FP32_FLOPS)


@pytest.mark.parametrize("name", ["factor_roofline.recon", "factor_ms.synth",
                                  "sweep_roofline.recon", "sweep_ms.recon",
                                  "idle_share.recon", "glue_ms.recon",
                                  "step_mfu.synth"])
def test_a_reader_with_nothing_to_read_returns_none(name):
    empty = readings({}, {"units": 1, "iterations": 10, "factorizations": 10,
                          "solves": 30, "applies": 0})
    assert read(name, empty) is None


def test_summarize_busy_layers_and_idle_labels():
    host = [Interval(0.0, 10.0, devtrace.WINDOW, 1),
            Interval(0.5, 9.5, "bench.unit", 1),
            Interval(1.0, 2.0, "aten::copy_", 1),
            Interval(5.4, 5.6, "cudaLaunchKernel", 1),
            Interval(0.0, 10.0, "other thread", 2)]
    device = [Interval(-1.0, 0.5, "pivot_gj(RowJobs, float2*, int, int, int)"),
              Interval(2.0, 4.0, "void sweep_cluster<16, 80>(float2 const*)"),
              Interval(3.0, 5.0, "_Z12panel_update7RowJobsP6float2iii"),
              Interval(6.0, 7.0, "Memcpy HtoD (Pageable -> Device)")]
    s = devtrace.summarize(device, host, LAYERS)
    assert s.window_s == 10.0
    assert s.busy_s == pytest.approx(0.5 + 3.0 + 1.0)
    assert s.kernel_s == pytest.approx({"pivot_gj": 0.5, "sweep_cluster": 2.0,
                                        "panel_update": 2.0, "Memcpy HtoD": 1.0})
    assert s.layer_s == pytest.approx({"K1 factor": 2.5, "K2 sweeps": 2.0})
    # gaps: 0.5-2 (copy_), 5-6 (launch), 7-10 (bench.unit until 9.5)
    assert s.idle_by_host == pytest.approx({"bench.unit/aten::copy_": 1.5,
                                            "bench.unit/cudaLaunchKernel": 1.0,
                                            "bench.unit/python": 3.0})
    assert devtrace.top(s.kernel_s, 2) == [["sweep_cluster", 2.0],
                                           ["panel_update", 2.0]]


@pytest.mark.parametrize("name,base", [
    ("build_s(float2 const*, RowJobs, float2*, int, int)", "build_s"),
    ("void sweep_cluster<16, 80>(float2 const*, float2*)", "sweep_cluster"),
    ("_Z8pivot_gj7RowJobsP6float2iii", "pivot_gj"),
    ("_ZN2at6native29vectorized_elementwise_kernelILi4E", "vectorized_elementwise_kernel"),
    ("void at::native::(anonymous namespace)::reduce_kernel<512, 1>(int)", "reduce_kernel"),
    ("Memcpy DtoH (Device -> Pageable)", "Memcpy DtoH")])
def test_base_name(name, base):
    assert devtrace.base_name(name) == base
