"""The port's utilities held against the JAX package on the CPU: the cost
models and roofline of ``utils/flops.py`` (the same counts to the last
bit), the H100 card specs, the reference's ``fused`` quirk; ``utils/host``
over nested results; ``utils/profiling``'s trace, spans and benchmark.
"""

import json
from typing import NamedTuple

import numpy as np
import pytest
import torch

from waveforminversionust_tpu.utils import flops as jflops
from waveforminversionust_tpu_torch.utils import flops, host, profiling


SHAPES = [(301, 301, 256), (151, 151, 16), (64, 256, 1), (801, 801, 64)]


def _same(port, ref):
    assert tuple(port) == tuple(ref)


@pytest.mark.parametrize("ny,nx,batch", SHAPES)
def test_cost_models_equal_the_reference(ny, nx, batch):
    """Every 2D cost function returns the JAX package's StageCost exactly,
    over the panel widths, the frozen-factor amortization and refinement,
    and the apply's traffic models."""
    for bk in (32, 64):
        _same(flops.factor_cost(ny, nx, bk), jflops.factor_cost(ny, nx, bk))
        _same(flops.solve_cost(ny, nx, batch, bk),
              jflops.solve_cost(ny, nx, batch, bk))
    for kw in ({}, {"materialized": True}, {"fused": True}):
        _same(flops.h_apply_cost(ny, nx, batch, **kw),
              jflops.h_apply_cost(ny, nx, batch, **kw))
    _same(flops.coefficient_cost(ny, nx), jflops.coefficient_cost(ny, nx))
    for refactor_every in (1, 2, 3):
        for refine in (0, 1, 2):
            _same(flops.fwi_iteration_cost(ny, nx, batch,
                                           refactor_every=refactor_every,
                                           refine=refine),
                  jflops.fwi_iteration_cost(ny, nx, batch,
                                            refactor_every=refactor_every,
                                            refine=refine))


@pytest.mark.parametrize("spectral", ["dft", "fft"])
def test_3d_cost_models_equal_the_reference(spectral):
    for nz, ny, nx, batch in ((64, 64, 64, 16), (65, 65, 65, 48),
                              (15, 17, 19, 3)):
        _same(flops.transform3d_cost(nz, ny, nx, batch, spectral),
              jflops.transform3d_cost(nz, ny, nx, batch, spectral))
        _same(flops.cbs_matvec_cost(nz, ny, nx, batch, spectral),
              jflops.cbs_matvec_cost(nz, ny, nx, batch, spectral))
        for restart in (8, 16):
            _same(flops.gmres_cbs_solve_cost(nz, ny, nx, batch, 150,
                                             restart, spectral),
                  jflops.gmres_cbs_solve_cost(nz, ny, nx, batch, 150,
                                              restart, spectral))


def test_stage_cost_arithmetic():
    a, b = flops.StageCost(1.0, 2.0, 3.0), flops.StageCost(4.0, 5.0, 6.0)
    assert (a + b) == flops.StageCost(5.0, 7.0, 9.0)
    assert a.scale(2.0) == flops.StageCost(2.0, 4.0, 6.0)
    assert a.flops == 3.0


@pytest.mark.parametrize("precision", ["highest", "high"])
@pytest.mark.parametrize("time_s", [0.07, 3e-3, 1e-5])
def test_roofline_equals_the_reference(precision, time_s):
    """roofline's dict equals the JAX package's when the port's ChipSpec is
    built here from the fields of the reference's V5E (its precision peaks
    the BF16 peak over the reference's pass counts): the same keys, numbers
    and bound labels. The port's own source names no TPU number."""
    v5e = jflops.V5E
    spec = flops.ChipSpec(
        name=v5e.name, peak_bf16_flops=v5e.peak_bf16_flops,
        hbm_bytes_per_s=v5e.hbm_bytes_per_s, hbm_bytes=v5e.hbm_bytes,
        peak_fp32_flops=v5e.peak_bf16_flops / jflops.PRECISION_PASSES["highest"],
        peak_tf32_flops=v5e.peak_bf16_flops / jflops.PRECISION_PASSES["high"])
    for cost_args in ((301, 301, 256), (801, 801, 64), (31, 31, 1)):
        port = flops.roofline(flops.fwi_iteration_cost(*cost_args), time_s,
                              precision, spec)
        ref = jflops.roofline(jflops.fwi_iteration_cost(*cost_args), time_s,
                              precision, v5e)
        assert port == ref


def test_roofline_bounds_and_h100_peaks():
    """Each of the four bound labels, on the H100 SXM spec; "default" is
    priced at TF32 like "high"; mfu is against the dense BF16 peak."""
    spec = flops.H100_SXM
    assert (spec.peak_bf16_flops, spec.peak_tf32_flops, spec.peak_fp32_flops,
            spec.hbm_bytes_per_s, spec.hbm_bytes, spec.power_limit_w) == (
        989.4e12, 494.7e12, 66.9e12, 3.35e12, 80e9, 700.0)
    assert "H100" in spec.name and "700 W" in spec.name
    assert "350 W" in flops.H100_PCIE.name
    cases = {"mxu": flops.StageCost(0.6 * 66.9e12, 0.0, 0.1 * 3.35e12),
             "hbm": flops.StageCost(0.0, 0.0, 0.6 * 3.35e12),
             "balanced (mxu+hbm)": flops.StageCost(0.45 * 66.9e12, 0.0,
                                                   0.45 * 3.35e12),
             "latency/serial-chain": flops.StageCost(1e9, 1e9, 1e6)}
    for label, cost in cases.items():
        r = flops.roofline(cost, 1.0, "highest", spec)
        assert r["bound"] == label
        assert r["mfu"] == pytest.approx(cost.flops / 989.4e12)
        assert r["chip"] == spec.name
    cost = flops.StageCost(1e12, 0.0, 0.0)
    assert (flops.roofline(cost, 1.0, "default", spec)
            ["mfu_precision_adjusted"]) == pytest.approx(1e12 / 494.7e12)
    assert (flops.roofline(cost, 1.0, "highest", spec)
            ["mfu_precision_adjusted"]) == pytest.approx(1e12 / 66.9e12)


def test_chip_spec_by_device_name(monkeypatch):
    """chip_spec picks the spec by the CUDA device's name and raises for a
    card it has no datasheet for, rather than guess."""
    class Props(NamedTuple):
        name: str

    names = iter(["NVIDIA H100 80GB HBM3", "NVIDIA H100 PCIe",
                  "NVIDIA A100-SXM4-80GB"])
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device: Props(next(names)))
    assert flops.chip_spec(0) is flops.H100_SXM
    assert flops.chip_spec(0) is flops.H100_PCIE
    with pytest.raises(ValueError, match="A100"):
        flops.chip_spec(0)


def test_fused_is_ignored_as_in_the_reference():
    """The reference's h_apply_cost accepts ``fused`` and drops it
    (``del fused``): the same cost either way. The port keeps that."""
    a = flops.h_apply_cost(301, 301, 256, fused=False)
    b = flops.h_apply_cost(301, 301, 256, fused=True)
    assert a == b == tuple(jflops.h_apply_cost(301, 301, 256, fused=True))
    assert a != flops.h_apply_cost(301, 301, 256, materialized=True)


def test_no_tpu_number_in_the_port_flops():
    """utils/flops.py states no TPU figure: none of the reference's V5E
    numbers, no pass table."""
    src = open(flops.__file__).read()
    for token in ("197e12", "819e9", "16e9", "PRECISION_PASSES", "v5e",
                  "V5E"):
        assert token not in src, token


# -- host ---------------------------------------------------------------------

class _Result(NamedTuple):
    velocity: object
    metrics: dict


def test_fetch_tree_on_nested_results():
    """fetch keeps complex64; fetch_tree maps over dicts, lists, tuples
    and NamedTuples, keeping their types and None leaves."""
    z = torch.tensor([1 + 2j, 3 - 1j], dtype=torch.complex64)
    got = host.fetch(z)
    assert isinstance(got, np.ndarray) and got.dtype == np.complex64
    np.testing.assert_array_equal(got, z.numpy())
    assert host.as_numpy_complex(z).dtype == np.complex64
    v = torch.arange(6, dtype=torch.float32, requires_grad=True).reshape(2, 3)
    tree = _Result(velocity=v, metrics={"loss": [torch.tensor(1.5), 2.0],
                                        "field": (z, None)})
    out = host.fetch_tree(tree)
    assert isinstance(out, _Result)
    np.testing.assert_array_equal(out.velocity, v.detach().numpy())
    assert isinstance(out.metrics["loss"], list)
    assert float(out.metrics["loss"][0]) == 1.5
    assert isinstance(out.metrics["field"], tuple)
    assert out.metrics["field"][1] is None
    assert out.metrics["field"][0].dtype == np.complex64


# -- profiling ----------------------------------------------------------------

def test_trace_writes_a_trace_file(tmp_path):
    """trace() exports a Chrome trace of the CPU ops inside it."""
    a = torch.ones(64, 64)
    with profiling.trace(str(tmp_path / "prof")):
        (a @ a).sum()
    path = tmp_path / "prof" / "trace.json"
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("aten::mm" in str(e.get("name", "")) for e in events)


def test_timed_and_benchmark_return_their_keys(capsys):
    results = {}
    with profiling.timed("matmul", results):
        torch.ones(32, 32) @ torch.ones(32, 32)
    assert set(results) == {"matmul"} and results["matmul"] >= 0.0
    with profiling.timed("printed"):
        pass
    assert "[timed] printed:" in capsys.readouterr().out
    calls = []
    out = profiling.benchmark(lambda x, k=1: calls.append((x, k)), 3,
                              warmup=2, iters=4, k=5)
    assert set(out) == {"compile_s", "mean_s", "min_s"}
    assert out["min_s"] <= out["mean_s"]
    assert calls == [(3, 5)] * 6  # first call, one more warm-up, 4 timed
