#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py            # the full check, under a minute on an H100

Phases (any failure makes the exit code non-zero):
  1. device and build: the card, its power limit, the nvcc build of
     waveforminversionust_tpu_torch/csrc/*.cu (one nvcc per source, in
     parallel) and its seconds;
  2. every kernel against its plain PyTorch version on the card, at the
     main path's shapes, with its relative Frobenius error, max abs error
     and the time of both;
  3. data: a 256-element ring dataset synthesized over a breast phantom on
     a 401^2 / 0.6 mm grid at 350 kHz (seed 0) through the kernels;
  4. the slice: 10 nonlinear-CG iterations at 301^2 / 0.8 mm, 256
     transmitters, refactor_every=2, from 1480 m/s; one warm-up run, then a
     timed run with the kernel launch counts reset just before it;
  5. slice parity: 2 iterations through the kernels and through the plain
     PyTorch path, held to the golden bounds.

The last lines are a JSON object of the kernels, the card's name and power
limit, and {"ok": true, "device": {...}}. Without a CUDA device it exits
non-zero and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np

PALLAS = "waveforminversionust_tpu/ops/"
# The kernels of the main path, one row each in the "kernels" line. The
# stencil kernel also serves the TPU's tiled call site
# (pallas_stencil.py:230), which the main path does not reach at 301^2:
# phase 2 checks it at 801^2 ("stencil_801") without a row of its own.
KERNELS = {
    "factor": dict(source="waveforminversionust_tpu_torch/csrc/factor.cu",
                   replaces=PALLAS + "pallas_factor.py:384"),
    "sweep": dict(source="waveforminversionust_tpu_torch/csrc/sweep.cu",
                  replaces=PALLAS + "pallas_sweep.py:220"),
    "stencil": dict(source="waveforminversionust_tpu_torch/csrc/stencil.cu",
                    replaces=PALLAS + "pallas_stencil.py:273"),
}
# Tolerances: K1 the bound of tests/test_pallas_factor.py:39; K2 and K3 the
# port's issue bounds (f32 sums taken in another order than the plain path).
TOL = {"factor": 5e-6, "sweep": 1e-5, "stencil": 1e-6, "stencil_801": 1e-6}
N_ITER = 10  # CG iterations of the timed slice (bench.py's N_ITER)
BIG = 801    # grid side of the tiled call site's check
REPS = 5     # timed calls per kernel case, after one warm-up call


def log(*a):
    print(*a, flush=True)


def rel_err(a, b):
    import torch
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def timed(fn, reps):
    """(result, ms per call) with CUDA events after one warm-up call."""
    import torch
    out = fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


class Smoke:
    """The phases, at the main path's shapes (bench.py::bench_2d): the
    301^2 / 0.8 mm grid and the reference 256-element ring."""

    def __init__(self, device):
        from waveforminversionust_tpu_torch.config import AcquisitionConfig
        from waveforminversionust_tpu_torch.fwi.runner import default_inversion_grid
        self.device = device
        self.grid = default_inversion_grid()
        self.acq_config = AcquisitionConfig()
        self.n_tx = self.acq_config.num_elements
        self.failures: list[str] = []
        self.kernels: dict[str, dict] = {}
        self.per_call: dict[str, float] = {}
        self.bad: list[str] = []

    def phase(self, name, fn):
        log(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # noqa: BLE001 - record the phase, run the others
            self.failures.append(name)
            log(f"FAILED phase {name}:\n{traceback.format_exc()}")
        log(f"== phase {name} done in {time.perf_counter() - t0:.2f} s")

    def check(self, ok, what):
        if not ok:
            raise AssertionError(what)

    def time_kernel(self, name, fn):
        """timed(fn), noting in per_call the kernel launches one call of
        the wrapper ``name`` makes at these shapes."""
        from waveforminversionust_tpu_torch.ops import kernel_launch_counts
        before = kernel_launch_counts()[name]
        out, ms = timed(fn, REPS)
        self.per_call[name] = (kernel_launch_counts()[name] - before) / (REPS + 1)
        return out, ms

    # -- phase 2 --------------------------------------------------------
    def record(self, name, kern, plain, ms, plain_ms):
        """Hold a kernel's output against its plain version's; a failed
        bound is collected so that every kernel is still measured."""
        import torch
        rel = rel_err(kern, plain)
        mx = float(torch.max(torch.abs(kern - plain)))
        ok = bool(np.isfinite(rel)) and rel < TOL[name]
        # Over a kernel's cases: the worst error and the mean times.
        ent = self.kernels.setdefault(name, dict(max_abs_err=0.0, rel=0.0,
                                                 runs=[]))
        ent["runs"].append((ms, plain_ms))
        ent.update(max_abs_err=max(ent["max_abs_err"], mx),
                   rel=max(ent["rel"], rel),
                   ms=float(np.mean([r[0] for r in ent["runs"]])),
                   plain_ms=float(np.mean([r[1] for r in ent["runs"]])))
        log(f"  {name}: rel {rel:.3e} (bound {TOL[name]:.0e}) max_abs "
            f"{mx:.3e} kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.bad.append(f"{name}: rel {rel:.3e} >= {TOL[name]:.0e}")

    def kernels_vs_plain(self):
        import torch
        from waveforminversionust_tpu_torch.config import SolverConfig
        from waveforminversionust_tpu_torch.models.phantom import breast_phantom
        from waveforminversionust_tpu_torch.ops import apply, banded
        from waveforminversionust_tpu_torch.ops.kernel_factor import banded_factor_kernel
        from waveforminversionust_tpu_torch.ops.kernel_stencil import h_apply_kernel
        from waveforminversionust_tpu_torch.ops.kernel_sweep import banded_solve_kernel
        from waveforminversionust_tpu_torch.ops.stencil import helmholtz_coefficients

        dev, cfg = self.device, SolverConfig()
        grid = self.grid
        ny, nx = grid.shape
        rng = np.random.default_rng(0)
        phantoms = {"breast": breast_phantom(grid),
                    "1480": np.full(grid.shape, 1480.0, np.float32)}
        fac = None
        for label, vel in phantoms.items():
            coeffs = helmholtz_coefficients(torch.as_tensor(vel, device=dev),
                                            grid, 350e3, cfg.pml, cfg.stencil)
            fk, ms = self.time_kernel("factor", lambda: banded_factor_kernel(coeffs))
            t0 = time.perf_counter()
            fp = banded.banded_factor(coeffs)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
            # K1's bound is held against the plain factor computed in
            # complex128: the FP32 kernel (blocked Gauss-Jordan) and the FP32
            # plain version (pivoted LU) each sit a few 1e-6 from the exact
            # factor at 301^2, so their mutual distance sums two FP32 errors.
            g64 = banded.banded_factor(coeffs.to(torch.complex128)).g
            log(f" K1 factor on the {label} planes ({ny}x{nx}); FP32 kernel "
                f"vs FP32 plain {rel_err(fk.g.to(g64.dtype), fp.g.to(g64.dtype)):.3e}, "
                f"FP32 plain vs complex128 plain "
                f"{rel_err(fp.g.to(g64.dtype), g64):.3e}; kernel vs complex128 plain:")
            self.record("factor", fk.g.to(g64.dtype), g64, ms, plain_ms)
            if fac is None:
                fac = fk
            del g64

        b = torch.as_tensor((rng.standard_normal((self.n_tx, ny, nx))
                             + 1j * rng.standard_normal((self.n_tx, ny, nx))
                             ).astype(np.complex64), device=dev)
        for adjoint in (False, True):
            xk, ms = self.time_kernel("sweep", lambda: banded_solve_kernel(fac, b, adjoint))
            xp, plain_ms = timed(lambda: banded.banded_solve(fac, b, adjoint), REPS)
            log(f" K2 sweeps, adjoint={adjoint}, {self.n_tx} RHS:")
            self.record("sweep", xk, xp, ms, plain_ms)
            op = apply.h_apply_adjoint if adjoint else apply.h_apply
            res = rel_err(op(fac.coeffs, xk), b)
            log(f"  true relative residual of the kernel solve: {res:.3e}")
            if not res < 2e-5:
                self.bad.append(f"sweep residual {res:.3e} >= 2e-5")

        from waveforminversionust_tpu_torch.models.grid import Grid2D
        for label, gsize, batch, name in (
                ("whole-field site", grid, self.n_tx, "stencil"),
                ("tiled site", Grid2D.centered(0.4e-3 * (BIG - 1), 0.8e-3), 4,
                 "stencil_801")):
            vel = breast_phantom(gsize)
            coeffs = helmholtz_coefficients(torch.as_tensor(vel, device=dev),
                                            gsize, 350e3, cfg.pml, cfg.stencil)
            shape = (batch,) + gsize.shape
            u = torch.as_tensor((rng.standard_normal(shape)
                                 + 1j * rng.standard_normal(shape)
                                 ).astype(np.complex64), device=dev)
            adj = apply.adjoint_coefficients(coeffs)
            for adjoint in (False, True):
                planes = adj if adjoint else coeffs
                ok_, ms = self.time_kernel("stencil", lambda: h_apply_kernel(planes, u))
                plain = apply.h_apply_adjoint if adjoint else apply.h_apply
                op_, plain_ms = timed(lambda: plain(coeffs, u), REPS)
                log(f" K3 apply, {label}, {gsize.ny}^2 x {batch}, "
                    f"adjoint={adjoint}:")
                self.record(name, ok_, op_, ms, plain_ms)
        self.check(not self.bad, f"kernel checks failed: {self.bad}")

    # -- phase 3 --------------------------------------------------------
    def data(self):
        import torch
        from waveforminversionust_tpu_torch.config import SolverConfig
        from waveforminversionust_tpu_torch.data.synthesize import synthesize_ring_dataset
        from waveforminversionust_tpu_torch.models.grid import Grid2D
        from waveforminversionust_tpu_torch.models.phantom import breast_phantom

        # bench.py's fallback data: the same ring over a 0.6 mm grid.
        fine = Grid2D.centered(120e-3, 0.6e-3)
        t0 = time.perf_counter()
        self.ds = synthesize_ring_dataset(breast_phantom(fine), fine,
                                          self.acq_config,
                                          f=350e3, solver=SolverConfig(),
                                          seed=0, device=self.device)
        torch.cuda.synchronize()
        rec = self.ds.rec_data
        log(f" synthesized {rec.shape} on {fine.ny}^2 in "
            f"{time.perf_counter() - t0:.2f} s; finite {np.isfinite(rec).all()}")
        self.check(np.isfinite(rec).all() and np.abs(rec).max() > 0,
                   "synthesized data not finite / all zero")

    # -- phase 4 --------------------------------------------------------
    def _setup(self):
        import torch
        from waveforminversionust_tpu_torch.fwi.objective import build_fwi_data
        from waveforminversionust_tpu_torch.models.acquisition import build_ring_acquisition

        from waveforminversionust_tpu_torch.config import FWIConfig

        grid = self.grid
        acq = build_ring_acquisition(grid, self.acq_config, x_elem=self.ds.x_circ,
                                     y_elem=self.ds.y_circ)
        data = build_fwi_data(acq, self.ds.rec_data, self.ds.f, device=self.device)
        vel0 = torch.full(grid.shape, FWIConfig().c_init, dtype=torch.float32,
                          device=self.device)
        return grid, data, vel0

    def slice(self):
        import torch
        from waveforminversionust_tpu_torch.config import FWIConfig, SolverConfig
        from waveforminversionust_tpu_torch.fwi.optimizers import nonlinear_cg
        from waveforminversionust_tpu_torch.fwi.runner import reconstruction_rmse
        from waveforminversionust_tpu_torch.models.grid import Grid2D
        from waveforminversionust_tpu_torch.ops import (kernel_launch_counts,
                                                        reset_kernel_launch_counts)

        grid, data, vel0 = self._setup()
        solver = SolverConfig(refactor_every=2)
        fwi = FWIConfig(num_iterations=N_ITER)
        t0 = time.perf_counter()
        nonlinear_cg(vel0, data, grid, solver, fwi)
        torch.cuda.synchronize()
        log(f" warm-up run: {time.perf_counter() - t0:.2f} s")
        reset_kernel_launch_counts()
        t0 = time.perf_counter()
        res = nonlinear_cg(vel0, data, grid, solver, fwi)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        self.counts = kernel_launch_counts()
        loss = res.metrics.loss.cpu().numpy()
        true_grid = Grid2D.from_arrays(self.ds.x, self.ds.y)
        rmse0 = reconstruction_rmse(vel0.cpu().numpy(), grid, self.ds.c, true_grid)
        rmse = reconstruction_rmse(res.velocity.cpu().numpy(), grid, self.ds.c,
                                   true_grid)
        self.s_per_iter = elapsed / N_ITER
        log(f" s/iter {self.s_per_iter:.6f} ({N_ITER} iterations, "
            f"{elapsed:.4f} s)")
        log(f" loss {loss.tolist()}")
        log(f" rmse start {rmse0:.4f} m/s end {rmse:.4f} m/s")
        log(f" kernel launches in the timed run: {self.counts}")
        # Where the time goes: each wrapper's calls (launches over its
        # launches per call) times its phase-2 ms per call at these shapes
        # (the sweep's and the stencil's mean of forward and adjoint).
        est = {name: n / self.per_call[name] * self.kernels[name]["ms"] / 1e3
               for name, n in self.counts.items()
               if self.per_call.get(name) and name in self.kernels}
        if est:
            log(f" kernel seconds estimated from counts x phase-2 ms: "
                f"{ {k: round(v, 4) for k, v in est.items()} }, "
                f"rest {elapsed - sum(est.values()):.4f} s of {elapsed:.4f} s")
        self.slice_numbers = dict(s_per_iter=self.s_per_iter, rmse_start=rmse0,
                                  rmse_end=rmse, loss=loss.tolist(),
                                  launches=self.counts)
        self.check(np.all(np.isfinite(loss)) and loss[-1] < loss[0],
                   f"loss not finite or not decreasing: {loss}")
        self.check(rmse < rmse0, f"rmse {rmse} not below the start {rmse0}")
        self.check(all(v > 0 for v in self.counts.values()),
                   f"a kernel was not launched on the main path: {self.counts}")

    # -- phase 5 --------------------------------------------------------
    def parity(self):
        import torch
        from waveforminversionust_tpu_torch.config import FWIConfig, SolverConfig
        from waveforminversionust_tpu_torch.fwi.optimizers import nonlinear_cg

        grid, data, vel0 = self._setup()
        fwi = FWIConfig(num_iterations=2)
        kern = nonlinear_cg(vel0, data, grid, SolverConfig(refactor_every=2), fwi)
        plain = nonlinear_cg(vel0, data, grid,
                             SolverConfig(refactor_every=2, factorization="thomas",
                                          fused_apply="off"), fwi)
        lk, lp = kern.metrics.loss.cpu().numpy(), plain.metrics.loss.cpu().numpy()
        sk = kern.metrics.step_size.cpu().numpy()
        sp = plain.metrics.step_size.cpu().numpy()
        dv = float(torch.max(torch.abs(kern.velocity - plain.velocity)))
        log(f" loss kernel {lk.tolist()} plain {lp.tolist()}")
        log(f" step kernel {sk.tolist()} plain {sp.tolist()}")
        log(f" max |velocity difference| {dv:.4e} m/s")
        self.check(np.allclose(lk, lp, rtol=1e-2, atol=0)
                   and np.allclose(sk, sp, rtol=1e-2, atol=0),
                   "loss/step disagree beyond rtol 1e-2")
        self.check(dv <= 0.5, f"velocity differs by {dv} m/s > 0.5")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="kernels,data,slice,parity",
                    help="comma-separated subset of kernels,data,slice,parity")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import waveforminversionust_tpu_torch  # noqa: F401
    from waveforminversionust_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    smoke = Smoke(dev)
    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    def build():
        out = _build.build_all()
        log(f" kernels built in {_build.build_seconds:.2f} s into {out}")
        for name in _build.SOURCES:
            for line in (out / f"{name}.log").read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  [{name}] {line.strip()}")

    smoke.phase("build", build)
    if "build" not in smoke.failures:
        phases = args.phases.split(",")
        if "kernels" in phases:
            smoke.phase("kernels", smoke.kernels_vs_plain)
        if {"data", "slice", "parity"} & set(phases):
            smoke.phase("data", smoke.data)
        if "slice" in phases and "data" not in smoke.failures:
            smoke.phase("slice", smoke.slice)
        if "parity" in phases and "data" not in smoke.failures:
            smoke.phase("parity", smoke.parity)

    counts = getattr(smoke, "counts", {})
    rows = []
    for name, meta in KERNELS.items():
        k = smoke.kernels.get(name, {})
        rows.append(dict(name=name, route="cuda", source=meta["source"],
                         replaces=meta["replaces"],
                         launches=counts.get(name, 0),
                         max_abs_err=k.get("max_abs_err"), ms=k.get("ms"),
                         plain_ms=k.get("plain_ms")))
    if smoke.failures:
        log(f"FAILED phases: {smoke.failures}")
        return 1
    if hasattr(smoke, "slice_numbers"):
        log(f"slice: {json.dumps(smoke.slice_numbers)}")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
