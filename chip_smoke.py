#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA card and check them.

    python3 chip_smoke.py            # the full check, ~5 minutes on an H100
    python3 chip_smoke.py --phases kernels,data,profile   # a subset

Phases (any failure makes the exit code non-zero):
  1. device and build: the card, its power limit, the nvcc build of
     waveforminversionust_tpu_torch/csrc/*.cu (one nvcc per source, in
     parallel) and its seconds;
  2. kernels: every kernel against its plain PyTorch version on the card, at
     its path's shapes, with its relative Frobenius error, max abs error,
     the time of both (K3 and K5, kernels of tens of microseconds, in a CUDA
     graph of launches, the others by CUDA events around calls from the
     host), the least time the card could take (bound) and, where one
     PyTorch call computes the same function, that call's time; both
     sweeps (block-Thomas and twisted) also at the data phase's 401^2, and
     their cluster launches; K3's bytes and rate at both call sites; K5 at
     every level's batch of the 301^2 cyclic factorization (us a launch,
     cycles a step, bounds) and its total for one factorization; the SHA-256
     of K3's and K5's outputs, so that the same script run against two
     trees compares their kernels' bits; and the pivot step of the two
     factorizations launched alone (us a launch);
  3. data: a 256-element ring dataset synthesized over a breast phantom on
     a 401^2 / 0.6 mm grid at 350 kHz (seed 0) through the kernels;
  4. the slices: 10 nonlinear-CG iterations at 301^2 / 0.8 mm, 256
     transmitters, refactor_every=2, from 1480 m/s, through each direct
     engine: block-Thomas (``slice``, the main path), twisted
     (``slice_twisted``) and cyclic reduction (``slice_cr``). Each is one
     warm-up run, then a timed run with the kernel launch counts set to 0
     just before it and read just after; the two opt-in engines are held to
     the block-Thomas trajectory;
  5. parity: 2 iterations of each engine through the kernels and through the
     plain PyTorch functions on the same CUDA tensors, held to the golden
     bounds;
  6. intake: bench.py::bench_intake through the public entry points with no
     device named, on the data phase's dataset: qc_report and reciprocity
     compensation, calibrate_background_speed (301^2, 16 transmitters, 9
     candidates over 1400-1600 m/s, 2 levels; its 18 misfits held against
     the plain path's at the same speeds), then invert_dataset with
     bilinear receivers and illumination preconditioning from the
     calibrated speed (10 iterations, warm-up then timed), and 2 of its
     iterations held against the plain path's;
  7. runner: invert_dataset's other paths at 301^2 / 256 transmitters: a
     two-stage continuation (300 then 350 kHz) over a {frequency: dataset}
     mapping with receiver calibration, refactor_every=2, checkpoints every
     2 iterations and a live callback; then the kill-and-resume of
     tests/test_fwi.py (one stage of 4, killed after the first checkpoint,
     resumed) against the uninterrupted run;
  8. lbfgs: invert_dataset(method="lbfgs"), 5 iterations, memory 10, over
     the differentiable solve (its backward the adjoint sweep): s/iter,
     value-and-grad evaluations, loss, RMSE, peak memory, launches; the
     first gradient against the plain path's (rel 1e-4), a central
     difference along a smooth bump against <g, dp> (rel 0.12), and 2
     iterations held against the plain path;
  9. gn: invert_dataset(method="gn"), 3 outer iterations of 8 inner: s per
     outer iteration, backtracks, inner residuals, monotone losses, RMSE,
     launches; <J dm, r> against <dm, J^H r> at the start (rel 1e-4); 1
     outer iteration held against the plain path;
 10. multifreq: invert_dataset(method="joint-multifreq") over the runner
     phase's {300, 350 kHz} mapping, 3 iterations: s/iter, loss, RMSE,
     launches (two factorizations a frequency an iteration); 2 iterations
     held against the plain path;
 11. gmres: invert_dataset with SolverConfig(method=GMRES) (tol 1e-5, cap
     1000), 2 CG iterations, every matvec K3: s/iter, matvecs and
     residuals of each solve, RMSE, peak memory, launches (K3 only); K1
     and K2 at the 151^2 coarse width against their plain versions; one
     forward operator solve two-level (K1 on the 151^2 coarse operator, K2
     in every preconditioner application) beside the one-level one at the
     same matvec count; two cycles of each, kernel against
     fused_apply="off" (equal matvecs, iterates rel < 1e-4);
 12. born: invert_dataset with SolverConfig(method=BORN), 2 CG iterations:
     s/iter, matvecs a solve, ms of one FFT pair of the Green's operator,
     RMSE, peak memory; no kernel launched;
 13. broadband: the JAX CLI's broadband workflow with the 256-element ring:
     (tx, rx, t) traces over the 150-350 kHz comb at 401^2 (9 lines, one
     K1 and one K2 each), extraction held to the comb's receiver matrices
     (rel < 1e-4), the direct-arrival gate, then a 150/250/350 kHz
     continuation of 5 CG iterations a frequency at 301^2: synthesis
     seconds, s/iter a stage, losses falling in each stage, RMSE, launches
     as counted;
 14. fwi3d: bench.py's 3D phase through the volumetric path at 64^3 / 0.75
     mm, 16 transmitters, 300 kHz: the spectral A/B (cuFFT against the
     dense DFT products at "highest" and "high": ms a transform pair and a
     matvec, the field's difference; the dft transform held to the fft one
     at rel 1e-5), the synthesis solve, 2 cold CG iterations and 4 warm
     ones (BB, the watchdog, warm starts) after a warm-up each: s/iter,
     matvecs a solve, loss, RMSE, peak memory; cold losses falling, warm
     ones reaching half the first; a matvec's device time split into the
     FFT pair, Gram-Schmidt and elementwise work (torch.profiler) beside
     its byte bound; one forward solve at 128^3 (recorded); no kernel
     launched;
 15. broadband3d: the JAX CLI's broadband3d workflow at its defaults (65^3,
     3 x 16 elements, the 150-400 kHz comb, 4 CG iterations at 150, 275
     and 400 kHz): synthesis seconds, extraction per line (rel < 1e-4),
     s/iter a stage, losses falling in each stage, RMSE end < start, no
     kernel launched;
 16. traveltime (run after broadband): the JAX CLI's broadband
     --traveltime-init on the broadband traces: the direct-arrival gate,
     traveltime_init straight and bent (3 outer passes) on 301^2 with the
     +-31-element exclusion: pick and tomogram seconds, the latter split
     into eikonal batches, ray traces and PCG solves, Jacobi sweeps and
     iterations a source, ms a sweep beside its byte bound, PCG residuals,
     peak memory, RMSE; finite tomograms inside 1300-1800 m/s whose picks'
     residual is below the homogeneous model's, no kernel launched; a
     homogeneous eikonal field within 1.5 cells of r * s at
     tests/test_eikonal.py's shape (the ring's 256 recorded); then the
     continuation from the straight tomogram (5 CG iterations at each of
     150, 250 and 350 kHz, refactor_every=2): K1, K2 and K3 launched, each
     stage's losses falling, RMSE below the tomogram's;
 17. traveltime3d: the JAX CLI's broadband3d --traveltime-init at its
     defaults on the broadband3d traces, straight and bent, the same
     numbers and holds (clip c +- 2 dv), no kernel launched;
 18. methods3d: at fwi3d's shapes, the gradient of fwi_loss_3d against
     central differences (lossless and lossy, both fields), then
     invert_dataset_3d "lbfgs" (5 iterations), "gn" (2 of 6 inner),
     "alpha" and "joint" (3 each, on data with a Gaussian absorber), and
     calibrate_background_speed_3d (9 x 2): s/iter, solves and their
     matvecs, peak memory, RMSE, c0; losses finite and falling (GN
     monotone), RMSE falling (the absorber recovered under "alpha"), c0 of
     a water shot within one final-level step of 1500 m/s, no kernel
     launched;
 19. cli: the port's command-line interface in-process on the card at the
     JAX CLI's defaults, no --device given: simulate (801^2 / 0.3 mm) into
     a .mat, qc on it, run (301^2, cg, 10 iterations) with --out held to
     invert_dataset called directly (the same bits), RMSE falling, factor
     and sweep kernels launched and no engine's other; run --profile (the
     trace names the launched kernels' device functions); run --method
     lbfgs; timedomain, broadband, broadband3d at their defaults with
     --iterations 1 (--plot where matplotlib is installed); the scan
     hybrids (factor_schulz_steps=4, fast_sweeps=True: no factor or sweep
     launch) and the frozen factor at 601^2 (refactor_every=2, finite and
     falling); the roofline of run's s/iter (utils/flops on chip_spec(0));
 20. profile (only when asked for): torch.profiler over 2 iterations of each
     engine, a two-cycle GMRES solve (one- and two-level) and a Born
     solve: device time by kernel name and the idle share.

The last lines are a JSON object of the kernels, the card's name and power
limit, and {"ok": true, "device": {...}}. Without a CUDA device it exits
non-zero and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import subprocess
import sys
import time
import traceback
from unittest import mock

import numpy as np

PALLAS = "waveforminversionust_tpu/ops/"
CSRC = "waveforminversionust_tpu_torch/csrc/"
# One row each in the "kernels" line. The stencil kernel also serves the
# TPU's tiled call site (pallas_stencil.py:230), which no slice reaches at
# 301^2: phase 2 checks it at 801^2 ("stencil_801") without a row of its own.
KERNELS = {
    "factor": dict(source=CSRC + "factor.cu",
                   replaces=PALLAS + "pallas_factor.py:384"),
    "sweep": dict(source=CSRC + "sweep.cu",
                  replaces=PALLAS + "pallas_sweep.py:220"),
    "stencil": dict(source=CSRC + "stencil.cu",
                    replaces=PALLAS + "pallas_stencil.py:273"),
    "twisted_factor": dict(source=CSRC + "twisted.cu",
                           replaces=PALLAS + "pallas_twisted.py:232"),
    "twisted_sweep": dict(source=CSRC + "twisted.cu",
                          replaces=PALLAS + "pallas_twisted.py:399"),
    "batched_inv": dict(source=CSRC + "inv.cu",
                        replaces=PALLAS + "pallas_inv.py:81"),
}
# Tolerances: the factors the bound of tests/test_pallas_factor.py:39; the
# sweeps and K3 the port's own bounds (f32 sums taken in another order than
# the plain path); K5, and the factorizations' pivot inverse launched alone,
# the bound of tests/test_batched_inv.py:82.
TOL = {"factor": 5e-6, "factor_151": 5e-6, "sweep": 1e-5, "sweep_401": 1e-5,
       "sweep_151": 1e-5, "stencil": 1e-6, "stencil_801": 1e-6,
       "twisted_factor": 5e-6, "twisted_sweep": 1e-5,
       "twisted_sweep_401": 1e-5, "batched_inv": 5e-5,
       "batched_inv_16": 5e-5, "pivot_inverse": 5e-5}
# A trajectory against another (an engine against block-Thomas, a kernel
# path against its plain path): rtol of loss and step, atol of velocity as
# a fraction of its largest value. GOLDEN is tests/test_golden.py's (0.5 of
# ~1600 m/s). Cyclic reduction cannot hold it in FP32 at 301^2: unpivoted, on
# the indefinite operator, its solves sit ~1e-2 from exact on random
# right-hand sides (block-Thomas and twisted ~3e-6; in complex128 it is
# exact to 1e-11, so it is rounding, which phase 2 prints). Its trajectory is
# held to the reference's own bound for this engine against block-Thomas
# (tests/test_cyclic.py:170-174: velocity atol 2e-3 of its largest value),
# to the golden loss rtol, and to a step rtol of 5e-2 (the step is a ratio
# of two sums of such fields; measured 8.7e-3 over 10 iterations).
GOLDEN = dict(loss=1e-2, step=1e-2, vel_atol=0.5, vel_frac=None)
CR_BOUNDS = dict(loss=1e-2, step=5e-2, vel_atol=None, vel_frac=2e-3)
N_ITER = 10  # CG iterations of the timed slices (bench.py's N_ITER)
# The intake's calibration misfits, kernel path against the plain path at
# the same 18 speeds: rtol. Measured 1.26e-6 on an H100 80GB HBM3 at 700 W
# (PERF.md §6), so 1e-4 leaves a margin of ~80.
CAL_RTOL = 1e-4
BIG = 801    # grid side of the tiled call site's check
REPS = 5     # timed calls per kernel case, after one warm-up call
# Published peaks of one H100 SXM (NVIDIA's data sheet): FP32 outside the
# tensor cores (every kernel here is FP32 FMA code) and HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
C64 = 8      # bytes of a complex64
CMAC = 8     # real FP32 operations of a complex multiply-add
SMS = 132    # streaming multiprocessors of an H100 SXM
C3D = 1500.0  # background speed of the 3D phases [m/s]
C_REF_TT = 1480.0  # the 2D travel-time start's c_ref (the CLI's --c-init)


def log(*a):
    print(*a, flush=True)


def sha256(t) -> str:
    """SHA-256 of a tensor's bytes, to compare two trees' outputs."""
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


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


def graph_timed(fn, launches=50, replays=5):
    """ms per call of ``fn`` with the host out of the way: ``launches``
    calls captured into one CUDA graph (the kernels launch on PyTorch's
    current stream, which is the capture's), replayed ``replays`` times
    between CUDA events. For kernels of a few microseconds, which a Python
    loop cannot launch as fast as the card runs them."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def host_timed(fn):
    """(result, ms) of one call on the host clock, ended by a synchronize:
    for the plain factors, a Python loop of hundreds of small calls."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound(flops, nbytes):
    """The least ms the card could take: each input byte read once and each
    output byte written once over the memory rate, or the operations over
    the FP32 peak, whichever is larger; and which of the two it is."""
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sweep_launch(name, p, steps, nx, ms):
    """Log a sweep kernel's last launch ``p`` (thread-block clusters: blocks
    and right-hand sides a cluster, threads, shared memory, clusters the
    card holds at once) and the bytes of G its blocks copy from L2 a solve,
    counted from the rows each block loads (its slice and one halo row each
    side) over the ``steps`` row steps a cluster walks (K2 2 ny - 1; K4b ny
    on average, the two chains of a group 2 ny over both launches), with
    the rate they imply at ``ms``."""
    c = p["cluster"]
    width = -(-nx // c)
    rows = 0
    for rank in range(c):
        o0 = min(nx, rank * width)
        o1 = min(nx, o0 + width)
        if o1 > o0:
            rows += min(nx, o1 + 1) - max(0, o0 - 1)
    l2 = steps * p["clusters"] * rows * nx * C64
    log(f"  {name} launch: {p['clusters']} clusters of {c} blocks x "
        f"{p['threads']} threads, {p['rows']} gemv rows a block, "
        f"{p['rhs']} RHS a cluster, {p['smem_bytes']} B shared memory a "
        f"block, {p['max_active_clusters']} clusters resident at once; G "
        f"copied from L2 {l2 / 1e9:.3f} GB a solve ({rows} rows of a G_i a "
        f"cluster), {l2 / ms / 1e9:.3f} TB/s at {ms:.3f} ms")


def data_grid():
    """The data phase's grid: bench.py's fallback, 0.6 mm over 120 mm."""
    from waveforminversionust_tpu_torch.models.grid import Grid2D
    return Grid2D.centered(120e-3, 0.6e-3)


@contextlib.contextmanager
def plain_engines():
    """Route the opt-in engines' kernel wrappers to their plain PyTorch
    versions, so that the plain functions run on the same CUDA tensors
    (block-Thomas has ``factorization="thomas"`` for that)."""
    from waveforminversionust_tpu_torch.ops import batched_inv, solve, twisted
    with mock.patch.object(solve, "twisted_factor_kernel", twisted.twisted_factor), \
            mock.patch.object(solve, "twisted_solve_kernel", twisted.twisted_solve), \
            mock.patch.object(batched_inv, "batched_small_inv_kernel",
                              batched_inv._batched_pivot_inv):
        yield


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
        self.slices: dict[str, dict] = {}
        self.launches = dict.fromkeys(KERNELS, 0)
        self.combs: dict[str, object] = {}  # broadband traces, 2D and 3D

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
    def record(self, name, kern, plain, ms, plain_ms, bound_ms=None,
               library_ms=None):
        """Hold a kernel's output against its plain version's; a failed
        bound is collected so that every kernel is still measured.
        ``bound_ms``: (ms, "bytes" | "operations") for this case's inputs."""
        import torch
        rel = rel_err(kern, plain)
        mx = float(torch.max(torch.abs(kern - plain)))
        ok = bool(np.isfinite(rel)) and rel < TOL[name]
        # Over a kernel's cases: the worst error and the mean times.
        ent = self.kernels.setdefault(name, dict(max_abs_err=0.0, rel=0.0,
                                                 runs=[], library=[]))
        ent["runs"].append((ms, plain_ms))
        if library_ms is not None:
            ent["library"].append(library_ms)
        ent.update(max_abs_err=max(ent["max_abs_err"], mx),
                   rel=max(ent["rel"], rel),
                   ms=float(np.mean([r[0] for r in ent["runs"]])),
                   plain_ms=float(np.mean([r[1] for r in ent["runs"]])),
                   library_ms=(float(np.mean(ent["library"]))
                               if ent["library"] else None))
        extra = ""
        if bound_ms is not None:
            ent.update(bound_ms=bound_ms[0], bound_by=bound_ms[1])
            extra += f" bound {bound_ms[0]:.4f} ms ({bound_ms[1]})"
        if library_ms is not None:
            extra += f" library {library_ms:.3f} ms"
        log(f"  {name}: rel {rel:.3e} (bound {TOL[name]:.0e}) max_abs "
            f"{mx:.3e} kernel {ms:.3f} ms plain {plain_ms:.3f} ms{extra} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.bad.append(f"{name}: rel {rel:.3e} >= {TOL[name]:.0e}")

    def kernels_vs_plain(self):
        import torch
        from waveforminversionust_tpu_torch.config import SolverConfig
        from waveforminversionust_tpu_torch.models.grid import Grid2D
        from waveforminversionust_tpu_torch.models.phantom import breast_phantom
        from waveforminversionust_tpu_torch.ops import (apply, banded,
                                                        batched_inv, cyclic,
                                                        kernel_sweep,
                                                        kernel_twisted, twisted)
        from waveforminversionust_tpu_torch.ops.kernel_factor import banded_factor_kernel
        from waveforminversionust_tpu_torch.ops.kernel_inv import batched_small_inv_kernel
        from waveforminversionust_tpu_torch.ops.kernel_stencil import h_apply_kernel
        from waveforminversionust_tpu_torch.ops.kernel_sweep import banded_solve_kernel
        from waveforminversionust_tpu_torch.ops.kernel_twisted import (
            twisted_factor_kernel, twisted_solve_kernel)
        from waveforminversionust_tpu_torch.ops.stencil import helmholtz_coefficients

        dev, cfg = self.device, SolverConfig()
        grid = self.grid
        ny, nx = grid.shape
        n_rhs = self.n_tx
        rng = np.random.default_rng(0)
        c128 = torch.complex128
        phantoms = {"breast": breast_phantom(grid),
                    "1480": np.full(grid.shape, 1480.0, np.float32)}
        # Both factorizations: ny Gauss-Jordan inverses of nx x nx (nx^3
        # complex multiply-adds each); planes in, inverses out.
        factor_bound = bound(ny * CMAC * nx ** 3,
                             (9 * ny * nx + ny * nx * nx) * C64)
        fac = tfac = None
        for label, vel in phantoms.items():
            coeffs = helmholtz_coefficients(torch.as_tensor(vel, device=dev),
                                            grid, 350e3, cfg.pml, cfg.stencil)
            fk, ms = self.time_kernel("factor", lambda: banded_factor_kernel(coeffs))
            fp, plain_ms = host_timed(lambda: banded.banded_factor(coeffs))
            # K1's bound is held against the plain factor computed in
            # complex128: the FP32 kernel (blocked Gauss-Jordan) and the FP32
            # plain version (pivoted LU) each sit a few 1e-6 from the exact
            # factor at 301^2, so their mutual distance sums two FP32 errors.
            g64 = banded.banded_factor(coeffs.to(c128)).g
            log(f" K1 factor on the {label} planes ({ny}x{nx}); FP32 kernel "
                f"vs FP32 plain {rel_err(fk.g.to(c128), fp.g.to(c128)):.3e}, "
                f"FP32 plain vs complex128 plain "
                f"{rel_err(fp.g.to(c128), g64):.3e}; kernel vs complex128 plain:")
            self.record("factor", fk.g.to(c128), g64, ms, plain_ms, factor_bound)
            del g64, fp

            tk, ms = self.time_kernel("twisted_factor",
                                      lambda: twisted_factor_kernel(coeffs))
            tp, plain_ms = host_timed(lambda: twisted.twisted_factor(coeffs))
            t64 = twisted.twisted_factor(coeffs.to(c128)).g
            log(f" K4a twisted factor on the {label} planes, middle row "
                f"{tk.m}; rows above it vs K1's kernel factor (the same "
                f"matrices) {rel_err(tk.g[:tk.m], fk.g[:tk.m]):.3e}; FP32 "
                f"plain vs complex128 plain {rel_err(tp.g.to(c128), t64):.3e}; "
                f"kernel vs complex128 plain:")
            self.record("twisted_factor", tk.g.to(c128), t64, ms, plain_ms,
                        factor_bound)
            del t64, tp
            if fac is None:
                fac, tfac = fk, tk

        b = torch.as_tensor((rng.standard_normal((n_rhs, ny, nx))
                             + 1j * rng.standard_normal((n_rhs, ny, nx))
                             ).astype(np.complex64), device=dev)
        # Both solves: 2 ny - 1 gemvs of nx x nx per right-hand side;
        # inverses, planes and b in, x out.
        sweep_bound = bound((2 * ny - 1) * CMAC * nx * nx * n_rhs,
                            (ny * nx * nx + 9 * ny * nx + 2 * b.numel()) * C64)
        for adjoint in (False, True):
            op = apply.h_apply_adjoint if adjoint else apply.h_apply
            xk, ms = self.time_kernel("sweep", lambda: banded_solve_kernel(fac, b, adjoint))
            xp, plain_ms = timed(lambda: banded.banded_solve(fac, b, adjoint), REPS)
            log(f" K2 sweeps, adjoint={adjoint}, {n_rhs} RHS:")
            self.record("sweep", xk, xp, ms, plain_ms, sweep_bound)
            sweep_launch("K2", kernel_sweep.last_launch, 2 * ny - 1, nx, ms)
            res = rel_err(op(fac.coeffs, xk), b)
            log(f"  true relative residual of the kernel solve: {res:.3e}")
            if not res < 2e-5:
                self.bad.append(f"sweep residual {res:.3e} >= 2e-5")

            tx, ms = self.time_kernel("twisted_sweep",
                                      lambda: twisted_solve_kernel(tfac, b, adjoint))
            tp, plain_ms = timed(lambda: twisted.twisted_solve(tfac, b, adjoint), REPS)
            log(f" K4b twisted sweeps, adjoint={adjoint}, {n_rhs} RHS; "
                f"distance to K2's solution of the same system "
                f"{rel_err(tx, xk):.3e}:")
            self.record("twisted_sweep", tx, tp, ms, plain_ms, sweep_bound)
            sweep_launch("K4b", kernel_twisted.last_sweep_launch, ny, nx, ms)
            res = rel_err(op(tfac.coeffs, tx), b)
            log(f"  true relative residual of the kernel solve: {res:.3e}")
            if not res < 2e-5:
                self.bad.append(f"twisted sweep residual {res:.3e} >= 2e-5")
            del xk, xp, tx, tp
        self.sweep_yardstick(fac, b)
        self.sweep_data_shape()

        for label, gsize, batch, name in (
                ("whole-field site", grid, n_rhs, "stencil"),
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
            # 9 complex multiply-adds per point; planes and u in, H u out.
            nbytes = (coeffs.numel() + 2 * u.numel()) * C64
            stencil_bound = bound(9 * CMAC * u.numel(), nbytes)
            both = []
            for adjoint in (False, True):
                planes = adj if adjoint else coeffs
                ok_, _ = self.time_kernel("stencil", lambda: h_apply_kernel(planes, u))
                ms = graph_timed(lambda: h_apply_kernel(planes, u), launches=20)
                both.append(ms)
                plain = apply.h_apply_adjoint if adjoint else apply.h_apply
                op_, plain_ms = timed(lambda: plain(coeffs, u), REPS)
                log(f" K3 apply, {label}, {gsize.ny}^2 x {batch}, "
                    f"adjoint={adjoint}; sha256 {sha256(ok_)}:")
                self.record(name, ok_, op_, ms, plain_ms, stencil_bound)
                log(f"  {nbytes / 1e6:.1f} MB a launch (planes and u in, H u "
                    f"out), {nbytes / ms / 1e9:.3f} TB/s")
            mean = sum(both) / 2
            log(f" K3 {label}: mean of forward and adjoint {mean:.4f} ms, "
                f"{nbytes / mean / 1e9:.3f} TB/s")

        # K5 at the cyclic-reduction path's shape: the level-0 pivot blocks
        # of the 301^2 breast operator (the first 64 x 64 panel of every odd
        # row's tri(D); 150 of them) and a seeded batch of the same shape
        # with a boosted diagonal; then a small ragged case.
        block = 64
        c = fac.coeffs
        odd = slice(1, None, 2)
        level0 = cyclic._btri_dense(c[0, odd], c[1, odd], c[2, odd]
                                    )[:, :block, :block].contiguous()

        def batch_of(n, bsz):
            a = (rng.standard_normal((n, bsz, bsz))
                 + 1j * rng.standard_normal((n, bsz, bsz))) / np.sqrt(bsz)
            return torch.as_tensor((a + 2 * np.eye(bsz)).astype(np.complex64),
                                   device=dev)

        for label, p, name in (
                ("level-0 pivot blocks of the breast operator", level0,
                 "batched_inv"),
                ("seeded random batch", batch_of(level0.shape[0], block),
                 "batched_inv"),
                ("seeded random batch", batch_of(5, 16), "batched_inv_16")):
            n, bsz = p.shape[0], p.shape[1]
            out, _ = self.time_kernel("batched_inv",
                                      lambda: batched_small_inv_kernel(p))
            ms = graph_timed(lambda: batched_small_inv_kernel(p))
            _, plain_ms = timed(lambda: batched_inv._batched_pivot_inv(p), REPS)
            lib, library_ms = timed(lambda: torch.linalg.inv(p), REPS)
            want = batched_inv._batched_pivot_inv(p.to(c128))
            log(f" K5 batched inverse, {label}, ({n}, {bsz}, {bsz}); "
                f"sha256 {sha256(out)}; torch.linalg.inv vs complex128 plain "
                f"{rel_err(lib.to(c128), want):.3e}; kernel vs complex128 plain:")
            # b^3 complex multiply-adds a matrix; the batch in, its inverse out.
            self.record(name, out.to(c128), want, ms, plain_ms,
                        bound(n * CMAC * bsz ** 3, 2 * p.numel() * C64),
                        library_ms)

        self.pivot_inverse_alone(batch_of)
        batches = self.cr_engine(c, b)
        self.k5_by_level(level0, batches, -(-nx // block))
        self.check(not self.bad, f"kernel checks failed: {self.bad}")

    def k5_by_level(self, level0, batches, panels):
        """K5 at each batch the cyclic factorization inverts (one level's
        odd rows, then the root), on the first n level-0 pivot blocks: us a
        launch (50 launches in one CUDA graph), the cycles of a step at the
        card's largest SM clock, the chip-wide bound and the floor of one SM
        (a matrix is one SM's chain: 64^3 complex multiply-adds at 1/132 of
        the FP32 peak, twice that where two matrices share an SM); and the
        sum over one factorization (``panels`` launches a level)."""
        from waveforminversionust_tpu_torch.ops.kernel_inv import batched_small_inv_kernel

        bsz = level0.shape[1]
        mhz = float(nvidia_smi("clocks.max.sm").split()[0])
        one_sm = CMAC * bsz ** 3 / (PEAK_FP32 / SMS) * 1e6
        total = 0.0
        log(f" K5 by level of the {level0.shape[0] * 2 + 1}-row cyclic "
            f"factorization, ({bsz}, {bsz}) blocks, {panels} launches a level:")
        for n in batches:
            p = level0[:n].contiguous()
            us = graph_timed(lambda: batched_small_inv_kernel(p)) * 1e3
            total += panels * us
            chip = bound(n * CMAC * bsz ** 3, 2 * p.numel() * C64)[0] * 1e3
            log(f"  batch {n:3d}: {us:.2f} us ({us * mhz / bsz:.0f} cycles a "
                f"step); bound {chip:.2f} us chip-wide, "
                f"{-(-n // SMS) * one_sm:.2f} us on one SM")
        log(f"  one factorization ({len(batches)} batches x {panels}): "
            f"{total / 1e3:.3f} ms (the first version: 2.2 ms, PERF.md §5)")

    def sweep_yardstick(self, fac, b):
        """K2's yardstick: the same 2 ny - 1 products with full reuse of G
        and no tridiagonal terms, as chained torch.matmul of (nx, nx) x
        (nx, batch) in one CUDA graph."""
        import torch

        n_rhs, ny, nx = b.shape
        steps = 2 * ny - 1
        y = [b[0].T.contiguous(), torch.empty(nx, n_rhs, dtype=b.dtype,
                                              device=b.device)]

        def chain():
            for s in range(steps):
                torch.matmul(fac.g[s if s < ny else 2 * ny - 2 - s],
                             y[s % 2], out=y[1 - s % 2])

        yard_ms = graph_timed(chain, launches=1, replays=REPS)
        log(f" K2 yardstick: {steps} chained torch.matmul ({nx}x{nx}) x "
            f"({nx}x{n_rhs}) complex64 in one CUDA graph: {yard_ms:.3f} ms")

    def sweep_data_shape(self):
        """K2 and K4b at the data phase's shape, where they take other
        instantiations than at 301^2: the forward solve of 256 right-hand
        sides through the 401^2 / 0.6 mm breast operator's factors, against
        the plain sweeps (rel < 1e-5) and its true residual (< 2e-5)."""
        import torch
        from waveforminversionust_tpu_torch.config import SolverConfig
        from waveforminversionust_tpu_torch.models.phantom import breast_phantom
        from waveforminversionust_tpu_torch.ops import (apply, banded,
                                                        kernel_sweep,
                                                        kernel_twisted, twisted)
        from waveforminversionust_tpu_torch.ops.kernel_factor import banded_factor_kernel
        from waveforminversionust_tpu_torch.ops.kernel_sweep import banded_solve_kernel
        from waveforminversionust_tpu_torch.ops.stencil import helmholtz_coefficients

        fine, cfg = data_grid(), SolverConfig()
        vel = torch.as_tensor(breast_phantom(fine), device=self.device)
        coeffs = helmholtz_coefficients(vel, fine, 350e3, cfg.pml, cfg.stencil)
        fac = banded_factor_kernel(coeffs)
        shape = (self.n_tx,) + fine.shape
        rng = np.random.default_rng(1)
        b = torch.as_tensor((rng.standard_normal(shape)
                             + 1j * rng.standard_normal(shape)
                             ).astype(np.complex64), device=self.device)
        ny, nx = fine.shape
        sweep_bound = bound((2 * ny - 1) * CMAC * nx * nx * self.n_tx,
                            (ny * nx * nx + 9 * ny * nx + 2 * b.numel()) * C64)
        xk, ms = timed(lambda: banded_solve_kernel(fac, b), REPS)
        xp, plain_ms = timed(lambda: banded.banded_solve(fac, b), REPS)
        log(f" K2 sweeps at the data phase's shape, {ny}^2, {self.n_tx} RHS, "
            f"forward:")
        self.record("sweep_401", xk, xp, ms, plain_ms, sweep_bound)
        sweep_launch("K2", kernel_sweep.last_launch, 2 * ny - 1, nx, ms)
        res = rel_err(apply.h_apply(coeffs, xk), b)
        log(f"  true relative residual of the kernel solve: {res:.3e}")
        if not res < 2e-5:
            self.bad.append(f"sweep_401 residual {res:.3e} >= 2e-5")
        del fac, xk, xp

        tfac = kernel_twisted.twisted_factor_kernel(coeffs)
        tx, ms = timed(lambda: kernel_twisted.twisted_solve_kernel(tfac, b), REPS)
        tp, plain_ms = timed(lambda: twisted.twisted_solve(tfac, b), REPS)
        log(f" K4b twisted sweeps at the data phase's shape, {ny}^2, "
            f"{self.n_tx} RHS, forward, middle row {tfac.m}:")
        self.record("twisted_sweep_401", tx, tp, ms, plain_ms, sweep_bound)
        sweep_launch("K4b", kernel_twisted.last_sweep_launch, ny, nx, ms)
        res = rel_err(apply.h_apply(coeffs, tx), b)
        log(f"  true relative residual of the kernel solve: {res:.3e}")
        if not res < 2e-5:
            self.bad.append(f"twisted_sweep_401 residual {res:.3e} >= 2e-5")

    def pivot_inverse_alone(self, batch_of):
        """The pivot step of K1 / K4a without a profiler: the blocked
        inverse of csrc/gj_pivot.cuh launched on its own (inv.cu's second
        entry), one block as in K1 and two as in K4a, on a full panel and on
        the ragged last panel of 301; beside it K5 on the same blocks: the
        scalar chain that step ran until the blocked inverse replaced it, in
        its register-tile layout since."""
        import torch
        from waveforminversionust_tpu_torch.ops.kernel_inv import (
            batched_small_inv_kernel, pivot_inverse_kernel)

        for batch, bsz in ((1, 64), (2, 64), (1, 45), (2, 45)):
            p = batch_of(batch, bsz)
            want = torch.linalg.inv(p.to(torch.complex128))
            out = pivot_inverse_kernel(p)
            ms = graph_timed(lambda: pivot_inverse_kernel(p))
            chain_ms = graph_timed(lambda: batched_small_inv_kernel(p))
            rel = rel_err(out.to(torch.complex128), want)
            ok = bool(np.isfinite(rel)) and rel < TOL["pivot_inverse"]
            log(f" pivot inverse alone, ({batch}, {bsz}, {bsz}): blocked "
                f"{ms * 1e3:.2f} us a launch, rel {rel:.3e} (bound "
                f"{TOL['pivot_inverse']:.0e}) {'ok' if ok else 'FAIL'}; "
                f"scalar chain {chain_ms * 1e3:.2f} us")
            if not ok:
                self.bad.append(f"pivot inverse rel {rel:.3e}")

    def cr_engine(self, c, b):
        """The cyclic-reduction engine around K5 (its dense products are
        torch.bmm, outside any kernel): its times, and how exact its FP32
        solves are at this size: bare, after one refinement pass, with
        pivoted LU inverses in place of the Gauss-Jordan ones, and beside
        the same code run in complex128. Returns the batches of K5 one
        factorization launches (a level's odd rows, then the root)."""
        import torch
        from waveforminversionust_tpu_torch.ops import apply, cyclic

        c128 = torch.complex128
        n_rhs, ny, nx = b.shape
        crf, factor_ms = timed(lambda: cyclic.cr_factor(c), 2)
        batches = [lev.dinv.shape[0] for lev in crf.levels] + [1]
        log(f" cyclic reduction at {ny}x{nx}: factorization {factor_ms:.3f} "
            f"ms, {len(crf.levels)} levels; odd rows a level and the root: "
            f"{batches}")
        for adjoint in (False, True):
            op = apply.h_apply_adjoint if adjoint else apply.h_apply
            x, ms = timed(lambda: cyclic.cr_solve(crf, b, adjoint), 2)
            res0 = rel_err(op(c, x), b)
            x = x + cyclic.cr_solve(crf, b - op(c, x), adjoint)
            res1 = rel_err(op(c, x), b)
            log(f"  solve adjoint={adjoint}, {n_rhs} RHS: {ms:.3f} ms; true "
                f"relative residual {res0:.3e}, after one refinement pass "
                f"{res1:.3e}")
            if not (res1 < res0 and res1 < 1e-3):
                self.bad.append(f"cr residual {res0:.3e} -> {res1:.3e}")
        del x
        with mock.patch.object(cyclic, "batched_inv",
                               lambda a, block=64: torch.linalg.inv(a)):
            lu = cyclic.cr_factor(c)
        res_lu = rel_err(apply.h_apply(c, cyclic.cr_solve(lu, b)), b)
        del lu
        few = b[:16].to(c128)
        with plain_engines():  # K5 is complex64 only
            f128 = cyclic.cr_factor(c.to(c128))
        res128 = rel_err(apply.h_apply(c.to(c128), cyclic.cr_solve(f128, few)),
                         few)
        by_level = [rel_err(lev.dinv.to(c128), lev128.dinv)
                    for lev, lev128 in zip(crf.levels, f128.levels)]
        log(f"  with torch.linalg.inv (pivoted LU) for every inverse: residual "
            f"{res_lu:.3e}; the same code in complex128: residual "
            f"{res128:.3e}; the FP32 factor's odd-row inverses against the "
            f"complex128 ones, by level: "
            f"{[float(f'{e:.1e}') for e in by_level]}")
        if not res128 < 1e-9:
            self.bad.append(f"complex128 cr residual {res128:.3e}")
        return batches

    # -- phase 3 --------------------------------------------------------
    def data(self):
        import torch
        from waveforminversionust_tpu_torch.config import SolverConfig
        from waveforminversionust_tpu_torch.data.synthesize import synthesize_ring_dataset
        from waveforminversionust_tpu_torch.models.phantom import breast_phantom

        # bench.py's fallback data: the same ring over a 0.6 mm grid. No
        # device is named: the entry point runs on the card by default.
        fine = data_grid()
        t0 = time.perf_counter()
        self.ds = synthesize_ring_dataset(breast_phantom(fine), fine,
                                          self.acq_config,
                                          f=350e3, solver=SolverConfig(),
                                          seed=0)
        torch.cuda.synchronize()
        rec = self.ds.rec_data
        log(f" synthesized {rec.shape} on {fine.ny}^2 in "
            f"{time.perf_counter() - t0:.2f} s; finite {np.isfinite(rec).all()}")
        self.check(np.isfinite(rec).all() and np.abs(rec).max() > 0,
                   "synthesized data not finite / all zero")

    # -- phase 4 --------------------------------------------------------
    def _setup(self):
        import torch
        from waveforminversionust_tpu_torch.config import FWIConfig
        from waveforminversionust_tpu_torch.fwi.objective import build_fwi_data
        from waveforminversionust_tpu_torch.models.acquisition import build_ring_acquisition

        grid = self.grid
        acq = build_ring_acquisition(grid, self.acq_config, x_elem=self.ds.x_circ,
                                     y_elem=self.ds.y_circ)
        data = build_fwi_data(acq, self.ds.rec_data, self.ds.f)
        self.check(data.src.is_cuda, "build_fwi_data did not default to the card")
        vel0 = torch.full(grid.shape, FWIConfig().c_init, dtype=torch.float32,
                          device=data.src.device)
        return grid, data, vel0

    def run_slice(self, name, factorization, uses, n_iter=N_ITER):
        """One engine's slice: warm-up, then the timed run between a reset
        and a reading of the launch counts. ``uses``: the kernels the path
        must launch; every other kernel must stay at 0."""
        import torch
        from waveforminversionust_tpu_torch.config import FWIConfig, SolverConfig
        from waveforminversionust_tpu_torch.fwi.optimizers import nonlinear_cg
        from waveforminversionust_tpu_torch.fwi.runner import reconstruction_rmse
        from waveforminversionust_tpu_torch.models.grid import Grid2D
        from waveforminversionust_tpu_torch.ops import (kernel_launch_counts,
                                                        reset_kernel_launch_counts)

        grid, data, vel0 = self._setup()
        solver = SolverConfig(refactor_every=2, factorization=factorization)
        fwi = FWIConfig(num_iterations=n_iter)
        t0 = time.perf_counter()
        nonlinear_cg(vel0, data, grid, solver, fwi)
        torch.cuda.synchronize()
        log(f" warm-up run: {time.perf_counter() - t0:.2f} s")
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_launch_counts()
        t0 = time.perf_counter()
        res = nonlinear_cg(vel0, data, grid, solver, fwi)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = kernel_launch_counts()
        peak = torch.cuda.max_memory_allocated()
        loss = res.metrics.loss.cpu().numpy()
        step = res.metrics.step_size.cpu().numpy()
        true_grid = Grid2D.from_arrays(self.ds.x, self.ds.y)
        rmse0 = reconstruction_rmse(vel0.cpu().numpy(), grid, self.ds.c, true_grid)
        rmse = reconstruction_rmse(res.velocity.cpu().numpy(), grid, self.ds.c,
                                   true_grid)
        log(f" s/iter {elapsed / n_iter:.6f} ({n_iter} iterations, "
            f"{elapsed:.4f} s); peak device memory {peak / 2**20:.1f} MiB")
        log(f" loss {loss.tolist()}")
        log(f" rmse start {rmse0:.4f} m/s end {rmse:.4f} m/s")
        log(f" kernel launches in the timed run: {counts}")
        # Where the time goes: each wrapper's calls (launches over its
        # launches per call) times its phase-2 ms per call at these shapes
        # (the sweeps' and the stencil's mean of forward and adjoint).
        est = {k: n / self.per_call[k] * self.kernels[k]["ms"] / 1e3
               for k, n in counts.items()
               if n and self.per_call.get(k) and k in self.kernels}
        if est:
            log(f" kernel seconds estimated from counts x phase-2 ms: "
                f"{ {k: round(v, 4) for k, v in est.items()} }, "
                f"rest {elapsed - sum(est.values()):.4f} s of {elapsed:.4f} s")
        self.slices[name] = dict(
            factorization=factorization, s_per_iter=elapsed / n_iter,
            iterations=n_iter, rmse_start=rmse0, rmse_end=rmse,
            loss=loss.tolist(), step=step.tolist(), launches=counts,
            peak_memory_mib=peak / 2**20, velocity=res.velocity)
        for k, n in counts.items():
            self.launches[k] += n
        self.check(np.all(np.isfinite(loss)) and loss[-1] < loss[0],
                   f"loss not finite or not decreasing: {loss}")
        self.check(rmse < rmse0, f"rmse {rmse} not below the start {rmse0}")
        self.check(all(counts[k] > 0 for k in uses),
                   f"a kernel of this path was not launched: {counts}")
        self.check(all(n == 0 for k, n in counts.items() if k not in uses),
                   f"a kernel of another path was launched: {counts}")

    def slice(self):
        self.run_slice("slice", "auto", ("factor", "sweep", "stencil"))

    def hold(self, what, bounds, loss, loss_ref, step, step_ref, vel, vel_ref):
        """Hold one trajectory to another within ``bounds``; returns the
        failures. ``step`` None: a method without a step history."""
        import torch
        loss, loss_ref = np.asarray(loss), np.asarray(loss_ref)
        dl = float(np.max(np.abs(loss - loss_ref) / np.abs(loss_ref)))
        ds = 0.0 if step is None else float(np.max(
            np.abs(np.asarray(step) - np.asarray(step_ref))
            / np.abs(np.asarray(step_ref))))
        dv = float(torch.max(torch.abs(vel - vel_ref)))
        atol = (bounds["vel_atol"] if bounds["vel_frac"] is None
                else bounds["vel_frac"] * float(torch.max(torch.abs(vel_ref))))
        step_note = ("no step history" if step is None else
                     f"step {ds:.3e} ({bounds['step']:.0e})")
        log(f" {what}: max rel loss difference {dl:.3e} (held to "
            f"{bounds['loss']:.0e}), {step_note}, "
            f"max |velocity difference| {dv:.4e} m/s ({atol:.3f})")
        failed = []
        if not dl <= bounds["loss"]:
            failed.append(f"{what}: loss differs by {dl:.3e}")
        if not ds <= bounds["step"]:
            failed.append(f"{what}: step differs by {ds:.3e}")
        if not dv <= atol:
            failed.append(f"{what}: velocity differs by {dv} m/s > {atol}")
        return failed

    def against_thomas(self, name, bounds, first_loss_rtol=None):
        """Hold an engine's timed trajectory to the block-Thomas slice's."""
        if "slice" not in self.slices:
            log(" no block-Thomas slice in this run: trajectory not compared")
            return
        ref, got = self.slices["slice"], self.slices[name]
        failed = self.hold(f"{name} vs the block-Thomas slice", bounds,
                           got["loss"], ref["loss"], got["step"], ref["step"],
                           got["velocity"], ref["velocity"])
        if first_loss_rtol is not None:
            l0, r0 = got["loss"][0], ref["loss"][0]
            if not abs(l0 - r0) <= first_loss_rtol * abs(r0):
                failed.append(f"first loss {l0} vs {r0} beyond rtol "
                              f"{first_loss_rtol}")
        self.check(not failed, f"{failed}")

    def slice_twisted(self):
        self.run_slice("slice_twisted", "twisted",
                       ("twisted_factor", "twisted_sweep", "stencil"))
        self.against_thomas("slice_twisted", GOLDEN)

    def slice_cr(self):
        # Memory, reckoned before the run: a level keeps five block arrays,
        # about 750 blocks of 301^2 complex64 at level 0 and as many again
        # over the deeper levels, ~1.1 GB a factor; the frozen-factor CG
        # holds one, the new one beside it while it is built.
        self.run_slice("slice_cr", "cr", ("batched_inv", "stencil"))
        self.against_thomas("slice_cr", CR_BOUNDS, first_loss_rtol=1e-3)

    # -- phase 5 --------------------------------------------------------
    def parity(self):
        from waveforminversionust_tpu_torch.config import FWIConfig, SolverConfig
        from waveforminversionust_tpu_torch.fwi.optimizers import nonlinear_cg

        grid, data, vel0 = self._setup()
        fwi = FWIConfig(num_iterations=2)
        failed = []
        for engine, plain_mode, bounds in (("auto", "thomas", GOLDEN),
                                           ("twisted", "twisted", GOLDEN),
                                           ("cr", "cr", CR_BOUNDS)):
            kern = nonlinear_cg(vel0, data, grid,
                                SolverConfig(refactor_every=2,
                                             factorization=engine), fwi)
            with plain_engines():
                plain = nonlinear_cg(
                    vel0, data, grid,
                    SolverConfig(refactor_every=2, factorization=plain_mode,
                                 fused_apply="off"), fwi)
            lk, lp = kern.metrics.loss.cpu().numpy(), plain.metrics.loss.cpu().numpy()
            sk = kern.metrics.step_size.cpu().numpy()
            sp = plain.metrics.step_size.cpu().numpy()
            log(f" {engine}: loss kernel {lk.tolist()} plain {lp.tolist()}")
            log(f" {engine}: step kernel {sk.tolist()} plain {sp.tolist()}")
            failed += self.hold(f"{engine}, kernel path vs plain path", bounds,
                                lk, lp, sk, sp, kern.velocity, plain.velocity)
        self.check(not failed, f"parity failed: {failed}")

    # -- phase 6 --------------------------------------------------------
    def intake(self):
        """bench.py::bench_intake on the data phase's dataset, through the
        entry points a user calls, none of them told a device."""
        import torch
        from waveforminversionust_tpu_torch import (AcquisitionConfig,
                                                    FWIConfig, SolverConfig,
                                                    calibrate_background_speed,
                                                    compensate_reciprocity,
                                                    invert_dataset, qc_report)
        from waveforminversionust_tpu_torch.fwi.calibrate import background_misfit_fn
        from waveforminversionust_tpu_torch.fwi.objective import build_fwi_data
        from waveforminversionust_tpu_torch.fwi.runner import reconstruction_rmse
        from waveforminversionust_tpu_torch.models.acquisition import build_ring_acquisition
        from waveforminversionust_tpu_torch.models.grid import Grid2D
        from waveforminversionust_tpu_torch.ops import (kernel_launch_counts,
                                                        reset_kernel_launch_counts)

        grid = self.grid
        t0 = time.perf_counter()
        rep = qc_report(self.ds.rec_data, exclude_each_side=31)
        ds = self.ds._replace(rec_data=compensate_reciprocity(
            self.ds.rec_data, rep.ratios))
        log(f" qc: asymmetry raw {rep.asymmetry_raw:.4e} compensated "
            f"{rep.asymmetry_compensated:.4e}; flagged channels "
            f"{rep.bad_elements.tolist()} ({time.perf_counter() - t0:.2f} s "
            f"on the host)")

        search = dict(c_min=1400.0, c_max=1600.0, num=9, levels=2)
        cal_acq = AcquisitionConfig(tx_downsample=16)
        calibrate_background_speed(ds, grid=grid, acquisition=cal_acq,
                                   **dict(search, levels=1, num=3))  # warm-up
        torch.cuda.synchronize()
        reset_kernel_launch_counts()
        t0 = time.perf_counter()
        cal = calibrate_background_speed(ds, grid=grid, acquisition=cal_acq,
                                         **search)
        torch.cuda.synchronize()
        cal_s = time.perf_counter() - t0
        cal_counts = kernel_launch_counts()
        n_cand = len(cal.candidates)
        log(f" calibration: {cal_s:.4f} s, {cal_s / n_cand * 1e3:.2f} ms a "
            f"candidate ({n_cand}); c0 {cal.c0:.4f} m/s, best candidate "
            f"{cal.c_grid_best:.4f}; launches {cal_counts}")
        pairs = [(round(float(c), 4), float(f"{j:.6e}"))
                 for c, j in zip(cal.candidates, cal.misfits)]
        log(f" (c, J): {pairs}")
        last_step = 2 * (search["c_max"] - search["c_min"]) / (search["num"] - 1) ** 2
        self.check(search["c_min"] <= cal.c0 <= search["c_max"]
                   and abs(cal.c0 - cal.c_grid_best) <= last_step,
                   f"c0 {cal.c0} outside [1400, 1600] or more than "
                   f"{last_step} from {cal.c_grid_best}")

        # The plain path's misfits at the same 18 speeds.
        acq = build_ring_acquisition(grid, cal_acq, x_elem=ds.x_circ,
                                     y_elem=ds.y_circ)
        data = build_fwi_data(acq, ds.rec_data, ds.f)
        with plain_engines():
            J = background_misfit_fn(data, grid, SolverConfig(
                factorization="thomas", fused_apply="off"))
            t0 = time.perf_counter()
            plain = np.array([float(J(c)) for c in cal.candidates])
            plain_s = time.perf_counter() - t0
        drift = float(np.max(np.abs(cal.misfits - plain) / np.abs(plain)))
        log(f" calibration misfits, kernel path vs plain path at the same "
            f"speeds: max rel {drift:.3e} (held to {CAL_RTOL:.0e}); plain "
            f"path {plain_s / n_cand * 1e3:.1f} ms a candidate")
        self.check(drift <= CAL_RTOL, f"calibration misfits differ by {drift}")

        acq_cfg = AcquisitionConfig(interpolation="bilinear")

        def run(n_iter, **kw):
            return invert_dataset(
                ds, grid=grid, acquisition=acq_cfg,
                fwi=FWIConfig(num_iterations=n_iter,
                              precondition="illumination"),
                c_init=cal.c0, **kw)

        t0 = time.perf_counter()
        run(N_ITER)
        torch.cuda.synchronize()
        log(f" warm-up inversion: {time.perf_counter() - t0:.2f} s")
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_launch_counts()
        t0 = time.perf_counter()
        res = run(N_ITER)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = kernel_launch_counts()
        peak = torch.cuda.max_memory_allocated()
        loss, step = res.metrics["loss"], res.metrics["step_size"]
        true_grid = Grid2D.from_arrays(ds.x, ds.y)
        rmse0 = reconstruction_rmse(np.full(grid.shape, cal.c0), grid, ds.c,
                                    true_grid)
        rmse = reconstruction_rmse(res.velocity, grid, ds.c, true_grid)
        log(f" s/iter {elapsed / N_ITER:.6f} ({N_ITER} iterations, "
            f"{elapsed:.4f} s); peak device memory {peak / 2**20:.1f} MiB")
        log(f" loss {loss.tolist()}")
        log(f" rmse start {rmse0:.4f} m/s end {rmse:.4f} m/s; the main "
            f"slice's end: "
            f"{self.slices['slice']['rmse_end'] if 'slice' in self.slices else 'not run'}")
        log(f" kernel launches in the timed run: {counts}")
        self.slices["intake"] = dict(
            calibration_s=cal_s, c0=cal.c0, c_grid_best=cal.c_grid_best,
            calibration_launches=cal_counts, s_per_iter=elapsed / N_ITER,
            iterations=N_ITER, rmse_start=rmse0, rmse_end=rmse,
            loss=loss.tolist(), step=step.tolist(), launches=counts,
            peak_memory_mib=peak / 2**20)
        for k in KERNELS:
            self.launches[k] += counts[k] + cal_counts[k]
        self.check(np.all(np.isfinite(loss)) and loss[-1] < loss[0],
                   f"loss not finite or not decreasing: {loss}")
        self.check(rmse < rmse0, f"rmse {rmse} not below the start {rmse0}")
        for c in (cal_counts, counts):
            self.check(c["factor"] > 0 and c["sweep"] > 0,
                       f"factor or sweep not launched: {c}")
            self.check(all(c[k] == 0 for k in ("twisted_factor",
                                               "twisted_sweep", "batched_inv")),
                       f"a kernel of another engine was launched: {c}")

        kern = run(2)
        with plain_engines():
            plain = run(2, solver=SolverConfig(factorization="thomas",
                                               fused_apply="off"))
        failed = self.hold("intake, kernel path vs plain path", GOLDEN,
                           kern.metrics["loss"], plain.metrics["loss"],
                           kern.metrics["step_size"], plain.metrics["step_size"],
                           torch.as_tensor(kern.velocity),
                           torch.as_tensor(plain.velocity))
        self.check(not failed, f"{failed}")

    def recordings(self):
        """{300 kHz, 350 kHz: dataset}: the data phase's recording and one
        at 300 kHz over the same phantom and ring, synthesized once."""
        if not hasattr(self, "recs"):
            from waveforminversionust_tpu_torch import synthesize_ring_dataset
            from waveforminversionust_tpu_torch.models.phantom import breast_phantom
            fine = data_grid()
            t0 = time.perf_counter()
            ds300 = synthesize_ring_dataset(breast_phantom(fine), fine,
                                            self.acq_config, f=300e3, seed=0)
            log(f" synthesized the 300 kHz recording in "
                f"{time.perf_counter() - t0:.2f} s")
            self.recs = {300e3: ds300, 350e3: self.ds}
        return self.recs

    # -- phase 7 --------------------------------------------------------
    def runner(self):
        """invert_dataset's continuation, receiver calibration, chunked
        checkpoints, live callback and resume at the main path's size."""
        import tempfile

        import torch
        from waveforminversionust_tpu_torch import (ContinuationConfig,
                                                    FWIConfig, SolverConfig,
                                                    invert_dataset)
        from waveforminversionust_tpu_torch.fwi.runner import reconstruction_rmse
        from waveforminversionust_tpu_torch.models.grid import Grid2D
        from waveforminversionust_tpu_torch.ops import (kernel_launch_counts,
                                                        reset_kernel_launch_counts)
        from waveforminversionust_tpu_torch.utils import checkpoint

        grid = self.grid
        recs = self.recordings()
        freqs = (300e3, 350e3)
        solver = SolverConfig(refactor_every=2)
        seen, ends = [], []

        def live(stage, f, it, vel, m):
            seen.append((stage, f, it))

        def stage_done(stage, f, vel, m):
            ends.append(time.perf_counter())

        with tempfile.TemporaryDirectory() as tmp:
            reset_kernel_launch_counts()
            t0 = time.perf_counter()
            res = invert_dataset(
                recs, grid=grid, solver=solver,
                continuation=ContinuationConfig(frequencies=freqs,
                                                iterations_per_frequency=3),
                receiver_calibration=True, checkpoint_dir=tmp,
                checkpoint_every=2, live_every=2, live_callback=live,
                callback=stage_done)
            torch.cuda.synchronize()
            counts = kernel_launch_counts()
            st = checkpoint.load_state(f"{tmp}/latest")
        stage_s = np.diff([t0] + ends)
        loss = res.metrics["loss"]
        true_grid = Grid2D.from_arrays(self.ds.x, self.ds.y)
        rmse0 = reconstruction_rmse(np.full(grid.shape, FWIConfig().c_init),
                                    grid, self.ds.c, true_grid)
        rmse = reconstruction_rmse(res.velocity, grid, self.ds.c, true_grid)
        log(f" continuation {freqs}: stage seconds {stage_s.tolist()}; loss "
            f"{loss.tolist()}; rmse start {rmse0:.4f} end {rmse:.4f} m/s")
        log(f" live callbacks {seen}; launches {counts}")
        self.slices["runner"] = dict(stage_s=stage_s.tolist(),
                                     loss=loss.tolist(), rmse_start=rmse0,
                                     rmse_end=rmse, launches=counts)
        for k in KERNELS:
            self.launches[k] += counts[k]
        self.check(seen == [(0, 300e3, 2), (0, 300e3, 3), (1, 350e3, 2),
                            (1, 350e3, 3)], f"live callbacks {seen}")
        self.check(len(ends) == 2, f"stage callbacks {len(ends)}")
        self.check((int(st["stage"]), int(st["iteration"])) == (1, 3),
                   f"last checkpoint at {int(st['stage'])}, {int(st['iteration'])}")
        self.check(np.all(np.isfinite(loss)) and loss[2] < loss[0]
                   and loss[5] < loss[3], f"stage losses not decreasing: {loss}")
        self.check(rmse < rmse0, f"rmse {rmse} not below the start {rmse0}")
        self.check(all(counts[k] > 0 for k in ("factor", "sweep", "stencil"))
                   and all(counts[k] == 0 for k in ("twisted_factor",
                                                    "twisted_sweep",
                                                    "batched_inv")),
                   f"launches {counts}")

        # tests/test_fwi.py's kill and resume, at this size.
        kw = dict(grid=grid, solver=solver, fwi=FWIConfig(num_iterations=4))
        full = invert_dataset(self.ds, **kw)
        save = checkpoint.save_state

        class Killed(Exception):
            pass

        def dying_save(path, state):
            save(path, state)
            raise Killed

        with tempfile.TemporaryDirectory() as tmp:
            with mock.patch.object(checkpoint, "save_state", dying_save):
                try:
                    invert_dataset(self.ds, checkpoint_dir=tmp,
                                   checkpoint_every=2, **kw)
                    killed = False
                except Killed:
                    killed = True
            t0 = time.perf_counter()
            resumed = invert_dataset(self.ds, resume_from=f"{tmp}/latest", **kw)
            resume_s = time.perf_counter() - t0
        self.check(killed, "the run was not killed")
        log(f" resumed the last 2 of 4 iterations in {resume_s:.2f} s")
        failed = self.hold("resumed vs uninterrupted", GOLDEN,
                           resumed.metrics["loss"], full.metrics["loss"],
                           resumed.metrics["step_size"],
                           full.metrics["step_size"],
                           torch.as_tensor(resumed.velocity),
                           torch.as_tensor(full.velocity))
        self.check(not failed, f"{failed}")

    # -- phases 8-10 ----------------------------------------------------
    def run_method(self, name, method, dataset, n_iter, uses,
                   timed=contextlib.nullcontext, warmup=True,
                   rmse_must_fall=True, **kw):
        """invert_dataset(method=...) with no device named, at the main
        path's grid from 1480 m/s: a 1-iteration warm-up (unless
        ``warmup`` is false: the iterative solvers' runs are seconds long),
        then the timed run of ``n_iter`` (inside the context ``timed()``)
        between a reset and a reading of the launch counts. ``uses``: the
        kernels it must launch, every other at 0; the RMSE must fall below
        the start's when ``rmse_must_fall``. Returns (result, seconds,
        counts)."""
        import torch
        from waveforminversionust_tpu_torch import FWIConfig, invert_dataset
        from waveforminversionust_tpu_torch.fwi.runner import reconstruction_rmse
        from waveforminversionust_tpu_torch.models.grid import Grid2D
        from waveforminversionust_tpu_torch.ops import (kernel_launch_counts,
                                                        reset_kernel_launch_counts)

        def run(n):
            return invert_dataset(dataset, grid=self.grid,
                                  fwi=FWIConfig(num_iterations=n),
                                  method=method, **kw)

        if warmup:
            t0 = time.perf_counter()
            run(1)
            torch.cuda.synchronize()
            log(f" warm-up run (1 iteration): "
                f"{time.perf_counter() - t0:.2f} s")
        with timed():
            torch.cuda.reset_peak_memory_stats()
            reset_kernel_launch_counts()
            t0 = time.perf_counter()
            res = run(n_iter)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            counts = kernel_launch_counts()
        peak = torch.cuda.max_memory_allocated()
        loss = res.metrics["loss"]
        true_grid = Grid2D.from_arrays(self.ds.x, self.ds.y)
        rmse0 = reconstruction_rmse(np.full(self.grid.shape, FWIConfig().c_init),
                                    self.grid, self.ds.c, true_grid)
        rmse = reconstruction_rmse(res.velocity, self.grid, self.ds.c, true_grid)
        log(f" s/iter {elapsed / n_iter:.6f} ({n_iter} iterations, "
            f"{elapsed:.4f} s); peak device memory {peak / 2**20:.1f} MiB")
        log(f" loss {loss.tolist()}")
        log(f" rmse start {rmse0:.4f} m/s end {rmse:.4f} m/s")
        log(f" kernel launches in the timed run: {counts}")
        self.slices[name] = dict(method=method, s_per_iter=elapsed / n_iter,
                                 iterations=n_iter, rmse_start=rmse0,
                                 rmse_end=rmse, loss=loss.tolist(),
                                 launches=counts,
                                 peak_memory_mib=peak / 2**20)
        for k in KERNELS:
            self.launches[k] += counts[k]
        self.check(np.all(np.isfinite(loss)), f"loss not finite: {loss}")
        if rmse_must_fall:
            self.check(rmse < rmse0,
                       f"rmse {rmse} not below the start {rmse0}")
        self.check(all(counts[k] > 0 for k in uses)
                   and all(n == 0 for k, n in counts.items() if k not in uses),
                   f"launches {counts}: the path's kernels {uses} only")
        return res, elapsed, counts

    def kernel_vs_plain(self, what, fn, bounds):
        """Hold fn(solver) through the kernels against fn(plain solver) on
        the same CUDA tensors: (loss, step or None, velocity) each."""
        import torch
        from waveforminversionust_tpu_torch.config import SolverConfig
        lk, sk, vk = fn(SolverConfig())
        with plain_engines():
            lp, sp, vp = fn(SolverConfig(factorization="thomas",
                                         fused_apply="off"))
        log(f" {what}: loss kernel {np.asarray(lk).tolist()} plain "
            f"{np.asarray(lp).tolist()}")
        failed = self.hold(what, bounds, lk, lp, sk, sp, torch.as_tensor(vk),
                           torch.as_tensor(vp))
        self.check(not failed, f"{failed}")

    def lbfgs(self):
        """invert_dataset(method="lbfgs"): 5 iterations, memory 10, over
        the differentiable solve (K1, K2 forward, K2 adjoint in the
        backward, K3 for the residual diagnostic)."""
        import torch
        from waveforminversionust_tpu_torch import FWIConfig, invert_dataset
        from waveforminversionust_tpu_torch.config import SolverConfig
        from waveforminversionust_tpu_torch.fwi import lbfgs

        grid, data, vel0 = self._setup()
        calls = []
        real = lbfgs.fwi_loss

        def counted(*a, **k):
            calls.append(1)
            return real(*a, **k)

        n_iter = 5
        self.run_method("lbfgs", "lbfgs", self.ds, n_iter,
                        ("factor", "sweep", "stencil"),
                        timed=lambda: mock.patch.object(lbfgs, "fwi_loss",
                                                        counted))
        evals = len(calls)
        log(f" value-and-grad evaluations: {evals} in {n_iter} iterations "
            f"({evals / n_iter:.2f} an iteration, one at each iteration's "
            f"start and one a line-search trial)")
        self.slices["lbfgs"]["evaluations"] = evals
        loss = np.asarray(self.slices["lbfgs"]["loss"])
        self.check(loss[-1] < loss[0], f"loss not decreasing: {loss}")

        # The normalized objective of run_lbfgs in dimensionless slowness.
        slow0 = (1.0 / vel0).reshape(-1)
        slow_ref = torch.mean(slow0)
        norm = 0.5 * torch.sum(torch.abs(data.rec_obs) ** 2)

        def objective(solver):
            return lambda p: real(p * slow_ref, data, grid, solver) / norm

        p0 = slow0 / slow_ref
        t0 = time.perf_counter()
        value, g = lbfgs._value_and_grad(objective(SolverConfig()), p0)
        torch.cuda.synchronize()
        grad_ms = (time.perf_counter() - t0) * 1e3
        with plain_engines():
            t0 = time.perf_counter()
            value_p, g_p = lbfgs._value_and_grad(objective(SolverConfig(
                factorization="thomas", fused_apply="off")), p0)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        rel = rel_err(g, g_p)
        log(f" first value and gradient: kernel path {grad_ms:.1f} ms, plain "
            f"path {plain_ms:.1f} ms; gradient rel {rel:.3e} (held to 1e-4), "
            f"value {float(value):.6e} vs {float(value_p):.6e}")
        self.check(rel < 1e-4, f"first gradient differs by {rel}")

        # A central difference along a smooth bump inside the ring against
        # <g, dp> (tests/test_adjoint_vjp.py:59: rel 0.12).
        X, Y = grid.meshgrid()
        dp = torch.as_tensor(np.exp(-((X - 0.01) ** 2 + (Y + 0.02) ** 2)
                                    / (2 * 0.015 ** 2)).astype(np.float32),
                             device=p0.device).reshape(-1)
        eps = 1e-3
        f = objective(SolverConfig())
        with torch.no_grad():
            fd = float(f(p0 + eps * dp) - f(p0 - eps * dp)) / (2 * eps)
        got = float(torch.dot(g, dp))
        log(f" directional derivative: <g, dp> {got:.6e}, central "
            f"difference {fd:.6e} (eps {eps}), rel {abs(got - fd) / abs(fd):.3e} "
            f"(held to 0.12)")
        self.check(abs(got - fd) <= 0.12 * abs(fd), f"<g, dp> {got} vs {fd}")

        def two(solver):
            r = invert_dataset(self.ds, grid=grid, solver=solver,
                               fwi=FWIConfig(num_iterations=2), method="lbfgs")
            return r.metrics["loss"], None, r.velocity

        self.kernel_vs_plain("lbfgs, 2 iterations, kernel path vs plain path",
                             two, GOLDEN)

    def gn(self):
        """invert_dataset(method="gn"): 3 outer iterations of 8 inner (K1
        an outer iteration and a trial, K2 for every J and J^H; no K3 at
        refine=0)."""
        import torch
        from waveforminversionust_tpu_torch import FWIConfig, invert_dataset
        from waveforminversionust_tpu_torch.config import SolverConfig
        from waveforminversionust_tpu_torch.fwi import newton
        from waveforminversionust_tpu_torch.ops.solve import (
            helmholtz_operator_solve, make_helmholtz_operator)

        stages = []
        n_iter = 3
        _, elapsed, _ = self.run_method(
            "gn", "gn", self.ds, n_iter, ("factor", "sweep"),
            callback=lambda i, f, v, m: stages.append(m))
        m = stages[-1]
        loss = np.asarray(m.loss)
        log(f" s per outer iteration {elapsed / n_iter:.6f}; backtracks "
            f"{m.backtracks.tolist()}; cg_relres {m.cg_relres.tolist()}; "
            f"step {m.step_size.tolist()}")
        self.slices["gn"].update(backtracks=m.backtracks.tolist(),
                                 cg_relres=m.cg_relres.tolist())
        self.check(np.all(np.diff(loss) <= 1e-6 * loss[0]),
                   f"losses not monotone: {loss}")

        # The adjoint identity of the Frechet pair at the start, on the
        # normalized data as run_gauss_newton sees it.
        grid, data, vel0 = self._setup()
        s_d = newton._data_normalization(data.rec_obs)
        data = data._replace(src=data.src * s_d, rec_obs=data.rec_obs * s_d)
        solver = SolverConfig()
        op = make_helmholtz_operator(vel0, data.f, grid, solver)
        wv = helmholtz_operator_solve(op, data.src, grid, solver)
        jv, jt, _ = newton.make_frechet_operators(op, data, grid, solver,
                                                  1.0 / vel0, wv)
        rng = np.random.default_rng(3)
        dm = torch.as_tensor(rng.standard_normal(grid.shape).astype(np.float32),
                             device=vel0.device)
        r = torch.as_tensor((rng.standard_normal(data.rec_obs.shape)
                             + 1j * rng.standard_normal(data.rec_obs.shape)
                             ).astype(np.complex64), device=vel0.device)
        jdm = jv(dm)
        lhs = float(torch.sum(jdm.real * r.real + jdm.imag * r.imag))
        rhs = float(torch.sum(dm * jt(r)))
        rel = abs(lhs - rhs) / abs(rhs)
        log(f" <J dm, r> {lhs:.8e} vs <dm, J^H r> {rhs:.8e}: rel {rel:.3e} "
            f"(held to 1e-4)")
        self.check(rel < 1e-4, f"adjoint identity off by {rel}")
        del op, wv, jv, jt

        def one(solver):
            r = invert_dataset(self.ds, grid=grid, solver=solver,
                               fwi=FWIConfig(num_iterations=1), method="gn")
            return r.metrics["loss"], None, r.velocity

        self.kernel_vs_plain("gn, 1 outer iteration, kernel path vs plain "
                             "path", one, GOLDEN)

    def multifreq(self):
        """invert_dataset(method="joint-multifreq") over {300, 350 kHz}: two
        K1 and three K2 a frequency an iteration, no K3 at refine=0."""
        from waveforminversionust_tpu_torch import FWIConfig, invert_dataset
        from waveforminversionust_tpu_torch.ops import (kernel_factor,
                                                        kernel_launch_counts,
                                                        reset_kernel_launch_counts)
        from waveforminversionust_tpu_torch.ops.stencil import helmholtz_coefficients

        recs = self.recordings()
        grid, _, vel0 = self._setup()
        reset_kernel_launch_counts()
        kernel_factor.banded_factor_kernel(helmholtz_coefficients(vel0, grid,
                                                                  350e3))
        per_factor = kernel_launch_counts()["factor"]
        n_iter, nf = 3, len(recs)
        res, _, counts = self.run_method("multifreq", "joint-multifreq", recs,
                                         n_iter, ("factor", "sweep"))
        loss = res.metrics["loss"]
        self.check(res.frequencies == (300e3, 350e3),
                   f"frequencies {res.frequencies}")
        self.check(loss[-1] < loss[0], f"loss not decreasing: {loss}")
        want = 2 * nf * n_iter * per_factor
        log(f" factor launches {counts['factor']} (2 factorizations x {nf} "
            f"frequencies x {n_iter} iterations x {per_factor} = {want}); "
            f"sweeps {counts['sweep']}")
        self.check(counts["factor"] == want, f"factor launches {counts}")

        def two(solver):
            r = invert_dataset(recs, grid=grid, solver=solver,
                               fwi=FWIConfig(num_iterations=2),
                               method="joint-multifreq")
            return r.metrics["loss"], r.metrics["step_size"], r.velocity

        self.kernel_vs_plain("joint-multifreq, 2 iterations, kernel path vs "
                             "plain path", two, GOLDEN)

    # -- phases 11-13 ---------------------------------------------------
    @contextlib.contextmanager
    def recorded(self, module, name, out, read):
        """Patch ``module.name`` so that every call appends ``read(result)``
        to ``out`` (the solves' matvecs and residuals)."""
        real = getattr(module, name)

        def wrapper(*a, **k):
            res = real(*a, **k)
            out.append(read(res))
            return res

        with mock.patch.object(module, name, wrapper):
            yield

    def gmres(self):
        """GMRES on the 9-point system, every matvec K3: 2 CG iterations
        through invert_dataset with the defaults (tol 1e-5, cap 1000,
        shift 0.5); one forward operator solve two-level (a 151^2 coarse
        factor, K1, and a K2 coarse solve every preconditioner application)
        beside the one-level one at the same matvec count; then two cycles
        of each, kernel path against fused_apply="off"."""
        import torch
        from waveforminversionust_tpu_torch.config import (SolverConfig,
                                                           SolverMethod)
        from waveforminversionust_tpu_torch.ops import (kernel_launch_counts,
                                                        reset_kernel_launch_counts,
                                                        solve)

        def read(res):
            rel = res.rel_residual
            return (res.iterations, float(rel.max()), float(rel.median()))

        solves = []
        gm = SolverConfig(method=SolverMethod.GMRES)
        with self.recorded(solve, "gmres", solves, read):
            self.run_method("gmres", "cg", self.ds, 2, ("stencil",),
                            warmup=False, rmse_must_fall=False, solver=gm)
        log(f" solves (matvecs, max and median relative residual): {solves}")
        self.slices["gmres"]["solves"] = solves

        grid, data, vel0 = self._setup()
        two = SolverConfig(method=SolverMethod.GMRES, gmres_two_level=True)
        reset_kernel_launch_counts()
        solve._coarse_factor(vel0, data.f, grid, two)
        per_factor = kernel_launch_counts()["factor"]
        self.coarse_kernels(vel0, data, grid, two)
        runs = {}
        for label, cfg in (("two-level", two), ("one-level", None)):
            if cfg is None:  # the one-level solve at the same matvec count
                cfg = SolverConfig(method=SolverMethod.GMRES,
                                   maxiter=runs["two-level"]["matvecs"])
            out = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_kernel_launch_counts()
            t0 = time.perf_counter()
            with self.recorded(solve, "gmres", out, read):
                op = solve.make_helmholtz_operator(vel0, data.f, grid, cfg)
                solve.helmholtz_operator_solve(op, data.src, grid, cfg)
            torch.cuda.synchronize()
            counts = kernel_launch_counts()
            matvecs, rmax, rmed = out[0]
            runs[label] = dict(seconds=time.perf_counter() - t0,
                               matvecs=matvecs, rel_residual_max=rmax,
                               rel_residual_median=rmed, launches=counts,
                               peak_memory_mib=torch.cuda.max_memory_allocated()
                               / 2**20)
            log(f" {label} forward operator solve, {self.n_tx} RHS: "
                f"{runs[label]}")
            del op
        counts = runs["two-level"]["launches"]
        for k in KERNELS:
            self.launches[k] += counts[k]
        self.slices["gmres"]["operator_solves"] = runs
        self.check(counts["factor"] == per_factor and counts["sweep"] > 0
                   and counts["stencil"] > 0,
                   f"two-level launches {counts}: factor must be one 151^2 "
                   f"factorization's {per_factor}")

        failed = []
        for level in (False, True):
            out, fields = [], []
            for fused in ("auto", "off"):
                cfg = SolverConfig(method=SolverMethod.GMRES, maxiter=34,
                                   gmres_two_level=level, fused_apply=fused)
                with self.recorded(solve, "gmres", out, read):
                    op = solve.make_helmholtz_operator(vel0, data.f, grid, cfg)
                    fields.append(solve.helmholtz_operator_solve(
                        op, data.src, grid, cfg))
            rel = rel_err(fields[0], fields[1])
            log(f" two cycles, {'two' if level else 'one'}-level, kernel vs "
                f"plain apply: matvecs {out[0][0]} / {out[1][0]}, iterates "
                f"rel {rel:.3e} (held to 1e-4)")
            if not (out[0][0] == out[1][0] and rel < 1e-4):
                failed.append(f"two-level={level}: {out}, rel {rel}")
            del fields, op
        self.check(not failed, f"GMRES parity failed: {failed}")

    def coarse_kernels(self, vel0, data, grid, cfg):
        """K1 and K2 at the two-level preconditioner's 151^2 coarse width:
        the coarse factor against the plain factor in complex128, and one
        256-RHS coarse solve, forward and adjoint, of the restricted
        sources against the plain sweeps (the kernels phase's bounds)."""
        import torch
        from waveforminversionust_tpu_torch.ops import banded, preconditioner, solve
        from waveforminversionust_tpu_torch.ops.kernel_sweep import banded_solve_kernel

        failed_before = len(self.bad)
        fac, ms = timed(lambda: solve._coarse_factor(vel0, data.f, grid, cfg),
                        REPS)
        coeffs = fac.coeffs
        fp, plain_ms = host_timed(lambda: banded.banded_factor(coeffs))
        ny, nx = coeffs.shape[1:]
        g64 = banded.banded_factor(coeffs.to(torch.complex128)).g
        log(f" K1 on the {ny}^2 coarse operator; kernel vs complex128 plain:")
        self.record("factor_151", fac.g.to(torch.complex128), g64, ms,
                    plain_ms, bound(ny * CMAC * nx ** 3,
                                    (9 * ny * nx + ny * nx * nx) * C64))
        del g64, fp
        b = preconditioner._restrict_axis(
            preconditioner._restrict_axis(data.src, -2), -1).contiguous()
        for adjoint in (False, True):
            xk, ms = timed(lambda: banded_solve_kernel(fac, b, adjoint), REPS)
            xp, plain_ms = timed(lambda: banded.banded_solve(fac, b, adjoint),
                                 REPS)
            log(f" K2 on the coarse factor, adjoint={adjoint}, "
                f"{b.shape[0]} RHS:")
            self.record("sweep_151", xk, xp, ms, plain_ms, bound(
                (2 * ny - 1) * CMAC * nx * nx * b.shape[0],
                (ny * nx * nx + 9 * ny * nx + 2 * b.numel()) * C64))
        self.check(len(self.bad) == failed_before,
                   f"coarse kernel checks failed: {self.bad[failed_before:]}")

    def born(self):
        """The convergent Born series (GMRES on its system, the default):
        2 CG iterations through invert_dataset; FFTs only, no kernel."""
        import torch
        from waveforminversionust_tpu_torch.config import (SolverConfig,
                                                           SolverMethod)
        from waveforminversionust_tpu_torch.ops import born, solve

        matvecs = []
        cfg = SolverConfig(method=SolverMethod.BORN)
        with self.recorded(solve, "born_gmres_solve", matvecs,
                           lambda res: res[1]):
            self.run_method("born", "cg", self.ds, 2, (), warmup=False,
                            rmse_must_fall=False, solver=cfg)
        grid, data, vel0 = self._setup()
        greens, *_ = born.born_operator(vel0, data.f, grid, cfg.born_pml)
        rng = np.random.default_rng(7)
        shape = (self.n_tx,) + grid.shape
        w = torch.as_tensor((rng.standard_normal(shape)
                             + 1j * rng.standard_normal(shape)
                             ).astype(np.complex64), device=self.device)
        _, fft_ms = timed(lambda: greens(w), REPS)
        log(f" matvecs a solve {matvecs}; one FFT pair of the Green's "
            f"operator over {self.n_tx} x {grid.ny}^2: {fft_ms:.3f} ms")
        self.slices["born"].update(matvecs=matvecs, fft_pair_ms=fft_ms)

    def comb_2d(self):
        """The broadband traces of the JAX CLI's workflow (cli.py:280-297)
        with the main path's 256-element ring snapped to the 301^2 grid:
        the breast phantom at 401^2 / 0.6 mm, the 150-350 kHz comb in 25 kHz
        steps, seed 0; made once and kept for the traveltime phase."""
        if "2d" not in self.combs:
            from waveforminversionust_tpu_torch.data import timedomain
            from waveforminversionust_tpu_torch.models.acquisition import (
                ring_positions, snap_to_grid)
            from waveforminversionust_tpu_torch.models.phantom import breast_phantom
            coarse, fine, acq = self.grid, data_grid(), self.acq_config
            xi, yi = snap_to_grid(coarse, *ring_positions(acq.num_elements,
                                                          acq.radius))
            self.combs["2d"] = timedomain.synthesize_time_domain_dataset(
                breast_phantom(fine), fine, acq, f_low=150e3, f_high=350e3,
                df=25e3, seed=0, x_elem=coarse.x[xi], y_elem=coarse.y[yi])
        return self.combs["2d"]

    def broadband(self):
        """The JAX CLI's broadband workflow (cli.py:264-330) through the
        port's functions, with the main path's 256-element ring: traces over
        the 150-350 kHz comb in 25 kHz steps at 401^2 / 0.6 mm (one K1 and
        one K2 a line), the direct-arrival gate, extraction at 150, 250
        and 350 kHz without deconvolution, then a continuation of 5 CG
        iterations a frequency at 301^2 from 1480 m/s."""
        import torch
        from waveforminversionust_tpu_torch import (ContinuationConfig,
                                                    FWIConfig, invert_dataset)
        from waveforminversionust_tpu_torch.data import timedomain
        from waveforminversionust_tpu_torch.fwi.runner import reconstruction_rmse
        from waveforminversionust_tpu_torch.models.grid import Grid2D
        from waveforminversionust_tpu_torch.ops import (kernel_factor,
                                                        kernel_launch_counts,
                                                        reset_kernel_launch_counts)
        from waveforminversionust_tpu_torch.ops.stencil import helmholtz_coefficients

        coarse, fine = self.grid, data_grid()
        acq = self.acq_config
        per = {}
        for g in (fine, coarse):
            reset_kernel_launch_counts()
            kernel_factor.banded_factor_kernel(helmholtz_coefficients(
                torch.full(g.shape, 1500.0, device=self.device), g, 250e3))
            per[g.ny] = kernel_launch_counts()["factor"]

        comb = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_launch_counts()
        t0 = time.perf_counter()
        with self.recorded(timedomain, "_sweep_record", comb, lambda r: r):
            td = self.comb_2d()
        torch.cuda.synchronize()
        synth_s = time.perf_counter() - t0
        syn_counts = kernel_launch_counts()
        synth_peak = torch.cuda.max_memory_allocated() / 2**20
        nf = len(td.freqs)
        lines = timedomain.extract_frequency_data(td.traces, td.times,
                                                  td.freqs, td.df,
                                                  td.spectrum)
        rec = comb[0].cpu().numpy()
        line_rel = [float(np.linalg.norm(lines[i] - rec[i])
                          / np.linalg.norm(rec[i])) for i in range(nf)]
        log(f" traces {td.traces.shape} over {nf} comb lines in {synth_s:.2f} "
            f"s, peak {synth_peak:.1f} MiB; launches {syn_counts}; "
            f"extraction vs the comb's receiver matrices, rel by line "
            f"{[float(f'{e:.2e}') for e in line_rel]} (held to 1e-4)")
        gated = timedomain.direct_arrival_gate(td, c_ref=1480.0, pre=3e-6,
                                               post=8e-6, taper=2e-6)
        kept = float(np.sum(np.abs(gated.traces) ** 2)
                     / np.sum(np.abs(td.traces) ** 2))
        log(f" direct-arrival gate (1480 m/s, 3/8/2 us): {kept:.3f} of the "
            f"trace energy kept")
        self.check(max(line_rel) < 1e-4, f"extraction off: {line_rel}")
        self.check(syn_counts == dict(dict.fromkeys(KERNELS, 0),
                                      factor=nf * per[fine.ny], sweep=nf,
                                      stencil=nf),
                   f"synthesis launches {syn_counts}")
        self.check(np.all(np.isfinite(gated.traces)) and 0 < kept < 1,
                   f"gate kept {kept}")

        freqs = (150e3, 250e3, 350e3)
        n_stage = 5
        datasets = timedomain.timedomain_to_ring_datasets(td, freqs,
                                                          deconvolve=False)
        ends = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_launch_counts()
        t0 = time.perf_counter()
        res = invert_dataset(
            datasets, grid=coarse, acquisition=acq,
            fwi=FWIConfig(c_init=1480.0),
            continuation=ContinuationConfig(frequencies=freqs,
                                            iterations_per_frequency=n_stage),
            callback=lambda *a: ends.append(time.perf_counter()))
        torch.cuda.synchronize()
        counts = kernel_launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**20
        stage_s = np.diff([t0] + ends)
        loss = res.metrics["loss"]
        true_grid = Grid2D.from_arrays(td.x, td.y)
        rmse0 = reconstruction_rmse(np.full(coarse.shape, 1480.0), coarse,
                                    td.c, true_grid)
        rmse = reconstruction_rmse(res.velocity, coarse, td.c, true_grid)
        log(f" continuation {freqs}, {n_stage} iterations each: s/iter by "
            f"stage {(stage_s / n_stage).tolist()}; loss {loss.tolist()}; "
            f"rmse start {rmse0:.4f} end {rmse:.4f} m/s; peak {peak:.1f} "
            f"MiB; launches {counts}")
        self.slices["broadband"] = dict(
            synthesis_s=synth_s, comb_lines=nf, synthesis_launches=syn_counts,
            synthesis_peak_memory_mib=synth_peak, extraction_rel=line_rel,
            gate_energy_kept=kept,
            s_per_iter_by_stage=(stage_s / n_stage).tolist(),
            loss=loss.tolist(), rmse_start=rmse0, rmse_end=rmse,
            launches=counts, peak_memory_mib=peak)
        for k in KERNELS:
            self.launches[k] += counts[k] + syn_counts[k]
        n_iter = n_stage * len(freqs)
        self.check(np.all(np.isfinite(loss)) and all(
            loss[i + n_stage - 1] < loss[i] for i in range(0, n_iter, n_stage)),
            f"stage losses not finite and falling: {loss}")
        self.check(rmse < rmse0, f"rmse {rmse} not below the start {rmse0}")
        self.check(counts == dict(dict.fromkeys(KERNELS, 0),
                                  factor=n_iter * per[coarse.ny],
                                  sweep=3 * n_iter),
                   f"inversion launches {counts}")

    # -- phases 14-15: the volumetric path ------------------------------
    def _bench3d(self, n):
        """bench.py::bench_3d_setup's workload at n^3 / 0.75 mm: the 2 x 8
        cylinder at 0.75 of the half width over half of it (min_angle 0.8),
        the Gaussian 40 m/s blob on 1500 m/s, PMLConfig(a0=20, l_pml=8 d),
        one-hot sources x 1e6 (at unit scale the squared norms of the
        solves' right-hand sides fall into FP32's denormals,
        bench.py:256-257). Returns (grid, acq, pml, true velocity, sources,
        half width)."""
        import torch
        from waveforminversionust_tpu_torch.config import PMLConfig
        from waveforminversionust_tpu_torch.models import acquisition3d
        from waveforminversionust_tpu_torch.models.grid3d import Grid3D

        d = 0.75e-3
        half = (n - 1) * d / 2
        grid = Grid3D(nx=n, ny=n, nz=n, dx=d, dy=d, dz=d, x0=-half,
                      y0=-half, z0=-half)
        pos = acquisition3d.cylinder_positions(n_rings=2, n_per_ring=8,
                                               radius=0.75 * half,
                                               z_span=0.5 * half)
        acq = acquisition3d.build_acquisition3d(grid, pos, min_angle=0.8)
        Z, Y, X = grid.meshgrid()
        vel = torch.as_tensor(
            (C3D + 40.0 * np.exp(-(X ** 2 + Y ** 2 + Z ** 2)
                                 / (0.33 * half) ** 2)).astype(np.float32),
            device=self.device)
        src = acquisition3d.source_fields_3d(acq, grid) * 1e6
        self.check(src.is_cuda, "source_fields_3d did not default to the card")
        return grid, acq, PMLConfig(a0=20.0, l_pml=8 * d), vel, src, half

    def fwi3d(self):
        """bench.py's 3D phase (bench_3d_setup, bench_3d_cold,
        bench_3d_warm) through the port: the spectral A/B at 64^3 x 16;
        the synthesis solve (GMRES restart 8, tol 2e-3, cap 400,
        "highest"); 2 cold CG iterations (clip +-100 m/s) and 4 warm ones
        (BB, the watchdog at 1.5, warm starts), each after a warm-up run;
        the matvec split by torch.profiler; one forward solve at 128^3."""
        import torch
        from waveforminversionust_tpu_torch.config import (FWIConfig,
                                                           StepSizeFormula)
        from waveforminversionust_tpu_torch.fwi import fwi3d
        from waveforminversionust_tpu_torch.fwi.runner3d import reconstruction_rmse_3d
        from waveforminversionust_tpu_torch.ops import (born3d,
                                                        kernel_launch_counts,
                                                        reset_kernel_launch_counts)

        f = 300e3
        grid, acq, pml, vel_true, src, half = self._bench3d(64)
        out = self.slices["fwi3d"] = {}
        out["spectral_ab"] = self.spectral_ab(vel_true, src, f, grid, pml)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_launch_counts()
        t0 = time.perf_counter()
        wv, syn_mv = born3d.born_gmres_solve_3d(vel_true, src, f, grid, pml,
                                                maxiter=400, tol=2e-3,
                                                restart=8)
        torch.cuda.synchronize()
        out.update(synthesis_s=time.perf_counter() - t0,
                   synthesis_matvecs=syn_mv)
        rx = torch.as_tensor(acq.rx_idx, dtype=torch.long, device=self.device)
        data = fwi3d.build_fwi_data_3d(acq, fwi3d.sample_receivers_3d(wv, rx),
                                       f, grid)._replace(src=src)
        del wv
        vel0 = torch.full(grid.shape, C3D, device=self.device)
        truth = vel_true.cpu().numpy()
        rmse0 = reconstruction_rmse_3d(vel0.cpu().numpy(), grid, truth,
                                       radius=0.75 * half)
        log(f" synthesis: {syn_mv} matvecs in {out['synthesis_s']:.4f} s "
            f"({data.src.shape[0]} transmitters, {data.rec_obs.shape[1]} "
            f"receivers each); rmse start {rmse0:.4f} m/s inside the array")
        clip = (C3D - 100.0, C3D + 100.0)
        runs = {"cold": (FWIConfig(num_iterations=2, clip_velocity=clip), 2,
                         False),
                "warm": (FWIConfig(num_iterations=2, clip_velocity=clip,
                                   step_size=StepSizeFormula.BB,
                                   reject_increase=1.5), 4, True)}
        counts = {}
        for name, (fwi, n_it, warm) in runs.items():
            def run():
                return fwi3d.nonlinear_cg_3d(
                    vel0, data, grid, fwi, num_iterations=n_it, pml=pml,
                    iter_cap=400, solver3d="gmres", spectral="auto",
                    warm_start=warm)

            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            warmup = time.perf_counter() - t0
            solves = []
            torch.cuda.reset_peak_memory_stats()
            reset_kernel_launch_counts()
            t0 = time.perf_counter()
            with self.recorded(fwi3d, "born_gmres_solve_3d", solves,
                               lambda r: r[1]):
                vel, m = run()
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            counts[name] = kernel_launch_counts()
            loss = m.loss.cpu().numpy()
            rmse = reconstruction_rmse_3d(vel.cpu().numpy(), grid, truth,
                                          radius=0.75 * half)
            peak = torch.cuda.max_memory_allocated() / 2**20
            out[name] = dict(s_per_iter=elapsed / n_it, iterations=n_it,
                             warmup_s=warmup, solve_matvecs=solves,
                             loss=loss.tolist(), rmse_start=rmse0,
                             rmse_end=rmse, peak_memory_mib=peak,
                             launches=counts[name])
            log(f" {name}: s/iter {elapsed / n_it:.6f} ({n_it} iterations, "
                f"warm-up run {warmup:.2f} s); matvecs a solve {solves}; "
                f"loss {loss.tolist()}; rmse {rmse0:.4f} -> {rmse:.4f} m/s; "
                f"peak {peak:.1f} MiB; launches {counts[name]}")
            for k in KERNELS:
                self.launches[k] += counts[name][k]
            if name == "cold":
                self.check(np.all(np.isfinite(loss)) and loss[-1] < loss[0],
                           f"cold losses not finite and falling: {loss}")
            else:
                self.check(np.all(np.isfinite(loss))
                           and loss.min() <= 0.5 * loss[0],
                           f"warm losses short of half the first: {loss}")
        out["matvec_split"] = self.matvec_split(
            lambda: born3d.born_gmres_solve_3d(
                vel0, src, f, grid, pml, tol=0.0, maxiter=18, restart=8,
                spectral="auto", spectral_precision="high"), 18,
            src.numel() * C64, vel0.numel() * C64)
        del data, src
        out["solve_128"] = self.solve_128(f)
        self.check(all(n == 0 for c in counts.values() for n in c.values()),
                   f"a kernel was launched on the 3D path: {counts}")

    def spectral_ab(self, vel, src, f, grid, pml):
        """The two spectral routes of ops/born3d.py on the bench's volumes,
        in turns (fft, dft "highest", dft "high", then back): ms of one
        transform pair with the Green's multiply, ms of one CBS matvec,
        and, after 18 GMRES matvecs (two cycles, restart 8) from zero, the
        field's relative difference to the fft route's. The dft route's
        transform pair is held to the fft route's at "highest" (rel 1e-5,
        tests/test_born3d.py:134)."""
        import torch
        from waveforminversionust_tpu_torch.ops import born3d

        rng = np.random.default_rng(3)
        w = torch.as_tensor((rng.standard_normal(src.shape)
                             + 1j * rng.standard_normal(src.shape)
                             ).astype(np.complex64), device=self.device)
        variants = [("fft", "highest"), ("dft", "highest"), ("dft", "high")]
        rows, ref = {}, {}
        for route, prec in variants + variants[::-1]:
            key = f"{route}/{prec}"
            greens, v_pot, gamma, _ = born3d.born_operator_3d(
                vel, f, grid, pml, spectral=route, spectral_precision=prec)
            pair, pair_ms = timed(lambda: greens(w), REPS)
            _, mv_ms = timed(lambda: gamma * (w - greens(v_pot * w)), REPS)
            row = rows.setdefault(key, dict(pair_ms=[], matvec_ms=[]))
            row["pair_ms"].append(pair_ms)
            row["matvec_ms"].append(mv_ms)
            if "field_rel" in row:
                continue
            u, _ = born3d.born_gmres_solve_3d(
                vel, src, f, grid, pml, tol=0.0, maxiter=18, restart=8,
                spectral=route, spectral_precision=prec)
            if not ref:
                ref.update(pair=pair, field=u)
            row.update(pair_rel=rel_err(pair, ref["pair"]),
                       field_rel=rel_err(u, ref["field"]))
        auto = "dft" if born3d._use_dft("auto") else "fft"
        for key, row in rows.items():
            log(f" spectral {key}: transform pair with the Green's multiply "
                f"{row['pair_ms']} ms, matvec {row['matvec_ms']} ms over "
                f"{src.shape[0]} x {grid.nx}^3; pair rel {row['pair_rel']:.3e}"
                f", field after 18 matvecs rel {row['field_rel']:.3e} "
                f"(to fft/highest)")
        log(f" spectral=\"auto\" on this card at {grid.nx}^3: {auto}")
        rows["auto"] = auto
        self.check(rows["dft/highest"]["pair_rel"] < 1e-5,
                   f"dft route off the fft route: {rows['dft/highest']}")
        return rows

    def matvec_split(self, fn, matvecs, field_bytes, volume_bytes):
        """Device time of ``fn`` (a GMRES solve of ``matvecs`` matvecs)
        under torch.profiler, per matvec, beside the unprofiled wall time
        (the idle share is taken against it) and the device launches, by
        what launched each kernel: the
        FFT pair (``aten::_fft_c2c``), the Krylov basis work (the
        Gram-Schmidt inner products and updates, norms and V y) or the
        elementwise rest; beside the bytes of a matvec (the field in and
        out, the three complex coefficient volumes in) and of an average
        Arnoldi step
        at restart 8 (4.5 basis fields and w read, v_j+1 written) at 3.35
        TB/s."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        basis_ops = ("aten::linalg_vecdot", "aten::addcmul",
                     "aten::linalg_vector_norm", "aten::bmm")

        def category(ev):
            while ev is not None:
                if "fft" in ev.name:
                    return "fft_pair"
                if ev.name in basis_ops:
                    return "gram_schmidt"
                ev = ev.cpu_parent
            return "elementwise"

        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        split = dict(fft_pair=0.0, gram_schmidt=0.0, elementwise=0.0)
        launches = 0
        for ev in prof.events():
            kernels = getattr(ev, "kernels", None) or []
            launches += len(kernels)
            us = sum(k.duration for k in kernels)
            if us:
                split[category(ev)] += us / 1e3 / matvecs
        busy = sum(split.values())
        bound_mv = (2 * field_bytes + 3 * volume_bytes) / PEAK_BYTES * 1e3
        bound_gs = 6.5 * field_bytes / PEAK_BYTES * 1e3
        res = dict(ms_per_matvec=plain_wall * 1e3 / matvecs,
                   profiled_ms_per_matvec=wall * 1e3 / matvecs,
                   device_ms_per_matvec=busy,
                   device_launches_per_matvec=launches / matvecs,
                   idle_share=max(0.0, 1 - busy * matvecs / 1e3 / plain_wall),
                   bound_matvec_ms=bound_mv, bound_arnoldi_step_ms=bound_gs,
                   **{f"{k}_ms": v for k, v in split.items()})
        if busy == 0:
            log(" matvec split: torch.profiler gave no device time "
                "(not measured)")
        log(f" a matvec of {matvecs} (2 GMRES cycles): {res}")
        return res

    def solve_128(self, f):
        """One forward GMRES solve (restart 8, tol 2e-3, cap 400) of the
        bench's workload at 128^3 / 16 transmitters: matvecs, seconds, peak
        memory. Recorded, not held."""
        import torch
        from waveforminversionust_tpu_torch.ops import born3d

        grid, _, pml, vel, src, _ = self._bench3d(128)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        u, mv = born3d.born_gmres_solve_3d(vel, src, f, grid, pml,
                                           maxiter=400, tol=2e-3, restart=8)
        torch.cuda.synchronize()
        res = dict(matvecs=mv, seconds=time.perf_counter() - t0,
                   peak_memory_mib=torch.cuda.max_memory_allocated() / 2**20,
                   finite=bool(torch.isfinite(u).all()))
        log(f" one forward solve at 128^3 x {src.shape[0]}: {res}")
        return res

    def setup_3d(self):
        """The JAX CLI's broadband3d defaults (cli.py:344-356, 635-678):
        65^3 / 0.75 mm, 3 rings x 16 elements (radius 18 mm over 12 mm),
        PMLConfig(a0=20, l_pml=9 mm), a 90 m/s Gaussian blob on C3D off
        centre. Returns (grid, positions, pml, velocity (numpy), dv)."""
        from waveforminversionust_tpu_torch.config import PMLConfig
        from waveforminversionust_tpu_torch.models.acquisition3d import cylinder_positions
        from waveforminversionust_tpu_torch.models.grid3d import Grid3D

        dv, radius = 90.0, 18e-3
        grid = Grid3D.centered(24e-3, 0.75e-3)
        Z, Y, X = grid.meshgrid()
        r2 = (X - 0.15 * radius) ** 2 + Y ** 2 + Z ** 2
        vel = (C3D + dv * np.exp(-r2 / (2 * (8e-3 / 2) ** 2))).astype(np.float32)
        return (grid, cylinder_positions(3, 16, radius, 12e-3),
                PMLConfig(a0=20.0, l_pml=9e-3), vel, dv)

    def comb_3d(self):
        """setup_3d's traces over the 150-400 kHz comb in 25 kHz steps
        (seed 0); made once and kept for the traveltime3d phase."""
        if "3d" not in self.combs:
            from waveforminversionust_tpu_torch.data import timedomain3d
            grid, pos, pml, vel, _ = self.setup_3d()
            self.combs["3d"] = timedomain3d.synthesize_time_domain_dataset_3d(
                vel, grid, pos, f_low=0.15e6, f_high=0.40e6, df=0.025e6,
                pml=pml, seed=0)
        return self.combs["3d"]

    def broadband3d(self):
        """The JAX CLI's broadband3d workflow at its defaults (cli.py:
        333-400, 635-678) without the travel-time start: 65^3 / 0.75 mm, 3
        rings x 16 elements (radius 18 mm over 12 mm, min_angle 0.7), a 90
        m/s blob; the spectral A/B at this width (275 kHz); traces over the
        150-400 kHz comb in 25 kHz steps (GMRES
        tol 1e-5, restart 16), extraction held to the comb's receiver
        matrices, then 4 CG iterations at each of 150, 275 and 400 kHz
        (GMRES, cap 400, clip +-2.5 x 90 m/s)."""
        import torch
        from waveforminversionust_tpu_torch.config import (ContinuationConfig,
                                                           FWIConfig)
        from waveforminversionust_tpu_torch.data import timedomain, timedomain3d
        from waveforminversionust_tpu_torch.fwi import fwi3d
        from waveforminversionust_tpu_torch.fwi.runner3d import invert_dataset_3d
        from waveforminversionust_tpu_torch.models.acquisition3d import (
            build_acquisition3d, source_fields_3d)
        from waveforminversionust_tpu_torch.ops import (kernel_launch_counts,
                                                        reset_kernel_launch_counts)

        grid, pos, pml, vel, dv = self.setup_3d()
        acq = build_acquisition3d(grid, pos, min_angle=0.7)
        self.slices["broadband3d"] = dict(spectral_ab=self.spectral_ab(
            torch.as_tensor(vel, device=self.device),
            source_fields_3d(acq, grid) * 1e6, 0.275e6, grid, pml))

        comb, line_mv = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_launch_counts()
        t0 = time.perf_counter()
        with self.recorded(timedomain3d, "_sweep_record_3d", comb, lambda r: r), \
                self.recorded(fwi3d, "born_gmres_solve_3d", line_mv,
                              lambda r: r[1]):
            td = self.comb_3d()
        torch.cuda.synchronize()
        synth_s = time.perf_counter() - t0
        syn_counts = kernel_launch_counts()
        synth_peak = torch.cuda.max_memory_allocated() / 2**20
        lines = timedomain.extract_frequency_data(td.traces, td.times,
                                                  td.freqs, td.df, td.spectrum)
        rec = comb[0].cpu().numpy()
        line_rel = [float(np.linalg.norm(lines[i] - rec[i])
                          / np.linalg.norm(rec[i])) for i in range(len(td.freqs))]
        log(f" traces {td.traces.shape} over {len(td.freqs)} comb lines on "
            f"{grid.nx}^3 in {synth_s:.2f} s, matvecs a line {line_mv}, peak "
            f"{synth_peak:.1f} MiB; launches {syn_counts}; extraction vs the "
            f"comb's receiver matrices, rel by line "
            f"{[float(f'{e:.2e}') for e in line_rel]} (held to 1e-4)")
        self.check(max(line_rel) < 1e-4, f"extraction off: {line_rel}")

        freqs, n_stage = (0.15e6, 0.275e6, 0.40e6), 4
        _, datasets = timedomain3d.timedomain_to_fwi_data_3d(td, freqs, grid,
                                                             min_angle=0.7)
        ends, solves = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_launch_counts()
        t0 = time.perf_counter()
        with self.recorded(fwi3d, "born_gmres_solve_3d", solves,
                           lambda r: r[1]):
            res = invert_dataset_3d(
                datasets, grid,
                FWIConfig(c_init=C3D, clip_velocity=(C3D - 2.5 * dv,
                                                     C3D + 2.5 * dv)),
                continuation=ContinuationConfig(
                    frequencies=freqs, iterations_per_frequency=n_stage),
                pml=pml, solver3d="gmres", iter_cap=400,
                callback=lambda *a: ends.append(time.perf_counter()))
        torch.cuda.synchronize()
        counts = kernel_launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**20
        stage_s = np.diff([t0] + ends)
        loss = res.metrics["loss"]
        rmse0 = float(np.sqrt(np.mean((C3D - vel) ** 2)))
        rmse = float(np.sqrt(np.mean((res.velocity - vel) ** 2)))
        log(f" continuation {freqs}, {n_stage} iterations each: s/iter by "
            f"stage {(stage_s / n_stage).tolist()}; matvecs a solve {solves}; "
            f"loss {loss.tolist()}; rmse start {rmse0:.4f} end {rmse:.4f} "
            f"m/s; peak {peak:.1f} MiB; launches {counts}")
        self.slices["broadband3d"].update(
            synthesis_s=synth_s, comb_lines=len(td.freqs),
            synthesis_matvecs=line_mv, synthesis_peak_memory_mib=synth_peak,
            extraction_rel=line_rel,
            s_per_iter_by_stage=(stage_s / n_stage).tolist(),
            solve_matvecs=solves, loss=loss.tolist(), rmse_start=rmse0,
            rmse_end=rmse, launches=counts, synthesis_launches=syn_counts,
            peak_memory_mib=peak)
        for k in KERNELS:
            self.launches[k] += counts[k] + syn_counts[k]
        n_iter = n_stage * len(freqs)
        self.check(np.all(np.isfinite(loss)) and all(
            loss[i + n_stage - 1] < loss[i] for i in range(0, n_iter, n_stage)),
            f"stage losses not finite and falling: {loss}")
        self.check(rmse < rmse0, f"rmse {rmse} not below the start {rmse0}")
        self.check(all(n == 0 for n in list(counts.values())
                       + list(syn_counts.values())),
                   f"a kernel was launched on the 3D path: {syn_counts}, "
                   f"{counts}")

    # -- phases 16-18: the travel-time starts and the 3D methods --------
    @contextlib.contextmanager
    def spans(self, out, *targets):
        """Patch each (module, name, key) of ``targets`` so that every call
        runs between two synchronizes and adds its seconds to out[key]."""
        import torch
        with contextlib.ExitStack() as stack:
            for module, name, key in targets:
                real = getattr(module, name)

                def wrapper(*a, _real=real, _key=key, **k):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = _real(*a, **k)
                    torch.cuda.synchronize()
                    out[_key] = out.get(_key, 0.0) + time.perf_counter() - t0
                    return res

                stack.enter_context(mock.patch.object(module, name, wrapper))
            yield

    def tomogram(self, run, pick_module, update, n_vox, c_ref, clip, rmse,
                 times):
        """One travel-time start through its entry point ``run`` (which
        returns (velocity, t_obs, tx, rx)): seconds split into the picks,
        the eikonal batches, the ray traces and the PCG solves, the Jacobi
        sweeps (``update`` is the (module, name) of the local solver) and
        each source's iterations, ms a sweep beside its byte bound (T and
        s read, T written), the PCG residuals, peak memory, RMSE
        (``rmse(velocity)``) and the picks' residual under ``times(slowness,
        tx, rx)`` against the homogeneous ``c_ref`` model's. Holds finite
        values inside ``clip``, the residual below the homogeneous one and
        no kernel launched."""
        import torch
        from waveforminversionust_tpu_torch.fwi import eikonal, traveltime
        from waveforminversionust_tpu_torch.ops import (kernel_launch_counts,
                                                        reset_kernel_launch_counts)

        secs, iters, sweeps, relres = {}, [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_launch_counts()
        t0 = time.perf_counter()
        with self.spans(secs, (pick_module, "pick_arrival_times", "pick"),
                        (eikonal, "_solve", "eikonal"),
                        (eikonal, "_trace", "trace"),
                        (traveltime, "_normal_eq_solve", "pcg")), \
                self.recorded(eikonal, "_solve", iters,
                              lambda r: r[1].cpu().numpy()), \
                self.recorded(*update, sweeps, lambda r: None), \
                self.recorded(traveltime, "_normal_eq_solve", relres,
                              lambda r: float(r[1])):
            vel, t_obs, tx, rx = run()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = kernel_launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**20
        slow = 1.0 / vel
        resid = float(np.linalg.norm(times(slow, tx, rx).cpu().numpy() - t_obs))
        resid0 = float(np.linalg.norm(
            times(np.full_like(slow, 1.0 / c_ref), tx, rx).cpu().numpy()
            - t_obs))
        n_sweeps = len(sweeps)
        its = np.concatenate(iters) if iters else np.zeros(0, np.int32)
        n_src = its.size // max(1, len(iters))
        ms_sweep = secs.get("eikonal", 0.0) * 1e3 / max(1, n_sweeps)
        sweep_bound = (2 * n_src + 1) * n_vox * 4 / PEAK_BYTES * 1e3
        out = dict(
            pick_s=secs["pick"], tomogram_s=total - secs["pick"],
            eikonal_s=secs.get("eikonal", 0.0),
            trace_s=secs.get("trace", 0.0), pcg_s=secs["pcg"],
            eikonal_batches=len(iters), sources=n_src, jacobi_sweeps=n_sweeps,
            iterations_max=int(its.max()) if its.size else 0,
            iterations_median=float(np.median(its)) if its.size else 0.0,
            ms_per_sweep=ms_sweep, sweep_bound_ms=sweep_bound,
            pcg_relres=relres, pairs=int(len(t_obs)), peak_memory_mib=peak,
            rmse=rmse(vel), residual_s=resid, residual_homogeneous_s=resid0,
            launches=counts)
        log(f"  picks {out['pick_s']:.3f} s, tomogram {out['tomogram_s']:.3f} s "
            f"(eikonal {out['eikonal_s']:.3f} s in {len(iters)} batches of "
            f"{n_src} sources, {n_sweeps} Jacobi sweeps, iterations a source "
            f"max {out['iterations_max']} median "
            f"{out['iterations_median']:.1f}, {ms_sweep:.4f} ms a sweep, "
            f"bound {sweep_bound:.4f} ms; trace {out['trace_s']:.3f} s; PCG "
            f"{out['pcg_s']:.3f} s, relres {relres}); {len(t_obs)} pairs; "
            f"peak {peak:.1f} MiB; rmse {out['rmse']:.4f} m/s; pick residual "
            f"{resid:.4e} s against {resid0:.4e} s homogeneous; launches "
            f"{counts}")
        self.check(np.all(np.isfinite(vel)) and vel.min() >= clip[0]
                   and vel.max() <= clip[1],
                   f"tomogram outside {clip}: {vel.min()} .. {vel.max()}")
        self.check(resid < resid0, f"pick residual {resid} not below the "
                   f"homogeneous model's {resid0}")
        self.check(all(n == 0 for n in counts.values()),
                   f"a kernel was launched by the travel-time start: {counts}")
        return vel, out

    def traveltime(self):
        """The JAX CLI's ``broadband --traveltime-init`` (cli.py:302-323) at
        the main path's ring: the broadband phase's traces (made here when
        it did not run), the direct-arrival gate at the CLI's defaults
        (1480 m/s, 3/8/2 us), traveltime_init on 301^2 / 0.8 mm with the
        +-31-element exclusion, straight and bent (3 outer passes); the
        homogeneous eikonal fields against r * s; then the continuation from
        the straight tomogram, 5 CG iterations at each of 150, 250 and 350
        kHz, with the main path's frozen factor (refactor_every=2), so that
        K1, K2 and K3 all run."""
        import torch
        from waveforminversionust_tpu_torch import (ContinuationConfig,
                                                    FWIConfig, SolverConfig,
                                                    invert_dataset)
        from waveforminversionust_tpu_torch.data import timedomain
        from waveforminversionust_tpu_torch.fwi import eikonal, traveltime
        from waveforminversionust_tpu_torch.fwi.runner import reconstruction_rmse
        from waveforminversionust_tpu_torch.models.acquisition import (
            ring_positions, snap_to_grid)
        from waveforminversionust_tpu_torch.models.grid import Grid2D
        from waveforminversionust_tpu_torch.ops import (kernel_launch_counts,
                                                        reset_kernel_launch_counts)

        coarse, acq = self.grid, self.acq_config
        td = self.comb_2d()
        gated = timedomain.direct_arrival_gate(td, c_ref=C_REF_TT, pre=3e-6,
                                               post=8e-6, taper=2e-6)
        true_grid = Grid2D.from_arrays(td.x, td.y)

        def rmse(v):
            return reconstruction_rmse(v, coarse, td.c, true_grid)

        out = self.slices["traveltime"] = dict(
            rmse_homogeneous=rmse(np.full(coarse.shape, C_REF_TT)))
        n_samples = 2 * max(coarse.shape)
        clip = (1300.0, 1800.0)
        tomo = {}
        for method in ("straight", "bent"):
            log(f" traveltime_init method={method}:")
            tomo[method], out[method] = self.tomogram(
                lambda: traveltime.traveltime_init(
                    gated, coarse,
                    num_excluded_each_side=acq.num_excluded_each_side,
                    c_ref=C_REF_TT, method=method, n_outer=3,
                    return_times=True),
                traveltime, (eikonal, "_upwind_update"),
                coarse.ny * coarse.nx, C_REF_TT, clip, rmse,
                lambda s, tx, rx: traveltime.straight_ray_times(
                    s, tx, rx, coarse, n_samples=n_samples))

        # homogeneous maps against r * s: tests/test_eikonal.py's case (40
        # mm at 1 mm, one source) held to its bound, 1.5 cells of time (the
        # first-order scheme's diagonal error); the ring's 256 sources on
        # the 301^2 grid, whose rays run ~5x as many cells, recorded
        s0 = np.float32(1.0 / C_REF_TT)
        xi, yi = snap_to_grid(coarse, *ring_positions(acq.num_elements,
                                                      acq.radius))
        cases = (("test_eikonal", Grid2D.centered(40e-3, 1e-3),
                  np.array([[-30e-3, 5e-3]], np.float32)),
                 ("ring", coarse, np.stack([coarse.x[xi], coarse.y[yi]], 1)
                  .astype(np.float32)))
        for name, g, src in cases:
            t = eikonal.eikonal_solve_batch(np.full(g.shape, s0), src,
                                            g).cpu().numpy()
            X, Y = g.meshgrid()
            exact = np.hypot(X[None] - src[:, 0, None, None],
                             Y[None] - src[:, 1, None, None]) * s0
            err = float(np.abs(t - exact).max())
            out[f"homogeneous_{name}_max_err_cells"] = err / float(g.dx * s0)
            log(f" homogeneous eikonal batch, {name} ({len(src)} sources on "
                f"{g.nx}^2): max |T - r s| {err:.4e} s = "
                f"{err / (g.dx * s0):.3f} cells of time")
        self.check(out["homogeneous_test_eikonal_max_err_cells"] < 1.5,
                   f"homogeneous eikonal {out}")

        freqs, n_stage = (150e3, 250e3, 350e3), 5
        datasets = timedomain.timedomain_to_ring_datasets(td, freqs,
                                                          deconvolve=False)
        ends = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_kernel_launch_counts()
        t0 = time.perf_counter()
        res = invert_dataset(
            datasets, grid=coarse, acquisition=acq,
            solver=SolverConfig(refactor_every=2),
            fwi=FWIConfig(c_init=C_REF_TT), c_init=tomo["straight"],
            continuation=ContinuationConfig(frequencies=freqs,
                                            iterations_per_frequency=n_stage),
            callback=lambda *a: ends.append(time.perf_counter()))
        torch.cuda.synchronize()
        counts = kernel_launch_counts()
        stage_s = np.diff([t0] + ends)
        loss = res.metrics["loss"]
        rmse0, rmse1 = out["straight"]["rmse"], rmse(res.velocity)
        out["continuation"] = dict(
            s_per_iter_by_stage=(stage_s / n_stage).tolist(),
            loss=loss.tolist(), rmse_start=rmse0, rmse_end=rmse1,
            peak_memory_mib=torch.cuda.max_memory_allocated() / 2**20,
            launches=counts)
        log(f" continuation {freqs} from the straight tomogram, {n_stage} "
            f"iterations each (refactor_every=2): s/iter by stage "
            f"{(stage_s / n_stage).tolist()}; loss {loss.tolist()}; rmse "
            f"{rmse0:.4f} -> {rmse1:.4f} m/s; launches {counts}")
        for k in KERNELS:
            self.launches[k] += counts[k]
        n_iter = n_stage * len(freqs)
        self.check(np.all(np.isfinite(loss)) and all(
            loss[i + n_stage - 1] < loss[i] for i in range(0, n_iter, n_stage)),
            f"stage losses not finite and falling: {loss}")
        self.check(rmse1 < rmse0, f"rmse {rmse1} not below the start {rmse0}")
        self.check(all(counts[k] > 0 for k in ("factor", "sweep", "stencil")),
                   f"continuation launches {counts}")

    def traveltime3d(self):
        """The JAX CLI's ``broadband3d --traveltime-init`` (cli.py:364-378)
        at its defaults: the broadband3d phase's traces (made here when it
        did not run), the gate at 1500 m/s (3/8/2 us), traveltime_init_3d
        on the 65^3 grid with min_angle 0.7 and the clip c +- 2 dv, straight
        and bent (3 outer passes); RMSE over the volume."""
        from waveforminversionust_tpu_torch.data import timedomain3d
        from waveforminversionust_tpu_torch.fwi import eikonal3d, traveltime3d

        grid, _, _, vel_true, dv = self.setup_3d()
        td = self.comb_3d()
        gated = timedomain3d.direct_arrival_gate_3d(td, c_ref=C3D, pre=3e-6,
                                                    post=8e-6, taper=2e-6)

        def rmse(v):
            return float(np.sqrt(np.mean((v - vel_true) ** 2)))

        clip = (C3D - 2 * dv, C3D + 2 * dv)
        out = self.slices["traveltime3d"] = dict(
            rmse_homogeneous=rmse(np.full(grid.shape, C3D)))
        n_samples = 2 * max(grid.shape)
        for method in ("straight", "bent"):
            log(f" traveltime_init_3d method={method}:")
            _, out[method] = self.tomogram(
                lambda: traveltime3d.traveltime_init_3d(
                    gated, grid, min_angle=0.7, c_ref=C3D, method=method,
                    clip_velocity=clip, return_times=True),
                traveltime3d, (eikonal3d, "_upwind_update_3d"),
                grid.nz * grid.ny * grid.nx, C3D, clip, rmse,
                lambda s, tx, rx: traveltime3d.straight_ray_times_3d(
                    s, tx, rx, grid, n_samples=n_samples))

    def methods3d(self):
        """The 3D methods at fwi3d's shapes (bench.py::bench_3d_setup: 64^3
        / 0.75 mm, 2 x 8 elements, 300 kHz, the 40 m/s blob; GMRES restart
        8, tol 2e-3, cap 400): the gradient of fwi_loss_3d against central
        differences along interior-masked random directions, lossless and
        lossy (tests/test_fwi3d.py:289-372: GMRES tol 1e-5, a frozen
        shell); invert_dataset_3d with "lbfgs" (5 iterations), "gn" (2
        outer of 6 inner), and "alpha" (from the true velocity) and "joint"
        (from 1500 m/s), 3 iterations each, on data with a Gaussian absorber
        (tests/test_fwi3d.py:380-427 scaled to 64^3); then
        calibrate_background_speed_3d (9 candidates x 2 levels) on a water
        shot and on the blob data."""
        import torch
        from waveforminversionust_tpu_torch.config import FWIConfig
        from waveforminversionust_tpu_torch.fwi import calibrate, fwi3d, lbfgs
        from waveforminversionust_tpu_torch.fwi.runner3d import (
            invert_dataset_3d, reconstruction_rmse_3d)
        from waveforminversionust_tpu_torch.ops import (born3d,
                                                        kernel_launch_counts,
                                                        reset_kernel_launch_counts)

        f = 300e3
        grid, acq, pml, vel_true, src, half = self._bench3d(64)
        rx = torch.as_tensor(acq.rx_idx, dtype=torch.long, device=self.device)
        Z, Y, X = grid.meshgrid()
        # the absorber of tests/test_fwi3d.py:392-394 (40 Np/m over 3 mm on
        # a 12 mm half width), widened to this volume's half width
        alpha_true = torch.as_tensor(
            (40.0 * np.exp(-(X ** 2 + Y ** 2 + Z ** 2)
                           / (3e-3 * half / 12e-3) ** 2)).astype(np.float32),
            device=self.device)

        def dataset(vel, alpha=None):
            wv, _ = born3d.born_gmres_solve_3d(vel, src, f, grid, pml,
                                               maxiter=400, tol=2e-3,
                                               restart=8, attenuation=alpha)
            return fwi3d.build_fwi_data_3d(
                acq, fwi3d.sample_receivers_3d(wv, rx), f, grid)._replace(
                    src=src)

        vel0 = torch.full(grid.shape, C3D, device=self.device)
        data, lossy = dataset(vel_true), dataset(vel_true, alpha_true)
        out = self.slices["methods3d"] = {}
        truth = vel_true.cpu().numpy()

        def rmse(v):
            return reconstruction_rmse_3d(np.asarray(v), grid, truth,
                                          radius=0.75 * half)

        # the gradient against central differences
        reset_kernel_launch_counts()
        slow = torch.full((vel0.numel(),), 1.0 / C3D, device=self.device)
        k0 = 2 * np.pi * f / C3D
        rng = np.random.default_rng(3)
        mask = np.zeros(grid.shape, np.float32)
        mask[3:-3, 3:-3, 3:-3] = 1.0
        grads = {}
        for name, alpha0 in (("lossless", None),
                             ("lossy", torch.full(grid.shape, 10.0,
                                                  device=self.device))):
            def loss_fn(s, a, _alpha0=alpha0):
                d = data._replace(attenuation=a)
                return lbfgs.fwi_loss_3d(s, d, grid, pml, iter_cap=2000,
                                         use_gmres=True, tol=1e-5,
                                         restart=16, estimate_sources=False,
                                         shell_k0=k0)

            s = slow.clone().requires_grad_(True)
            a = None if alpha0 is None else alpha0.clone().requires_grad_(True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = loss_fn(s, a)
            loss.backward()
            torch.cuda.synchronize()
            grad_s = time.perf_counter() - t0
            ds = torch.as_tensor(rng.standard_normal(slow.shape[0])
                                 .astype(np.float32) * mask.ravel() / C3D,
                                 device=self.device)
            with torch.no_grad():
                eps = 3e-3
                fd = (float(loss_fn(slow + eps * ds, alpha0))
                      - float(loss_fn(slow - eps * ds, alpha0))) / (2 * eps)
                an = float(torch.dot(s.grad, ds))
                row = dict(loss=float(loss), value_and_grad_s=grad_s,
                           slowness=dict(analytic=an, fd=fd,
                                         rel=abs(an - fd) / abs(fd)))
                if alpha0 is not None:
                    da = torch.as_tensor(rng.standard_normal(grid.shape)
                                         .astype(np.float32) * mask * 5.0,
                                         device=self.device)
                    eps_a = 1e-1
                    fd_a = (float(loss_fn(slow, alpha0 + eps_a * da))
                            - float(loss_fn(slow, alpha0 - eps_a * da))
                            ) / (2 * eps_a)
                    an_a = float(torch.sum(a.grad * da))
                    row["alpha"] = dict(analytic=an_a, fd=fd_a,
                                        rel=abs(an_a - fd_a) / abs(fd_a))
            grads[name] = row
            log(f" fwi_loss_3d gradient, {name}: {row}")
        out["gradient"] = grads
        grad_counts = kernel_launch_counts()
        self.check(all(np.isfinite(r["slowness"]["analytic"])
                       and r["slowness"]["rel"] < 5e-2 for r in grads.values()),
                   f"slowness gradient off its central difference: {grads}")
        # the JAX package's own bound for the weaker alpha sensitivity
        # (tests/test_fwi3d.py:371)
        self.check(grads["lossy"]["alpha"]["rel"] < 1e-1,
                   f"alpha gradient off its central difference: {grads}")

        # the four methods
        runs = (("lbfgs", data, 5, {}, vel0),
                ("gn", data, 2, dict(cg_iters=6), vel0),
                ("alpha", lossy, 3, {}, vel_true),
                ("joint", lossy, 3, {}, vel0))
        counts = {"gradient": grad_counts}
        for method, d, n_it, kw, c_init in runs:
            solves = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_kernel_launch_counts()
            t0 = time.perf_counter()
            with self.recorded(fwi3d, "born_gmres_solve_3d", solves,
                               lambda r: r[1]), \
                    self.recorded(born3d, "born_gmres_solve_3d", solves,
                                  lambda r: r[1]):
                res = invert_dataset_3d(
                    d, grid, FWIConfig(c_init=C3D), method=method,
                    c_init=c_init, pml=pml, iter_cap=400, solver3d="gmres",
                    gmres_tol=2e-3, gmres_restart=8, num_iterations=n_it,
                    **kw)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            counts[method] = kernel_launch_counts()
            loss = res.metrics["loss"]
            row = dict(s_per_iter=elapsed / n_it, iterations=n_it,
                       solves=len(solves), solve_matvecs=solves,
                       loss=loss.tolist(), rmse_start=rmse(c_init.cpu()),
                       rmse_end=rmse(res.velocity),
                       peak_memory_mib=torch.cuda.max_memory_allocated() / 2**20,
                       launches=counts[method])
            if method in ("alpha", "joint"):
                am = res.metrics["attenuation"]
                c = tuple(n // 2 for n in grid.shape)
                row.update(alpha_centre=float(am[c]), alpha_max=float(am.max()),
                           alpha_true_centre=float(alpha_true[c]))
            out[method] = row
            log(f" {method}: {row}")
            self.check(np.all(np.isfinite(loss)) and loss[-1] < loss[0],
                       f"{method} losses not finite and falling: {loss}")
            if method == "gn":
                self.check(np.all(np.diff(loss) <= 0),
                           f"gn losses not monotone: {loss}")
            if method == "alpha":
                self.check(row["alpha_centre"] > 0,
                           f"no absorber recovered: {row['alpha_centre']}")
            else:
                self.check(row["rmse_end"] < row["rmse_start"],
                           f"{method} rmse {row['rmse_end']} not below "
                           f"{row['rmse_start']}")

        # background-speed calibration, 9 candidates over 1400-1600 m/s x 2
        # levels: on a water shot (the homogeneous C3D volume), where c0
        # must come within the last level's spacing of C3D, and on the blob
        # data, whose anomaly pulls it up (recorded)
        step = 2 * (1600.0 - 1400.0) / 8 / 8   # the last level's spacing
        for name, d in (("water", dataset(vel0)), ("blob", data)):
            reset_kernel_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cal = calibrate.calibrate_background_speed_3d(d, grid, pml=pml)
            torch.cuda.synchronize()
            counts[f"calibrate_{name}"] = kernel_launch_counts()
            out[f"calibrate_{name}"] = dict(
                seconds=time.perf_counter() - t0, c0=cal.c0,
                c_grid_best=cal.c_grid_best, misfits=cal.misfits.tolist(),
                final_step=step)
            log(f" calibrate_background_speed_3d on the {name} data: c0 "
                f"{cal.c0:.4f} m/s (background {C3D}, last spacing {step}), "
                f"best candidate {cal.c_grid_best}, "
                f"{out[f'calibrate_{name}']['seconds']:.3f} s")
        c0 = out["calibrate_water"]["c0"]
        self.check(abs(c0 - C3D) <= step,
                   f"calibrated c0 {c0} off the background {C3D}")
        self.check(all(n == 0 for c in counts.values() for n in c.values()),
                   f"a kernel was launched on the 3D path: {counts}")

    # -- phase 19 -------------------------------------------------------
    def cli(self):
        """The port's front end, ``cli.main`` in-process on the card at full
        width (the JAX CLI's defaults, waveforminversionust_tpu/cli.py:
        463-697), each subcommand with no ``--device`` (the card): simulate
        (801^2 / 0.3 mm, 256 elements, 350 kHz, seed 0) into a .mat; qc on
        it; run (301^2 / 0.8 mm, cg, 10 iterations from 1480 m/s) with
        ``--out`` held against invert_dataset called directly with the same
        configuration (losses and velocity to the last bit); run
        ``--iterations 2 --profile``; run ``--method lbfgs --iterations
        2``; timedomain, broadband and broadband3d at their defaults with
        ``--iterations 1``; ``--plot`` wherever matplotlib is installed.
        Then, through invert_dataset on simulate's data, the scan hybrids
        (factor_schulz_steps=4, fast_sweeps=True, 2 iterations at 301^2: no
        factor or sweep kernel) and the frozen factor at 601^2 / 0.4 mm
        (refactor_every=2, 4 iterations); fast_sweeps=True alone against
        factorization="thomas" (the stock plain sweeps) at 301^2 / 256
        right-hand sides; the roofline of run's s/iter."""
        import contextlib as ctx
        import importlib.util
        import io
        import os
        import re
        import tempfile

        import torch
        from waveforminversionust_tpu_torch import cli
        from waveforminversionust_tpu_torch.config import (FWIConfig,
                                                           SolverConfig)
        from waveforminversionust_tpu_torch.data import matio, timedomain
        from waveforminversionust_tpu_torch.fwi import runner
        from waveforminversionust_tpu_torch.models.grid import Grid2D
        from waveforminversionust_tpu_torch.ops import (kernel_launch_counts,
                                                        reset_kernel_launch_counts)
        from waveforminversionust_tpu_torch.utils import flops

        plot = importlib.util.find_spec("matplotlib") is not None
        if not plot:
            log(" matplotlib is not installed here: no --plot (the CPU tests "
                "render every figure, tests/test_torch_viz.py, "
                "tests/test_torch_cli.py)")
        phase_counts = dict.fromkeys(KERNELS, 0)
        out = self.slices["cli"] = {}

        def count(counts):
            for k in KERNELS:
                self.launches[k] += counts[k]
                phase_counts[k] += counts[k]

        def main(name, argv):
            """cli.main(argv) with its standard output captured and echoed:
            (output, seconds, launch counts)."""
            buf = io.StringIO()
            torch.cuda.synchronize()
            reset_kernel_launch_counts()
            t0 = time.perf_counter()
            with ctx.redirect_stdout(buf):
                cli.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = kernel_launch_counts()
            count(counts)
            shown = " ".join(os.path.basename(a) for a in argv)
            log(f" wiust-torch {shown}: {secs:.3f} s; launches {counts}")
            for line in buf.getvalue().splitlines():
                log(f"   | {line}")
            out[name] = dict(seconds=secs, launches=counts)
            return buf.getvalue(), secs, counts

        def losses(text):
            found = re.findall(r"loss history: \[([^\]]*)\]", text)
            self.check(found, "no loss history printed")
            return np.array([float(v) for v in found[-1].split()])

        def direct(ds, n_iter, **kw):
            """invert_dataset on ds (the CLI's run defaults otherwise):
            (result, s/iter, launch counts)."""
            torch.cuda.synchronize()
            reset_kernel_launch_counts()
            t0 = time.perf_counter()
            res = runner.invert_dataset(ds, fwi=FWIConfig(num_iterations=n_iter),
                                        **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            counts = kernel_launch_counts()
            count(counts)
            return res, secs / n_iter, counts

        others = [k for k in KERNELS if k not in ("factor", "sweep", "stencil")]
        with tempfile.TemporaryDirectory(prefix="wiust_cli_") as tmp:
            data = os.path.join(tmp, "sim.mat")
            _, sim_s, sim_counts = main("simulate", ["simulate", data])
            ds = matio.load_recorded_dataset(data)
            self.check(ds.rec_data.shape == (256, 256)
                       and np.all(np.isfinite(ds.rec_data))
                       and ds.c.shape == (801, 801),
                       f"simulate wrote {ds.rec_data.shape}, {ds.c.shape}")

            qc_out = os.path.join(tmp, "qc.mat")
            text, _, _ = main("qc", ["qc", data, "--out", qc_out])
            m = re.search(r"raw ([\d.eE+-]+) -> compensated ([\d.eE+-]+)", text)
            self.check(m and float(m.group(2)) < 0.1 * float(m.group(1))
                       and matio.load_mat(qc_out)["REC_DATA"].shape == (256, 256),
                       "qc: asymmetry not compensated or no file")

            # run at its defaults, the invert_dataset call timed inside it
            inner = []
            real = runner.invert_dataset

            def timed_run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = real(*a, **k)
                torch.cuda.synchronize()
                inner.append(time.perf_counter() - t0)
                return res

            run_mat = os.path.join(tmp, "x.mat")
            argv = ["run", data, "--out", run_mat]
            if plot:
                argv += ["--plot", os.path.join(tmp, "rec.png")]
            with mock.patch.object(runner, "invert_dataset", timed_run):
                text, run_s, run_counts = main("run", argv)
            got = matio.load_mat(run_mat)
            loss = got["loss"].ravel()
            s_iter = inner[0] / N_ITER
            grid = runner.default_inversion_grid()
            true_grid = Grid2D.from_arrays(ds.x, ds.y)
            rmse0 = runner.reconstruction_rmse(np.full(grid.shape, 1480.0),
                                               grid, ds.c, true_grid)
            rmse = runner.reconstruction_rmse(got["VEL_F"], grid, ds.c,
                                              true_grid)
            res, s_iter_direct, direct_counts = direct(ds, N_ITER)
            same = (np.array_equal(res.metrics["loss"].astype(np.float64), loss)
                    and np.array_equal(res.velocity.astype(np.float64),
                                       got["VEL_F"]))
            log(f" run: {s_iter:.6f} s/iter inside the CLI (host clock, "
                f"synchronised; {run_s:.3f} s the whole command), direct "
                f"invert_dataset {s_iter_direct:.6f} s/iter; loss "
                f"{loss.tolist()}; rmse start {rmse0:.4f} end {rmse:.4f} m/s; "
                f"equal to the direct call to the last bit: {same}")
            out["run"].update(s_per_iter=s_iter, s_per_iter_direct=s_iter_direct,
                              loss=loss.tolist(), rmse_start=rmse0,
                              rmse_end=rmse, direct_launches=direct_counts)
            self.check(same, "run's .mat differs from the direct "
                             "invert_dataset call")
            self.check(np.all(np.isfinite(loss)) and loss[-1] < loss[0],
                       f"run losses {loss}")
            self.check(rmse < rmse0, f"run rmse {rmse0} -> {rmse}")
            # run at its defaults refactors every iteration and refines
            # nothing (SolverConfig(): refactor_every=1, refine=0), as the
            # JAX CLI's run does: the stencil kernel is not on its path
            self.check(run_counts["factor"] > 0 and run_counts["sweep"] > 0
                       and all(run_counts[k] == 0 for k in others),
                       f"run launches {run_counts}")

            prof = os.path.join(tmp, "prof")
            _, _, prof_counts = main("run_profile", ["run", data, "--iterations",
                                                     "2", "--profile", prof])
            trace = open(os.path.join(prof, "trace.json")).read()
            names = {"factor": ("build_s", "pivot_gj", "panel_update"),
                     "sweep": ("sweep_cluster",),
                     "stencil": ("stencil9_kernel",)}
            named = {k: all(n in trace for n in v) for k, v in names.items()}
            log(f" profile trace {len(trace) / 1e6:.1f} MB; names the device "
                f"functions of {[k for k, v in named.items() if v]}")
            self.check(all(named[k] == (prof_counts[k] > 0) for k in names)
                       and named["factor"] and named["sweep"],
                       f"trace names {named} against launches {prof_counts}")

            text, _, lb_counts = main("run_lbfgs", ["run", data, "--method",
                                                    "lbfgs", "--iterations", "2"])
            lb_loss = losses(text)
            self.check(lb_loss.size == 2 and np.all(np.isfinite(lb_loss)),
                       f"lbfgs losses {lb_loss}")

            fields = []
            argv = ["timedomain"]
            if plot:
                argv += ["--plot", os.path.join(tmp, "td.png")]
            with self.recorded(timedomain, "simulate_time_domain", fields,
                               lambda r: r):
                main("timedomain", argv)
            td = fields[0]
            self.check(tuple(td.wavefields_t.shape) == (501, 241, 241)
                       and bool(torch.isfinite(td.wavefields_t).all())
                       and np.all(np.isfinite(td.channel_data)),
                       "timedomain fields not finite")

            argv = ["broadband", "--iterations", "1"]
            if plot:
                argv += ["--plot", os.path.join(tmp, "bb.png")]
            text, _, _ = main("broadband", argv)
            bb_loss = losses(text)
            self.check(bb_loss.size == 3 and np.all(np.isfinite(bb_loss)),
                       f"broadband losses {bb_loss}")

            vol = os.path.join(tmp, "vol.npy")
            argv = ["broadband3d", "--iterations", "1", "--out", vol]
            if plot:
                argv += ["--plot", os.path.join(tmp, "bb3.png")]
            text, _, _ = main("broadband3d", argv)
            b3_loss = losses(text)
            v = np.load(vol)
            self.check(b3_loss.size == 3 and np.all(np.isfinite(b3_loss))
                       and v.shape == (65, 65, 65) and np.all(np.isfinite(v)),
                       f"broadband3d losses {b3_loss}, volume {v.shape}")

        # the scan hybrids at 301^2: the plain block-Thomas factor with
        # warm-started Schulz rows and the precomputed sweep operators
        hyb, hyb_s, hyb_counts = direct(
            ds, 2, solver=SolverConfig(factor_schulz_steps=4, fast_sweeps=True))
        hyb_loss = hyb.metrics["loss"]
        log(f" scan hybrids (factor_schulz_steps=4, fast_sweeps=True), 2 "
            f"iterations: {hyb_s:.4f} s/iter, loss {hyb_loss.tolist()} (the "
            f"kernel path's {loss[:2].tolist()}); launches {hyb_counts}")
        out["hybrids"] = dict(s_per_iter=hyb_s, loss=hyb_loss.tolist(),
                              launches=hyb_counts)
        self.check(all(n == 0 for n in hyb_counts.values())
                   and np.allclose(hyb_loss, loss[:2], rtol=GOLDEN["loss"],
                                   atol=0),
                   f"hybrids: launches {hyb_counts}, losses {hyb_loss}")

        self.fast_sweeps_ab()

        # the frozen factor at 601^2: the whole stale factor reused
        g601 = Grid2D.centered(120e-3, 0.4e-3)
        fz, fz_s, fz_counts = direct(ds, 4, grid=g601,
                                     solver=SolverConfig(refactor_every=2))
        fz_loss = fz.metrics["loss"]
        log(f" frozen factor at {g601.nx}^2 (refactor_every=2), 4 iterations: "
            f"{fz_s:.4f} s/iter, loss {fz_loss.tolist()}, velocity "
            f"{float(fz.velocity.min()):.2f}..{float(fz.velocity.max()):.2f} "
            f"m/s; launches {fz_counts}")
        out["frozen_601"] = dict(s_per_iter=fz_s, loss=fz_loss.tolist(),
                                 launches=fz_counts)
        self.check(np.all(np.isfinite(fz_loss)) and np.all(np.isfinite(fz.velocity))
                   and fz_counts["stencil"] > 0 and fz_loss[-1] < fz_loss[0],
                   f"601^2 frozen factor: losses {fz_loss}, launches {fz_counts}")

        # run's s/iter in the CLI (its first run at this size) and in the
        # direct call after it (the same computation, warm)
        spec = flops.chip_spec(0)
        cost = flops.fwi_iteration_cost(301, 301, 256)
        roof = {}
        for name, t in (("cli", s_iter), ("direct", s_iter_direct)):
            roof[name] = flops.roofline(cost, t, "highest", spec)
            log(f" roofline of run's {t:.6f} s/iter ({name}) against "
                f"fwi_iteration_cost(301, 301, 256): {json.dumps(roof[name])}")
        out.update(simulate_s=sim_s, simulate_launches=sim_counts,
                   roofline=roof, launches=phase_counts)
        log(f" cli phase launches {phase_counts}")
        self.check(all(phase_counts[k] > 0 for k in ("factor", "sweep", "stencil"))
                   and all(phase_counts[k] == 0 for k in others),
                   f"cli phase launches {phase_counts}")

    def fast_sweeps_ab(self):
        """fast_sweeps=True alone (the plain factor, then the precomputed
        sweep operators) against factorization="thomas" (the plain factor
        and the stock plain sweeps), both without a kernel, on the main
        path's 301^2 operator and its 256 sources: the operator's build,
        the forward and adjoint solves, the operators' own cost, and the
        forward-adjoint pairs per factor that pay for it. The kernel engine's operator ("auto") beside
        them for scale."""
        import torch
        from waveforminversionust_tpu_torch.config import SolverConfig
        from waveforminversionust_tpu_torch.ops import (banded,
                                                        kernel_launch_counts,
                                                        reset_kernel_launch_counts,
                                                        solve)

        grid, data, vel0 = self._setup()
        ab, sols = {}, {}
        for name, cfg in (("thomas", SolverConfig(factorization="thomas")),
                          ("fast_sweeps", SolverConfig(fast_sweeps=True)),
                          ("kernels", SolverConfig())):
            reset_kernel_launch_counts()
            op, build_ms = host_timed(
                lambda: solve.make_helmholtz_operator(vel0, data.f, grid, cfg))
            row = dict(build_ms=build_ms)
            for adjoint in (False, True):
                x, ms = timed(lambda: solve.helmholtz_operator_solve(
                    op, data.src, grid, cfg, adjoint=adjoint), 3)
                key = "adjoint" if adjoint else "forward"
                row[f"{key}_ms"] = ms
                sols[name, key] = x
            row["launches"] = {k: n for k, n in kernel_launch_counts().items()
                               if n}
            if name == "thomas":  # the operators' own cost, warm
                for _ in range(2):
                    _, row["prepare_sweep_ops_ms"] = host_timed(
                        lambda: banded.prepare_sweep_ops(op.factor))
            ab[name] = row
            del op
        torch.cuda.empty_cache()
        for key in ("forward", "adjoint"):
            ab[f"rel_err_{key}"] = rel_err(sols["fast_sweeps", key],
                                           sols["thomas", key])
        saved = sum(ab["thomas"][f"{k}_ms"] - ab["fast_sweeps"][f"{k}_ms"]
                    for k in ("forward", "adjoint"))
        ab["pairs_to_pay_back"] = (ab["thomas"]["prepare_sweep_ops_ms"] / saved
                                   if saved > 0 else None)
        log(f" fast_sweeps=True alone against factorization='thomas' at "
            f"{grid.ny}^2 / {data.src.shape[0]} right-hand sides: "
            f"{json.dumps(ab)}")
        self.slices["cli"]["fast_sweeps_ab"] = ab
        self.check(all(ab[f"rel_err_{k}"] < 1e-4 for k in ("forward", "adjoint"))
                   and not ab["thomas"]["launches"]
                   and not ab["fast_sweeps"]["launches"],
                   f"fast sweeps A/B: {ab}")

    # -- phase 20 -------------------------------------------------------
    def profile(self):
        """torch.profiler over 2 iterations (one factored, one stale) of
        each engine, and over one two-cycle GMRES forward solve (one- and
        two-level) and one Born solve: device time by kernel name, and the
        idle share."""
        import torch
        from waveforminversionust_tpu_torch.config import (FWIConfig,
                                                           SolverConfig,
                                                           SolverMethod)
        from waveforminversionust_tpu_torch.fwi.optimizers import nonlinear_cg
        from waveforminversionust_tpu_torch.ops import solve

        grid, data, vel0 = self._setup()
        fwi = FWIConfig(num_iterations=2)
        for engine in ("auto", "twisted", "cr"):
            solver = SolverConfig(refactor_every=2, factorization=engine)
            self.profiled(f"{engine}: 2 iterations",
                          lambda: nonlinear_cg(vel0, data, grid, solver, fwi))
        for label, cfg in (
                ("GMRES one-level, 34 matvecs",
                 SolverConfig(method=SolverMethod.GMRES, maxiter=34)),
                ("GMRES two-level, 34 matvecs",
                 SolverConfig(method=SolverMethod.GMRES, maxiter=34,
                              gmres_two_level=True)),
                ("Born, one solve", SolverConfig(method=SolverMethod.BORN))):
            op = solve.make_helmholtz_operator(vel0, data.f, grid, cfg)
            self.profiled(label, lambda: solve.helmholtz_operator_solve(
                op, data.src, grid, cfg))

    def profiled(self, label, fn):
        """Run ``fn`` once unprofiled, then under torch.profiler; log the
        wall times, the device's busy time and idle share, and the 14
        kernels that took the most device time."""
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device-side events only: an aten op's row repeats the time of
        # the kernels it launched
        rows = [(e.key, e.count,
                 getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)))
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        rows = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
        busy = sum(r[2] for r in rows) / 1e6
        log(f" profile {label}: {wall:.4f} s profiled wall "
            f"({plain_wall:.4f} s unprofiled), device busy {busy:.4f} s, "
            f"idle share {max(0.0, 1 - busy / wall):.3f}")
        for key, count, us in rows[:14]:
            log(f"   {us / 1e3:10.3f} ms {us / 1e6 / busy:6.1%} "
                f"x{count:<6d} {key[:90]}")


def nvidia_smi(query="name,power.limit") -> str:
    """The first card's ``nvidia-smi --query-gpu`` line for ``query``."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


SLICES = ("slice", "slice_twisted", "slice_cr")
PATHS = SLICES + ("parity", "intake", "runner", "lbfgs", "gn", "multifreq",
                  "gmres", "born", "broadband", "traveltime", "profile")
# the 3D phases and the CLI (which makes its own data) need no 2D data
VOLUMES = ("fwi3d", "broadband3d", "traveltime3d", "methods3d", "cli")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="kernels,data,slice,slice_twisted,slice_cr,"
                            "parity,intake,runner,lbfgs,gn,multifreq,gmres,"
                            "born,broadband,traveltime,fwi3d,broadband3d,"
                            "traveltime3d,methods3d,cli",
                    help="comma-separated subset of kernels,data,slice,"
                         "slice_twisted,slice_cr,parity,intake,runner,lbfgs,"
                         "gn,multifreq,gmres,born,broadband,traveltime,"
                         "fwi3d,broadband3d,traveltime3d,methods3d,cli,"
                         "profile")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    import waveforminversionust_tpu_torch  # noqa: F401
    from waveforminversionust_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    smoke = Smoke(dev)
    smi = nvidia_smi()
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
        if set(phases) & set(PATHS + ("data",)):
            smoke.phase("data", smoke.data)
        for name in PATHS:
            if name in phases and "data" not in smoke.failures:
                smoke.phase(name, getattr(smoke, name))
        for name in VOLUMES:
            if name in phases:
                smoke.phase(name, getattr(smoke, name))

    rows = []
    for name, meta in KERNELS.items():
        k = smoke.kernels.get(name, {})
        rows.append(dict(name=name, route="cuda", source=meta["source"],
                         replaces=meta["replaces"],
                         launches=smoke.launches[name],
                         max_abs_err=k.get("max_abs_err"), ms=k.get("ms"),
                         plain_ms=k.get("plain_ms"),
                         bound_ms=k.get("bound_ms"),
                         bound_by=k.get("bound_by"),
                         library_ms=k.get("library_ms")))
    if smoke.failures:
        log(f"FAILED phases: {smoke.failures}")
        return 1
    for name, numbers in smoke.slices.items():
        numbers.pop("velocity", None)
        log(f"{name}: {json.dumps(numbers)}")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
