#!/usr/bin/env python3
"""Time K5 (``csrc/inv.cu::batched_gj``, 8 warps a matrix in 4 x 4 register
tiles) against the row layouts of ``k5_layouts.cu`` on one NVIDIA card.

    python3 probes/k5_layouts.py

The row layouts: warps owning rows, column j by ``__shfl_sync``, 4 or 8
warps a matrix, one block barrier a step or an mbarrier a row, with or
without the lookahead row. Each is built from ``k5_layouts.cu`` with the
port's nvcc flags into ``build/probes/``, checked bit for bit against K5 on
the level-0 pivot blocks of the 301^2 breast operator, a seeded
(150, 64, 64) batch and ragged widths, then timed beside K5 (a CUDA graph
of 50 launches, two rounds) at every batch one 301^2 cyclic factorization
inverts, and summed over one factorization (5 launches a level). The
clock64 stamps of one launch at batch 1 give each layout's cycles a step;
the ``parts`` kernel times a step's pieces alone (the update, a barrier,
the shared-memory reads, the shuffled column) by 4, 8 and 16 warps. Prints
the card's name and power limit first. Needs a card; imports nothing of
JAX. Exits 1 if a layout's bits differ from K5's.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# (warps, flags, ahead): the row layouts timed against K5
LAYOUTS = [(w, f, a) for w in (8, 4) for f in (0, 1) for a in (0, 1)]
# The batches a 301^2 cyclic factorization inverts (a level's odd rows, then
# the root), 5 panels of 64 a level.
LEVELS = (150, 75, 38, 19, 9, 5, 2, 1, 1, 1)
BATCHES = sorted(set(LEVELS), reverse=True)
PANELS = 5


def name(layout) -> str:
    w, f, a = layout
    return (f"rows {w}w {'mbarrier' if f else 'barrier'}"
            f"{' ahead' if a else ''}")


def build() -> tuple:
    """nvcc k5_layouts.cu (which includes csrc/inv.cu) into build/probes/."""
    sys.path.insert(0, str(REPO))
    from waveforminversionust_tpu_torch.ops import _build

    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for f in [HERE / "k5_layouts.cu", *sorted(_build.CSRC.glob("*.cu*"))]:
        h.update(f.read_bytes())
    out = REPO / "build" / "probes" / h.hexdigest()[:16]
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libk5_layouts.so"
    if not lib.exists():
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                              str(HERE / "k5_layouts.cu")],
                             capture_output=True, text=True)
        for line in (res.stdout + res.stderr).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(" ", line.strip(), flush=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed:\n{res.stderr[-4000:]}")
    so = ctypes.CDLL(str(lib))
    so.k5_rows.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p] * 2)
    so.k5_parts.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                            + [ctypes.c_void_p] * 2)
    so.k5_rows.restype = so.k5_parts.restype = ctypes.c_int
    return so.k5_rows, so.k5_parts


def graph_us(fn, launches=50, replays=5) -> float:
    """us a call of ``fn``: ``launches`` calls in one CUDA graph, replayed."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays) * 1e3


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k5_layouts: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    sys.path.insert(0, str(REPO))
    from waveforminversionust_tpu_torch.config import SolverConfig
    from waveforminversionust_tpu_torch.fwi.runner import default_inversion_grid
    from waveforminversionust_tpu_torch.models.phantom import breast_phantom
    from waveforminversionust_tpu_torch.ops import _build, cyclic
    from waveforminversionust_tpu_torch.ops.kernel_inv import batched_small_inv_kernel
    from waveforminversionust_tpu_torch.ops.stencil import helmholtz_coefficients

    dev = torch.device("cuda", 0)
    rows, parts = build()

    def rows_inv(p, layout, clk=None):
        out = torch.empty_like(p)
        rc = rows(p.data_ptr(), out.data_ptr(), p.shape[0], p.shape[1], *layout,
                  None if clk is None else clk.data_ptr(),
                  _build.stream_handle(dev))
        _build.check(rc, name(layout))
        return out

    grid, cfg = default_inversion_grid(), SolverConfig()
    c = helmholtz_coefficients(torch.as_tensor(breast_phantom(grid), device=dev),
                               grid, 350e3, cfg.pml, cfg.stencil)
    odd = slice(1, None, 2)
    level0 = cyclic._btri_dense(c[0, odd], c[1, odd], c[2, odd]
                                )[:, :64, :64].contiguous()
    rng = np.random.default_rng(0)

    def seeded(n, b):
        a = (rng.standard_normal((n, b, b)) + 1j * rng.standard_normal((n, b, b))
             ) / np.sqrt(b) + 2 * np.eye(b)
        return torch.as_tensor(a.astype(np.complex64), device=dev)

    cases = [level0, seeded(150, 64)] + [seeded(3, b) for b in (1, 17, 45, 63)]
    equal = {}
    for layout in LAYOUTS:
        equal[layout] = all(
            torch.equal(torch.view_as_real(rows_inv(p, layout)),
                        torch.view_as_real(batched_small_inv_kernel(p)))
            for p in cases)
        print(f" {name(layout)}: bitwise K5's on all {len(cases)} cases: "
              f"{equal[layout]}", flush=True)

    clk = torch.zeros(4, dtype=torch.int64, device=dev)
    one = level0[:1].contiguous()
    for layout in LAYOUTS:
        rows_inv(one, layout, clk)
        rows_inv(one, layout, clk)
        t = clk.cpu().tolist()
        print(f" {name(layout)}, batch 1: {t[1] - t[0]} cycles to row 0, "
              f"{(t[2] - t[1]) / 64:.0f} a step, {t[3] - t[2]} to store",
              flush=True)

    part_names = ["tile update", "tile update + barrier",
                  "tile update + barrier + shared reads", "row update (shuffle)",
                  "row update (shuffle) + barrier"]
    iters = 4096
    src = seeded(1, 32).reshape(-1).contiguous()
    sink = torch.empty(1024, dtype=torch.complex64, device=dev)
    for kind, label in enumerate(part_names):
        line = []
        for threads in (128, 256, 512):
            if kind >= 3 and threads > 256:
                continue
            for _ in range(2):  # the second launch is timed
                _build.check(parts(src.data_ptr(), sink.data_ptr(), kind, threads,
                                   iters, clk.data_ptr(), _build.stream_handle(dev)),
                             label)
            line.append(f"{threads // 32} warps {clk[0].item() / iters:.0f}")
        print(f" parts, {label}: cycles a step: " + ", ".join(line), flush=True)

    print(" us a launch, (n, 64, 64) level-0 pivot blocks, two rounds:")
    kinds = ["K5 tiles 8w"] + [name(x) for x in LAYOUTS]
    times = {k: {n: [] for n in BATCHES} for k in kinds}
    for _ in range(2):
        for n in BATCHES:
            p = level0[:n].contiguous()
            times["K5 tiles 8w"][n].append(graph_us(lambda: batched_small_inv_kernel(p)))
            for layout in LAYOUTS:
                times[name(layout)][n].append(graph_us(lambda: rows_inv(p, layout)))
    for k in kinds:
        cells = ", ".join(f"{n}: " + "/".join(f"{v:.2f}" for v in times[k][n])
                          for n in BATCHES)
        total = PANELS * sum(np.mean(times[k][n]) for n in LEVELS) / 1e3
        print(f"  {k:24s} {cells}; one factorization {total:.3f} ms", flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
