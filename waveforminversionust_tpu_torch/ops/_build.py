"""Build and load the hand-written CUDA kernels (``csrc/*.cu``, sharing
device code through ``csrc/*.cuh``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with :mod:`ctypes`. The build runs
on first use, one ``nvcc`` per source, all started together, into a
directory keyed by a hash of the sources, headers and flags:
``<repo>/build/kernels/<hash>/``.
Nothing is built when the package is imported, and nothing here runs on a
CPU-only machine unless a kernel is asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("factor", "sweep", "stencil", "twisted", "inv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
build_seconds: float | None = None
build_dir: Path | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from csrc/ on first use")
    return found


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / f"{name}.cu").read_bytes())
    # every source may include every header: an edited header rebuilds all
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every missing library (in parallel) and return the directory.
    Sets :data:`build_seconds` to the wall time of this call's builds."""
    global build_seconds, build_dir
    out = CSRC.parent.parent / "build" / "kernels" / _key()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        lib = out / f"lib{name}.so"
        if lib.exists():
            continue
        tmp = out / f"lib{name}.{os.getpid()}.tmp.so"
        log = open(out / f"{name}.log", "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, tmp, lib, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, tmp, lib, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(name)
    build_seconds = time.perf_counter() - t0
    build_dir = out
    if failed:
        logs = "\n".join((out / f"{n}.log").read_text()[-4000:] for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        out = build_all()
        for n in SOURCES:
            _libs[n] = ctypes.CDLL(str(out / f"lib{n}.so"))
        lib = _libs[name]
    return lib


def stream_handle(device) -> int:
    """The raw handle of PyTorch's current CUDA stream on ``device``."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (a cudaError_t)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
