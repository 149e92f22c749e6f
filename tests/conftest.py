"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-chip sharding paths are tested on host CPU devices
(``--xla_force_host_platform_device_count``), per the reference test strategy
gap analysis (SURVEY.md section 4): the reference has no automated tests at
all; this suite is the framework's correctness contract.
"""

import os

# One compute thread a test process wherever a library takes a setting:
# XLA:CPU's multithreaded Eigen, and torch and numpy's BLAS
# (OMP_NUM_THREADS, read when they load), so no test file pins threads of
# its own. (XLA:CPU still runs part of its work on its own pool, XLAEigen,
# one thread a core; no flag of this jaxlib caps it.) The suite runs under
# six xdist workers on 8 cores: with each library's default threads the
# load average sat at 21-24 and the run thrashed (test_timedomain's
# end-to-end inversion 666 s, 5.5 s with one thread; test_attenuation's
# regularized multifrequency run 461 s, 7.0 s). A caller's own XLA_FLAGS
# wins; OMP_NUM_THREADS is 1 whatever the caller set.
os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8 "
                      "--xla_cpu_multi_thread_eigen=false")
os.environ["OMP_NUM_THREADS"] = "1"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# The persistent compilation cache is deliberately DISABLED for the suite:
# on this image (jax 0.9 / XLA:CPU AOT), deserializing certain large cached
# executables (the banded-factorization scans) SEGFAULTS inside
# backend.deserialize_executable — two full-suite runs died at the same
# compilation_cache.get_executable_and_time frame (2026-08-17), one of them
# reading an entry written moments earlier by the same process, and the
# cpu_aot_loader logs machine-feature mismatches ("+prefer-no-scatter …
# could lead to execution errors such as SIGILL") even on the machine that
# compiled the entry. Recompiling duplicates across test modules costs
# ~2x suite wall time; a suite that segfaults at 87% costs more.
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


REFERENCE_DIR = "/root/reference"


def reference_available() -> bool:
    return os.path.isdir(os.path.join(REFERENCE_DIR, "Lecture19_Fwi"))


def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="run slow-marked tests (full-workload reference "
                          "parity, large-grid inversions)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running validation (opt in with --runslow)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc (the PyTorch port's "
                   "CUDA kernels); skipped where torch.cuda is unavailable")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow test: use --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables after every test module.

    A full-suite process accumulates thousands of XLA:CPU JIT'd
    executables in one LLVM ORC instance; on this image the compiler
    nondeterministically SEGFAULTS deep into the run (observed three
    times at tests ~100-170, always inside backend_compile_and_load;
    each crashing test passes standalone). Releasing the jit caches per
    module keeps the JIT footprint bounded — the cross-module recompiles
    this costs were mostly happening anyway (the persistent cache is
    disabled above for its own segfault, and modules rarely share traced
    signatures)."""
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
