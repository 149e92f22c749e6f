"""No module of the benchmark imports JAX or the JAX package, and the
reference side imports nothing of the program. Top-level names (the part
before the first dot) are compared whole: the port's name begins with the
JAX package's."""

import ast

import pytest

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "waveforminversionust_tpu"}
# the program (the port) and the benchmark modules that reach it
PROGRAM = {"waveforminversionust_tpu_torch", "program", "workload", "harness",
           "calibrate", "run"}
# the reference side: the plain reference, its inputs and its arithmetic
REFERENCE = ["reference.py", "phantom.py", "make_data.py", "costs.py",
             "devtrace.py", "spec.py"]
MODULES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("name", REFERENCE + [
    p.name for p in sorted((BENCH / "metrics").glob("*.py"))])
def test_reference_side_imports_nothing_of_the_program(name):
    path = BENCH / name if (BENCH / name).exists() else BENCH / "metrics" / name
    assert not top_level_imports(path) & (FORBIDDEN | PROGRAM)


def test_the_check_compares_whole_names():
    # the port's top-level name starts with the JAX package's and passes
    assert "waveforminversionust_tpu_torch".split(".")[0] not in FORBIDDEN
    assert top_level_imports(BENCH / "program.py") >= {
        "waveforminversionust_tpu_torch"}
