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
# the reference side: the plain reference, its inputs and its arithmetic,
# each entry's reference and each metric's reader
REFERENCE = sorted(
    [BENCH / n for n in ("reference.py", "phantom.py", "make_data.py",
                         "costs.py", "devtrace.py", "spec.py")]
    + list((BENCH / "references").glob("*.py"))
    + list((BENCH / "metrics").glob("*.py")))
# the program side's loops, one an entry
ENTRIES = sorted((BENCH / "entries").glob("*.py"))
MODULES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _id(path):
    return str(path.relative_to(BENCH))


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


@pytest.mark.parametrize("path", MODULES, ids=_id)
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE, ids=_id)
def test_reference_side_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | PROGRAM)


@pytest.mark.parametrize("path", ENTRIES, ids=_id)
def test_each_entry_is_a_loop_beside_its_reference(path):
    # an entry's loop is program side, so it is held to test_no_jax; its
    # plain reference is a file of its own under references/, held above
    assert not top_level_imports(path) & FORBIDDEN
    assert "class Loop" in path.read_text()
    assert (BENCH / "references" / path.name).is_file()


def test_the_check_compares_whole_names():
    # the port's top-level name starts with the JAX package's and passes
    assert "waveforminversionust_tpu_torch".split(".")[0] not in FORBIDDEN
    assert top_level_imports(BENCH / "program.py") >= {
        "waveforminversionust_tpu_torch"}
