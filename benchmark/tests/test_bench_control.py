"""The control, the reference computed with TF32 products put in the
program's place, comes out not correct: at a tiny size on the CPU
against the tiny cells' limits, and on the card at each cell's own size
against its limits (run there: ``python3 -m pytest -q benchmark/tests -m
cuda``)."""

import json

import pytest

import spec
import workload
from conftest import ROOT, TINY_LIMITS


def control_numbers(root, cell, seed, device):
    loop = workload.make(spec.load(root, cell), seed, device)
    want = loop.expected(0)
    return loop.compare(loop.expected(0, "tf32"), want), loop


def fails(numbers, limits):
    return any(numbers[k] > lim for k, lim in limits.items())


@pytest.mark.parametrize("cell", ["tiny.live", "tinysim.shots"])
def test_control_fails_the_tiny_limits(tiny_tree, cell):
    numbers, _ = control_numbers(tiny_tree, cell, 2**31 + 5, "cpu")
    assert fails(numbers, TINY_LIMITS[cell]), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_control_fails_the_cell_limits_on_the_card(card, cell):
    numbers, loop = control_numbers(ROOT, cell, 2**31 + 17, card)
    assert fails(numbers, loop.cell.check["limits"]), numbers
