"""The comparison's two ends at the CPU's size, with each cell's own
limits: the control (the reference a precision step down, in the program's
place) is not correct, the program as it stands is, and a run with each
fault its cell can have planted under the timed path comes out not correct.
The runs skip the harness's look for a card and drive the rest of a run."""

from __future__ import annotations

import pytest

from benchmark import faults, judge
from benchmark.drivers import serve, train
from benchmark.run import run_cell
from benchmark.tests.conftest import tiny_cell

CELLS = ["train.ref_shaped", "train.scaled_dense", "serve.exact_10m", "serve.int8_10m"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_is_correct(name):
    out = run_cell(tiny_cell(name), 31337, 0.3, False, "cpu")
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    if cell["traffic_spec"]["driver"] == "train":
        numbers = train.control(cell, 31337, "cpu")
    else:
        numbers = serve.control(cell, 31337, "cpu", 64)
    correct, checks = judge.verdict(numbers, cell["limits"], 0)
    assert not correct, checks


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS for f in faults.FAULTS[c.split(".")[0]]])
def test_planted_fault_is_not_correct(name, fault):
    with faults.plant(fault):
        out = run_cell(tiny_cell(name), 31337, 0.3, False, "cpu")
    assert not out["correct"], out["checks"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    out = run_cell(tiny_cell(name), 7, 1.0, False, "cuda")
    assert out["correct"], out["checks"]
