"""The sparse-table training cell at the CPU's size: the program's check
steps against the dense reference (the tables' gradients and changes
included), the control not correct, the planted faults caught."""

from __future__ import annotations

import pytest

from benchmark import faults, judge, spec
from benchmark.drivers import train_sparse
from benchmark.run import run_cell
from benchmark.tests.conftest import TINY, tiny_cell

NAME = "train.scaled_sparse"


def tiny_sparse_cell(**sections) -> dict:
    """The cell with ``train.scaled_dense``'s config cut as ``tiny_cell``
    cuts it (the two share ``scaled_tables``) and the training cut."""
    c = spec.cell(NAME)
    c["config_spec"] = tiny_cell("train.scaled_dense", **sections)["config_spec"]
    c["traffic_spec"] = {**c["traffic_spec"], **TINY["train"]}
    return c


def test_float32_steps_match_the_dense_reference():
    cell = tiny_sparse_cell(model={"compute_dtype": "float32"}, loss={"use_fused_logits": "auto"})
    run = train_sparse.Run(cell, 20260101, "cpu")
    assert {"notice_tower.embeddings.table", "company_tower.embeddings.table"} <= set(run.prog["grad_norms"])
    run.release()
    numbers = run.judge()
    assert numbers["loss_gap"] < 1e-5 and numbers["grad_gap"] < 1e-4 and numbers["update_gap"] < 1e-4, numbers


def test_sound_program_is_correct_and_control_is_not():
    cell = tiny_sparse_cell()
    out = run_cell(cell, 31337, 0.3, False, "cpu")
    assert out["correct"], out["checks"]
    correct, checks = judge.verdict(train_sparse.control(cell, 31337, "cpu"), cell["limits"], 0)
    assert not correct, checks


@pytest.mark.parametrize("fault", faults.FAULTS["train"])
def test_planted_fault_is_not_correct(fault):
    with faults.plant(fault):
        out = run_cell(tiny_sparse_cell(), 31337, 0.3, False, "cpu")
    assert not out["correct"], out["checks"]
