"""The reference against the program at the CPU's size, with the towers and
the loss in float32 (the fused loss reads bf16 embeddings, so it is left to
"auto", which the CPU runs unfused) so that the two agree to rounding: the
training driver's check steps and the serving driver's answers."""

from __future__ import annotations

import pytest
import torch

from benchmark.drivers import serve, train
from benchmark.reference import model as ref_model
from benchmark.tests.conftest import tiny_cell

F32 = {"compute_dtype": "float32"}


@pytest.mark.parametrize("name", ["train.ref_shaped", "train.scaled_dense"])
def test_training_steps_match(name):
    cell = tiny_cell(name, model=F32, loss={"use_fused_logits": "auto"})
    run = train.Run(cell, 20260101, "cpu")
    run.release()
    numbers = run.judge()
    assert numbers["loss_gap"] < 1e-5  # float32 sums in another order, over three steps
    assert numbers["grad_gap"] < 1e-4 and numbers["update_gap"] < 1e-4, numbers


def test_serving_answers_match():
    cell = tiny_cell("serve.exact_10m", model=F32)
    run = serve.Run(cell, 4242, "cpu")
    run.window(0.2)
    run.release()
    numbers = run.judge()
    assert numbers["score_gap"] < 1e-5 and numbers["rank_gap"] < 1e-5, numbers


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-11, -3.0000002])
    assert ref_model.tf32(x).tolist() == [1.0, 1.0, 1.0 + 2**-9, -3.0]


def test_row_offsets_align_to_128():
    assert ref_model.row_offsets([1000, 5, 129]).tolist() == [0, 1024, 1152]
