"""Encoders (port of ``make_encode_fn`` from
``jodalrob_twotower_tpu/train/train_step.py``; the train and eval steps
arrive with the training slice)."""

from __future__ import annotations

import torch
from torch.func import functional_call

from jodalrob_twotower_torch.data.types import TowerBatch
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel


def make_encode_fn(model: TwoTowerModel, side: str):
    """Single-side encoder for index building / serving:
    ``encode(state, batch) -> [B, final_dim]`` float32, in inference mode.

    As in the reference, the model is the structure and ``state`` holds the
    weights (``state.state_dict``, the model's keys): the tower runs through
    ``torch.func.functional_call`` on them, so one model serves any state on
    any device. ``batch`` is a :class:`TowerBatch` of tensors on that device."""
    tower = {"notice": model.notice_tower, "company": model.company_tower}[side]
    prefix = f"{side}_tower."

    def encode(state, batch: TowerBatch) -> torch.Tensor:
        weights = {k[len(prefix):]: v for k, v in state.state_dict.items() if k.startswith(prefix)}
        with torch.inference_mode():
            return functional_call(tower, weights, (batch,), strict=True)

    return encode
