"""Batch containers (port of ``jodalrob_twotower_tpu/data/types.py``).

Every categorical feature has exactly one id per sample, so ids are a dense
``[B, K]`` int32 matrix. The containers hold host numpy arrays (what the
feature store returns) or tensors (what the towers take).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class TowerBatch(NamedTuple):
    """Inputs for one tower.

    dense: float32 [B, dense_dim] - numeric features ++ text embeddings.
    cat_ids: int32 [B, K] - one label-encoded id per categorical feature.
    text_ids: int32 [B, max_length] - the token ids of the side's encoded
        text column (``SideSchema.encoded_text``), right-padded; None for a
        side without one.
    text_lengths: int32 [B] - each text's token count (at most max_length).
    """

    dense: torch.Tensor | np.ndarray
    cat_ids: torch.Tensor | np.ndarray
    text_ids: torch.Tensor | np.ndarray | None = None
    text_lengths: torch.Tensor | np.ndarray | None = None

    @property
    def batch_size(self) -> int:
        return self.dense.shape[0]

    def to(self, device: torch.device) -> "TowerBatch":
        """Every field as tensors on ``device``. Host data bound for the card
        goes through pinned memory with a ``non_blocking`` copy, so the host
        does not wait for the work already queued on the card."""
        device = torch.device(device)

        def move(x):
            t = torch.as_tensor(x)
            if device.type == "cuda" and t.device.type == "cpu":
                return (t if t.is_pinned() else t.pin_memory()).to(device, non_blocking=True)
            return t.to(device)

        text = () if self.text_ids is None else (move(self.text_ids), move(self.text_lengths))
        return TowerBatch(move(self.dense), move(self.cat_ids), *text)


class PairBatch(NamedTuple):
    """A batch of aligned positive pairs: row i of notice matches row i of company."""

    notice: TowerBatch
    company: TowerBatch

    @property
    def batch_size(self) -> int:
        return self.notice.batch_size


def default_tower_gather(store, rows: torch.Tensor) -> TowerBatch:
    """Batch assembly from a device-resident store: plain row gathers from a
    (dense [N, D], cat_ids [N, K]) tuple of tensors (reference
    ``data/types.default_tower_gather``)."""
    dense, cat = store
    return TowerBatch(dense=dense.index_select(0, rows), cat_ids=cat.index_select(0, rows))
