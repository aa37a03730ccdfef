"""Corpus encoding for index building (port of ``Evaluator.encode_corpus``
from ``jodalrob_twotower_tpu/evaluation/evaluator.py``; the in-batch and
corpus-level metrics arrive with the evaluation slice)."""

from __future__ import annotations

import numpy as np
import torch

from jodalrob_twotower_torch.config import TrainConfig
from jodalrob_twotower_torch.data.types import TowerBatch
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel
from jodalrob_twotower_torch.train.train_step import make_encode_fn


class Evaluator:
    def __init__(self, model: TwoTowerModel, cfg: TrainConfig) -> None:
        self.model = model
        self.cfg = cfg
        self._encode_notice = make_encode_fn(model, "notice")
        self._encode_company = make_encode_fn(model, "company")

    def encode_corpus(
        self,
        state,
        store_dense: np.ndarray,
        store_cat: np.ndarray,
        *,
        side: str = "company",
        batch_size: int = 8192,
    ) -> torch.Tensor:
        """Encode a whole side's feature store into [N, D] float32 embeddings
        on the state's device (index-building path).

        On the card each chunk is staged in one of two pinned host buffers
        and copied with ``non_blocking``, so the host fills chunk i+1 while
        the card copies and encodes chunk i; a buffer is refilled only after
        the copy out of it has finished."""
        encode = self._encode_company if side == "company" else self._encode_notice
        device = state.device
        n = store_dense.shape[0]
        out = torch.empty((n, self.model.config.final_embedding_dim), dtype=torch.float32, device=device)
        if device.type != "cuda":
            for start in range(0, n, batch_size):
                rows = slice(start, start + batch_size)
                batch = TowerBatch(torch.from_numpy(store_dense[rows]), torch.from_numpy(store_cat[rows]))
                out[rows] = encode(state, batch.to(device))
            return out
        staging = [
            (
                torch.empty((batch_size, store_dense.shape[1]), dtype=torch.float32, pin_memory=True),
                torch.empty((batch_size, store_cat.shape[1]), dtype=torch.int32, pin_memory=True),
            )
            for _ in range(2)
        ]
        copied: list[torch.cuda.Event | None] = [None, None]
        stream = torch.cuda.current_stream(device)
        for i, start in enumerate(range(0, n, batch_size)):
            slot = i % 2
            if copied[slot] is not None:
                copied[slot].synchronize()
            m = min(batch_size, n - start)
            host_dense, host_cat = (buf[:m] for buf in staging[slot])
            host_dense.copy_(torch.from_numpy(store_dense[start : start + m]))
            host_cat.copy_(torch.from_numpy(store_cat[start : start + m]))
            batch = TowerBatch(host_dense, host_cat).to(device)
            copied[slot] = torch.cuda.Event()
            copied[slot].record(stream)
            out[start : start + m] = encode(state, batch)
        return out
