"""Two-tower model: notice tower + company tower (port of
``jodalrob_twotower_tpu/models/two_tower.py``)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from jodalrob_twotower_torch.config import ModelConfig
from jodalrob_twotower_torch.data.types import PairBatch, TowerBatch
from jodalrob_twotower_torch.models.tower import BatchNorm, Tower
from jodalrob_twotower_torch.schema import TwoTowerSchema


class TwoTowerModel(nn.Module):
    """Both towers share one :class:`ModelConfig`, so their final dims match.
    Constructed in eval mode; the train step asks for the training form per
    call (``train=True``), so the module's flag stays as the caller set it.
    ``use_pallas_lookup`` lets the towers' gathers take the row-gather
    kernel (models/embedding.EmbeddingCollection)."""

    def __init__(self, schema: TwoTowerSchema, config: ModelConfig, use_pallas_lookup: bool = False) -> None:
        super().__init__()
        self.schema = schema
        self.config = config
        self.notice_tower = Tower(schema.notice, config, use_pallas_lookup)
        self.company_tower = Tower(schema.company, config, use_pallas_lookup)
        self.eval()

    def forward(
        self,
        batch: PairBatch,
        *,
        train: bool | None = None,
        generator: torch.Generator | None = None,
        emb_overrides: tuple[torch.Tensor, torch.Tensor] | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """(notice_emb, company_emb), both [B, final_dim], L2-normalized.
        ``train`` and ``generator`` as in :meth:`Tower.forward`; the notice
        tower draws its dropout masks from ``generator`` first.
        ``emb_overrides``: an optional (notice, company) pair of categorical
        embedding activations, each tower's ``emb_override`` (the
        sparse-table step)."""
        n_ov, c_ov = emb_overrides if emb_overrides is not None else (None, None)
        return (
            self.notice_tower(batch.notice, train=train, generator=generator, emb_override=n_ov),
            self.company_tower(batch.company, train=train, generator=generator, emb_override=c_ov),
        )

    def encode_notice(self, batch: TowerBatch) -> torch.Tensor:
        return self.notice_tower(batch)

    def encode_company(self, batch: TowerBatch) -> torch.Tensor:
        return self.company_tower(batch)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "TwoTowerModel":
        """Random weights from ``generator`` with flax's default distributions
        (lecun-normal kernels as a plain normal, zero biases, N(0, 1/D)
        tables) and random BatchNorm statistics, so that a wrong statistics
        map shows in a comparison. Returns self."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                fan_in = module.weight.shape[1]
                module.weight.copy_(torch.randn(module.weight.shape, generator=generator) / np.sqrt(fan_in))
                module.bias.zero_()
            elif isinstance(module, BatchNorm):
                n = module.weight.shape[0]
                module.running_mean.copy_(0.1 * torch.randn(n, generator=generator))
                module.running_var.copy_(0.5 + torch.rand(n, generator=generator))
        for name, p in self.named_parameters():
            if name.endswith("embeddings.table"):
                p.copy_(torch.randn(p.shape, generator=generator) / np.sqrt(p.shape[1]))
        return self
