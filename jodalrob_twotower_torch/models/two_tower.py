"""Two-tower model: notice tower + company tower (port of
``jodalrob_twotower_tpu/models/two_tower.py``)."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from jodalrob_twotower_torch.config import ModelConfig
from jodalrob_twotower_torch.data.types import PairBatch, TowerBatch
from jodalrob_twotower_torch.models.embedding import EmbeddingCollection
from jodalrob_twotower_torch.models.tower import BatchNorm, Tower
from jodalrob_twotower_torch.schema import TwoTowerSchema

# the std of a unit normal truncated to [-2, 2]; flax divides by it so that the
# truncated draw keeps the requested variance
_TRUNC_STD_FACTOR = 0.87962566103423978


class TwoTowerModel(nn.Module):
    """Both towers share one :class:`ModelConfig`, so their final dims match.
    Constructed in eval mode; the train step asks for the training form per
    call (``train=True``), so the module's flag stays as the caller set it.
    ``use_pallas_lookup`` lets the towers' gathers take the row-gather
    kernel (models/embedding.EmbeddingCollection). ``mesh`` is the mesh
    model's (``models.build_model``): the towers then run on the rank's
    block of each global batch, and with ``row_sharded`` each table holds
    the rank's block of rows (:attr:`row_sharded_keys`); ``per_rank`` makes
    the block a batch of its own in training form (the compressed sync)."""

    def __init__(self, schema: TwoTowerSchema, config: ModelConfig, use_pallas_lookup: bool = False, *,
                 mesh=None, row_sharded: bool = False, per_rank: bool = False) -> None:
        super().__init__()
        self.schema = schema
        self.config = config
        kw = dict(mesh=mesh, row_sharded=row_sharded, per_rank=per_rank)
        self.notice_tower = Tower(schema.notice, config, use_pallas_lookup, **kw)
        self.company_tower = Tower(schema.company, config, use_pallas_lookup, **kw)
        # the state_dict keys of the row-sharded tables (empty off a mesh or
        # with replicated tables)
        self.row_sharded_keys = frozenset(f"{name}.table" for name, m in self.named_modules()
                                          if isinstance(m, EmbeddingCollection) and m.row_mesh is not None)
        self.eval()

    def _draw_tables(self, generator: torch.Generator) -> None:
        """Every table from N(0, 1/D), drawn whole (a row-sharded table then
        keeps its rank's block, so that every mesh size starts from one
        device's weights)."""
        for name, m in self.named_modules():
            if isinstance(m, EmbeddingCollection):
                full = torch.randn((m.total_rows, m.embed_dim), generator=generator) / np.sqrt(m.embed_dim)
                m.table.copy_(full[m.row_offset : m.row_offset + m.shard_rows])

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
    def init_flax(self, generator: torch.Generator) -> "TwoTowerModel":
        """Fresh weights from ``generator`` with the distributions of the
        reference's ``model.init``: every Dense kernel from flax's
        ``lecun_normal`` (``variance_scaling(1, "fan_in",
        "truncated_normal")``: a normal truncated at two standard deviations,
        std sqrt(1/fan_in) / 0.87962566, so that the truncated draw has std
        sqrt(1/fan_in)), zero biases, BatchNorm scale 1 and bias 0 with
        running mean 0 and variance 1, and N(0, 1/D) tables (a row-sharded
        table drawn whole, keeping its rank's block). Draws are made
        in module order on the generator's device (the CPU for a default
        ``torch.Generator()``), so one seed gives one model. Returns self."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                std = float(np.sqrt(1.0 / module.weight.shape[1]) / _TRUNC_STD_FACTOR)
                w = torch.empty(module.weight.shape)
                nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
                module.weight.copy_(w)
                module.bias.zero_()
            elif isinstance(module, BatchNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
        self._draw_tables(generator)
        return self

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "TwoTowerModel":
        """Random weights from ``generator`` for parity tests: lecun-normal
        kernels as a plain normal, zero biases, N(0, 1/D) tables, and random
        BatchNorm statistics, so that a wrong statistics map shows in a
        comparison (:meth:`init_flax` is the init a run trains from).
        Returns self."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                fan_in = module.weight.shape[1]
                module.weight.copy_(torch.randn(module.weight.shape, generator=generator) / np.sqrt(fan_in))
                module.bias.zero_()
            elif isinstance(module, BatchNorm):
                n = module.weight.shape[0]
                module.running_mean.copy_(0.1 * torch.randn(n, generator=generator))
                module.running_var.copy_(0.5 + torch.rand(n, generator=generator))
        self._draw_tables(generator)
        return self
