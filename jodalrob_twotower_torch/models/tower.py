"""One retrieval tower (port of ``jodalrob_twotower_tpu/models/tower.py``).

Learned projections of the numeric block and each text block, a dense
projection to the first hidden width, the categorical embeddings, an MLP of
Linear -> ReLU -> BatchNorm (-> Dropout in training) blocks, a head and an
L2 normalisation in float32. Layer names are the flax module names, so the
converter (convert.py) maps the reference's params 1:1.

Numerics follow flax ``Dense(dtype=compute_dtype)``: inputs, weights and
biases are cast to the compute dtype. In training form (``train=True``)
BatchNorm normalises with the batch's own statistics and updates its running
statistics as flax does, and dropout follows each BatchNorm, drawn from the
``torch.Generator`` the caller passes. On a mesh (``parallel/mesh.py``) the
tower runs on the rank's block of the global batch: BatchNorm's statistics
are the global batch's and dropout keeps the rank's block of the global
batch's masks, as one device's step on the whole batch has them; under the
compressed gradient sync (``per_rank``) the rank's block is a batch of its
own, with its own statistics and masks, as in the reference's explicit
``shard_map`` step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jodalrob_twotower_torch.config import ModelConfig
from jodalrob_twotower_torch.data.types import TowerBatch
from jodalrob_twotower_torch.models.embedding import EmbeddingCollection, resolve_lookup_mode
from jodalrob_twotower_torch.models.text_encoder import build_text_encoder
from jodalrob_twotower_torch.parallel.mesh import all_reduce_sum
from jodalrob_twotower_torch.schema import SideSchema
from jodalrob_twotower_torch.utils.profiling import span

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm``: eps 1e-5, statistics in float32, output in the
    compute dtype. ``weight``/``bias`` are flax's ``scale``/``bias``;
    ``running_mean``/``running_var`` its ``batch_stats`` ``mean``/``var``.

    ``train=True`` normalises with the batch statistics as flax computes
    them (``use_fast_variance``: var = max(0, E[x^2] - E[x]^2), the biased
    variance, in float32) and updates the running statistics in place,
    running = 0.99 running + 0.01 batch (flax's momentum 0.99; torch's own
    BatchNorm would take the unbiased variance and weigh the new value
    0.1)."""

    eps = 1e-5
    momentum = 0.99

    def __init__(self, width: int, mesh=None) -> None:
        super().__init__()
        self.mesh = mesh
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))
        self.register_buffer("running_mean", torch.zeros(width))
        self.register_buffer("running_var", torch.ones(width))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x32 = x.float()
        if train and self.mesh is not None:
            mean, var = self._global_stats(x32)
        elif train:
            mean = x32.mean(0)
            var = torch.clamp((x32 * x32).mean(0) - mean * mean, min=0.0)
        if train:
            with torch.no_grad():
                self.running_mean.copy_(self.momentum * self.running_mean + (1 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var + (1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean) * mul + self.bias
        return y.to(x.dtype)

    def _global_stats(self, x32: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Mean and biased variance over the global batch of a mesh, as the
        reference's BatchNorm takes them under GSPMD (its mean over the
        sharded batch dim covers every device's rows): [sum x, sum x^2,
        rows] all-reduced once, differentiably, so the backward sums each
        rank's share of the statistics' gradient across ranks too."""
        w = x32.shape[1]
        local = torch.cat([x32.sum(0), (x32 * x32).sum(0), x32.new_full((1,), x32.shape[0])])
        total = all_reduce_sum(local, self.mesh)
        count = total[2 * w]
        mean = total[:w] / count
        return mean, torch.clamp(total[w : 2 * w] / count - mean * mean, min=0.0)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator, mesh=None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate,
    scaled by 1/(1 - rate) in x's dtype, else 0. The mask comes from
    ``generator`` (on x's device), so a run is replayable from its seed. On
    a mesh x is the rank's block of the global batch: every rank draws the
    global batch's mask and keeps its block, so the masks are those of one
    device's step on the whole batch."""
    keep = 1.0 - rate
    if mesh is None:
        u = torch.rand(x.shape, generator=generator, device=x.device)
    else:
        u = torch.rand((x.shape[0] * mesh.size, *x.shape[1:]), generator=generator, device=x.device)
        u = u[mesh.block(u.shape[0])]
    mask = u < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _dense(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """flax Dense(dtype=x.dtype): weight and bias cast to the input's dtype."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class Tower(nn.Module):
    """Encode a :class:`TowerBatch` of tensors into an L2-normalized
    [B, final_dim] float32 embedding."""

    def __init__(self, schema: SideSchema, config: ModelConfig, use_pallas_lookup: bool = False, *,
                 mesh=None, row_sharded: bool = False, per_rank: bool = False) -> None:
        super().__init__()
        self.schema = schema
        self.config = config
        multi = mesh if mesh is not None and mesh.size > 1 else None
        # a mesh of more than one rank: the training form's BatchNorm takes
        # global statistics and dropout the global batch's masks, unless
        # each rank's block is a batch of its own (per_rank)
        self.mesh = None if per_rank else multi
        self.compute_dtype = _DTYPES[config.compute_dtype]
        proj = config.dense_projection_dim
        # (layer name, start in dense or None for an encoded column, width)
        self.blocks: list[tuple[str, int | None, int]] = []
        off = 0
        if schema.num_numeric:
            self.blocks.append(("proj_numeric", 0, schema.num_numeric))
            off = schema.num_numeric
        for t in schema.text:
            self.blocks.append((f"proj_{t.name}", off, t.embed_dim))
            off += t.embed_dim
        for t in schema.encoded_text:
            # the frozen encoder of the column, its weights in the compute dtype
            self.blocks.append((f"proj_{t.name}", None, t.embed_dim))
            self.add_module(f"encoder_{t.name}", build_text_encoder(t, self.compute_dtype))
        for name, _, width in self.blocks:
            self.add_module(name, nn.Linear(width, proj))
        if self.blocks:
            self.dense_projection = nn.Linear(proj * len(self.blocks), config.tower_hidden_dims[0])
        if schema.num_categorical:
            self.embeddings = EmbeddingCollection(
                schema.vocab_sizes,
                config.categorical_embedding_dim,
                grad_mode=config.embedding_grad,
                lookup_mode=resolve_lookup_mode(config),
                use_pallas=use_pallas_lookup,
                row_mesh=multi if row_sharded else None,
            )
        if not self.blocks and not schema.num_categorical:
            raise ValueError(f"tower {schema.table!r} has no features")
        width = (config.tower_hidden_dims[0] if self.blocks else 0) + (
            schema.num_categorical * config.categorical_embedding_dim
        )
        for i, out in enumerate(config.tower_hidden_dims[1:]):
            self.add_module(f"mlp_{i}", nn.Linear(width, out))
            if config.use_batch_norm:
                self.add_module(f"bn_{i}", BatchNorm(out, self.mesh))
            width = out
        self.head = nn.Linear(width, config.final_embedding_dim)

    def forward(
        self,
        batch: TowerBatch,
        *,
        train: bool | None = None,
        generator: torch.Generator | None = None,
        emb_override: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """``train`` (default: the module's ``training`` flag) selects the
        training form; with ``dropout_rate > 0`` it needs ``generator``, a
        ``torch.Generator`` on the batch's device for the dropout masks.
        ``emb_override`` ([B, K * embed_dim]) takes the place of the
        categorical embedding activations, and the table is not read: the
        sparse-table step looks the rows up itself, so its autograd yields
        compact [B, K, D] cotangents and no table gradient
        (train/sparse_tables.py)."""
        cfg = self.config
        train = self.training if train is None else train
        if train and self.schema.encoded_text:
            raise ValueError(
                f"tower {self.schema.table!r}: its text encoder is frozen and runs in inference form only; "
                "train on the vectors it produces, stored as a text column"
            )
        if train and cfg.dropout_rate > 0 and generator is None:
            raise ValueError(
                f"training form with dropout_rate={cfg.dropout_rate} needs a torch.Generator "
                "for the dropout masks (generator=...)"
            )
        dense = batch.dense.to(self.compute_dtype)
        parts = []
        if self.blocks:
            projected = [
                F.relu(_dense(getattr(self, name),
                              self._encoded(batch) if start is None else dense[:, start : start + width]))
                for name, start, width in self.blocks
            ]
            parts.append(_dense(self.dense_projection, torch.cat(projected, dim=1)))
        if self.schema.num_categorical:
            emb = self.embeddings(batch.cat_ids) if emb_override is None else emb_override
            parts.append(emb.to(self.compute_dtype))
        x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
        for i in range(len(cfg.tower_hidden_dims) - 1):
            x = F.relu(_dense(getattr(self, f"mlp_{i}"), x))
            if cfg.use_batch_norm:
                x = getattr(self, f"bn_{i}")(x, train)
            if train and cfg.dropout_rate > 0:
                x = dropout(x, cfg.dropout_rate, generator, self.mesh)
        x = _dense(self.head, x).float()
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)

    def _encoded(self, batch: TowerBatch) -> torch.Tensor:
        """The encoded text column's pooled vector [B, embed_dim] in the
        compute dtype, from the batch's token ids and lengths."""
        (t,) = self.schema.encoded_text
        if batch.text_ids is None or batch.text_lengths is None:
            raise ValueError(f"tower {self.schema.table!r} encodes {t.name!r}: the batch needs text_ids and text_lengths")
        if batch.text_ids.shape[1] > t.max_length:
            raise ValueError(f"{t.name!r}: {batch.text_ids.shape[1]} tokens a text, max_length {t.max_length}")
        with span("serve.text"):
            return getattr(self, f"encoder_{t.name}")(batch.text_ids, batch.text_lengths).to(self.compute_dtype)
