"""Unified categorical embedding table (port of
``jodalrob_twotower_tpu/models/embedding.py``).

All features share one ``[total_rows, D]`` table; each feature's row block
starts at a 128-row boundary, and per-feature ids are clamped into their
vocab and shifted by static offsets, so one lookup serves every feature.
The layout fixes the param shapes, so the flax table maps 1:1 onto this one.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from jodalrob_twotower_torch.ops.embedding_grad import make_dense_grad_lookup, make_onehot_lookup
from jodalrob_twotower_torch.ops.embedding_lookup import embedding_lookup

# Each feature's row block is padded to a multiple of 128 rows, so every
# 128-row tile belongs to exactly ONE feature (the one-hot lookup's block
# test relies on that). The waste is < 128 rows per feature.
ROW_ALIGNMENT = 128


def table_layout(vocab_sizes: tuple[int, ...], row_alignment: int = ROW_ALIGNMENT):
    """Compute (offsets, total_rows) for the unified table; every feature's
    block starts at a row_alignment boundary."""
    offsets = np.zeros(len(vocab_sizes), dtype=np.int32)
    acc = 0
    for i, v in enumerate(vocab_sizes):
        offsets[i] = acc
        acc += -(-v // row_alignment) * row_alignment
    return offsets, max(acc, row_alignment)


def absolute_rows(vocab_sizes: tuple[int, ...], cat_ids: torch.Tensor) -> torch.Tensor:
    """Clamp per-feature ids into their vocab and add the unified-table
    offsets - the mapping EmbeddingCollection applies. cat_ids: int [B, K]
    -> int32 [B, K]."""
    return make_absolute_rows(vocab_sizes)(cat_ids)


def _shift(cat_ids: torch.Tensor, vmax: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    ids = torch.minimum(torch.clamp(cat_ids.to(torch.int32), min=0), vmax[None, :])
    return ids + offsets[None, :]


def make_absolute_rows(vocab_sizes: tuple[int, ...]):
    """:func:`absolute_rows` for fixed vocabs, its two small constants kept
    on each device: a fresh host-to-device copy per call would synchronise
    the stream."""
    offsets, _ = table_layout(vocab_sizes)
    vmax = np.asarray(vocab_sizes, np.int32) - 1
    consts: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def rows(cat_ids: torch.Tensor) -> torch.Tensor:
        c = consts.get(cat_ids.device)
        if c is None:
            c = consts[cat_ids.device] = (torch.as_tensor(vmax, device=cat_ids.device),
                                          torch.as_tensor(offsets, device=cat_ids.device))
        return _shift(cat_ids, *c)

    return rows


def resolve_lookup_mode(model_cfg) -> str:
    """``ModelConfig.embedding_lookup`` with the dtype gate applied: "auto"
    demotes to "gather" when ``compute_dtype != bfloat16`` - the one-hot
    lookup emits bf16 activations, which is free exactly when the towers
    already compute in bf16. "onehot" stays forced."""
    mode = getattr(model_cfg, "embedding_lookup", "auto")
    if mode == "auto" and getattr(model_cfg, "compute_dtype", "bfloat16") != "bfloat16":
        return "gather"
    return mode


def tile_feature_map(vocab_sizes: tuple[int, ...], row_alignment: int = ROW_ALIGNMENT):
    """Static map tile_index -> owning feature for the aligned layout."""
    out = []
    for k, v in enumerate(vocab_sizes):
        out.extend([k] * (-(-v // row_alignment)))
    return np.asarray(out or [0], dtype=np.int32)


class EmbeddingCollection(nn.Module):
    """One embedding table row-block per categorical feature, unified.

    Call with int ids ``[B, K]`` -> embeddings ``[B, K * embed_dim]``: float32
    from the gather, bfloat16 from the one-hot lookup kernel. The table's
    gradient is the dense table-gradient kernel wherever the one-hot lookup
    or the dense gradient is active (:meth:`_dense_grad_active`), else the
    gather's own scatter. Where neither is active, ``use_pallas`` takes the
    row-gather kernel (ops/embedding_lookup.embedding_lookup_pallas) for the
    gather, as the reference's ``use_pallas`` takes its Pallas gather: on
    the card, past the 65,536-row dense envelope or with
    ``grad_mode="scatter"``.

    With ``row_mesh`` (a mesh of more than one rank; ``models.build_model``
    passes it for the row-sharded modes) the table is row-sharded: this
    rank holds the block ``[r R/n, (r+1) R/n)`` (``shard_rows`` rows, from
    ``row_offset``) and every lookup is the row exchange of
    ``parallel/sharded_embedding.make_sharded_lookup``, with the row-gather
    kernel under ``use_pallas``. The one-hot and dense-gradient kernels are
    the replicated table's and are not used there. Every rank must call it
    alike (the exchange is a collective).
    """

    # Above this many table rows the reference's dense one-hot path stops
    # paying (its cost grows with rows x batch); the port keeps the same
    # envelope for "auto" and the forced mode.
    DENSE_GRAD_MAX_ROWS = 1 << 16

    def __init__(
        self,
        vocab_sizes: tuple[int, ...],
        embed_dim: int,
        *,
        grad_mode: str = "auto",
        lookup_mode: str = "auto",
        use_pallas: bool = False,
        row_mesh=None,
    ) -> None:
        super().__init__()
        self.vocab_sizes = tuple(vocab_sizes)
        self.embed_dim = embed_dim
        self.use_pallas = use_pallas
        self.grad_mode = grad_mode
        self.lookup_mode = lookup_mode
        _, self.total_rows = table_layout(self.vocab_sizes)
        self.row_mesh = row_mesh if row_mesh is not None and row_mesh.size > 1 else None
        self.shard_rows, self.row_offset, self._sharded = self.total_rows, 0, None
        if self.row_mesh is not None:
            from jodalrob_twotower_torch.parallel.sharded_embedding import make_sharded_lookup

            if self.total_rows % self.row_mesh.size:
                raise ValueError(f"rows {self.total_rows} must divide the 'data' axis ({self.row_mesh.size}) "
                                 "to row-shard the table")
            self._sharded = make_sharded_lookup(self.row_mesh, use_pallas=use_pallas)
            block = self.row_mesh.block(self.total_rows)
            self.shard_rows, self.row_offset = block.stop - block.start, block.start
        self.table = nn.Parameter(torch.empty(self.shard_rows, embed_dim))
        nn.init.normal_(self.table, std=1.0 / np.sqrt(embed_dim))
        tiles = tile_feature_map(self.vocab_sizes)
        self._onehot = make_onehot_lookup(self.total_rows, tiles)
        self._dense_grad = make_dense_grad_lookup(self.total_rows, tiles)
        self._rows = make_absolute_rows(self.vocab_sizes)

    def forward(self, cat_ids: torch.Tensor) -> torch.Tensor:
        if cat_ids.dim() != 2 or cat_ids.shape[1] != len(self.vocab_sizes):
            raise ValueError(
                f"cat_ids must be [B, {len(self.vocab_sizes)}], got {tuple(cat_ids.shape)}"
            )
        rows = self._rows(cat_ids)
        if self._sharded is not None:
            emb = self._sharded(self.table, rows, self.total_rows)
        elif self._onehot_lookup_active(rows):
            emb = self._onehot(self.table, rows)
        elif self._dense_grad_active(rows):
            emb = self._dense_grad(self.table, rows)
        else:
            emb = embedding_lookup(self.table, rows, use_pallas=self.use_pallas)
        b, k = cat_ids.shape
        return emb.reshape(b, k * self.embed_dim)

    def _onehot_lookup_active(self, rows: torch.Tensor) -> bool:
        """``lookup_mode`` resolution (the caller has already applied
        :func:`resolve_lookup_mode`'s dtype gate). "auto" takes the kernel for
        CUDA tensors when the table is within the dense envelope, the grad
        mode keeps the matching dense backward and embed_dim % 8 == 0.
        "gather" never does. "onehot" forces it (its plain version on the
        CPU) and raises where it cannot run, instead of silently reverting."""
        if self.lookup_mode == "gather":
            return False
        if self.lookup_mode == "onehot":
            if self.grad_mode == "scatter":
                raise ValueError(
                    "embedding_lookup='onehot' forces the one-hot lookup, whose "
                    "backward is the dense one-hot gradient - it cannot honor "
                    "embedding_grad='scatter'; use embedding_lookup='auto'/'gather' "
                    "to keep the scatter backward, or embedding_grad='auto'/'dense'"
                )
            if self.total_rows > self.DENSE_GRAD_MAX_ROWS:
                raise ValueError(
                    f"embedding_lookup='onehot' forced but the unified table "
                    f"({self.total_rows} rows) exceeds the dense one-hot envelope "
                    f"({self.DENSE_GRAD_MAX_ROWS}); use 'auto' or 'gather'"
                )
            if self.embed_dim % 8:
                raise ValueError(
                    f"embedding_lookup='onehot' needs embed_dim % 8 == 0 (the "
                    f"kernel moves 16-byte row pieces); got {self.embed_dim} - use "
                    "'auto' or 'gather'"
                )
            return True
        return (
            rows.is_cuda
            and self.total_rows <= self.DENSE_GRAD_MAX_ROWS
            and self.grad_mode != "scatter"
            and self.embed_dim % 8 == 0
        )

    def _dense_grad_active(self, rows: torch.Tensor) -> bool:
        """``grad_mode`` resolution for the gather forward (reference
        ``models/embedding.py:212-228``): "dense" always takes the dense
        table-gradient backward, "scatter" never; "auto" takes it for CUDA
        tensors (the port runs on one device) when the table is within the
        dense envelope. On the CPU "auto" keeps the gather's scatter, as the
        reference does on its CPU backend."""
        if self.grad_mode == "dense":
            return True
        if self.grad_mode == "scatter":
            return False
        return rows.is_cuda and self.total_rows <= self.DENSE_GRAD_MAX_ROWS
