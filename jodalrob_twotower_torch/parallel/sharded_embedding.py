"""Embedding lookups on a mesh (port of
``jodalrob_twotower_tpu/parallel/sharded_embedding.py``).

**Replicated tables** (``embedding_sharding="auto"`` up to 65,536 rows, or
"replicated") need no lookup of their own: each rank runs the model's
unchanged ``models/embedding.EmbeddingCollection`` on its block of the
batch, which on the card takes the one-hot lookup kernel (K1) forward and
the dense table gradient (K2) over the rank's cotangents, exactly the
reference's per-device choice. The [R, D] partials are summed across ranks
by the train step's one all-reduce of the replicated gradients
(``parallel/mesh.sync_grads``), where the reference's shard_map ends its
backward with a ``psum``. The reference's name ``ShardedDenseGradLookup``
points to that collection.

**Row-sharded tables** ("gspmd_rows", which "auto" picks above 65,536
rows, and "shard_map"): rank r holds rows ``[r R/n, (r+1) R/n)`` of each
table, and :func:`make_sharded_lookup` exchanges rows as the reference's
``shard_map`` writes it out (``:222-263``):

  1. every rank all-gathers the flat ids of the global batch (B K ints);
  2. each rank gathers the ids that fall in its row range from its own
     shard and zeroes the rest (on the card under
     ``MeshConfig.use_pallas_lookup`` the row-gather kernel K4's zero form,
     one launch; else ``index_select`` and a masked fill);
  3. a reduce-scatter sums the ranks' contributions (each row comes from
     one rank, the others add zeros, so the sum is exact) and hands each
     rank the rows of its own block of the batch.

Its backward is the transpose: an all-gather of the cotangents [B K, D]
and an ``index_add_`` of the in-range ones, in global batch order, into
zeros of the shard's shape and dtype. That is the whole gradient of the
rank's rows, so no all-reduce follows (``sync_grads`` passes the sharded
leaves). The reference's "gspmd_rows" lets XLA pick the collectives of
``jnp.take`` on a row-sharded table; PyTorch has no GSPMD, so in the port
both modes are this one exchange and compute the same function.
"""

from __future__ import annotations

from typing import Callable

import torch

from jodalrob_twotower_torch.models.embedding import EmbeddingCollection
from jodalrob_twotower_torch.ops import embedding_lookup as el
from jodalrob_twotower_torch.ops.embedding_lookup import local_rows
from jodalrob_twotower_torch.parallel.mesh import DATA_AXIS

# the reference's name for the replicated-table lookup of a mesh rank
ShardedDenseGradLookup = EmbeddingCollection

# out-of-range cotangents land in this many scratch rows past the shard
# (spread, so that the card's atomics do not pile onto one address)
_SCRATCH_ROWS = 1024


def masked_shard_gather(shard: torch.Tensor, ids: torch.Tensor, offset: int, *, use_pallas: bool = False
                        ) -> torch.Tensor:
    """Step 2 of the exchange: rows ``ids`` (global, flat) of the table
    whose rows ``[offset, offset + shard_rows)`` are ``shard``, read from
    the shard where they lie in it and zero elsewhere: [N, D] in the
    shard's dtype. ``use_pallas`` takes K4's zero form, one launch on the
    card."""
    if use_pallas:
        return el.embedding_lookup_pallas_shard(shard, ids, offset)
    return el.embedding_lookup_pallas_shard_plain(shard, ids, offset)


def exchange_rows(mesh, shard: torch.Tensor, ids: torch.Tensor, *, use_pallas: bool = False) -> torch.Tensor:
    """The exchange outside autograd: this rank's ids [N] (global rows of
    a table row-sharded over ``mesh``, this rank holding ``shard``) ->
    their rows [N, D]. Every rank must call it alike (N equal on every
    rank): the all-gather and the reduce-scatter are collectives."""
    all_ids = mesh.all_gather_rows(ids.reshape(-1))
    partial = masked_shard_gather(shard, all_ids, mesh.rank * shard.shape[0], use_pallas=use_pallas)
    return mesh.reduce_scatter_rows(partial)


class _RowShardedLookup(torch.autograd.Function):
    """y = the rows ``ids`` of the row-sharded table whose rank block is
    ``shard`` (:func:`exchange_rows`); dy -> the shard's gradient."""

    @staticmethod
    def forward(ctx, shard, ids, mesh, use_pallas):
        all_ids = mesh.all_gather_rows(ids)
        offset = mesh.rank * shard.shape[0]
        partial = masked_shard_gather(shard, all_ids, offset, use_pallas=use_pallas)
        ctx.save_for_backward(all_ids)
        ctx.mesh, ctx.offset, ctx.shape, ctx.dtype = mesh, offset, shard.shape, shard.dtype
        return mesh.reduce_scatter_rows(partial)

    @staticmethod
    def backward(ctx, g):
        (all_ids,) = ctx.saved_tensors
        rows, d = ctx.shape
        all_g = ctx.mesh.all_gather_rows(g.contiguous())
        local, in_range = local_rows(all_ids, ctx.offset, rows)
        scratch = rows + torch.arange(all_ids.numel(), device=local.device) % _SCRATCH_ROWS
        grad = torch.zeros((rows + _SCRATCH_ROWS, d), dtype=ctx.dtype, device=g.device)
        grad.index_add_(0, torch.where(in_range, local, scratch), all_g.to(ctx.dtype))
        return grad[:rows], None, None, None


def make_sharded_lookup(mesh, axis: str = DATA_AXIS, *, use_pallas: bool = False) -> Callable:
    """Build ``lookup(table, rows, total_rows=None) -> [b, K, D]``, the
    reference's ``make_sharded_lookup`` on one rank: ``table`` is the
    rank's block [R/n, D] of a table of ``total_rows`` = R rows
    (default: n times the block), ``rows`` int [b, K] the rank's block of
    the batch's absolute rows, the result their embeddings, differentiable
    in ``table``. ``use_pallas`` gathers with the row-gather kernel (K4) on
    the card. R must divide the axis, as the reference requires; the
    batch does by construction (each rank passes a block of ``b`` rows,
    ``mesh.block`` refusing a batch that does not divide), and every rank
    must pass the same ``b``."""
    n_shards = mesh.shape[axis]

    def lookup(table: torch.Tensor, rows: torch.Tensor, total_rows: int | None = None) -> torch.Tensor:
        b, k = rows.shape
        r = table.shape[0] * n_shards if total_rows is None else total_rows
        if r % n_shards or table.shape[0] * n_shards != r:
            raise ValueError(
                f"rows {r} and batch {b * n_shards} must divide the {axis!r} axis ({n_shards}), "
                f"each rank holding {r // n_shards} rows (got {table.shape[0]})"
            )
        out = _RowShardedLookup.apply(table, rows.reshape(-1), mesh, use_pallas)
        return out.reshape(b, k, table.shape[1])

    return lookup
