"""Training on the mesh (port of ``jodalrob_twotower_tpu/parallel/sharded_train.py``).

The reference places the train state on the mesh (tables row-sharded or
replicated, everything else replicated), shards each batch over the
``data`` axis and jits the ordinary train step, and XLA writes the
distributed program. Here each rank holds its share of the state on its
device and runs the mesh steps of ``train/train_step.py`` on its block of
every global batch: the global in-batch negatives through the mesh's fused
CE (or the gathered embeddings), global BatchNorm statistics, one
all-reduce SUM of the replicated gradients, and the same optimizer update
on every rank.

:func:`state_shardings` is the reference's layout rule. A replicated leaf
is rank 0's on every rank (a broadcast). A "rows" leaf, an embedding table
under the row-sharded modes (``embedding_sharding`` "gspmd_rows", which
"auto" picks above 65,536 rows, or "shard_map") and its optimizer leaves
(rowwise Adagrad's [R/n, 1] accumulator, or AdamW's mu and nu), is the
rank's block ``[r R/n, (r+1) R/n)``, drawn whole from the seed and cut, so
a mesh state is one device's state cut into blocks. Stores are replicated
or, with ``store_sharding="rows"``, row-sharded too
(``parallel/sharded_store.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from jodalrob_twotower_torch.parallel.mesh import put_replicated, shard_batch
from jodalrob_twotower_torch.parallel.sharded_store import resolve_store_placement
from jodalrob_twotower_torch.train.train_step import (
    TrainState,
    create_train_state,
    make_indexed_train_step,
    make_sampled_train_steps,
    make_scanned_train_steps,
    make_train_step,
)


def _is_table_row_leaf(name: str, leaf: torch.Tensor, n_data: int) -> bool:
    """A leaf is row-sharded iff it is an embedding table whose (128-aligned)
    rows divide the data axis."""
    return "embeddings.table" in name and leaf.ndim >= 1 and leaf.shape[0] % max(n_data, 1) == 0 \
        and leaf.shape[0] >= 128


def state_shardings(state: TrainState, mesh, *, shard_tables: bool = True) -> dict[str, str]:
    """The reference's rule on a one-device state: each leaf of the params
    and batch statistics -> "rows" (cut to the rank's block on a mesh) or
    "replicated". ``shard_tables=False`` is ``embedding_sharding``
    "replicated" ("auto" up to 65,536 rows). A mesh model built row-sharded
    names its own "rows" leaves (``model.row_sharded_keys``), which are
    these tables."""
    out = {}
    for name, leaf in {**state.params, **state.batch_stats}.items():
        out[name] = "rows" if shard_tables and _is_table_row_leaf(name, leaf, mesh.size) else "replicated"
    return out


def _check_mesh_config(model, cfg, mesh, batch_size: int) -> None:
    if batch_size % max(mesh.size, 1):
        raise ValueError(
            f"batch_size {batch_size} must divide the data axis ({mesh.size}) to shard the batch dim"
        )


def replicated_state(model, cfg, mesh, total_steps: int) -> tuple[TrainState, object]:
    """A train state of ``model``'s current weights on the rank's device,
    every replicated tensor rank 0's (a broadcast) and every row-sharded
    one the rank's own block, with its optimizer."""
    state, tx = create_train_state(model, cfg, cfg.seed, total_steps, device=mesh.device)
    for name, t in {**state.params, **state.batch_stats}.items():
        if name not in model.row_sharded_keys:
            put_replicated(t, mesh)
    return state, tx


def make_sharded_train(model, cfg, mesh, batch_size: int, total_steps: int):
    """(state, train_step, shard_batch): ``train_step(state, batch)`` on the
    rank's block of a global batch, which ``shard_batch(global PairBatch)``
    cuts and places on the rank's device. ``model`` must be the mesh model
    (``models.build_model(schema, cfg, mesh)``) with its initial weights."""
    _check_mesh_config(model, cfg, mesh, batch_size)
    state, tx = replicated_state(model, cfg, mesh, total_steps)
    step = make_train_step(model, cfg, tx, mesh=mesh)
    return state, step, lambda batch: shard_batch(batch, mesh)


def put_idx_fn(mesh):
    """``put_idx(idx)``: the rank's block of a global [B, 2] batch or
    [n, B, 2] stack of pair indices, int64 on the rank's device."""

    def put_idx(idx) -> torch.Tensor:
        idx = np.asarray(idx, np.int64)
        block = mesh.block(idx.shape[-2])
        return torch.from_numpy(np.ascontiguousarray(idx[..., block, :])).to(mesh.device)

    return put_idx


def make_sharded_indexed_train(model, cfg, mesh, batch_size: int, total_steps: int, *, n_inner: int = 8):
    """Indexed training on the mesh, the Trainer's host-fed path. Returns
    (state, tx, scan_steps, single_step, put_idx, put_store):
    ``scan_steps(state, idx_stack [n_inner, b, 2], n_store, c_store)`` and
    ``single_step(state, idx [b, 2], n_store, c_store)`` (with metrics) on
    the rank's blocks that ``put_idx`` cuts from global batches, over
    stores that ``put_store((dense, cat_ids))`` places on the rank's device
    (whole, or the rank's block of rows under ``store_sharding="rows"``,
    gathered through the exchange)."""
    _check_mesh_config(model, cfg, mesh, batch_size)
    state, tx = replicated_state(model, cfg, mesh, total_steps)
    store_gather, put_store = resolve_store_placement(cfg, mesh)
    scan_steps = make_scanned_train_steps(model, cfg, tx, n_inner, mesh=mesh, store_gather=store_gather)
    single_step = make_indexed_train_step(model, cfg, tx, with_metrics=True, mesh=mesh, store_gather=store_gather)
    return state, tx, scan_steps, single_step, put_idx_fn(mesh), put_store


def put_pairs_fn(mesh):
    """``put_pairs(pairs)``: the whole pair set on the rank's device (every
    rank draws the global batch from it)."""

    def put_pairs(pairs) -> torch.Tensor:
        return torch.from_numpy(np.asarray(pairs, np.int64)).to(mesh.device)

    return put_pairs


def make_sharded_sampled_steps(model, cfg, tx, mesh, n_inner: int, batch_size: int):
    """On-device sampling on the mesh: ``sampled_steps(state, sample_seed,
    pairs_dev [P, 2], n_store, c_store)`` draws each step's global batch of
    ``batch_size`` from (sample_seed, global step) on every rank and trains
    the rank's block of it, over stores placed as
    :func:`make_sharded_indexed_train` places them. Returns (sampled_steps,
    put_pairs), the latter placing the pair set on the rank's device."""
    store_gather, _ = resolve_store_placement(cfg, mesh)
    steps = make_sampled_train_steps(model, cfg, tx, n_inner, batch_size, mesh=mesh, store_gather=store_gather)
    return steps, put_pairs_fn(mesh)
