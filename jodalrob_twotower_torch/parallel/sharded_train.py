"""Training on the mesh (port of ``jodalrob_twotower_tpu/parallel/sharded_train.py``).

The reference places the train state on the mesh (tables row-sharded or
replicated, everything else replicated), shards each batch over the
``data`` axis and jits the ordinary train step, and XLA writes the
distributed program. Here each rank holds a copy of the state on its
device, made equal by a broadcast from rank 0, and runs the mesh steps of
``train/train_step.py`` on its block of every global batch: the global
in-batch negatives through the mesh's fused CE (or the gathered
embeddings), global BatchNorm statistics, one all-reduce SUM of every
gradient, and the same optimizer update on every rank. Only the default
mesh is ported: replicated tables (``embedding_sharding`` "auto" up to
65,536 rows, or "replicated") and replicated stores; row-sharded tables and
stores and the sparse mesh wait for ROADMAP A12b.
"""

from __future__ import annotations

import numpy as np
import torch

from jodalrob_twotower_torch.parallel.mesh import put_replicated, resolve_embedding_sharding, shard_batch
from jodalrob_twotower_torch.train.train_step import (
    TrainState,
    create_train_state,
    make_indexed_train_step,
    make_sampled_train_steps,
    make_scanned_train_steps,
    make_train_step,
)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to the PyTorch package yet (ROADMAP A12b)")


def _is_table_row_leaf(name: str, leaf: torch.Tensor, n_data: int) -> bool:
    """A leaf would be row-sharded iff it is an embedding table (or a
    row-by-row optimizer leaf of one) whose rows divide the data axis."""
    return "embeddings.table" in name and leaf.ndim >= 1 and leaf.shape[0] % max(n_data, 1) == 0 \
        and leaf.shape[0] >= 128


def state_shardings(state: TrainState, mesh, *, shard_tables: bool = True) -> dict[str, str]:
    """Each leaf of the state's params and batch statistics -> "rows" (it
    would be row-sharded over the data axis) or "replicated", by the
    reference's rule. The port runs "replicated" only:
    ``shard_tables=False``, which ``embedding_sharding`` "auto" resolves to
    for tables up to 65,536 rows."""
    out = {}
    for name, leaf in {**state.params, **state.batch_stats}.items():
        out[name] = "rows" if shard_tables and _is_table_row_leaf(name, leaf, mesh.size) else "replicated"
    return out


def _check_mesh_config(model, cfg, mesh, batch_size: int) -> None:
    if batch_size % max(mesh.size, 1):
        raise ValueError(
            f"batch_size {batch_size} must divide the data axis ({mesh.size}) to shard the batch dim"
        )
    if resolve_embedding_sharding(cfg.mesh, model.schema) != "replicated" and mesh.size > 1:
        raise _not_ported("row-sharded embedding tables")
    if cfg.mesh.store_sharding != "replicated":
        raise _not_ported("store_sharding='rows' (row-sharded feature stores)")
    if cfg.mesh.grad_compression != "none":
        raise _not_ported("the compressed gradient sync (grad_compression)")


def replicated_state(model, cfg, mesh, total_steps: int) -> tuple[TrainState, object]:
    """A train state of ``model``'s current weights on the rank's device,
    every tensor rank 0's (a broadcast), with its optimizer."""
    state, tx = create_train_state(model, cfg, cfg.seed, total_steps, device=mesh.device)
    for t in (*state.params.values(), *state.batch_stats.values()):
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
    (replicated: every rank holds the same host stores)."""
    _check_mesh_config(model, cfg, mesh, batch_size)
    state, tx = replicated_state(model, cfg, mesh, total_steps)
    scan_steps = make_scanned_train_steps(model, cfg, tx, n_inner, mesh=mesh)
    single_step = make_indexed_train_step(model, cfg, tx, with_metrics=True, mesh=mesh)

    def put_store(store):
        return tuple(torch.as_tensor(np.ascontiguousarray(x)).to(mesh.device) for x in store)

    return state, tx, scan_steps, single_step, put_idx_fn(mesh), put_store


def make_sharded_sampled_steps(model, cfg, tx, mesh, n_inner: int, batch_size: int):
    """On-device sampling on the mesh: ``sampled_steps(state, sample_seed,
    pairs_dev [P, 2], n_store, c_store)`` draws each step's global batch of
    ``batch_size`` from (sample_seed, global step) on every rank and trains
    the rank's block of it. Returns (sampled_steps, put_pairs), the latter
    placing the pair set on the rank's device."""
    steps = make_sampled_train_steps(model, cfg, tx, n_inner, batch_size, mesh=mesh)

    def put_pairs(pairs) -> torch.Tensor:
        return torch.from_numpy(np.asarray(pairs, np.int64)).to(mesh.device)

    return steps, put_pairs
