"""Row-sharded sparse-table training: O(batch) updates on a mesh (port of
``jodalrob_twotower_tpu/parallel/sharded_sparse.py``).

BASELINE config 3 at full spec: 10M-row embedding tables row-sharded over
the devices, trained with the O(batch) sparse rowwise-Adagrad path
(``train/sparse_tables.py``) rather than dense table gradients.

Layout (:func:`sparse_state_shardings`): each ``SparseTable``'s table
[R, D] and accumulator [R, 1] row-sharded over the ``data`` axis (R is
128-aligned by the unified-table layout, so it divides any axis up to 128):
rank r holds rows ``[r R/n, (r+1) R/n)`` of both. The dense tower params,
their optimizer state and the BatchNorm statistics are replicated (rank
0's, broadcast), the pair indices cut to each rank's block of every global
batch, and the stores replicated or row-sharded (``store_sharding``).

The reference jits its unmodified sparse step with these shardings and lets
XLA partition the lookup and the touched-rows scatter. The port writes the
same algorithm out in the step (``make_sparse_train_step(mesh=...)``): the
lookup is the row exchange, and the compact cotangents and their rows are
all-gathered so that each rank updates the rows of its block, in global
batch order.
"""

from __future__ import annotations

from jodalrob_twotower_torch.parallel.mesh import put_replicated
from jodalrob_twotower_torch.parallel.sharded_store import resolve_store_placement
from jodalrob_twotower_torch.parallel.sharded_train import put_idx_fn, put_pairs_fn
from jodalrob_twotower_torch.train.optimizer import build_optimizer
from jodalrob_twotower_torch.train.sparse_tables import (
    TABLE_KEYS,
    SparseTable,
    SparseTrainState,
    create_sparse_train_state,
    deferred_sparse_steps_fn,
    make_sampled_sparse_steps,
    make_sparse_train_step,
)
from jodalrob_twotower_torch.train.train_step import scanned_fn

TABLE_FIELDS = tuple(TABLE_KEYS.values())


def sparse_state_shardings(state: SparseTrainState, mesh) -> dict[str, str]:
    """The reference's rule: the two SparseTables' leaves -> "rows", every
    other leaf (dense params, their moments, the statistics) ->
    "replicated". Keys: ``<field>.table``, ``<field>.accumulator``, and
    the dense params' and statistics' own names."""
    out = {f"{f}.{leaf}": "rows" for f in TABLE_FIELDS for leaf in ("table", "accumulator")}
    out.update({k: "replicated" for k in {**state.dense_params, **state.batch_stats}})
    return out


def sharded_sparse_state(model, cfg, mesh, total_steps: int):
    """(state, tx): ``model``'s current weights as a sparse train state on
    the rank's device, the dense leaves rank 0's and each table and
    accumulator the rank's block of rows (the model's own blocks when it
    was built row-sharded, ``models.build_model``; else cut here)."""
    state, tx = create_sparse_train_state(model, cfg, cfg.seed, total_steps, device=mesh.device)
    for t in (*state.dense_params.values(), *state.batch_stats.values()):
        put_replicated(t, mesh)
    if mesh.size > 1 and not model.row_sharded_keys:
        for f in TABLE_FIELDS:
            st = getattr(state, f)
            block = mesh.block(st.table.shape[0])
            setattr(state, f, SparseTable(st.table[block].clone(), st.accumulator[block].clone()))
    return state, tx


def make_sharded_sparse_train(model, cfg, mesh, batch_size: int, total_steps: int, *, with_metrics: bool = False,
                              n_inner: int | None = None, defer_updates: bool = False):
    """(state, step, put_batch, put_store[, scan_steps]), the reference's
    order. ``step(state, pair_idx [b, 2], notice_store, company_store)`` is
    the sparse O(batch) step on the rank's block of a global batch, which
    ``put_batch`` cuts (a [B, 2] batch or an [n, B, 2] stack); stores are
    (dense, cat_ids) from ``put_store``. With ``n_inner`` a fifth value runs
    n_inner steps per call over an [n_inner, b, 2] stack, with one batched
    table update per window under ``defer_updates``."""
    if batch_size % max(mesh.size, 1):
        raise ValueError(f"batch_size {batch_size} must divide the data axis ({mesh.size}) to shard the batch dim")
    state, tx = sharded_sparse_state(model, cfg, mesh, total_steps)
    store_gather, put_store = resolve_store_placement(cfg, mesh)
    step = make_sparse_train_step(model, cfg, tx, total_steps, with_metrics=with_metrics, mesh=mesh,
                                  store_gather=store_gather)
    put_batch = put_idx_fn(mesh)
    if n_inner is None:
        return state, step, put_batch, put_store
    if defer_updates:
        scan_steps = deferred_sparse_steps_fn(model, cfg, tx, total_steps, n_inner=n_inner, mesh=mesh,
                                              store_gather=store_gather)
    else:
        scan_steps = scanned_fn(make_sparse_train_step(model, cfg, tx, total_steps, mesh=mesh,
                                                       store_gather=store_gather), n_inner)
    return state, step, put_batch, put_store, scan_steps


def make_sharded_sampled_sparse(model, cfg, mesh, state: SparseTrainState, n_inner: int, batch_size: int,
                                total_steps: int, *, defer_updates: bool = False):
    """On-device sampling for mesh sparse training: every rank draws each
    step's global batch from (sample_seed, global step), as
    ``train_step.sampled_scan_fn`` draws, and trains its block of it with
    the layout of :func:`make_sharded_sparse_train` (whose ``state`` this
    takes). Returns (steps, put_pairs): ``steps(state, sample_seed,
    pairs_dev [P, 2], n_store, c_store) -> (state, {"loss": [n_inner]})``."""
    del state  # the layout is fixed by the model and the mesh
    tx = build_optimizer(cfg.optimizer, total_steps)  # a pure function of the config
    store_gather, _ = resolve_store_placement(cfg, mesh)
    if defer_updates:
        steps = deferred_sparse_steps_fn(model, cfg, tx, total_steps, sampled=(n_inner, batch_size), mesh=mesh,
                                         store_gather=store_gather)
    else:
        steps = make_sampled_sparse_steps(model, cfg, tx, total_steps, n_inner, batch_size, mesh=mesh,
                                          store_gather=store_gather)
    return steps, put_pairs_fn(mesh)

