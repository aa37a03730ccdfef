"""Sparse-table training: O(batch) embedding updates for huge tables (port of
``jodalrob_twotower_tpu/train/sparse_tables.py``).

The standard step differentiates through the table lookup, so autograd forms
a dense [R, D] gradient and rowwise Adagrad touches every row: O(R) memory
traffic per step. The sparse step instead

1. looks the embeddings up outside autograd (``index_select``, never the
   row-gather kernel, as the reference's ``jnp.take``) and feeds them to the
   towers as ``emb_overrides``, each a leaf with ``requires_grad``;
2. takes the gradients of those leaves: compact [B, K, D] cotangents, no
   table gradient;
3. applies rowwise Adagrad to the touched rows only,

     acc[r]   += mean_d(G^2)      with G = sum over occurrences of g (dedup)
     table[r] -= lr * G / sqrt(acc'[r] + eps)

   With ``sparse_duplicate_handling="exact"`` (the default) the cotangents
   of each row's occurrences are summed first (:func:`segment_sum_duplicates`),
   which makes the sparse step equal to the dense step's rowwise Adagrad on
   any batch; "per_occurrence" adds and steps each occurrence on its own,
   exact only on batches without duplicate ids.

Dense (tower) params keep the AdamW transform of train/optimizer.py. Tables,
accumulators, dense params, their moments and the BatchNorm statistics are
updated in place, where the reference returns new arrays: a step returns the
same state object. Scatters whose index is a padding slot (the sentinel row
R that the reference's ``mode="drop"`` scatters drop) are routed to row
R - 1 with a value of exactly 0, so ``index_add_`` never sees an index out
of range and nothing changes. ``index_add_`` of floats on CUDA sums a row's
duplicates in no fixed order; the exact dedup leaves each row once, so the
table and accumulator scatters are deterministic, and only the segment sum
varies in the last bits.

On a mesh (the steps' ``mesh`` argument, ``parallel/sharded_sparse.py``)
each rank holds its block of rows of both tables and their accumulators
(``[r R/n, (r+1) R/n)``) and its block of every global batch. The lookup is
the row exchange outside autograd (``parallel/sharded_embedding.exchange_rows``),
the loss the mesh's, the dense gradients summed over the ranks. The compact
cotangents [b K, D] and their rows are all-gathered, in global batch
order; each rank keeps the rows of its block (the others become the
shard's sentinel, a zero update) and applies the same dedup and rowwise
Adagrad to its shard, so every row steps as on one device. A deferred
window gathers its stacked occurrences once, into the same step-major
order as one device's window.

Under the compressed gradient sync (``sync``,
``parallel/compressed_grads.py``) the lookup and the table update stay that
exact exchange, while each rank's towers train on its block as a batch of
its own: the dense gradients go through the compressed sum, and the compact
cotangents carry the same objective scale before they are gathered.
"""

from __future__ import annotations

import dataclasses

import torch

from jodalrob_twotower_torch.data.types import PairBatch, default_tower_gather
from jodalrob_twotower_torch.device import resolve_device
from jodalrob_twotower_torch.models.embedding import make_absolute_rows
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel
from jodalrob_twotower_torch.parallel.mesh import sync_grads
from jodalrob_twotower_torch.parallel.sharded_embedding import exchange_rows, local_rows
from jodalrob_twotower_torch.train.metrics import in_batch_metrics
from jodalrob_twotower_torch.train.optimizer import Optimizer, build_optimizer, warmup_constant_schedule
from jodalrob_twotower_torch.utils.profiling import span
from jodalrob_twotower_torch.train.train_step import (
    _forward_loss,
    dropout_generator,
    make_sharded_ce,
    sampled_scan_fn,
    scanned_fn,
)

# the tables' state_dict keys and the state's fields that hold them
TABLE_KEYS = {"notice_tower.embeddings.table": "notice_table", "company_tower.embeddings.table": "company_table"}
_DEFERRED_KEYS = ("rows_n", "g_n", "rows_c", "g_c")


@dataclasses.dataclass
class SparseTable:
    table: torch.Tensor  # [R, D]
    accumulator: torch.Tensor  # [R, 1]


@dataclasses.dataclass
class SparseTrainState:
    """What sparse training carries from step to step, on one device:
    ``dense_params`` are the model's parameters without the two tables
    (state_dict keys), ``seed`` is the base of every step's dropout
    generator."""

    step: int
    dense_params: dict[str, torch.Tensor]
    batch_stats: dict[str, torch.Tensor]
    opt_state: dict
    notice_table: SparseTable
    company_table: SparseTable
    seed: int

    @property
    def state_dict(self) -> dict[str, torch.Tensor]:
        """Every weight under the model's state_dict keys, tables included:
        the standard eval, encode and serving paths take the state as is."""
        return {**merged_params(self), **self.batch_stats}

    @property
    def device(self) -> torch.device:
        return self.notice_table.table.device


def merged_params(state: SparseTrainState) -> dict[str, torch.Tensor]:
    """The full parameter dict (state_dict keys), tables included."""
    return {**state.dense_params, **{k: getattr(state, f).table for k, f in TABLE_KEYS.items()}}


def create_sparse_train_state(
    model: TwoTowerModel, cfg, seed: int, total_steps: int, *, device=None
) -> tuple[SparseTrainState, Optimizer]:
    """A state holding copies of ``model``'s current weights on ``device``
    (None means the card), the two tables split out with accumulators at
    ``adagrad_init_accumulator``, and a fresh AdamW state for the rest;
    returns it with the dense optimizer (every leaf it sees is dense)."""
    if cfg.optimizer.embedding_optimizer != "rowwise_adagrad":
        raise ValueError(
            "sparse_tables implements rowwise Adagrad table updates; "
            f"embedding_optimizer={cfg.optimizer.embedding_optimizer!r} is only "
            "available on the dense (non-sparse-tables) path"
        )
    dev = resolve_device(device)
    buffers = {k for k, _ in model.named_buffers()}
    sd = {k: v.detach().to(dev, torch.float32).clone() for k, v in model.state_dict().items()}
    missing = set(TABLE_KEYS) - set(sd)
    if missing:
        raise ValueError(f"sparse tables need both towers' embedding tables; the model lacks {sorted(missing)}")
    dense = {k: v for k, v in sd.items() if k not in buffers and k not in TABLE_KEYS}
    batch_stats = {k: v for k, v in sd.items() if k in buffers}
    init_acc = cfg.optimizer.adagrad_init_accumulator
    tables = {
        f: SparseTable(sd[k], torch.full((sd[k].shape[0], 1), init_acc, dtype=sd[k].dtype, device=dev))
        for k, f in TABLE_KEYS.items()
    }
    tx = build_optimizer(cfg.optimizer, total_steps)
    return SparseTrainState(0, dense, batch_stats, tx.init(dense), tables["notice_table"],
                            tables["company_table"], int(seed)), tx


# Above this many occurrences the reference's segment-sum scatter fell off a
# cliff on its TPU while the cumsum-difference form scaled smoothly: per-step
# batches (B*K = 65-262k) take the scatter, deferred windows (n_inner*B*K >=
# 524k) the cumsum form. Kept under the reference's name and value so that
# tests can lower it on both sides.
_DEDUP_CUMSUM_MIN_ROWS = 1 << 19


def segment_sum_duplicates(rows: torch.Tensor, grads: torch.Tensor, sentinel: int):
    """Exact duplicate handling, fixed shapes: sum the per-occurrence
    cotangents of each unique row. rows [N] int, grads [N, D] float ->
    (unique_rows [N], summed_grads [N, D]); the unique rows sorted in the
    first slots, every unused slot holding ``sentinel`` (an out-of-range
    row) and zero grads. Below ``_DEDUP_CUMSUM_MIN_ROWS`` occurrences the
    sums are a scatter-add (``index_add_``) of the sorted cotangents into
    their segments; from it on, differences of one prefix sum at the
    segments' ends (the reference's two branches)."""
    n = rows.shape[0]
    order = torch.argsort(rows, stable=True)
    rs = rows.index_select(0, order)
    gs = grads.index_select(0, order)
    first = torch.ones(n, dtype=torch.bool, device=rows.device)
    first[1:] = rs[1:] != rs[:-1]
    seg = torch.cumsum(first.to(torch.int64), 0) - 1  # [n], in [0, n_unique)
    if n >= _DEDUP_CUMSUM_MIN_ROWS:
        # the prefix sums in the [D, n] layout: PyTorch scans a tensor's last
        # dim with parallel blocks, its dim 0 with one thread per column
        cs = torch.cumsum(gs.t().contiguous(), 1)
        pos = torch.arange(n, device=rows.device)
        last_pos = torch.zeros(n, dtype=torch.int64, device=rows.device).scatter_reduce_(0, seg, pos, "amax")
        g_end = cs.index_select(1, last_pos)
        # segments are contiguous after the sort: slot u's start - 1 is slot
        # u - 1's end, so one max-scatter serves both boundaries
        prev_last = torch.cat([last_pos.new_zeros(1), last_pos[:-1]])
        g_start = torch.where(pos > 0, cs.index_select(1, prev_last), torch.zeros((), dtype=cs.dtype, device=cs.device))
        g_sum = (g_end - g_start).t()
    else:
        g_sum = torch.zeros_like(gs).index_add_(0, seg, gs)
    # every occurrence of a row writes the same value into its segment's slot
    unique_rows = torch.full((n,), sentinel, dtype=rows.dtype, device=rows.device).scatter_(0, seg, rs)
    if n >= _DEDUP_CUMSUM_MIN_ROWS:
        # the cumsum form leaves garbage in unused slots; zero them as the
        # scatter branch does by construction
        g_sum = torch.where((unique_rows != sentinel)[:, None], g_sum, torch.zeros((), dtype=g_sum.dtype,
                                                                                   device=g_sum.device))
    return unique_rows, g_sum


def sparse_rowwise_adagrad_update(
    st: SparseTable, rows: torch.Tensor, grads: torch.Tensor, *, lr: float, eps: float, dedup: bool = True
) -> SparseTable:
    """Touched-rows-only rowwise Adagrad, in place on ``st`` (returned).
    rows [N] absolute rows (duplicates allowed), grads [N, D] float32
    per-occurrence cotangents. ``dedup=True`` sums each row's occurrences
    first: acc[r] += mean_d((sum g)^2) and the row steps once by the summed
    gradient, the dense path's semantics. ``dedup=False`` accumulates and
    steps every occurrence separately. The step divides by the accumulator
    after this update (gathered at rows clamped into the table)."""
    total_rows = st.table.shape[0]
    if dedup:
        rows, grads = segment_sum_duplicates(rows, grads, total_rows)
    valid = ((rows >= 0) & (rows < total_rows))[:, None]
    zero = torch.zeros((), dtype=grads.dtype, device=grads.device)
    safe = rows.clamp(0, total_rows - 1).long()
    gsq = torch.where(valid, (grads * grads).mean(-1, keepdim=True), zero)
    st.accumulator.index_add_(0, safe, gsq.to(st.accumulator.dtype))
    denom = torch.rsqrt(st.accumulator.index_select(0, safe) + eps)  # post-update acc
    step = torch.where(valid, (-lr * grads) * denom, zero)
    st.table.index_add_(0, safe, step.to(st.table.dtype))
    return st


def _on_mesh(mesh) -> bool:
    return mesh is not None and mesh.size > 1


def gather_occurrences(mesh, rows: torch.Tensor, grads: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Every rank's per-occurrence rows [..., N] and cotangents [..., N, D]
    (a leading window axis allowed) -> the global batch's, flat, in global
    batch order (step-major over a window, as one device's window)."""
    d = grads.shape[-1]
    rows, grads = rows.reshape(-1, rows.shape[-1]), grads.reshape(-1, grads.shape[-2], d)
    n_steps = rows.shape[0]
    all_rows = mesh.all_gather_rows(rows).reshape(mesh.size, n_steps, -1).transpose(0, 1)
    all_grads = mesh.all_gather_rows(grads).reshape(mesh.size, n_steps, -1, d).transpose(0, 1)
    return all_rows.reshape(-1), all_grads.reshape(-1, d)


def update_shard(st: SparseTable, rows: torch.Tensor, grads: torch.Tensor, mesh, **kw) -> SparseTable:
    """:func:`sparse_rowwise_adagrad_update` of the rank's shard ``st`` by
    global rows: a row outside the shard's block becomes the shard's
    sentinel (its update is zero and leaves the table and the accumulator
    as they were). Off a mesh, the update itself."""
    if not _on_mesh(mesh):
        return sparse_rowwise_adagrad_update(st, rows, grads, **kw)
    n = st.table.shape[0]
    local, in_range = local_rows(rows, mesh.rank * n, n)
    return sparse_rowwise_adagrad_update(st, torch.where(in_range, local, n), grads, **kw)


def make_sparse_train_step(
    model: TwoTowerModel,
    cfg,
    tx: Optimizer,
    total_steps: int,
    *,
    with_metrics: bool = False,
    defer_table_updates: bool = False,
    mesh=None,
    store_gather=None,
    sync=None,
):
    """Indexed train step over device-resident stores with sparse tables:
    ``step(state, pair_idx [B, 2], notice_store, company_store) -> (state,
    metrics)``, each store a (dense, cat_ids) tuple on the state's device.

    ``defer_table_updates=True`` leaves the tables untouched and returns the
    compact per-occurrence rows and cotangents in the metrics (keys
    ``rows_n``, ``g_n``, ``rows_c``, ``g_c``), for one batched update per
    window (:func:`make_deferred_sparse_steps`).

    With ``mesh`` (more than one rank) ``pair_idx`` is the rank's block of
    the global batch and the state's tables the rank's row blocks (module
    docstring); ``store_gather(store, rows) -> TowerBatch`` replaces the
    plain gather (a row-sharded store, ``parallel/sharded_store.py``).
    ``sync`` (the compressed sync) keeps the mesh's lookup and table update
    and makes the towers' step the rank's own (module docstring).
    ``pair_idx`` may also be a function of the state that draws the indices
    (``train_step.sampled_scan_fn``'s)."""
    n_rows = make_absolute_rows(model.schema.notice.vocab_sizes)
    c_rows = make_absolute_rows(model.schema.company.vocab_sizes)
    emb_dim = cfg.model.categorical_embedding_dim
    emb_lr = cfg.optimizer.embedding_learning_rate or cfg.optimizer.learning_rate
    emb_schedule = warmup_constant_schedule(emb_lr, total_steps, cfg.optimizer.warmup_ratio)
    eps = cfg.optimizer.adagrad_eps
    dedup = cfg.optimizer.sparse_duplicate_handling == "exact"
    gather = store_gather or default_tower_gather
    sharded_ce = sync.sharded_ce if sync is not None else make_sharded_ce(cfg, mesh)
    loss_mesh = None if sync is not None else mesh
    sharded = _on_mesh(mesh)

    def lookup(st: SparseTable, rows: torch.Tensor) -> torch.Tensor:
        if sharded:
            return exchange_rows(mesh, st.table, rows.reshape(-1))
        return st.table.index_select(0, rows.reshape(-1))

    def step(state: SparseTrainState, pair_idx, notice_store, company_store):
        with span("train.sparse_step", root=state.step):
            return _step(state, pair_idx, notice_store, company_store)

    def _step(state: SparseTrainState, pair_idx, notice_store, company_store):
        if callable(pair_idx):
            pair_idx = pair_idx(state)
        batch = PairBatch(notice=gather(notice_store, pair_idx[:, 0]),
                          company=gather(company_store, pair_idx[:, 1]))
        b = pair_idx.shape[0]
        # lookups outside autograd -> compact activation cotangents
        rows_n, rows_c = n_rows(batch.notice.cat_ids), c_rows(batch.company.cat_ids)
        emb_n = lookup(state.notice_table, rows_n).reshape(b, -1).requires_grad_(True)
        emb_c = lookup(state.company_table, rows_c).reshape(b, -1).requires_grad_(True)
        generator = dropout_generator(cfg, state, sync)
        dense = {k: v.detach().requires_grad_(True) for k, v in state.dense_params.items()}
        # the tables complete the model's keys; with the overrides no tower reads them
        weights = {**dense, **state.batch_stats, **{k: getattr(state, f).table for k, f in TABLE_KEYS.items()}}
        loss, sim, _, _ = _forward_loss(model, cfg, weights, batch, generator, train=True,
                                        emb_overrides=(emb_n, emb_c), mesh=loss_mesh, sharded_ce=sharded_ce)
        *g_dense, g_n, g_c = torch.autograd.grad(loss, [*dense.values(), emb_n, emb_c])
        g_dense = dict(zip(dense, g_dense))
        scale = 1.0
        if sync is not None:
            g_dense, scale = sync(g_dense), sync.scale
        elif mesh is not None:
            g_dense = sync_grads(g_dense, mesh)
        with span("train.sparse_update"):
            tx.update(state.dense_params, g_dense, state.opt_state)
            rows_n, rows_c = rows_n.reshape(-1), rows_c.reshape(-1)
            if scale != 1.0:
                # the cotangents carry the dense gradients' objective scale
                # (reference compressed_grads.py:665-670)
                g_n, g_c = g_n * scale, g_c * scale
            g_n, g_c = g_n.reshape(-1, emb_dim).float(), g_c.reshape(-1, emb_dim).float()
            if not defer_table_updates:
                lr_t = emb_schedule(state.step)
                for st, rows, g in ((state.notice_table, rows_n, g_n), (state.company_table, rows_c, g_c)):
                    if sharded:
                        rows, g = gather_occurrences(mesh, rows, g)
                    update_shard(st, rows, g, mesh, lr=lr_t, eps=eps, dedup=dedup)
        state.step += 1
        metrics = {"loss": loss.detach()}
        if with_metrics and sim is not None:
            metrics.update(in_batch_metrics(sim.detach()))
        if sync is not None:
            metrics = sync.pmean_(metrics, state.batch_stats)
        if defer_table_updates:
            metrics.update(rows_n=rows_n, g_n=g_n, rows_c=rows_c, g_c=g_c)
        return state, metrics

    return step


def make_scanned_sparse_steps(model: TwoTowerModel, cfg, tx: Optimizer, total_steps: int, n_inner: int, *,
                              mesh=None, store_gather=None):
    """``steps(state, pair_idx_stack [n_inner, B, 2], notice_store,
    company_store) -> (state, metrics stacked [n_inner])``: n_inner sparse
    steps per call (the reference's ``lax.scan``, a Python loop here)."""
    return scanned_fn(make_sparse_train_step(model, cfg, tx, total_steps, mesh=mesh, store_gather=store_gather),
                      n_inner)


def make_sampled_sparse_steps(
    model: TwoTowerModel, cfg, tx: Optimizer, total_steps: int, n_inner: int, batch_size: int, *,
    mesh=None, store_gather=None,
):
    """``steps(state, sample_seed, pairs_dev [P, 2], notice_store,
    company_store)``: n_inner sparse steps per call, each on a batch drawn
    on the device from a generator seeded from (sample_seed, global step),
    as train_step.make_sampled_train_steps draws (on a mesh every rank
    draws the global batch and keeps its block). For one table update per
    window use :func:`make_sampled_deferred_sparse_steps`."""
    inner = make_sparse_train_step(model, cfg, tx, total_steps, mesh=mesh, store_gather=store_gather)
    return sampled_scan_fn(inner, n_inner, batch_size, mesh)


def make_deferred_sparse_steps(model: TwoTowerModel, cfg, tx: Optimizer, total_steps: int, n_inner: int):
    """n_inner steps per call with ONE batched table update per window:
    ``steps(state, pair_idx_stack [n_inner, B, 2], notice_store,
    company_store)``.

    Steps inside the window read the window-start tables (dense params
    still update every step) and stash their compact rows and cotangents; at
    the window's end each side applies one
    :func:`sparse_rowwise_adagrad_update` over all n_inner * B * K
    occurrences, at the learning rate of the window's last step. Embeddings
    are up to n_inner steps stale within a window, the asynchronous-embedding
    trade; n_inner = 1 is the per-step path."""
    return deferred_sparse_steps_fn(model, cfg, tx, total_steps, n_inner=n_inner)


def deferred_sparse_steps_fn(
    model: TwoTowerModel,
    cfg,
    tx: Optimizer,
    total_steps: int,
    *,
    n_inner: int | None = None,
    sampled: tuple[int, int] | None = None,
    mesh=None,
    store_gather=None,
):
    """The deferred window (see :func:`make_deferred_sparse_steps`).
    Host-fed, ``n_inner`` steps over a pair-index stack; with ``sampled=
    (n_inner, batch_size)`` the window draws its batches on the device, as
    :func:`make_sampled_sparse_steps` does, and the call becomes
    ``steps(state, sample_seed, pairs_dev, notice_store, company_store)``.
    On a mesh the window's occurrences are gathered once, at its end."""
    if (n_inner is None) == (sampled is None):
        raise ValueError("deferred_sparse_steps_fn takes n_inner (host-fed) or sampled=(n_inner, batch_size)")
    inner = make_sparse_train_step(model, cfg, tx, total_steps, defer_table_updates=True, mesh=mesh,
                                   store_gather=store_gather)
    emb_lr = cfg.optimizer.embedding_learning_rate or cfg.optimizer.learning_rate
    emb_schedule = warmup_constant_schedule(emb_lr, total_steps, cfg.optimizer.warmup_ratio)
    eps = cfg.optimizer.adagrad_eps
    dedup = cfg.optimizer.sparse_duplicate_handling == "exact"
    window = sampled_scan_fn(inner, *sampled, mesh) if sampled is not None else scanned_fn(inner, n_inner)

    def steps(state: SparseTrainState, *args):
        """One batched rowwise-Adagrad update per side over the window's
        stacked occurrences."""
        state, metrics = window(state, *args)
        rows_n, g_n, rows_c, g_c = (metrics.pop(k) for k in _DEFERRED_KEYS)
        lr_t = emb_schedule(state.step - 1)
        for st, rows, g in ((state.notice_table, rows_n, g_n), (state.company_table, rows_c, g_c)):
            if _on_mesh(mesh):
                rows, g = gather_occurrences(mesh, rows, g)
            update_shard(st, rows.reshape(-1), g.reshape(-1, g.shape[-1]), mesh, lr=lr_t, eps=eps, dedup=dedup)
        return state, metrics

    return steps


def make_sampled_deferred_sparse_steps(
    model: TwoTowerModel, cfg, tx: Optimizer, total_steps: int, n_inner: int, batch_size: int
):
    """Deferred-window sparse training with on-device batch sampling: one
    seed per window and one batched table update per window. Call:
    ``steps(state, sample_seed, pairs_dev [P, 2], notice_store,
    company_store)``."""
    return deferred_sparse_steps_fn(model, cfg, tx, total_steps, sampled=(n_inner, batch_size))
