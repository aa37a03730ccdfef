"""Train and eval steps, the train state and the encoders (port of
``jodalrob_twotower_tpu/train/train_step.py``).

A step gathers its batch, runs both towers in training form, the loss, the
backward pass and the optimizer update. The reference compiles that into one
XLA program; here it runs eagerly, with the hand-written kernels on the card
(the one-hot lookup and the table gradient for the embeddings, the fused CE
forward and backward for the loss). ``n_inner`` steps per call are a Python
loop whose losses stay on the device until the call returns. An eval step
runs the towers in inference form, the loss and the in-batch metrics (on
the card from the statistics kernels, without the [B, B] matrix).

Randomness is a pure function of (seed, step): each step's dropout masks and
each sampled batch come from a ``torch.Generator`` seeded from the state's
base seed (or the call's sample seed) and the global step counter, so
``n_inner`` steps in one call equal ``n_inner`` separate calls, as
``lax.scan`` over a folded-in key guarantees in the reference. torch's
generators do not give JAX's bits: parity with the reference runs with
dropout 0 and fixed pair indices.

The state is updated in place: parameters and optimizer moments by the
optimizer, BatchNorm running statistics by the towers. A step returns the
same state object.

On a mesh (``parallel/mesh.py``, the steps' ``mesh`` argument) each rank
holds a copy of the state on its device and steps on its block of every
global batch; the loss is the global batch's, the gradients of the
replicated leaves are summed over the ranks before the update, and every
rank applies the same update, so the copies stay equal. A row-sharded
table (``model.row_sharded_keys``) and its optimizer leaves are the rank's
block of rows: the row exchange's backward gives each rank its block's
whole gradient, which no sum touches. A row-sharded store enters through
``store_gather`` (``parallel/sharded_store.make_tower_batch_gather``).

Under the compressed gradient sync (the steps' ``sync`` argument,
``parallel/compressed_grads.CompressedSync``) each rank instead trains on its
block as a batch of its own: its own loss ("local" negatives) or the mesh's
CE ("global"), its own dropout stream, and the compressed sum with error
feedback in place of the mesh's sum.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import numpy as np
import torch
from torch.func import functional_call

from jodalrob_twotower_torch.data.types import PairBatch, TowerBatch, default_tower_gather
from jodalrob_twotower_torch.device import resolve_device
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel
from jodalrob_twotower_torch.ops.fused_logits import (
    fused_in_batch_metrics,
    make_sharded_fused_ce,
    sharded_ce_loss,
    sharded_in_batch_metrics,
)
from jodalrob_twotower_torch.parallel.mesh import gather_replicated, sync_grads
from jodalrob_twotower_torch.train.loss import compute_loss, resolve_use_fused
from jodalrob_twotower_torch.train.metrics import in_batch_metrics
from jodalrob_twotower_torch.train.optimizer import Optimizer, build_optimizer
from jodalrob_twotower_torch.utils.profiling import span

DROPOUT_STREAM = 0
SAMPLE_STREAM = 1
RANK_DROPOUT_STREAM = 2  # a compressed step's per-rank dropout masks
RANK_SAMPLE_STREAM = 3  # a compressed step's per-rank batch draws


@dataclasses.dataclass
class TrainState:
    """What training carries from step to step, all on one device.

    ``params`` and ``batch_stats`` are keyed as the model's ``state_dict``
    (parameters; BatchNorm running statistics); ``seed`` is the base of
    every step's dropout generator."""

    step: int
    params: dict[str, torch.Tensor]
    batch_stats: dict[str, torch.Tensor]
    opt_state: dict
    seed: int

    @property
    def state_dict(self) -> dict[str, torch.Tensor]:
        return {**self.params, **self.batch_stats}

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device


def create_train_state(
    model: TwoTowerModel,
    cfg,
    seed: int,
    total_steps: int,
    *,
    device=None,
) -> tuple[TrainState, Optimizer]:
    """A state holding copies of ``model``'s current weights on ``device``
    (None means the card) and a fresh optimizer state; returns it with the
    optimizer."""
    dev = resolve_device(device)
    buffers = {k for k, _ in model.named_buffers()}
    sd = model.state_dict()
    params = {k: v.detach().to(dev, torch.float32).clone() for k, v in sd.items() if k not in buffers}
    batch_stats = {k: v.detach().to(dev, torch.float32).clone() for k, v in sd.items() if k in buffers}
    tx = build_optimizer(cfg.optimizer, total_steps)
    return TrainState(0, params, batch_stats, tx.init(params), int(seed)), tx


def resolve_dropout_rng_impl(model_cfg) -> str:
    """``ModelConfig.dropout_rng_impl`` with "auto" resolved: "threefry",
    never "rbg" (the TPU's hardware generator). The port draws its masks from
    a ``torch.Generator`` seeded per step whichever name is set; the name
    stays the reference's, so a config file means the same in both."""
    v = model_cfg.dropout_rng_impl
    return "threefry" if v == "auto" else v


def step_generator(device: torch.device, seed: int, step: int, stream: int, rank: int | None = None) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, stream, step) alone, and
    ``rank`` where a stream draws apart on every rank (the reference folds
    the axis index into the step's key)."""
    entropy = [int(seed) & 0xFFFFFFFF, stream, int(step)] + ([int(rank)] if rank is not None else [])
    words = np.random.SeedSequence(entropy).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(words[0]) << 31) ^ int(words[1]))
    return gen


def resolve_store_dtype(cfg):
    """dtype of the device-resident dense blocks (``DataConfig.device_store_dtype``;
    None keeps float32). "auto" stores at the compute dtype: bf16 halves the
    store and changes nothing, since the towers cast the dense block to the
    compute dtype first."""
    mode = cfg.data.device_store_dtype
    if mode == "bfloat16" or (mode == "auto" and cfg.model.compute_dtype == "bfloat16"):
        return torch.bfloat16
    return None


def device_store(feature_store, *, dtype=None, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """A host FeatureStore's (dense, cat_ids) as tensors on ``device`` (None
    means the card), once, for indexed steps. The dense block is cast to
    ``dtype`` on the host, so only the smaller copy crosses to the card."""
    dev = resolve_device(device)
    dense = torch.from_numpy(np.ascontiguousarray(feature_store.dense))
    if dtype is not None:
        dense = dense.to(dtype)
    return dense.to(dev), torch.from_numpy(np.ascontiguousarray(feature_store.cat_ids)).to(dev)


def make_sharded_ce(cfg, mesh):
    """The mesh's fused CE (``ops/fused_logits.make_sharded_fused_ce``) for a
    train step, or None where the config or mesh does not call for it: no
    mesh or a mesh of one rank, the fused loss off, or another loss
    (reference ``make_sharded_ce``, train_step.py:107-131). A one-rank mesh
    thus runs the single-device CE."""
    if mesh is None or mesh.size <= 1 or cfg.loss.loss_type != "cross_entropy":
        return None
    if not resolve_use_fused(cfg.loss, mesh.device):
        return None
    return make_sharded_fused_ce(
        mesh, temperature=cfg.loss.temperature, label_smoothing=cfg.loss.label_smoothing,
        # tower outputs are L2-normalized (models/tower.py), proving the
        # bound |logits| <= 1/temperature for the lean kernel
        max_abs_logit=1.0 / cfg.loss.temperature,
    )


def _forward_loss(model, cfg, weights: Mapping[str, torch.Tensor], batch: PairBatch, generator, *, train: bool,
                  emb_overrides=None, mesh=None, sharded_ce=None):
    """(loss, similarity or None, notice embeddings, company embeddings) of
    one batch; the towers run on ``weights`` (the model's state_dict keys)
    through ``functional_call``, with the categorical activations
    ``emb_overrides`` in place of the tables' where given. On a mesh of more
    than one rank ``batch`` is the rank's block and the loss the global
    batch's: ``sharded_ce``'s, or the loss of the embeddings gathered from
    every rank (the similarity then the global [B, B] one)."""
    kwargs = {"train": train, "generator": generator}
    if emb_overrides is not None:
        kwargs["emb_overrides"] = emb_overrides
    n_emb, c_emb = functional_call(model, dict(weights), (batch,), kwargs, strict=True)
    if sharded_ce is not None:
        return sharded_ce(n_emb, c_emb), None, n_emb, c_emb
    if mesh is not None and mesh.size > 1:
        n_emb, c_emb = gather_replicated(n_emb, mesh), gather_replicated(c_emb, mesh)
    loss, sim = compute_loss(
        cfg.loss.loss_type,
        n_emb,
        c_emb,
        temperature=cfg.loss.temperature,
        label_smoothing=cfg.loss.label_smoothing,
        margin=cfg.loss.cosine_margin,
        use_fused=resolve_use_fused(cfg.loss, n_emb.device),
        # tower outputs are L2-normalized (models/tower.py), which proves
        # |logits| <= 1/temperature for the fused forward
        normalized_inputs=True,
    )
    return loss, sim, n_emb, c_emb


def dropout_generator(cfg, state, sync=None) -> torch.Generator | None:
    """The step's dropout generator, None without dropout: seeded from the
    state's (seed, step), and under the compressed sync ``sync`` from the
    rank's own stream, so that the ranks' blocks draw apart (reference
    compressed_grads.py:213-220)."""
    if cfg.model.dropout_rate <= 0:
        return None
    if sync is None:
        return step_generator(state.device, state.seed, state.step, DROPOUT_STREAM)
    return step_generator(state.device, state.seed, state.step, RANK_DROPOUT_STREAM, sync.mesh.rank)


def loss_and_grads(model, cfg, state: TrainState, batch: PairBatch, *, mesh=None, sharded_ce=None, sync=None):
    """(loss, similarity or None, grads keyed as ``state.params``) of one
    training-form step on ``batch``, without the update. BatchNorm running
    statistics in ``state`` advance as in a step. On a mesh ``batch`` is the
    rank's block, the loss the global batch's and the gradients summed over
    the ranks (``parallel/mesh.sync_grads``): every rank holds the gradient
    of one device's step on the whole batch. ``sync`` (the compressed sync,
    with ``mesh`` None) takes the sum's place: the rank's own gradients go
    through it, and the loss stays the rank's."""
    generator = dropout_generator(cfg, state, sync)
    params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
    with span("train.forward"):
        loss, sim, _, _ = _forward_loss(model, cfg, {**params, **state.batch_stats}, batch, generator, train=True,
                                        mesh=mesh, sharded_ce=sharded_ce)
    with span("train.backward"):
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        if sync is not None:
            grads = sync(grads)
        elif mesh is not None:
            grads = sync_grads(grads, mesh, sharded=model.row_sharded_keys)
    return loss.detach(), sim, grads


def _train_on_batch(model, cfg, tx: Optimizer, state: TrainState, batch, with_metrics: bool,
                    mesh=None, sharded_ce=None, sync=None):
    """One step under its root span ``train.step``: ``batch`` is a
    PairBatch, or a function that draws and gathers one (an indexed step's),
    which then runs inside the step's span as ``train.batch``."""
    with span("train.step", root=state.step):
        if callable(batch):
            with span("train.batch"):
                batch = batch()
        loss, sim, grads = loss_and_grads(model, cfg, state, batch, mesh=mesh, sharded_ce=sharded_ce, sync=sync)
        with span("train.update"):
            tx.update(state.params, grads, state.opt_state, mesh=mesh, sharded=model.row_sharded_keys)
        state.step += 1
        metrics = {"loss": loss}
        if with_metrics and sim is not None:
            metrics.update(in_batch_metrics(sim.detach()))
        if sync is not None:
            metrics = sync.pmean_(metrics, state.batch_stats)
    return state, metrics


def make_train_step(model: TwoTowerModel, cfg, tx: Optimizer, *, with_metrics: bool = True, mesh=None):
    """``step(state, batch: PairBatch) -> (state, metrics)``: grads, update
    and, on the materialized loss path, the in-batch metrics. With ``mesh``
    (``parallel/mesh.py``) ``batch`` is the rank's block of the global batch
    and the loss, metrics and update are the global batch's, the same on
    every rank; with the fused loss the CE is the mesh's
    (:func:`make_sharded_ce`)."""
    sharded_ce = make_sharded_ce(cfg, mesh)

    def step(state: TrainState, batch: PairBatch):
        return _train_on_batch(model, cfg, tx, state, batch, with_metrics, mesh, sharded_ce)

    return step


def make_indexed_train_step(
    model: TwoTowerModel,
    cfg,
    tx: Optimizer,
    *,
    with_metrics: bool = True,
    store_gather: Callable | None = None,
    mesh=None,
    sync=None,
):
    """Train step over device-resident stores:
    ``step(state, pair_idx [B, 2], notice_store, company_store)``, each
    store a (dense, cat_ids) tuple of tensors on the state's device; the
    batch is gathered on the device. ``store_gather(store, rows) ->
    TowerBatch`` replaces the plain gather. With ``mesh``, ``pair_idx`` is
    the rank's block of the global batch's indices (:func:`make_train_step`).
    With ``sync`` (the compressed sync, no ``mesh``) it is the rank's block
    trained as a batch of its own, its loss ``sync.sharded_ce`` where the
    negatives are global. ``pair_idx`` may also be a function of the state
    that draws the indices (:func:`sampled_scan_fn`'s), so that the draw
    falls inside the step's span."""
    gather = store_gather or default_tower_gather
    sharded_ce = sync.sharded_ce if sync is not None else make_sharded_ce(cfg, mesh)

    def step(state: TrainState, pair_idx, notice_store, company_store):
        def batch() -> PairBatch:
            idx = pair_idx(state) if callable(pair_idx) else pair_idx
            return PairBatch(notice=gather(notice_store, idx[:, 0]), company=gather(company_store, idx[:, 1]))

        return _train_on_batch(model, cfg, tx, state, batch, with_metrics, mesh, sharded_ce, sync)

    return step


def _stack(metrics: list[dict[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def scanned_fn(inner, n_inner: int):
    """The ``n_inner``-step body over host-given batches (the reference's
    ``lax.scan`` over a pair-index stack): ``steps(state, pair_idx_stack
    [n_inner, B, 2], notice_store, company_store) -> (state, metrics
    stacked [n_inner])``."""

    def steps(state, pair_idx_stack: torch.Tensor, notice_store, company_store):
        if pair_idx_stack.shape[0] != n_inner:
            raise ValueError(f"pair_idx_stack must hold {n_inner} steps, got {pair_idx_stack.shape[0]}")
        out = []
        for pair_idx in pair_idx_stack:
            state, m = inner(state, pair_idx, notice_store, company_store)
            out.append(m)
        return state, _stack(out)

    return steps


def make_scanned_train_steps(
    model: TwoTowerModel, cfg, tx: Optimizer, n_inner: int, *, with_metrics: bool = False, mesh=None,
    store_gather: Callable | None = None,
):
    """``steps(state, pair_idx_stack [n_inner, B, 2], notice_store,
    company_store) -> (state, metrics stacked [n_inner])``: n_inner indexed
    steps per call (with ``mesh``, the rank's [n_inner, B/n, 2] blocks)."""
    return scanned_fn(make_indexed_train_step(model, cfg, tx, with_metrics=with_metrics, mesh=mesh,
                                              store_gather=store_gather), n_inner)


def sampled_scan_fn(inner, n_inner: int, batch_size: int, mesh=None, *, per_rank: bool = False):
    """The ``n_inner``-step body with on-device batch sampling: each step
    draws ``batch_size`` pairs IID with replacement from a generator seeded
    from (sample_seed, global step), so draws are replayable and
    resume-exact. On a mesh every rank draws the global batch and keeps its
    block (reference train_step.py:340-352, where GSPMD shards the draw);
    with ``per_rank`` each rank draws only its batch_size / n rows, from
    (sample_seed, global step, rank) (the dense compressed steps, reference
    compressed_grads.py:466-472)."""
    block = mesh.block(batch_size) if mesh is not None and not per_rank else slice(None)
    n_draw = batch_size // mesh.size if per_rank else batch_size

    def steps(state, sample_seed: int, pairs_dev: torch.Tensor, notice_store, company_store):
        n_pairs = pairs_dev.shape[0]

        def draw(state) -> torch.Tensor:
            if per_rank:
                gen = step_generator(pairs_dev.device, sample_seed, state.step, RANK_SAMPLE_STREAM, mesh.rank)
            else:
                gen = step_generator(pairs_dev.device, sample_seed, state.step, SAMPLE_STREAM)
            rows = torch.randint(0, n_pairs, (n_draw,), generator=gen, device=pairs_dev.device)[block]
            return pairs_dev.index_select(0, rows)

        out = []
        for _ in range(n_inner):
            state, m = inner(state, draw, notice_store, company_store)
            out.append(m)
        return state, _stack(out)

    return steps


def make_sampled_train_steps(
    model: TwoTowerModel,
    cfg,
    tx: Optimizer,
    n_inner: int,
    batch_size: int,
    *,
    with_metrics: bool = False,
    mesh=None,
    store_gather: Callable | None = None,
):
    """``steps(state, sample_seed, pairs_dev [P, 2], notice_store,
    company_store) -> (state, metrics stacked [n_inner])``: n_inner train
    steps per call, each on a batch sampled on the device from the resident
    pair set; the host sends one integer seed per call. ``batch_size`` is
    the global batch; with ``mesh`` each rank trains its block of it."""
    inner = make_indexed_train_step(model, cfg, tx, with_metrics=with_metrics, mesh=mesh, store_gather=store_gather)
    return sampled_scan_fn(inner, n_inner, batch_size, mesh)


def make_eval_step(model: TwoTowerModel, cfg, *, mesh=None):
    """``eval_step(state, batch: PairBatch) -> metrics``: the forward in
    inference form (no dropout, running BatchNorm statistics), the loss and
    the in-batch metrics, as 0-dim tensors on the state's device (reference
    ``make_eval_step``, train_step.py:421-469). On the materialized loss path
    the metrics come from the similarity matrix; on the fused path (the
    default on CUDA) from :func:`fused_in_batch_metrics`, which never forms
    it (the statistics kernels).

    With ``mesh`` the batch is sharded, the rank's block of the global
    batch (the reference's ``sharded_batch``), and the metrics are the
    global batch's on every rank: on the fused path the mesh's CE forward
    and the statistics of the rank's rows against the gathered company side
    (K8 and K5 at the rank's row offset, ``sharded_in_batch_metrics``);
    otherwise the single-device step on the gathered embeddings."""
    fused_mesh = (mesh is not None and mesh.size > 1 and cfg.loss.loss_type == "cross_entropy"
                  and resolve_use_fused(cfg.loss, mesh.device))

    def eval_step(state, batch: PairBatch) -> dict[str, torch.Tensor]:
        with torch.inference_mode():
            if fused_mesh:
                n_emb, c_emb = functional_call(model, state.state_dict, (batch,), {"train": False}, strict=True)
                tau = cfg.loss.temperature
                return {"loss": sharded_ce_loss(n_emb, c_emb, mesh, tau, cfg.loss.label_smoothing, 1.0 / tau),
                        **sharded_in_batch_metrics(n_emb, c_emb, mesh, temperature=tau)}
            loss, sim, n_emb, c_emb = _forward_loss(model, cfg, state.state_dict, batch, None, train=False,
                                                    mesh=mesh)
            metrics = {"loss": loss}
            if sim is not None:
                metrics.update(in_batch_metrics(sim))
            elif cfg.loss.loss_type == "cross_entropy":
                metrics.update(fused_in_batch_metrics(n_emb, c_emb, temperature=cfg.loss.temperature))
        return metrics

    return eval_step


def make_indexed_eval_steps(model: TwoTowerModel, cfg, *, mesh=None, store_gather: Callable | None = None):
    """Eval over device-resident stores: ``steps(state, idx_stack [n, B, 2],
    notice_store, company_store)`` gathers each batch on the device and
    returns the per-batch metrics stacked [n] (reference
    ``make_indexed_eval_steps``, train_step.py:472-519; a Python loop where
    the reference scans). Only the indices cross to the device. With
    ``mesh`` the stack is the global batches' (as the reference places it
    replicated) and each rank evaluates its block of every batch, gathered
    by ``store_gather`` over row-sharded stores."""
    eval_core = make_eval_step(model, cfg, mesh=mesh)
    gather = store_gather or default_tower_gather

    def steps(state, idx_stack: torch.Tensor, notice_store, company_store) -> dict[str, torch.Tensor]:
        if mesh is not None:
            idx_stack = idx_stack[:, mesh.block(idx_stack.shape[1])]
        out = []
        for pair_idx in idx_stack:
            batch = PairBatch(
                notice=gather(notice_store, pair_idx[:, 0]),
                company=gather(company_store, pair_idx[:, 1]),
            )
            out.append(eval_core(state, batch))
        return _stack(out)

    return steps


def make_device_encode_fn(model: TwoTowerModel, side: str, chunk: int, *, mesh=None,
                          store_gather: Callable | None = None):
    """Chunked single-side encoder over a device-resident (dense, cat_ids)
    store: ``encode(state, store, start)`` embeds rows [start, start +
    chunk) in inference form (reference ``make_device_encode_fn``,
    train_step.py:522-561). As the reference's dynamic slice does, a start
    past N - chunk is clamped to N - chunk (and one below 0 to 0), so a
    chunk always has ``chunk`` rows of a store that holds as many. With
    ``mesh`` each rank encodes its block of the chunk and every rank gets
    the whole chunk back (an all-gather), so ``chunk`` must divide the
    mesh's data axis, as the reference requires (:542). A row-sharded
    store (``store_gather``, N its padded rows over the ranks) gives each
    rank its block's rows through the exchange."""
    encode = make_encode_fn(model, side)
    block = mesh.block(chunk) if mesh is not None else slice(None)  # raises unless chunk divides

    def encode_chunk(state, store, start: int) -> torch.Tensor:
        dense, cat = store
        n_rows = dense.shape[0] * (mesh.size if store_gather is not None else 1)
        start = max(0, min(int(start), n_rows - chunk))
        rows = slice(start + (block.start or 0), start + (block.stop or chunk))
        if store_gather is not None:
            tb = store_gather(store, torch.arange(rows.start, rows.stop, device=dense.device))
        else:
            tb = TowerBatch(dense[rows], cat[rows])
        out = encode(state, tb)
        return mesh.all_gather_rows(out) if mesh is not None else out

    return encode_chunk


def make_encode_fn(model: TwoTowerModel, side: str):
    """Single-side encoder for index building / serving:
    ``encode(state, batch) -> [B, final_dim]`` float32, in inference form.

    As in the reference, the model is the structure and ``state`` holds the
    weights (``state.state_dict``, the model's keys: a FrozenState or a
    TrainState): the tower runs through ``torch.func.functional_call`` on
    them, so one model serves any state on any device. ``batch`` is a
    :class:`TowerBatch` of tensors on that device."""
    tower = {"notice": model.notice_tower, "company": model.company_tower}[side]
    prefix = f"{side}_tower."

    def encode(state, batch: TowerBatch) -> torch.Tensor:
        weights = {k[len(prefix):]: v for k, v in state.state_dict.items() if k.startswith(prefix)}
        with torch.inference_mode():
            return functional_call(tower, weights, (batch,), {"train": False}, strict=True)

    return encode
