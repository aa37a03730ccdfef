"""Compressed dense-gradient all-reduce with error feedback (port of
``jodalrob_twotower_tpu/parallel/compressed_grads.py``).

Data-parallel training across hosts syncs the dense gradients over the
link between them every step, and where that link is slow the bytes on the
wire are the cost. Each rank quantizes its gradients and keeps an
error-feedback residual: what the quantizer dropped this step is added to
the next step's gradient, so the long-run update stays unbiased (paper
anchor in PAPERS.md: arxiv 2407.04272).

Wire formats (``method``), as the reference defines them:

* "none": the f32 sum (the control); the residual is 0.
* "bf16": the gradient cast to bf16 and summed; the residual is what the
  cast dropped. The sum itself rounds in bf16.
* "int16": int8 quanta on a scale shared by every rank (the max over the
  ranks of each leaf's absmax, / 127), summed exactly, times the scale. The
  reference sums the quanta as int16, exact up to 256 ranks (256 x 127 <
  32767). Neither collective backend sums int16 here: gloo refuses it,
  an int8 all-reduce wraps, and NCCL has no 16-bit integer type. So each
  rank all-gathers every rank's int8 quanta and sums them in int32: the
  same exact total, bit for bit, at one byte an element from each peer.

The collectives are flattened as ``mesh.sync_grads`` flattens the mesh's
sum: one MAX all-reduce of the vector of per-leaf absmax values, one
collective of the concatenated quanta (or of the f32 or bf16 values). The
scales stay per leaf, so the values are the reference's per-leaf ``pmax``
and ``psum``.

The steps. The reference's compressed step is an explicit ``shard_map``; in
the port each rank already runs its own code, so a compressed step is the
port's indexed step (``train/train_step.py``, ``train/sparse_tables.py``)
with the mesh's gradient sum replaced by :class:`CompressedSync`:

* every rank trains its block of the global batch as a batch of its own
  (the per-rank towers of ``models.build_model``): BatchNorm takes the
  rank's statistics, and the running statistics are averaged over the
  ranks after each step; dropout draws the rank's own masks;
* ``MeshConfig.compressed_negatives`` "local": the loss is the rank's
  [B/n, B/n] bidirectional CE (one device's loss at B/n, the fused kernels
  on the card) and the summed gradient is scaled by 1/n; "global": the
  mesh's CE (``ops/fused_logits.sharded_fused_ce``, which in the port
  already is the reference's manual per-shard form), whose backward leaves
  each rank its partial gradient, scale 1;
* the optimizer then steps on identical gradients on every rank, so the
  replicated states stay bit-equal;
* the residual is f32, the params' shape (tables included), per rank, and
  is not checkpointed: a resume restarts it at zero.

Sparse tables (:func:`make_dp_compressed_sparse_train`) keep the mesh's
exact row exchange for the lookup and the touched-rows update, and compress
the dense tower gradients only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from jodalrob_twotower_torch.ops.fused_logits import make_sharded_fused_ce
from jodalrob_twotower_torch.parallel.mesh import DATA_AXIS, put_replicated, shard_batch
from jodalrob_twotower_torch.parallel.sharded_sparse import sharded_sparse_state
from jodalrob_twotower_torch.parallel.sharded_train import put_idx_fn, replicated_state
from jodalrob_twotower_torch.train.sparse_tables import make_sparse_train_step
from jodalrob_twotower_torch.train.train_step import (
    _train_on_batch,
    make_indexed_train_step,
    sampled_scan_fn,
    scanned_fn,
)

_METHODS = ("none", "int16", "bf16")
_INT8_MAX = 127
_MAX_INT16_RANKS = 256  # n x 127 <= 32767: the reference's int16 sum cannot wrap


def resolve_compressed_loss(cfg, mesh):
    """(sharded_ce | None, grad_scale | None) for a compressed step, by
    ``MeshConfig.compressed_negatives``:

    * "local": (None, None), the rank's own CE, its summed gradient scaled
      by 1/n (the caller's mesh size) to a mean of the ranks' means;
    * "global": the mesh's CE over the global batch, whose backward leaves
      each rank its partial gradient: the sum is the whole gradient, scale 1.
    """
    if cfg.mesh.compressed_negatives != "global":
        return None, None
    if cfg.loss.loss_type != "cross_entropy":
        raise ValueError(
            "compressed_negatives='global' keeps the global in-batch-"
            "negatives CE under compression; it has no meaning for "
            f"loss_type={cfg.loss.loss_type!r} — use 'local'"
        )
    return (
        make_sharded_fused_ce(
            mesh,
            temperature=cfg.loss.temperature,
            label_smoothing=cfg.loss.label_smoothing,
            # tower outputs are L2-normalized (models/tower.py): |logits| <=
            # 1/temperature for the lean kernel
            max_abs_logit=1.0 / cfg.loss.temperature,
        ),
        1.0,
    )


def _check_method(method: str, n_shards: int) -> None:
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got {method!r}")
    if method == "int16" and n_shards > _MAX_INT16_RANKS:
        # the int16 sum's exactness precondition: n x 127 <= 32767
        raise ValueError(
            f"method='int16' is exact only up to 256 workers (int16 sum of "
            f"int8 quanta); the {DATA_AXIS!r} axis has {n_shards} — use 'bf16'"
        )


def compressed_psum_tree(grads: dict[str, torch.Tensor], err_tree: dict[str, torch.Tensor], mesh,
                         method: str = "int16", *, buffers: list | None = None):
    """(synced, new_err): every leaf of ``grads`` plus this rank's residual
    ``err_tree`` summed over the ranks in the wire format ``method`` (module
    docstring), f32, and the new residual of each leaf. ``buffers``, where
    given, receives (collective, bytes of this rank's input buffer) of each
    collective the sum made."""
    if method not in _METHODS:
        raise ValueError(f"method must be one of {_METHODS}, got {method!r}")
    names = list(grads)
    g_ef = [(grads[k] + err_tree[k]).float() for k in names]
    sizes = [g.numel() for g in g_ef]
    flat = torch.cat([g.reshape(-1) for g in g_ef])
    sent = []
    if method == "none":
        total, residual = mesh.all_reduce_(flat.clone()), torch.zeros_like(flat)
        sent.append(("all_reduce", flat.numel() * 4))
    elif method == "bf16":
        wire = flat.to(torch.bfloat16)
        residual = flat - wire.float()
        sent.append(("all_reduce", wire.numel() * 2))
        total = mesh.all_reduce_(wire).float()
    else:
        # one shared grid per leaf: every rank quantizes on the max over the
        # ranks of the leaf's absmax, so the exact sum of the quanta times the
        # scale is the sum of the dequantized values
        absmax = torch.stack([g.abs().max() for g in g_ef])
        sent.append(("all_reduce", absmax.numel() * 4))
        scale = mesh.all_reduce_(absmax, "max").clamp_min(1e-30) / float(_INT8_MAX)
        scale = torch.repeat_interleave(scale, torch.tensor(sizes, device=scale.device), output_size=flat.numel())
        q = torch.clamp(torch.round(flat / scale), -_INT8_MAX, _INT8_MAX).to(torch.int8)
        sent.append(("all_gather", q.numel()))
        every = mesh.all_gather_rows(q).view(mesh.size, -1)
        total = every.to(torch.int32).sum(0).float() * scale
        # one rounding of the exact g_ef - q * scale, as the reference's XLA
        # fuses it into a multiply-add: q * scale is exact in f64 and lies
        # within half a quantum of g_ef, so the f64 difference is exact too
        residual = (flat.double() - q.double() * scale.double()).float()
    if buffers is not None:
        buffers[:] = sent
    shapes = [grads[k].shape for k in names]
    synced = {k: t.view(s) for k, t, s in zip(names, torch.split(total, sizes), shapes)}
    new_err = {k: t.view(s) for k, t, s in zip(names, torch.split(residual, sizes), shapes)}
    return synced, new_err


def compressed_psum_leaf(g: torch.Tensor, err: torch.Tensor, mesh, method: str = "int16"):
    """(synced sum f32, new residual) of one gradient leaf (the tree form
    with one leaf)."""
    synced, new_err = compressed_psum_tree({"g": g}, {"g": err}, mesh, method)
    return synced["g"], new_err["g"]


def ring_wire_bytes(buffers: list, n: int) -> int:
    """Bytes one rank sends for ``buffers`` ((collective, input bytes) as
    :func:`compressed_psum_tree` records them) under ring schedules: an
    all-reduce of b bytes sends 2 (n - 1) / n b, an all-gather of b bytes
    from each rank (n - 1) b."""
    per = {"all_reduce": lambda b: 2 * (n - 1) * b / n, "all_gather": lambda b: (n - 1) * b}
    return int(sum(per[c](b) for c, b in buffers))


class CompressedSync:
    """What a compressed step runs in place of the mesh's gradient sum: the
    rank's gradients plus its residual ``err`` through
    :func:`compressed_psum_tree`, times ``scale`` (1/n for local negatives,
    1 for global); ``sharded_ce`` is the step's loss where the negatives are
    global (None: the rank's own loss). ``buffers`` holds the last sum's
    collectives and their input bytes."""

    def __init__(self, cfg, mesh, method: str) -> None:
        _check_method(method, mesh.shape[DATA_AXIS])
        self.mesh = mesh
        self.method = method
        self.sharded_ce, scale = resolve_compressed_loss(cfg, mesh)
        self.scale = 1.0 / mesh.size if scale is None else scale
        self.err: dict[str, torch.Tensor] | None = None
        self.buffers: list = []

    def __call__(self, grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        synced, self.err = compressed_psum_tree(grads, self.err, self.mesh, self.method, buffers=self.buffers)
        return {k: g * self.scale for k, g in synced.items()}

    def pmean_(self, metrics: dict[str, torch.Tensor], batch_stats: dict[str, torch.Tensor]) -> dict:
        """``metrics`` averaged over the ranks (returned) and ``batch_stats``
        averaged in place, in one all-reduce (the reference's ``pmean`` of
        the loss, the in-batch metrics and the running statistics)."""
        keys, stats = list(metrics), list(batch_stats.values())
        flat = torch.cat([torch.stack([metrics[k].float().reshape(()) for k in keys]),
                          *(s.reshape(-1).float() for s in stats)])
        flat = self.mesh.all_reduce_(flat) / self.mesh.size
        start = len(keys)
        for s in stats:
            s.copy_(flat[start : start + s.numel()].view(s.shape))
            start += s.numel()
        return dict(zip(keys, flat[: len(keys)].unbind()))


def _threaded(sync: CompressedSync, fn: Callable) -> Callable:
    """``fn(state, *args) -> (state, metrics)`` as ``call(state, err, *args)
    -> (state, err, metrics)``, the residual threaded through each call."""

    def call(state, err, *args):
        sync.err = err
        state, metrics = fn(state, *args)
        return state, sync.err, metrics

    return call


def _check_setup(model, mesh, batch_size: int) -> None:
    n = mesh.shape[DATA_AXIS]
    if batch_size % max(n, 1):
        raise ValueError(f"the {DATA_AXIS!r} axis ({n}) must divide batch_size {batch_size}")
    if any(getattr(m, "mesh", None) is not None for m in (model.notice_tower, model.company_tower)):
        raise ValueError(
            "the compressed steps train each rank's block as a batch of its own: build the model with "
            "models.build_model under grad_compression, or without the mesh (its towers take the global "
            "batch's BatchNorm statistics and dropout masks)"
        )


def _zeros_like(tree: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: torch.zeros_like(v, dtype=torch.float32) for k, v in tree.items()}


def make_dp_compressed_train_step(model, cfg, tx, mesh, batch_size: int, total_steps: int, *,
                                  method: str = "int16"):
    """Data-parallel train step with the compressed gradient sync. Returns
    (state, err_state, step, put_batch): ``step(state, err_state, batch)
    -> (state, err_state, metrics)`` on the rank's block of a global
    PairBatch, which ``put_batch`` cuts and places. The state holds
    ``model``'s current weights, rank 0's on every rank; ``err_state`` is
    this rank's residual, zeros of the params' shapes in f32."""
    sync = CompressedSync(cfg, mesh, method)
    _check_setup(model, mesh, batch_size)
    state, _ = replicated_state(model, cfg, mesh, total_steps)

    def step(state, batch):
        return _train_on_batch(model, cfg, tx, state, batch, False, sharded_ce=sync.sharded_ce, sync=sync)

    return state, _zeros_like(state.params), _threaded(sync, step), lambda batch: shard_batch(batch, mesh)


@dataclasses.dataclass
class CompressedDPTrain:
    """Everything the Trainer needs to drive compressed training over
    device-resident stores (``MeshConfig.grad_compression``).

    ``scan_steps(state, err, idx_stack [n, b, 2], n_store, c_store)`` ->
    (state, err, {"loss": [n]}); ``single_step(state, err, idx [b, 2],
    n_store, c_store)`` -> (state, err, metrics, the in-batch ones the
    ranks' average where the loss is materialized); ``make_sampled(k)`` ->
    ``steps(state, err, sample_seed, pairs_dev, n_store, c_store)``, k
    steps drawn on the device per call. ``idx`` blocks are the rank's, cut
    by ``put_idx`` from global batches; ``put_store`` places a store on
    every rank. ``err_state`` is this rank's residual; ``sync`` records the
    last sum's collectives."""

    state: object
    err_state: object
    tx: object
    scan_steps: Callable
    single_step: Callable
    put_idx: Callable
    put_store: Callable
    make_sampled: Callable
    sync: CompressedSync


def _put_store_fn(mesh):
    def put_store(store):
        return tuple(put_replicated(x, mesh) for x in store)

    return put_store


def _scan(inner: Callable) -> Callable:
    """One inner step per leading row of an index stack, any length."""

    def steps(state, idx_stack, n_store, c_store):
        return scanned_fn(inner, idx_stack.shape[0])(state, idx_stack, n_store, c_store)

    return steps


def make_dp_compressed_indexed_train(model, cfg, mesh, batch_size: int, total_steps: int, *,
                                     method: str = "int16") -> CompressedDPTrain:
    """Compressed training over device-resident stores, the Trainer's path
    for ``MeshConfig.grad_compression`` with dense tables: ``model``'s
    current weights replicated, the stores replicated, each rank training
    its block of every global batch (module docstring). The sampled form
    draws each rank's own b = B/n rows from (sample seed, global step,
    rank) (reference :466-472)."""
    sync = CompressedSync(cfg, mesh, method)
    _check_setup(model, mesh, batch_size)
    state, tx = replicated_state(model, cfg, mesh, total_steps)
    inner = make_indexed_train_step(model, cfg, tx, with_metrics=False, sync=sync)
    single = make_indexed_train_step(model, cfg, tx, with_metrics=True, sync=sync)

    def make_sampled(k: int) -> Callable:
        return _threaded(sync, sampled_scan_fn(inner, k, batch_size, mesh, per_rank=True))

    return CompressedDPTrain(state=state, err_state=_zeros_like(state.params), tx=tx,
                             scan_steps=_threaded(sync, _scan(inner)), single_step=_threaded(sync, single),
                             put_idx=put_idx_fn(mesh), put_store=_put_store_fn(mesh), make_sampled=make_sampled,
                             sync=sync)


def make_dp_compressed_sparse_train(model, cfg, mesh, batch_size: int, total_steps: int, *,
                                    method: str = "int16") -> CompressedDPTrain:
    """The compressed sync composed with sparse tables: the dense tower
    gradients compressed as above; the lookup and the touched-rows rowwise
    Adagrad through the mesh's exact row exchange on row-sharded tables
    (``parallel/sharded_sparse.py``), the cotangents scaled alike. The
    state is a row-sharded ``SparseTrainState`` and ``err_state`` covers
    ``dense_params`` only. The sampled form draws the global batch keyed on
    the step and keeps the rank's block (reference :767-772)."""
    sync = CompressedSync(cfg, mesh, method)
    _check_setup(model, mesh, batch_size)
    state, tx = sharded_sparse_state(model, cfg, mesh, total_steps)
    kw = dict(mesh=mesh, sync=sync)
    inner = make_sparse_train_step(model, cfg, tx, total_steps, **kw)
    single = make_sparse_train_step(model, cfg, tx, total_steps, with_metrics=True, **kw)

    def make_sampled(k: int) -> Callable:
        return _threaded(sync, sampled_scan_fn(inner, k, batch_size, mesh))

    return CompressedDPTrain(state=state, err_state=_zeros_like(state.dense_params), tx=tx,
                             scan_steps=_threaded(sync, _scan(inner)), single_step=_threaded(sync, single),
                             put_idx=put_idx_fn(mesh), put_store=_put_store_fn(mesh), make_sampled=make_sampled,
                             sync=sync)

