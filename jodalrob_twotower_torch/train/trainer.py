"""The trainer (port of ``jodalrob_twotower_tpu/train/trainer.py``).

Orchestrates: stores on the device -> train steps -> per-epoch validation
(and optionally the corpus eval) -> epoch, best and mid-epoch checkpoints ->
the final corpus-level retrieval eval -> the results CSV. The state starts
from ``TwoTowerModel.init_flax`` (the reference's ``model.init``
distributions) seeded with ``cfg.seed``.

Four step forms, each a call of ``n_inner`` steps with single steps for an
epoch's remainder, as in the reference:

* dense, host-fed: shuffled index batches (``epoch_batches``) stacked
  ``n_inner`` at a time (``make_scanned_train_steps``);
* dense, sampled on the device (``DataConfig.sample_on_device``): each step
  draws its batch from the resident pair set with a generator keyed by the
  global step (``make_sampled_train_steps``), so a resumed run draws the
  batches the interrupted one would have;
* sparse tables (``TrainConfig.sparse_tables``), host-fed or sampled, with
  one table update per step or per window (``sparse_defer_updates``).

A host-fed run may take its index batches from a ``batch_source(epoch)``
instead of the in-memory pairs: ``train_streaming`` streams them from
parquet pair files too large for host memory (``data/parquet_stream.py``).

Mid-epoch resume is exact: the epoch iterator is seeded, the checkpoint
records how many batches the epoch had consumed, and every random draw
(dropout, sampling) is a function of (seed, global step); a streamed epoch
is seeded too, and resume skips the batches it had consumed.

On a mesh (``Trainer(mesh=...)``, ``parallel/mesh.py``) every rank runs the
trainer alike on its device, in every form: each step trains the rank's
block of the global batch (``parallel/sharded_train.py``, and
``parallel/sharded_sparse.py`` for sparse tables), and
``cfg.data.batch_size`` is the global batch, which must divide the data
axis. Tables are replicated or row-sharded as ``embedding_sharding``
resolves (sparse tables always row-sharded), the stores replicated or, with
``store_sharding="rows"``, row-sharded and read through the exchange in
training, validation and the corpus encode alike. Rank 0 alone writes
checkpoints (the row-sharded leaves gathered whole first), the metrics,
the results CSV and the log, and every rank restores its share. With
``MeshConfig.grad_compression`` the mesh steps are the compressed ones
(``parallel/compressed_grads.py``): each rank trains its block as a batch of
its own and the dense gradients sync through the compressed sum; its
error-feedback residual is threaded through every call and not
checkpointed, so a resume restarts it at zero. Off a mesh the setting is
ignored, as in the reference.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch

from jodalrob_twotower_torch.config import TrainConfig
from jodalrob_twotower_torch.data.feature_store import FeatureStore
from jodalrob_twotower_torch.data.pipeline import assemble_pair_batch, epoch_batches
from jodalrob_twotower_torch.device import resolve_device
from jodalrob_twotower_torch.evaluation.evaluator import (
    CorpusEvalResult,
    Evaluator,
    corpus_retrieval_eval,
    qualitative_assessment,
    sharded_corpus_retrieval_eval,
)
from jodalrob_twotower_torch.parallel.compressed_grads import (
    make_dp_compressed_indexed_train,
    make_dp_compressed_sparse_train,
)
from jodalrob_twotower_torch.parallel.sharded_sparse import make_sharded_sampled_sparse, make_sharded_sparse_train
from jodalrob_twotower_torch.parallel.sharded_store import resolve_store_placement
from jodalrob_twotower_torch.parallel.sharded_train import make_sharded_indexed_train, make_sharded_sampled_steps
from jodalrob_twotower_torch.models import build_model
from jodalrob_twotower_torch.serving.service import FrozenState
from jodalrob_twotower_torch.train import sparse_tables
from jodalrob_twotower_torch.train.checkpoint import CheckpointManager
from jodalrob_twotower_torch.train.ledger import append_result
from jodalrob_twotower_torch.train.train_step import (
    create_train_state,
    device_store,
    make_indexed_train_step,
    make_sampled_train_steps,
    make_scanned_train_steps,
    resolve_store_dtype,
)
from jodalrob_twotower_torch.utils.profiling import MetricsLogger


def host_store(fs: FeatureStore, dtype=None) -> tuple[torch.Tensor, torch.Tensor]:
    """A FeatureStore's (dense, cat_ids) as CPU tensors, the dense block at
    ``dtype`` (cast on the host, so only the smaller copy crosses)."""
    dense = torch.from_numpy(np.ascontiguousarray(fs.dense))
    return (dense.to(dtype) if dtype is not None else dense), torch.from_numpy(np.ascontiguousarray(fs.cat_ids))


@dataclasses.dataclass
class TrainResult:
    state: object
    history: list[dict]
    final_val: dict[str, float]
    corpus: CorpusEvalResult | None
    examples_per_sec: float
    num_params: int


def _count_params(params, mesh=None, sharded=frozenset()) -> int:
    """The model's parameter count (a row-sharded leaf counts its ranks'
    blocks together)."""
    n = mesh.size if mesh is not None else 1
    return int(sum(p.numel() * (n if k in sharded else 1) for k, p in params.items()))


class Trainer:
    """End-to-end training over host FeatureStores + positive pairs, on one
    device (``device``; None means the card, "cpu" must be asked for) or on
    this rank of ``mesh`` (its device)."""

    def __init__(
        self,
        cfg: TrainConfig,
        schema,
        notice_store: FeatureStore,
        company_store: FeatureStore,
        *,
        mesh=None,
        device=None,
        log_fn: Callable[[str], None] = print,
    ) -> None:
        self.cfg = cfg
        self.schema = schema
        self.notice_store = notice_store
        self.company_store = company_store
        self.mesh = mesh
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh rank's device {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.model = build_model(schema, cfg, mesh)
        main = mesh is None or mesh.is_main  # the rank that writes
        self.log = log_fn if main else (lambda *_: None)
        self.evaluator = Evaluator(self.model, cfg, mesh=mesh)
        self._dev_stores = None
        self._store_gather = None  # the exchange of row-sharded stores
        self._metrics_logger = MetricsLogger(cfg.metrics_jsonl) if cfg.metrics_jsonl and main else None

    def _init_state(self, total_steps: int):
        """Fresh weights (``init_flax`` from ``cfg.seed``) and the train state
        of the configured form, with its optimizer."""
        cfg = self.cfg
        self.model.init_flax(torch.Generator().manual_seed(cfg.seed))
        if cfg.sparse_tables:
            return sparse_tables.create_sparse_train_state(self.model, cfg, cfg.seed, total_steps, device=self.device)
        return create_train_state(self.model, cfg, cfg.seed, total_steps, device=self.device)

    def train(
        self,
        train_pairs: np.ndarray,
        val_pairs: np.ndarray,
        *,
        checkpoint_dir: str | Path | None = None,
        resume: bool = False,
        corpus_eval: bool = True,
        epoch_corpus_eval: bool = False,
        n_inner: int = 8,
        batch_source: Callable[[int], Iterable[np.ndarray]] | None = None,
        steps_per_epoch: int | None = None,
    ) -> TrainResult:
        """Train ``cfg.optimizer.num_epochs`` epochs of ``len(train_pairs) //
        batch_size`` steps, ``n_inner`` steps per call, validating on
        ``val_pairs`` after each; with ``checkpoint_dir``, checkpoint there
        and, with ``resume``, continue from its newest checkpoint.

        ``batch_source(epoch) -> iterable of [B, 2] index batches`` replaces
        the shuffled in-memory epochs (``train_streaming`` passes one); an
        epoch then runs as many steps as its source yields, and
        ``steps_per_epoch`` sizes the schedule."""
        cfg = self.cfg
        mesh = self.mesh
        if cfg.data.sample_on_device and batch_source is not None:
            raise ValueError(
                "sample_on_device needs the whole pair set device-resident; "
                "it is incompatible with streaming batch sources"
            )
        b = cfg.data.batch_size
        if steps_per_epoch is None:
            steps_per_epoch = len(train_pairs) // b
        total_steps = max(steps_per_epoch * cfg.optimizer.num_epochs, 1)
        n_inner = max(min(n_inner, steps_per_epoch), 1)
        dev = self.device
        model = self.model

        put_idx = None
        compressed = None  # CompressedDPTrain under grad_compression
        if mesh is not None and cfg.mesh.grad_compression != "none":
            self._check_compressed()
            self.model.init_flax(torch.Generator().manual_seed(cfg.seed))
            make_compressed = make_dp_compressed_sparse_train if cfg.sparse_tables else make_dp_compressed_indexed_train
            compressed = make_compressed(model, cfg, mesh, b, total_steps, method=cfg.mesh.grad_compression)
            state, tx, put_idx = compressed.state, compressed.tx, compressed.put_idx
            # the rank's error-feedback residual threads through every call;
            # the steps keep the (state, metrics) interface
            err_cell = [compressed.err_state]

            def threaded(fn: Callable) -> Callable:
                def call(st, *args):
                    st, err_cell[0], m = fn(st, err_cell[0], *args)
                    return st, m

                return call

            scan_steps, single_step = threaded(compressed.scan_steps), threaded(compressed.single_step)
            params = sparse_tables.merged_params(state) if cfg.sparse_tables else state.params
            num_params = _count_params(params, mesh, model.row_sharded_keys)
            if batch_source is not None:
                put_idx = None  # a streamed source yields the rank's own blocks
        elif mesh is not None:
            # the rank's share of the state (rank 0's replicated weights, its
            # own blocks of row-sharded tables) and the mesh steps on its
            # block of each global batch
            self.model.init_flax(torch.Generator().manual_seed(cfg.seed))
            if cfg.sparse_tables:
                state, single_step, put_idx, _, scan_steps = make_sharded_sparse_train(
                    model, cfg, mesh, b, total_steps, with_metrics=True, n_inner=n_inner,
                    defer_updates=cfg.sparse_defer_updates)
                num_params = _count_params(sparse_tables.merged_params(state), mesh, model.row_sharded_keys)
            else:
                state, tx, scan_steps, single_step, put_idx, _ = make_sharded_indexed_train(
                    model, cfg, mesh, b, total_steps, n_inner=n_inner)
                num_params = _count_params(state.params, mesh, model.row_sharded_keys)
            if batch_source is not None:
                put_idx = None  # a streamed source yields the rank's own blocks
        elif cfg.sparse_tables:
            state, tx = self._init_state(total_steps)
            make_window = (sparse_tables.make_deferred_sparse_steps if cfg.sparse_defer_updates
                           else sparse_tables.make_scanned_sparse_steps)
            scan_steps = make_window(model, cfg, tx, total_steps, n_inner)
            single_step = sparse_tables.make_sparse_train_step(model, cfg, tx, total_steps, with_metrics=True)
            num_params = _count_params(sparse_tables.merged_params(state))
        else:
            state, tx = self._init_state(total_steps)
            scan_steps = make_scanned_train_steps(model, cfg, tx, n_inner)
            single_step = make_indexed_train_step(model, cfg, tx, with_metrics=True)
            num_params = _count_params(state.params)

        sampled_steps: dict[int, Callable] = {}
        if cfg.data.sample_on_device:
            # batches drawn on the device, IID with replacement, by a
            # generator keyed with the global step: draws are a function of
            # the step counter, so mid-epoch resume replays them exactly
            if compressed is not None:
                make_sampled = lambda k: threaded(compressed.make_sampled(k))  # noqa: E731
            elif mesh is not None and cfg.sparse_tables:
                make_sampled = lambda k: make_sharded_sampled_sparse(  # noqa: E731
                    model, cfg, mesh, state, k, b, total_steps, defer_updates=cfg.sparse_defer_updates)[0]
            elif mesh is not None:
                make_sampled = lambda k: make_sharded_sampled_steps(model, cfg, tx, mesh, k, b)[0]  # noqa: E731
            elif not cfg.sparse_tables:
                make_sampled = lambda k: make_sampled_train_steps(model, cfg, tx, k, b)  # noqa: E731
            elif cfg.sparse_defer_updates:
                make_sampled = lambda k: sparse_tables.make_sampled_deferred_sparse_steps(  # noqa: E731
                    model, cfg, tx, total_steps, k, b)
            else:
                make_sampled = lambda k: sparse_tables.make_sampled_sparse_steps(  # noqa: E731
                    model, cfg, tx, total_steps, k, b)

            def sampled_fn(k: int) -> Callable:
                if k not in sampled_steps:
                    sampled_steps[k] = make_sampled(k)
                return sampled_steps[k]

            sampled_fn(n_inner)  # the main dispatch size
        self.log(f"model: {num_params:,} params; {steps_per_epoch} steps/epoch x {cfg.optimizer.num_epochs} epochs")

        ckpt = None
        start_epoch = 0
        skip_batches = 0  # mid-epoch resume: batches already trained this epoch
        if checkpoint_dir is not None:
            ckpt = CheckpointManager(checkpoint_dir, cfg.checkpoint, mesh=mesh, sharded=model.row_sharded_keys)
            ckpt.save_config(cfg)
            if resume:
                last_epoch = ckpt.latest_epoch()
                step_ckpt = ckpt.restore_step(state)
                # a mid-epoch checkpoint wins only if it is from an epoch no
                # completed-epoch checkpoint covers (the epoch save happens
                # after the last step save of that epoch)
                if step_ckpt is not None and step_ckpt[1] > (last_epoch if last_epoch is not None else -1):
                    state, start_epoch, saved_step, saved_batch = step_ckpt
                    if saved_batch is not None:
                        skip_batches = saved_batch
                    else:  # a pointer written without "batch": derive it
                        skip_batches = max(0, min(saved_step - start_epoch * steps_per_epoch, steps_per_epoch))
                    self.log(
                        f"resumed mid-epoch {start_epoch} at step {saved_step} "
                        f"(skipping {skip_batches} already-trained batches)"
                    )
                elif last_epoch is not None:
                    state = ckpt.restore(f"epoch_{last_epoch}", state)
                    start_epoch = last_epoch + 1
                    self.log(f"resumed from epoch {last_epoch} (step {int(state.step)})")

        # device-resident stores (dense blocks at the configured store dtype);
        # indices are the only per-step host-to-device traffic. Validation and
        # the corpus encode reuse them.
        self.prepare_device_eval()
        n_store, c_store = self._dev_stores
        pairs_dev = None
        if cfg.data.sample_on_device:
            if not len(train_pairs):
                raise ValueError("sample_on_device requires a non-empty pair set")
            pairs_dev = torch.from_numpy(np.asarray(train_pairs, np.int64)).to(dev)
            sample_seed = cfg.data.shuffle_seed

        if put_idx is None:
            def put_idx(idx: np.ndarray) -> torch.Tensor:
                return torch.from_numpy(np.asarray(idx, np.int64)).to(dev)

        history: list[dict] = []
        examples_per_sec = 0.0
        train_loss = float("nan")
        last_epoch_corpus = None  # the final epoch's epoch_corpus_eval result
        first_dispatch = True  # the first dispatch builds kernels: not timed
        save_every = cfg.checkpoint.save_every_steps if ckpt is not None else 0
        steps_since_save = 0
        for epoch in range(start_epoch, cfg.optimizer.num_epochs):
            t0 = time.perf_counter()
            losses: list[torch.Tensor] = []
            stack: list[np.ndarray] = []
            seen = 0
            # batches consumed from this epoch (skipped + trained), recorded
            # in mid-epoch checkpoints so that resume is exact
            batches_done = skip_batches
            if pairs_dev is not None:
                # sampled: steps_per_epoch draws on the device, no host
                # iterator; resume runs the remaining steps
                steps_todo = steps_per_epoch - skip_batches
                skip_batches = 0
                while steps_todo > 0:
                    k = min(n_inner, steps_todo)
                    state, metrics = sampled_fn(k)(state, sample_seed, pairs_dev, n_store, c_store)
                    if first_dispatch:
                        float(metrics["loss"][-1])  # wait for the first call
                        t0 = time.perf_counter()
                        seen = 0
                        first_dispatch = False
                    else:
                        seen += k * b
                    losses.append(metrics["loss"])
                    batches_done += k
                    steps_since_save += k
                    steps_todo -= k
                    if save_every and steps_since_save >= save_every:
                        ckpt.save_step(state, epoch, batches_done)
                        steps_since_save = 0
                batch_iter = ()
            elif batch_source is not None:
                batch_iter = batch_source(epoch)
            else:
                batch_iter = epoch_batches(train_pairs, b, shuffle=True, seed=cfg.data.shuffle_seed + epoch)
            for idx in batch_iter:
                if skip_batches:  # mid-epoch resume: the epoch iterator is
                    skip_batches -= 1  # seeded, so dropping the first N
                    continue  # batches replays the interrupted epoch exactly
                if first_dispatch and not stack and batch_source is None:
                    self.verify_pair_alignment(idx[: min(len(idx), 256)], train_pairs)
                stack.append(idx)
                if len(stack) == n_inner:
                    state, metrics = scan_steps(state, put_idx(np.stack(stack)), n_store, c_store)
                    stack.clear()
                    if first_dispatch:
                        float(metrics["loss"][-1])  # wait for the first call
                        t0 = time.perf_counter()
                        seen = 0  # this dispatch's examples and time both excluded
                        first_dispatch = False
                    else:
                        seen += n_inner * b
                    losses.append(metrics["loss"])
                    batches_done += n_inner
                    steps_since_save += n_inner
                    if save_every and steps_since_save >= save_every:
                        ckpt.save_step(state, epoch, batches_done)
                        steps_since_save = 0
            for idx in stack:  # remainder: single steps
                state, metrics = single_step(state, put_idx(idx), n_store, c_store)
                seen += b
                losses.append(metrics["loss"].reshape(-1))
                batches_done += 1
                steps_since_save += 1
                if save_every and steps_since_save >= save_every:
                    ckpt.save_step(state, epoch, batches_done)
                    steps_since_save = 0
            if losses:  # empty when a resume skipped the whole epoch
                epoch_losses = torch.cat([l.reshape(-1).float() for l in losses]).cpu().numpy()
                train_loss = float(epoch_losses[-min(len(epoch_losses), 20):].mean())
            dt = time.perf_counter() - t0
            examples_per_sec = seen / dt

            val = self.validate(state, val_pairs)
            entry = {
                "epoch": epoch,
                "train_loss": train_loss,
                "examples_per_sec": examples_per_sec,
                **{f"val_{k}": v for k, v in val.items()},
            }
            if epoch_corpus_eval and len(val_pairs):
                # the per-epoch corpus-retrieval trajectory, from the
                # device-resident stores
                last_epoch_corpus = self.corpus_eval(state, val_pairs)
                entry.update({f"corpus_recall@{k}": v for k, v in last_epoch_corpus.recall.items()})
                entry["corpus_mrr"] = last_epoch_corpus.mrr
            history.append(entry)
            if self._metrics_logger is not None:
                self._metrics_logger.log(int(state.step), entry)
            self.log(
                f"epoch {epoch}: train_loss {train_loss:.4f} val_loss {val.get('loss', float('nan')):.4f} "
                f"acc {val.get('accuracy', 0):.4f} mrr {val.get('mrr', 0):.4f} "
                f"gap {val.get('similarity_gap', 0):.4f} z-gap {val.get('z_gap', 0):.2f} "
                f"({examples_per_sec:,.0f} ex/s)"
            )
            if ckpt is not None:
                ckpt.save_epoch(state, epoch, metric=val.get("loss"))

        final_val = self.validate(state, val_pairs)
        self.log("assessment: " + qualitative_assessment(final_val, b))

        corpus = None
        if corpus_eval and len(val_pairs):
            # the last epoch's per-epoch result is this exact evaluation:
            # reuse it rather than encode the corpus again
            corpus = last_epoch_corpus if last_epoch_corpus is not None else self.corpus_eval(state, val_pairs)
            self.log(
                f"corpus retrieval over {corpus.corpus_size:,} companies: "
                + " ".join(f"recall@{k}={v:.4f}" for k, v in corpus.recall.items())
                + f" mrr={corpus.mrr:.4f}"
            )

        if ckpt is not None:
            ckpt.finalize(state)
        if cfg.results_csv and (mesh is None or mesh.is_main):
            val_out = dict(final_val)
            if corpus is not None:
                val_out.update({f"corpus_recall@{k}": v for k, v in corpus.recall.items()})
            append_result(
                cfg.results_csv,
                run_info={
                    "epochs": cfg.optimizer.num_epochs,
                    "batch_size": b,
                    "learning_rate": cfg.optimizer.learning_rate,
                    "embedding_dim": cfg.model.final_embedding_dim,
                    "num_params": num_params,
                    "examples_per_sec": f"{examples_per_sec:.0f}",
                },
                val_metrics=val_out,
                train_loss=train_loss,
            )
        return TrainResult(
            state=state,
            history=history,
            final_val=final_val,
            corpus=corpus,
            examples_per_sec=examples_per_sec,
            num_params=num_params,
        )

    def train_streaming(
        self,
        pair_files,
        val_pairs: np.ndarray,
        *,
        steps_per_epoch: int,
        host_index: int = 0,
        host_count: int = 1,
        chunk_rows: int = 1_000_000,
        **train_kwargs,
    ) -> TrainResult:
        """Train from parquet pair files too large for host memory
        (``data/parquet_stream.py``): each epoch streams the files again,
        in chunks of ``chunk_rows`` joined to the stores' keys, this host's
        lockstep shard of each (``host_index`` of ``host_count``), shuffled
        with the seed ``shuffle_seed + epoch``. ``steps_per_epoch`` sizes
        the schedule; ``train_kwargs`` go to :meth:`train`.

        On a mesh ``batch_size`` is the global batch: rank r streams
        ``host_index=r`` of ``host_count`` = the mesh size and trains
        batch_size / n rows of its own per step (reference trainer.py:637-648)."""
        from jodalrob_twotower_torch.data.parquet_stream import stream_pair_chunks, streaming_index_batches

        local_b = self.cfg.data.batch_size
        if self.mesh is not None:
            local_b = self.mesh.block(local_b).stop - self.mesh.block(local_b).start
            host_index, host_count = self.mesh.rank, self.mesh.size

        def source(epoch: int):
            return streaming_index_batches(
                stream_pair_chunks(pair_files, self.notice_store, self.company_store, chunk_rows=chunk_rows,
                                   host_index=host_index, host_count=host_count),
                local_b,
                seed=self.cfg.data.shuffle_seed + epoch,
            )

        return self.train(np.empty((0, 2), np.int64), val_pairs, batch_source=source,
                          steps_per_epoch=steps_per_epoch, **train_kwargs)

    def _check_compressed(self) -> None:
        """The reference's refusals of forms the compressed steps do not run
        (its train/trainer.py:128-148)."""
        cfg = self.cfg
        if cfg.sparse_tables and cfg.sparse_defer_updates:
            raise ValueError(
                "grad_compression with sparse_tables runs per-step "
                "table updates; sparse_defer_updates (windowed "
                "staleness) composed with quantized dense sync has no "
                "tested semantics — disable one of the two"
            )
        if cfg.mesh.store_sharding != "replicated":
            raise ValueError(
                "grad_compression requires store_sharding='replicated' "
                "(its explicit shard_map step feeds each shard the full "
                "stores)"
            )
        if cfg.model.embedding_lookup == "onehot":
            raise ValueError(
                "grad_compression uses the plain per-shard gather "
                "inside its explicit shard_map step (build_model "
                "installs no mesh lookup_fn in this mode) — "
                "embedding_lookup='onehot' cannot be honored; use "
                "'auto' or 'gather'"
            )

    def prepare_device_eval(self) -> None:
        """Place both feature stores on the device, so validate() and
        corpus_eval() run device-resident (indices-only uploads) without a
        prior train(): the standalone-eval entry point. On a mesh the stores
        are placed per ``cfg.mesh.store_sharding`` (whole, or the rank's
        block of rows read through the exchange), as the mesh steps read
        them."""
        store_dt = resolve_store_dtype(self.cfg)
        if self.mesh is None:
            self._dev_stores = (
                device_store(self.notice_store, dtype=store_dt, device=self.device),
                device_store(self.company_store, dtype=store_dt, device=self.device),
            )
            return
        self._store_gather, put_store = resolve_store_placement(self.cfg, self.mesh)
        self._dev_stores = tuple(put_store(host_store(fs, store_dt)) for fs in (self.notice_store, self.company_store))

    @staticmethod
    def verify_pair_alignment(batch_idx: np.ndarray, pairs: np.ndarray) -> None:
        """One-time check that every row of an index batch is a known
        positive pair (the reference ran an equivalent check on its first
        batch)."""
        def _pack(a: np.ndarray) -> np.ndarray:
            # rows are non-negative ints < 2^32: pack (i, j) into one int64 so
            # membership is a searchsorted over a sorted array
            a = np.asarray(a, dtype=np.int64)
            return (a[:, 0] << np.int64(32)) | a[:, 1]

        known = np.sort(_pack(pairs))
        keys = _pack(batch_idx)
        pos = np.minimum(np.searchsorted(known, keys), len(known) - 1)
        ok = known[pos] == keys
        if not ok.all():
            first = tuple(np.asarray(batch_idx)[~ok][0].tolist())
            raise AssertionError(
                f"{int((~ok).sum())}/{len(batch_idx)} batch rows are not known "
                f"positive pairs (first: {first}) - input pipeline misaligned"
            )

    @staticmethod
    def _eval_view(state) -> FrozenState:
        """The weights the evaluator reads, under the model's state_dict
        keys (a sparse state's tables merged back in)."""
        return FrozenState(state.state_dict)

    def validate(self, state, val_pairs: np.ndarray) -> dict[str, float]:
        b = self.cfg.data.batch_size
        state = self._eval_view(state)
        if self._dev_stores is not None and len(val_pairs) >= b:
            # device-resident eval: whole stacks of batches per call, only
            # indices over the link
            return self.evaluator.evaluate_indexed(state, val_pairs, *self._dev_stores, batch_size=b,
                                                   store_gather=self._store_gather)
        batches = (
            assemble_pair_batch(self.notice_store, self.company_store, idx)
            for idx in epoch_batches(val_pairs, b, shuffle=False)
        )
        return self.evaluator.evaluate(state, batches)

    def corpus_eval(self, state, val_pairs: np.ndarray, ks: tuple[int, ...] = (10, 100)) -> CorpusEvalResult:
        """Rank each val notice's paired company against the full corpus."""
        state = self._eval_view(state)
        if self._dev_stores is not None:
            # the big side encodes straight from the device-resident store
            # (on a mesh each rank a block of every chunk)
            corpus_emb = self.evaluator.encode_corpus_device(
                state, self._dev_stores[1], len(self.company_store), side="company", store_gather=self._store_gather
            )
        else:
            corpus_emb = self.evaluator.encode_corpus(
                state, self.company_store.dense, self.company_store.cat_ids, side="company"
            )
        q_rows = val_pairs[:, 0]
        query_emb = self.evaluator.encode_corpus(
            state, self.notice_store.dense[q_rows], self.notice_store.cat_ids[q_rows], side="notice"
        )
        if self.mesh is not None and self.mesh.size > 1:
            return sharded_corpus_retrieval_eval(query_emb, corpus_emb, val_pairs[:, 1], self.mesh, ks=ks)
        return corpus_retrieval_eval(query_emb, corpus_emb, val_pairs[:, 1], ks=ks)
