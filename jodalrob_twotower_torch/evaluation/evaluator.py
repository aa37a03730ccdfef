"""Evaluation: in-batch metrics, corpus-level retrieval, prediction demo
(port of ``jodalrob_twotower_tpu/evaluation/evaluator.py``).

Per-batch recall@k / MRR / accuracy / similarity means over in-batch
candidates (on the card from the statistics kernels, through the eval step),
random baselines, a qualitative assessment and a top-k prediction demo; and
corpus-level retrieval metrics, where each query ranks against the whole
company corpus. The ranking math is vectorized on the device; the corpus
ranks are plain float32 products and counts, as the reference computes them
outside any kernel. On a mesh (``parallel/mesh.py``) the evaluator's steps
run on each rank's block of every batch and return the global batch's
metrics on every rank, over replicated or row-sharded stores (a
``store_gather``, ``parallel/sharded_store.py``), and
:func:`sharded_corpus_retrieval_eval` ranks against a row-sharded corpus.
Every rank calls the evaluator alike, at the same shapes: a row-sharded
table or store is read through a collective exchange.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

import numpy as np
import torch

from jodalrob_twotower_torch.config import TrainConfig
from jodalrob_twotower_torch.data.types import PairBatch, TowerBatch
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel
from jodalrob_twotower_torch.parallel.mesh import row_sharding, shard_batch
from jodalrob_twotower_torch.train.metrics import random_baselines
from jodalrob_twotower_torch.train.train_step import (
    make_device_encode_fn,
    make_encode_fn,
    make_eval_step,
    make_indexed_eval_steps,
)


def qualitative_assessment(metrics: Mapping[str, float], batch_size: int) -> str:
    """Human-readable verdict against the random baselines (reference
    ``qualitative_assessment``)."""
    rb = random_baselines(batch_size)
    lift = metrics.get("accuracy", 0.0) / max(rb["accuracy"], 1e-12)
    gap = metrics.get("similarity_gap", 0.0)
    if lift >= 20 and gap > 0.2:
        quality = "excellent"
    elif lift >= 5:
        quality = "good"
    elif lift >= 2:
        quality = "weak"
    else:
        quality = "no better than random"
    return (
        f"{quality}: top-1 accuracy {metrics.get('accuracy', 0.0):.4f} is "
        f"{lift:.1f}x the random baseline {rb['accuracy']:.4f}; "
        f"similarity gap {gap:.4f}"
    )


def _fetch(metrics: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Every metric to the host in one copy."""
    keys = list(metrics)
    values = torch.stack([metrics[k].float() for k in keys]).cpu().numpy()
    return dict(zip(keys, values))


class Evaluator:
    """Runs eval over batches and aggregates the reference's metric surface
    (with ``mesh``, over the mesh: every rank calls alike)."""

    def __init__(self, model: TwoTowerModel, cfg: TrainConfig, *, mesh=None) -> None:
        self.model = model
        self.cfg = cfg
        self.mesh = mesh
        self._eval_step = make_eval_step(model, cfg, mesh=mesh)
        self._encode_notice = make_encode_fn(model, "notice")
        self._encode_company = make_encode_fn(model, "company")
        # one indexed eval per store kind: plain gathers or the exchange
        self._indexed_eval: dict[bool, object] = {}

    def evaluate(self, state, batches: Iterable[PairBatch]) -> dict[str, float]:
        """The in-batch metrics averaged over ``batches`` (host or device
        PairBatches, moved to the state's device), one device fetch per
        batch (reference ``evaluate``)."""
        total: dict[str, float] = {}
        n = 0
        batch_size = 0
        for batch in batches:
            batch_size = batch.batch_size  # the global batch's, also on a mesh
            if self.mesh is not None:  # the rank's block of the global batch
                batch = shard_batch(batch, self.mesh)
            batch = PairBatch(batch.notice.to(state.device), batch.company.to(state.device))
            m = _fetch(self._eval_step(state, batch))
            for k, v in m.items():
                total[k] = total.get(k, 0.0) + float(v)
            n += 1
        if n == 0:
            return {}
        out = {k: v / n for k, v in total.items()}
        out["num_batches"] = float(n)
        out["assessment_batch_size"] = float(batch_size)
        return out

    def evaluate_indexed(
        self,
        state,
        pairs: np.ndarray,
        notice_store,
        company_store,
        *,
        batch_size: int,
        stack: int = 32,
        store_gather=None,
    ) -> dict[str, float]:
        """:meth:`evaluate` over device-resident (dense, cat_ids) stores:
        only the [n, B, 2] indices go to the device, batches run in stacks
        of ``stack`` (``make_indexed_eval_steps``), and every stack's
        metrics are fetched at the end. A partial trailing batch is dropped;
        when the batches do not fill whole stacks, the final stack starts
        early and its already-covered head is left out (reference
        ``evaluate_indexed``). ``store_gather`` reads row-sharded stores
        through the exchange; ``batch_size`` must then be a multiple of its
        ``batch_multiple``, as the reference requires."""
        n_batches = len(pairs) // batch_size
        if n_batches == 0:
            return {}
        multiple = getattr(store_gather, "batch_multiple", 1) if store_gather is not None else 1
        if batch_size % multiple:
            raise ValueError(
                f"batch_size {batch_size} must be a multiple of the row-sharded store's mesh axis ({multiple}) "
                "- the eval batch is split over it by the cross-shard exchange"
            )
        key = store_gather is not None
        if key not in self._indexed_eval:
            self._indexed_eval[key] = make_indexed_eval_steps(self.model, self.cfg, mesh=self.mesh,
                                                              store_gather=store_gather)
        indexed_eval = self._indexed_eval[key]
        idx = torch.from_numpy(pairs[: n_batches * batch_size].astype(np.int64)).reshape(n_batches, batch_size, 2)
        idx = idx.to(state.device)
        stack = min(stack, n_batches)
        starts = list(range(0, n_batches - stack + 1, stack))
        if starts[-1] + stack < n_batches:
            starts.append(n_batches - stack)
        results = []
        for i, start in enumerate(starts):
            # for the overlapping final stack keep only the uncovered tail
            prev_end = starts[i - 1] + stack if i else 0
            keep = start + stack - max(prev_end, start)
            results.append((keep, indexed_eval(state, idx[start : start + stack], notice_store, company_store)))
        totals: dict[str, float] = {}
        for keep, m in results:
            for k, v in _fetch(m).items():
                totals[k] = totals.get(k, 0.0) + float(np.sum(v[-keep:]))
        out = {k: v / n_batches for k, v in totals.items()}
        out["num_batches"] = float(n_batches)
        out["assessment_batch_size"] = float(batch_size)
        return out

    def encode_corpus_device(
        self, state, store, n_rows: int, *, side: str = "company", chunk: int = 8192, store_gather=None
    ) -> torch.Tensor:
        """:meth:`encode_corpus` over a device-resident (dense, cat_ids)
        store: [n_rows, D] float32 on the store's device. The store may hold
        more rows than ``n_rows`` (padding). Chunks are of one size; when
        they do not tile the store, the final chunk starts early and its
        overlapping head is dropped (reference ``encode_corpus_device``). On
        a mesh each rank encodes its block of every chunk (the chunk cut to
        a multiple of the mesh size) and every rank returns the whole. A
        row-sharded store (``store_gather``; the rank's block of a store
        padded to a multiple of the mesh size) is read through the
        exchange, every rank at the same chunks."""
        store_rows = store[0].shape[0]
        if store_gather is not None:
            store_rows *= getattr(store_gather, "batch_multiple", 1)
        chunk = min(chunk, store_rows)
        if self.mesh is not None:
            chunk = max(chunk - chunk % self.mesh.size, self.mesh.size)
        encode = make_device_encode_fn(self.model, side, chunk, mesh=self.mesh, store_gather=store_gather)
        pieces = []
        covered = 0
        while covered < store_rows:
            start = min(covered, store_rows - chunk)
            pieces.append(encode(state, store, start)[covered - start :])
            covered = start + chunk
        return torch.cat(pieces)[:n_rows]

    def encode_corpus(
        self,
        state,
        store_dense: np.ndarray,
        store_cat: np.ndarray,
        *,
        side: str = "company",
        batch_size: int = 8192,
    ) -> torch.Tensor:
        """Encode a whole side's feature store into [N, D] float32 embeddings
        on the state's device (index-building path).

        On the card each chunk is staged in one of two pinned host buffers
        and copied with ``non_blocking``, so the host fills chunk i+1 while
        the card copies and encodes chunk i; a buffer is refilled only after
        the copy out of it has finished."""
        encode = self._encode_company if side == "company" else self._encode_notice
        device = state.device
        n = store_dense.shape[0]
        out = torch.empty((n, self.model.config.final_embedding_dim), dtype=torch.float32, device=device)
        if device.type != "cuda":
            for start in range(0, n, batch_size):
                rows = slice(start, start + batch_size)
                batch = TowerBatch(torch.from_numpy(store_dense[rows]), torch.from_numpy(store_cat[rows]))
                out[rows] = encode(state, batch.to(device))
            return out
        staging = [
            (
                torch.empty((batch_size, store_dense.shape[1]), dtype=torch.float32, pin_memory=True),
                torch.empty((batch_size, store_cat.shape[1]), dtype=torch.int32, pin_memory=True),
            )
            for _ in range(2)
        ]
        copied: list[torch.cuda.Event | None] = [None, None]
        stream = torch.cuda.current_stream(device)
        for i, start in enumerate(range(0, n, batch_size)):
            slot = i % 2
            if copied[slot] is not None:
                copied[slot].synchronize()
            m = min(batch_size, n - start)
            host_dense, host_cat = (buf[:m] for buf in staging[slot])
            host_dense.copy_(torch.from_numpy(store_dense[start : start + m]))
            host_cat.copy_(torch.from_numpy(store_cat[start : start + m]))
            batch = TowerBatch(host_dense, host_cat).to(device)
            copied[slot] = torch.cuda.Event()
            copied[slot].record(stream)
            out[start : start + m] = encode(state, batch)
        return out


@dataclasses.dataclass
class CorpusEvalResult:
    recall: dict[int, float]
    mrr: float
    num_queries: int
    corpus_size: int


def _as_tensor(x, device=None) -> torch.Tensor:
    return x.float() if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x, np.float32), device=device)


def corpus_retrieval_eval(
    query_emb,
    corpus_emb,
    positive_rows: np.ndarray,
    *,
    ks: tuple[int, ...] = (10, 100),
    query_chunk: int = 1024,
    corpus_chunk: int | None = None,
) -> CorpusEvalResult:
    """Rank each query's positive against the whole corpus (reference
    ``corpus_retrieval_eval``).

    rank = #{corpus rows scoring strictly above the positive}, the
    positive's own row left out by index; the positive's score is computed
    from its gathered row in both modes, so one-shot and chunked ranks are
    equal. recall@k is the share of queries whose rank is below k, MRR the
    mean of 1 / (rank + 1). Scores are float32 products on the query's
    device (``torch.backends.cuda.matmul.allow_tf32`` must stay False on the
    card). ``corpus_chunk`` bounds the [query_chunk, chunk] score block;
    None scores the whole corpus at once ([1024, N] f32: 4 GB at N = 1M)."""
    query = _as_tensor(query_emb)
    corpus = _as_tensor(corpus_emb, query.device)
    pos = torch.as_tensor(np.asarray(positive_rows), dtype=torch.int64, device=query.device)
    n_valid = corpus.shape[0]
    chunk = corpus_chunk or n_valid
    ranks = []
    for start in range(0, query.shape[0], query_chunk):
        q = query[start : start + query_chunk]
        p = pos[start : start + query_chunk]
        pos_sim = (q * corpus.index_select(0, p)).sum(1, keepdim=True)
        count = torch.zeros(q.shape[0], dtype=torch.int64, device=q.device)
        for c0 in range(0, n_valid, chunk):
            part = corpus[c0 : c0 + chunk]
            rows = torch.arange(c0, c0 + part.shape[0], device=q.device)
            count += ((q @ part.T > pos_sim) & (rows[None, :] != p[:, None])).sum(1)
        ranks.append(count)
    ranks = torch.cat(ranks).cpu().numpy()
    return CorpusEvalResult(
        recall={k: float((ranks < k).mean()) for k in ks},
        mrr=float((1.0 / (ranks + 1.0)).mean()),
        num_queries=query.shape[0],
        corpus_size=n_valid,
    )


def sharded_corpus_retrieval_eval(
    query_emb,
    corpus_emb,
    positive_rows: np.ndarray,
    mesh,
    *,
    ks: tuple[int, ...] = (10, 100),
    query_chunk: int = 1024,
) -> CorpusEvalResult:
    """:func:`corpus_retrieval_eval` with the corpus row-sharded over a mesh
    (reference ``sharded_corpus_retrieval_eval``, evaluator.py:365-430),
    called alike on every rank with the whole corpus and the queries.

    Each rank keeps its block of the corpus, padded to a multiple of the
    mesh size (``parallel/mesh.row_sharding``), and scores the queries
    against it alone. The positive row is picked by the rank that owns it
    and all-reduced, so every rank scores it from its gathered row; each
    rank counts its live rows strictly above it (the positive's own row left
    out by index) and one all-reduce of the integer counts merges them, so
    recall and MRR equal the single-device eval's exactly. Traffic per query
    block: the [Q, D] positive rows and the [Q] counts."""
    query = _as_tensor(query_emb, mesh.device).to(mesh.device)
    corpus = _as_tensor(corpus_emb, mesh.device)
    n_valid = corpus.shape[0]
    block = row_sharding(mesh, n_valid)
    shard = corpus[block.start : min(block.stop, n_valid)].to(mesh.device)
    offset = block.start
    pos = torch.as_tensor(np.asarray(positive_rows), dtype=torch.int64, device=mesh.device)
    rows = offset + torch.arange(shard.shape[0], device=mesh.device)
    ranks = []
    for start in range(0, query.shape[0], query_chunk):
        q = query[start : start + query_chunk]
        p = pos[start : start + query_chunk]
        local = p - offset
        mine = (local >= 0) & (local < shard.shape[0])
        picked = shard.index_select(0, local.clamp(0, max(shard.shape[0] - 1, 0))) if shard.shape[0] else \
            q.new_zeros(q.shape)
        pos_vec = mesh.all_reduce_(torch.where(mine[:, None], picked, torch.zeros((), device=q.device)))
        pos_sim = (q * pos_vec).sum(1, keepdim=True)
        count = ((q @ shard.T > pos_sim) & (rows[None, :] != p[:, None])).sum(1)
        ranks.append(mesh.all_reduce_(count))
    ranks = torch.cat(ranks).cpu().numpy()
    return CorpusEvalResult(
        recall={k: float((ranks < k).mean()) for k in ks},
        mrr=float((1.0 / (ranks + 1.0)).mean()),
        num_queries=query.shape[0],
        corpus_size=n_valid,
    )


def demonstrate_predictions(query_emb, corpus_emb, *, k: int = 10, query_keys=None, corpus_keys=None) -> list[dict]:
    """Top-k demo (reference ``demonstrate_predictions``): each query's k
    best corpus rows by inner product, with their scores."""
    query = _as_tensor(query_emb)
    scores, idx = torch.topk(query @ _as_tensor(corpus_emb, query.device).T, k, dim=1)
    scores, idx = scores.cpu().numpy(), idx.cpu().numpy()
    out = []
    for qi in range(query.shape[0]):
        out.append(
            {
                "query": str(query_keys[qi]) if query_keys is not None else qi,
                "top_k": [
                    {
                        "candidate": str(corpus_keys[ci]) if corpus_keys is not None else int(ci),
                        "score": float(s),
                    }
                    for ci, s in zip(idx[qi], scores[qi])
                ],
            }
        )
    return out
