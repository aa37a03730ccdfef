"""Retrieval service: frozen towers + corpus index -> top-k companies (port of
``jodalrob_twotower_tpu/serving/service.py``).

Encode the company corpus once with the frozen company tower, build an exact
or int8 index, then serve notice queries (raw features -> notice tower ->
MIPS top-k). Results reach the host through pinned, ``non_blocking`` copies,
and ``qps_bench`` keeps several batches in flight so the host's dispatch and
copies overlap the card's work.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Literal

import numpy as np
import torch

from jodalrob_twotower_torch.config import TrainConfig
from jodalrob_twotower_torch.data.feature_store import FeatureStore
from jodalrob_twotower_torch.data.types import TowerBatch
from jodalrob_twotower_torch.device import resolve_device
from jodalrob_twotower_torch.evaluation.evaluator import Evaluator
from jodalrob_twotower_torch.serving.index import (
    BruteForceIndex,
    HostCopy,
    Int8Index,
    SearchResult,
    ShardedIndex,
)
from jodalrob_twotower_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class FrozenState:
    """Weights-only model state for serving: the model's ``state_dict``
    (parameters and BatchNorm statistics), the port's counterpart of the
    reference's (params, batch_stats) pair. Build it from flax variables
    with ``convert.flax_to_state_dict`` or from a model with
    :meth:`from_model`."""

    state_dict: dict[str, torch.Tensor]

    @classmethod
    def from_model(cls, model: torch.nn.Module) -> "FrozenState":
        return cls({k: v.detach().clone() for k, v in model.state_dict().items()})

    def to(self, device: torch.device) -> "FrozenState":
        return FrozenState({k: v.to(device) for k, v in self.state_dict.items()})

    @property
    def device(self) -> torch.device:
        return next(iter(self.state_dict.values())).device


class RetrievalService:
    def __init__(
        self,
        model,
        cfg: TrainConfig,
        state: FrozenState,
        company_store: FeatureStore,
        *,
        index_kind: Literal["exact", "int8"] = "exact",
        query_chunk: int = 1024,
        corpus_chunk: int | None = None,
        approx_recall: float | None = None,
        rescore_depth: int | None = None,
        rescore_dtype: str = "int8",
        mesh=None,
        precomputed_corpus_emb=None,
        prebuilt_index=None,
        device=None,
    ) -> None:
        """Serve on ``device`` (None means the card), or with ``mesh`` on
        the rank's device from a :class:`ShardedIndex` (every rank encodes
        the corpus and keeps its block; every rank must search alike).
        ``state`` is moved there; the corpus is encoded there unless ``prebuilt_index`` (e.g.
        from ``index.load_index``) or ``precomputed_corpus_emb`` (the corpus
        already encoded: a tensor, or host numpy that the index moves, int8
        rows quantized on the host) is given."""
        if index_kind not in ("exact", "int8"):
            raise ValueError(f"index_kind must be 'exact' or 'int8', got {index_kind!r}")
        if mesh is not None:
            if prebuilt_index is not None:
                raise ValueError(
                    "prebuilt_index cannot be combined with a mesh: persisted indexes are "
                    "single-host - rebuild with mesh=... (ShardedIndex) instead"
                )
            if corpus_chunk is not None:
                raise ValueError(
                    "corpus_chunk is not supported with a mesh: ShardedIndex scores each shard "
                    "whole - bound per-device memory by the shard size (more devices) instead"
                )
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh rank's device {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.state = state.to(self.device)
        self.company_store = company_store
        self._evaluator = Evaluator(model, cfg)
        if prebuilt_index is not None:
            if prebuilt_index.device != self.device:
                raise ValueError(
                    f"prebuilt_index lives on {prebuilt_index.device}, the service on {self.device}"
                )
            self.index = prebuilt_index
        else:
            corpus_emb = precomputed_corpus_emb
            if corpus_emb is None:
                corpus_emb = self._evaluator.encode_corpus(
                    self.state, company_store.dense, company_store.cat_ids, side="company"
                )
            if mesh is not None:
                self.index = ShardedIndex(
                    corpus_emb, mesh, kind=index_kind, query_chunk=query_chunk, approx_recall=approx_recall,
                    rescore_depth=rescore_depth, rescore_dtype=rescore_dtype,
                )
            elif index_kind == "int8":
                self.index = Int8Index(
                    corpus_emb, query_chunk=query_chunk, corpus_chunk=corpus_chunk,
                    approx_recall=approx_recall, rescore_depth=rescore_depth,
                    rescore_dtype=rescore_dtype, device=self.device,
                )
            else:
                self.index = BruteForceIndex(
                    corpus_emb, query_chunk=query_chunk, corpus_chunk=corpus_chunk,
                    approx_recall=approx_recall, rescore_depth=rescore_depth,
                    device=self.device,
                )
        self._encode_notice = self._evaluator._encode_notice
        self._requests = itertools.count()  # the ids of search_device's root spans

    def encode_queries(self, batch: TowerBatch) -> torch.Tensor:
        return self._encode_notice(self.state, batch.to(self.device))

    @torch.inference_mode()
    def search_device(self, batch: TowerBatch, k: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
        """Encode + search; returns device tensors (scores [Q, k] f32,
        rows [Q, k] int32) without waiting for the card. One request: a
        root span, ``serve.search``, around ``serve.encode`` and the index's
        spans."""
        with span("serve.search", root=next(self._requests)):
            with span("serve.encode"):
                queries = self.encode_queries(batch)
            return self.index.topk_body(queries, k)

    def search(self, batch: TowerBatch, k: int = 10) -> SearchResult:
        """notice features -> top-k company rows + scores."""
        return SearchResult(*HostCopy(*self.search_device(batch, k)).result())

    def search_keys(self, batch: TowerBatch, k: int = 10) -> list[list[tuple[str, float]]]:
        """Same, resolved to company primary keys (the serving payload)."""
        res = self.search(batch, k)
        keys = self.company_store.keys
        return [
            [(str(keys[ci]), float(s)) for ci, s in zip(idx_row, score_row)]
            for idx_row, score_row in zip(res.indices, res.scores)
        ]


def qps_bench(
    service: RetrievalService,
    query_store: FeatureStore,
    *,
    k: int = 100,
    batch_size: int = 1024,
    n_batches: int = 20,
    seed: int = 0,
    pipeline_depth: int = 2,
) -> dict:
    """Sustained queries/sec through encode + search.

    Keeps ``pipeline_depth`` batches in flight: batch i+1 is dispatched
    before batch i's results are waited for, and each result's pinned host
    copy starts at dispatch. Every result IS fetched to host numpy - the
    loop measures real end-to-end serving, host assembly excluded."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, len(query_store), size=(n_batches, batch_size))
    batches = [query_store.gather(r) for r in rows]
    service.search(batches[0], k)  # warm-up
    in_flight: list[HostCopy] = []
    results: list[SearchResult] = []

    def drain(limit: int) -> None:
        while len(in_flight) > limit:
            results.append(SearchResult(*in_flight.pop(0).result()))

    t0 = time.perf_counter()
    for batch in batches:
        in_flight.append(HostCopy(*service.search_device(batch, k)))
        drain(pipeline_depth - 1)
    drain(0)
    elapsed = time.perf_counter() - t0
    if len(results) != n_batches or not np.isfinite(results[-1].scores).all():
        raise RuntimeError("qps_bench: a batch's results are missing or not finite")
    return {
        "qps": n_batches * batch_size / elapsed,
        "latency_ms_per_batch": elapsed / n_batches * 1e3,
        "batch_size": batch_size,
        "k": k,
        "corpus_size": len(service.index),
    }
