"""Recall-targeted serving auto-configuration (port of
``jodalrob_twotower_tpu/serving/autoconfig.py``, one device).

The serving stack has three knobs (index kind, ``approx_recall``, two-stage
rescore depth; serving/index.py). ``_CURVE`` orders the candidate
configurations fastest first, as the reference measured them on its 10M
corpus: rescore-400 over approx 0.90, then rescore-400 over approx 0.97,
then the exact float32 scan. Its ``expected_recall`` values are recall@100
priors from that measurement, not speeds of this card; the port's indexes
select exactly (the reference's off-TPU semantics), so the two int8 rows
differ here only in the recall target they carry.

* :func:`calibrate_serving_config` (what ``serve --target-recall`` runs):
  each candidate's recall@k is measured against the exact scan on the
  deployment's own corpus and a sample of its queries, fastest first; the
  first candidate that meets the target wins.
* :func:`choose_serving_config`: the priors-only pick, for when no corpus is
  at hand.

The plain-int8 configuration is not a candidate: rescore-400 over approx
0.90 gave more recall and more queries/s in the reference's measurement.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jodalrob_twotower_torch.device import resolve_device
from jodalrob_twotower_torch.serving.index import _NEG, BruteForceIndex, Int8Index, _merge_topk


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """One point on the QPS/recall frontier."""

    index_kind: str  # "int8" | "exact"
    approx_recall: float | None
    rescore_depth: int | None
    rescore_dtype: str
    expected_recall: float  # recall@100 vs exact: a prior, or measured by calibration
    note: str

    def cli_flags(self) -> list[str]:
        """The equivalent explicit serve flags (for logging)."""
        flags = ["--index", self.index_kind]
        if self.approx_recall is not None:
            flags += ["--approx-recall", str(self.approx_recall)]
        if self.rescore_depth is not None:
            flags += ["--rescore-depth", str(self.rescore_depth), "--rescore-dtype", self.rescore_dtype]
        return flags


EXACT = ServingConfig("exact", None, None, "int8", 1.0, "exact brute-force f32 scan")

# Fastest -> slowest.
_CURVE: tuple[ServingConfig, ...] = (
    ServingConfig(
        "int8", 0.90, 400, "bfloat16", 0.988,
        "rescore-400 over approx 0.90 (dominates plain int8: more recall AND more QPS)",
    ),
    ServingConfig("int8", 0.97, 400, "bfloat16", 0.995, "rescore-400 over approx 0.97"),
    EXACT,
)

# a measured recall equal to the target up to float rounding meets it
_RECALL_TOLERANCE = 1e-9


def _check_target(target_recall: float) -> None:
    if not 0.0 < target_recall <= 1.0:
        raise ValueError(f"target_recall must be in (0, 1], got {target_recall}")


def choose_serving_config(target_recall: float, *, k: int = 100) -> ServingConfig:
    """Priors-only pick: the fastest configuration whose prior recall@100
    meets ``target_recall``. Past k = 100 the rescore depth of 400 was never
    measured, so the exact scan is returned (a guard, not a measurement).
    Prefer :func:`calibrate_serving_config` when the corpus is at hand."""
    _check_target(target_recall)
    if k > 100:
        return _CURVE[-1]
    for cfg in _CURVE:
        if cfg.expected_recall >= target_recall - _RECALL_TOLERANCE:
            return cfg
    return _CURVE[-1]


def overlap_recall(got: np.ndarray, exact_indices: np.ndarray, k: int) -> float:
    """Mean per-query overlap of ``got`` [Q, k] with the exact top-k: the one
    recall@k-vs-exact definition that calibration and its validation share."""
    hits = 0
    for row_got, row_exact in zip(got, exact_indices):
        hits += len(np.intersect1d(row_got, row_exact, assume_unique=False))
    return hits / (exact_indices.shape[0] * k)


def measured_recall_at_k(index, exact_indices: np.ndarray, query_emb, k: int) -> float:
    """:func:`overlap_recall` of ``index``'s search against the exact scan."""
    return overlap_recall(np.asarray(index.search(query_emb, k).indices), exact_indices, k)


def _exact_topk_streamed(corpus_np: np.ndarray, query_emb, k: int, chunk: int, query_chunk: int = 1024,
                         *, device=None) -> np.ndarray:
    """Exact top-k rows [Q, k] int32 of a host corpus, streamed to ``device``
    (None means the card) in ``chunk``-row slices, so that nothing
    corpus-sized is ever resident there.

    Each slice is copied into one reused pinned host buffer and from there,
    ``non_blocking``, into one reused device buffer; the host refills the
    pinned buffer only once the copy out of it has finished, so filling
    slice i+1 overlaps the card's work on slice i. Queries run in
    ``query_chunk`` slices inside the corpus loop, so the corpus streams
    once. The tail slice's stale rows are masked to the float32 minimum and
    candidates merge with the index's ``_merge_topk``, as the device-resident
    scan does."""
    dev = resolve_device(device)
    n, d = corpus_np.shape
    if n < k:
        raise ValueError(f"exact reference needs at least k={k} corpus rows, got {n}")
    chunk = min(chunk, n)  # a sub-chunk corpus must not be padded up
    q_all = torch.as_tensor(query_emb).to(device=dev, dtype=torch.float32)
    q_slices = [q_all[lo : lo + query_chunk] for lo in range(0, q_all.shape[0], query_chunk)]
    carry = [(torch.full((qs.shape[0], k), _NEG, device=dev), torch.zeros((qs.shape[0], k), dtype=torch.int64,
                                                                            device=dev)) for qs in q_slices]
    on_card = dev.type == "cuda"
    host = torch.empty((chunk, d), dtype=torch.float32, pin_memory=on_card)
    block = torch.empty((chunk, d), dtype=torch.float32, device=dev) if on_card else host
    copied = None
    cols = torch.arange(chunk, device=dev)
    for lo in range(0, n, chunk):
        n_valid = min(chunk, n - lo)
        if copied is not None:
            copied.synchronize()
        host[:n_valid].copy_(torch.from_numpy(np.ascontiguousarray(corpus_np[lo : lo + n_valid], np.float32)))
        if on_card:
            block.copy_(host, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(dev))
        for j, qs in enumerate(q_slices):
            s = qs @ block.T
            if n_valid < chunk:  # the tail slice's stale rows are unselectable
                s = torch.where(cols[None, :] < n_valid, s, _NEG)
            ls, li = torch.topk(s, k, dim=1)
            carry[j] = _merge_topk(*carry[j], ls, li + lo, k)
    return torch.cat([bi for _, bi in carry]).to(torch.int32).cpu().numpy()


def calibrate_serving_config(
    target_recall: float,
    corpus_emb,
    query_emb,
    *,
    k: int = 100,
    corpus_chunk: int | None = None,
    query_chunk: int = 1024,
    curve: tuple[ServingConfig, ...] = _CURVE,
    device=None,
) -> tuple[ServingConfig, dict[str, float]]:
    """Measured pick: each candidate's recall@k against the exact scan on
    this corpus and this query sample, in the curve's fastest-first order;
    the first candidate that meets ``target_recall`` wins. A target no
    candidate reaches returns the curve's exact scan (recall 1.0 by
    construction); a curve without one raises ``ValueError``.

    ``corpus_emb`` is a tensor (its device runs everything: the exact
    reference is a ``BruteForceIndex`` of it, freed before the first
    candidate) or host numpy (run on ``device``, None meaning the card: the
    exact reference streams from the host, ``corpus_chunk`` or 262,144 rows
    at a time, and each candidate uploads only its int8 and bf16 copies).
    Candidates are built one at a time and each is freed before the next.

    Returns ``(chosen, measured)``: ``measured`` maps each evaluated
    candidate's note, and "exact", to its measured recall."""
    _check_target(target_recall)
    if isinstance(corpus_emb, torch.Tensor):
        dev = corpus_emb.device
        exact = BruteForceIndex(corpus_emb, query_chunk=query_chunk, corpus_chunk=corpus_chunk, device=dev)
        exact_idx = exact.search(query_emb, k).indices
        del exact
    else:
        dev = resolve_device(device)
        corpus_emb = np.asarray(corpus_emb, np.float32)
        exact_idx = _exact_topk_streamed(corpus_emb, query_emb, k, corpus_chunk or 262_144,
                                         query_chunk=query_chunk, device=dev)
    measured: dict[str, float] = {}
    chosen = None
    for cand in curve:
        if cand.index_kind == "exact":
            continue
        idx = Int8Index(
            corpus_emb, query_chunk=query_chunk, corpus_chunk=corpus_chunk,
            approx_recall=cand.approx_recall, rescore_depth=cand.rescore_depth,
            rescore_dtype=cand.rescore_dtype, device=dev,
        )
        r = measured_recall_at_k(idx, exact_idx, query_emb, k)
        del idx
        measured[cand.note] = r
        if r >= target_recall - _RECALL_TOLERANCE:
            chosen = dataclasses.replace(cand, expected_recall=round(r, 6))
            break
    measured["exact"] = 1.0
    if chosen is None:
        chosen = next((c for c in curve if c.index_kind == "exact"), None)
        if chosen is None:
            raise ValueError(
                f"no candidate of the curve reached recall {target_recall} and the curve has no exact "
                "entry to fall back to"
            )
    return chosen, measured
