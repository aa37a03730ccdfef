"""MIPS top-k indexes over a frozen corpus of tower embeddings (port of
``jodalrob_twotower_tpu/serving/index.py``).

* :class:`BruteForceIndex` - exact maximum-inner-product search: [Q, N]
  float32 matmul + top-k, corpus resident on the device.
* :class:`Int8Index` - corpus rows quantized to int8 with one f32 scale per
  row (max-abs symmetric); scores are ``(bf16(q) . int8_row) * row_scale``
  with float32 accumulation, optionally rescored exactly on the best
  ``rescore_depth`` candidates.

Every index keeps its rows in one layout, [n_chunks, C, D] (the int8
scales [n_chunks, C, 1]; the bf16 rescore copy [n_chunks C, D]), and
searches chunk by chunk with a running top-k, so peak memory is one [Q, C]
score block. ``corpus_chunk=C`` sets the chunk; None is one chunk of all N
rows, a view of them with no padding. Both kinds share one search
(``_ScanIndex.topk_body``: the first pass, then the rescore of its
candidates) and differ only in the query their product reads, one chunk's
product and the rows their second pass reads.

The exact scan's product stays ``torch.matmul`` in float32, as the
reference left it to XLA. The int8 scan's is ``ops/int8_scan`` (a CUDA
kernel on the card: bf16 tensor-core products of the int8 rows widened on
chip, the row scale in its epilogue; its plain version on the CPU): products
of bf16-rounded values are exact in float32, so only the order of the
float32 sum differs from the reference's bf16 product with float32
accumulation. The scan's selection
is the running top-k of ``ops/chunk_topk`` (a CUDA kernel on the card that
reads each score once, its plain version on the CPU), exact, with ties
broken toward the lower row as ``jax.lax.top_k`` breaks them; only a k above
the kernel's cap (``chunk_topk.MAX_K``) takes ``torch.topk`` and a merge.
``approx_recall`` is the reference's ``jax.lax.approx_max_k`` recall
target: it is checked against the range that function accepts, (0, 1],
kept and saved, and the selection stays exact, as the reference's is
everywhere but on a TPU (XLA's CPU and GPU backends lower
``approx_max_k`` to an exact top-k). :class:`ShardedIndex` row-shards the
corpus over a mesh's ranks (``parallel/mesh.py``): each rank's block is an
index of the kind, one chunk, and the ranks' answers are all-gathered and
merged. The npz format of ``save_index``/``load_index`` is the
reference's, so an index saved by either package loads in the other.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from jodalrob_twotower_torch.device import resolve_device
from jodalrob_twotower_torch.ops import chunk_topk as ct
from jodalrob_twotower_torch.ops.int8_scan import int8_scan
from jodalrob_twotower_torch.utils.profiling import span


class SearchResult(NamedTuple):
    scores: np.ndarray  # [Q, k] float32, descending
    indices: np.ndarray  # [Q, k] int32 corpus rows


_NEG = ct.NEG  # the float32 minimum: a padding entry's score


class HostCopy:
    """Device-to-host copies of result tensors into pinned memory, started
    with ``non_blocking`` at construction and waited on in :meth:`result`.
    The construction is a root span, ``serve.copy``."""

    _count = itertools.count()

    def __init__(self, *tensors: torch.Tensor) -> None:
        with span("serve.copy", root=next(HostCopy._count)):
            self.event = None
            if tensors[0].is_cuda:
                self.hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
                for host, t in zip(self.hosts, tensors):
                    host.copy_(t, non_blocking=True)
                self.event = torch.cuda.Event()
                self.event.record(torch.cuda.current_stream(tensors[0].device))
            else:
                self.hosts = [t.detach() for t in tensors]

    def result(self) -> list[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [h.numpy() for h in self.hosts]


def _check_approx(approx_recall: float | None) -> float | None:
    """The recall target ``jax.lax.approx_max_k`` takes, in (0, 1]; the
    reference fails at its first search outside it, the port at once."""
    if approx_recall is not None and not 0.0 < approx_recall <= 1.0:
        raise ValueError(f"approx_recall must be in (0, 1], got {approx_recall}")
    return approx_recall


def _check_rescore_depth(depth: int | None) -> int | None:
    if depth is not None and depth < 1:
        raise ValueError(f"rescore_depth must be >= 1, got {depth}")
    return depth


def _pad_chunks(arr: torch.Tensor, chunk: int) -> torch.Tensor:
    """[N, ...] -> [n_chunks, chunk, ...]; padding rows are zeros."""
    n = arr.shape[0]
    n_chunks = max(1, -(-n // chunk))
    pad = n_chunks * chunk - n
    if pad:
        arr = torch.cat([arr, arr.new_zeros((pad, *arr.shape[1:]))])
    return arr.reshape(n_chunks, chunk, *arr.shape[1:])


def _as_corpus(corpus_emb, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(corpus_emb).to(device=device, dtype=torch.float32)


def _merge_topk(scores_a, idx_a, scores_b, idx_b, k: int):
    """Merge two per-query candidate sets into the best k of their union."""
    s, sel = torch.topk(torch.cat([scores_a, scores_b], dim=1), k, dim=1)
    return s, torch.gather(torch.cat([idx_a, idx_b], dim=1), 1, sel)


def _rescore_topk(queries, cand_scores, cand_idx, k: int, rescore_rows, rescore_scales=None):
    """Second-stage exact rescore of first-pass candidates.

    ``cand_idx`` [Q, R] (R >= k) indexes ``rescore_rows`` [N, D] (a bf16/f32
    full-precision copy, or the int8 values with ``rescore_scales`` for a
    dequantized rescore). The R candidate rows per query are gathered and
    scored exactly (the query rounded to the rows' type, or to bf16 for int8
    rows) before the final top-k. A span, ``serve.rescore``."""
    with span("serve.rescore"):
        cand = rescore_rows[cand_idx]  # [Q, R, D]
        dtype = torch.bfloat16 if cand.dtype == torch.int8 else cand.dtype
        q = queries.to(dtype).float()
        s = torch.bmm(cand.to(dtype).float(), q[:, :, None])[..., 0]
        if rescore_scales is not None:
            s = s * rescore_scales[:, 0][cand_idx]
        # first-pass padding sentinels stay unselectable
        s = torch.where(cand_scores <= _NEG, _NEG, s)
        s2, sel = torch.topk(s, k, dim=1)
        return s2, torch.gather(cand_idx, 1, sel)


def _scanned_topk(chunk_sims_fn, n_chunks: int, chunk_rows: int, n_valid: int, queries: torch.Tensor, k: int):
    """An index's first pass, a span (``serve.scan``): the running top-k
    over corpus chunks; peak memory is one [Q, chunk] block.

    ``chunk_sims_fn(queries, ci) -> [Q, chunk_rows] f32`` scores chunk ci,
    whose column c is row ci * chunk_rows + c. Rows at or past ``n_valid``
    never enter; slots no valid row fills hold (the float32 minimum, row
    0). Up to ``chunk_topk.MAX_K`` the selection is
    :func:`ops.chunk_topk.chunk_topk`; past it, ``torch.topk`` of each
    block merged with ``_merge_topk``."""
    with span("serve.scan"):
        q, dev = queries.shape[0], queries.device
        best_s = torch.full((q, k), _NEG, dtype=torch.float32, device=dev)
        best_i = torch.zeros((q, k), dtype=torch.int64, device=dev)
        if k <= ct.MAX_K:
            work = ct.workspace(q, k, chunk_rows, dev)
            for ci in range(n_chunks):
                best_s, best_i = ct.chunk_topk(best_s, best_i, chunk_sims_fn(queries, ci), ci * chunk_rows, n_valid,
                                               work)
            return best_s, best_i
        cols = torch.arange(chunk_rows, device=dev)
        for ci in range(n_chunks):
            row0 = ci * chunk_rows
            sims = chunk_sims_fn(queries, ci)
            if row0 + chunk_rows > n_valid:
                sims = torch.where(row0 + cols[None, :] < n_valid, sims, _NEG)
            s, i = torch.topk(sims, k, dim=1)
            best_s, best_i = _merge_topk(best_s, best_i, s, i + row0, k)
        return best_s, best_i


def _search(index, queries, k: int) -> SearchResult:
    queries = torch.as_tensor(queries).to(index.device)
    scores, indices = [], []
    for start in range(0, queries.shape[0], index.query_chunk):
        s, i = HostCopy(*index.topk_body(queries[start : start + index.query_chunk], k)).result()
        scores.append(s)
        indices.append(i)
    return SearchResult(np.concatenate(scores), np.concatenate(indices))


class _ScanIndex:
    """The search of both single-device kinds, and of a :class:`ShardedIndex`
    rank's block. An index keeps its rows as [n_chunks, C, ...] tensors
    (``corpus_chunk`` None: one chunk of all N rows, a view of them); a kind
    gives the query its product reads (``_query``), one chunk's product
    (``_chunk_sims``) and the rows its second pass reads
    (``_second_pass_rows``)."""

    kind: str

    def _init(self, n_rows: int, query_chunk: int, corpus_chunk: int | None, approx_recall: float | None,
              rescore_depth: int | None, rescore_dtype: str, device: torch.device) -> None:
        """The options every index keeps, checked, and the layout of its
        ``n_rows`` rows as ``_pad_chunks`` cuts them: without
        ``corpus_chunk`` one chunk of them all (an empty corpus: one padding
        row)."""
        self.approx_recall = _check_approx(approx_recall)
        if rescore_dtype not in ("int8", "bfloat16"):
            raise ValueError(f"rescore_dtype must be 'int8' or 'bfloat16', got {rescore_dtype!r}")
        self.device = device
        self.query_chunk = query_chunk
        self.corpus_chunk = corpus_chunk
        self.rescore_depth = _check_rescore_depth(rescore_depth)
        self.n_valid = n_rows
        self._chunk_rows = corpus_chunk or max(1, n_rows)
        self._n_chunks = max(1, -(-n_rows // self._chunk_rows))

    def topk_body(self, queries: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Device search of one query block: (scores [Q, k] f32, rows [Q, k] int32)."""
        s, i = self._local_topk(queries, k)
        return s, i.to(torch.int32)

    def _local_topk(self, queries: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """The first pass and its rescore over this index's rows: (scores
        [Q, k] f32, rows [Q, k] int64)."""
        q = self._query(queries)  # once a search; each chunk's product reads it
        c = self._chunk_rows
        kk = max(k, min(max(k, self.rescore_depth or 0), c))  # per-chunk candidate cap
        s, i = _scanned_topk(self._chunk_sims, self._n_chunks, c, self.n_valid, q, kk)
        if self.rescore_depth:
            # second pass over the kk candidates: re-ranks the chunk-merge
            # selection, with exact f32 or bf16 scores where the kind keeps them
            s, i = _rescore_topk(queries, s, i, k, *self._second_pass_rows())
        return s, i

    def __len__(self) -> int:
        return self.n_valid

    def search(self, queries, k: int = 10) -> SearchResult:
        return _search(self, queries, k)


class BruteForceIndex(_ScanIndex):
    """Exact MIPS: the corpus f32 on the device as [n_chunks, C, D]; the
    product is a float32 matmul, and the rescore reads the same rows."""

    kind = "exact"

    def __init__(self, corpus_emb, *, query_chunk: int = 1024,
                 corpus_chunk: int | None = None,
                 approx_recall: float | None = None,
                 rescore_depth: int | None = None,
                 device=None) -> None:
        self._build(corpus_emb, query_chunk, corpus_chunk, approx_recall, rescore_depth, "int8",
                    resolve_device(device))

    def _build(self, rows, query_chunk: int, corpus_chunk: int | None, approx_recall: float | None,
               rescore_depth: int | None, rescore_dtype: str, device: torch.device) -> None:
        corpus = _as_corpus(rows, device)
        self._init(corpus.shape[0], query_chunk, corpus_chunk, approx_recall, rescore_depth, rescore_dtype,
                   device)
        self.corpus = _pad_chunks(corpus, self._chunk_rows)  # [n_chunks, C, D] f32

    def _query(self, queries: torch.Tensor) -> torch.Tensor:
        return queries.float()

    def _chunk_sims(self, q32: torch.Tensor, ci: int) -> torch.Tensor:
        return q32 @ self.corpus[ci].T

    def _second_pass_rows(self) -> tuple:
        return (self.corpus.reshape(-1, self.corpus.shape[-1]),)

    def _host_corpus(self) -> np.ndarray:
        flat = self.corpus.reshape(-1, self.corpus.shape[-1])[: self.n_valid]
        return flat.cpu().numpy()


class Int8Index(_ScanIndex):
    """Row-wise symmetric int8 quantized MIPS: int8 values [n_chunks, C, D]
    and f32 scales [n_chunks, C, 1] on the device, and the bf16 rescore
    copy [n_chunks C, D] when the rescore is bf16."""

    kind = "int8"

    def __init__(self, corpus_emb, *, query_chunk: int = 1024,
                 corpus_chunk: int | None = None,
                 approx_recall: float | None = None,
                 rescore_depth: int | None = None,
                 rescore_dtype: str = "int8",
                 device=None) -> None:
        self._build(corpus_emb, query_chunk, corpus_chunk, approx_recall, rescore_depth, rescore_dtype,
                    resolve_device(device))

    def _build(self, rows, query_chunk: int, corpus_chunk: int | None, approx_recall: float | None,
               rescore_depth: int | None, rescore_dtype: str, device: torch.device) -> None:
        # host rows are quantized on the host: only the int8 values, scales
        # and bf16 rescore rows reach the device, never the f32 corpus
        corpus = _as_corpus(rows, device if isinstance(rows, torch.Tensor) else torch.device("cpu"))
        values, scales = quantize_int8(corpus)
        rescore_rows = corpus if rescore_depth and rescore_dtype == "bfloat16" else None
        self._init_from_quantized(values, scales, query_chunk, corpus_chunk, approx_recall,
                                  rescore_depth, rescore_dtype, rescore_rows, device)

    def _init_from_quantized(self, values, scales, query_chunk: int,
                             corpus_chunk: int | None,
                             approx_recall: float | None,
                             rescore_depth: int | None,
                             rescore_dtype: str,
                             rescore_rows,
                             device: torch.device) -> None:
        self._init(values.shape[0], query_chunk, corpus_chunk, approx_recall, rescore_depth, rescore_dtype,
                   device)
        if rescore_depth and rescore_dtype == "bfloat16" and rescore_rows is None:
            raise ValueError(
                "bfloat16 rescore needs the full-precision corpus; build via "
                "Int8Index(corpus_emb, ...) or pass rescore_rows"
            )
        if rescore_rows is not None and rescore_rows.shape[0] != values.shape[0]:
            raise ValueError(
                f"rescore_rows has {rescore_rows.shape[0]} rows but values has "
                f"{values.shape[0]} - they must cover the same corpus"
            )
        self.rescore_dtype = rescore_dtype
        self.values = _pad_chunks(torch.as_tensor(values).to(device), self._chunk_rows)  # [nc, C, D] int8
        self.scales = _pad_chunks(torch.as_tensor(scales).to(device), self._chunk_rows)  # [nc, C, 1] f32
        self.rescore_rows = None
        if self.rescore_depth and rescore_dtype == "bfloat16":
            rows = torch.as_tensor(rescore_rows).to(torch.bfloat16).to(device)  # cast where the rows are
            # padded as the chunks are, so candidate indices into padding
            # rows stay in bounds (their scores are masked)
            self.rescore_rows = _pad_chunks(rows, self._chunk_rows).reshape(-1, rows.shape[-1])  # [N_pad, D] bf16

    @classmethod
    def from_quantized(cls, values, scales, *, query_chunk: int = 1024,
                       corpus_chunk: int | None = None,
                       approx_recall: float | None = None,
                       rescore_depth: int | None = None,
                       rescore_dtype: str = "int8",
                       rescore_rows=None,
                       device=None) -> "Int8Index":
        """Build from already-quantized rows (numpy or tensors)."""
        idx = cls.__new__(cls)
        idx._init_from_quantized(values, scales, query_chunk, corpus_chunk, approx_recall,
                                 rescore_depth, rescore_dtype, rescore_rows,
                                 resolve_device(device))
        return idx

    def _query(self, queries: torch.Tensor) -> torch.Tensor:
        return queries.to(torch.bfloat16).contiguous()

    def _chunk_sims(self, qbf: torch.Tensor, ci: int) -> torch.Tensor:
        return int8_scan(qbf, self.values[ci], self.scales[ci, :, 0])

    def _second_pass_rows(self) -> tuple:
        if self.rescore_rows is not None:  # bf16 full-precision second pass
            return (self.rescore_rows,)
        # dequantized int8: re-ranks the chunk-merge selection only
        return self.values.reshape(-1, self.values.shape[-1]), self.scales.reshape(-1, 1)

    @property
    def nbytes(self) -> int:
        """Device bytes the index pins: int8 values + f32 scales + the bf16
        rescore copy when present."""
        n = self.values.numel() + self.scales.numel() * 4
        if self.rescore_rows is not None:
            n += self.rescore_rows.numel() * 2
        return n

    def _host_quantized(self) -> tuple[np.ndarray, np.ndarray]:
        v = self.values.reshape(-1, self.values.shape[-1])[: self.n_valid]
        s = self.scales.reshape(-1, 1)[: self.n_valid]
        return v.cpu().numpy(), s.cpu().numpy()


_KINDS = {"exact": BruteForceIndex, "int8": Int8Index}


class ShardedIndex:
    """MIPS over a corpus row-sharded across a mesh (reference
    ``ShardedIndex``, serving/index.py:408-596): each rank keeps its block
    of the corpus, padded to a multiple of the mesh size
    (``parallel/mesh.row_sharding``), as a single-device index of the kind
    (``kind``: float32-exact or int8) with one chunk of the block's rows,
    so the rows past the corpus's end are that chunk's padding. The block
    searches as that index does, rescore included, so the merge orders the
    scores the rescore gave, and ``approx_recall`` is kept as the
    single-device indexes keep it (the selection stays exact). The block's
    k candidates and their global rows are all-gathered and merged on every
    rank, so the traffic per query block is O(ranks k), never the corpus.
    Every rank calls :meth:`search` with the same queries and gets the same
    answers."""

    def __init__(self, corpus_emb, mesh, *, kind: str = "exact", query_chunk: int = 1024,
                 approx_recall: float | None = None,
                 rescore_depth: int | None = None,
                 rescore_dtype: str = "int8") -> None:
        from jodalrob_twotower_torch.parallel.mesh import row_sharding

        if kind not in _KINDS:
            raise ValueError(f"unknown kind: {kind}")
        self.mesh = mesh
        self.kind = kind
        self.device = mesh.device
        self.query_chunk = query_chunk
        corpus = torch.as_tensor(corpus_emb).float()
        self.n_valid = corpus.shape[0]
        block = row_sharding(mesh, self.n_valid)
        self.shard_rows = block.stop - block.start
        self.row0 = block.start
        self.block = _KINDS[kind].__new__(_KINDS[kind])
        self.block._build(corpus[block], query_chunk, self.shard_rows, approx_recall, rescore_depth, rescore_dtype,
                          self.device)

    def __len__(self) -> int:
        return self.n_valid

    def topk_body(self, queries: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Search of one query block, the same on every rank: (scores [Q, k]
        f32, global rows [Q, k] int32)."""
        s, i = self.block._local_topk(queries, k)
        i = i + self.row0
        s_all = self.mesh.all_gather_rows(s.T.contiguous()).T  # [Q, ranks k]
        i_all = self.mesh.all_gather_rows(i.T.contiguous()).T
        s2, sel = torch.topk(s_all, k, dim=1)
        return s2, torch.gather(i_all, 1, sel).to(torch.int32)

    def search(self, queries, k: int = 10) -> SearchResult:
        return _search(self, queries, k)


def quantize_int8(corpus):
    """Row-wise symmetric int8: values [N, D] int8, scales [N, 1] f32.

    Works on numpy arrays or tensors (on their device), with the same
    arithmetic, so both give the reference's host bits. The divisor 127 is a
    tensor on the corpus's device: CUDA turns division by a Python scalar
    into a product with its reciprocal, one ulp off on some rows, which can
    move a value across a rounding boundary."""
    if isinstance(corpus, torch.Tensor):
        amax = corpus.abs().amax(dim=1, keepdim=True)
        scales = (amax / amax.new_tensor(127.0)).float()
        safe = torch.where(scales > 0, scales, torch.ones_like(scales))
        values = torch.clamp(torch.round(corpus / safe), -127, 127).to(torch.int8)
        return values, scales
    amax = np.max(np.abs(corpus), axis=1, keepdims=True)
    scales = (amax / 127.0).astype(np.float32)
    safe = np.where(scales > 0, scales, np.ones_like(scales))
    values = np.clip(np.round(corpus / safe), -127, 127).astype(np.int8)
    return values, scales


def save_index(index: "BruteForceIndex | Int8Index", path) -> None:
    """Persist a built index (npz, the reference's format): rebuildable
    without the towers."""
    if isinstance(index, Int8Index):
        values, scales = index._host_quantized()
        extra = {}
        if index.rescore_rows is not None:
            # bf16 doesn't survive npz: persist as f32 (exact superset),
            # without the chunk padding - load re-pads
            extra["rescore_rows"] = index.rescore_rows[: index.n_valid].float().cpu().numpy()
        np.savez_compressed(
            path, kind="int8", values=values, scales=scales,
            query_chunk=index.query_chunk,
            corpus_chunk=index.corpus_chunk or 0,
            approx_recall=index.approx_recall or 0.0,
            rescore_depth=index.rescore_depth or 0,
            rescore_dtype=index.rescore_dtype,
            **extra,
        )
    else:
        np.savez_compressed(
            path, kind="exact", corpus=index._host_corpus(),
            query_chunk=index.query_chunk,
            corpus_chunk=index.corpus_chunk or 0,
            approx_recall=index.approx_recall or 0.0,
            rescore_depth=index.rescore_depth or 0,
        )


def load_index(path, *, device=None) -> "BruteForceIndex | Int8Index":
    with np.load(path) as z:
        kind = str(z["kind"])
        corpus_chunk = int(z["corpus_chunk"]) if "corpus_chunk" in z else 0
        approx = float(z["approx_recall"]) if "approx_recall" in z else 0.0
        depth = int(z["rescore_depth"]) if "rescore_depth" in z else 0
        if kind == "int8":
            return Int8Index.from_quantized(
                z["values"], z["scales"],
                query_chunk=int(z["query_chunk"]),
                corpus_chunk=corpus_chunk or None,
                approx_recall=approx or None,
                rescore_depth=depth or None,
                rescore_dtype=(str(z["rescore_dtype"]) if "rescore_dtype" in z else "int8"),
                rescore_rows=(z["rescore_rows"] if "rescore_rows" in z else None),
                device=device,
            )
        return BruteForceIndex(z["corpus"], query_chunk=int(z["query_chunk"]),
                               corpus_chunk=corpus_chunk or None,
                               approx_recall=approx or None,
                               rescore_depth=depth or None,
                               device=device)


def recall_vs_exact(approx: SearchResult, exact: SearchResult, k: int | None = None) -> float:
    """Fraction of exact top-k that the approximate index recovered."""
    k = k or exact.indices.shape[1]
    hits = 0
    for a_row, e_row in zip(approx.indices[:, :k], exact.indices[:, :k]):
        hits += len(set(a_row.tolist()) & set(e_row.tolist()))
    return hits / (exact.indices.shape[0] * k)
