"""Streaming pair input: train on pair sets too large for host memory (port
of ``jodalrob_twotower_tpu/data/parquet_stream.py``).

The stores stay resident (host, and the card for the indexed steps); the
pairs stream from parquet chunks. Chunks are read with pyarrow's batch
iterator, key-joined to store rows with a sorted-array lookup, sharded
across hosts, shuffled within the chunk and emitted as [B, 2] int64 index
batches by a reader thread.

Sharding across hosts is lockstep: every host reads and joins every chunk
alike, trims it to a multiple of ``host_count`` and takes the strided rows
``[host_index::host_count]``, so every host gets the same row count of each
chunk and yields the same number of batches. ``host_index`` and
``host_count`` are arguments; on a mesh ``Trainer.train_streaming`` sets
them to the rank and the mesh size (the reference reads them from JAX's
process index), so every rank streams its own share. pyarrow is
imported inside ``stream_pair_chunks`` only (the card machine has none).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Iterator, Sequence

import numpy as np

from jodalrob_twotower_torch.data.feature_store import FeatureStore
from jodalrob_twotower_torch.data.pipeline import _Worker


class _KeyIndex:
    """Vectorized key -> row lookup (sorted array + searchsorted)."""

    def __init__(self, store: FeatureStore) -> None:
        keys = np.asarray(store.keys).astype(str)
        self._order = np.argsort(keys).astype(np.int64)
        self._sorted = keys[self._order]

    def lookup(self, query: np.ndarray) -> np.ndarray:
        """rows [N] int64; -1 where the key is absent."""
        query = np.asarray(query).astype(str)
        if not len(self._sorted):
            return np.full(len(query), -1, dtype=np.int64)
        pos = np.searchsorted(self._sorted, query)
        pos_c = np.minimum(pos, len(self._sorted) - 1)
        rows = self._order[pos_c]
        return np.where(self._sorted[pos_c] == query, rows, -1)


def stream_pair_chunks(
    paths: Sequence[str | Path] | str | Path,
    notice_store: FeatureStore,
    company_store: FeatureStore,
    *,
    chunk_rows: int = 1_000_000,
    host_index: int = 0,
    host_count: int = 1,
    on_missing: str = "drop",
) -> Iterator[np.ndarray]:
    """Yield pair-row chunks, int64 [<= chunk_rows // host_count, 2].

    Files hold (notice_key, company_key) columns (``parquet_dataset``).
    Keys join to store rows chunk by chunk; a pair with a missing key drops
    or, with ``on_missing="error"``, raises ``KeyError``. Every host gets
    exactly ``kept // host_count`` rows of each chunk.

    pyarrow is imported and the files opened here, on the calling thread;
    the chunks may then be read on another (``streaming_index_batches``'
    reader). Opened first on that reader thread, a file crashed a mesh rank
    with a segmentation fault inside ``ParquetFile`` (a training process,
    gloo up; tests/test_torch_mesh_train.py)."""
    import pyarrow.parquet as pq

    if isinstance(paths, (str, Path)):
        paths = [paths]
    files = [pq.ParquetFile(str(path)) for path in paths]
    return _chunks(files, _KeyIndex(notice_store), _KeyIndex(company_store), chunk_rows, host_index, host_count,
                   on_missing)


def _chunks(files, n_idx: _KeyIndex, c_idx: _KeyIndex, chunk_rows: int, host_index: int, host_count: int,
            on_missing: str) -> Iterator[np.ndarray]:
    for pf in files:
        for batch in pf.iter_batches(batch_size=chunk_rows, columns=["notice_key", "company_key"]):
            n_rows = n_idx.lookup(batch.column(0).to_numpy(zero_copy_only=False))
            c_rows = c_idx.lookup(batch.column(1).to_numpy(zero_copy_only=False))
            ok = (n_rows >= 0) & (c_rows >= 0)
            if on_missing == "error" and not ok.all():
                i = int(np.argmin(ok))
                raise KeyError(
                    "pair references missing key "
                    f"({batch.column(0)[i].as_py()!r}, {batch.column(1)[i].as_py()!r})"
                )
            rows = np.stack([n_rows[ok], c_rows[ok]], axis=1)
            # the lockstep trim: the same count on every host, however many
            # rows this chunk had or dropped
            per_host = len(rows) // host_count
            if per_host:
                yield np.ascontiguousarray(rows[host_index::host_count][:per_host])


def streaming_index_batches(
    pair_chunks: Iterable[np.ndarray],
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
    prefetch_chunks: int = 2,
) -> Iterator[np.ndarray]:
    """Chunks read ``prefetch_chunks`` ahead on a thread -> shuffled [B, 2]
    int64 batches. Each chunk is shuffled on its own (one generator seeded
    with ``seed`` for the epoch) and its remainder rows carry into the next
    chunk, so nothing drops mid-stream. An exception of the chunk iterator
    is re-raised here, on the consumer: swallowing it would turn a broken
    source into a silently shorter epoch."""
    rng = np.random.default_rng(seed)
    carry = np.empty((0, 2), dtype=np.int64)
    for chunk in _Worker(pair_chunks, prefetch_chunks):
        if shuffle:
            chunk = chunk[rng.permutation(len(chunk))]
        if len(carry):
            chunk = np.concatenate([carry, chunk])
        n_full = len(chunk) // batch_size
        for i in range(n_full):
            yield np.ascontiguousarray(chunk[i * batch_size : (i + 1) * batch_size], dtype=np.int64)
        carry = chunk[n_full * batch_size :]
    if len(carry) and not drop_remainder:
        yield np.ascontiguousarray(carry, dtype=np.int64)
