"""Batch pipeline: pair indices -> batches on the device (port of
``jodalrob_twotower_tpu/data/pipeline.py``).

Host side: ``epoch_batches`` yields shuffled [B, 2] index batches with the
reference's numpy permutation, so both packages see the same batches for
the same seed; ``assemble_pair_batch`` gathers one aligned batch from the
host stores with numpy, rows bounds-checked as in the reference.
``BackgroundAssembler`` runs the gather on a worker thread with
``torch.index_select``, which releases the GIL (the reference's worker runs
a native gather that does), straight into page-locked buffers when the
batches are bound for the card.

Device side: ``prefetch_to_device`` keeps ``size`` batches in flight. Each
is copied from page-locked memory on a side stream; the consumer's stream
waits on an event recorded after the copies, and each device tensor is
marked as used by the consumer's stream (``record_stream``), so that the
caching allocator does not hand its memory to a later batch while a step
still reads it. ``index_batches`` and ``index_stacks`` stream [B, 2] and
[n_inner, B, 2] index batches the same way, each window one upload, and
``train_batches`` chains shuffle -> gather (worker) -> prefetch.

Indices are int64, the port's convention (the reference streams int32).
The port takes a ``device`` (None means the card); the reference's
``sharding`` argument of ``prefetch_to_device`` and ``train_batches`` takes
a mesh (``parallel/mesh.py``): each rank then gets its block of every global
batch (the rows the reference's ``P("data")`` gives its device), on its
device.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from jodalrob_twotower_torch.data.feature_store import FeatureStore, check_rows
from jodalrob_twotower_torch.data.types import PairBatch, TowerBatch
from jodalrob_twotower_torch.device import resolve_device


def assemble_pair_batch(notice_store: FeatureStore, company_store: FeatureStore, pairs: np.ndarray) -> PairBatch:
    """Gather one aligned batch. pairs: int [B, 2] rows into the stores, each
    in [0, n) of its store (``IndexError`` otherwise)."""
    pairs = np.asarray(pairs)
    return PairBatch(notice=notice_store.gather(pairs[:, 0]), company=company_store.gather(pairs[:, 1]))


def epoch_batches(
    pairs: np.ndarray,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
) -> Iterator[np.ndarray]:
    """Yield [B, 2] index batches for one epoch."""
    n = pairs.shape[0]
    order = np.random.default_rng(seed).permutation(n) if shuffle else np.arange(n)
    end = n - (n % batch_size) if drop_remainder else n
    for start in range(0, end, batch_size):
        yield pairs[order[start : start + batch_size]]


def _map(fn: Callable[[torch.Tensor], torch.Tensor], batch: PairBatch) -> PairBatch:
    return PairBatch(*(TowerBatch(fn(side.dense), fn(side.cat_ids)) for side in batch))


def _gather_batch(notice_store: FeatureStore, company_store: FeatureStore, pairs: np.ndarray, *,
                  pin_memory: bool) -> PairBatch:
    """``assemble_pair_batch`` into CPU tensors (page-locked with
    ``pin_memory``), bit for bit: ``torch.index_select`` copies the rows and
    releases the GIL while it does."""
    pairs = np.asarray(pairs)
    sides = []
    for store, col in ((notice_store, 0), (company_store, 1)):
        rows = torch.from_numpy(check_rows(pairs[:, col], len(store)))
        cols = []
        for src in (torch.from_numpy(store.dense), torch.from_numpy(store.cat_ids)):
            out = torch.empty((len(rows), src.shape[1]), dtype=src.dtype, pin_memory=pin_memory)
            cols.append(torch.index_select(src, 0, rows, out=out))
        sides.append(TowerBatch(*cols))
    return PairBatch(*sides)


class _Worker:
    """Runs ``items`` on a daemon thread, at most ``depth`` items ahead of the
    consumer. An exception of the worker is re-raised on the consumer:
    swallowing it would turn a broken data source into a silently shorter
    epoch. Closing the consumer's iterator stops the worker at its next
    item."""

    _DONE = object()

    def __init__(self, items: Iterable, depth: int) -> None:
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(items,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _run(self, items: Iterable) -> None:
        try:
            for item in items:
                if not self._put((item, None)):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised on the consumer
            self._put((None, e))
            return
        self._put((self._DONE, None))

    def __iter__(self) -> Iterator:
        try:
            while True:
                item, error = self._q.get()
                if error is not None:
                    raise error
                if item is self._DONE:
                    return
                yield item
        finally:
            self._stop.set()


class BackgroundAssembler:
    """Assemble host batches on a worker thread while the device computes.

    The worker gathers each index batch's rows (``torch.index_select``,
    GIL released), into page-locked memory with ``pin_memory``, ``depth``
    batches ahead; the consumer thread issues the copies to the card
    (``prefetch_to_device``). A failing index iterator or gather raises on
    the consumer; it never ends the epoch early."""

    def __init__(
        self,
        notice_store: FeatureStore,
        company_store: FeatureStore,
        index_batches: Iterable[np.ndarray],
        *,
        depth: int = 4,
        pin_memory: bool = False,
    ) -> None:
        self._worker = _Worker(
            (_gather_batch(notice_store, company_store, idx, pin_memory=pin_memory) for idx in index_batches),
            depth,
        )

    def __iter__(self) -> Iterator[PairBatch]:
        return iter(self._worker)


def _tree_map(fn: Callable[[torch.Tensor], torch.Tensor], x):
    return _map(fn, x) if isinstance(x, PairBatch) else fn(x)


def _leaves(x) -> list[torch.Tensor]:
    return [t for side in x for t in side if t is not None] if isinstance(x, PairBatch) else [x]


class _Uploader:
    """Copies of host tensors (a PairBatch or one tensor) to ``device``. On
    the card each copy runs from page-locked memory on a side stream, and
    ``take`` hands it to the consumer's stream: that stream waits on an
    event recorded after the copies, and every device tensor is recorded as
    used by it, so that the caching allocator keeps its memory from later
    batches until the consumer's work on it is done. PyTorch's caching host
    allocator keeps each page-locked source from reuse until its copy is
    done."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def host(self, shape: tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
        """An empty host buffer to fill, page-locked when bound for the card."""
        return torch.empty(shape, dtype=dtype, pin_memory=self.stream is not None)

    def put(self, x):
        """Issue the copy of ``x``; returns (device copy, event or None)."""
        x = _tree_map(torch.as_tensor, x)
        if self.stream is None:
            return _tree_map(lambda t: t.to(self.device), x), None
        x = _tree_map(lambda t: t if t.is_pinned() else t.pin_memory(), x)
        with torch.cuda.stream(self.stream):
            dev = _tree_map(lambda t: t.to(self.device, non_blocking=True), x)
            done = torch.cuda.Event()
            done.record(self.stream)
        return dev, done

    def take(self, item):
        """The device copy of ``put``, ready for the consumer's stream."""
        dev, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(done)
            for t in _leaves(dev):
                t.record_stream(consumer)
        return dev


def _in_flight(uploader: _Uploader, host: Iterable, depth: int) -> Iterator:
    """Issue each host item's copy as it comes and yield the device items,
    up to ``depth`` more in flight behind the one yielded."""
    buf: collections.deque = collections.deque()
    for item in host:
        buf.append(uploader.put(item))
        if len(buf) > depth:
            yield uploader.take(buf.popleft())
    while buf:
        yield uploader.take(buf.popleft())


def prefetch_to_device(
    host_batches: Iterable[PairBatch],
    *,
    size: int = 2,
    device=None,
    sharding=None,
) -> Iterator[PairBatch]:
    """Keep ``size`` batches in flight on ``device`` (None means the card)
    ahead of the consumer: the copy of batch k+1 overlaps the step on batch
    k. Host batches that are not page-locked are pinned first, on this
    thread. With ``sharding`` (a mesh) each global batch is cut to the
    rank's block and placed on the rank's device."""
    if sharding is not None:
        device = sharding.device
        host_batches = (_map(lambda t, r=sharding.block(b.batch_size): torch.as_tensor(t)[r], b)
                        for b in host_batches)
    return _in_flight(_Uploader(resolve_device(device)), host_batches, size)


def index_batches(
    pairs: np.ndarray,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
    prefetch: int = 2,
    device=None,
) -> Iterator[torch.Tensor]:
    """Stream of [B, 2] int64 index batches on ``device`` (None means the
    card), ``prefetch`` ahead. Companion to the indexed train step
    (``train_step.make_indexed_train_step``): with the feature stores on the
    device, this is the only per-step host-to-device traffic."""
    up = _Uploader(resolve_device(device))

    def host() -> Iterator[torch.Tensor]:
        for b in epoch_batches(pairs, batch_size, shuffle=shuffle, seed=seed, drop_remainder=drop_remainder):
            buf = up.host((len(b), 2), torch.int64)
            buf.numpy()[:] = b
            yield buf

    return _in_flight(up, host(), prefetch)


def index_stacks(
    pairs: np.ndarray,
    batch_size: int,
    n_inner: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    prefetch: int = 2,
    device=None,
) -> Iterator[torch.Tensor]:
    """[n_inner, B, 2] int64 index windows on ``device`` (None means the
    card) for multi-step calls (``train_step.make_scanned_train_steps``).
    Each window is assembled contiguously on the host and shipped in one
    copy; ``prefetch`` windows in flight overlap window k+1's copy with the
    steps on window k. Trailing batches that do not fill a window are
    dropped (the epoch semantics of ``drop_remainder``)."""
    up = _Uploader(resolve_device(device))

    def host() -> Iterator[torch.Tensor]:
        window: list[np.ndarray] = []
        for idx in epoch_batches(pairs, batch_size, shuffle=shuffle, seed=seed):
            window.append(idx)
            if len(window) == n_inner:
                buf = up.host((n_inner, batch_size, 2), torch.int64)
                arr = buf.numpy()
                for i, w in enumerate(window):
                    arr[i] = w
                window.clear()
                yield buf

    return _in_flight(up, host(), prefetch)


def train_batches(
    notice_store: FeatureStore,
    company_store: FeatureStore,
    pairs: np.ndarray,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    drop_remainder: bool = True,
    prefetch: int = 2,
    background: bool = True,
    device=None,
    sharding=None,
) -> Iterator[PairBatch]:
    """Full pipeline: shuffle -> gather (on a worker thread with
    ``background``) -> ``prefetch`` batches in flight on ``device`` (None
    means the card). ``prefetch <= 0`` uploads each batch with a plain
    blocking copy on the consumer's stream. With ``sharding`` (a mesh) the
    rank gathers only its block of each global batch, onto its device."""
    dev = resolve_device(sharding.device if sharding is not None else device)
    pin = dev.type == "cuda" and prefetch > 0
    idx = epoch_batches(pairs, batch_size, shuffle=shuffle, seed=seed, drop_remainder=drop_remainder)
    if sharding is not None:
        idx = (b[sharding.block(len(b))] for b in idx)
    if background:
        host: Iterable[PairBatch] = BackgroundAssembler(notice_store, company_store, idx, pin_memory=pin)
    else:
        host = (_gather_batch(notice_store, company_store, b, pin_memory=pin) for b in idx)
    if prefetch <= 0:
        yield from (_map(lambda t: t.to(dev), b) for b in host)
    else:
        yield from prefetch_to_device(host, size=prefetch, device=dev)
