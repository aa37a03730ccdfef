"""The port's host pipeline against the JAX package's: ``epoch_batches``
(the same index batches for the same seed), ``assemble_pair_batch`` (bit for
bit, and rows outside [0, n) refused with the reference's ``IndexError``),
``index_batches`` and ``index_stacks`` (the same values; the port's are
int64), ``train_batches`` with and without the background worker and the
prefetch (bit for bit), ``BackgroundAssembler`` re-raising its worker's
exception and stopping its worker when the consumer stops; then the results
ledger (the same rows apart from the timestamp, the same rule for a
pre-existing header) and ``MetricsLogger`` (the same JSON lines apart from
the elapsed time, tensors written as floats as the reference writes its
arrays). Every iteration over a worker runs with a bounded wait."""

import csv
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.data import pipeline as tpipe
from jodalrob_twotower_torch.data.synthetic import make_synthetic_dataset as t_make_dataset
from jodalrob_twotower_torch.schema import tiny_synthetic_schema as t_tiny_schema
from jodalrob_twotower_torch.train import ledger as tledger
from jodalrob_twotower_torch.utils.profiling import MetricsLogger as TMetricsLogger
from jodalrob_twotower_tpu.data import pipeline as jpipe
from jodalrob_twotower_tpu.data.synthetic import make_synthetic_dataset as j_make_dataset
from jodalrob_twotower_tpu.schema import tiny_synthetic_schema as j_tiny_schema
from jodalrob_twotower_tpu.train import ledger as jledger
from jodalrob_twotower_tpu.utils.profiling import MetricsLogger as JMetricsLogger

from torch_parity import DRAIN_TIMEOUT_S, drain



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small gathers run fastest on one thread, and several test workers
    sharing the cores do not oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def datasets():
    kw = dict(n_notices=300, n_companies=200, n_pairs=500, n_clusters=8, seed=5)
    j_ds = j_make_dataset(j_tiny_schema(n_categorical=3, vocab_size=40, n_numeric=6), **kw)
    t_ds = t_make_dataset(t_tiny_schema(n_categorical=3, vocab_size=40, n_numeric=6), **kw)
    return j_ds, t_ds


@pytest.mark.parametrize("n,batch,shuffle,seed,drop", [
    (1000, 64, True, 0, True), (1000, 64, True, 43, True), (1000, 64, False, 0, True),
    (1000, 64, True, 7, False), (64, 64, True, 1, True), (10, 64, True, 1, True),
])
def test_epoch_batches_match_the_reference(n, batch, shuffle, seed, drop):
    pairs = np.random.default_rng(3).integers(0, 500, size=(n, 2))
    kw = dict(shuffle=shuffle, seed=seed, drop_remainder=drop)
    got = list(tpipe.epoch_batches(pairs, batch, **kw))
    want = list(jpipe.epoch_batches(pairs, batch, **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_assemble_pair_batch_is_bit_equal(datasets):
    j_ds, t_ds = datasets
    for idx in list(tpipe.epoch_batches(t_ds.pairs, 128, seed=2))[:3]:
        got = tpipe.assemble_pair_batch(t_ds.notice_store, t_ds.company_store, idx)
        want = jpipe.assemble_pair_batch(j_ds.notice_store, j_ds.company_store, idx)
        for g, w in ((got.notice, want.notice), (got.company, want.company)):
            assert g.dense.dtype == np.asarray(w.dense).dtype and g.cat_ids.dtype == np.asarray(w.cat_ids).dtype
            np.testing.assert_array_equal(g.dense, np.asarray(w.dense))
            np.testing.assert_array_equal(g.cat_ids, np.asarray(w.cat_ids))


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for gs, ws in ((g.notice, w.notice), (g.company, w.company)):
            for gt, wt in ((gs.dense, ws.dense), (gs.cat_ids, ws.cat_ids)):
                wt = np.asarray(wt)
                assert isinstance(gt, torch.Tensor) and gt.device.type == "cpu"
                assert gt.numpy().dtype == wt.dtype
                np.testing.assert_array_equal(gt.numpy(), wt)


@pytest.mark.parametrize("side", ["notice", "company"])
@pytest.mark.parametrize("bad_row", ["negative", "past_the_end"])
def test_gathers_refuse_rows_outside_the_store_like_the_reference(datasets, side, bad_row):
    j_ds, t_ds = datasets
    n = len(getattr(t_ds, f"{side}_store"))
    row = -1 if bad_row == "negative" else n
    pairs = np.zeros((2, 2), dtype=np.int64)
    pairs[0, 0 if side == "notice" else 1] = row
    messages = []
    for mod, ds in ((jpipe, j_ds), (tpipe, t_ds)):
        with pytest.raises(IndexError) as err:
            mod.assemble_pair_batch(ds.notice_store, ds.company_store, pairs)
        messages.append(str(err.value))
        with pytest.raises(IndexError):
            getattr(ds, f"{side}_store").gather(np.asarray([0, row]))
    assert messages[0] == messages[1]
    assert f"{n} rows" in messages[1] and "negatives not allowed" in messages[1]
    with pytest.raises(IndexError, match="negatives not allowed"):  # the worker's gather too
        drain(tpipe.BackgroundAssembler(t_ds.notice_store, t_ds.company_store, [pairs]))


@pytest.mark.parametrize("n,batch,seed,prefetch,shuffle,drop", [
    (1000, 64, 0, 2, True, True), (1000, 64, 9, 0, True, False), (1000, 100, 3, 1, False, True),
    (64, 64, 1, 2, True, True), (10, 64, 1, 2, True, False), (777, 32, 4, 5, True, True),
])
def test_index_batches_match_the_reference(n, batch, seed, prefetch, shuffle, drop):
    pairs = np.random.default_rng(3).integers(0, 500, size=(n, 2))
    kw = dict(shuffle=shuffle, seed=seed, drop_remainder=drop, prefetch=prefetch)
    got = list(tpipe.index_batches(pairs, batch, device="cpu", **kw))
    want = [np.asarray(jax.device_get(b)) for b in jpipe.index_batches(pairs, batch, **kw)]
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("n,batch,n_inner,seed,prefetch", [
    (1000, 64, 3, 0, 2), (1000, 64, 1, 5, 0), (2000, 50, 8, 2, 1), (640, 64, 10, 7, 2), (600, 64, 10, 7, 2),
])
def test_index_stacks_match_the_reference(n, batch, n_inner, seed, prefetch):
    pairs = np.random.default_rng(4).integers(0, 500, size=(n, 2))
    got = list(tpipe.index_stacks(pairs, batch, n_inner, seed=seed, prefetch=prefetch, device="cpu"))
    want = [np.asarray(jax.device_get(w)) for w in jpipe.index_stacks(pairs, batch, n_inner, seed=seed,
                                                                      prefetch=prefetch)]
    assert len(got) == len(want) == (n // batch) // n_inner
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and g.shape == (n_inner, batch, 2)
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("background", [True, False])
@pytest.mark.parametrize("prefetch", [0, 2])
def test_train_batches_are_bit_equal_to_the_reference(datasets, background, prefetch):
    j_ds, t_ds = datasets
    kw = dict(seed=11, drop_remainder=False, prefetch=prefetch, background=background)
    want = [jax.device_get(b) for b in drain(jpipe.train_batches(j_ds.notice_store, j_ds.company_store,
                                                                  j_ds.pairs, 64, **kw))]
    got = drain(tpipe.train_batches(t_ds.notice_store, t_ds.company_store, t_ds.pairs, 64, device="cpu", **kw))
    assert len(got) == 8  # 500 pairs: 7 full batches and the remainder
    _assert_batches_equal(got, want)


def test_background_assembler_matches_the_reference(datasets):
    j_ds, t_ds = datasets
    idx = list(tpipe.epoch_batches(t_ds.pairs, 128, seed=2))
    want = drain(jpipe.BackgroundAssembler(j_ds.notice_store, j_ds.company_store, iter(idx), depth=2))
    got = drain(tpipe.BackgroundAssembler(t_ds.notice_store, t_ds.company_store, iter(idx), depth=2))
    _assert_batches_equal(got, want)


def test_background_assembler_reraises_its_worker_exception(datasets):
    j_ds, t_ds = datasets
    good = list(tpipe.epoch_batches(t_ds.pairs, 64, seed=1))[:3]

    def failing_index_batches():
        yield from good
        raise RuntimeError("index source broke")

    seen = []

    def counted():
        for batch in tpipe.BackgroundAssembler(t_ds.notice_store, t_ds.company_store, failing_index_batches()):
            seen.append(batch)
            yield batch

    with pytest.raises(RuntimeError, match="index source broke"):
        drain(counted())
    assert len(seen) == 3  # every batch before the failure, then the error: never a shorter epoch
    with pytest.raises(RuntimeError, match="index source broke"):  # the reference does the same
        drain(jpipe.BackgroundAssembler(j_ds.notice_store, j_ds.company_store, failing_index_batches()))


def test_background_worker_stops_when_the_consumer_stops(datasets):
    _, t_ds = datasets
    assembler = tpipe.BackgroundAssembler(t_ds.notice_store, t_ds.company_store,
                                          tpipe.epoch_batches(t_ds.pairs, 16, seed=1), depth=1)
    it = iter(assembler)
    assert next(it).notice.dense.shape[0] == 16
    it.close()  # what dropping a half-read epoch does
    worker = assembler._worker._thread
    worker.join(DRAIN_TIMEOUT_S)
    assert not worker.is_alive()


def test_background_workers_under_fast_thread_switching(datasets):
    """More workers than cores, the interpreter switching threads every
    microsecond: every worker still yields every batch, in order and bit
    for bit (the queue hand-off and the stop flag are the shared state)."""
    _, t_ds = datasets
    idx = list(tpipe.epoch_batches(t_ds.pairs, 32, seed=4))
    want = [tpipe.assemble_pair_batch(t_ds.notice_store, t_ds.company_store, i) for i in idx]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [tpipe.BackgroundAssembler(t_ds.notice_store, t_ds.company_store, iter(idx), depth=1)
                   for _ in range(2 * (os.cpu_count() or 1))]
        got = drain((b for w in workers for b in w), timeout=2 * DRAIN_TIMEOUT_S)
    finally:
        sys.setswitchinterval(interval)
    assert len(got) == len(workers) * len(idx)
    _assert_batches_equal(got, want * len(workers))


RUN_INFO = {"epochs": 2, "batch_size": 256, "learning_rate": 0.001, "embedding_dim": 128, "num_params": 12345,
            "examples_per_sec": "9876"}
VAL = {"loss": 4.5, "accuracy": 0.25, "recall@5": 0.8, "recall@10": 0.9, "mrr": 0.4, "auc": 0.99,
       "positive_similarity": 0.9, "negative_similarity": 0.2, "similarity_gap": 0.7, "z_gap": 3.3,
       "corpus_recall@10": 0.07, "corpus_recall@100": 0.6, "num_batches": 3.0}


def _rows(path):
    with path.open(newline="") as fh:
        return list(csv.reader(fh))


@pytest.mark.parametrize("legacy_header", [False, True])
def test_append_result_matches_the_reference(tmp_path, legacy_header):
    paths = {side: tmp_path / f"{side}.csv" for side in ("jax", "torch")}
    if legacy_header:  # a file from before z_gap: appends keep its header
        for p in paths.values():
            p.write_text(",".join(f for f in jledger.FIELDS if f != "z_gap") + "\n")
    assert tledger.FIELDS == jledger.FIELDS
    for i in range(2):
        for side, mod in (("jax", jledger), ("torch", tledger)):
            row = mod.append_result(paths[side], run_info=RUN_INFO, val_metrics=VAL, train_loss=4.25 + i,
                                    notes=f"run {i}")
            row.pop("timestamp")
    got, want = _rows(paths["torch"]), _rows(paths["jax"])
    assert got[0] == want[0] and len(got) == len(want) == 3
    ts = got[0].index("timestamp")
    for g, w in zip(got[1:], want[1:]):
        assert g[:ts] + g[ts + 1:] == w[:ts] + w[ts + 1:]
    assert [r["train_loss"] for r in tledger.read_results(paths["torch"])] == ["4.250000", "5.250000"]


def test_metrics_logger_matches_the_reference(tmp_path):
    t_log, j_log = TMetricsLogger(tmp_path / "t.jsonl"), JMetricsLogger(tmp_path / "j.jsonl")
    for step in (8, 16):
        common = {"epoch": step // 8, "train_loss": 4.5 + step, "note": "text", "val_recall@10": np.float32(0.25)}
        t_log.log(step, {**common, "loss": torch.tensor(1.5 * step), "count": torch.tensor(step)}, tag="x")
        j_log.log(step, {**common, "loss": jnp.asarray(1.5 * step), "count": jnp.asarray(step)}, tag="x")
    t_log.close()
    j_log.close()
    got, want = TMetricsLogger.read(tmp_path / "t.jsonl"), JMetricsLogger.read(tmp_path / "j.jsonl")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert isinstance(g.pop("time"), float) and isinstance(w.pop("time"), float)
        assert json.dumps(g) == json.dumps(w)
