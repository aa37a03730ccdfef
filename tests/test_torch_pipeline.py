"""The port's copies of the trainer's host-side helpers against the JAX
package's: ``epoch_batches`` (the same index batches for the same seed),
``assemble_pair_batch`` (bit for bit), the results ledger (the same rows
apart from the timestamp, the same rule for a pre-existing header) and
``MetricsLogger`` (the same JSON lines apart from the elapsed time, tensors
written as floats as the reference writes its arrays)."""

import csv
import json

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


def test_assemble_pair_batch_is_bit_equal():
    kw = dict(n_notices=300, n_companies=200, n_pairs=500, n_clusters=8, seed=5)
    j_ds = j_make_dataset(j_tiny_schema(n_categorical=3, vocab_size=40, n_numeric=6), **kw)
    t_ds = t_make_dataset(t_tiny_schema(n_categorical=3, vocab_size=40, n_numeric=6), **kw)
    for idx in list(tpipe.epoch_batches(t_ds.pairs, 128, seed=2))[:3]:
        got = tpipe.assemble_pair_batch(t_ds.notice_store, t_ds.company_store, idx)
        want = jpipe.assemble_pair_batch(j_ds.notice_store, j_ds.company_store, idx)
        for g, w in ((got.notice, want.notice), (got.company, want.company)):
            assert g.dense.dtype == np.asarray(w.dense).dtype and g.cat_ids.dtype == np.asarray(w.cat_ids).dtype
            np.testing.assert_array_equal(g.dense, np.asarray(w.dense))
            np.testing.assert_array_equal(g.cat_ids, np.asarray(w.cat_ids))


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
