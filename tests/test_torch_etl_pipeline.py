"""The port's ETL pipeline (``etl/pipeline.py``) and its feature-store glue
(``etl/to_feature_store.py``) against the JAX package's, on the same raw
tables from a seed: the manifests and fitted-state files equal, each
package reads the other's chunks to equal arrays, ``update_text_embeddings``
rewrites the same rows the same way, the in-memory ETL (the card's path,
no pyarrow) equals what the parquet path reads back, and the feature
stores built from either have equal keys and arrays."""

import json

import numpy as np
import pytest

from jodalrob_twotower_torch.etl import pipeline as tpipe
from jodalrob_twotower_torch.etl import to_feature_store as tfs
from jodalrob_twotower_torch.etl.text import HashTextEmbedder as THash
from jodalrob_twotower_tpu.etl import pipeline as jpipe
from jodalrob_twotower_tpu.etl import to_feature_store as jfs
from jodalrob_twotower_tpu.etl.text import HashTextEmbedder as JHash

N_ROWS = 230
CHUNK_ROWS = 80  # chunks of 80, 80, 70


def raw_table(seed: int, n: int = N_ROWS) -> dict:
    rng = np.random.default_rng(seed)
    price = rng.lognormal(4.0, 1.0, n)
    price[::13] = np.nan
    score = rng.normal(0.0, 3.0, n)
    region = rng.choice(["seoul", "busan", "daegu", "jeju", " Seoul "], n).astype(object)
    region[::11] = None
    kind = np.asarray([f"k{v}" for v in rng.zipf(1.5, n) % 25], object)
    title = np.asarray([f"공고 work {c} item {w}" for c, w in zip(rng.integers(0, 8, n), rng.integers(0, 30, n))],
                       object)
    title[::9] = None
    return {"bidntceno": np.asarray([f"N{i:05d}" for i in range(n)], object),
            "bidntceord": np.asarray([f"{i % 3:03d}" for i in range(n)], object),
            "price": price, "score": score, "region": region, "kind": kind, "title": title}


def chunks(table: dict, rows: int = CHUNK_ROWS) -> list:
    n = len(table["bidntceno"])
    return [{k: v[lo : lo + rows] for k, v in table.items()} for lo in range(0, n, rows)]


def pipeline_kw(embedder_cls, text: bool = True) -> dict:
    return dict(
        pk_columns=["bidntceno", "bidntceord"],
        numeric_columns=["price", "score"],
        categorical_columns=["region", "kind"],
        text_columns=["title"] if text else None,
        numeric_configs={"price": {"fill": "median", "log1p": True, "clip_percentiles": (1, 99)},
                         "score": {"fill": "mean", "scale": "minmax", "null_flag": False}},
        categorical_configs={"kind": {"rare_threshold": 2}, "region": {"lowercase": True}},
        text_configs={"title": {"add_flag": True, "max_length": 3}},
        text_embedder=embedder_cls(24),
    )


def assert_columns_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.fixture(params=[True, False], ids=["with_text", "no_text"])
def both_runs(request, tmp_path):
    table = raw_table(1)
    out = {}
    for name, pipe, emb in (("torch", tpipe, THash), ("jax", jpipe, JHash)):
        out[name] = tmp_path / name
        # the port fits on the concatenated chunks, the reference on a given fit table
        fit = {} if name == "torch" else {"fit_table": table}
        manifest = pipe.run_pipeline("notice", chunks(table), out[name], **fit, **pipeline_kw(emb, request.param))
        assert manifest == json.loads((out[name] / "notice_manifest.json").read_text())
    return table, out, request.param


def test_run_pipeline_files_match_the_reference(both_runs):
    _, out, _ = both_runs
    for f in ("notice_manifest.json", "notice_numeric.json", "notice_categorical.json"):
        assert json.loads((out["torch"] / f).read_text()) == json.loads((out["jax"] / f).read_text()), f
    manifest = json.loads((out["torch"] / "notice_manifest.json").read_text())
    assert manifest["chunks"] == [f"notice_chunk_{i:04d}.parquet" for i in range(3)] and manifest["rows"] == N_ROWS


def test_each_package_reads_the_others_chunks(both_runs):
    _, out, _ = both_runs
    want = jpipe.load_preprocessed(out["jax"], "notice")
    assert_columns_equal(tpipe.load_preprocessed(out["jax"], "notice"), want)
    assert_columns_equal(jpipe.load_preprocessed(out["torch"], "notice"), want)
    assert_columns_equal(tpipe.load_preprocessed(out["torch"], "notice"), want)
    streamed = list(tpipe.iter_preprocessed_chunks(out["torch"], "notice"))
    assert [len(c["bidntceno"]) for c in streamed] == [80, 80, 70]


def test_in_memory_etl_equals_the_files(both_runs):
    table, out, text = both_runs
    manifest, columns = tpipe.preprocess_in_memory("notice", chunks(table), **pipeline_kw(THash, text))
    assert manifest == json.loads((out["jax"] / "notice_manifest.json").read_text())
    assert_columns_equal(columns, jpipe.load_preprocessed(out["jax"], "notice"))
    # the shared assembly gives the parquet path's store
    side = tfs.side_schema_from_manifest_dict(manifest)
    store = tfs.feature_store_from_columns(side, columns)
    _, from_files = tfs.feature_store_from_pipeline(out["torch"], "notice")
    np.testing.assert_array_equal(store.keys, from_files.keys)
    np.testing.assert_array_equal(store.dense, from_files.dense)
    np.testing.assert_array_equal(store.cat_ids, from_files.cat_ids)


def test_feature_store_from_pipeline_matches_the_reference(both_runs):
    _, out, _ = both_runs
    t_schema, t_store = tfs.feature_store_from_pipeline(out["jax"], "notice")
    j_schema, j_store = jfs.feature_store_from_pipeline(out["jax"], "notice")
    assert t_schema.to_dict() == j_schema.to_dict()
    assert tfs.side_schema_from_manifest(out["torch"], "notice").to_dict() == j_schema.to_dict()
    np.testing.assert_array_equal(t_store.keys, j_store.keys)
    assert t_store.keys[0] == "N00000|000"  # composite PKs joined with '|'
    np.testing.assert_array_equal(t_store.dense, j_store.dense)
    np.testing.assert_array_equal(t_store.cat_ids, j_store.cat_ids)


def test_update_text_embeddings_matches_the_reference(both_runs):
    _, out, text = both_runs
    updates = {"N00003|000": "완전히 new words", "N00100|001": "", "N00229|001": "other"}
    if not text:
        for pipe, emb in ((tpipe, THash), (jpipe, JHash)):
            with pytest.raises(KeyError, match="not a text column"):
                pipe.update_text_embeddings(out["torch"], "notice", "title", updates, embedder=emb(24))
        return
    before = tpipe.load_preprocessed(out["torch"], "notice")
    cfg = {"add_flag": True, "max_length": 3}
    n_t = tpipe.update_text_embeddings(out["torch"], "notice", "title", updates, embedder=THash(24), text_config=cfg)
    n_j = jpipe.update_text_embeddings(out["jax"], "notice", "title", updates, embedder=JHash(24), text_config=cfg)
    assert n_t == n_j == 3
    after = tpipe.load_preprocessed(out["torch"], "notice")
    assert_columns_equal(after, jpipe.load_preprocessed(out["jax"], "notice"))
    assert not np.array_equal(after["title"][3], before["title"][3])
    np.testing.assert_array_equal(after["title"][4], before["title"][4])
    assert after["title_is_null"][100] == 1.0


def test_run_pipeline_materializes_only_without_a_fit_table(tmp_path):
    table = raw_table(2)
    consumed = []

    def lazy():
        for c in chunks(table):
            consumed.append(len(consumed))
            yield c

    kw = pipeline_kw(THash)
    gen = lazy()
    tpipe.run_pipeline("notice", gen, tmp_path / "a", fit_table=table, **kw)
    assert consumed == [0, 1, 2]
    want = jpipe.run_pipeline("notice", chunks(table), tmp_path / "b", fit_table=table, **pipeline_kw(JHash))
    assert json.loads((tmp_path / "a" / "notice_manifest.json").read_text()) == want
