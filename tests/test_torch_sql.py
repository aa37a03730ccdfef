"""The port's SQL shim (``etl/sql.py``) and PostgreSQL write-back
(``etl/pg_writeback.py``) against the JAX package's: the query builders
give equal strings, the connector is gated alike without sqlalchemy, and
over the recording fake connection of tests/test_pg_writeback.py both
packages execute the same statements with the same COPY payloads and
commits."""

import numpy as np
import pytest

from jodalrob_twotower_torch.etl import pg_writeback as tpg
from jodalrob_twotower_torch.etl import sql as tsql
from jodalrob_twotower_torch.etl.pipeline import iter_preprocessed_chunks, run_pipeline
from jodalrob_twotower_torch.etl.text import HashTextEmbedder
from jodalrob_twotower_tpu.etl import pg_writeback as jpg
from jodalrob_twotower_tpu.etl import sql as jsql
from test_pg_writeback import FakeConn

BUILDS = [
    ("build_select", ("notice", ["bidntceno", "presmptprce"]), {"limit": 100, "offset": 50}),
    ("build_select", ("company", []), {"where": "bizno = '123'", "order_by": ["bizno"]}),
    ("build_pk_lookup", ("company", ("bizno",), 3), {}),
    ("build_pk_lookup", ("notice", ("bidntceno", "bidntceord"), 2), {}),
    ("build_bid_participants", (), {"company_columns": ["bizno", "prcbdramt"]}),
    ("build_bid_participants", (), {}),
    ("build_company_bid_history", (), {"limit": 25}),
    ("build_company_bid_history", (), {"notice_columns": ("a", "b_c"), "order_by": "a"}),
    ("build_pgvector_ddl", ("public", "notice", "bidntcenm_emb", 768), {}),
    ("build_vector_update", ("public", "notice", ["bidntceno", "bidntceord"], "bidntcenm_emb", 768), {}),
    ("build_vector_update", ("s", "t", ["pk"], "v", 3), {"temp_table": "tmp_other"}),
]


@pytest.mark.parametrize("name, args, kw", BUILDS, ids=[f"{b[0]}_{i}" for i, b in enumerate(BUILDS)])
def test_query_builders_match_the_reference(name, args, kw):
    assert getattr(tsql, name)(*args, **kw) == getattr(jsql, name)(*args, **kw)


@pytest.mark.parametrize("call", [
    lambda m: m.build_select("notice; DROP TABLE x", ["a"]),
    lambda m: m.build_select("notice", ["a", "b; --"]),
    lambda m: m.build_company_bid_history(order_by="rgstdt; DROP"),
    lambda m: m.build_vector_update("public", "x; DROP", ["a"], "v", 3),
])
def test_unsafe_identifiers_raise_like_the_reference(call):
    for m in (tsql, jsql):
        with pytest.raises(ValueError, match="unsafe"):
            call(m)


@pytest.mark.parametrize("env", [
    {"DB_HOST": "h", "DB_PORT": "5433", "DB_NAME": "d", "DB_USER": "u", "DB_PASSWORD": "p"},
    {}, {"DB_USER": "a@b", "DB_PASSWORD": "p:w/#%"},
])
def test_connection_url_matches_the_reference(env):
    assert tsql.connection_url(env) == jsql.connection_url(env)
    assert tsql.DEFAULT_PK == jsql.DEFAULT_PK


def test_connector_is_gated_like_the_reference():
    try:
        import sqlalchemy  # noqa: F401
    except ImportError:
        pass
    else:
        pytest.skip("sqlalchemy installed; the gate cannot be triggered")
    messages = []
    for m in (tsql, jsql):
        with pytest.raises(ImportError, match="parquet data plane") as err:
            m.DatabaseConnector("postgresql://x")
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_writeback_helpers_match_the_reference():
    for values in (np.asarray([1, 2, 3]), np.asarray([1.5, 2.0]), np.asarray([True, False]),
                   np.asarray(["a", "b"], object), np.asarray([1, None, 3], object),
                   np.asarray([1, 2.5], object), np.asarray([None, None], object)):
        assert tpg.infer_pg_type(values) == jpg.infer_pg_type(values)
    cols = ["pk", "x", "title_emb000", "title_emb001", "t_emb0000", "t_emb0001"]
    assert tpg.collapse_embedding_columns(cols) == jpg.collapse_embedding_columns(cols)
    for m in (tpg, jpg):
        with pytest.raises(ValueError, match="non-contiguous"):
            m.collapse_embedding_columns(["t_emb000", "t_emb002"])
    v = np.asarray([0.1, -2.5e-7, 3.0, float("nan")], np.float32)
    assert tpg.vector_literal(v) == jpg.vector_literal(v)
    for x in (np.float32("nan"), float("nan"), np.float32(1.5), None, True, 'a "q", b', "x\ny", 7):
        assert tpg._csv_field(x) == jpg._csv_field(x)
    kw = dict(column_types={"bidntceno": "bigint", "v": "double precision"}, vector_dims={"title": 768})
    for replace, pk in ((True, ()), (False, ("bidntceno",))):
        assert tpg.build_create_preprocessed("public", "t", **kw, replace=replace, pk_cols=pk) == \
            jpg.build_create_preprocessed("public", "t", **kw, replace=replace, pk_cols=pk)


def chunks(seed: int):
    rng = np.random.default_rng(seed)
    yield {
        "pk": np.asarray(["a", "b,c", None, 'q"uote'], object),
        "score": np.asarray([1.0, float("nan"), 3.5, -0.25]),
        "n": np.asarray([1, 2, 3, 4]),
        "ok": np.asarray([True, False, True, True]),
        "title_emb000": np.asarray([0.1, float("nan"), 0.3, 0.4], np.float32),
        "title_emb001": rng.normal(size=4).astype(np.float32),
        "body": rng.normal(size=(4, 3)).astype(np.float32),
    }
    yield {
        "pk": np.asarray(["d", "e"], object),
        "score": np.asarray([2.0, 3.0]),
        "n": np.asarray([5, 6]),
        "ok": np.asarray([False, False]),
        "title_emb000": np.asarray([1.0, float("inf")], np.float32),
        "title_emb001": np.asarray([2.0, 3.0], np.float32),
        "body": rng.normal(size=(2, 3)).astype(np.float32),
    }


@pytest.mark.parametrize("kw", [{}, {"schema": "s", "replace": False}, {"pk_cols": ["pk", "n"]}])
def test_uploader_statements_and_copies_match_the_reference(kw):
    logs = []
    for m in (tpg, jpg):
        conn = FakeConn()
        up = m.PreprocessedUploader(conn, **kw)
        counts = [up.upload_chunk("notice_preprocessed", c) for c in chunks(3)]
        up.commit()
        logs.append((conn.log, conn.commits, counts))
    assert logs[0] == logs[1]
    assert logs[0][2] == [4, 2] and logs[0][1] == 1


def test_uploader_rejects_a_missing_pk_like_the_reference():
    chunk = {"bidntceno": np.asarray(["1"], object), "v": np.asarray([1.0])}
    for m in (tpg, jpg):
        with pytest.raises(ValueError, match="bidNtceNo"):
            m.PreprocessedUploader(FakeConn(), pk_cols=["bidNtceNo"]).upload_chunk("t", chunk)


@pytest.mark.parametrize("ensure_column", [True, False])
def test_vector_update_matches_the_reference(ensure_column):
    rows = [("n1", "01", [0.5, 0.25]), ("n2", "01", np.asarray([1.0, 2.0], np.float32)),
            ("n,3", "02", [float("nan"), 1.0])]
    logs = []
    for m in (tpg, jpg):
        conn = FakeConn()
        n = m.execute_vector_update(conn, schema="public", table="notice", pk_cols=("bidntceno", "bidntceord"),
                                    vec_col="bidntcenm_vec", rows=iter(rows), dims=2, ensure_column=ensure_column)
        logs.append((n, conn.log, conn.commits))
    assert logs[0] == logs[1]
    assert logs[0][0] == 3 and logs[0][1][-1] == ("commit",)


def test_pipeline_chunks_upload_like_the_reference(tmp_path):
    rng = np.random.default_rng(0)
    n = 10
    table = {
        "pk": np.asarray([f"k{i}" for i in range(n)], object),
        "amount": rng.normal(size=n),
        "cat": np.asarray([f"c{i % 3}" for i in range(n)], object),
        "title": np.asarray([f"text number {i}" for i in range(n)], object),
    }
    run_pipeline("notice", [table], tmp_path, pk_columns=["pk"], numeric_columns=["amount"],
                 categorical_columns=["cat"], text_columns=["title"], fit_table=table,
                 text_embedder=HashTextEmbedder(embed_dim=4))
    logs = []
    for m in (tpg, jpg):
        conn = FakeConn()
        up = m.PreprocessedUploader(conn, pk_cols=["pk"])
        total = sum(up.upload_chunk("notice_preprocessed", c) for c in iter_preprocessed_chunks(tmp_path, "notice"))
        up.commit()
        logs.append((total, conn.log))
    assert logs[0] == logs[1] and logs[0][0] == n
