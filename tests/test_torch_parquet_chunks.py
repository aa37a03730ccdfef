"""The cases of tests/test_parquet_chunks.py on both packages' chunked
parquet conversion (``etl/parquet_chunks.py``), and across them: each
package reads the other's datasets to equal arrays, and the manifests agree
(but for their creation time)."""

import numpy as np
import pytest

from jodalrob_twotower_torch.etl import parquet_chunks as tpc
from jodalrob_twotower_tpu.etl import parquet_chunks as jpc


@pytest.fixture(params=[tpc, jpc], ids=["torch", "jax"])
def pc(request):
    return request.param


def _chunks(n_chunks=3, rows=10, seed=0):
    rng = np.random.default_rng(seed)
    for i in range(n_chunks):
        yield {
            "pk": np.arange(i * rows, (i + 1) * rows, dtype=np.int64),
            "x": rng.normal(size=rows).astype(np.float32),
            "name": np.asarray([f"row{i}_{j}" for j in range(rows)], dtype=object),
            "emb": rng.normal(size=(rows, 4)).astype(np.float32),
        }


def test_roundtrip_one_file_per_chunk(pc, tmp_path):
    manifest = pc.write_parquet_chunks(_chunks(), tmp_path / "t", table_name="t")
    assert manifest["n_rows"] == 30 and manifest["n_files"] == 3
    assert manifest["columns"] == ["pk", "x", "name", "emb"]
    assert pc.read_manifest(tmp_path / "t") == manifest
    data = pc.load_parquet_chunks(tmp_path / "t")
    np.testing.assert_array_equal(data["pk"], np.arange(30))
    assert data["emb"].shape == (30, 4)
    assert data["name"][0] == "row0_0" and data["name"][-1] == "row2_9"
    ref = {k: np.concatenate([c[k] for c in _chunks()], axis=0) for k in data}
    np.testing.assert_array_equal(data["x"], ref["x"])
    np.testing.assert_array_equal(data["emb"], ref["emb"])


def test_rebatching_rows_per_file(pc, tmp_path):
    manifest = pc.write_parquet_chunks(_chunks(), tmp_path / "t", table_name="t", rows_per_file=12)
    assert [f["rows"] for f in manifest["files"]] == [12, 12, 6]
    assert [f["file"] for f in manifest["files"]] == [
        "chunk_0000.parquet", "chunk_0001.parquet", "chunk_0002.parquet",
    ]
    assert [len(c["pk"]) for c in pc.iter_parquet_chunks(tmp_path / "t")] == [12, 12, 6]
    np.testing.assert_array_equal(pc.load_parquet_chunks(tmp_path / "t")["pk"], np.arange(30))


def test_column_projection(pc, tmp_path):
    pc.write_parquet_chunks(_chunks(), tmp_path / "t", table_name="t")
    assert set(pc.load_parquet_chunks(tmp_path / "t", columns=["pk", "emb"])) == {"pk", "emb"}


def test_parallel_multi_table(pc, tmp_path):
    manifests = pc.convert_tables_parallel(
        {"notice": lambda: _chunks(2, 8, seed=1), "company": lambda: _chunks(4, 5, seed=2)},
        tmp_path, rows_per_file=10, max_workers=2,
    )
    assert manifests["notice"]["n_rows"] == 16 and manifests["company"]["n_rows"] == 20
    for table in ("notice", "company"):
        assert len(pc.load_parquet_chunks(tmp_path / table)["pk"]) == manifests[table]["n_rows"]
        assert pc.read_manifest(tmp_path / table)["table"] == table


def test_empty_stream(pc, tmp_path):
    manifest = pc.write_parquet_chunks(iter(()), tmp_path / "t", table_name="t")
    assert manifest["n_rows"] == 0 and manifest["n_files"] == 0
    assert pc.load_parquet_chunks(tmp_path / "t") == {}


def test_schema_drift_is_unified(pc, tmp_path):
    def chunks():
        yield {"pk": np.arange(4, dtype=np.int64), "x": np.asarray([1.0, 2.0, None, 4.0], dtype=object)}
        yield {"pk": np.arange(4, 8, dtype=np.int64), "x": np.asarray([None] * 4, dtype=object)}
        yield {"pk": np.arange(8, 12, dtype=np.int64), "x": np.asarray([1, 2, 3, 4], dtype=object)}

    manifest = pc.write_parquet_chunks(chunks(), tmp_path / "t", table_name="t", rows_per_file=100)
    assert manifest["n_rows"] == 12 and manifest["n_files"] == 1
    data = pc.load_parquet_chunks(tmp_path / "t")
    assert data["x"][1] == 2.0 and np.isnan(data["x"][4]) and data["x"][8] == 1.0


def test_incompatible_schema_drift_raises(pc, tmp_path):
    def chunks():
        yield {"x": np.asarray([1.0, 2.0], dtype=np.float32)}
        yield {"x": np.asarray([["a", "b"], ["c", "d"]], dtype=object)}

    with pytest.raises(ValueError, match="schema drifted"):
        pc.write_parquet_chunks(chunks(), tmp_path / "t", table_name="t", rows_per_file=100)


def test_rows_per_file_must_be_positive(pc, tmp_path):
    with pytest.raises(ValueError, match="rows_per_file"):
        pc.write_parquet_chunks(_chunks(), tmp_path / "t", table_name="t", rows_per_file=0)


@pytest.mark.parametrize("rows_per_file", [None, 7])
def test_each_package_reads_the_others_dataset(tmp_path, rows_per_file):
    manifests = {name: pkg.write_parquet_chunks(_chunks(4, 9, seed=3), tmp_path / name, table_name="t",
                                                rows_per_file=rows_per_file)
                 for name, pkg in (("torch", tpc), ("jax", jpc))}
    strip = lambda m: {k: v for k, v in m.items() if k != "created_unix"}  # noqa: E731
    assert strip(manifests["torch"]) == strip(manifests["jax"])
    want = jpc.load_parquet_chunks(tmp_path / "jax")
    for reader, where in ((tpc, "jax"), (jpc, "torch"), (tpc, "torch")):
        got = reader.load_parquet_chunks(tmp_path / where)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
