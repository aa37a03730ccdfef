"""The port's parquet data plane against the JAX package's, on the CPU: a
dataset directory written by either package's ``save_dataset`` reads back
through the other's (schema, stores, pairs equal); ``load_pairs_parquet``
with missing keys drops the same rows or raises ``KeyError`` in both;
``stream_pair_chunks`` yields the same chunks, chunk for chunk, for host
counts 1-3 over two files, every host the same row count; and
``streaming_index_batches`` gives the same batches for a shuffle seed
(values: the port's are int64, the reference's int32), re-raising a reader
exception. Without pyarrow the readers raise ``ImportError`` naming it.
Every iteration over a reader thread runs with a bounded wait."""

import sys

import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.data import parquet_dataset as tpd
from jodalrob_twotower_torch.data import parquet_stream as tps
from jodalrob_twotower_torch.data.feature_store import FeatureStore as TFeatureStore
from jodalrob_twotower_torch.schema import TwoTowerSchema as TSchema
from jodalrob_twotower_tpu.data import parquet_dataset as jpd
from jodalrob_twotower_tpu.data import parquet_stream as jps
from jodalrob_twotower_tpu.data.feature_store import FeatureStore as JFeatureStore
from jodalrob_twotower_tpu.schema import TwoTowerSchema as JSchema

from torch_parity import drain, schemas, side_inputs

N_ROWS = {"notice": 240, "company": 180}
CHUNK_ROWS = 700


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Several test workers share the cores: do not oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    """Both packages' stores over the same arrays (a text block, composite
    keys), and 2,000 pairs."""
    j_schema, t_schema = schemas()
    rng = np.random.default_rng(23)
    arrays = {s: side_inputs(j_schema.side(s), rng, N_ROWS[s]) for s in N_ROWS}
    keys = {"notice": np.asarray([f"n{i}|{i % 3}" for i in range(N_ROWS["notice"])]),
            "company": np.asarray([f"c{i:04d}" for i in range(N_ROWS["company"])])}
    j = {s: JFeatureStore(j_schema.side(s), *arrays[s], keys[s]) for s in N_ROWS}
    t = {s: TFeatureStore(t_schema.side(s), *arrays[s], keys[s]) for s in N_ROWS}
    pairs = np.stack([rng.integers(0, N_ROWS["notice"], 2000), rng.integers(0, N_ROWS["company"], 2000)], 1)
    return dict(j_schema=j_schema, t_schema=t_schema, j=j, t=t, keys=keys, pairs=pairs.astype(np.int64))


def _assert_stores_equal(got, want):
    np.testing.assert_array_equal(got.dense, want.dense)
    np.testing.assert_array_equal(got.cat_ids, want.cat_ids)
    assert got.dense.dtype == want.dense.dtype and got.cat_ids.dtype == want.cat_ids.dtype
    assert got.keys.tolist() == want.keys.tolist()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_dataset_written_by_one_package_reads_in_the_other(data, tmp_path, writer):
    side = "j" if writer == "jax" else "t"
    save = jpd.save_dataset if writer == "jax" else tpd.save_dataset
    save(tmp_path, data[f"{side}_schema"], data[side]["notice"], data[side]["company"], data["pairs"])

    t_schema, t_notice, t_company, t_pairs = tpd.load_dataset(tmp_path)
    j_schema = JSchema.from_json(tmp_path / "schema.json")
    j_notice = JFeatureStore.from_parquet(j_schema.notice, tmp_path / "notice.parquet")
    j_company = JFeatureStore.from_parquet(j_schema.company, tmp_path / "company.parquet")
    j_pairs = jpd.load_pairs_parquet(tmp_path / "pairs.parquet", j_notice, j_company)

    assert t_schema.to_dict() == j_schema.to_dict() == data["j_schema"].to_dict()
    assert isinstance(t_schema, TSchema)
    for got, want in ((t_notice, data["t"]["notice"]), (t_company, data["t"]["company"]),
                      (t_notice, j_notice), (t_company, j_company)):
        _assert_stores_equal(got, want)
    assert t_pairs.dtype == j_pairs.dtype == np.int64
    np.testing.assert_array_equal(t_pairs, data["pairs"])
    np.testing.assert_array_equal(j_pairs, data["pairs"])


def _pairs_with_missing_keys(data, tmp_path, writer_mod):
    nk = data["keys"]["notice"][data["pairs"][:300, 0]].copy()
    ck = data["keys"]["company"][data["pairs"][:300, 1]].copy()
    nk[[5, 77]] = "no-such-notice"
    ck[[5, 140, 299]] = "no-such-company"
    path = tmp_path / "pairs.parquet"
    writer_mod.save_pairs_parquet(path, nk, ck)
    return path


@pytest.mark.parametrize("writer", [jpd, tpd], ids=["jax_writes", "torch_writes"])
def test_missing_keys_drop_or_raise_like_the_reference(data, tmp_path, writer):
    path = _pairs_with_missing_keys(data, tmp_path, writer)
    got = tpd.load_pairs_parquet(path, data["t"]["notice"], data["t"]["company"])
    want = jpd.load_pairs_parquet(path, data["j"]["notice"], data["j"]["company"])
    keep = np.setdiff1d(np.arange(300), [5, 77, 140, 299])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data["pairs"][keep])
    for mod, side in ((jpd, "j"), (tpd, "t")):
        with pytest.raises(KeyError, match="missing key"):
            mod.load_pairs_parquet(path, data[side]["notice"], data[side]["company"], on_missing="error")


@pytest.fixture(scope="module")
def pair_files(data, tmp_path_factory):
    """Two pair files, 1,500 and 1,100 rows, with a few missing keys."""
    d = tmp_path_factory.mktemp("pair_files")
    keys, pairs = data["keys"], data["pairs"]
    rng = np.random.default_rng(5)
    paths = []
    for i, (lo, n) in enumerate(((0, 1500), (500, 1100))):
        nk = keys["notice"][pairs[lo:lo + n, 0]].copy()
        ck = keys["company"][pairs[lo:lo + n, 1]].copy()
        nk[rng.choice(n, 7, replace=False)] = "gone"
        paths.append(d / f"pairs_{i}.parquet")
        tpd.save_pairs_parquet(paths[-1], nk, ck)
    return paths


@pytest.mark.parametrize("host_count", [1, 2, 3])
def test_stream_pair_chunks_match_the_reference(data, pair_files, host_count):
    per_host = []
    for host in range(host_count):
        kw = dict(chunk_rows=CHUNK_ROWS, host_index=host, host_count=host_count)
        got = list(tps.stream_pair_chunks(pair_files, data["t"]["notice"], data["t"]["company"], **kw))
        want = list(jps.stream_pair_chunks(pair_files, data["j"]["notice"], data["j"]["company"], **kw))
        assert len(got) == len(want) == 5  # 700 + 700 + 100 and 700 + 400 rows read
        for g, w in zip(got, want):
            assert g.dtype == np.int64
            np.testing.assert_array_equal(g, w)
        per_host.append([len(c) for c in got])
    assert all(counts == per_host[0] for counts in per_host)  # lockstep: the same rows on every host


def test_stream_pair_chunks_missing_key_raises_like_the_reference(data, pair_files):
    for mod, side in ((jps, "j"), (tps, "t")):
        with pytest.raises(KeyError, match="missing key"):
            list(mod.stream_pair_chunks(pair_files, data[side]["notice"], data[side]["company"],
                                        chunk_rows=CHUNK_ROWS, on_missing="error"))


@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("seed", [0, 7])
def test_streaming_index_batches_match_the_reference(data, pair_files, drop_remainder, seed):
    chunks = list(tps.stream_pair_chunks(pair_files, data["t"]["notice"], data["t"]["company"],
                                         chunk_rows=CHUNK_ROWS))
    kw = dict(seed=seed, drop_remainder=drop_remainder)
    got = drain(tps.streaming_index_batches(iter(chunks), 64, **kw))
    want = drain(jps.streaming_index_batches(iter(chunks), 64, **kw))
    n_rows = sum(len(c) for c in chunks)
    assert len(got) == len(want) == n_rows // 64 + (0 if drop_remainder else int(n_rows % 64 > 0))
    for g, w in zip(got, want):
        assert g.dtype == np.int64 and w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    if not drop_remainder:
        np.testing.assert_array_equal(np.sort(np.concatenate(got), axis=0), np.sort(np.concatenate(chunks), axis=0))


def test_streaming_reader_exception_is_reraised(data):
    chunk = data["pairs"][:300]

    def broken():
        yield chunk
        raise OSError("pair file truncated")

    for mod in (jps, tps):
        seen = []

        def counted(batches):
            for b in batches:
                seen.append(b)
                yield b

        with pytest.raises(OSError, match="truncated"):
            drain(counted(mod.streaming_index_batches(broken(), 64)))
        assert len(seen) == 4  # the first chunk's batches, then the error


def test_parquet_readers_without_pyarrow_raise_import_error(data, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(ImportError, match="pyarrow"):
        tpd.load_pairs_parquet(tmp_path / "pairs.parquet", data["t"]["notice"], data["t"]["company"])
    with pytest.raises(ImportError, match="pyarrow"):
        next(tps.stream_pair_chunks(tmp_path / "pairs.parquet", data["t"]["notice"], data["t"]["company"]))
    with pytest.raises(ImportError, match="pyarrow"):
        tpd.save_dataset(tmp_path, data["t_schema"], data["t"]["notice"], data["t"]["company"], data["pairs"])
