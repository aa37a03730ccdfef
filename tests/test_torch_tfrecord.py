"""The port's TFRecord IO (``io/tfrecord.py``) and its CRC32C
(``io/crc32c.py``: ``csrc/crc32c.cpp`` built with g++, the pure-Python
plain version beside it) against the JAX package's: the same features and
tables give byte-identical uncompressed files and gzip files equal after
decompression; each package reads, counts, searches and inspects the
other's files alike; TensorFlow parses the port's records; corruption is
detected; the native CRC equals the Python CRC and the JAX package's."""

import gzip

import numpy as np
import pytest

from jodalrob_twotower_torch.io import crc32c as tcrc
from jodalrob_twotower_torch.io import tfrecord as ttf
from jodalrob_twotower_torch.ops import _build
from jodalrob_twotower_tpu import native
from jodalrob_twotower_tpu.io import tfrecord as jtf

EXAMPLES = [
    {"name": b"notice-42", "price": [1.5, -2.25, 0.0], "region": [3, -7, 1 << 40], "title": "hello world"},
    {"f32": np.float32(1.75), "f64": np.float64(-2.5), "i32": np.int32(-7), "i64": np.int64(1 << 40),
     "f_list": [np.float32(0.5), np.float32(2.25)], "b": np.bool_(True), "flag": True},
    {"scalar_f": 0.1, "scalar_i": 0, "neg": -1, "big": (1 << 63) - 1, "empty": [], "s": "공고 용역",
     "arr_f": np.linspace(-1, 1, 7, dtype=np.float32), "arr_i": np.arange(-3, 300, 7, dtype=np.int32),
     "bytes_list": [b"a", b"", b"ccc"], "str_list": ["x", "yz"], "zero_d": np.asarray(2.5)},
]


def table(seed: int, n: int = 40) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "bizno": np.asarray([f"{i:010d}" for i in range(n)]).astype(str),
        "num_0_is_null": (rng.random(n) < 0.1).astype(np.float32),
        "num_0": rng.normal(size=n).astype(np.float32),
        "f64": rng.normal(size=n),
        "cat_0": rng.integers(0, 1003, n).astype(np.int32),
        "i64": rng.integers(-(1 << 40), 1 << 40, n),
        "flag": rng.random(n) < 0.5,
        "title": rng.normal(size=(n, 12)).astype(np.float32),
        "ids": rng.integers(0, 500, (n, 3)).astype(np.int64),
        "obj": np.asarray([f"o{i}" if i % 3 else b"raw" for i in range(n)], object),
    }


@pytest.mark.parametrize("i", range(len(EXAMPLES)))
def test_examples_encode_to_the_references_bytes(i):
    data = ttf.encode_example(EXAMPLES[i])
    assert data == jtf.encode_example(EXAMPLES[i])
    assert ttf.decode_example(data) == jtf.decode_example(data)


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "gzip"])
def test_tables_write_the_references_files(tmp_path, compress):
    cols = table(1)
    paths = {name: tmp_path / f"{name}.tfrecord" for name in ("torch", "jax")}
    assert ttf.table_to_tfrecord(paths["torch"], cols, compress=compress) == 40
    assert jtf.table_to_tfrecord(paths["jax"], cols, compress=compress) == 40
    read = (lambda p: gzip.open(p).read()) if compress else (lambda p: p.read_bytes())
    assert read(paths["torch"]) == read(paths["jax"])
    # each package reads, counts, searches and inspects the other's file
    for reader in (ttf, jtf):
        for path in paths.values():
            assert [ex for ex in reader.TFRecordReader(path).examples()] == list(
                jtf.TFRecordReader(paths["jax"]).examples())
            assert reader.count_records(path) == 40
            assert reader.search_records(path, "bizno", b"0000000017") == jtf.search_records(
                paths["jax"], "bizno", b"0000000017")
            assert reader.inspect_tfrecord(path, limit=3)["preview"] == jtf.inspect_tfrecord(
                paths["jax"], limit=3)["preview"]


def test_count_and_search_match_the_reference(tmp_path):
    for fname, n in (("a.tfrecord", 7), ("b.tfrecord", 4)):
        cols = {"id": np.asarray([f"k{i}" for i in range(n)]), "val": np.arange(n).astype(np.int64)}
        ttf.table_to_tfrecord(tmp_path / fname, cols, compress=False)
    for pkg in (ttf, jtf):
        assert pkg.count_records(tmp_path / "a.tfrecord") == 7
        assert pkg.count_records(str(tmp_path / "*.tfrecord")) == 11
        assert pkg.count_records([tmp_path / "a.tfrecord", tmp_path / "b.tfrecord"]) == 11
        assert pkg.search_records(tmp_path / "a.tfrecord", "val", 3)[0]["id"] == [b"k3"]
        assert pkg.search_records(tmp_path / "a.tfrecord", "id", b"k5")[0]["val"] == [5]
        assert pkg.search_records(tmp_path / "a.tfrecord", "val", 99) == []
        assert len(pkg.search_records(tmp_path / "a.tfrecord", "val", [0],
                                      max_results=1)) == 1


@pytest.mark.parametrize("offset", [0, 9, 14], ids=["length", "length_crc", "payload"])
def test_corruption_is_detected(tmp_path, offset):
    path = tmp_path / "x.tfrecord"
    with ttf.TFRecordWriter(path) as w:
        w.write(b"hello records")
    raw = bytearray(path.read_bytes())
    raw[offset] ^= 0xFF
    path.write_bytes(bytes(raw))
    for pkg in (ttf, jtf):
        with pytest.raises(IOError, match="corrupt"):
            list(pkg.TFRecordReader(path))


def test_tensorflow_reads_the_ports_records(tmp_path):
    tf = pytest.importorskip("tensorflow")
    path = tmp_path / "compat.tfrecord"
    with ttf.TFRecordWriter(path) as w:
        w.write_example({"a": [1.0, 2.0], "b": [3], "c": b"bytes", "d": np.float32(0.25), "e": "공고"})
    ttf.table_to_tfrecord(tmp_path / "table.tfrecord.gz", table(2), compress=True)
    recs = list(tf.data.TFRecordDataset(str(path)).as_numpy_iterator())
    assert len(recs) == 1
    ex = tf.train.Example()
    ex.ParseFromString(recs[0])
    assert list(ex.features.feature["a"].float_list.value) == [1.0, 2.0]
    assert list(ex.features.feature["b"].int64_list.value) == [3]
    assert ex.features.feature["c"].bytes_list.value[0] == b"bytes"
    assert list(ex.features.feature["d"].float_list.value) == [0.25]
    assert ex.features.feature["e"].bytes_list.value[0].decode() == "공고"
    rows = list(tf.data.TFRecordDataset(str(tmp_path / "table.tfrecord.gz"), compression_type="GZIP")
                .as_numpy_iterator())
    assert len(rows) == 40
    ex.ParseFromString(rows[5])
    np.testing.assert_array_equal(np.asarray(ex.features.feature["title"].float_list.value, np.float32),
                                  table(2)["title"][5])


def test_native_crc_is_built_and_in_use():
    assert tcrc.backend() == "native"
    assert _build.host_library_path("crc32c").exists()


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 255, 4096, 1 << 20])
def test_native_crc_equals_python_and_the_reference(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    got = tcrc.crc32c(data)
    assert got == tcrc._crc32c_py(data) == native.crc32c(data) == native._crc32c_py(data)
    # chaining: a CRC continued over a split equals the one-shot CRC
    cut = n // 3
    assert tcrc.crc32c(data[cut:], tcrc.crc32c(data[:cut])) == got
    assert tcrc._crc32c_py(data[cut:], tcrc._crc32c_py(data[:cut])) == got


def test_crc_known_vectors():
    for crc in (tcrc.crc32c, tcrc._crc32c_py):
        assert crc(b"") == 0
        assert crc(b"123456789") == 0xE3069283  # RFC 3720
        assert crc(bytes(32)) == 0x8A9136AA


def test_python_crc_is_taken_where_the_library_cannot_build(monkeypatch):
    def no_gxx(name):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(tcrc, "_lib", False)
    monkeypatch.setattr(_build, "load_host", no_gxx)
    assert tcrc.backend() == "python"
    assert tcrc.crc32c(b"123456789") == 0xE3069283
