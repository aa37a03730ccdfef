"""TFRecord + tf.train.Example IO without TensorFlow (port of
``jodalrob_twotower_tpu/io/tfrecord.py``).

Parity with the upstream export/inspection tooling
(src/tfrecord/to_tfrecord.py, tfrecord_viewer.py) which depended on a full
TensorFlow install just for `tf.io.TFRecordWriter` and `tf.train.Example`.
Both formats are small and stable, so they are implemented directly:

* TFRecord framing: ``[len u64][crc32c(len) masked u32][data][crc32c(data)
  masked u32]`` per record, optional gzip around the whole stream.
* tf.train.Example protobuf: hand-rolled proto3 wire-format encoder/decoder
  for the fixed schema Example{features: Features{feature: map<string,
  Feature{bytes_list|float_list|int64_list}>}}.

CRC32C comes from ``io/crc32c.py``: the native library built from
``csrc/crc32c.cpp`` at first use, else the pure-Python version.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path
from typing import Iterable, Iterator, Mapping, Sequence

import numpy as np

from jodalrob_twotower_torch.io.crc32c import crc32c

_MASK_DELTA = 0xA282EAD8


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + _MASK_DELTA & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal proto3 wire format
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


# Feature fields: 1=bytes_list, 2=float_list, 3=int64_list; each wraps a
# repeated `value` field (1).

_F32 = struct.Struct("<f")
_ONE_FLOAT = b"\x12\x06\x0a\x04"  # float_list(2){packed value(1): 4 bytes}


def _encode_feature(value) -> bytes:
    kind = type(value)
    # one Python float, int or str (a table export is mostly these): the
    # bytes the general path below gives them, built directly
    if kind is float:
        return _ONE_FLOAT + _F32.pack(value)
    if kind is int:
        return _len_delim(3, _tag(1, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF))
    if kind is str:
        return _len_delim(1, _len_delim(1, value.encode()))
    if isinstance(value, np.ndarray) and value.dtype.kind in "fiu":
        value = value.ravel().tolist()
    if isinstance(value, bytes):
        value = [value]
    if isinstance(value, str):
        value = [value.encode()]
    arr = value
    if isinstance(arr, np.ndarray):
        arr = arr.tolist() if arr.ndim else [arr.item()]
    if not isinstance(arr, (list, tuple)):
        arr = [arr]
    # numpy scalars (np.float32 etc.) are NOT python float/int subclasses;
    # without this they fall through to the int branch and truncate floats
    arr = [a.item() if isinstance(a, np.generic) else a for a in arr]
    if len(arr) and isinstance(arr[0], (bytes, str)):
        payload = b"".join(
            _len_delim(1, v.encode() if isinstance(v, str) else v) for v in arr
        )
        return _len_delim(1, payload)
    if len(arr) and isinstance(arr[0], float):
        # float_list uses packed fixed32 floats
        packed = struct.pack(f"<{len(arr)}f", *arr)
        return _len_delim(2, _len_delim(1, packed))
    # default ints (also empty lists)
    payload = b"".join(_tag(1, 0) + _varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in arr)
    return _len_delim(3, payload)


def encode_example(features: Mapping[str, object]) -> bytes:
    """dict -> serialized tf.train.Example. Values: bytes/str, float(list),
    int(list), or 1-D numpy arrays."""
    body = b""
    for name, value in features.items():
        entry = _len_delim(1, name.encode()) + _len_delim(2, _encode_feature(value))
        body += _len_delim(1, entry)  # Features.feature map entry
    return _len_delim(1, body)  # Example.features


def _decode_feature(buf: bytes) -> list:
    pos = 0
    out: list = []
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        ln, pos = _read_varint(buf, pos)
        payload = buf[pos : pos + ln]
        pos += ln
        if field == 1:  # bytes_list
            p2 = 0
            while p2 < len(payload):
                k2, p2 = _read_varint(payload, p2)
                l2, p2 = _read_varint(payload, p2)
                out.append(payload[p2 : p2 + l2])
                p2 += l2
        elif field == 2:  # float_list
            p2 = 0
            while p2 < len(payload):
                k2, p2 = _read_varint(payload, p2)
                if (k2 & 7) == 2:  # packed
                    l2, p2 = _read_varint(payload, p2)
                    out.extend(struct.unpack(f"<{l2 // 4}f", payload[p2 : p2 + l2]))
                    p2 += l2
                else:  # unpacked fixed32
                    out.append(struct.unpack("<f", payload[p2 : p2 + 4])[0])
                    p2 += 4
        elif field == 3:  # int64_list
            p2 = 0
            while p2 < len(payload):
                k2, p2 = _read_varint(payload, p2)
                v, p2 = _read_varint(payload, p2)
                if v >= 1 << 63:
                    v -= 1 << 64
                out.append(v)
    return out


def decode_example(data: bytes) -> dict[str, list]:
    """serialized tf.train.Example -> {name: [values]}."""
    out: dict[str, list] = {}
    _, pos = _read_varint(data, 0)  # features tag
    flen, pos = _read_varint(data, pos)
    features = data[pos : pos + flen]
    p = 0
    while p < len(features):
        key, p = _read_varint(features, p)
        ln, p = _read_varint(features, p)
        entry = features[p : p + ln]
        p += ln
        # map entry: 1=name, 2=Feature
        e = 0
        name = b""
        feat: list = []
        while e < len(entry):
            k, e = _read_varint(entry, e)
            l2, e = _read_varint(entry, e)
            if (k >> 3) == 1:
                name = entry[e : e + l2]
            else:
                feat = _decode_feature(entry[e : e + l2])
            e += l2
        out[name.decode()] = feat
    return out


# ---------------------------------------------------------------------------
# record framing
# ---------------------------------------------------------------------------


class TFRecordWriter:
    def __init__(self, path: str | Path, *, compress: bool = False):
        self.path = Path(path)
        self._fh = gzip.open(self.path, "wb") if compress else self.path.open("wb")

    def write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._fh.write(header)
        self._fh.write(struct.pack("<I", _masked_crc(header)))
        self._fh.write(record)
        self._fh.write(struct.pack("<I", _masked_crc(record)))

    def write_example(self, features: Mapping[str, object]) -> None:
        self.write(encode_example(features))

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class TFRecordReader:
    def __init__(self, path: str | Path, *, compressed: bool | None = None):
        self.path = Path(path)
        if compressed is None:
            with self.path.open("rb") as fh:
                compressed = fh.read(2) == b"\x1f\x8b"
        self._compressed = compressed

    def __iter__(self) -> Iterator[bytes]:
        fh = gzip.open(self.path, "rb") if self._compressed else self.path.open("rb")
        with fh:
            while True:
                header = fh.read(8)
                if len(header) < 8:
                    return
                (length,) = struct.unpack("<Q", header)
                (hcrc,) = struct.unpack("<I", fh.read(4))
                if hcrc != _masked_crc(header):
                    raise IOError(f"corrupt record header in {self.path}")
                data = fh.read(length)
                (dcrc,) = struct.unpack("<I", fh.read(4))
                if dcrc != _masked_crc(data):
                    raise IOError(f"corrupt record payload in {self.path}")
                yield data

    def examples(self) -> Iterator[dict[str, list]]:
        for rec in self:
            yield decode_example(rec)


def inspect_tfrecord(path: str | Path, *, limit: int = 5) -> dict:
    """Count records and preview the first few (upstream tfrecord_viewer
    capability: view/count/search)."""
    reader = TFRecordReader(path)
    count = 0
    preview = []
    for ex in reader.examples():
        if count < limit:
            preview.append(
                {
                    k: (v[:4] + ["..."] if len(v) > 4 else v)
                    for k, v in ex.items()
                }
            )
        count += 1
    return {"path": str(path), "count": count, "preview": preview}


def count_records(paths: "str | Path | Sequence[str | Path]") -> int:
    """Total record count across one or many files (upstream
    tfrecord_viewer.py:158 count_tfrecords, without the TF dependency).

    Accepts a path, a glob pattern, or a sequence of paths."""
    import glob as _glob

    if isinstance(paths, (str, Path)):
        s = str(paths)
        paths = sorted(_glob.glob(s)) if "*" in s else [s]
    total = 0
    for p in paths:
        for _ in TFRecordReader(p):
            total += 1
    return total


def search_records(
    path: str | Path,
    search_key: str,
    search_value,
    *,
    max_results: int = 10,
) -> list[dict[str, list]]:
    """Records whose `search_key` feature equals `search_value` (upstream
    tfrecord_viewer.py:114 search_records). Scalar values match a
    single-element feature list; lists match exactly."""
    want = search_value if isinstance(search_value, list) else [search_value]
    out: list[dict[str, list]] = []
    for ex in TFRecordReader(path).examples():
        if search_key in ex and ex[search_key] == want:
            out.append(ex)
            if len(out) >= max_results:
                break
    return out


def table_to_tfrecord(
    path: str | Path,
    columns: Mapping[str, np.ndarray],
    *,
    compress: bool = True,
) -> int:
    """Write a column dict as one Example per row (upstream
    to_tfrecord.py:113 capability, minus the DB source)."""
    names = list(columns.keys())
    arrays = [np.asarray(columns[name]) for name in names]
    n = len(arrays[0])
    # bool, number and str columns as Python values, converted once: they
    # encode to the same bytes as their numpy elements
    values = [a.tolist() if a.dtype.kind in "biufU" else a for a in arrays]
    with TFRecordWriter(path, compress=compress) as w:
        for i in range(n):
            w.write_example({name: col[i] for name, col in zip(names, values)})
    return n
