"""TFRecord export / inspection CLI, with no TensorFlow (port of
``scripts/tfrecord_tool.py``): ``python -m jodalrob_twotower_torch.tfrecord_tool``.

Subcommands
-----------
export   parquet file -> GZIP TFRecord of tf.train.Example rows
count    total records across files / glob patterns
inspect  record count + first-N preview of one file
search   records whose feature equals a value

The flags and output are the JAX script's; the records come from
``io/tfrecord.py`` (CRC32C from the native library when it builds).

Examples
--------
  python -m jodalrob_twotower_torch.tfrecord_tool export --input notice.parquet --out notice.tfrecord.gz
  python -m jodalrob_twotower_torch.tfrecord_tool count 'out/*.tfrecord.gz'
  python -m jodalrob_twotower_torch.tfrecord_tool inspect out/notice.tfrecord.gz --limit 3
  python -m jodalrob_twotower_torch.tfrecord_tool search out/notice.tfrecord.gz --key bizno --value 1234
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from jodalrob_twotower_torch.io.tfrecord import (
    count_records,
    inspect_tfrecord,
    search_records,
    table_to_tfrecord,
)


def _jsonable(obj):
    if isinstance(obj, bytes):
        return obj.decode("utf-8", "replace")
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer, np.floating)):
        return obj.item()
    return obj


def cmd_export(args: argparse.Namespace) -> int:
    import pyarrow.parquet as pq

    tbl = pq.read_table(args.input)
    names = args.columns.split(",") if args.columns else tbl.column_names
    columns = {}
    for name in names:
        data = tbl.column(name).to_numpy(zero_copy_only=False)
        # fixed-size-list embedding columns come back as object arrays of
        # ndarrays; stack them so each row exports as a float list feature
        if data.dtype == object and len(data) and isinstance(data[0], np.ndarray):
            data = np.stack(data)
        columns[name] = data
    n = table_to_tfrecord(args.out, columns, compress=not args.no_compress)
    print(f"wrote {n} records -> {args.out}")
    return 0


def cmd_count(args: argparse.Namespace) -> int:
    total = sum(count_records(p) for p in args.paths)
    print(total)
    return 0


def cmd_inspect(args: argparse.Namespace) -> int:
    print(json.dumps(_jsonable(inspect_tfrecord(args.path, limit=args.limit)), indent=2))
    return 0


def search_value(value: str, as_bytes: bool):
    """The ``--value`` to match: bytes with ``--bytes`` (ids like '1234' are
    routinely STORED as bytes features, and int(1234) never equals
    b'1234'), else an int, a float or the string, the first that parses."""
    if as_bytes:
        return value.encode()
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            continue
    return value


def cmd_search(args: argparse.Namespace) -> int:
    hits = search_records(args.path, args.key, search_value(args.value, args.bytes), max_results=args.limit)
    print(json.dumps(_jsonable(hits), indent=2))
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="TFRecord export / inspection CLI (zero TensorFlow dependency).")
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("export", help="parquet -> TFRecord")
    e.add_argument("--input", required=True)
    e.add_argument("--out", required=True)
    e.add_argument("--columns", default=None, help="comma-separated subset")
    e.add_argument("--no-compress", action="store_true")
    e.set_defaults(fn=cmd_export)

    c = sub.add_parser("count", help="count records across files/globs")
    c.add_argument("paths", nargs="+")
    c.set_defaults(fn=cmd_count)

    i = sub.add_parser("inspect", help="count + preview one file")
    i.add_argument("path")
    i.add_argument("--limit", type=int, default=5)
    i.set_defaults(fn=cmd_inspect)

    s = sub.add_parser("search", help="find records by feature value")
    s.add_argument("path")
    s.add_argument("--key", required=True)
    s.add_argument("--value", required=True)
    s.add_argument("--limit", type=int, default=10)
    s.add_argument("--bytes", action="store_true", help="match value as bytes feature")
    s.set_defaults(fn=cmd_search)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
