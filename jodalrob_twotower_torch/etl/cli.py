"""Offline ETL driver CLI (port of ``scripts/etl.py``):
``python -m jodalrob_twotower_torch.etl``.

Subcommands
-----------
classify     metadata.csv -> pk/numeric/categorical/text classification (JSON)
schema       metadata.csv -> TwoTowerSchema JSON (drives model + pipeline)
run          raw parquet table -> preprocessed parquet feature chunks
update-text  re-embed one text column for selected rows, in place
upload       COPY preprocessed chunks into PostgreSQL (+pgvector)

The flags, output and files are the JAX script's. ``run`` and
``update-text`` take the HF text embedder's device from ``--force-cpu``:
the card unless it is given (without a card, ``auto`` and ``hf`` raise;
``hash`` needs no device).

Examples
--------
  python -m jodalrob_twotower_torch.etl classify --table notice --metadata meta/metadata.csv
  python -m jodalrob_twotower_torch.etl run --table notice --metadata meta/metadata.csv \\
      --input raw/notice.parquet --out-dir /data/preprocessed \\
      --numeric-config meta/notice_numeric_config.json \\
      --categorical-config meta/notice_categorical_config.json \\
      --chunk-rows 50000
  python -m jodalrob_twotower_torch.etl update-text --out-dir /data/preprocessed \\
      --table notice --column bidntcenm --texts updates.json
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from jodalrob_twotower_torch.etl.pipeline import run_pipeline, update_text_embeddings
from jodalrob_twotower_torch.etl.reference_configs import (
    categorical_configs_from_reference,
    numeric_configs_from_reference,
    text_configs_from_reference,
)
from jodalrob_twotower_torch.etl.text import HashTextEmbedder, HFTextEmbedder, auto_text_embedder
from jodalrob_twotower_torch.schema import classify_columns, schema_from_metadata_csv


def _make_embedder(args: argparse.Namespace, model_name: str | None = None):
    """The ``--text-embedder``: ``auto`` takes the HF model (``model_name``,
    the text config's embedding_model, else the default) and falls back to
    the hash embedder only when the model cannot be loaded; the explicit
    kinds skip that attempt."""
    device = "cpu" if args.force_cpu else None
    if args.text_embedder == "hash":
        return HashTextEmbedder(args.text_embed_dim)
    if args.text_embedder == "hf":
        return HFTextEmbedder(model_name, device)
    return auto_text_embedder(model_name, device, args.text_embed_dim)


def _read_parquet_columns(path: str | Path) -> dict[str, np.ndarray]:
    import pyarrow.parquet as pq

    tbl = pq.read_table(str(path))
    return {
        name: tbl.column(name).to_numpy(zero_copy_only=False)
        for name in tbl.column_names
    }


def _chunked(columns: dict[str, np.ndarray], chunk_rows: int):
    n = len(next(iter(columns.values())))
    for start in range(0, n, chunk_rows):
        yield {k: v[start : start + chunk_rows] for k, v in columns.items()}


def cmd_classify(args: argparse.Namespace) -> int:
    cls = classify_columns(args.table, args.metadata)
    out = {
        "table": args.table,
        "pk": cls["pk"],
        "numeric": cls["numeric"],
        "categorical": [
            {"column": name, "n_categories": count} for name, count in cls["categorical"]
        ],
        "text": cls["text"],
    }
    print(json.dumps(out, ensure_ascii=False, indent=2))
    return 0


def cmd_schema(args: argparse.Namespace) -> int:
    schema = schema_from_metadata_csv(
        args.metadata,
        notice_table=args.notice_table,
        company_table=args.company_table,
        text_embed_dim=args.text_embed_dim,
        notice_text_columns=args.notice_text_columns.split(",")
        if args.notice_text_columns
        else None,
    )
    if args.out:
        schema.to_json(args.out)
        print(f"wrote {args.out}")
    else:
        print(json.dumps(schema.to_dict(), ensure_ascii=False, indent=2))
    return 0


def cmd_run(args: argparse.Namespace) -> int:
    cls = classify_columns(args.table, args.metadata)
    columns = _read_parquet_columns(args.input)
    missing = [
        c
        for c in (*cls["pk"], *cls["numeric"], *(n for n, _ in cls["categorical"]))
        if c not in columns
    ]
    if missing:
        raise SystemExit(f"input parquet is missing classified columns: {missing}")

    numeric_configs = (
        numeric_configs_from_reference(args.numeric_config) if args.numeric_config else None
    )
    categorical_configs = (
        categorical_configs_from_reference(args.categorical_config)
        if args.categorical_config
        else None
    )
    text_configs, text_model = (
        text_configs_from_reference(args.text_config) if args.text_config else ({}, None)
    )
    text_columns = [c for c in cls["text"] if c in columns]
    if text_configs:
        text_columns = [c for c in text_columns if c in text_configs]

    manifest = run_pipeline(
        args.table,
        _chunked(columns, args.chunk_rows),
        args.out_dir,
        pk_columns=cls["pk"],
        numeric_columns=[c for c in cls["numeric"] if c in columns],
        categorical_columns=[n for n, _ in cls["categorical"] if n in columns],
        text_columns=text_columns or None,
        numeric_configs=numeric_configs,
        categorical_configs=categorical_configs,
        text_configs=text_configs or None,
        fit_table=columns,
        text_embedder=_make_embedder(args, text_model) if text_columns else None,
    )
    print(json.dumps({k: manifest[k] for k in ("table", "rows", "chunks")}, indent=2))
    return 0


def cmd_update_text(args: argparse.Namespace) -> int:
    texts_by_pk = json.loads(Path(args.texts).read_text(encoding="utf-8"))
    if not isinstance(texts_by_pk, dict):
        raise SystemExit("--texts must be a JSON object of {pk: text}")
    # the patched rows must be embedded with the SAME config (max_length,
    # normalize, model) the store was built with, or they land in a
    # different embedding space than the untouched rows
    text_configs, text_model = (
        text_configs_from_reference(args.text_config) if args.text_config else ({}, None)
    )
    n = update_text_embeddings(
        args.out_dir,
        args.table,
        args.column,
        texts_by_pk,
        embedder=_make_embedder(args, text_model),
        text_config=text_configs.get(args.column),
    )
    print(f"updated {n} rows of {args.table}.{args.column}")
    return 0


def cmd_upload(args: argparse.Namespace) -> int:
    """Write preprocessed parquet chunks back into PostgreSQL
    ({table}_preprocessed with pgvector embedding columns, through
    etl/pg_writeback.py)."""
    from jodalrob_twotower_torch.etl.pipeline import iter_preprocessed_chunks
    from jodalrob_twotower_torch.etl.sql import DatabaseConnector

    conn = DatabaseConnector(args.url)
    target = args.target_table or f"{args.table}_preprocessed"
    n = conn.upload_preprocessed(
        target,
        iter_preprocessed_chunks(args.out_dir, args.table),
        schema=args.pg_schema,
        replace=not args.append,
    )
    print(json.dumps({"table": f"{args.pg_schema}.{target}", "rows": n}))
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="Offline ETL driver CLI.")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("classify", help="classify a table's columns from metadata.csv")
    c.add_argument("--table", required=True)
    c.add_argument("--metadata", required=True)
    c.set_defaults(fn=cmd_classify)

    s = sub.add_parser("schema", help="build a TwoTowerSchema JSON from metadata.csv")
    s.add_argument("--metadata", required=True)
    s.add_argument("--notice-table", default="notice")
    s.add_argument("--company-table", default="company")
    s.add_argument("--text-embed-dim", type=int, default=768)
    s.add_argument(
        "--notice-text-columns",
        default=None,
        help="comma-separated text columns to embed (default: all classified)",
    )
    s.add_argument("--out", default=None, help="write schema JSON here (default: stdout)")
    s.set_defaults(fn=cmd_schema)

    r = sub.add_parser("run", help="preprocess a raw parquet table")
    r.add_argument("--table", required=True)
    r.add_argument("--metadata", required=True)
    r.add_argument("--input", required=True, help="raw table parquet file")
    r.add_argument("--out-dir", required=True)
    r.add_argument("--chunk-rows", type=int, default=50_000)
    r.add_argument("--numeric-config", default=None, help="reference-format JSON")
    r.add_argument("--categorical-config", default=None, help="reference-format JSON")
    r.add_argument("--text-config", default=None, help="reference-format JSON")
    r.set_defaults(fn=cmd_run)

    u = sub.add_parser("update-text", help="re-embed one text column for given PKs")
    u.add_argument("--out-dir", required=True)
    u.add_argument("--table", required=True)
    u.add_argument("--column", required=True)
    u.add_argument("--texts", required=True, help="JSON file of {pk: new_text}")
    u.add_argument(
        "--text-config", default=None,
        help="reference-format JSON the store was built with (keeps patched "
        "rows in the same embedding space)",
    )
    u.set_defaults(fn=cmd_update_text)

    up = sub.add_parser(
        "upload", help="COPY preprocessed chunks into PostgreSQL (+pgvector)"
    )
    up.add_argument("--out-dir", required=True, help="preprocessed chunk dir")
    up.add_argument("--table", required=True, help="logical table (manifest name)")
    up.add_argument("--target-table", default=None,
                    help="PG table name (default: {table}_preprocessed)")
    up.add_argument("--pg-schema", default="public")
    up.add_argument("--url", default=None,
                    help="postgres URL (default: DB_* env vars)")
    up.add_argument("--append", action="store_true",
                    help="keep an existing table instead of replacing it")
    up.set_defaults(fn=cmd_upload)

    for cmd in (r, u):
        cmd.add_argument(
            "--text-embedder",
            choices=("auto", "hash", "hf"),
            default="auto",
            help="auto tries HF then falls back to the hash embedder",
        )
        cmd.add_argument("--text-embed-dim", type=int, default=768)
        cmd.add_argument("--force-cpu", action="store_true",
                         help="run the HF text embedder on the CPU instead of the card")

    args = p.parse_args(argv)
    return args.fn(args)
