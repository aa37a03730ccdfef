"""Chunked parquet conversion: multi-file datasets with a manifest (port of
``jodalrob_twotower_tpu/etl/parquet_chunks.py``).

Single file or ``chunk_%04d.parquet`` multi-file output with dataset
metadata, parallel multi-table conversion, and a loader that reassembles
the table. The writer is DB-agnostic: it consumes ANY iterator of
column-dict chunks (a ``DatabaseConnector.iter_chunks`` stream, a CSV
reader, a synthetic generator), so it is testable without postgres. The
manifest is JSON (``metadata.json``). ``pyarrow`` is imported only inside
the functions.
"""

from __future__ import annotations

import json
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Iterable, Iterator, Mapping, Sequence

import numpy as np

MANIFEST_NAME = "metadata.json"
CHUNK_PATTERN = "chunk_%04d.parquet"


def _to_arrow_table(chunk: Mapping[str, np.ndarray]):
    import pyarrow as pa

    cols = {}
    for k, v in chunk.items():
        arr = np.asarray(v)
        # 2-D blocks (e.g. text-embedding matrices) become fixed-size lists
        if arr.ndim == 2:
            cols[k] = pa.FixedSizeListArray.from_arrays(
                pa.array(arr.reshape(-1)), arr.shape[1]
            )
        elif arr.dtype == object:
            cols[k] = pa.array(arr.tolist())
        else:
            cols[k] = pa.array(arr)
    return pa.table(cols)


def write_parquet_chunks(
    chunks: Iterable[Mapping[str, np.ndarray]],
    out_dir: str | Path,
    *,
    table_name: str,
    rows_per_file: int | None = None,
    compression: str = "snappy",
) -> dict:
    """Write a chunk stream as ``chunk_%04d.parquet`` files + manifest.

    ``rows_per_file=None`` starts a new file per input chunk; otherwise
    input chunks are re-batched so every file (except the last) holds
    exactly ``rows_per_file`` rows. Returns the manifest dict (also written
    to ``out_dir/metadata.json``).
    """
    import pyarrow.parquet as pq

    if rows_per_file is not None and rows_per_file < 1:
        raise ValueError(f"rows_per_file must be >= 1, got {rows_per_file}")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    files: list[dict] = []
    columns: list[str] | None = None
    schema = None  # canonical: inferred from the first chunk
    n_rows = 0
    writer = None
    rows_in_file = 0

    def open_file():
        nonlocal writer, rows_in_file
        path = out / (CHUNK_PATTERN % len(files))
        files.append({"file": path.name, "rows": 0})
        rows_in_file = 0
        return path

    try:
        for chunk in chunks:
            tbl = _to_arrow_table(chunk)
            if columns is None:
                columns = list(chunk.keys())
                schema = tbl.schema
            elif tbl.schema != schema:
                # per-chunk type inference can drift (an all-NULL chunk of a
                # nullable column infers 'null', ints followed by floats
                # infer int64 then double); unify on the first chunk's schema
                # so one ParquetWriter can span chunks
                try:
                    tbl = tbl.cast(schema)
                except Exception as e:
                    raise ValueError(
                        f"chunk schema drifted from the first chunk's and "
                        f"cannot be cast back: {e}\nfirst: {schema}\n"
                        f"current: {tbl.schema}"
                    ) from e
            offset = 0
            while offset < tbl.num_rows:
                if writer is None:
                    path = open_file()
                    writer = pq.ParquetWriter(
                        str(path), tbl.schema, compression=compression
                    )
                take = tbl.num_rows - offset
                if rows_per_file is not None:
                    take = min(take, rows_per_file - rows_in_file)
                writer.write_table(tbl.slice(offset, take))
                offset += take
                rows_in_file += take
                n_rows += take
                files[-1]["rows"] = rows_in_file
                if rows_per_file is not None and rows_in_file >= rows_per_file:
                    writer.close()
                    writer = None
            if rows_per_file is None and writer is not None:
                writer.close()
                writer = None
    finally:
        if writer is not None:
            writer.close()

    manifest = {
        "table": table_name,
        "n_rows": n_rows,
        "n_files": len(files),
        "rows_per_file": rows_per_file,
        "columns": columns or [],
        "files": files,
        "created_unix": int(time.time()),
    }
    (out / MANIFEST_NAME).write_text(json.dumps(manifest, indent=2))
    return manifest


def read_manifest(out_dir: str | Path) -> dict:
    return json.loads((Path(out_dir) / MANIFEST_NAME).read_text())


def iter_parquet_chunks(
    out_dir: str | Path, *, columns: Sequence[str] | None = None
) -> Iterator[dict[str, np.ndarray]]:
    """Stream the dataset back file-by-file (column dicts, manifest order)."""
    import pyarrow.parquet as pq

    out = Path(out_dir)
    manifest = read_manifest(out)
    for entry in manifest["files"]:
        tbl = pq.read_table(str(out / entry["file"]), columns=list(columns) if columns else None)
        yield {name: _from_arrow(tbl.column(name)) for name in tbl.column_names}


def _from_arrow(col) -> np.ndarray:
    import pyarrow as pa

    if pa.types.is_fixed_size_list(col.type):
        width = col.type.list_size
        combined = col.combine_chunks()
        flat = combined.values.to_numpy(zero_copy_only=False)
        return flat.reshape(-1, width)
    return col.to_numpy(zero_copy_only=False)


def load_parquet_chunks(
    out_dir: str | Path, *, columns: Sequence[str] | None = None
) -> dict[str, np.ndarray]:
    """Reassemble the full table."""
    parts: dict[str, list[np.ndarray]] = {}
    for chunk in iter_parquet_chunks(out_dir, columns=columns):
        for k, v in chunk.items():
            parts.setdefault(k, []).append(v)
    if not parts:
        return {c: np.empty((0,)) for c in (columns or [])}
    return {k: np.concatenate(v, axis=0) for k, v in parts.items()}


def convert_tables_parallel(
    sources: Mapping[str, Callable[[], Iterable[Mapping[str, np.ndarray]]]],
    out_root: str | Path,
    *,
    rows_per_file: int | None = None,
    max_workers: int = 4,
) -> dict[str, dict]:
    """Convert several tables concurrently.

    ``sources`` maps table name -> zero-arg callable returning that table's
    chunk iterator (e.g. ``lambda: connector.iter_chunks(sql)``); each table
    lands in ``out_root/<table>/``. IO-bound (DB reads + parquet writes), so
    threads give real overlap despite the GIL.
    """
    out_root = Path(out_root)

    def one(name: str, make_chunks) -> dict:
        return write_parquet_chunks(
            make_chunks(), out_root / name, table_name=name,
            rows_per_file=rows_per_file,
        )

    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        futures = {name: ex.submit(one, name, fn) for name, fn in sources.items()}
        return {name: f.result() for name, f in futures.items()}
