"""Offline ETL pipeline: raw table -> preprocessed parquet feature chunks (port
of ``jodalrob_twotower_tpu/etl/pipeline.py``).

Fit numeric and categorical statistics once on the full table, then
transform in chunks; text columns expand to fixed-width embedding vectors
inline. The work is split into helpers that ``run_pipeline`` composes:
``fit_preprocessors`` (the fit), ``FittedPreprocessors.transform`` (one
chunk) and ``FittedPreprocessors.manifest`` (the manifest dict), so a caller
without ``pyarrow`` (the card machine has none) runs the same ETL in memory
through ``preprocess_in_memory``. ``pyarrow`` is imported only inside the
functions that read or write parquet.

Output layout for table ``t`` under ``out_dir``, the JAX package's:
  t_chunk_0000.parquet ...   preprocessed rows (pk + flags + features + emb)
  t_numeric.json             fitted numeric stats
  t_categorical.json         fitted vocabs (+ model spec with input_dims)
  t_manifest.json            chunk list, row counts, column groups
Each package reads the other's files and loads the other's fitted state.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Iterable, Mapping

import numpy as np

from jodalrob_twotower_torch.etl.categorical import CategoricalPreprocessor
from jodalrob_twotower_torch.etl.numeric import NumericPreprocessor
from jodalrob_twotower_torch.etl.text import TextPreprocessor


def _write_parquet(path: Path, columns: Mapping[str, np.ndarray]) -> None:
    import pyarrow as pa
    import pyarrow.parquet as pq

    arrays = {}
    for name, arr in columns.items():
        arr = np.asarray(arr)
        if arr.ndim == 2:  # embedding block -> fixed-size list column
            arrays[name] = pa.array(list(arr), type=pa.list_(pa.float32(), arr.shape[1]))
        else:
            arrays[name] = pa.array(arr)
    pq.write_table(pa.table(arrays), str(path))


def chunk_file(table_name: str, i: int) -> str:
    """The name of chunk ``i`` of ``table_name``'s preprocessed output."""
    return f"{table_name}_chunk_{i:04d}.parquet"


@dataclasses.dataclass
class FittedPreprocessors:
    """One table's fitted preprocessors and the columns they cover."""

    pk_columns: list[str]
    numeric: NumericPreprocessor
    categorical: CategoricalPreprocessor
    text: TextPreprocessor | None
    text_columns: list[str]

    def transform(self, chunk: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
        """One chunk's preprocessed columns: pk (as str), numeric outputs
        (null flags first), categorical ids (+ flags), text embeddings."""
        cols: dict[str, np.ndarray] = {}
        for pk in self.pk_columns:
            cols[pk] = np.asarray(chunk[pk]).astype(str)
        cols.update(self.numeric.transform(chunk))
        cols.update(self.categorical.transform(chunk))
        if self.text is not None:
            cols.update(self.text.transform(chunk, self.text_columns))
        return cols

    def categorical_payload(self) -> dict:
        """The ``{t}_categorical.json`` payload: the vocabs and the model spec."""
        payload = self.categorical.to_dict()
        payload["model_spec"] = self.categorical.model_spec()
        return payload

    def manifest(self, table_name: str, rows: int, chunks: list[str]) -> dict:
        """The ``{t}_manifest.json`` dict for ``rows`` rows in ``chunks``."""
        return {
            "table": table_name,
            "rows": rows,
            "chunks": chunks,
            "pk": self.pk_columns,
            "numeric_outputs": self.numeric.output_columns,
            "categorical_outputs": list(self.categorical.vocabs.keys()),
            "categorical_input_dims": self.categorical.input_dims(),
            "text_outputs": list(self.text_columns),
            "text_embed_dim": self.text.embed_dim if self.text is not None else 0,
        }


def fit_preprocessors(
    fit_table: Mapping[str, np.ndarray],
    *,
    pk_columns: list[str],
    numeric_columns: list[str],
    categorical_columns: list[str],
    text_columns: list[str] | None = None,
    numeric_configs: Mapping | None = None,
    categorical_configs: Mapping | None = None,
    text_configs: Mapping | None = None,
    text_embedder=None,
) -> FittedPreprocessors:
    """Fit the numeric and categorical statistics on ``fit_table`` (every
    row at once) and set up the text embedder."""
    num = NumericPreprocessor(numeric_configs or {}).fit(fit_table, numeric_columns)
    cat = CategoricalPreprocessor(categorical_configs or {}).fit(fit_table, categorical_columns)
    txt = TextPreprocessor(text_configs or {}, embedder=text_embedder) if text_columns else None
    return FittedPreprocessors(list(pk_columns), num, cat, txt, list(text_columns or []))


def _fit_source(chunks, fit_table, columns):
    """(chunks, fit_table): without a ``fit_table`` the stream is
    materialized and concatenated, since fitting needs every row at once;
    with one, the chunks stay a lazy iterator (tables larger than host
    memory are the point of the chunked API)."""
    if fit_table is None:
        chunks = list(chunks)
        fit_table = {
            col: np.concatenate([np.asarray(c[col], dtype=object) for c in chunks])
            for col in columns
        }
    return chunks, fit_table


def _columns(kw: Mapping) -> tuple[str, ...]:
    return (*kw["pk_columns"], *kw["numeric_columns"], *kw["categorical_columns"],
            *(kw.get("text_columns") or []))


def run_pipeline(
    table_name: str,
    chunks: Iterable[Mapping[str, np.ndarray]],
    out_dir: str | Path,
    *,
    fit_table: Mapping[str, np.ndarray] | None = None,
    **kw,
) -> dict:
    """Fit on ``fit_table`` (or the concatenation of chunks), then transform
    chunk-by-chunk to parquet. ``kw`` are :func:`fit_preprocessors`'s column
    lists, configs and text embedder. Returns the manifest dict."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    chunks, fit_table = _fit_source(chunks, fit_table, _columns(kw))
    prep = fit_preprocessors(fit_table, **kw)
    prep.numeric.save(out / f"{table_name}_numeric.json")
    (out / f"{table_name}_categorical.json").write_text(
        json.dumps(prep.categorical_payload(), ensure_ascii=False, indent=2)
    )
    chunk_files = []
    total_rows = 0
    for i, chunk in enumerate(chunks):
        cols = prep.transform(chunk)
        fname = chunk_file(table_name, i)
        _write_parquet(out / fname, cols)
        chunk_files.append(fname)
        total_rows += len(next(iter(cols.values())))
    manifest = prep.manifest(table_name, total_rows, chunk_files)
    (out / f"{table_name}_manifest.json").write_text(json.dumps(manifest, indent=2))
    return manifest


def preprocess_in_memory(
    table_name: str,
    chunks: Iterable[Mapping[str, np.ndarray]],
    *,
    fit_table: Mapping[str, np.ndarray] | None = None,
    **kw,
) -> tuple[dict, dict[str, np.ndarray]]:
    """:func:`run_pipeline` without the files: the same fit and per-chunk
    transform, the chunks' columns concatenated instead of written. Returns
    the manifest dict ``run_pipeline`` would write (its chunk names
    included) and the preprocessed columns ``load_preprocessed`` would read
    back."""
    chunks, fit_table = _fit_source(chunks, fit_table, _columns(kw))
    prep = fit_preprocessors(fit_table, **kw)
    parts = [prep.transform(chunk) for chunk in chunks]
    rows = sum(len(next(iter(p.values()))) for p in parts)
    manifest = prep.manifest(table_name, rows, [chunk_file(table_name, i) for i in range(len(parts))])
    return manifest, {name: np.concatenate([p[name] for p in parts]) for name in parts[0]}


def update_text_embeddings(
    out_dir: str | Path,
    table_name: str,
    column: str,
    texts_by_pk: Mapping[str, str],
    *,
    embedder=None,
    text_config: Mapping | None = None,
) -> int:
    """Incrementally re-embed one text column for selected rows: the chunks
    holding affected PKs are rewritten in place with fresh embeddings,
    untouched chunks are left alone. Returns the number of rows updated."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    out = Path(out_dir)
    manifest = json.loads((out / f"{table_name}_manifest.json").read_text())
    if column not in manifest["text_outputs"]:
        raise KeyError(f"{column!r} is not a text column of {table_name!r}")
    pk_cols = manifest["pk"]
    txt = TextPreprocessor({column: text_config or {}}, embedder=embedder)
    updated = 0
    for fname in manifest["chunks"]:
        path = out / fname
        tbl = pq.read_table(str(path))
        if len(pk_cols) == 1:
            keys = [str(v) for v in tbl.column(pk_cols[0]).to_pylist()]
        else:
            cols = [tbl.column(c).to_pylist() for c in pk_cols]
            keys = ["|".join(str(v) for v in row) for row in zip(*cols)]
        hit = [i for i, k in enumerate(keys) if k in texts_by_pk]
        if not hit:
            continue
        emb_col = tbl.column(column).to_numpy(zero_copy_only=False)
        block = np.stack(emb_col).astype(np.float32)
        new_texts = [texts_by_pk[keys[i]] for i in hit]
        new_out = txt.transform({column: np.asarray(new_texts, object)}, [column])
        block[hit] = new_out[column]
        dim = block.shape[1]
        new_arr = pa.array(list(block), type=pa.list_(pa.float32(), dim))
        tbl = tbl.set_column(tbl.column_names.index(column), column, new_arr)
        flag_col = f"{column}_is_null"
        if flag_col in new_out and flag_col in tbl.column_names:
            flags = tbl.column(flag_col).to_numpy(zero_copy_only=False).astype(np.float32)
            flags[hit] = new_out[flag_col]
            tbl = tbl.set_column(tbl.column_names.index(flag_col), flag_col, pa.array(flags))
        pq.write_table(tbl, str(path))
        updated += len(hit)
    return updated


def iter_preprocessed_chunks(out_dir: str | Path, table_name: str):
    """Yield each preprocessed chunk as a column dict (embeddings -> [N, D]),
    in manifest order: the streaming counterpart of :func:`load_preprocessed`
    (feeds e.g. the PG write-back without holding the table in memory)."""
    import pyarrow.parquet as pq

    out = Path(out_dir)
    manifest = json.loads((out / f"{table_name}_manifest.json").read_text())
    for fname in manifest["chunks"]:
        tbl = pq.read_table(str(out / fname))
        cols = {}
        for name in tbl.column_names:
            data = tbl.column(name).to_numpy(zero_copy_only=False)
            if data.dtype == object and len(data) and isinstance(data[0], np.ndarray):
                data = np.stack(data).astype(np.float32)
            cols[name] = data
        yield cols


def load_preprocessed(out_dir: str | Path, table_name: str) -> dict[str, np.ndarray]:
    """Read all chunks back into one column dict (embeddings -> [N, D])."""
    parts = list(iter_preprocessed_chunks(out_dir, table_name))
    return {name: np.concatenate([p[name] for p in parts]) for name in parts[0]}
