"""Executable PostgreSQL write-back of preprocessed tables + text vectors
(port of ``jodalrob_twotower_tpu/etl/pg_writeback.py``).

etl/sql.py builds the statements; this module EXECUTES the round trip, so
a user can land preprocessed features back in their PG+pgvector store:

* ``PreprocessedUploader`` — creates ``{table}_preprocessed`` with inferred
  PG column types, collapses ``{col}_emb000..NNN`` float-column groups into
  one pgvector ``vector(N)`` column, and bulk-loads every chunk via
  COPY FROM STDIN (upstream preprocess/upload_database.py:64-102,138-266).
* ``execute_vector_update`` — pgvector DDL + COPY-into-temp + UPDATE-JOIN
  in one transaction (upstream data/database_connector.py:85-131), the
  execution of etl/sql.py's build_pgvector_ddl/build_vector_update.

Both take any psycopg3-style connection (``conn.cursor()``,
``cursor.execute``, ``cursor.copy(sql)`` context manager with ``write``,
``conn.commit``), so the logic is hermetically testable with a fake
connection and runs unchanged against a real psycopg3 one
(``DatabaseConnector.pg_connection()`` hands one out when the driver is
installed).
"""

from __future__ import annotations

import re
from typing import Iterable, Mapping, Sequence

import numpy as np

from jodalrob_twotower_torch.etl.sql import (
    _quote_ident,
    build_pgvector_ddl,
    build_vector_update,
)

_EMB_RE = re.compile(r"^(?P<base>.+)_emb(?P<idx>\d{3,})$")


def infer_pg_type(values: np.ndarray) -> str:
    """PG column type from a numpy column (upstream
    upload_database.py:138-151 dtype inference): ints -> bigint, floats ->
    double precision, bools -> boolean, everything else -> text."""
    if values.dtype == object:
        non_null = [v for v in values if v is not None]
        if non_null and all(isinstance(v, bool) for v in non_null):
            return "boolean"
        if non_null and all(
            isinstance(v, (int, np.integer)) and not isinstance(v, bool)
            for v in non_null
        ):
            return "bigint"
        if non_null and all(
            isinstance(v, (int, float, np.integer, np.floating))
            and not isinstance(v, bool)
            for v in non_null
        ):
            return "double precision"
        return "text"
    if np.issubdtype(values.dtype, np.bool_):
        return "boolean"
    if np.issubdtype(values.dtype, np.integer):
        return "bigint"
    if np.issubdtype(values.dtype, np.floating):
        return "double precision"
    return "text"


def collapse_embedding_columns(
    columns: Sequence[str],
) -> tuple[list[str], dict[str, tuple[str, ...]]]:
    """Split column names into (scalar columns, {base: ordered column
    names}) by detecting ``{base}_emb000..NNN`` groups (upstream
    upload_database.py:198-232 collapses them into ``vector(768)`` columns
    named ``{base}``). Group values carry the ACTUAL column names (any
    zero-padding width) in index order; the vector dim is their length."""
    groups: dict[str, list[tuple[int, str]]] = {}
    scalars: list[str] = []
    for c in columns:
        m = _EMB_RE.match(c)
        if m:
            groups.setdefault(m.group("base"), []).append((int(m.group("idx")), c))
        else:
            scalars.append(c)
    out = {}
    for base, pairs in groups.items():
        pairs.sort()
        idxs = [i for i, _ in pairs]
        if idxs != list(range(len(idxs))):
            raise ValueError(
                f"embedding group {base!r} has non-contiguous indices "
                f"(have {len(idxs)}, min {idxs[0]}, max {idxs[-1]})"
            )
        out[base] = tuple(name for _, name in pairs)
    return scalars, out


def build_create_preprocessed(
    schema: str,
    table: str,
    column_types: Mapping[str, str],
    vector_dims: Mapping[str, int],
    *,
    replace: bool = True,
    pk_cols: Sequence[str] = (),
) -> list[str]:
    """DDL for ``{schema}.{table}`` with scalar + vector columns.

    ``pk_cols`` are forced to ``text NOT NULL`` (Korean bid/biz numbers have
    leading zeros a bigint round-trip would drop) and get a PRIMARY KEY
    constraint, matching the upstream table shape
    (upload_database.py:138-196)."""
    pk_set = set(pk_cols)
    unknown = pk_set - set(column_types)
    if unknown:
        raise ValueError(f"pk_cols not in column_types: {sorted(unknown)}")
    cols = [
        f"{_quote_ident(c)} text NOT NULL"
        if c in pk_set
        else f"{_quote_ident(c)} {t}"
        for c, t in column_types.items()
    ]
    cols += [
        f"{_quote_ident(base)} vector({int(d)})" for base, d in vector_dims.items()
    ]
    qualified = f"{_quote_ident(schema)}.{_quote_ident(table)}"
    stmts = ["CREATE EXTENSION IF NOT EXISTS vector;"] if vector_dims else []
    if replace:
        stmts.append(f"DROP TABLE IF EXISTS {qualified};")
    stmts.append(f"CREATE TABLE IF NOT EXISTS {qualified} ({', '.join(cols)});")
    if pk_cols:
        key = ", ".join(_quote_ident(c) for c in pk_cols)
        alter = (
            f"ALTER TABLE {qualified} ADD CONSTRAINT "
            f"{_quote_ident(f'{table}_pkey')} PRIMARY KEY ({key})"
        )
        # Postgres has no ADD CONSTRAINT IF NOT EXISTS: with replace=False
        # + CREATE TABLE IF NOT EXISTS the table (and its key) may already
        # exist, so swallow duplicate_object (constraint name exists) and
        # invalid_table_definition (table already has a primary key) —
        # the re-run/append path must not abort on an already-keyed table.
        stmts.append(
            "DO $$ BEGIN "
            f"{alter}; "
            "EXCEPTION WHEN duplicate_object OR invalid_table_definition "
            "THEN NULL; END $$;"
        )
    return stmts


def _csv_field(v) -> str:
    # np.floating included: ETL chunks are float32 and an f32 NaN must land
    # as NULL exactly like an f64 one
    if v is None or (isinstance(v, (float, np.floating)) and np.isnan(v)):
        return "\\N"
    if isinstance(v, (bool, np.bool_)):
        return "t" if v else "f"
    s = str(v)
    if any(ch in s for ch in (",", '"', "\n", "\r")):
        s = '"' + s.replace('"', '""') + '"'
    return s


def vector_literal(vec: Iterable[float]) -> str:
    """pgvector input literal: '[v1,v2,...]' (database_connector.py:105)."""
    return "[" + ",".join(repr(float(x)) for x in vec) + "]"


def _chunk_layout(chunk: Mapping[str, np.ndarray]):
    """(scalar_cols, emb_groups {base: ordered col names}, array_cols
    {name: dims}).

    Vector columns arrive in either shape: the upstream wide
    ``{base}_emb000..NNN`` scalar groups (upload_database.py:198-232) or
    this framework's native 2-D ``[N, D]`` blocks (etl/pipeline.py stores
    embeddings as fixed-size-list parquet columns)."""
    names = list(chunk)
    array_cols = {
        c: int(chunk[c].shape[1])
        for c in names
        if getattr(chunk[c], "ndim", 1) == 2
    }
    scalar_cols, emb_groups = collapse_embedding_columns(
        [c for c in names if c not in array_cols]
    )
    overlap = set(emb_groups) & set(array_cols)
    if overlap:
        raise ValueError(f"columns are both emb-group and 2-D array: {overlap}")
    return scalar_cols, emb_groups, array_cols


def _block_literals(block: np.ndarray) -> list[str]:
    """Per-row quoted pgvector literals for a [N, D] float block, formatted
    columnar in C (%.9g round-trips float32 exactly) instead of a Python
    loop per element — chunks are 50k rows x 768 dims.

    Rows containing any non-finite value become NULL (``\\N``): pgvector
    rejects 'nan'/'inf' literals and one bad row would abort the whole
    COPY, so match the upstream NULL-on-non-finite behavior
    (upload_database.py _collapse_embeddings)."""
    block = block.astype(np.float64)
    finite = np.all(np.isfinite(block), axis=1)
    strs = np.char.mod("%.9g", block)
    return [
        '"[' + ",".join(row) + ']"' if ok else "\\N"
        for row, ok in zip(strs, finite)
    ]


def _chunk_csv(
    chunk: Mapping[str, np.ndarray],
    scalar_cols: Sequence[str],
    emb_groups: Mapping[str, Sequence[str]],
    array_cols: Mapping[str, int],
) -> str:
    n = len(next(iter(chunk.values())))
    columns: list[list[str]] = [
        [_csv_field(v) for v in chunk[c]] for c in scalar_cols
    ]
    for base, group_cols in emb_groups.items():
        block = np.column_stack([chunk[c] for c in group_cols])
        columns.append(_block_literals(block))
    for name in array_cols:
        columns.append(_block_literals(np.asarray(chunk[name])))
    lines = [",".join(fields) for fields in zip(*columns)] if columns else []
    assert len(lines) == n
    return "\n".join(lines) + "\n"


class PreprocessedUploader:
    """Chunked COPY upload of a preprocessed table (see module docstring).

    Usage::

        up = PreprocessedUploader(conn, schema="public")
        for chunk in transform_chunks(...):   # {col: np.ndarray} dicts
            up.upload_chunk("notice_preprocessed", chunk)
        up.commit()
    """

    def __init__(
        self,
        conn,
        *,
        schema: str = "public",
        replace: bool = True,
        pk_cols: Sequence[str] = (),
    ):
        self.conn = conn
        self.schema = schema
        self.replace = replace
        self.pk_cols = tuple(pk_cols)
        self._created: set[str] = set()
        self._layout: dict[str, tuple[list[str], dict[str, int]]] = {}

    def upload_chunk(self, table: str, chunk: Mapping[str, np.ndarray]) -> int:
        """First chunk creates (or replaces) the table; every chunk COPYes."""
        cur = self.conn.cursor()
        chunk = {k: np.asarray(v) for k, v in chunk.items()}
        if table not in self._created:
            scalar_cols, emb_groups, array_cols = _chunk_layout(chunk)
            types = {c: infer_pg_type(chunk[c]) for c in scalar_cols}
            vector_dims = {
                **{b: len(cols) for b, cols in emb_groups.items()},
                **array_cols,
            }
            missing_pks = [c for c in self.pk_cols if c not in types]
            if missing_pks:
                # a typo'd/mis-cased pk would silently create a keyless
                # table, defeating the text-PK/PRIMARY-KEY contract
                raise ValueError(
                    f"pk_cols {missing_pks} not among the chunk's scalar "
                    f"columns {sorted(types)}"
                )
            for stmt in build_create_preprocessed(
                self.schema, table, types, vector_dims, replace=self.replace,
                pk_cols=self.pk_cols,
            ):
                cur.execute(stmt)
            self._created.add(table)
            self._layout[table] = (scalar_cols, emb_groups, array_cols)
        scalar_cols, emb_groups, array_cols = self._layout[table]
        cols = ", ".join(
            _quote_ident(c)
            for c in [*scalar_cols, *emb_groups.keys(), *array_cols.keys()]
        )
        copy_sql = (
            f"COPY {_quote_ident(self.schema)}.{_quote_ident(table)} ({cols}) "
            "FROM STDIN WITH (FORMAT csv, DELIMITER ',', NULL '\\N', "
            "QUOTE '\"', ESCAPE '\"')"
        )
        payload = _chunk_csv(chunk, scalar_cols, emb_groups, array_cols)
        with cur.copy(copy_sql) as copy:
            copy.write(payload)
        return payload.count("\n")

    def commit(self) -> None:
        self.conn.commit()


def execute_vector_update(
    conn,
    *,
    schema: str,
    table: str,
    pk_cols: Sequence[str],
    vec_col: str,
    rows: Iterable[tuple],
    dims: int,
    temp_table: str = "tmp_vec",
    ensure_column: bool = True,
) -> int:
    """Bulk vector UPDATE: DDL (optional) + COPY-into-temp + UPDATE-JOIN in
    one transaction. ``rows`` yields (*pk_values, vector) tuples. Executes
    the statements etl/sql.py builds (upstream
    database_connector.py:85-131); returns the number of rows streamed."""
    cur = conn.cursor()
    if ensure_column:
        for stmt in build_pgvector_ddl(schema, table, vec_col, dims):
            cur.execute(stmt)
    stmts = build_vector_update(
        schema, table, pk_cols, vec_col, dims, temp_table=temp_table
    )
    cur.execute(stmts["create_temp"])
    n = 0
    with cur.copy(stmts["copy"]) as copy:
        for row in rows:
            *pks, vec = row
            fields = [_csv_field(p) for p in pks]
            vals = np.asarray(list(vec), dtype=np.float64)
            # NULL-on-non-finite, same contract as _block_literals
            if np.all(np.isfinite(vals)):
                fields.append('"' + vector_literal(vals) + '"')
            else:
                fields.append("\\N")
            copy.write(",".join(fields) + "\n")
            n += 1
    cur.execute(stmts["update"])
    conn.commit()
    return n
