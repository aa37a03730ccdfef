"""PostgreSQL access shim (optional) + pure SQL query building (port of
``jodalrob_twotower_tpu/etl/sql.py``; ``sqlalchemy`` is imported only inside
``DatabaseConnector``).

Capability parity with the upstream L0 (data/database_connector.py,
data/query_helper.py): engine from env vars, used-column SELECT building
driven by the metadata schema, chunked streaming reads, PK lookups, and a
table -> parquet export that feeds the framework's parquet data plane.

The framework's data plane is parquet; this shim exists so
users coming from the upstream can pull their notice/company/pair tables
out of PostgreSQL once. SQLAlchemy/psycopg are NOT required by anything
else and import lazily here; query *construction* is pure string logic and
fully testable without a database.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterable, Iterator, Mapping, Sequence

import numpy as np

# Reference PK map (data/query_helper.py:23-27).
DEFAULT_PK = {
    "notice": ("bidntceno", "bidntceord"),
    "company": ("bizno",),
    "bid_two_tower": ("bidntceno", "bidntceord", "bizno"),
}


def _quote_ident(name: str) -> str:
    if not name.replace("_", "").isalnum():
        raise ValueError(f"unsafe SQL identifier: {name!r}")
    return f'"{name}"'


def build_select(
    table: str,
    columns: Sequence[str],
    *,
    where: str | None = None,
    order_by: Sequence[str] = (),
    limit: int | None = None,
    offset: int | None = None,
) -> str:
    """Used-column SELECT (upstream query_helper.py:33,70 capability)."""
    cols = ", ".join(_quote_ident(c) for c in columns) if columns else "*"
    sql = f"SELECT {cols} FROM {_quote_ident(table)}"
    if where:
        sql += f" WHERE {where}"
    if order_by:
        sql += " ORDER BY " + ", ".join(_quote_ident(c) for c in order_by)
    if limit is not None:
        sql += f" LIMIT {int(limit)}"
    if offset is not None:
        sql += f" OFFSET {int(offset)}"
    return sql


def build_pk_lookup(table: str, pk_columns: Sequence[str], n_keys: int) -> str:
    """Parameterized WHERE-IN over (composite) PKs (query_helper.py:91)."""
    if len(pk_columns) == 1:
        placeholders = ", ".join(["%s"] * n_keys)
        return (
            f"SELECT * FROM {_quote_ident(table)} "
            f"WHERE {_quote_ident(pk_columns[0])} IN ({placeholders})"
        )
    tuple_ph = "(" + ", ".join(["%s"] * len(pk_columns)) + ")"
    placeholders = ", ".join([tuple_ph] * n_keys)
    pk = "(" + ", ".join(_quote_ident(c) for c in pk_columns) + ")"
    return f"SELECT * FROM {_quote_ident(table)} WHERE {pk} IN ({placeholders})"


def build_bid_participants(
    *,
    bid_table: str = "bid_two_tower",
    company_table: str = "company",
    company_columns: Sequence[str] = (),
    pk: Mapping[str, Sequence[str]] = DEFAULT_PK,
) -> str:
    """Companies that bid on one notice (upstream query_helper.py:219-250).

    Parameterized (%s placeholders for bidntceno, bidntceord) instead of the
    upstream f-string interpolation — same capability, injection-safe.
    """
    bid_pk = pk[bid_table if bid_table in pk else "bid_two_tower"]
    company_pk = pk[company_table if company_table in pk else "company"]
    cols = (
        ", ".join(f"c.{_quote_ident(c)}" for c in company_columns)
        if company_columns
        else "c.*"
    )
    return (
        f"SELECT {cols} FROM {_quote_ident(bid_table)} b "
        f"LEFT JOIN {_quote_ident(company_table)} c "
        f"ON b.{_quote_ident(bid_pk[2])} = c.{_quote_ident(company_pk[0])} "
        f"WHERE b.{_quote_ident(bid_pk[0])} = %s AND b.{_quote_ident(bid_pk[1])} = %s"
    )


def build_company_bid_history(
    *,
    bid_table: str = "bid_two_tower",
    notice_table: str = "notice",
    notice_columns: Sequence[str] = ("bidnm", "rgstdt"),
    order_by: str = "rgstdt",
    limit: int = 100,
    pk: Mapping[str, Sequence[str]] = DEFAULT_PK,
) -> str:
    """One company's bid history, newest first (query_helper.py:252-283).

    Parameterized on the company id (%s for bizno)."""
    bid_pk = pk[bid_table if bid_table in pk else "bid_two_tower"]
    notice_pk = pk[notice_table if notice_table in pk else "notice"]
    n_cols = ", ".join(f"n.{_quote_ident(c)}" for c in notice_columns)
    join = " AND ".join(
        f"b.{_quote_ident(b)} = n.{_quote_ident(n)}"
        for b, n in zip(bid_pk[:2], notice_pk)
    )
    return (
        f"SELECT b.{_quote_ident(bid_pk[0])}, b.{_quote_ident(bid_pk[1])}, {n_cols} "
        f"FROM {_quote_ident(bid_table)} b "
        f"LEFT JOIN {_quote_ident(notice_table)} n ON {join} "
        f"WHERE b.{_quote_ident(bid_pk[2])} = %s "
        f"ORDER BY n.{_quote_ident(order_by)} DESC LIMIT {int(limit)}"
    )


def build_pgvector_ddl(schema: str, table: str, vec_col: str, dims: int) -> list[str]:
    """Statements ensuring the pgvector extension + a vector column exist
    (upstream database_connector.py:85-92 ensure_pgvector_and_column)."""
    return [
        "CREATE EXTENSION IF NOT EXISTS vector;",
        f"ALTER TABLE {_quote_ident(schema)}.{_quote_ident(table)} "
        f"ADD COLUMN IF NOT EXISTS {_quote_ident(vec_col)} vector({int(dims)});",
    ]


def build_vector_update(
    schema: str,
    table: str,
    pk_cols: Sequence[str],
    vec_col: str,
    dims: int,
    *,
    temp_table: str = "tmp_vec",
) -> dict[str, str]:
    """The COPY-into-temp + UPDATE-JOIN statements for bulk vector writes
    (upstream database_connector.py:94-131 copy_temp_and_update_vector):
    {'create_temp', 'copy', 'update'} to run in one transaction, streaming
    the PK+vector rows as CSV through the COPY."""
    tmp = _quote_ident(temp_table)
    pk_defs = ", ".join(f"{_quote_ident(c)} text" for c in pk_cols)
    cols_csv = ", ".join(_quote_ident(c) for c in [*pk_cols, vec_col])
    on_clause = " AND ".join(
        f"t.{_quote_ident(c)} = s.{_quote_ident(c)}" for c in pk_cols
    )
    return {
        "create_temp": (
            f"CREATE TEMP TABLE {tmp} ({pk_defs}, "
            f"{_quote_ident(vec_col)} vector({int(dims)}));"
        ),
        "copy": (
            f"COPY {tmp} ({cols_csv}) FROM STDIN WITH "
            "(FORMAT csv, DELIMITER ',', NULL '\\N', QUOTE '\"', ESCAPE '\"')"
        ),
        "update": (
            f"UPDATE {_quote_ident(schema)}.{_quote_ident(table)} AS t "
            f"SET {_quote_ident(vec_col)} = s.{_quote_ident(vec_col)} "
            f"FROM {tmp} AS s WHERE {on_clause};"
        ),
    }


def connection_url(env: Mapping[str, str] | None = None) -> str:
    """postgres URL from the upstream env-var surface
    (database_connector.py:14-44): DB_HOST/DB_PORT/DB_NAME/DB_USER/DB_PASSWORD."""
    from urllib.parse import quote

    env = env if env is not None else os.environ
    host = env.get("DB_HOST", "localhost")
    port = env.get("DB_PORT", "5432")
    name = env.get("DB_NAME", "postgres")
    # credentials must be percent-encoded: a password containing @ : / # %
    # would otherwise be parsed as URL structure (the '@' splits the host)
    user = quote(env.get("DB_USER", "postgres"), safe="")
    password = quote(env.get("DB_PASSWORD", ""), safe="")
    auth = f"{user}:{password}@" if password else f"{user}@"
    return f"postgresql+psycopg://{auth}{host}:{port}/{name}"


class DatabaseConnector:
    """Lazy SQLAlchemy engine with chunked reads (optional dependency)."""

    def __init__(self, url: str | None = None, *, pool_pre_ping: bool = True):
        try:
            import sqlalchemy
        except ImportError as e:
            raise ImportError(
                "the SQL shim needs sqlalchemy + a postgres driver "
                "(pip install sqlalchemy psycopg) - the rest of the framework "
                "does not; use the parquet data plane instead"
            ) from e
        self._sa = sqlalchemy
        self.engine = sqlalchemy.create_engine(
            url or connection_url(), pool_pre_ping=pool_pre_ping, pool_recycle=1800
        )

    def iter_chunks(
        self, sql: str, *, chunk_rows: int = 50_000
    ) -> Iterator[dict[str, np.ndarray]]:
        """Stream a query as column dicts (upstream
        database_connector.py:81 chunked iteration)."""
        with self.engine.connect() as conn:
            result = conn.execution_options(yield_per=chunk_rows).execute(
                self._sa.text(sql)
            )
            keys = list(result.keys())
            for partition in result.partitions(chunk_rows):
                rows = list(partition)
                yield {
                    k: np.asarray([r[i] for r in rows], dtype=object)
                    for i, k in enumerate(keys)
                }

    def export_table_to_parquet(
        self,
        table: str,
        columns: Sequence[str],
        out_path: str | Path,
        *,
        chunk_rows: int = 50_000,
        where: str | None = None,
    ) -> int:
        """table -> single parquet file via chunked reads (replaces the
        upstream convert_to_parquet.py against the new data plane)."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        sql = build_select(table, columns, where=where)
        writer = None
        total = 0
        try:
            for chunk in self.iter_chunks(sql, chunk_rows=chunk_rows):
                tbl = pa.table({k: pa.array(v.tolist()) for k, v in chunk.items()})
                if writer is None:
                    writer = pq.ParquetWriter(str(out_path), tbl.schema)
                writer.write_table(tbl)
                total += tbl.num_rows
        finally:
            if writer is not None:
                writer.close()
        return total

    def pg_connection(self):
        """A pooled DBAPI connection for COPY-based write-back
        (etl/pg_writeback.py). Returns the pool PROXY, not the bare
        psycopg3 connection: the proxy delegates cursor()/commit() to the
        driver (whose cursors expose ``copy``), and it must stay referenced
        for the whole write-back — dropping it would let the pool's
        finalizer check the underlying connection back in (reset/rollback)
        while the COPY is still streaming. Call ``.close()`` when done to
        return it to the pool."""
        return self.engine.raw_connection()

    def upload_preprocessed(
        self,
        table: str,
        chunks: Iterable[Mapping[str, np.ndarray]],
        *,
        schema: str = "public",
        replace: bool = True,
        pk_cols: Sequence[str] = (),
    ) -> int:
        """EXECUTE the preprocessed-table write-back: create
        ``{table}_preprocessed``-style tables with inferred types +
        collapsed pgvector columns (PKs as text NOT NULL + PRIMARY KEY),
        COPY every chunk (upstream upload_database.py:64-102; logic in
        etl/pg_writeback.py)."""
        from jodalrob_twotower_torch.etl.pg_writeback import PreprocessedUploader

        conn = self.pg_connection()
        try:
            up = PreprocessedUploader(
                conn, schema=schema, replace=replace, pk_cols=pk_cols
            )
            total = 0
            for chunk in chunks:
                total += up.upload_chunk(table, chunk)
            up.commit()
            return total
        finally:
            conn.close()

    def update_text_vectors(
        self,
        *,
        schema: str,
        table: str,
        pk_cols: Sequence[str],
        vec_col: str,
        rows: Iterable[tuple],
        dims: int,
    ) -> int:
        """EXECUTE the incremental text-vector UPDATE (upstream
        text_vector_updator.py:34-51 + database_connector.py:94-131)."""
        from jodalrob_twotower_torch.etl.pg_writeback import execute_vector_update

        conn = self.pg_connection()
        try:
            return execute_vector_update(
                conn, schema=schema, table=table, pk_cols=pk_cols,
                vec_col=vec_col, rows=rows, dims=dims,
            )
        finally:
            conn.close()

    def export_table_to_parquet_chunks(
        self,
        table: str,
        columns: Sequence[str],
        out_dir: str | Path,
        *,
        chunk_rows: int = 50_000,
        rows_per_file: int | None = None,
        where: str | None = None,
    ) -> dict:
        """table -> ``chunk_%04d.parquet`` dataset + metadata.json manifest
        (upstream convert_to_parquet.py:140-180 multi-file mode). Returns
        the manifest; reload with etl.parquet_chunks.load_parquet_chunks."""
        from jodalrob_twotower_torch.etl.parquet_chunks import write_parquet_chunks

        sql = build_select(table, columns, where=where)
        return write_parquet_chunks(
            self.iter_chunks(sql, chunk_rows=chunk_rows),
            out_dir,
            table_name=table,
            rows_per_file=rows_per_file,
        )
