"""Host-side column-major feature store (port of
``jodalrob_twotower_tpu/data/feature_store.py``).

Contiguous per-side matrices (the dense block is numeric ++ text embeddings,
pre-concatenated so batch assembly is one row gather) plus a key -> row map.
``gather`` uses numpy indexing under the reference's contract: rows must lie
in [0, n), anything else raises ``IndexError`` (the reference's native
multithreaded gather is not part of the port; its bounds check is).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np

from jodalrob_twotower_torch.data.types import TowerBatch
from jodalrob_twotower_torch.schema import SideSchema


def check_rows(rows, n_src_rows: int) -> np.ndarray:
    """``rows`` as contiguous int64, which must lie in [0, n_src_rows): a
    negative row would silently read from the end, so one contract holds
    for every gather (reference ``native._check_bounds``, with its message)."""
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    if rows.size and (rows.min() < 0 or rows.max() >= n_src_rows):
        raise IndexError(
            f"row indices out of bounds for source with {n_src_rows} rows "
            f"(min {rows.min()}, max {rows.max()}; negatives not allowed)"
        )
    return rows


@dataclasses.dataclass
class FeatureStore:
    """All features for one side, resident in host memory.

    dense: float32 [N, dense_dim] = numeric columns ++ text-embedding blocks,
        in schema order.
    cat_ids: int32 [N, K] - label-encoded categorical ids, schema order.
    keys: object/str array [N] - primary keys (composite PKs joined with '|').
    """

    schema: SideSchema
    dense: np.ndarray
    cat_ids: np.ndarray
    keys: np.ndarray

    def __post_init__(self) -> None:
        n = self.dense.shape[0]
        if self.cat_ids.shape != (n, self.schema.num_categorical):
            raise ValueError(
                f"cat_ids shape {self.cat_ids.shape} != ({n}, {self.schema.num_categorical})"
            )
        if self.dense.shape[1] != self.schema.dense_dim:
            raise ValueError(f"dense width {self.dense.shape[1]} != schema {self.schema.dense_dim}")
        if len(self.keys) != n:
            raise ValueError("keys length mismatch")
        self.dense = np.ascontiguousarray(self.dense, dtype=np.float32)
        self.cat_ids = np.ascontiguousarray(self.cat_ids, dtype=np.int32)
        self._key_to_row: dict | None = None

    def __len__(self) -> int:
        return self.dense.shape[0]

    @property
    def key_to_row(self) -> dict:
        if self._key_to_row is None:
            self._key_to_row = {k: i for i, k in enumerate(self.keys.tolist())}
        return self._key_to_row

    def rows_for_keys(self, keys: Sequence) -> np.ndarray:
        m = self.key_to_row
        return np.fromiter((m[k] for k in keys), dtype=np.int64, count=len(keys))

    def gather(self, rows: np.ndarray) -> TowerBatch:
        """Assemble a host TowerBatch for the given row indices, each in [0, n)."""
        rows = check_rows(rows, len(self))
        return TowerBatch(dense=self.dense[rows], cat_ids=self.cat_ids[rows])

    @classmethod
    def from_columns(
        cls,
        schema: SideSchema,
        *,
        numeric: Mapping[str, np.ndarray] | np.ndarray | None,
        categorical: Mapping[str, np.ndarray] | np.ndarray | None,
        text: Mapping[str, np.ndarray] | None = None,
        keys: np.ndarray | None = None,
    ) -> "FeatureStore":
        """Build from per-column (or pre-stacked) arrays, in schema order."""
        def stack(block, names, dtype):
            if block is None:
                return None
            if isinstance(block, np.ndarray):
                return np.asarray(block, dtype=dtype)
            cols = [np.asarray(block[n], dtype=dtype).reshape(len(block[n]), -1) for n in names]
            return np.concatenate(cols, axis=1) if cols else None

        num = stack(numeric, schema.numeric_names, np.float32)
        cat = stack(categorical, schema.categorical_names, np.int32)
        txt_blocks = []
        if schema.text:
            if text is None:
                raise ValueError("schema has text features but no text arrays given")
            for t in schema.text:
                arr = np.asarray(text[t.name], dtype=np.float32)
                if arr.shape[1] != t.embed_dim:
                    raise ValueError(f"text {t.name}: dim {arr.shape[1]} != {t.embed_dim}")
                txt_blocks.append(arr)
        n = next(x.shape[0] for x in (num, cat, *txt_blocks) if x is not None)
        if num is None:
            num = np.zeros((n, 0), dtype=np.float32)
        if cat is None:
            cat = np.zeros((n, 0), dtype=np.int32)
        dense = np.concatenate([num, *txt_blocks], axis=1) if txt_blocks else num
        if keys is None:
            keys = np.arange(n).astype(str)
        return cls(schema=schema, dense=dense, cat_ids=cat, keys=np.asarray(keys))

    # -- parquet io (pyarrow is imported only here; the card machine has none)
    def to_parquet(self, path: str | Path) -> None:
        """Write the store as a single parquet file (wide columns)."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        arrays: dict[str, pa.Array] = {"__key__": pa.array(self.keys.astype(str))}
        nn = self.schema.num_numeric
        for i, name in enumerate(self.schema.numeric_names):
            arrays[name] = pa.array(self.dense[:, i])
        off = nn
        for t in self.schema.text:
            block = self.dense[:, off : off + t.embed_dim]
            arrays[t.name] = pa.array(list(block), type=pa.list_(pa.float32(), t.embed_dim))
            off += t.embed_dim
        for j, name in enumerate(self.schema.categorical_names):
            arrays[name] = pa.array(self.cat_ids[:, j])
        pq.write_table(pa.table(arrays), str(path))

    @classmethod
    def from_parquet(cls, schema: SideSchema, path: str | Path) -> "FeatureStore":
        import pyarrow.parquet as pq

        tbl = pq.read_table(str(path))
        n = tbl.num_rows
        num = np.empty((n, schema.num_numeric), dtype=np.float32)
        for i, name in enumerate(schema.numeric_names):
            num[:, i] = tbl.column(name).to_numpy(zero_copy_only=False)
        cat = np.empty((n, schema.num_categorical), dtype=np.int32)
        for j, name in enumerate(schema.categorical_names):
            cat[:, j] = tbl.column(name).to_numpy(zero_copy_only=False)
        text = {
            t.name: np.stack(tbl.column(t.name).to_numpy(zero_copy_only=False)).astype(np.float32)
            for t in schema.text
        }
        keys = np.asarray(tbl.column("__key__").to_pylist())
        return cls.from_columns(schema, numeric=num, categorical=cat, text=text or None, keys=keys)
