"""Parquet dataset layout, the data plane (port of
``jodalrob_twotower_tpu/data/parquet_dataset.py``):

  <dir>/schema.json        TwoTowerSchema
  <dir>/notice.parquet     notice FeatureStore (wide columns)
  <dir>/company.parquet    company FeatureStore
  <dir>/pairs.parquet      positive pairs as (notice_key, company_key)

Pairs are stored by key, not row, so the stores can be rebuilt or filtered
on their own; loading joins the keys to store rows, and a pair whose key is
missing is dropped (or, with ``on_missing="error"``, raises ``KeyError``).
The files are the reference's: either package reads what the other wrote.
pyarrow is imported inside the functions only (the card machine has none):
without it they raise ``ImportError`` naming it.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from jodalrob_twotower_torch.data.feature_store import FeatureStore
from jodalrob_twotower_torch.schema import TwoTowerSchema


def save_pairs_parquet(path: str | Path, notice_keys: np.ndarray, company_keys: np.ndarray) -> None:
    import pyarrow as pa
    import pyarrow.parquet as pq

    pq.write_table(
        pa.table(
            {
                "notice_key": pa.array(np.asarray(notice_keys).astype(str)),
                "company_key": pa.array(np.asarray(company_keys).astype(str)),
            }
        ),
        str(path),
    )


def load_pairs_parquet(
    path: str | Path,
    notice_store: FeatureStore,
    company_store: FeatureStore,
    *,
    on_missing: str = "drop",
) -> np.ndarray:
    """Load pairs and join them to store rows -> int64 [P, 2].
    ``on_missing``: "drop" (the default) or "error"."""
    import pyarrow.parquet as pq

    tbl = pq.read_table(str(path))
    n_keys = tbl.column("notice_key").to_pylist()
    c_keys = tbl.column("company_key").to_pylist()
    n_map = notice_store.key_to_row
    c_map = company_store.key_to_row
    rows = np.empty((len(n_keys), 2), dtype=np.int64)
    kept = 0
    for nk, ck in zip(n_keys, c_keys):
        ni = n_map.get(nk)
        ci = c_map.get(ck)
        if ni is None or ci is None:
            if on_missing == "error":
                raise KeyError(f"pair references missing key: ({nk!r}, {ck!r})")
            continue
        rows[kept] = (ni, ci)
        kept += 1
    return rows[:kept]


def save_dataset(
    directory: str | Path,
    schema: TwoTowerSchema,
    notice_store: FeatureStore,
    company_store: FeatureStore,
    pairs_rows: np.ndarray,
) -> Path:
    """Write the whole layout (the pairs by the stores' keys)."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    schema.to_json(d / "schema.json")
    notice_store.to_parquet(d / "notice.parquet")
    company_store.to_parquet(d / "company.parquet")
    save_pairs_parquet(
        d / "pairs.parquet",
        notice_store.keys[pairs_rows[:, 0]],
        company_store.keys[pairs_rows[:, 1]],
    )
    return d


def load_dataset(directory: str | Path) -> tuple[TwoTowerSchema, FeatureStore, FeatureStore, np.ndarray]:
    """(schema, notice store, company store, pairs) of a layout directory,
    read as the reference's train and eval CLIs read it."""
    d = Path(directory)
    schema = TwoTowerSchema.from_json(d / "schema.json")
    notice_store = FeatureStore.from_parquet(schema.notice, d / "notice.parquet")
    company_store = FeatureStore.from_parquet(schema.company, d / "company.parquet")
    return schema, notice_store, company_store, load_pairs_parquet(d / "pairs.parquet", notice_store, company_store)
