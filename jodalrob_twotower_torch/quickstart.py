"""Quickstart: the whole lifecycle in one script (port of
``examples/quickstart.py``): ``python -m jodalrob_twotower_torch.quickstart``.

raw tables -> ETL -> feature stores -> training (+ checkpoints, ledger)
-> evaluation (in-batch + corpus) -> serving (int8 MIPS top-k).

Runs on the card, or on the CPU with ``--force-cpu``. ``QUICKSTART_FAST=1``
in the environment shrinks the run (400 rows, 2 epochs) for tests. The data
and the printed lines are the JAX script's. The ETL writes its parquet
chunks and manifests into the work directory when ``pyarrow`` imports, and
otherwise (the card machine has no ``pyarrow``) runs the same fit and
transforms in memory (``etl.pipeline.preprocess_in_memory``).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

from jodalrob_twotower_torch.config import (
    DataConfig,
    LossConfig,
    ModelConfig,
    OptimizerConfig,
    TrainConfig,
)
from jodalrob_twotower_torch.etl.pipeline import preprocess_in_memory, run_pipeline
from jodalrob_twotower_torch.etl.text import HashTextEmbedder
from jodalrob_twotower_torch.etl.to_feature_store import (
    feature_store_from_columns,
    feature_store_from_pipeline,
    side_schema_from_manifest_dict,
)
from jodalrob_twotower_torch.schema import TwoTowerSchema
from jodalrob_twotower_torch.serving.service import FrozenState, RetrievalService
from jodalrob_twotower_torch.train.trainer import Trainer

BATCH_SIZE = 128


def sizes(fast: bool) -> dict:
    """Rows per table, clusters, held-out pairs and epochs of a run."""
    n_rows, n_clusters = (400, 8) if fast else (2000, 16)
    return {"rows": n_rows, "clusters": n_clusters, "val": 60 if fast else 300, "epochs": 2 if fast else 6}


def _has_pyarrow() -> bool:
    try:
        import pyarrow  # noqa: F401
    except ImportError:
        return False
    return True


def etl(name: str, table: dict, workdir: Path, on_disk: bool):
    """(side schema, feature store) of one raw table, through the files
    (``run_pipeline`` + ``feature_store_from_pipeline``) or in memory."""
    kw = dict(
        pk_columns=["id"],
        numeric_columns=["price"],
        categorical_columns=["region", "category"],
        text_columns=["title"],
        numeric_configs={"price": {"fill": "median", "clip_percentiles": (1, 99), "scale": "zscore"}},
        text_embedder=HashTextEmbedder(64),  # swap for HFTextEmbedder() with a real model
    )
    if on_disk:
        manifest = run_pipeline(name, [table], workdir, **kw)
        schema, store = feature_store_from_pipeline(workdir, name)
    else:
        manifest, columns = preprocess_in_memory(name, [table], **kw)
        schema = side_schema_from_manifest_dict(manifest)
        store = feature_store_from_columns(schema, columns)
    print(f"ETL {name}: {manifest['rows']} rows, vocabs {manifest['categorical_input_dims']}")
    return schema, store


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="raw tables -> ETL -> training -> serving, in one run")
    p.add_argument("--workdir", default=None, help="work directory (default: a new temporary one)")
    p.add_argument("--force-cpu", action="store_true", help="run on the CPU instead of the card")
    args = p.parse_args(argv)
    device = "cpu" if args.force_cpu else None
    workdir = Path(args.workdir) if args.workdir else Path(tempfile.mkdtemp(prefix="twotower_quickstart_"))
    workdir.mkdir(parents=True, exist_ok=True)
    print(f"workdir: {workdir}")

    # --- 1. raw tables (stand-ins for the PostgreSQL notice/company tables) ----
    size = sizes(os.environ.get("QUICKSTART_FAST") == "1")
    rng = np.random.default_rng(0)
    n_rows, n_clusters = size["rows"], size["clusters"]
    n_cluster = rng.integers(0, n_clusters, n_rows)
    c_cluster = rng.integers(0, n_clusters, n_rows)

    def raw_table(prefix: str, cluster: np.ndarray) -> dict:
        price = cluster * 7.0 + rng.normal(0, 1, n_rows)
        price[::37] = np.nan
        return {
            "id": np.asarray([f"{prefix}{i}" for i in range(n_rows)], object),
            "price": price,
            "region": np.asarray([f"region_{c % 5}" for c in cluster], object),
            "category": np.asarray([f"cat_{c}" for c in cluster], object),
            "title": np.asarray([f"{prefix} work package {c}" for c in cluster], object),
        }

    # --- 2. offline ETL: fit stats/vocabs, transform (and write parquet) ---------
    # --- 3. feature stores + schema from the ETL outputs ------------------------
    on_disk = _has_pyarrow()
    n_schema, n_store = etl("notice", raw_table("notice", n_cluster), workdir, on_disk)
    c_schema, c_store = etl("company", raw_table("company", c_cluster), workdir, on_disk)
    schema = TwoTowerSchema(notice=n_schema, company=c_schema)

    # positive pairs: same-cluster notice->company
    pairs = np.asarray(
        [
            (ni, rng.choice(np.flatnonzero(c_cluster == n_cluster[ni])))
            for ni in range(n_rows)
        ],
        np.int64,
    )
    perm = rng.permutation(len(pairs))
    n_val = size["val"]
    train_pairs, val_pairs = pairs[perm[n_val:]], pairs[perm[:n_val]]

    # --- 4. train --------------------------------------------------------------
    cfg = TrainConfig(
        model=ModelConfig(
            categorical_embedding_dim=16,
            dense_projection_dim=32,
            tower_hidden_dims=(64, 32),
            final_embedding_dim=32,
            dropout_rate=0.0,
            compute_dtype="float32",
        ),
        loss=LossConfig(temperature=0.1),
        optimizer=OptimizerConfig(learning_rate=3e-3, num_epochs=size["epochs"]),
        data=DataConfig(batch_size=BATCH_SIZE),
        results_csv=str(workdir / "train_results.csv"),
    )
    trainer = Trainer(cfg, schema, n_store, c_store, device=device)
    result = trainer.train(train_pairs, val_pairs, checkpoint_dir=workdir / "ckpt")

    # --- 5. serve: int8 MIPS top-k over the company corpus ---------------------
    svc = RetrievalService(trainer.model, cfg, FrozenState(result.state.state_dict), c_store,
                           index_kind="int8", device=device)
    query = n_store.gather(val_pairs[:3, 0])
    for q, hits in zip(val_pairs[:3, 0], svc.search_keys(query, k=5)):
        positive = c_store.keys[val_pairs[np.flatnonzero(val_pairs[:, 0] == q)[0], 1]]
        print(f"notice {n_store.keys[q]} (true match {positive}): top-5 {hits}")

    print(f"done — checkpoints in {workdir / 'ckpt'}, ledger in {cfg.results_csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
