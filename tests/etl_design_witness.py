"""Why the card's ``etl`` phase plants its numeric columns as it does: the
JAX package's ``Trainer`` and the port's ``Trainer(device="cpu")`` trained
on the CPU on the phase's raw-table designs, at a reduced size, side by side.

The phase (``chip_smoke.etl_raw_tables``) gives every numeric column its
cluster's centroid coordinate (8-d centroids shared by both tables, cycled
over the columns) plus noise 1.0. Two designs before it learned less in the
phase's two epochs: every numeric column a per-column multiple of the
cluster number plus noise 1.0 ("ordinal"), and the centroids with noise 0.3.
This script trains both packages on each design, and on each with the
company table's one numeric column permuted across companies, so that the
company tower cannot read its cluster from a number. It prints one JSON
line per design and package: per-epoch train loss and corpus recall@100.

Both trainers run ``TrainConfig()``'s model, loss and optimizer (dropout
0.1, bf16 towers, temperature 1) from one flax init carried over by
``convert.py``; the JAX loss is the materialized one (``use_fused_logits``
off: its Pallas kernel is the TPU's). Reduced: 25,000 notices and
companies, 64 clusters (about 390 companies a cluster, as on the card),
100,000 pairs, B=2048, so that two epochs are 78 steps as on the card.
Run from the repository root::

    python tests/etl_design_witness.py [--designs ordinal noise0.3 ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from jodalrob_twotower_torch.config import TrainConfig as TTrainConfig  # noqa: E402
from jodalrob_twotower_torch.convert import flax_to_state_dict  # noqa: E402
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel as TTwoTowerModel  # noqa: E402
from jodalrob_twotower_torch.train import trainer as ttrainer  # noqa: E402
from jodalrob_twotower_torch.train.cli import split_pairs  # noqa: E402
from jodalrob_twotower_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from jodalrob_twotower_tpu.data.feature_store import FeatureStore as JFeatureStore  # noqa: E402
from jodalrob_twotower_tpu.data.pipeline import assemble_pair_batch  # noqa: E402
from jodalrob_twotower_tpu.models import build_model  # noqa: E402
from jodalrob_twotower_tpu.schema import TwoTowerSchema as JTwoTowerSchema  # noqa: E402
from jodalrob_twotower_tpu.train.train_step import create_train_state  # noqa: E402
from jodalrob_twotower_tpu.train.trainer import Trainer as JTrainer  # noqa: E402

N_ROWS, N_PAIRS, N_CLUSTERS, BATCH, EPOCHS = 25_000, 100_000, 64, 2048, 2
# design -> (numeric noise, ordinal numeric columns, company numeric permuted)
DESIGNS = {
    "ordinal": (1.0, True, False),
    "noise0.3": (0.3, False, False),
    "noise1.0": (1.0, False, False),
    "ordinal_company_numeric_permuted": (1.0, True, True),
    "noise0.3_company_numeric_permuted": (0.3, False, True),
    "noise1.0_company_numeric_permuted": (1.0, False, True),
}
PLANTED_TABLES = chip_smoke.etl_raw_tables


def design_tables(ordinal: bool, permute_company: bool):
    """``chip_smoke.etl_raw_tables`` with the design's numeric columns: for
    "ordinal", column values ``cluster * u + N(0, 1)`` with one ``u`` from
    [0.5, 2) per column (the clusters are the generator's first two draws,
    replayed here); the company's numeric columns permuted if asked."""

    def tables(metadata, n_notices, n_companies, n_pairs, seed=chip_smoke.SEED, n_categories=chip_smoke.ETL_CATEGORIES,
               n_clusters=chip_smoke.ETL_CLUSTERS):
        notice, company, pairs = PLANTED_TABLES(metadata, n_notices, n_companies, n_pairs, seed, n_categories,
                                                n_clusters)
        replay = np.random.default_rng(seed)
        clusters = {"notice": replay.integers(0, n_clusters, n_notices),
                    "company": replay.integers(0, n_clusters, n_companies)}
        rng = np.random.default_rng(seed + 1)
        for name, table in (("notice", notice), ("company", company)):
            for col in chip_smoke.classify_columns(name, metadata)["numeric"]:
                if ordinal:
                    x = clusters[name] * rng.uniform(0.5, 2.0) + rng.normal(0.0, 1.0, len(clusters[name]))
                    x[:: chip_smoke.ETL_NULL_EVERY] = np.nan
                    table[col] = x
                if name == "company" and permute_company:
                    table[col] = table[col][rng.permutation(len(table[col]))]
        return notice, company, pairs

    return tables


def train_both(data: dict) -> dict:
    """Per-epoch train loss and corpus recall@100 of both trainers on the
    ETL-built stores, from one flax init."""
    t_schema = data["schema"]
    j_schema = JTwoTowerSchema.from_dict(t_schema.to_dict())
    t_stores = [data[side]["store"] for side in ("notice", "company")]
    j_stores = [JFeatureStore(getattr(j_schema, side), s.dense, s.cat_ids, s.keys)
                for side, s in zip(("notice", "company"), t_stores)]
    t_cfg = TTrainConfig().replace(
        data=dataclasses.replace(TTrainConfig().data, batch_size=BATCH),
        optimizer=dataclasses.replace(TTrainConfig().optimizer, num_epochs=EPOCHS), results_csv="", seed=0)
    j_cfg = JTrainConfig().replace(
        data=dataclasses.replace(JTrainConfig().data, batch_size=BATCH),
        optimizer=dataclasses.replace(JTrainConfig().optimizer, num_epochs=EPOCHS),
        loss=dataclasses.replace(JTrainConfig().loss, use_fused_logits=False), results_csv="", seed=0)
    train_pairs, val_pairs = split_pairs(data["pairs"], t_cfg)
    out = {}
    t0 = time.perf_counter()
    example = assemble_pair_batch(*j_stores, train_pairs[:BATCH])
    init, _ = create_train_state(build_model(j_schema, j_cfg), j_cfg, jax.random.PRNGKey(j_cfg.seed), example, 8)
    params0, stats0 = jax.device_get(init.params), jax.device_get(init.batch_stats)
    res = JTrainer(j_cfg, j_schema, *j_stores, log_fn=lambda *_: None).train(
        train_pairs, val_pairs, corpus_eval=False, epoch_corpus_eval=True)
    out["jax"] = res.history, time.perf_counter() - t0
    start = flax_to_state_dict(TTwoTowerModel(t_schema, t_cfg.model), params0, stats0)
    init_flax = TTwoTowerModel.init_flax

    def init_from_flax(self, generator):
        self.load_state_dict(start)
        return self

    TTwoTowerModel.init_flax = init_from_flax
    try:
        t0 = time.perf_counter()
        res = ttrainer.Trainer(t_cfg, t_schema, *t_stores, device="cpu", log_fn=lambda *_: None).train(
            train_pairs, val_pairs, corpus_eval=False, epoch_corpus_eval=True)
        out["torch"] = res.history, time.perf_counter() - t0
    finally:
        TTwoTowerModel.init_flax = init_flax
    return {pkg: {"train_loss": [h["train_loss"] for h in hist], "val_loss": [h["val_loss"] for h in hist],
                  "corpus_recall@100": [h["corpus_recall@100"] for h in hist], "seconds": seconds}
            for pkg, (hist, seconds) in out.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--designs", nargs="+", choices=list(DESIGNS), default=list(DESIGNS))
    p.add_argument("--rows", type=int, default=N_ROWS)
    p.add_argument("--pairs", type=int, default=N_PAIRS)
    p.add_argument("--threads", type=int, default=4)
    args = p.parse_args(argv)
    torch.set_num_threads(args.threads)
    with tempfile.TemporaryDirectory(prefix="etl_design_witness_") as tmp:
        metadata = chip_smoke.etl_metadata_csv(Path(tmp) / "metadata.csv")
        for design in args.designs:
            noise, ordinal, permute_company = DESIGNS[design]
            chip_smoke.ETL_NUMERIC_NOISE = noise
            chip_smoke.etl_raw_tables = design_tables(ordinal, permute_company)
            try:
                data = chip_smoke.etl_stores(metadata, args.rows, args.rows, args.pairs, n_clusters=N_CLUSTERS)
            finally:
                chip_smoke.etl_raw_tables = PLANTED_TABLES
            for pkg, row in train_both(data).items():
                print(json.dumps({"design": design, "package": pkg, "rows": args.rows, "pairs": args.pairs,
                                  "clusters": N_CLUSTERS, "batch": BATCH, **row}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
