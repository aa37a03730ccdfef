"""BASELINE config 2, the migration workflow at the reference's scale:
``python -m jodalrob_twotower_torch.reference_scale_demo --meta DIR
[--rows N] [--pairs N] [--epochs N] [--batch-size B] [--workdir DIR]
[--force-cpu]`` (port of ``scripts/reference_scale_demo.py``).

The reference's metadata drives everything: the schema comes from
``DIR/metadata.csv`` (29 numeric, 32 categorical and the 768-d title text
block for notices; 1 numeric and 6 categorical for companies), the text
columns from ``DIR/notice_text_config.json``, and the numeric and
categorical configs of ``DIR/notice_numeric_config.json`` and
``DIR/notice_categorical_config.json`` load through ``etl/reference_configs``
(proof of their format; the features below are generated already encoded).
Synthetic stores with planted clusters on that schema (every numeric column
its cluster's centroid plus unit noise, every categorical its cluster's
value, the text block its cluster's centroid plus noise 0.3), from seed 0
in the reference's order; pairs join a notice to a company of its cluster.
Then ``Trainer.train`` with the reference's hyperparameters (batch 256,
towers (512, 256) -> 128, categorical embeddings of 32, lr 1e-3,
temperature 1): 4/5 of the pairs train, up to 4,096 of the rest validate,
the results CSV (the ledger) and the metrics JSONL go to ``--workdir``.
The last line is one JSON object with the final validation's recall@k, MRR
and AUC and the corpus eval's recall@k and MRR.

The loss is ``use_fused_logits="auto"``: on the card at B = 256, D = 128
the fused CE kernels (K6, K11 a step; K6, K8 and K5 a validation batch),
on the CPU the materialized loss the reference's script asks for, the same
function. Runs on the card; ``--force-cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np


def planted_stores(schema, rows: int, n_pairs: int, seed: int = 0):
    """(notice store, company store, pairs [n_pairs, 2] int64, the
    generator they were drawn from, which the split goes on drawing from),
    in the reference's order from ``seed``."""
    from jodalrob_twotower_torch.data.feature_store import FeatureStore

    rng = np.random.default_rng(seed)
    n_clusters = min(256, max(rows // 50, 2))  # keep every cluster populated

    def make_store(side, cluster):
        numeric = rng.normal(size=(rows, side.num_numeric)).astype(np.float32)
        centroids = rng.normal(size=(n_clusters, side.num_numeric)).astype(np.float32)
        numeric += centroids[cluster]
        cat = np.empty((rows, side.num_categorical), np.int32)
        for k, spec in enumerate(side.categorical):
            mapping = rng.integers(0, spec.vocab_size, n_clusters)
            cat[:, k] = mapping[cluster]
        text = None
        if side.text:
            text = {}
            for t in side.text:
                tc = rng.normal(size=(n_clusters, t.embed_dim)).astype(np.float32)
                text[t.name] = tc[cluster] + 0.3 * rng.normal(size=(rows, t.embed_dim)).astype(np.float32)
        return FeatureStore.from_columns(side, numeric=numeric, categorical=cat, text=text)

    n_cluster = rng.integers(0, n_clusters, rows)
    c_cluster = rng.integers(0, n_clusters, rows)
    notice_store = make_store(schema.notice, n_cluster)
    company_store = make_store(schema.company, c_cluster)
    by_cluster = [np.flatnonzero(c_cluster == c) for c in range(n_clusters)]
    for c in range(n_clusters):  # every cluster has a company
        if len(by_cluster[c]) == 0:
            c_cluster[c % rows] = c
            by_cluster[c] = np.asarray([c % rows])
    n_idx = rng.integers(0, rows, n_pairs)
    c_idx = np.asarray([by_cluster[n_cluster[i]][rng.integers(0, len(by_cluster[n_cluster[i]]))] for i in n_idx])
    return notice_store, company_store, np.stack([n_idx, c_idx], 1).astype(np.int64), rng


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--meta", type=Path, required=True,
                   help="the reference's meta directory (metadata.csv and the notice_*_config.json files)")
    p.add_argument("--rows", type=int, default=20_000, help="rows per side")
    p.add_argument("--pairs", type=int, default=100_000)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=256)  # the reference's
    p.add_argument("--workdir", type=Path)
    p.add_argument("--force-cpu", action="store_true", help="run on the CPU instead of the card")
    args = p.parse_args(argv)

    from jodalrob_twotower_torch.config import DataConfig, LossConfig, ModelConfig, OptimizerConfig, TrainConfig
    from jodalrob_twotower_torch.device import resolve_device
    from jodalrob_twotower_torch.etl.reference_configs import (
        categorical_configs_from_reference,
        numeric_configs_from_reference,
        text_configs_from_reference,
    )
    from jodalrob_twotower_torch.schema import schema_from_metadata_csv
    from jodalrob_twotower_torch.train.trainer import Trainer

    device = resolve_device("cpu" if args.force_cpu else None)
    if device.type == "cuda":
        from jodalrob_twotower_torch.bench import card_line

        print(card_line(), flush=True)
    meta = args.meta
    workdir = args.workdir or Path(tempfile.mkdtemp(prefix="ref_scale_"))
    print(f"meta: {meta}  workdir: {workdir}")

    # 1. the schema from the reference metadata (text: the columns of
    #    notice_text_config.json that are in use)
    text_cfgs, _model = text_configs_from_reference(meta / "notice_text_config.json")
    schema = schema_from_metadata_csv(meta / "metadata.csv", notice_text_columns=list(text_cfgs),
                                      company_text_columns=())
    print(f"schema: notice {schema.notice.num_numeric} num / {schema.notice.num_categorical} cat / "
          f"{len(schema.notice.text)} text; company {schema.company.num_numeric} / "
          f"{schema.company.num_categorical} / {len(schema.company.text)}")
    n_num_cfg = numeric_configs_from_reference(meta / "notice_numeric_config.json")
    n_cat_cfg = categorical_configs_from_reference(meta / "notice_categorical_config.json")
    print(f"reference configs: {len(n_num_cfg)} numeric, {len(n_cat_cfg)} categorical adapted")

    # 2. planted-cluster stores on that schema
    notice_store, company_store, pairs, rng = planted_stores(schema, args.rows, args.pairs)

    # 3. the reference's hyperparameters (its scripts/train.py:84-134)
    cfg = TrainConfig(
        model=ModelConfig(),
        loss=LossConfig(temperature=1.0),
        optimizer=OptimizerConfig(learning_rate=1e-3, num_epochs=args.epochs),
        data=DataConfig(batch_size=args.batch_size),
        results_csv=str(workdir / "train_results.csv"),
        metrics_jsonl=str(workdir / "metrics.jsonl"),
    )
    trainer = Trainer(cfg, schema, notice_store, company_store, device=device)
    perm = rng.permutation(len(pairs))
    n_val = len(pairs) // 5
    result = trainer.train(pairs[perm[n_val:]], pairs[perm[:n_val]][:4096], checkpoint_dir=workdir / "ckpt")
    print(f"ledger: {cfg.results_csv}")
    val = result.final_val
    print(json.dumps({"bench": "reference_scale_demo", "device": str(device), "batch": args.batch_size,
                      "steps": int(result.state.step), "train_loss": result.history[-1]["train_loss"],
                      "val_loss": val["loss"], **{k: val[k] for k in sorted(val) if k.startswith("recall@")},
                      "mrr": val["mrr"], "auc": val["auc"],
                      "corpus_recall": {str(k): v for k, v in result.corpus.recall.items()},
                      "corpus_mrr": result.corpus.mrr, "examples_per_sec": result.examples_per_sec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
