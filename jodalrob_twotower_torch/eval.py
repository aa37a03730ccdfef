"""Evaluation CLI of the PyTorch port, ``python -m jodalrob_twotower_torch.eval``
(port of ``scripts/eval.py``): restore a trained model and score it.

It restores the weights-only export (``weights/``) of a training run into a
FrozenState, carves the run's validation pairs again (the same pair limit and
seeded permutation as the training CLI), and writes one JSON document: the
in-batch metric surface (``evaluate_indexed`` over device-resident stores, or
``evaluate`` over host batches with ``--host-eval``) with the random
baselines and the qualitative verdict, the corpus-level retrieval recall@k
and MRR over ``--ks``, and with ``--demo-queries`` the top-10 predictions of
the first queries. The keys are the reference CLI's. The data is the
synthetic dataset, or with ``--data-dir`` a parquet dataset directory (the
training CLI's; its readers need pyarrow). Runs on the card; ``--force-cpu``
asks for the CPU. ``--mesh-devices N`` evaluates over an N-rank mesh
(``parallel/``; N cards over NCCL, or N gloo ranks with ``--force-cpu``):
each rank scores its block of every batch and the corpus is row-sharded
(``sharded_corpus_retrieval_eval``); the report is rank 0's. Tables above
65,536 rows are row-sharded over the mesh (each rank restores its block of
the weights), and ``--store-sharding rows`` places each rank's block of the
feature stores (it needs ``--mesh-devices``).

  python -m jodalrob_twotower_torch.eval --model-dir runs/exp1 --output eval.json
  python -m jodalrob_twotower_torch.eval --model-dir runs/ds --data-dir ds/ --output eval.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path



def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m jodalrob_twotower_torch.eval", description=__doc__.splitlines()[0])
    p.add_argument("--model-dir", type=Path, required=True, help="training output dir (config.json + weights/)")
    p.add_argument("--data-dir", type=Path, help="parquet dataset directory")
    p.add_argument("--synthetic", action="store_true", help="use the synthetic dataset (the default)")
    p.add_argument("--synthetic-scale", choices=["tiny", "bench"], default="tiny",
                   help="the synthetic dataset's scale, as the training run's --synthetic-scale")
    p.add_argument("--batch-size", type=int, help="eval batch size (default: the run's config)")
    p.add_argument("--pair-limit", type=int, help="evaluate at most N validation pairs")
    p.add_argument("--ks", default="10,100", help="corpus recall@k values, comma-separated")
    p.add_argument("--no-corpus-eval", action="store_true")
    p.add_argument("--demo-queries", type=int, default=0,
                   help="show top-10 predictions for the first N validation queries")
    p.add_argument("--output", type=Path, help="write the JSON report here (default: stdout)")
    p.add_argument("--host-eval", action="store_true",
                   help="assemble eval batches on the host instead of placing the stores on the device")
    p.add_argument("--force-cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--mesh-devices", type=int,
                   help="evaluate over an N-device mesh (state replicated, batches and corpus sharded)")
    p.add_argument("--store-sharding", choices=["replicated", "rows"],
                   help="feature-store placement under --mesh-devices ('rows': each device its block of rows)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    from jodalrob_twotower_torch.parallel.distributed import launch_cli, refuse_unported

    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    refuse_unported(args)
    if args.mesh_devices:
        return launch_cli(run, argv, args.mesh_devices, args.force_cpu)
    return run(argv)


def run(argv: list[str], devices: list | None = None) -> int:
    """The evaluation of ``argv``, on one device or, with ``devices`` (one
    per rank of the process group), as this rank of the mesh."""
    from jodalrob_twotower_torch.config import TrainConfig
    from jodalrob_twotower_torch.data.pipeline import assemble_pair_batch
    from jodalrob_twotower_torch.device import resolve_device
    from jodalrob_twotower_torch.evaluation.evaluator import (
        Evaluator,
        corpus_retrieval_eval,
        demonstrate_predictions,
        qualitative_assessment,
        sharded_corpus_retrieval_eval,
    )
    from jodalrob_twotower_torch.models import build_model
    from jodalrob_twotower_torch.parallel.mesh import make_mesh
    from jodalrob_twotower_torch.parallel.sharded_store import resolve_store_placement
    from jodalrob_twotower_torch.serving.service import FrozenState
    from jodalrob_twotower_torch.train.checkpoint import CheckpointManager
    from jodalrob_twotower_torch.train.cli import split_pairs, synthetic_data
    from jodalrob_twotower_torch.train.metrics import random_baselines
    from jodalrob_twotower_torch.train.train_step import device_store, resolve_store_dtype

    args = parse_args(argv)
    mesh = make_mesh(devices) if devices else None
    device = mesh.device if mesh is not None else resolve_device("cpu" if args.force_cpu else None)
    cfg = TrainConfig.from_json(args.model_dir / "config.json")
    if args.store_sharding:
        cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, store_sharding=args.store_sharding))
    if args.data_dir and not args.synthetic:
        from jodalrob_twotower_torch.data.parquet_dataset import load_dataset

        schema, notice_store, company_store, pairs = load_dataset(args.data_dir)
    else:
        schema, notice_store, company_store, pairs = synthetic_data(args.synthetic_scale, cfg.seed)
    if cfg.data.pair_limit:
        pairs = pairs[: cfg.data.pair_limit]
    _, val_pairs = split_pairs(pairs, cfg)
    if not len(val_pairs):  # no split: every pair
        val_pairs = pairs
    if args.pair_limit:
        val_pairs = val_pairs[: args.pair_limit]
    b = args.batch_size or cfg.data.batch_size
    writes = mesh is None or mesh.is_main  # the rank that reports
    if writes:
        print(f"eval: {len(val_pairs):,} validation pairs, batch {b}", file=sys.stderr)

    model = build_model(schema, cfg, mesh)
    ckpt = CheckpointManager(args.model_dir, cfg.checkpoint, mesh=mesh, sharded=model.row_sharded_keys)
    restored = ckpt.restore_weights(model.state_dict(), device=device)
    state = FrozenState({**restored["params"], **restored["batch_stats"]})
    evaluator = Evaluator(model, cfg, mesh=mesh)

    dev_stores, store_gather = None, None
    if not args.host_eval:
        store_dt = resolve_store_dtype(cfg)
        if mesh is not None:
            from jodalrob_twotower_torch.train.trainer import host_store

            store_gather, put_store = resolve_store_placement(cfg, mesh)
            dev_stores = tuple(put_store(host_store(fs, store_dt)) for fs in (notice_store, company_store))
        else:
            dev_stores = (device_store(notice_store, dtype=store_dt, device=device),
                          device_store(company_store, dtype=store_dt, device=device))

    def batches():
        for start in range(0, len(val_pairs) - b + 1, b):
            yield assemble_pair_batch(notice_store, company_store, val_pairs[start : start + b])

    report: dict = {"model_dir": str(args.model_dir), "num_val_pairs": int(len(val_pairs))}
    if dev_stores is not None and len(val_pairs) >= b:
        metrics = evaluator.evaluate_indexed(state, val_pairs, dev_stores[0], dev_stores[1], batch_size=b,
                                             store_gather=store_gather)
    else:
        metrics = evaluator.evaluate(state, batches())
    report["in_batch"] = {k: round(v, 6) for k, v in metrics.items()}
    report["random_baselines"] = {k: round(v, 6) for k, v in random_baselines(b).items()}
    report["assessment"] = qualitative_assessment(metrics, b)

    if not args.no_corpus_eval and len(val_pairs):
        ks = tuple(int(k) for k in args.ks.split(","))
        if dev_stores is not None:
            corpus_emb = evaluator.encode_corpus_device(state, dev_stores[1], len(company_store), side="company",
                                                        store_gather=store_gather)
        else:
            corpus_emb = evaluator.encode_corpus(state, company_store.dense, company_store.cat_ids, side="company")
        query_emb = evaluator.encode_corpus(
            state, notice_store.dense[val_pairs[:, 0]], notice_store.cat_ids[val_pairs[:, 0]], side="notice"
        )
        if mesh is not None and mesh.size > 1:
            res = sharded_corpus_retrieval_eval(query_emb, corpus_emb, val_pairs[:, 1], mesh, ks=ks)
        else:
            res = corpus_retrieval_eval(query_emb, corpus_emb, val_pairs[:, 1], ks=ks)
        report["corpus"] = {
            "corpus_size": res.corpus_size,
            "num_queries": res.num_queries,
            "mrr": round(res.mrr, 6),
            **{f"recall@{k}": round(v, 6) for k, v in res.recall.items()},
        }
        if args.demo_queries:
            n = min(args.demo_queries, len(val_pairs))
            report["demo"] = demonstrate_predictions(
                query_emb[:n], corpus_emb, k=10,
                query_keys=notice_store.keys[val_pairs[:n, 0]], corpus_keys=company_store.keys,
            )

    if not writes:
        return 0
    text = json.dumps(report, indent=2)
    if args.output:
        args.output.write_text(text)
        print(f"report: {args.output}", file=sys.stderr)
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
