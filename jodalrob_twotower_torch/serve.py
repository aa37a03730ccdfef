"""Serving CLI of the PyTorch port, ``python -m jodalrob_twotower_torch.serve``
(port of ``scripts/serve.py``): frozen towers -> corpus MIPS index -> top-k
retrieval.

It restores the weights-only export of a training run (``config.json`` and
``weights/``), encodes the company corpus, builds (or loads) an exact or int8
index, and answers notice queries with top-k company keys: one JSON line per
notice (``notice``, ``top_k: [{company, score}]``), and with ``--qps-bench``
the ``serve_cli_qps`` line. ``--target-recall`` measures the candidate
configurations on the corpus and picks the fastest that meets the target
(serving/autoconfig.py). Runs on the card; ``--force-cpu`` asks for the CPU.
``--mesh-devices N`` serves from a corpus row-sharded over an N-rank mesh
(``serving/index.ShardedIndex``; N cards over NCCL, or N gloo ranks with
``--force-cpu``); rank 0 writes the answers.

  python -m jodalrob_twotower_torch.train --output-dir runs/exp1
  python -m jodalrob_twotower_torch.serve --model-dir runs/exp1 --index int8 --k 10 \\
      --queries 100 --output results.jsonl --save-index runs/exp1/company.idx.npz
  python -m jodalrob_twotower_torch.serve --model-dir runs/exp1 \\
      --load-index runs/exp1/company.idx.npz --qps-bench
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

QUERY_BATCH = 1024
CALIBRATION_QUERIES = 2048


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m jodalrob_twotower_torch.serve", description=__doc__.splitlines()[0])
    p.add_argument("--model-dir", type=Path, required=True, help="training output dir (config.json + weights/)")
    p.add_argument("--data-dir", type=Path,
                   help="dataset directory: schema.json, notice.parquet, company.parquet (needs pyarrow)")
    p.add_argument("--synthetic", action="store_true", help="use the synthetic dataset (the default)")
    p.add_argument("--synthetic-scale", choices=["tiny", "bench"], default="tiny",
                   help="the synthetic dataset's scale, as the training run's --synthetic-scale")
    p.add_argument("--index", choices=["exact", "int8"], default="int8")
    p.add_argument("--corpus-chunk", type=int,
                   help="scan the corpus in chunks of this many rows (bounds the score block's memory)")
    p.add_argument("--approx-recall", type=float,
                   help="the approx_max_k recall target of the reference, in (0, 1]; the port selects exactly")
    p.add_argument("--rescore-depth", type=int,
                   help="two-stage search: over-fetch this many candidates, then re-rank them with exact dots")
    p.add_argument("--rescore-dtype", choices=["int8", "bfloat16"], default="int8",
                   help="second-pass precision: int8 = dequantized rows, bfloat16 = a full-precision copy")
    p.add_argument("--target-recall", type=float,
                   help="pick (index kind, approx-recall, rescore-depth) by measuring each candidate's "
                        "recall@k against the exact scan on this corpus (serving/autoconfig.py); "
                        "exclusive with the manual --index/--approx-recall/--rescore-depth knobs")
    p.add_argument("--mesh-devices", type=int,
                   help="serve over an N-device mesh (serving/index.ShardedIndex: the corpus row-sharded)")
    p.add_argument("--save-index", type=Path, help="persist the built index (npz)")
    p.add_argument("--load-index", type=Path, help="serve a persisted index")
    p.add_argument("--k", type=int, default=10)
    p.add_argument("--queries", type=int, default=0, help="serve the first N notices (0 = skip the query demo)")
    p.add_argument("--output", type=Path, help="write results JSONL here")
    p.add_argument("--qps-bench", action="store_true")
    p.add_argument("--force-cpu", action="store_true", help="run on the CPU instead of the card")
    return p.parse_args(argv)


def load_data(args, seed: int):
    """(schema, notice store, company store) from ``--data-dir`` or the
    synthetic dataset."""
    if args.data_dir and not args.synthetic:
        from jodalrob_twotower_torch.data.feature_store import FeatureStore
        from jodalrob_twotower_torch.schema import TwoTowerSchema

        schema = TwoTowerSchema.from_json(args.data_dir / "schema.json")
        return (schema, FeatureStore.from_parquet(schema.notice, args.data_dir / "notice.parquet"),
                FeatureStore.from_parquet(schema.company, args.data_dir / "company.parquet"))
    from jodalrob_twotower_torch.train.cli import synthetic_data

    schema, notice_store, company_store, _ = synthetic_data(args.synthetic_scale, seed)
    return schema, notice_store, company_store


def candidate_bytes(n: int, d: int, query_chunk: int, corpus_chunk: int | None) -> int:
    """Device bytes that the largest candidate of the calibration (int8 with
    a bf16 rescore copy, built from the f32 corpus) asks for beside the
    corpus: its int8 values (1 byte an element), bf16 rescore rows (2) and
    f32 scales (4 a row); ``quantize_int8``'s two live f32 temporaries (8
    bytes an element) at its peak; at search time one block of rows widened
    to f32 (4) and one [query_chunk, rows] f32 score block."""
    rows = min(n, corpus_chunk or n)
    return n * d * (1 + 2 + 8) + 4 * n + 4 * rows * d + 4 * query_chunk * rows


def corpus_fits(corpus_emb, corpus_chunk: int | None) -> bool:
    """Whether the calibration's largest candidate fits on the card beside
    the encoded corpus ``corpus_emb``: in the card's free memory
    (``torch.cuda.mem_get_info``) plus what PyTorch's allocator holds
    unused. Always true off the card."""
    import torch

    if corpus_emb.device.type != "cuda":
        return True
    free, _ = torch.cuda.mem_get_info(corpus_emb.device)
    free += torch.cuda.memory_reserved(corpus_emb.device) - torch.cuda.memory_allocated(corpus_emb.device)
    n, d = corpus_emb.shape
    return candidate_bytes(n, d, 1024, corpus_chunk) <= free


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.mesh_devices:
        incompatible = [
            name for name, val in (
                ("--corpus-chunk", args.corpus_chunk),
                ("--load-index", args.load_index),
                ("--save-index", args.save_index),
                ("--target-recall", args.target_recall),
            ) if val is not None
        ]
        if incompatible:
            raise SystemExit(
                f"--mesh-devices cannot be combined with {', '.join(incompatible)}: the sharded index "
                "bounds per-device memory by the shard (not --corpus-chunk), is not persistable as a "
                "single-host npz, and the measured auto-config calibrates single-device indexes - pick "
                "the index knobs explicitly for mesh serving"
            )
    if args.target_recall is not None:
        manual = [
            name for name, val, default in (
                ("--index", args.index, "int8"),
                ("--approx-recall", args.approx_recall, None),
                ("--rescore-depth", args.rescore_depth, None),
                ("--rescore-dtype", args.rescore_dtype, "int8"),
            ) if val != default
        ]
        if manual or args.load_index:
            raise SystemExit(
                "--target-recall picks the index configuration itself; drop "
                + ", ".join(manual or ["--load-index"])
            )
    if args.mesh_devices:
        from jodalrob_twotower_torch.parallel.distributed import launch_cli

        return launch_cli(run, argv, args.mesh_devices, args.force_cpu)
    return run(argv)


def run(argv: list[str], devices: list | None = None) -> int:
    """The serving run of ``argv``, on one device or, with ``devices`` (one
    per rank of the process group), as this rank of the mesh: every rank
    searches alike and rank 0 writes."""
    from jodalrob_twotower_torch.config import TrainConfig
    from jodalrob_twotower_torch.device import resolve_device
    from jodalrob_twotower_torch.models import build_model
    from jodalrob_twotower_torch.serving.index import load_index, save_index
    from jodalrob_twotower_torch.serving.service import FrozenState, RetrievalService, qps_bench
    from jodalrob_twotower_torch.parallel.mesh import make_mesh
    from jodalrob_twotower_torch.train.checkpoint import CheckpointManager

    args = parse_args(argv)
    mesh = make_mesh(devices) if devices else None
    writes = mesh is None or mesh.is_main  # the rank that writes
    device = mesh.device if mesh is not None else resolve_device("cpu" if args.force_cpu else None)
    cfg = TrainConfig.from_json(args.model_dir / "config.json")
    schema, notice_store, company_store = load_data(args, cfg.seed)
    model = build_model(schema, cfg, mesh)
    ckpt = CheckpointManager(args.model_dir, cfg.checkpoint, mesh=mesh, sharded=model.row_sharded_keys)
    restored = ckpt.restore_weights(model.state_dict(), device=device)
    state = FrozenState({**restored["params"], **restored["batch_stats"]})

    precomputed_emb = None
    if args.target_recall is not None:
        from jodalrob_twotower_torch.evaluation.evaluator import Evaluator
        from jodalrob_twotower_torch.serving.autoconfig import calibrate_serving_config

        ev = Evaluator(model, cfg)
        # encode once; the service below indexes these embeddings
        precomputed_emb = ev.encode_corpus(state, company_store.dense, company_store.cat_ids, side="company")
        if not corpus_fits(precomputed_emb, args.corpus_chunk):
            # from the host the exact reference streams and each candidate
            # uploads only its int8 and bf16 copies
            precomputed_emb = precomputed_emb.cpu().numpy()
            print(f"calibration: the corpus ({precomputed_emb.shape[0]:,} x {precomputed_emb.shape[1]} f32) "
                  "moved to the host", file=sys.stderr)
        n_sample = min(CALIBRATION_QUERIES, len(notice_store))
        rows = np.sort(np.random.default_rng(0).choice(len(notice_store), size=n_sample, replace=False))
        query_emb = ev.encode_corpus(state, notice_store.dense[rows], notice_store.cat_ids[rows], side="notice")
        chosen, measured = calibrate_serving_config(
            args.target_recall, precomputed_emb, query_emb, k=args.k, corpus_chunk=args.corpus_chunk, device=device,
        )
        args.index = chosen.index_kind
        args.approx_recall = chosen.approx_recall
        args.rescore_depth = chosen.rescore_depth
        args.rescore_dtype = chosen.rescore_dtype
        print(
            f"auto-config for recall>={args.target_recall} (measured on {len(company_store):,} corpus rows, "
            f"{n_sample} sample queries, k={args.k}): {chosen.note} — measured recall@{args.k} "
            + ", ".join(f"{name}: {r:.4f}" for name, r in measured.items())
            + "; equivalent to " + " ".join(chosen.cli_flags()),
            file=sys.stderr,
        )
        if chosen.index_kind == "exact" and isinstance(precomputed_emb, np.ndarray):
            raise SystemExit(
                "--target-recall picked the exact f32 scan, but the corpus does not fit on the card beside "
                "the index copies and was moved to the host; an exact index would hold the whole f32 corpus "
                "on the card. Lower the target, or serve with --index exact --corpus-chunk on a larger card"
            )

    prebuilt = load_index(args.load_index, device=device) if args.load_index else None
    if prebuilt is not None:
        # a loaded index keeps its saved settings; these flags would do nothing
        ignored = [
            name for name, val, default in (
                ("--index", args.index, "int8"),
                ("--corpus-chunk", args.corpus_chunk, None),
                ("--approx-recall", args.approx_recall, None),
                ("--rescore-depth", args.rescore_depth, None),
                ("--rescore-dtype", args.rescore_dtype, "int8"),
            ) if val != default
        ]
        if ignored:
            raise SystemExit(
                f"{', '.join(ignored)} cannot be combined with --load-index: a persisted index keeps the "
                "settings it was built with — rebuild without --load-index to change them"
            )
    svc = RetrievalService(
        model, cfg, state, company_store,
        index_kind=args.index, corpus_chunk=args.corpus_chunk, approx_recall=args.approx_recall,
        rescore_depth=args.rescore_depth, rescore_dtype=args.rescore_dtype,
        precomputed_corpus_emb=precomputed_emb, prebuilt_index=prebuilt, mesh=mesh, device=device,
    )
    del precomputed_emb
    if writes:
        where = f" row-sharded over {mesh.size} ranks" if mesh is not None else ""
        print(f"index: {args.index if prebuilt is None else 'loaded'} over {len(svc.index):,} companies{where}",
              file=sys.stderr)

    if args.save_index:
        save_index(svc.index, args.save_index)
        print(f"index saved: {args.save_index}", file=sys.stderr)

    if args.queries:
        n = min(args.queries, len(notice_store))
        out = (args.output.open("w") if args.output else sys.stdout) if writes else None
        try:
            for start in range(0, n, QUERY_BATCH):
                rows = np.arange(start, min(start + QUERY_BATCH, n))
                hits_of = svc.search_keys(notice_store.gather(rows), k=args.k)  # every rank searches
                for qi, hits in zip(rows, hits_of if writes else ()):
                    out.write(json.dumps({
                        "notice": str(notice_store.keys[qi]),
                        "top_k": [{"company": key, "score": round(s, 6)} for key, s in hits],
                    }) + "\n")
        finally:
            if args.output and writes:
                out.close()
        if args.output and writes:
            print(f"results: {args.output} ({n} queries)", file=sys.stderr)

    if args.qps_bench:
        res = qps_bench(svc, notice_store, k=args.k, batch_size=QUERY_BATCH, n_batches=10)
        if writes:
            print(json.dumps({"bench": "serve_cli_qps", **{
                k: (round(v, 2) if isinstance(v, float) else v) for k, v in res.items()
            }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
