"""Training CLI of the PyTorch port, ``python -m jodalrob_twotower_torch.train``
(port of ``scripts/train.py``).

Every hyperparameter lives in the typed TrainConfig (JSON-serializable); the
flags override the common ones. The run writes checkpoints under
``--output-dir`` (epoch, best, final, weights and, with
``--save-every-steps``, mid-epoch ones that ``--resume`` continues from bit
for bit), a row of the results CSV and, with ``--metrics-jsonl``, one JSON
line per epoch.

Data: ``--synthetic`` (the default) is the planted-cluster dataset, at the
``tiny`` scale or the headline bench's (``--synthetic-scale bench``);
``--data-dir`` reads a parquet dataset directory (``data/parquet_dataset.py``:
schema.json, notice/company.parquet, pairs.parquet), and with ``--stream``
trains on pairs.parquet streamed in chunks of ``DataConfig.chunk_size``
(``Trainer.train_streaming``; validation pairs are carved from the loaded
set as without it). The parquet readers need pyarrow. The run goes on the
card; ``--force-cpu`` asks for the CPU. ``--mesh-devices N`` trains over an
N-rank data-parallel mesh (``parallel/``): N cards over NCCL, or with
``--force-cpu`` N gloo ranks on the CPU; ``--batch-size`` is then the global
batch. Tables above 65,536 rows are row-sharded over the mesh, and
``--store-sharding rows`` row-shards the feature stores too (it needs
``--mesh-devices``). ``--grad-compression int16|bf16`` syncs the dense
gradients of the mesh in that wire format with error feedback
(``parallel/compressed_grads.py``; each rank then trains its block as a
batch of its own), with ``--compressed-negatives`` "local" (each rank's
in-batch negatives, the default) or "global". A run across hosts starts one
process per card with ``torchrun``.

  python -m jodalrob_twotower_torch.train --synthetic --synthetic-scale bench \\
      --batch-size 8192 --epochs 8 --sample-on-device --epoch-corpus-eval \\
      --output-dir runs/headline
  python -m jodalrob_twotower_torch.train --force-cpu --epochs 2 --output-dir runs/cpu
  python -m jodalrob_twotower_torch.train --data-dir ds/ --stream --output-dir runs/ds
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m jodalrob_twotower_torch.train", description=__doc__.splitlines()[0])
    p.add_argument("--config", type=Path, help="TrainConfig JSON")
    p.add_argument("--synthetic", action="store_true", help="use the synthetic dataset (the default)")
    p.add_argument(
        "--synthetic-scale", choices=["tiny", "bench"], default="tiny",
        help="'tiny' (10k rows a side, 50k pairs) or 'bench' (the headline bench's shape: "
        "reference-shaped schema, 100k rows a side, 400k pairs, 256 planted clusters)",
    )
    p.add_argument("--data-dir", type=Path, help="parquet dataset directory")
    p.add_argument("--stream", action="store_true",
                   help="with --data-dir: stream pairs.parquet in chunks instead of holding every pair")
    p.add_argument("--output-dir", type=Path, default=Path("output/models"))
    p.add_argument("--epochs", type=int)
    p.add_argument("--batch-size", type=int)
    p.add_argument("--learning-rate", type=float)
    p.add_argument("--pair-limit", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--save-every-steps", type=int,
                   help="mid-epoch checkpoints every N steps; --resume restarts from the exact step")
    p.add_argument("--no-corpus-eval", action="store_true")
    p.add_argument("--epoch-corpus-eval", action="store_true",
                   help="run the corpus-retrieval eval every epoch (default: the final one only)")
    p.add_argument("--results-csv", type=Path, help="append the run's result row here (default train_results.csv)")
    p.add_argument("--metrics-jsonl", type=Path, help="stream per-epoch metrics to this JSONL file")
    p.add_argument("--sample-on-device", action="store_true",
                   help="draw each step's batch on the device, IID with replacement, from the resident pair set")
    p.add_argument("--fused-logits", choices=["auto", "on", "off"],
                   help="the fused CE kernels: 'auto' (the default) on the card, 'off' the materialized loss")
    p.add_argument("--dropout-rng", choices=["auto", "threefry", "rbg"],
                   help="ModelConfig.dropout_rng_impl (the port draws every mask from a seeded torch.Generator)")
    p.add_argument("--force-cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--mesh-devices", type=int,
                   help="train over an N-device data-parallel mesh (batch dim sharded; tables replicated "
                   "up to 65,536 rows, row-sharded above)")
    p.add_argument("--store-sharding", choices=["replicated", "rows"],
                   help="feature-store placement under --mesh-devices ('rows': each device its block of rows)")
    p.add_argument("--grad-compression", choices=["none", "int16", "bf16"],
                   help="compressed dense-gradient sync with error feedback under --mesh-devices "
                   "(int8 quanta summed exactly, or bf16)")
    p.add_argument("--compressed-negatives", choices=["local", "global"],
                   help="in-batch negatives under --grad-compression: 'local' (each device's block, "
                   "the default) or 'global' (the whole batch, through the mesh's CE)")
    return p.parse_args(argv)


def configure(args):
    """The TrainConfig of a run: ``--config`` (or the defaults) with the
    flags applied."""
    from jodalrob_twotower_torch.config import TrainConfig

    cfg = TrainConfig.from_json(args.config) if args.config else TrainConfig()
    if args.epochs is not None:
        cfg = cfg.replace(optimizer=dataclasses.replace(cfg.optimizer, num_epochs=args.epochs))
    if args.batch_size is not None:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, batch_size=args.batch_size))
    if args.learning_rate is not None:
        cfg = cfg.replace(optimizer=dataclasses.replace(cfg.optimizer, learning_rate=args.learning_rate))
    if args.pair_limit is not None:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, pair_limit=args.pair_limit))
    if args.seed is not None:
        cfg = cfg.replace(seed=args.seed)
    if args.save_every_steps is not None:
        cfg = cfg.replace(checkpoint=dataclasses.replace(cfg.checkpoint, save_every_steps=args.save_every_steps))
    if args.sample_on_device:
        if args.stream:
            raise SystemExit("--sample-on-device needs the whole pair set device-resident; "
                             "it is incompatible with --stream")
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, sample_on_device=True))
    if args.metrics_jsonl:
        cfg = cfg.replace(metrics_jsonl=str(args.metrics_jsonl))
    if args.results_csv:
        cfg = cfg.replace(results_csv=str(args.results_csv))
    if args.fused_logits:
        resolved = {"auto": "auto", "on": True, "off": False}[args.fused_logits]
        cfg = cfg.replace(loss=dataclasses.replace(cfg.loss, use_fused_logits=resolved))
    if args.compressed_negatives:
        if args.compressed_negatives != "local" and not args.grad_compression:
            raise SystemExit("--compressed-negatives requires --grad-compression")
        cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, compressed_negatives=args.compressed_negatives))
    if args.dropout_rng:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, dropout_rng_impl=args.dropout_rng))
    if args.store_sharding:
        if not args.mesh_devices:
            raise SystemExit("--store-sharding requires --mesh-devices")
        cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, store_sharding=args.store_sharding))
    if args.grad_compression:
        if not args.mesh_devices and args.grad_compression != "none":
            raise SystemExit("--grad-compression requires --mesh-devices")
        cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh, grad_compression=args.grad_compression))
    return cfg


def synthetic_data(scale: str, seed: int):
    """(schema, notice store, company store, pairs) of the synthetic dataset
    at ``scale``."""
    from jodalrob_twotower_torch.data.synthetic import make_synthetic_dataset

    if scale == "bench":
        from jodalrob_twotower_torch.schema import reference_shaped_schema

        ds = make_synthetic_dataset(
            reference_shaped_schema(), n_notices=100_000, n_companies=100_000, n_pairs=400_000,
            n_clusters=256, seed=seed,
        )
    else:
        ds = make_synthetic_dataset(seed=seed)
    return ds.schema, ds.notice_store, ds.company_store, ds.pairs


def split_pairs(pairs: np.ndarray, cfg) -> tuple[np.ndarray, np.ndarray]:
    """(train, val) pairs: ``pair_limit`` truncation first, then the seeded
    permutation (the reference's order; the eval CLI carves the same val
    set)."""
    if cfg.data.pair_limit:
        pairs = pairs[: cfg.data.pair_limit]
    perm = np.random.default_rng(cfg.data.shuffle_seed).permutation(len(pairs))
    n_test = int(round(len(pairs) * cfg.data.test_split))
    return pairs[perm[n_test:]], pairs[perm[:n_test]]


def main(argv=None) -> int:
    from jodalrob_twotower_torch.parallel.distributed import launch_cli, refuse_unported

    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    refuse_unported(args)
    configure(args)  # the flags' exits, before any rank starts
    if args.mesh_devices:
        return launch_cli(run, argv, args.mesh_devices, args.force_cpu)
    return run(argv)


def run(argv: list[str], devices: list | None = None) -> int:
    """The training run of ``argv``, on one device or, with ``devices``
    (one per rank of the process group), as this rank of the mesh."""
    from jodalrob_twotower_torch.parallel.mesh import make_mesh
    from jodalrob_twotower_torch.train.trainer import Trainer

    args = parse_args(argv)
    mesh = make_mesh(devices) if devices else None
    say = print if mesh is None or mesh.is_main else (lambda *_: None)
    cfg = configure(args)
    if args.data_dir and not args.synthetic:
        from jodalrob_twotower_torch.data.parquet_dataset import load_dataset

        schema, notice_store, company_store, pairs = load_dataset(args.data_dir)
        say(f"data: {args.data_dir} ({len(pairs):,} pairs)")
    else:
        say(f"data: synthetic planted-cluster dataset ({args.synthetic_scale} scale)")
        schema, notice_store, company_store, pairs = synthetic_data(args.synthetic_scale, cfg.seed)
    train_pairs, val_pairs = split_pairs(pairs, cfg)
    say(f"pairs: {len(train_pairs):,} train / {len(val_pairs):,} val")
    if mesh is not None:
        from jodalrob_twotower_torch.parallel.mesh import resolve_embedding_sharding

        tables = resolve_embedding_sharding(cfg.mesh, schema)
        sync = ""
        if cfg.mesh.grad_compression != "none":
            tables = "gspmd_rows" if cfg.sparse_tables else "replicated"
            sync = f", gradients {cfg.mesh.grad_compression} with {cfg.mesh.compressed_negatives} negatives"
        say(f"mesh: {mesh.size} devices over {mesh.backend} (tables {tables}, "
            f"stores {cfg.mesh.store_sharding}, batch dim sharded{sync})")

    trainer = Trainer(cfg, schema, notice_store, company_store, mesh=mesh,
                      device=None if mesh is not None else "cpu" if args.force_cpu else None, log_fn=say)
    common = dict(checkpoint_dir=args.output_dir, resume=args.resume, corpus_eval=not args.no_corpus_eval)
    if args.stream and args.data_dir:
        # the stream reads the whole pairs file each epoch: the split above
        # only carves out the validation pairs, which training then sees
        # too (the reference's rule for the huge-pairs regime it serves)
        result = trainer.train_streaming(
            args.data_dir / "pairs.parquet",
            val_pairs,
            steps_per_epoch=max((len(train_pairs) + len(val_pairs)) // cfg.data.batch_size, 1),
            chunk_rows=cfg.data.chunk_size,
            **common,
        )
    else:
        result = trainer.train(train_pairs, val_pairs, epoch_corpus_eval=args.epoch_corpus_eval, **common)
    say(f"done: {result.examples_per_sec:,.0f} examples/s, results appended to {cfg.results_csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
