"""Headline training artifact of the PyTorch port,
``python -m jodalrob_twotower_torch.train_headline``: the torch leg of
``scripts/train_headline.py``.

It trains the headline bench's configuration end to end through the port's
training CLI, called in-process: ``TrainConfig()`` on the reference-shaped
schema, bench-scale planted-cluster data (100k x 100k rows, 400k pairs, 256
clusters), B=8192, 8 epochs, batches sampled on the card, with a corpus
retrieval eval every epoch. It writes ``summary.json``, ``metrics.jsonl`` and
``train_results.csv`` into ``artifacts/headline_b8192_torch/`` (or
``--output-dir``), beside the committed JAX artifact
(``artifacts/headline_b8192/summary.json``), which it reads and never
rewrites. Checkpoints go to a temporary directory.

Gates, checked after ``summary.json`` is written so that a failed run
leaves its numbers:

* ``learned``: the last epoch's train loss is below the first's, and the
  final corpus recall@100 is at least 10x random (0.01 over the bench's
  100k companies, 0.1 over the tiny corpus's 10k);
* ``within_tolerance``: the final corpus recall@100 is within
  ``--tolerance`` (0.05) of the JAX artifact's.

The runs' random streams (sampled batches, dropout masks) are torch's, not
the reference's, so the yardstick is recall, not bits. ``--smoke`` runs the
recipe at the tiny scale, B=256, on the CPU, into a temporary directory,
with the learned gate only.
"""

from __future__ import annotations

import argparse
import csv
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
ART = REPO / "artifacts" / "headline_b8192_torch"
REFERENCE_SUMMARY = REPO / "artifacts" / "headline_b8192" / "summary.json"
EPOCH_KEYS = ("epoch", "train_loss", "val_loss", "val_accuracy", "corpus_recall@10", "corpus_recall@100",
              "examples_per_sec")


def run_leg(art: Path, epochs: int, extra: list[str], *, batch_size: int, scale: str,
            checkpoint_dir: Path | None = None) -> dict:
    """One training run through ``train.main`` in-process; its numbers from
    the results CSV and the metrics stream it wrote. Its checkpoints go to
    ``checkpoint_dir``, which is kept, or else to a temporary directory
    removed after."""
    from jodalrob_twotower_torch import train
    from jodalrob_twotower_torch.utils.profiling import MetricsLogger

    art.mkdir(parents=True, exist_ok=True)
    results_csv, metrics_jsonl = art / "train_results.csv", art / "metrics.jsonl"
    for p in (results_csv, metrics_jsonl):
        if p.exists():
            p.unlink()
    ckpt = checkpoint_dir or Path(tempfile.mkdtemp(prefix="headline_torch_"))
    argv = [
        "--synthetic", "--synthetic-scale", scale,
        "--batch-size", str(batch_size), "--epochs", str(epochs),
        "--sample-on-device", "--epoch-corpus-eval",
        "--output-dir", str(ckpt),
        "--results-csv", str(results_csv),
        "--metrics-jsonl", str(metrics_jsonl),
        *extra,
    ]
    print("[torch] train " + " ".join(argv), flush=True)
    t0 = time.perf_counter()
    try:
        rc = train.main(argv)
    finally:
        if checkpoint_dir is None:
            shutil.rmtree(ckpt, ignore_errors=True)
    wall_s = time.perf_counter() - t0
    if rc != 0:
        raise SystemExit(f"training failed rc={rc}")
    with results_csv.open() as f:
        final = list(csv.DictReader(f))[-1]
    epochs_log = MetricsLogger.read(metrics_jsonl)
    # the command with its machine-specific directories named by role
    shown = [a.replace(str(ckpt), "<checkpoint dir>").replace(str(art), "<artifact dir>") for a in argv]
    return {
        "cmd": "python -m jodalrob_twotower_torch.train " + " ".join(shown),
        "final_corpus_recall_at_100": float(final["corpus_recall_at_100"]),
        "final_corpus_recall_at_10": float(final["corpus_recall_at_10"]),
        "final_val_loss": float(final["val_loss"]),
        "final_val_accuracy": float(final["val_accuracy"]),
        "final_z_gap": float(final["z_gap"]) if final.get("z_gap") else None,
        "examples_per_sec": float(final["examples_per_sec"]),
        "first_epoch_train_loss": epochs_log[0]["train_loss"],
        "last_epoch_train_loss": epochs_log[-1]["train_loss"],
        "epochs": len(epochs_log),
        "per_epoch": [{k: e.get(k) for k in EPOCH_KEYS} for e in epochs_log],
        "wall_s": wall_s,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m jodalrob_twotower_torch.train_headline",
                                 description=__doc__.splitlines()[0].strip())
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--tolerance", type=float, default=0.05,
                    help="max |torch - JAX artifact| final corpus recall@100")
    ap.add_argument("--output-dir", type=Path, help="write the artifact here instead of " + str(ART.relative_to(REPO)))
    ap.add_argument("--checkpoint-dir", type=Path,
                    help="keep the run's checkpoints (config.json, weights/, ...) here; default: a temporary "
                         "directory removed after the run")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny scale, B=256, on the CPU, into a temporary directory; the learned gate only")
    args = ap.parse_args(argv)

    art = args.output_dir or ART
    scale, batch, extra = "bench", 8192, []
    if args.smoke:
        art = args.output_dir or Path(tempfile.mkdtemp(prefix="headline_torch_smoke_"))
        scale, batch, extra = "tiny", 256, ["--force-cpu"]
    summary: dict = {
        "batch_size": batch,
        "scale": "bench (100k x 100k, 400k pairs)" if scale == "bench" else "tiny (smoke)",
    }
    if not args.smoke:
        from jodalrob_twotower_torch.bench import card_line

        summary["card"] = card_line()  # nvidia-smi name, power limit: the numbers below are this card's
    summary["torch"] = leg = run_leg(art, args.epochs, extra, batch_size=batch, scale=scale,
                                        checkpoint_dir=args.checkpoint_dir)
    # 10x random recall@100: 1e-3 over the bench corpus's 100k companies,
    # 1e-2 over the tiny corpus's 10k
    min_recall = 0.1 if args.smoke else 0.01
    summary["learned"] = bool(
        leg["last_epoch_train_loss"] < leg["first_epoch_train_loss"]
        and leg["final_corpus_recall_at_100"] >= min_recall
    )
    if not args.smoke:
        reference = json.loads(REFERENCE_SUMMARY.read_text())["chip"]["final_corpus_recall_at_100"]
        diff = abs(leg["final_corpus_recall_at_100"] - reference)
        summary["reference"] = {"final_corpus_recall_at_100": reference,
                                "source": str(REFERENCE_SUMMARY.relative_to(REPO))}
        summary["recall_at_100_abs_diff"] = round(diff, 6)
        summary["tolerance"] = args.tolerance
        summary["within_tolerance"] = bool(diff <= args.tolerance)

    (art / "summary.json").write_text(json.dumps(summary, indent=2) + "\n")
    if not summary["learned"]:
        raise SystemExit(f"headline run did not learn: {json.dumps(summary)}")
    if not args.smoke and not summary["within_tolerance"]:
        raise SystemExit(f"headline recall@100 off the JAX artifact's by more than {args.tolerance}: "
                         f"{json.dumps(summary)}")
    print(json.dumps({"bench": "headline_training_artifact_torch",
                      **{k: v for k, v in summary.items() if not isinstance(v, dict)},
                      "recall_at_100": leg["final_corpus_recall_at_100"], "artifacts": str(art)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
