"""Results ledger: append one row per training run to a CSV (a copy of
``jodalrob_twotower_tpu/train/ledger.py``, which imports no JAX; the port
keeps its own so that it imports nothing of the JAX package).

Parity with the reference's ``save_training_results`` / train_results.csv
(scripts/train.py:24-75), including its column names — with the reference's
recall key-mismatch bug fixed (it wrote empty recall columns because the
writer read ``recall_at_5`` while metrics emitted ``recall@5``,
scripts/train.py:50-51 vs :480-481; SURVEY.md §6).
"""

from __future__ import annotations

import csv
import datetime
from pathlib import Path
from typing import Mapping

FIELDS = [
    "timestamp",
    "epochs",
    "batch_size",
    "learning_rate",
    "embedding_dim",
    "num_params",
    "train_loss",
    "val_loss",
    "val_accuracy",
    "recall_at_5",
    "recall_at_10",
    "corpus_recall_at_10",
    "corpus_recall_at_100",
    "mrr",
    "auc",
    "positive_similarity",
    "negative_similarity",
    "similarity_gap",
    "z_gap",
    "examples_per_sec",
    "notes",
]

# metric-dict key -> csv column (the reference's bug was exactly this map
# being inconsistent between writer and metrics)
_METRIC_TO_FIELD = {
    "loss": "val_loss",
    "accuracy": "val_accuracy",
    "recall@5": "recall_at_5",
    "recall@10": "recall_at_10",
    "corpus_recall@10": "corpus_recall_at_10",
    "corpus_recall@100": "corpus_recall_at_100",
    "mrr": "mrr",
    "auc": "auc",
    "positive_similarity": "positive_similarity",
    "negative_similarity": "negative_similarity",
    "similarity_gap": "similarity_gap",
    # the reference displayed z_gap on every progress line but never
    # persisted it (scripts/train.py:347-351); the ledger keeps it
    "z_gap": "z_gap",
}


def append_result(
    path: str | Path,
    *,
    run_info: Mapping[str, object],
    val_metrics: Mapping[str, float],
    train_loss: float | None = None,
    notes: str = "",
) -> dict:
    """Append one run row; creates the file with a header when absent.

    Appends to a PRE-EXISTING file conform to THAT file's header: new
    metric columns added since the file was created (e.g. round 4's
    z_gap) are dropped rather than silently shifting every value one
    column over — the header is only ever written once, so schema drift
    must bend to the file, not corrupt it."""
    path = Path(path)
    row = {f: "" for f in FIELDS}
    row["timestamp"] = datetime.datetime.now().isoformat(timespec="seconds")
    row["notes"] = notes
    if train_loss is not None:
        row["train_loss"] = f"{float(train_loss):.6f}"
    for k, v in run_info.items():
        if k in row:
            row[k] = v
    for k, v in val_metrics.items():
        field = _METRIC_TO_FIELD.get(k)
        if field:
            row[field] = f"{float(v):.6f}"
    fields = FIELDS
    exists = path.exists()
    if exists:
        with path.open(newline="") as fh:
            header = fh.readline().strip()
        if header:
            fields = header.split(",")
    with path.open("a", newline="") as fh:
        # extrasaction="ignore" drops row keys the (possibly legacy)
        # header lacks
        writer = csv.DictWriter(fh, fieldnames=fields, extrasaction="ignore")
        if not exists:
            writer.writeheader()
        writer.writerow(row)
    return row


def read_results(path: str | Path) -> list[dict]:
    with Path(path).open(newline="") as fh:
        return list(csv.DictReader(fh))
