"""The updates' share of a sparse training step's host time, in %: the self
time of the program's ``train.sparse_update`` span (AdamW on the dense
leaves, rowwise Adagrad on the touched rows) over its ``train.sparse_step``,
the median over the steps run outside any profiler session."""

import statistics

from benchmark import spans


def read(s: dict):
    shares = [100.0 * sum(c["self_ns"] for c in r["children"] if c["name"] == "train.sparse_update")
              / (r["end_ns"] - r["start_ns"]) for r in spans.roots(s, "train.sparse_step")]
    return statistics.median(shares) if shares else None
