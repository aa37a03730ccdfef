"""The optimizer's share of a training step's host time, in %: the self
time of the program's ``train.update`` span over its ``train.step``, the
median over the steps run outside any profiler session."""

import statistics

from benchmark import spans


def read(s: dict):
    shares = [100.0 * sum(c["self_ns"] for c in r["children"] if c["name"] == "train.update")
              / (r["end_ns"] - r["start_ns"]) for r in spans.roots(s, "train.step")]
    return statistics.median(shares) if shares else None
