"""The text encoder's share of a search's host time, in %: the program's
``serve.text`` span over its ``serve.search`` root, the median over the
requests served outside any profiler session. None where no search opened
the span."""

import statistics

from benchmark import spans


def read(s: dict):
    shares = [100.0 * sum(c["end_ns"] - c["start_ns"] for c in r["children"] if c["name"] == "serve.text")
              / (r["end_ns"] - r["start_ns"]) for r in spans.roots(s, "serve.search")
              if any(c["name"] == "serve.text" for c in r["children"])]
    return statistics.median(shares) if shares else None
