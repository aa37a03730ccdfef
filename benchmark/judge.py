"""The comparison that decides ``correct``: the numbers read from the
program's output against the reference's, each beside its limit
(``limits/<cell>.json``). A number at or below its limit passes; the run is
correct when every number passes and no answer failed.
"""

from __future__ import annotations

import math
import statistics

# a leaf whose reference gradient is under this share of the median leaf's
# moves by round-off alone under Adam, so its change is not compared
MOVED_LEAF_SHARE = 1e-3


def _relative_gaps(prog: dict, ref: dict, keys) -> dict:
    """|prog norm - ref norm| over the larger of the leaf's reference norm
    and the median leaf's, per leaf."""
    median = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in keys}


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` each hold ``losses`` (the first steps'),
    ``grad_norms`` (every leaf's at the first step, as the optimizer got it)
    and ``change_norms`` (every leaf's change over those steps)."""
    if not all(math.isfinite(x) for x in prog["losses"]):
        return {"loss_gap": math.inf, "grad_gap": math.inf, "update_gap": math.inf}
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"], strict=True))
    grad = _relative_gaps(prog["grad_norms"], ref["grad_norms"], ref["grad_norms"])
    g_median = statistics.median(ref["grad_norms"].values())
    moved = [k for k, g in ref["grad_norms"].items() if g >= MOVED_LEAF_SHARE * g_median]
    change = _relative_gaps(prog["change_norms"], ref["change_norms"], moved)
    return {"loss_gap": loss_gap, "grad_gap": max(grad.values()), "update_gap": max(change.values()),
            "_worst_grad_leaf": max(grad, key=grad.get), "_worst_update_leaf": max(change, key=change.get)}


def serve_numbers(prog_scores, prog_rows, ref_best, ref_of_prog) -> dict:
    """Over the sampled queries ([Q, k] each, numpy or tensors):
    ``score_gap``, the widest gap between a served score and the reference's
    score of the same company; ``rank_gap``, the widest amount by which the
    company served at rank r scores, by the reference, below the reference's
    r-th best. Both are 0 for an exact float32 scan of the reference."""
    return {"score_gap": float(abs(prog_scores - ref_of_prog).max()),
            "rank_gap": float(max((ref_best - ref_of_prog).max(), 0.0))}


def verdict(numbers: dict, limits: dict, failed: int) -> tuple[bool, list]:
    """(correct, [[name, value, limit], ...]) for every limited number."""
    checks = [[name, numbers[name], limit] for name, limit in limits.items() if not name.startswith("_")]
    ok = failed == 0 and all(v <= lim for _, v, lim in checks)
    return ok, checks
