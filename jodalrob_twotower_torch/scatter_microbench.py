"""Scatter strategies of a sparse rowwise-Adagrad update, timed on the card:
``python -m jodalrob_twotower_torch.scatter_microbench`` (port of
``scripts/scatter_microbench.py``).

N = 65,536 row updates of width D = 64 into a [10,000,000, 64] float32
table with its [R, 1] accumulator (BASELINE config 3's table height, the
cost that dominates the sparse training paths). Plain PyTorch, as the
reference's variants are plain XLA. Variants:

* the update itself (gsq = mean(g^2); acc[r] += gsq; table[r] -= lr g
  rsqrt(acc[r] + 1e-8), the accumulator read after every occurrence):
  ``baseline`` (two ``index_add_`` passes, as ``train/sparse_tables.py``),
  ``sorted_two`` (the same on rows sorted first) and ``fused_sorted`` (one
  [R, D + 1] table + accumulator, the accumulator's new value formed from a
  segment sum over the sorted duplicates, then one ``index_add_``);
* the scatter alone (table[r] += g): ``one_scatter``, ``one_scatter_srt``
  (rows sorted), ``one_scatter_uniq`` (a non-accumulating put of sorted
  rows: UNSAFE where rows repeat, it keeps one of a row's updates, as the
  reference's ``unique_indices=True`` probe is undefined there) and
  ``dedup_scatter`` (duplicates segment-summed first, then one scatter of
  the distinct rows).

Each variant updates its own tables in place; each time is the median of
calls timed alone with CUDA events after an L2 flush
(``utils/profiling.median_ms``). Prints the card's name and power limit,
then one JSON line per variant. The card only.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

R, D, N = 10_000_000, 64, 65_536
LR, EPS = 0.01, 1e-8
RUNS = 20
UPDATE_VARIANTS = ("baseline", "sorted_two", "fused_sorted")
SCATTER_VARIANTS = ("one_scatter", "one_scatter_srt", "one_scatter_uniq", "dedup_scatter")
UNSAFE = ("one_scatter_uniq",)


def inputs(n: int = N, r: int = R, d: int = D, device="cuda", seed: int = 0):
    """(rows [n] int64, grads [n, d] f32) drawn in the reference's order."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, r, n).astype(np.int32)
    grads = rng.normal(size=(n, d)).astype(np.float32)
    return torch.from_numpy(rows).long().to(device), torch.from_numpy(grads).to(device)


def tables(r: int = R, d: int = D, device="cuda") -> dict:
    """The zero table, the accumulator at 0.1 and the fused [R, D + 1]
    table + accumulator. The reference starts its fused accumulator column
    at 0 beside its baseline's 0.1, so the two compute different updates;
    here both start at 0.1, so that every update variant computes one
    function (the times do not depend on the values)."""
    fused = torch.zeros((r, d + 1), device=device)
    fused[:, d] = 0.1
    return {"table": torch.zeros((r, d), device=device), "acc": torch.full((r, 1), 0.1, device=device),
            "fused": fused}


def _segments(rows: torch.Tensor, grads: torch.Tensor):
    """Rows sorted, grads in their order, and each sorted row's segment id
    (the run of equal rows it belongs to)."""
    order = torch.argsort(rows)
    r_s, g_s = rows[order], grads[order]
    start = torch.ones_like(r_s, dtype=torch.bool)
    start[1:] = r_s[1:] != r_s[:-1]
    return r_s, g_s, torch.cumsum(start, 0) - 1


def baseline(table, acc, rows, grads):
    gsq = grads.square().mean(-1, keepdim=True)
    acc.index_add_(0, rows, gsq)
    table.index_add_(0, rows, -LR * grads * torch.rsqrt(acc[rows] + EPS))


def sorted_two(table, acc, rows, grads):
    order = torch.argsort(rows)
    baseline(table, acc, rows[order], grads[order])


def fused_sorted(fused, rows, grads):
    """One scatter of [update, gsq] into the [R, D + 1] table: the
    accumulator's value after every occurrence comes from the segment
    total of gsq over the sorted duplicates."""
    d = fused.shape[1] - 1
    r_s, g_s, seg = _segments(rows, grads)
    q_s = g_s.square().mean(-1)
    totals = torch.zeros(rows.shape[0], device=rows.device).index_add_(0, seg, q_s)
    acc_new = fused[r_s, d] + totals[seg]
    payload = torch.cat([-LR * g_s * torch.rsqrt(acc_new[:, None] + EPS), q_s[:, None]], dim=1)
    fused.index_add_(0, r_s, payload)


def one_scatter(table, rows, grads):
    table.index_add_(0, rows, grads)


def one_scatter_srt(table, rows, grads):
    order = torch.argsort(rows)
    table.index_add_(0, rows[order], grads[order])


def one_scatter_uniq(table, rows, grads):
    """UNSAFE unless rows are distinct: a put of table[r] + g, which keeps
    one of a repeated row's updates."""
    order = torch.argsort(rows)
    r_s = rows[order]
    table.index_put_((r_s,), table[r_s] + grads[order])


def dedup_scatter(table, rows, grads):
    """Sort, segment-sum the duplicates, scatter each distinct row once."""
    r_s, g_s, seg = _segments(rows, grads)
    summed = torch.zeros_like(g_s).index_add_(0, seg, g_s)
    uniq = torch.empty_like(r_s).scatter_(0, seg, r_s)
    n_seg = int(seg[-1]) + 1
    table.index_add_(0, uniq[:n_seg], summed[:n_seg])


def call(name: str, state: dict, rows: torch.Tensor, grads: torch.Tensor) -> None:
    """Variant ``name`` once, on the tables of ``state``."""
    if name in ("baseline", "sorted_two"):
        globals()[name](state["table"], state["acc"], rows, grads)
    elif name == "fused_sorted":
        fused_sorted(state["fused"], rows, grads)
    else:
        globals()[name](state["table"], rows, grads)


def group_first(name: str) -> str:
    """The variant a variant is held to: the first of its group."""
    return UPDATE_VARIANTS[0] if name in UPDATE_VARIANTS else SCATTER_VARIANTS[0]


def result(name: str, state: dict) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(table, accumulator) a variant leaves: the fused table split; the
    scatter-only variants have no accumulator."""
    if name == "fused_sorted":
        return state["fused"][:, :-1], state["fused"][:, -1:]
    return state["table"], (state["acc"] if name in UPDATE_VARIANTS else None)


ATOL = 1e-6  # float32 sums of a row's few updates (|update| <= ~0.05) in another order


def agreement(name: str, state: dict, ref: dict, rows: torch.Tensor) -> dict:
    """A variant's tables after one call against its group's first
    (``baseline`` for the update, ``one_scatter`` for the scatter alone), on
    the rows the updates touch (the rest stay at their start in every
    variant): the largest difference, and whether it is within ATOL. The
    unsafe variant is held only on the rows that occur once, and the rows
    that repeat are counted."""
    group = group_first(name)
    touched, counts = torch.unique(rows, return_counts=True)
    held = touched[counts == 1] if name in UNSAFE else touched
    err = 0.0
    for got, want in zip(result(name, state), result(group, ref)):
        if got is not None:
            err = max(err, float((got[held] - want[held]).abs().max()))
    return {"held_to": group, "max_abs_err": err, "within_tolerance": err <= ATOL,
            "rows_repeated": int((counts > 1).sum())}


def run(runs: int = RUNS, device="cuda") -> dict:
    """Each variant's line, printed and returned by name: its tables after
    one call held to its group's first (:func:`agreement`), then its time."""
    from jodalrob_twotower_torch.utils.profiling import median_ms

    rows, grads = inputs(device=device)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=device)  # > the 50 MB L2
    refs, out = {}, {}
    for name in (*UPDATE_VARIANTS, *SCATTER_VARIANTS):
        state = tables(device=device)
        call(name, state, rows, grads)
        if name == group_first(name):
            refs[name] = {k: v.clone() for k, v in state.items()}
        check = agreement(name, state, refs[group_first(name)], rows)
        if not check["within_tolerance"]:
            raise RuntimeError(f"scatter_microbench: {name} differs from {check['held_to']} by {check['max_abs_err']}")
        ms = median_ms(lambda: call(name, state, rows, grads), flush, runs)
        out[name] = {"bench": "scatter", "variant": name, "ms": ms, "rows": R, "d": D, "updates": N,
                     "unsafe_with_duplicates": name in UNSAFE, **check}
        print(json.dumps(out[name]), flush=True)
        del state
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.parse_args(argv)
    from jodalrob_twotower_torch.bench import card_line
    from jodalrob_twotower_torch.device import resolve_device

    resolve_device(None)
    print(card_line(), flush=True)
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
