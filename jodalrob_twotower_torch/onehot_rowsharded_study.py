"""The one-hot lookup under row-sharded tables, measured on the card:
``python -m jodalrob_twotower_torch.onehot_rowsharded_study`` (port of
``scripts/onehot_rowsharded_study.py``).

A row-sharded one-hot forward would have each of n ranks run the lookup
over its R/n table rows against the whole global batch's ids, then sum the
[B, K, D] partial embeddings over the ranks (each row is owned by one rank,
the others add zeros). The replicated form
(``parallel/sharded_embedding.py``, what "auto" picks for tables up to
65,536 rows) has each rank run it over the whole table against its B/n
batch block, with no collective. The study times the lookup kernel (K1,
``csrc/onehot_lookup.cu``) at the three shapes that compare the two at
n = 8: the whole (R, B), a row shard's work (R/8, B) and a batch block's
work (R, B/8), at K = 32 features of width D = 32, and prints the bytes
the row-sharded form would add to every step: one [B, K, D] bf16 sum.

Each time is the median of launches timed alone with CUDA events after an
L2 flush (``utils/profiling.median_ms``). Prints the card's name and power
limit, then one JSON line per shape and the verdict line. The card only:
a timing without one is refused.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from jodalrob_twotower_torch.models.embedding import table_layout, tile_feature_map
from jodalrob_twotower_torch.ops.embedding_grad import dense_table_lookup

K, D = 32, 32
SHAPES = (  # name, vocab per feature, batch
    ("full_R_fullB", 1000, 8192),  # one device's shape
    ("eighth_R_fullB", 125, 8192),  # a row shard's work at n = 8
    ("full_R_eighthB", 1000, 1024),  # a batch block's work at n = 8
)
WIRE_BATCH = 8192  # the global batch whose [B, K, D] bf16 partials the row-sharded form sums
RUNS = 100


def lookup_inputs(vocab: int, batch: int, device, seed: int = 0):
    """(table [R, D] f32, rows [B, K] int32 absolute, tile_feature [R/128])
    of K features of ``vocab`` ids each, from ``seed``."""
    vocabs = (vocab,) * K
    offsets, total = table_layout(vocabs)
    rng = np.random.default_rng(seed)
    rows = (rng.integers(0, vocab, size=(batch, K)) + offsets[None, :]).astype(np.int32)
    table = rng.normal(size=(total, D)).astype(np.float32)
    return (torch.from_numpy(table).to(device), torch.from_numpy(rows).to(device),
            torch.from_numpy(tile_feature_map(vocabs)).to(device))


def measure(name: str, vocab: int, batch: int, flush: torch.Tensor, runs: int = RUNS) -> dict:
    """K1's median ms at one shape, on the card."""
    from jodalrob_twotower_torch.utils.profiling import median_ms

    table, rows, tf = lookup_inputs(vocab, batch, flush.device)
    ms = median_ms(lambda: dense_table_lookup(table, rows, tf), flush, runs)
    probe = float(dense_table_lookup(table, rows, tf)[0, 0, 0])
    return {"bench": f"onehot_lookup_{name}", "ms_per_call": ms, "rows": int(table.shape[0]), "b": batch,
            "k": K, "d": D, "probe": probe}


def verdict(rows: dict) -> dict:
    """The row-sharded form's kernel saving at n = 8 (a batch block's
    lookup minus a row shard's) beside the bytes it adds to every step."""
    return {"bench": "onehot_rowsharded_verdict", "extra_wire_bytes_per_step": WIRE_BATCH * K * D * 2,
            "row_sharded_kernel_saving_ms": rows["full_R_eighthB"]["ms_per_call"]
            - rows["eighth_R_fullB"]["ms_per_call"],
            "full_ms": rows["full_R_fullB"]["ms_per_call"]}


def run(runs: int = RUNS, device="cuda") -> dict:
    """Every shape's line and the verdict, printed and returned by name."""
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=device)  # > the 50 MB L2
    out = {}
    for name, vocab, batch in SHAPES:
        out[name] = measure(name, vocab, batch, flush, runs)
        print(json.dumps(out[name]), flush=True)
    out["verdict"] = verdict(out)
    print(json.dumps(out["verdict"]), flush=True)
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
