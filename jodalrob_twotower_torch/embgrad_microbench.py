"""The dense table gradient in its two layouts, timed on the card:
``python -m jodalrob_twotower_torch.embgrad_microbench`` (port of
``scripts/embgrad_microbench.py``).

From the towers' native [B, K, D] cotangent, at the bench's shape (B =
8192, K = 32 features of 1,000 ids, D = 32, a 32,768-row table):

* ``k2_rows_major``: K2 (``dense_table_grad``), the [R, D] gradient the
  training step uses;
* ``k3_bmajor``: K3 (``dense_table_grad_bmajor``), the same gradient
  stored [D, R], the layout the reference's ``dense_table_grad_bmajor``
  returns. It is K2's kernel with a transposed store, and its output must
  be K2's transposed, bit for bit.

The reference compared a relayout of the cotangent plus its lane-major
kernel with the batch-major kernel that needs no relayout; the CUDA kernels
read the native layout either way, so the two rows here differ only in the
store. Each time is the median of launches timed alone with CUDA events
after an L2 flush (``utils/profiling.median_ms``). Prints the card's name
and power limit, then one JSON line per variant. The card only.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from jodalrob_twotower_torch.models.embedding import table_layout, tile_feature_map
from jodalrob_twotower_torch.ops.embedding_grad import dense_table_grad, dense_table_grad_bmajor

B, K, D = 8192, 32, 32
VOCAB = 1000
RUNS = 100


def grad_inputs(batch: int = B, features: int = K, dim: int = D, vocab: int = VOCAB, device="cuda", seed: int = 0):
    """(rows [B, K] int32 absolute, g [B, K, D] f32, tile_feature) from
    ``seed``: ids uniform over each feature's vocab, g ~ N(0, 1)."""
    vocabs = (vocab,) * features
    offsets, _ = table_layout(vocabs)
    rng = np.random.default_rng(seed)
    rows = (rng.integers(0, vocab, size=(batch, features)) + offsets[None, :]).astype(np.int32)
    g = rng.normal(size=(batch, features, dim)).astype(np.float32)
    return (torch.from_numpy(rows).to(device), torch.from_numpy(g).to(device),
            torch.from_numpy(tile_feature_map(vocabs)).to(device))


VARIANTS = {"k2_rows_major": dense_table_grad, "k3_bmajor": dense_table_grad_bmajor}


def run(runs: int = RUNS, device="cuda") -> dict:
    """Each variant's line, printed and returned by name; K3 checked against
    K2 transposed."""
    from jodalrob_twotower_torch.utils.profiling import median_ms

    rows, g, tf = grad_inputs(device=device)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=device)  # > the 50 MB L2
    k2 = dense_table_grad(rows, g, tf)
    k3 = dense_table_grad_bmajor(rows, g, tf)
    equal = bool(torch.equal(k3, k2.t()))
    if not equal:
        raise RuntimeError("embgrad_microbench: K3's [D, R] gradient is not K2's transposed bit for bit")
    out = {}
    for name, fn in VARIANTS.items():
        ms = median_ms(lambda fn=fn: fn(rows, g, tf), flush, runs)
        out[name] = {"bench": f"embgrad_{name}", "ms_per_call": ms, "b": B, "k": K, "d": D,
                     "rows": int(k2.shape[0]), "probe": float(k2[int(rows[0, 0])].sum()),
                     "equal_to_k2_transposed": equal}
        print(json.dumps(out[name]), flush=True)
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
