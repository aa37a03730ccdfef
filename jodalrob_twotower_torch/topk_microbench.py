"""Top-k strategies of a chunk-scanned exact MIPS, timed on the card:
``python -m jodalrob_twotower_torch.topk_microbench`` (port of
``scripts/topk_microbench.py``).

Isolates the candidate selection of ``serving/index.py``'s scan at one
chunk: Q = 1,024 queries against C = 262,144 rows of D = 128, k = 100.

* ``matmul only``: the float32 product [Q, C];
* ``matmul+top_k``: the product and ``torch.topk``;
* ``matmul+approx_max_k``: the reference's approximate selection, a TPU
  primitive. The port selects exactly (``serving/index.py``), so this line
  is ``matmul+top_k`` again, and its JSON says ``"selection": "exact"``;
* ``matmul+maxpool+top_k``: the max over groups of 8 rows, then the exact
  top-k of the C/8 group maxima (the prefilter's first phase);
* ``matmul int8->bf16``: the int8 corpus widened to bf16 against bf16
  queries on the tensor cores (the reference's int8 product; torch returns
  it rounded to bf16, which is widened after);
* ``matmul+chunk_topk first chunk`` and ``later chunk``: the product and
  one step of the scan's own selection, the kernel of ``ops/chunk_topk``,
  from the padding the scan starts from (every slice runs its select) and
  from the running top-k of a previous chunk of the same distribution (the
  threshold rejects almost every score). Each call first restores the
  running top-k (two copies of [Q, k]).

The kernel's variants and ``matmul+top_k`` run again at the serving cells'
Q = 256, k = 400 (``"q"`` and ``"k"`` in each line). The other variants are
plain PyTorch, as the reference's are plain XLA. Each time is the median of
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

Q, C, D, K = 1024, 262_144, 128, 100
POOL = 8
RUNS = 20


def inputs(q: int = Q, c: int = C, d: int = D, device="cuda", seed: int = 0):
    """(queries [q, d] f32, corpus [c, d] f32, corpus_i8 [c, d] int8) drawn
    in the reference's order from ``seed``."""
    rng = np.random.default_rng(seed)
    queries = rng.normal(size=(q, d)).astype(np.float32)
    corpus = rng.normal(size=(c, d)).astype(np.float32)
    corpus_i8 = np.clip(rng.normal(size=(c, d)) * 50, -127, 127).astype(np.int8)
    return tuple(torch.from_numpy(x).to(device) for x in (queries, corpus, corpus_i8))


def mm_only(q: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    return q @ corpus.T


def mm_topk(q: torch.Tensor, corpus: torch.Tensor, k: int = K):
    return torch.topk(q @ corpus.T, k, dim=1)


def mm_maxpool_topk(q: torch.Tensor, corpus: torch.Tensor, k: int = K, pool: int = POOL):
    """The top-k of the maxima over groups of ``pool`` consecutive rows:
    (scores, group indices)."""
    sims = q @ corpus.T
    pooled = sims.view(q.shape[0], corpus.shape[0] // pool, pool).amax(dim=-1)
    return torch.topk(pooled, k, dim=1)


def mm_int8(q: torch.Tensor, corpus_i8: torch.Tensor) -> torch.Tensor:
    """The bf16 product of the bf16 queries and the int8 corpus widened to
    bf16 (exact in bf16), on the tensor cores; its bf16 result widened to
    float32."""
    return (q.to(torch.bfloat16) @ corpus_i8.to(torch.bfloat16).T).float()


def mm_chunk_topk(q: torch.Tensor, corpus: torch.Tensor, start: tuple, state: tuple, row0: int, work=None):
    """The product and one step of the scan's running top-k (``ops/chunk_topk``)
    over its columns as rows ``row0`` on, from ``start`` (scores [Q, k], rows
    [Q, k]) copied into ``state``."""
    from jodalrob_twotower_torch.ops import chunk_topk as ct

    best_s, best_i = state[0].copy_(start[0]), state[1].copy_(start[1])
    return ct.chunk_topk(best_s, best_i, q @ corpus.T, row0, row0 + corpus.shape[0], work)


def kernel_starts(q: torch.Tensor, corpus: torch.Tensor, k: int, seed: int = 1) -> dict:
    """The running top-k a step starts from: ``first chunk``, the scan's
    padding; ``later chunk``, the top k of another chunk of C rows drawn
    as ``inputs`` draws them (rows before this one's)."""
    from jodalrob_twotower_torch.ops import chunk_topk as ct

    fresh = (torch.full((q.shape[0], k), ct.NEG, device=q.device),
             torch.zeros((q.shape[0], k), dtype=torch.int64, device=q.device))
    previous = inputs(q=q.shape[0], c=corpus.shape[0], d=corpus.shape[1], device=q.device, seed=seed)[1]
    later = mm_chunk_topk(q, previous, fresh, tuple(t.clone() for t in fresh), 0)
    return {"first chunk": fresh, "later chunk": tuple(t.clone() for t in later)}


def run(runs: int = RUNS, device="cuda") -> dict:
    """Each variant's line, printed and returned by name (at Q = 256 and
    k = 400, by name and ``@q256_k400``)."""
    from jodalrob_twotower_torch.ops import chunk_topk as ct
    from jodalrob_twotower_torch.utils.profiling import median_ms

    q, corpus, corpus_i8 = inputs(device=device)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=device)  # > the 50 MB L2
    variants = {
        "matmul only": (lambda: mm_only(q, corpus), {}),
        "matmul+top_k": (lambda: mm_topk(q, corpus), {"selection": "exact"}),
        "matmul+approx_max_k": (lambda: mm_topk(q, corpus), {"selection": "exact", "same_as": "matmul+top_k"}),
        "matmul+maxpool+top_k": (lambda: mm_maxpool_topk(q, corpus), {"selection": "exact", "pool": POOL}),
        "matmul int8->bf16": (lambda: mm_int8(q, corpus_i8), {}),
    }
    shapes = {"": (Q, K), "@q256_k400": (256, 400)}
    for suffix, (nq, k) in shapes.items():
        qs = q[:nq]
        if suffix:
            variants["matmul+top_k" + suffix] = (lambda qs=qs, k=k: mm_topk(qs, corpus, k), {"selection": "exact"})
        work = ct.workspace(nq, k, C, qs.device)
        for when, start in kernel_starts(qs, corpus, k).items():
            state = tuple(t.clone() for t in start)
            variants[f"matmul+chunk_topk {when}{suffix}"] = (
                lambda qs=qs, start=start, state=state, work=work: mm_chunk_topk(qs, corpus, start, state, C, work),
                {"selection": "exact"})
    out = {}
    for name, (fn, extra) in variants.items():
        nq, k = shapes["@q256_k400" if name.endswith("@q256_k400") else ""]
        out[name] = {"bench": "topk", "variant": name, "ms": median_ms(fn, flush, runs), "q": nq, "c": C, "d": D,
                     "k": k, **extra}
        print(json.dumps(out[name]), flush=True)
    return out


def kernel_launches_per_run(runs: int = RUNS) -> int:
    """The launches of ``ops/chunk_topk``'s kernel that :func:`run` makes:
    two a step, for each of the two shapes a step that builds the later
    start and, per variant, a warm-up and ``runs`` timed calls."""
    return 2 * 2 * (1 + 2 * (runs + 1))


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
