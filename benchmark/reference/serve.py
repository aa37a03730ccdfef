"""The reference's retrieval: the company corpus and the queries encoded by
the reference towers in inference form, and an exact maximum-inner-product
top-k over the whole corpus, block by block so that it fits beside nothing.
"""

from __future__ import annotations

import torch

from benchmark.reference.model import fp8, tf32, tower


@torch.no_grad()
def encode(weights: dict, side_name: str, side: dict, model: dict, dense, cat_ids, *, chunk: int = 262_144,
           prec: str = "f32") -> torch.Tensor:
    """[N, final] float32 embeddings of a whole store, ``chunk`` rows at a time."""
    out = [tower(weights, side_name, side, model, dense[a : a + chunk], cat_ids[a : a + chunk], train=False,
                 prec=prec) for a in range(0, dense.shape[0], chunk)]
    return torch.cat(out)


@torch.no_grad()
def exact_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int, *, chunk: int = 1 << 20,
               prec: str = "f32") -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, k] descending, rows [Q, k] int64): the k largest q . c over
    every corpus row, scanned ``chunk`` rows at a time."""
    if prec == "tf32":
        queries, corpus = tf32(queries), tf32(corpus)
    best_s = torch.full((queries.shape[0], 0), 0.0, device=queries.device)
    best_i = torch.zeros((queries.shape[0], 0), dtype=torch.int64, device=queries.device)
    for a in range(0, corpus.shape[0], chunk):
        s, i = torch.topk(queries @ corpus[a : a + chunk].T, min(k, corpus[a : a + chunk].shape[0]), dim=1)
        best_s, sel = torch.topk(torch.cat([best_s, s], dim=1), min(k, best_s.shape[1] + s.shape[1]), dim=1)
        best_i = torch.gather(torch.cat([best_i, i + a], dim=1), 1, sel)
    return best_s, best_i


@torch.no_grad()
def int4_rescored_topk(queries: torch.Tensor, corpus: torch.Tensor, k: int, depth: int, *,
                       chunk: int = 1 << 20) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 index's two passes one precision step down, as a control:
    corpus rows quantized to int4 (symmetric, one scale a row: max |x| / 7),
    the bf16 query's scores against them, the best ``depth`` kept, then
    those rescored against the rows in float8 and the best k returned."""
    scale = corpus.abs().amax(dim=1, keepdim=True) / 7.0
    rows4 = torch.clamp(torch.round(corpus / torch.where(scale > 0, scale, 1.0)), -7, 7) * scale
    q = queries.to(torch.bfloat16).float()
    _, cand = exact_topk(q, rows4, depth, chunk=chunk)
    s = torch.einsum("qd,qkd->qk", q, fp8(corpus)[cand])
    best, sel = torch.topk(s, k, dim=1)
    return best, torch.gather(cand, 1, sel)


@torch.no_grad()
def scores_of(queries: torch.Tensor, corpus: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """[Q, k] float32: each query's exact score against the rows named for it
    (rows must lie in [0, N))."""
    return torch.einsum("qd,qkd->qk", queries, corpus[rows])
