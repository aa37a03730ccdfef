"""Sharded serving over gloo or NCCL ranks:
``python -m jodalrob_twotower_torch.sharded_serving_bench [--ranks N]
[--force-cpu]`` (port of ``scripts/sharded_serving_bench.py``).

``ShardedIndex`` (each rank scores its block of the corpus, all-gathers
its k candidates and merges) over 200,000 unit rows of width 128, 1,024
unit queries at k = 100, in three kinds: ``exact``, ``int8`` and ``int8``
with a bf16 rescore at depth 400. Each kind's second search is timed (wall
ms per 1,024 queries, the first builds and warms), and its recall against
the exact answers of one device's ``BruteForceIndex`` is set beside the
recall of one device's index of the same kind. The reference's claim:
the sharded merge's recall equals one device's. For ``exact`` and ``int8``
every query's set must equal one device's but for rows tied within
``TIE_ATOL`` at the k-th score (``ties_only``); with the rescore each rank
rescores its own 400 candidates, so the merge sees more of them than one
device's 400 and its recall may only be higher.

The reference ran 8 virtual CPU devices; ``--ranks`` (default 2) sets the
ranks here (``parallel/distributed.script_ranks``: on one card they share
it over gloo, so the times are no claim about scaling). Runs on the card;
``--force-cpu`` asks for gloo ranks on the CPU. Prints the card's name and
power limit first, then one JSON line per kind.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

N_CORPUS, DIM, N_QUERIES, K = 200_000, 128, 1024, 100
RESCORE_DEPTH = 400
KINDS = {"exact": {"kind": "exact"}, "int8": {"kind": "int8"},
         "int8_rescore": {"kind": "int8", "rescore_depth": RESCORE_DEPTH, "rescore_dtype": "bfloat16"}}
TIE_ATOL = 1e-5


def unit_data(n_corpus: int, n_queries: int, dim: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(corpus, queries) of unit rows, drawn in the reference's order."""
    rng = np.random.default_rng(seed)
    corpus = rng.normal(size=(n_corpus, dim)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    queries = rng.normal(size=(n_queries, dim)).astype(np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    return corpus, queries


def ties_only(got, want) -> int:
    """The queries whose sets differ from ``want``'s; raises unless every
    row in one set and not the other scores within TIE_ATOL of ``want``'s
    k-th score."""
    differing = 0
    for gs, gi, ws, wi in zip(got.scores, got.indices, want.scores, want.indices):
        a, b = set(gi.tolist()), set(wi.tolist())
        if a == b:
            continue
        differing += 1
        kth = ws[-1]
        apart = [s for s, i in zip(gs, gi) if i not in b] + [s for s, i in zip(ws, wi) if i not in a]
        if max(abs(s - kth) for s in apart) > TIE_ATOL:
            raise RuntimeError(f"sharded_serving_bench: a query's rows differ from one device's beyond ties "
                               f"(scores {apart} against the k-th {kth})")
    return differing


def rank_run(devices: list, n_corpus: int, n_queries: int, dim: int, k: int, query_chunk: int) -> list[dict]:
    """One rank: every kind's sharded search, timed, against one device's."""
    from jodalrob_twotower_torch.parallel.mesh import make_mesh
    from jodalrob_twotower_torch.serving.index import BruteForceIndex, Int8Index, ShardedIndex, recall_vs_exact

    mesh = make_mesh(devices)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)

    def sync():
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    corpus, queries = unit_data(n_corpus, n_queries, dim)
    exact = BruteForceIndex(corpus, query_chunk=query_chunk, device=mesh.device).search(queries, k)
    rows = []
    for name, kw in KINDS.items():
        index = ShardedIndex(corpus, mesh, query_chunk=query_chunk, **kw)
        index.search(queries, k)  # builds and warms
        sync()
        t0 = time.perf_counter()
        res = index.search(queries, k)
        sync()
        dt = time.perf_counter() - t0
        single_kw = {key: v for key, v in kw.items() if key != "kind"}
        single = (BruteForceIndex(corpus, query_chunk=query_chunk, device=mesh.device) if kw["kind"] == "exact"
                  else Int8Index(corpus, query_chunk=query_chunk, device=mesh.device, **single_kw)).search(queries, k)
        recall, single_recall = recall_vs_exact(res, exact), recall_vs_exact(single, exact)
        row = {"bench": f"serving_sharded_mesh_{name}", "backend": mesh.backend, "device": str(mesh.device),
               "n_ranks": mesh.size, "corpus_size": n_corpus, "queries": n_queries, "k": k,
               "wall_ms_per_1024q": dt * 1e3 * 1024 / n_queries, "recall_vs_exact_at100": recall,
               "single_device_recall": single_recall, "shard_rows": index.shard_rows}
        if name == "int8_rescore":
            if recall < single_recall:
                raise RuntimeError(f"sharded_serving_bench: {name} recall {recall} below one device's {single_recall}")
        else:
            row["queries_differing_at_ties"] = ties_only(res, single)
        rows.append(row)
    return rows


def run(n_ranks: int, force_cpu: bool, *, n_corpus: int = N_CORPUS, n_queries: int = N_QUERIES, dim: int = DIM,
        k: int = K, query_chunk: int = 1024) -> list[dict]:
    """Rank 0's lines; every rank's answers must agree (their recalls)."""
    from jodalrob_twotower_torch.parallel.distributed import launch_script

    ranks, _ = launch_script(rank_run, n_ranks, (n_corpus, n_queries, dim, k, query_chunk), force_cpu)
    for r in ranks[1:]:
        if [x["recall_vs_exact_at100"] for x in r] != [x["recall_vs_exact_at100"] for x in ranks[0]]:
            raise RuntimeError("sharded_serving_bench: the ranks' recalls differ")
    return ranks[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=2, help="mesh ranks (the reference's 8 virtual devices)")
    p.add_argument("--force-cpu", action="store_true", help="gloo ranks on the CPU instead of the card")
    args = p.parse_args(argv)
    if not args.force_cpu:
        from jodalrob_twotower_torch.bench import card_line
        from jodalrob_twotower_torch.device import resolve_device

        resolve_device(None)
        print(card_line(), flush=True)
    for row in run(args.ranks, args.force_cpu):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
