"""Row-sharded feature stores at a size too big to replicate cheaply:
``python -m jodalrob_twotower_torch.rowsharded_store_bench [--ranks N]
[--force-cpu]`` (port of ``scripts/rowsharded_store_bench.py``).

The reference's store, nothing cut: 1,000,000 notices of 256 float32
numeric features and 8 categoricals (vocab 1,000), and 1,000,000 companies
of 64 and 4; 1,266.5 MiB in all. ``make_sharded_indexed_train`` at B =
1,024, ``n_inner`` = 4 steps per call, runs under ``store_sharding``
"rows" (each rank holds its block of every store matrix, padded to a
multiple of the ranks, and gathers a batch's rows through the row exchange)
and "replicated" (each rank a whole copy). Towers (256, 128) -> 64, float32,
no dropout, temperature 1. For each mode: ms per step (5 timed calls after
one warm-up call, ended by fetching the last loss), the whole store's MiB
and the MiB each rank holds. The warm-up call's four losses of the two
modes must be equal bit for bit: the exchange moves each row from the one
rank that holds it, so both modes train on the same batches.

The reference ran 8 virtual CPU devices; ``--ranks`` (default 2) sets the
ranks here (``parallel/distributed.script_ranks``: on one card they share
it over gloo, staged through the host, so the times are no claim about
scaling). Runs on the card; ``--force-cpu`` asks for gloo ranks on the CPU
(with ``--rows`` cut). Prints the card's name and power limit first, then
one JSON line per mode and one comparing them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

N_ROWS = 1_000_000
N_PAIRS = 100_000
BATCH = 1024
N_INNER = 4
REPS = 5
MODES = ("rows", "replicated")


def store_schema():
    from jodalrob_twotower_torch.schema import CategoricalSpec, NumericSpec, SideSchema, TwoTowerSchema

    def side(table, n_num, n_cat):
        return SideSchema(table=table, pk=("pk",), numeric=tuple(NumericSpec(f"n{i}") for i in range(n_num)),
                          categorical=tuple(CategoricalSpec(f"c{i}", vocab_size=1000) for i in range(n_cat)))

    return TwoTowerSchema(notice=side("notice", 256, 8), company=side("company", 64, 4))


def store_data(n_rows: int, n_pairs: int, seed: int = 0) -> dict:
    """The stores and pairs, drawn in the reference's order from ``seed``."""
    rng = np.random.default_rng(seed)
    n_dense = rng.normal(size=(n_rows, 256)).astype(np.float32)
    n_cat = rng.integers(0, 1000, size=(n_rows, 8)).astype(np.int32)
    c_dense = rng.normal(size=(n_rows, 64)).astype(np.float32)
    c_cat = rng.integers(0, 1000, size=(n_rows, 4)).astype(np.int32)
    pairs = rng.integers(0, n_rows, size=(n_pairs, 2)).astype(np.int32)
    return {"notice": (n_dense, n_cat), "company": (c_dense, c_cat), "pairs": pairs}


def bench_config(mode: str, batch: int):
    from jodalrob_twotower_torch.config import DataConfig, LossConfig, MeshConfig, ModelConfig, OptimizerConfig
    from jodalrob_twotower_torch.config import TrainConfig

    return TrainConfig(model=ModelConfig(tower_hidden_dims=(256, 128), final_embedding_dim=64, dropout_rate=0.0,
                                         compute_dtype="float32"),
                       loss=LossConfig(temperature=1.0), optimizer=OptimizerConfig(),
                       data=DataConfig(batch_size=batch), mesh=MeshConfig(store_sharding=mode), results_csv="")


def rank_run(devices: list, n_rows: int, n_pairs: int, batch: int, n_inner: int, reps: int) -> dict:
    """One rank: each mode's warm-up and timed calls from one seeded state."""
    from jodalrob_twotower_torch.models import build_model
    from jodalrob_twotower_torch.parallel.mesh import make_mesh
    from jodalrob_twotower_torch.parallel.sharded_train import make_sharded_indexed_train
    from jodalrob_twotower_torch.utils.profiling import kernel_launches

    mesh = make_mesh(devices)
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.set_device(mesh.device)
    data = store_data(n_rows, n_pairs)
    schema = store_schema()
    pairs = data["pairs"]
    store_bytes = sum(m.nbytes for side in ("notice", "company") for m in data[side])
    out = {"rank": mesh.rank, "backend": mesh.backend, "device": str(mesh.device)}
    for mode in MODES:
        cfg = bench_config(mode, batch)
        model = build_model(schema, cfg, mesh).init_flax(torch.Generator().manual_seed(cfg.seed))
        state, _, scan_steps, _, put_idx, put_store = make_sharded_indexed_train(model, cfg, mesh, batch, 100,
                                                                                n_inner=n_inner)
        n_store, c_store = put_store(data["notice"]), put_store(data["company"])
        per_rank = sum(t.numel() * t.element_size() for t in (*n_store, *c_store))
        stack = put_idx(np.stack([pairs[i * batch:(i + 1) * batch] for i in range(n_inner)]))
        before = kernel_launches()
        state, metrics = scan_steps(state, stack, n_store, c_store)  # warm-up
        first_losses = metrics["loss"].tolist()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            state, metrics = scan_steps(state, stack, n_store, c_store)
        last = float(metrics["loss"][-1])
        dt = (time.perf_counter() - t0) / (reps * n_inner)
        after = kernel_launches()
        out[mode] = {"bench": f"train_rowsharded_store_{mode}", "ms_per_step": dt * 1e3,
                     "examples_per_sec": batch / dt, "store_total_mb": store_bytes / 2**20,
                     "store_per_rank_mb": per_rank / 2**20, "store_rows_per_rank": int(n_store[0].shape[0]),
                     "batch": batch, "n_inner": n_inner, "ranks": mesh.size, "first_losses": first_losses,
                     "last_loss": last, "launches": {k: after[k] - before[k] for k in after}}
        del n_store, c_store, state
    return out


def run(n_ranks: int, force_cpu: bool, *, n_rows: int = N_ROWS, n_pairs: int = N_PAIRS, batch: int = BATCH,
        n_inner: int = N_INNER, reps: int = REPS) -> list[dict]:
    """Rank 0's lines and the comparison; raises if the modes' losses
    differ, the ranks' losses differ, or "rows" does not hold 1/n of the
    (padded) rows on each rank."""
    from jodalrob_twotower_torch.parallel.distributed import launch_script

    ranks, _ = launch_script(rank_run, n_ranks, (n_rows, n_pairs, batch, n_inner, reps), force_cpu)
    r0 = ranks[0]
    for r in ranks[1:]:
        if [r[m]["first_losses"] for m in MODES] != [r0[m]["first_losses"] for m in MODES]:
            raise RuntimeError("rowsharded_store_bench: the ranks' losses differ")
    if r0["rows"]["first_losses"] != r0["replicated"]["first_losses"]:
        raise RuntimeError(f"rowsharded_store_bench: the modes' losses differ: {r0['rows']['first_losses']} "
                           f"vs {r0['replicated']['first_losses']}")
    padded = -(-n_rows // n_ranks)
    if (any(r["rows"]["store_rows_per_rank"] != padded for r in ranks)
            or r0["replicated"]["store_rows_per_rank"] != n_rows):
        raise RuntimeError("rowsharded_store_bench: a rank does not hold its 1/n of the store's rows")
    compare = {"bench": "train_rowsharded_store_compare", "losses_equal": True, "ranks": n_ranks,
               "rows_per_rank": padded, "per_rank_mb": {m: r0[m]["store_per_rank_mb"] for m in MODES},
               "ms_per_step": {m: r0[m]["ms_per_step"] for m in MODES},
               "rows_over_replicated_ms": r0["rows"]["ms_per_step"] / r0["replicated"]["ms_per_step"]}
    return [r0["rows"], r0["replicated"], compare]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, default=2, help="mesh ranks (the reference's 8 virtual devices)")
    p.add_argument("--rows", type=int, default=N_ROWS, help="rows of each store (the reference's 1,000,000)")
    p.add_argument("--force-cpu", action="store_true", help="gloo ranks on the CPU instead of the card")
    args = p.parse_args(argv)
    if not args.force_cpu:
        from jodalrob_twotower_torch.bench import card_line
        from jodalrob_twotower_torch.device import resolve_device

        resolve_device(None)
        print(card_line(), flush=True)
    for row in run(args.ranks, args.force_cpu, n_rows=args.rows):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
