"""Strong scaling of the mesh train step:
``python -m jodalrob_twotower_torch.scaling_sweep [--devices 1 2 ...]
[--force-cpu]`` (port of ``scripts/scaling_sweep.py``).

The same ``make_sharded_train`` program at a fixed global batch of 4,096
on meshes of each size in ``--devices`` (default 1 and 2; the reference
swept 1, 2, 4 and 8), reporting examples/s, ms per step and ``vs_1dev``,
the examples/s over the first size's. Strong scaling, because the in-batch
negatives' loss grows with the global batch. The script's model: towers
(256, 128) -> 64, categorical embeddings of 32, the dense projection 64,
no dropout, on the synthetic planted-cluster data of 20,000 notices and
companies (64 clusters, 4 batches of pairs). One warm-up step, then 12
timed steps ended by fetching the loss. At D = 64 the CE is outside the
fused kernels' envelope (D % 128 == 0) and takes the materialized path, so
the step launches the lookup (K1) and the table gradient (K2) only.

A mesh of one is this process with no process group (its collectives do
nothing, as the reference's one-device mesh has none); larger meshes are
ranks of ``parallel/distributed.script_ranks``: on one card they share it
over gloo, staged through the host, so ``vs_1dev`` there measures gloo,
not scaling. Runs on the card; ``--force-cpu`` asks for the CPU. Prints
the card's name and power limit first, then one JSON line per size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

GLOBAL_BATCH = 4096
STEPS = 12
N_ROWS = 20_000


def sweep_config():
    from jodalrob_twotower_torch.config import ModelConfig, TrainConfig

    return TrainConfig(model=ModelConfig(categorical_embedding_dim=32, dense_projection_dim=64,
                                         tower_hidden_dims=(256, 128), final_embedding_dim=64, dropout_rate=0.0))


def measure(devices: list, batch: int, steps: int, n_rows: int) -> dict:
    """One rank of a mesh over ``devices`` (with no process group, a mesh
    of one): the warm-up step and ``steps`` timed ones."""
    from jodalrob_twotower_torch.data.pipeline import assemble_pair_batch
    from jodalrob_twotower_torch.data.synthetic import make_synthetic_dataset
    from jodalrob_twotower_torch.models import build_model
    from jodalrob_twotower_torch.parallel.mesh import make_mesh
    from jodalrob_twotower_torch.parallel.sharded_train import make_sharded_train
    from jodalrob_twotower_torch.utils.profiling import kernel_launches

    mesh = make_mesh(devices)
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.set_device(mesh.device)
    cfg = sweep_config()
    ds = make_synthetic_dataset(n_notices=n_rows, n_companies=n_rows, n_pairs=4 * batch, n_clusters=64, seed=0)
    model = build_model(ds.schema, cfg, mesh).init_flax(torch.Generator().manual_seed(cfg.seed))
    state, step, shard_batch = make_sharded_train(model, cfg, mesh, batch, 100)
    dev_batch = shard_batch(assemble_pair_batch(ds.notice_store, ds.company_store, ds.pairs[:batch]))
    state, m = step(state, dev_batch)  # warm-up
    first_loss = float(m["loss"])
    before = kernel_launches()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step(state, dev_batch)
    loss = float(m["loss"])
    dt = time.perf_counter() - t0
    after = kernel_launches()
    if not np.isfinite(loss):
        raise RuntimeError(f"scaling_sweep: non-finite loss {loss} on {mesh.size} devices")
    return {"devices": mesh.size, "global_batch": batch, "examples_per_sec": steps * batch / dt,
            "step_ms": dt / steps * 1e3, "first_loss": first_loss, "loss": loss, "backend": mesh.backend,
            "device": str(mesh.device), "launches": {k: after[k] - before[k] for k in after}}


def run(ns, force_cpu: bool, *, batch: int = GLOBAL_BATCH, steps: int = STEPS, n_rows: int = N_ROWS) -> list[dict]:
    from jodalrob_twotower_torch.parallel.distributed import launch_script, script_ranks

    rows = []
    for n in ns:
        if n == 1:
            rows.append(measure(script_ranks(1, force_cpu)[0], batch, steps, n_rows))
        else:
            ranks, _ = launch_script(measure, n, (batch, steps, n_rows), force_cpu)
            rows.append(ranks[0])
    base = rows[0]["examples_per_sec"]
    for r in rows:
        r["vs_1dev"] = r["examples_per_sec"] / base
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--devices", type=int, nargs="+", default=[1, 2], help="mesh sizes, the first the baseline")
    p.add_argument("--force-cpu", action="store_true", help="run on the CPU instead of the card")
    args = p.parse_args(argv)
    if not args.force_cpu:
        from jodalrob_twotower_torch.bench import card_line
        from jodalrob_twotower_torch.device import resolve_device

        resolve_device(None)
        print(card_line(), flush=True)
    for row in run(args.devices, args.force_cpu):
        print(json.dumps({"bench": "scaling_sweep", **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
