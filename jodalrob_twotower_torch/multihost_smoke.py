"""The multi-process training recipe, run for real:
``python -m jodalrob_twotower_torch.multihost_smoke [--processes N]
[--force-cpu]`` (port of ``scripts/multihost_smoke.py``).

N processes (default 2), one device each, through the port's launcher
(``parallel/distributed.launch``: in-process spawn, no subprocess that
needs the package on its path). Every process builds the same synthetic
data from seed 0, keeps its own pairs (``host_shard_pairs`` over the data
axis) and feeds its rows of each global batch (``host_local_batch_to_global``).
The checks, the reference's:

* each process keeps 1/N of the pairs;
* three ``make_sharded_train`` steps with row-sharded tables
  (``embedding_sharding="gspmd_rows"``): the losses finite and equal on
  every process, falling;
* the mesh's fused CE: its first loss within 1e-3 of the materialized one;
* each process holds 1/N of every table's rows;
* the streaming ``Trainer`` (``train_streaming``'s source over chunks of
  512 pairs, each process its lockstep share): equal batch counts on every
  process, equal and finite losses;
* the int16 compressed ``Trainer``: equal and finite losses; on the card
  its replicated tables (embed width 8) take the dense table gradient (K2)
  twice a step on every process, and the gather forward (the reference's
  "auto" keeps the one-hot lookup for bfloat16 towers, these are float32);
* a row-sharded store (1/N of its rows on each process): the row
  exchange's gather equal to a host gather;
* "global" negatives under the compressed sync's "none": the first loss
  within 1e-3 of the sharded step's and equal on every process.

The reference counted ``processes x 4`` global devices; a port process
drives one device, so the mesh's size must equal the processes. The
streaming leg reads a parquet file of the pairs with ``--force-cpu``; on
the card, whose machine has no pyarrow, it is fed the same chunks from
memory. Runs on the card (ranks sharing one card over gloo,
``parallel/distributed.script_ranks``); ``--force-cpu`` asks for gloo
ranks on the CPU. Prints the card's name and power limit first, then each
process's JSON line and the summary ``{"bench": "multihost_smoke", "ok":
true, ...}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

BATCH = 64
CHUNK_ROWS = 512
N_ROWS, N_PAIRS = 512, 2048
COMPRESSED_PAIRS = 1024  # the compressed Trainer's epoch
FUSED_ATOL = 1e-3


def smoke_config():
    from jodalrob_twotower_torch.config import DataConfig, LossConfig, MeshConfig, ModelConfig, OptimizerConfig
    from jodalrob_twotower_torch.config import TrainConfig

    return TrainConfig(
        model=ModelConfig(categorical_embedding_dim=8, dense_projection_dim=16, tower_hidden_dims=(32, 16),
                          final_embedding_dim=8, dropout_rate=0.0, compute_dtype="float32", use_batch_norm=False),
        loss=LossConfig(temperature=0.5, use_fused_logits=False),
        optimizer=OptimizerConfig(learning_rate=1e-2),
        data=DataConfig(batch_size=BATCH),
        # row-sharded tables: the smoke checks each process holds 1/N of the
        # rows ("auto" would replicate these small vocabs)
        mesh=MeshConfig(embedding_sharding="gspmd_rows"),
    )


def memory_pair_chunks(pairs: np.ndarray, chunk_rows: int, host_index: int, host_count: int):
    """The chunks ``stream_pair_chunks`` reads from a file of ``pairs`` (all
    keys present): consecutive ``chunk_rows`` rows, each trimmed to a
    multiple of the hosts and cut to the host's strided share."""
    for start in range(0, len(pairs), chunk_rows):
        rows = np.asarray(pairs[start:start + chunk_rows], np.int64)
        per_host = len(rows) // host_count
        if per_host:
            yield np.ascontiguousarray(rows[host_index::host_count][:per_host])


def _built(schema, cfg, mesh):
    from jodalrob_twotower_torch.models import build_model

    return build_model(schema, cfg, mesh).init_flax(torch.Generator().manual_seed(cfg.seed))


def _streaming_leg(cfg, ds, mesh, source: str, workdir: Path) -> tuple[int, float]:
    """(this process's batch count, the streamed epoch's train loss)."""
    from jodalrob_twotower_torch.data.parquet_stream import stream_pair_chunks, streaming_index_batches
    from jodalrob_twotower_torch.train.trainer import Trainer

    local_b = BATCH // mesh.size
    cfg_stream = cfg.replace(results_csv="")
    trainer = Trainer(cfg_stream, ds.schema, ds.notice_store, ds.company_store, mesh=mesh, log_fn=lambda *_: None)
    empty = np.empty((0, 2), np.int64)
    if source == "parquet":
        from jodalrob_twotower_torch.data.parquet_dataset import save_pairs_parquet

        pair_file = workdir / "pairs.parquet"
        save_pairs_parquet(pair_file, ds.notice_store.keys[ds.pairs[:, 0]], ds.company_store.keys[ds.pairs[:, 1]])
        chunks = stream_pair_chunks(pair_file, ds.notice_store, ds.company_store, chunk_rows=CHUNK_ROWS,
                                    host_index=mesh.rank, host_count=mesh.size)
        batches = sum(1 for _ in streaming_index_batches(chunks, local_b, seed=1))
        res = trainer.train_streaming(pair_file, empty, steps_per_epoch=batches, chunk_rows=CHUNK_ROWS,
                                      corpus_eval=False)
    else:
        def chunks():
            return memory_pair_chunks(ds.pairs, CHUNK_ROWS, mesh.rank, mesh.size)

        batches = sum(1 for _ in streaming_index_batches(chunks(), local_b, seed=1))

        def source_fn(epoch: int):
            return streaming_index_batches(chunks(), local_b, seed=cfg.data.shuffle_seed + epoch)

        res = trainer.train(empty, empty, batch_source=source_fn, steps_per_epoch=batches, corpus_eval=False)
    return batches, float(res.history[-1]["train_loss"])


def rank_run(devices: list, stream_source: str) -> dict:
    """One process: every leg, its results as one JSON-ready dict."""
    from jodalrob_twotower_torch.data.pipeline import assemble_pair_batch
    from jodalrob_twotower_torch.data.synthetic import make_synthetic_dataset
    from jodalrob_twotower_torch.parallel.compressed_grads import make_dp_compressed_indexed_train
    from jodalrob_twotower_torch.parallel.distributed import host_local_batch_to_global, host_shard_pairs, process_info
    from jodalrob_twotower_torch.parallel.mesh import make_mesh
    from jodalrob_twotower_torch.parallel.sharded_store import make_tower_batch_gather, put_row_sharded_store
    from jodalrob_twotower_torch.parallel.sharded_train import make_sharded_train
    from jodalrob_twotower_torch.train.trainer import Trainer
    from jodalrob_twotower_torch.utils.profiling import kernel_launches

    idx, count = process_info()
    mesh = make_mesh(devices)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    if mesh.size != count:
        raise RuntimeError(f"multihost_smoke: the mesh has {mesh.size} ranks for {count} processes")
    cfg = smoke_config()
    # every process generates the same dataset (same seed), then keeps its share
    ds = make_synthetic_dataset(seed=0, n_notices=N_ROWS, n_companies=N_ROWS, n_pairs=N_PAIRS)
    my_pairs = host_shard_pairs(ds.pairs, mesh)
    if len(my_pairs) != len(ds.pairs) // count:
        raise RuntimeError(f"multihost_smoke: {len(my_pairs)} pairs on process {idx}, not 1/{count}")
    local_b = BATCH // count

    def local_batch(step: int):
        rows = my_pairs[step * local_b:(step + 1) * local_b]
        return host_local_batch_to_global(mesh, assemble_pair_batch(ds.notice_store, ds.company_store, rows))

    model = _built(ds.schema, cfg, mesh)
    state, train_step, _ = make_sharded_train(model, cfg, mesh, BATCH, total_steps=10)
    losses = []
    for step in range(3):
        state, metrics = train_step(state, local_batch(step))
        losses.append(float(metrics["loss"]))
    table = state.params["notice_tower.embeddings.table"]
    table_rows_global = model.notice_tower.embeddings.total_rows

    # the mesh's fused CE across processes: its first loss against the step's
    cfg_f = cfg.replace(loss=dataclasses.replace(cfg.loss, use_fused_logits=True))
    state_f, step_f, _ = make_sharded_train(_built(ds.schema, cfg_f, mesh), cfg_f, mesh, BATCH, total_steps=10)
    _, metrics_f = step_f(state_f, local_batch(0))
    fused_loss = float(metrics_f["loss"])

    # the streaming Trainer: each process its lockstep share of every chunk
    with tempfile.TemporaryDirectory(prefix=f"multihost_stream_{idx}_") as tmp:
        stream_batches, stream_loss = _streaming_leg(cfg_f, ds, mesh, stream_source, Path(tmp))

    # the compressed sync (int16 wire, error feedback) through the Trainer;
    # its tables are replicated, so on the card its backward runs K2
    cfg_c = cfg.replace(results_csv="", mesh=dataclasses.replace(cfg.mesh, grad_compression="int16"))
    before = kernel_launches()
    res_c = Trainer(cfg_c, ds.schema, ds.notice_store, ds.company_store, mesh=mesh, log_fn=lambda *_: None).train(
        ds.pairs[:COMPRESSED_PAIRS], np.empty((0, 2), np.int64), corpus_eval=False)
    compressed_launches = {k: v - before[k] for k, v in kernel_launches().items()}
    compressed_loss = float(res_c.history[-1]["train_loss"])

    # "global" negatives under "none": the candidate set spans every
    # process's block; its first loss against the sharded step's
    cfg_cg = cfg.replace(results_csv="", mesh=dataclasses.replace(cfg.mesh, grad_compression="none",
                                                                  compressed_negatives="global"))
    model_cg = _built(ds.schema, cfg_cg.replace(mesh=dataclasses.replace(cfg_cg.mesh, grad_compression="int16")),
                      mesh)  # the compressed sync's per-rank model
    cdp = make_dp_compressed_indexed_train(model_cg, cfg_cg, mesh, BATCH, 10, method="none")
    n_cg = cdp.put_store((ds.notice_store.dense, ds.notice_store.cat_ids))
    c_cg = cdp.put_store((ds.company_store.dense, ds.company_store.cat_ids))
    _, _, m_cg = cdp.single_step(cdp.state, cdp.err_state, host_local_batch_to_global(mesh, my_pairs[:local_b]
                                                                                       .astype(np.int64)),
                                 n_cg, c_cg)
    compressed_global_loss = float(m_cg["loss"])

    # a row-sharded store: 1/N of the rows here, the exchange's gather exact
    rstore = put_row_sharded_store((ds.notice_store.dense, ds.notice_store.cat_ids), mesh)
    probe = torch.from_numpy((np.arange(BATCH, dtype=np.int64) * 37) % len(ds.notice_store))
    tb = make_tower_batch_gather(mesh)(rstore, probe[mesh.block(BATCH)].to(mesh.device))
    got_dense, got_cat = (mesh.all_gather_rows(t).cpu().numpy() for t in (tb.dense, tb.cat_ids))
    store_gather_exact = bool(np.array_equal(got_dense, ds.notice_store.dense[probe.numpy()])
                              and np.array_equal(got_cat, ds.notice_store.cat_ids[probe.numpy()]))

    return {
        "process": idx, "processes": count, "mesh_size": mesh.size, "backend": mesh.backend,
        "device": str(mesh.device), "pairs_on_this_process": len(my_pairs),
        "losses": losses, "fused_loss": fused_loss, "fused_matches_xla": abs(fused_loss - losses[0]) < FUSED_ATOL,
        "table_rows_global": int(table_rows_global), "table_rows_on_this_host": int(table.shape[0]),
        "stream_source": stream_source, "stream_batches": int(stream_batches), "stream_loss": stream_loss,
        "stream_finite": bool(np.isfinite(stream_loss)),
        "compressed_loss": compressed_loss, "compressed_finite": bool(np.isfinite(compressed_loss)),
        "compressed_launches": compressed_launches,
        "store_rows_on_this_host": int(rstore[0].shape[0]),
        "store_rows_global": int(rstore[0].shape[0]) * mesh.size, "store_gather_exact": store_gather_exact,
        "compressed_global_loss": compressed_global_loss,
        "compressed_global_matches_gspmd": abs(compressed_global_loss - losses[0]) < FUSED_ATOL,
    }


def check(ok: bool, what: str, outs: list) -> None:
    if not ok:
        raise RuntimeError(f"multihost_smoke: {what}: {outs}")


def run(n: int, force_cpu: bool, stream_source: str) -> dict:
    """Every process's results, checked as the reference's ``main`` checks
    them; returns the summary line."""
    from jodalrob_twotower_torch.parallel.distributed import launch_script

    outs, backend = launch_script(rank_run, n, (stream_source,), force_cpu)
    for o in outs:
        print(json.dumps(o), flush=True)
    o0 = outs[0]
    check(all(o["losses"] == o0["losses"] for o in outs), "the processes' losses differ", outs)
    check(all(np.isfinite(o0["losses"])) and o0["losses"][-1] < o0["losses"][0], "the losses did not fall", outs)
    check(all(o["mesh_size"] == n == o["processes"] for o in outs), "the mesh size is not the processes'", outs)
    check(all(o["pairs_on_this_process"] * n == N_PAIRS for o in outs), "a process does not hold 1/N of the pairs",
          outs)
    check(all(o["fused_matches_xla"] for o in outs), "the fused CE's loss differs from the materialized one", outs)
    check(all(o["table_rows_on_this_host"] * n == o["table_rows_global"] for o in outs),
          "a process does not hold 1/N of the table rows", outs)
    check(all(o["stream_batches"] == o0["stream_batches"] > 0 for o in outs), "the streamed batch counts differ",
          outs)
    check(all(o["stream_loss"] == o0["stream_loss"] and o["stream_finite"] for o in outs),
          "the streamed losses differ or are not finite", outs)
    check(all(o["compressed_loss"] == o0["compressed_loss"] and o["compressed_finite"] for o in outs),
          "the compressed losses differ or are not finite", outs)
    cfg = smoke_config()
    expected = {name: 0 for name in o0["compressed_launches"]}  # the CPU: the plain versions
    if not force_cpu:  # K2 for the notice and the company table each step
        expected["dense_table_grad"] = 2 * COMPRESSED_PAIRS // cfg.data.batch_size * cfg.optimizer.num_epochs
    check(all(o["compressed_launches"] == expected for o in outs),
          f"the compressed Trainer's kernel launches are not {expected}", outs)
    check(all(o["store_rows_on_this_host"] * n == o["store_rows_global"] for o in outs),
          "a process does not hold 1/N of the store rows", outs)
    check(all(o["store_gather_exact"] for o in outs), "the row-sharded store's gather is not the host gather", outs)
    check(all(o["compressed_global_matches_gspmd"] for o in outs),
          "the compressed global negatives' loss differs from the sharded step's", outs)
    check(all(o["compressed_global_loss"] == o0["compressed_global_loss"] for o in outs),
          "the compressed global losses differ", outs)
    return {"bench": "multihost_smoke", "ok": True, **o0, "backend": backend}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--processes", type=int, default=2, help="processes, one device each")
    p.add_argument("--force-cpu", action="store_true", help="gloo ranks on the CPU instead of the card")
    args = p.parse_args(argv)
    source = "parquet" if args.force_cpu else "memory"  # the card machine has no pyarrow
    if not args.force_cpu:
        from jodalrob_twotower_torch.bench import card_line
        from jodalrob_twotower_torch.device import resolve_device

        resolve_device(None)
        print(card_line(), flush=True)
    print(json.dumps(run(args.processes, args.force_cpu, source)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
