"""Rank functions of the port's mesh tests (tests/test_torch_mesh*.py).

Each runs inside a rank that ``parallel/distributed.launch`` spawned, over
gloo on the CPU, and returns numpy results to the test process, which holds
them against the JAX package's. This module imports torch and the port
only: the ranks never import JAX (tests/torch_parity.py does)."""

from __future__ import annotations

import numpy as np
import torch

from jodalrob_twotower_torch.data.types import PairBatch, TowerBatch
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel
from jodalrob_twotower_torch.parallel.mesh import make_mesh


def _np(sd: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def ce_cases(n_np: np.ndarray, c_np: np.ndarray, cases: list) -> list:
    """Per case (tau, eps, max_abs_logit): (loss, dn, dc) of the mesh's CE on
    this rank's blocks of n, c [B, D]."""
    from jodalrob_twotower_torch.ops.fused_logits import sharded_fused_ce

    mesh = make_mesh(["cpu"] * torch.distributed.get_world_size())
    rows = mesh.block(n_np.shape[0])
    out = []
    for tau, eps, bound in cases:
        n = torch.from_numpy(n_np[rows].copy()).requires_grad_(True)
        c = torch.from_numpy(c_np[rows].copy()).requires_grad_(True)
        loss = sharded_fused_ce(n, c, mesh, tau, eps, bound)
        loss.backward()
        out.append((float(loss.detach()), n.grad.numpy(), c.grad.numpy()))
    return out


def retrieval(queries: np.ndarray, corpus: np.ndarray, positives: np.ndarray, ks: tuple, k: int) -> dict:
    """The sharded corpus eval and the ShardedIndex (exact and int8, and
    int8 with a bf16 rescore) on this rank."""
    from jodalrob_twotower_torch.evaluation.evaluator import sharded_corpus_retrieval_eval
    from jodalrob_twotower_torch.serving.index import ShardedIndex

    mesh = make_mesh(["cpu"] * torch.distributed.get_world_size())
    res = sharded_corpus_retrieval_eval(queries, corpus, positives, mesh, ks=ks, query_chunk=32)
    out = {"recall": res.recall, "mrr": res.mrr, "corpus_size": res.corpus_size}
    for name, kw in (("exact", {}), ("int8", {}), ("int8_rescore", dict(rescore_depth=3 * k, rescore_dtype="bfloat16"))):
        index = ShardedIndex(corpus, mesh, kind="exact" if name == "exact" else "int8", query_chunk=32, **kw)
        found = index.search(queries, k)
        out[name] = (found.scores, found.indices)
    return out


def _stores(stores: dict):
    return {side: tuple(torch.from_numpy(x) for x in stores[side]) for side in ("notice", "company")}


def train_step(schema, cfg, start: dict, stores: dict, idx: np.ndarray, steps: int) -> dict:
    """``steps`` mesh steps on this rank's block of each [B, 2] batch of
    ``idx``, from the state dict ``start``, beside the port's single-device
    steps on the whole batches from the same state (run on every rank)."""
    from jodalrob_twotower_torch.models import build_model
    from jodalrob_twotower_torch.parallel.sharded_train import make_sharded_train
    from jodalrob_twotower_torch.train import train_step as tts

    mesh = make_mesh(["cpu"] * torch.distributed.get_world_size())
    model = build_model(schema, cfg, mesh)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in start.items()})
    state, step, shard_batch = make_sharded_train(model, cfg, mesh, idx.shape[1], 10)
    s = _stores(stores)

    def batch(i):
        return PairBatch(TowerBatch(*(x[torch.from_numpy(i[:, 0])] for x in s["notice"])),
                         TowerBatch(*(x[torch.from_numpy(i[:, 1])] for x in s["company"])))

    losses, per_step = [], []
    for i in idx[:steps]:
        state, m = step(state, shard_batch(batch(i)))
        losses.append({k: float(v) for k, v in m.items()})
        per_step.append(_np({**state.params, **state.batch_stats}))
    single = TwoTowerModel(schema, cfg.model)
    single.load_state_dict({k: torch.from_numpy(v) for k, v in start.items()})
    s_state, tx = tts.create_train_state(single, cfg, cfg.seed, 10, device="cpu")
    s_step = tts.make_train_step(single, cfg, tx)
    single_losses = []
    for i in idx[:steps]:
        s_state, m = s_step(s_state, batch(i))
        single_losses.append(float(m["loss"]))
    return {"losses": losses, "states": per_step, "single_losses": single_losses,
            "single_state": _np({**s_state.params, **s_state.batch_stats})}


def _patched_trainer(schema, cfg, stores, start, mesh):
    from jodalrob_twotower_torch.data.feature_store import FeatureStore
    from jodalrob_twotower_torch.train.trainer import Trainer

    def init_from(self, generator):
        self.load_state_dict({k: torch.from_numpy(v) for k, v in start.items()})
        return self

    TwoTowerModel.init_flax = init_from  # this rank's process only
    keys = np.arange(len(stores["notice"][0])).astype(str)
    fs = [FeatureStore(schema.side(side), *stores[side], keys) for side in ("notice", "company")]
    return Trainer(cfg, schema, *fs, mesh=mesh, log_fn=lambda *_: None)


def trainer_runs(schema, cfg, stores: dict, start: dict, train_pairs, val_pairs, n_inner: int, tmp: str,
                 bad_cfg, pair_file: str) -> dict:
    """On this rank: the mesh Trainer's straight run (with the corpus eval);
    a run preempted after its second mid-epoch checkpoint and resumed; the
    streaming trainer over ``pair_file`` (this rank's share of each chunk);
    and the batch divisibility guard under ``bad_cfg``."""
    import dataclasses
    from pathlib import Path

    from jodalrob_twotower_torch.train.checkpoint import CheckpointManager

    mesh = make_mesh(["cpu"] * torch.distributed.get_world_size())
    straight = _patched_trainer(schema, cfg, stores, start, mesh).train(train_pairs, val_pairs, n_inner=n_inner)
    out = {"history": straight.history, "final_val": straight.final_val, "step": straight.state.step,
           "state": _np({**straight.state.params, **straight.state.batch_stats}),
           "corpus": (straight.corpus.recall, straight.corpus.mrr)}

    ckpt_cfg = cfg.replace(checkpoint=dataclasses.replace(cfg.checkpoint, save_every_steps=2))
    d = Path(tmp) / "ckpt"
    saves = []
    real_save = CheckpointManager.save_step

    def save_then_stop(self, state, epoch, batch):
        real_save(self, state, epoch, batch)
        saves.append(int(state.step))
        if len(saves) == 2:
            raise KeyboardInterrupt("simulated preemption")

    CheckpointManager.save_step = save_then_stop
    try:
        _patched_trainer(schema, ckpt_cfg, stores, start, mesh).train(
            train_pairs, val_pairs, checkpoint_dir=d, corpus_eval=False, n_inner=1)
    except KeyboardInterrupt:
        pass
    finally:
        CheckpointManager.save_step = real_save
    resumed = _patched_trainer(schema, ckpt_cfg, stores, start, mesh).train(
        train_pairs, val_pairs, checkpoint_dir=d, resume=True, corpus_eval=False, n_inner=1)
    again = _patched_trainer(schema, ckpt_cfg, stores, start, mesh).train(
        train_pairs, val_pairs, corpus_eval=False, n_inner=1)
    out["resume"] = {"saved_at": saves, "step": resumed.state.step,
                     "resumed": _np({**resumed.state.params, **resumed.state.batch_stats}),
                     "straight": _np({**again.state.params, **again.state.batch_stats}),
                     "files": sorted(p.name for p in d.iterdir())}
    streamed = _patched_trainer(schema, cfg, stores, start, mesh).train_streaming(
        pair_file, val_pairs, steps_per_epoch=len(train_pairs) // cfg.data.batch_size, chunk_rows=64,
        corpus_eval=False, n_inner=1)
    out["streamed"] = {"step": streamed.state.step, "history": streamed.history,
                       "state": _np({**streamed.state.params, **streamed.state.batch_stats})}
    try:
        _patched_trainer(schema, bad_cfg, stores, start, mesh).train(train_pairs, val_pairs, corpus_eval=False)
        out["guard"] = None
    except ValueError as e:
        out["guard"] = str(e)
    return out


def fails(message: str) -> None:
    """Rank 1 raises; the others wait in a collective that never completes."""
    if torch.distributed.get_rank() == 1:
        raise RuntimeError(message)
    torch.distributed.barrier()


def hangs() -> None:
    """Every rank but 0 sleeps past any deadline a test sets."""
    import time

    if torch.distributed.get_rank():
        time.sleep(3600)
