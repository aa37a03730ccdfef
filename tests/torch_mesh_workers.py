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
        from jodalrob_twotower_torch.parallel.mesh import shard_state

        sd = {k: torch.from_numpy(v) for k, v in start.items()}
        self.load_state_dict(shard_state(sd, mesh, self.row_sharded_keys))
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


# -- row-sharded tables and stores, the sparse mesh (test_torch_mesh_rows.py,
#    test_torch_mesh_sparse.py) -------------------------------------------------


def _mesh():
    return make_mesh(["cpu"] * torch.distributed.get_world_size())


def exchange_checks(table: np.ndarray, rows: np.ndarray, mats: dict, store_rows: np.ndarray) -> dict:
    """The row exchange on this rank: the lookup's forward and its table
    gradient (of sum(2 y)) on the rank's blocks, its shape errors, and the
    store gather of each matrix in ``mats`` (the rank's block of the
    padded matrix) at the rank's block of ``store_rows``, and its ragged
    refusal."""
    from jodalrob_twotower_torch.parallel.sharded_embedding import make_sharded_lookup
    from jodalrob_twotower_torch.parallel.sharded_store import make_store_gather, put_row_sharded_store

    mesh = _mesh()
    lookup = make_sharded_lookup(mesh)
    t = torch.from_numpy(table[mesh.block(table.shape[0])].copy()).requires_grad_(True)
    out = lookup(t, torch.from_numpy(rows[mesh.block(rows.shape[0])].copy()))
    (out * 2.0).sum().backward()
    res = {"lookup": out.detach().numpy(), "grad": t.grad.numpy(), "errors": []}
    for shard, ids, total in ((torch.zeros(50, 8), torch.zeros(4, 2, dtype=torch.int32), 100 + 1),
                              (torch.zeros(64, 8), torch.zeros(3, 2, dtype=torch.int32), 100)):
        try:
            lookup(shard, ids, total)
            res["errors"].append(None)
        except ValueError as e:
            res["errors"].append(str(e))
    gather = make_store_gather(mesh)
    mine = torch.from_numpy(store_rows[mesh.block(store_rows.shape[0])].copy())
    res["stores"] = {}
    for name, mat in mats.items():
        shard = put_row_sharded_store((mat,), mesh)[0] if name != "bf16" else \
            put_row_sharded_store((torch.from_numpy(mat).to(torch.bfloat16),), mesh)[0]
        got = gather(shard, mine)
        res["stores"][name] = (got.float() if name == "bf16" else got).numpy()
        res["shard_rows"] = shard.shape[0]
    try:
        gather(torch.zeros(30, 8), mine, 61)
        res["ragged"] = None
    except ValueError as e:
        res["ragged"] = str(e)
    return res


def _joined(sd: dict, mesh, keys) -> dict:
    from jodalrob_twotower_torch.parallel.mesh import join_state

    return _np(join_state(dict(sd), mesh, keys))


def rows_steps(schema, cfgs: dict, start: dict, stores: dict, idx: np.ndarray) -> dict:
    """Per config name: the mesh steps (``make_sharded_indexed_train``'s
    single step) on this rank's blocks of the global batches ``idx`` from
    the one-device state dict ``start``, cut to the rank's blocks: each
    step's loss, the joined params and accumulators, this rank's
    replicated leaves, its table blocks' rows untouched by any batch, and
    each table's rank block shape. Config names starting "single" run the
    port's one-device steps on the whole batches instead."""
    from jodalrob_twotower_torch.models import build_model
    from jodalrob_twotower_torch.parallel.mesh import shard_state
    from jodalrob_twotower_torch.parallel.sharded_train import make_sharded_indexed_train
    from jodalrob_twotower_torch.train import train_step as tts

    mesh = _mesh()
    out = {}
    for name, cfg in cfgs.items():
        if name.startswith("single"):
            model = TwoTowerModel(schema, cfg.model)
            model.load_state_dict({k: torch.from_numpy(v) for k, v in start.items()})
            state, tx = tts.create_train_state(model, cfg, cfg.seed, 10, device="cpu")
            step = tts.make_indexed_train_step(model, cfg, tx)
            s = _stores(stores)
            losses = []
            for i in idx:
                state, m = step(state, torch.from_numpy(i.astype(np.int64)), s["notice"], s["company"])
                losses.append(float(m["loss"]))
            out[name] = {"losses": losses, "state": _np({**state.params, **state.batch_stats}),
                         "acc": _np(state.opt_state["acc"])}
            continue
        model = build_model(schema, cfg, mesh)
        keys = model.row_sharded_keys
        model.load_state_dict(shard_state({k: torch.from_numpy(v) for k, v in start.items()}, mesh, keys))
        state, tx, _, single, put_idx, put_store = make_sharded_indexed_train(model, cfg, mesh, idx.shape[1], 10,
                                                                            n_inner=1)
        n_store = put_store(stores["notice"])
        c_store = put_store(stores["company"])
        losses, states, replicated = [], [], []
        for i in idx:
            state, m = single(state, put_idx(i), n_store, c_store)
            losses.append(float(m["loss"]))
            states.append(_joined({**state.params, **state.batch_stats}, mesh, keys))
            replicated.append(_np({k: v for k, v in state.params.items() if k not in keys}))
        out[name] = {"losses": losses, "states": states, "replicated": replicated,
                     "acc": _joined(state.opt_state["acc"], mesh, keys),
                     "shard_shapes": {k: tuple(state.params[k].shape) for k in keys},
                     "store_rows": int(n_store[0].shape[0]), "row_sharded": sorted(keys)}
    return out


def rows_trainer(schema, cfgs: dict, stores: dict, start: dict, train_pairs, val_pairs, tmp: str) -> dict:
    """On this rank: the mesh Trainer under each config (row-sharded tables
    and stores, and the replicated stores beside them), its validation and
    corpus eval from the device stores against the host-assembled ones, the
    corpus encode at a chunk that does not divide the mesh, the eval batch
    refusal; a row-sharded mesh checkpoint preempted after its second step
    save and resumed against a straight run, and its files."""
    import dataclasses
    from pathlib import Path

    from jodalrob_twotower_torch.train.checkpoint import CheckpointManager

    mesh = _mesh()
    out = {}
    for name, cfg in cfgs.items():
        trainer = _patched_trainer(schema, cfg, stores, start, mesh)
        res = trainer.train(train_pairs, val_pairs, n_inner=2)
        state = res.state
        row = {"history": res.history, "rows_store": trainer._store_gather is not None}
        dev_val, dev_corpus = trainer.validate(state, val_pairs), trainer.corpus_eval(state, val_pairs)
        view = trainer._eval_view(state)
        row["odd_chunk"], row["tiny_chunk"] = (trainer.evaluator.encode_corpus_device(
            view, trainer._dev_stores[1], len(trainer.company_store), chunk=chunk,
            store_gather=trainer._store_gather).numpy() for chunk in (33, 1))
        try:
            trainer.evaluator.evaluate_indexed(view, val_pairs, *trainer._dev_stores, batch_size=31,
                                               store_gather=trainer._store_gather)
            row["odd_batch"] = None
        except ValueError as e:
            row["odd_batch"] = str(e)
        dev_stores, trainer._dev_stores = trainer._dev_stores, None
        host_val, host_corpus = trainer.validate(state, val_pairs), trainer.corpus_eval(state, val_pairs)
        trainer._dev_stores = dev_stores
        row.update(dev_val=dev_val, host_val=host_val, dev_corpus=(dev_corpus.recall, dev_corpus.mrr),
                   host_corpus=(host_corpus.recall, host_corpus.mrr),
                   corpus_emb=trainer.evaluator.encode_corpus(view, trainer.company_store.dense,
                                                              trainer.company_store.cat_ids).numpy())
        out[name] = row

    cfg = cfgs["rows"]
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
    trainer = _patched_trainer(schema, ckpt_cfg, stores, start, mesh)
    resumed = trainer.train(train_pairs, val_pairs, checkpoint_dir=d, resume=True, corpus_eval=False, n_inner=1)
    again = _patched_trainer(schema, ckpt_cfg, stores, start, mesh).train(
        train_pairs, val_pairs, corpus_eval=False, n_inner=1)
    keys = trainer.model.row_sharded_keys

    def whole(st):
        return {**_joined({**st.params, **st.batch_stats}, mesh, keys),
                **{f"acc/{k}": v for k, v in _joined(st.opt_state["acc"], mesh, keys).items()}}

    out["resume"] = {"saved_at": saves, "step": resumed.state.step, "resumed": whole(resumed.state),
                     "straight": whole(again.state), "files": sorted(p.name for p in d.iterdir()),
                     "shard_rows": {k: int(resumed.state.params[k].shape[0]) for k in keys}}
    # the final checkpoint restored into the rank's state again
    back = CheckpointManager(d, ckpt_cfg.checkpoint, mesh=mesh, sharded=keys).restore("final", resumed.state)
    out["resume"]["restored_equal"] = all(torch.equal(back.params[k], resumed.state.params[k])
                                          for k in resumed.state.params) and all(
        torch.equal(back.opt_state["acc"][k], resumed.state.opt_state["acc"][k]) for k in keys)
    return out


def sparse_runs(schema, cfgs: dict, start: dict, stores: dict, batches: dict, pairs: np.ndarray,
                sample_seed: int) -> dict:
    """Per config name, on this rank: the mesh sparse steps
    (``make_sharded_sparse_train``) from the one-device state dict
    ``start`` on the rank's blocks of the global batches
    ``batches.get(name, batches["default"])``, one step per batch (or, for
    names ending "deferred", one window over all of them): the losses, the
    joined tables, accumulators and dense params, the rank's table block
    rows and its replicated leaves; names starting "single" run the port's
    one-device sparse steps instead. "sampled" draws as many batches on the
    device (``make_sharded_sampled_sparse``, from ``sample_seed``); "learn"
    runs 20 steps over the batches repeated."""
    from jodalrob_twotower_torch.models import build_model
    from jodalrob_twotower_torch.parallel.mesh import shard_state
    from jodalrob_twotower_torch.parallel.sharded_sparse import make_sharded_sampled_sparse, make_sharded_sparse_train
    from jodalrob_twotower_torch.train import sparse_tables as tst

    mesh = _mesh()
    s = _stores(stores)
    out = {}

    def result(state, losses, keys_mesh):
        tables = {f"{f}/{leaf}": getattr(getattr(state, f), leaf) for f in tst.TABLE_KEYS.values()
                  for leaf in ("table", "accumulator")}
        whole = _joined(tables, keys_mesh, set(tables)) if keys_mesh is not None else _np(tables)
        return {"losses": losses, "tables": whole, "dense": _np(state.dense_params),
                "shard_rows": {k: int(v.shape[0]) for k, v in tables.items()}}

    for name, cfg in cfgs.items():
        idx = batches.get(name, batches["default"])
        n = len(idx)
        if name.startswith("single"):
            model = TwoTowerModel(schema, cfg.model)
            model.load_state_dict({k: torch.from_numpy(v) for k, v in start.items()})
            state, tx = tst.create_sparse_train_state(model, cfg, cfg.seed, 10, device="cpu")
            if name.endswith("deferred"):
                steps = tst.make_deferred_sparse_steps(model, cfg, tx, 10, n)
                state, m = steps(state, torch.from_numpy(idx.astype(np.int64)), s["notice"], s["company"])
                losses = m["loss"].tolist()
            else:
                step = tst.make_sparse_train_step(model, cfg, tx, 10)
                losses = []
                for i in idx:
                    state, m = step(state, torch.from_numpy(i.astype(np.int64)), s["notice"], s["company"])
                    losses.append(float(m["loss"]))
            out[name] = result(state, losses, None)
            continue
        if name == "plain_model":  # built without the mesh: the sparse state cuts its tables itself
            model = TwoTowerModel(schema, cfg.model)
            model.load_state_dict({k: torch.from_numpy(v) for k, v in start.items()})
        else:
            model = build_model(schema, cfg, mesh)
            model.load_state_dict(shard_state({k: torch.from_numpy(v) for k, v in start.items()}, mesh,
                                              model.row_sharded_keys))
        n_inner = n if name.endswith("deferred") else None
        built = make_sharded_sparse_train(model, cfg, mesh, idx.shape[1], 10, n_inner=n_inner,
                                          defer_updates=n_inner is not None)
        state, step, put_batch, put_store = built[:4]
        n_store, c_store = put_store(stores["notice"]), put_store(stores["company"])
        losses = []
        if name.endswith("deferred"):
            state, m = built[4](state, put_batch(idx), n_store, c_store)
            losses = m["loss"].tolist()
        elif name == "sampled":
            steps, put_pairs = make_sharded_sampled_sparse(model, cfg, mesh, state, n, idx.shape[1], 10)
            state, m = steps(state, sample_seed, put_pairs(pairs), n_store, c_store)
            losses = m["loss"].tolist()
        else:
            for i in idx:
                state, m = step(state, put_batch(i), n_store, c_store)
                losses.append(float(m["loss"]))
        out[name] = result(state, losses, mesh)
        out[name]["replicated"] = _np({**state.dense_params, **state.batch_stats})
    return out


# -- the compressed gradient sync (test_torch_compressed.py) -------------------------


def compressed_wire(leaves: dict, errs: dict, methods: tuple, feedback=None) -> dict:
    """On this rank: ``compressed_psum_tree`` of its row of every leaf of
    ``leaves`` and ``errs`` ([n, ...] each) under each method (the sums, the
    new residuals and the collectives' input bytes), the one-leaf form, and
    with ``feedback`` = (g [n, d], steps) the running total of ``steps``
    int16 syncs of g with the residual fed back and without it."""
    from jodalrob_twotower_torch.parallel.compressed_grads import compressed_psum_leaf, compressed_psum_tree

    mesh = _mesh()
    r = mesh.rank
    mine = {k: torch.from_numpy(v[r].copy()) for k, v in leaves.items()}
    err = {k: torch.from_numpy(v[r].copy()) for k, v in errs.items()}
    out = {}
    for method in methods:
        buffers = []
        synced, new_err = compressed_psum_tree(mine, err, mesh, method, buffers=buffers)
        k0 = next(iter(mine))
        leaf_sum, leaf_err = compressed_psum_leaf(mine[k0], err[k0], mesh, method)
        out[method] = {"synced": _np(synced), "err": _np(new_err), "buffers": list(buffers),
                       "leaf": (leaf_sum.numpy(), leaf_err.numpy())}
    if feedback is not None:
        g_all, steps = feedback
        g = {"g": torch.from_numpy(g_all[r].copy())}
        e = {"g": torch.zeros_like(g["g"])}
        acc, lost = torch.zeros_like(g["g"]), torch.zeros_like(g["g"])
        for _ in range(steps):
            total, e = compressed_psum_tree(g, e, mesh, "int16")
            acc += total["g"]
            total, _ = compressed_psum_tree(g, {"g": torch.zeros_like(g["g"])}, mesh, "int16")
            lost += total["g"]
        out["feedback"] = (acc.numpy(), lost.numpy())
    return out


def _compressed_state(state) -> dict:
    """A dense or sparse state's leaves under the model's keys, the tables
    whole (a sparse state's row blocks gathered from every rank)."""
    from jodalrob_twotower_torch.train import sparse_tables as tst

    if isinstance(state, tst.SparseTrainState):
        keys = set(tst.TABLE_KEYS)
        return _joined({**tst.merged_params(state), **state.batch_stats}, _mesh(), keys)
    return _np({**state.params, **state.batch_stats})


def compressed_runs(schema, jobs: dict, start: dict, stores: dict, batches: dict, pairs: np.ndarray,
                    sample_seed: int) -> dict:
    """Per job name, on this rank, from the one-device state dict ``start``
    (each job ``dict(cfg, kind, method, batches, ...)``), one step per
    global batch of ``batches[job["batches"]]``:

    * kind "full": ``make_dp_compressed_train_step`` on the rank's blocks
      of host-assembled batches;
    * "single": ``make_dp_compressed_indexed_train``'s ``single_step``
      (``make_dp_compressed_sparse_train``'s where ``job["sparse"]``);
    * "scan": one ``scan_steps`` call over the batches;
    * "sampled": ``make_sampled(len)`` from a fresh build; the dense
      form's rank-drawn rows are returned and replayed through
      ``single_step`` from another fresh build ("replay");
    * "mesh" / "mesh_sparse": the uncompressed mesh steps
      (``make_sharded_indexed_train``, ``make_sharded_sparse_train``).

    Each result: the losses, the metric keys of the last step, the final
    state (tables whole), and for the compressed kinds the rank's residual
    and the last sum's collectives. The compressed kinds run on a model
    built without the mesh, as the reference's tests build theirs."""
    from jodalrob_twotower_torch.models import build_model
    from jodalrob_twotower_torch.parallel import compressed_grads as cg
    from jodalrob_twotower_torch.parallel.mesh import shard_state
    from jodalrob_twotower_torch.parallel.sharded_sparse import make_sharded_sparse_train
    from jodalrob_twotower_torch.parallel.sharded_train import make_sharded_indexed_train
    from jodalrob_twotower_torch.train.train_step import RANK_SAMPLE_STREAM, step_generator

    mesh = _mesh()
    s = _stores(stores)
    out = {}
    for name, job in jobs.items():
        cfg, kind, idx = job["cfg"], job["kind"], batches[job["batches"]]
        b = idx.shape[1]
        sd = {k: torch.from_numpy(v) for k, v in start.items()}
        if kind.startswith("mesh"):
            model = build_model(schema, cfg, mesh)
            model.load_state_dict(shard_state(sd, mesh, model.row_sharded_keys))
        else:
            model = TwoTowerModel(schema, cfg.model)
            model.load_state_dict(sd)
        res = {"losses": []}
        if kind == "mesh":
            state, _, _, step, put_idx, put_store = make_sharded_indexed_train(model, cfg, mesh, b, 10, n_inner=1)
        elif kind == "mesh_sparse":
            state, step, put_idx, put_store = make_sharded_sparse_train(model, cfg, mesh, b, 10, with_metrics=True)
        if kind.startswith("mesh"):
            ns, cs = put_store(stores["notice"]), put_store(stores["company"])
            for i in idx:
                state, m = step(state, put_idx(i), ns, cs)
                res["losses"].append(float(m["loss"]))
            res.update(keys=sorted(m), state=_compressed_state(state))
            out[name] = res
            continue
        if kind == "full":
            from jodalrob_twotower_torch.train.optimizer import build_optimizer

            state, err, step, put_batch = cg.make_dp_compressed_train_step(
                model, cfg, build_optimizer(cfg.optimizer, 10), mesh, b, 10, method=job["method"])
            for i in idx:
                rows = torch.from_numpy(i)
                batch = PairBatch(TowerBatch(*(x[rows[:, 0]] for x in s["notice"])),
                                  TowerBatch(*(x[rows[:, 1]] for x in s["company"])))
                state, err, m = step(state, err, put_batch(batch))
                res["losses"].append(float(m["loss"]))
            res.update(keys=sorted(m), state=_compressed_state(state), err=_np(err))
            out[name] = res
            continue
        sparse = job.get("sparse", False)
        make = cg.make_dp_compressed_sparse_train if sparse else cg.make_dp_compressed_indexed_train
        built = make(model, cfg, mesh, b, 10, method=job["method"])
        ns, cs = built.put_store(stores["notice"]), built.put_store(stores["company"])
        state, err = built.state, built.err_state
        if kind == "scan":
            state, err, m = built.scan_steps(state, err, built.put_idx(idx), ns, cs)
            res["losses"] = m["loss"].tolist()
        elif kind == "sampled":
            pairs_dev = torch.from_numpy(pairs)
            state, err, m = built.make_sampled(len(idx))(state, err, sample_seed, pairs_dev, ns, cs)
            res["losses"] = m["loss"].tolist()
        if kind == "sampled" and not sparse:
            rows = [pairs[torch.randint(0, len(pairs), (b // mesh.size,), generator=step_generator(
                torch.device("cpu"), sample_seed, t, RANK_SAMPLE_STREAM, mesh.rank)).numpy()] for t in range(len(idx))]
            res["rows"] = np.stack(rows)
            model.load_state_dict(sd)
            again = make(model, cfg, mesh, b, 10, method=job["method"])
            st2, er2, replay = again.state, again.err_state, []
            for r in rows:
                st2, er2, m2 = again.single_step(st2, er2, torch.from_numpy(r), ns, cs)
                replay.append(float(m2["loss"]))
            res["replay"] = replay
            res["replay_state"] = _compressed_state(st2)
        elif kind == "single":
            for i in idx:
                state, err, m = built.single_step(state, err, built.put_idx(i), ns, cs)
                res["losses"].append(float(m["loss"]))
        res.update(keys=sorted(m), state=_compressed_state(state), err=_np(err), buffers=list(built.sync.buffers),
                   step=int(state.step))
        out[name] = res
    return out


def compressed_trainer(schema, cfgs: dict, ds_arrays: dict, train_pairs, val_pairs, refused: dict) -> dict:
    """On this rank: ``Trainer.train`` under each config of ``cfgs`` on the
    port's synthetic dataset (``ds_arrays``: the stores' dense, cat_ids and
    keys), without the corpus eval: the history, the final validation, the
    step, and whether the ranks' final states are bit-equal; then each
    config of ``refused``, whose train must raise ValueError (its message)."""
    from jodalrob_twotower_torch.data.feature_store import FeatureStore
    from jodalrob_twotower_torch.train.trainer import Trainer

    mesh = _mesh()
    fs = [FeatureStore(schema.side(side), *ds_arrays[side]) for side in ("notice", "company")]
    out = {}
    for name, cfg in cfgs.items():
        res = Trainer(cfg, schema, *fs, mesh=mesh, log_fn=lambda *_: None).train(train_pairs, val_pairs,
                                                                                corpus_eval=False, n_inner=4)
        flat = torch.cat([torch.from_numpy(v).reshape(-1).float() for v in _compressed_state(res.state).values()])
        every = mesh.all_gather_rows(flat[None])
        out[name] = {"history": res.history, "final_val": res.final_val, "step": int(res.state.step),
                     "ranks_equal": all(torch.equal(every[0], every[r]) for r in range(1, mesh.size))}
    for name, cfg in refused.items():
        try:
            Trainer(cfg, schema, *fs, mesh=mesh, log_fn=lambda *_: None).train(train_pairs, val_pairs,
                                                                              corpus_eval=False)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def compressed_all(parts: dict) -> dict:
    """Each (function name, args) of ``parts`` run on this rank, in order:
    one launch for a test module's every rank function."""
    return {name: globals()[fn](*args) for name, (fn, args) in parts.items()}


# -- a model axis above 1 (test_torch_model_axis.py) ---------------------------


def _axis_steps(schema, cfg, start: dict, stores: dict, idx: np.ndarray, mesh) -> dict:
    """``make_sharded_train`` steps on ``mesh`` from the one-device state dict
    ``start`` (cut to the rank's blocks): per step the loss, the summed
    gradients at the step's start (``loss_and_grads`` on a copy of the
    state) and the state after, the row-sharded leaves joined whole."""
    import copy

    from jodalrob_twotower_torch.models import build_model
    from jodalrob_twotower_torch.parallel.mesh import shard_state
    from jodalrob_twotower_torch.parallel.sharded_train import make_sharded_train
    from jodalrob_twotower_torch.train.train_step import loss_and_grads, make_sharded_ce

    model = build_model(schema, cfg, mesh)
    keys = model.row_sharded_keys
    model.load_state_dict(shard_state({k: torch.from_numpy(v) for k, v in start.items()}, mesh, keys))
    state, step, shard_batch = make_sharded_train(model, cfg, mesh, idx.shape[1], 10)
    s = _stores(stores)
    losses, grads, states = [], [], []
    for i in idx:
        batch = shard_batch(PairBatch(TowerBatch(*(x[torch.from_numpy(i[:, 0])] for x in s["notice"])),
                                      TowerBatch(*(x[torch.from_numpy(i[:, 1])] for x in s["company"]))))
        _, _, g = loss_and_grads(model, cfg, copy.deepcopy(state), batch, mesh=mesh,
                                 sharded_ce=make_sharded_ce(cfg, mesh))
        grads.append(_joined(g, mesh, keys))
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        states.append(_joined({**state.params, **state.batch_stats}, mesh, keys))
    return {"losses": losses, "grads": grads, "states": states, "row_sharded": sorted(keys),
            "shard_rows": {k: int(state.params[k].shape[0]) for k in keys}}


def model_axis_runs(schema, cfgs: dict, start: dict, stores: dict, idx: np.ndarray, trainer_cfg,
                    pairs: np.ndarray, tmp: str) -> dict:
    """On each of 4 ranks: the (2, 2) mesh's steps under each config of
    ``cfgs``, and on ranks 0 and 1 the same steps on a (2, 1) mesh of those
    two ranks; the rank's coordinates, its ``host_shard_pairs`` of
    ``pairs``, and the files a (2, 2) mesh Trainer leaves in the rank's own
    directory under ``tmp`` (checkpoints and results CSV)."""
    import dataclasses
    from pathlib import Path

    from jodalrob_twotower_torch.config import MeshConfig
    from jodalrob_twotower_torch.parallel.distributed import host_shard_pairs

    rank = torch.distributed.get_rank()
    pair_group = torch.distributed.new_group([0, 1])  # every rank creates it, as new_group asks
    axes = MeshConfig(data_axis=2, model_axis=2)
    mesh = make_mesh(["cpu"] * 4, axes)
    out = {"rank": rank, "data_index": mesh.rank, "data_size": mesh.size, "model_index": mesh.model_index,
           "shape": dict(mesh.shape), "is_main": mesh.is_main, "pairs": host_shard_pairs(pairs, mesh),
           "pairs_no_mesh": host_shard_pairs(pairs)}
    out["mesh22"] = {name: _axis_steps(schema, cfg.replace(mesh=dataclasses.replace(cfg.mesh, data_axis=2,
                                                                                   model_axis=2)),
                                       start, stores, idx, mesh)
                     for name, cfg in cfgs.items()}
    if rank < 2:
        mesh21 = make_mesh(["cpu"] * 2, MeshConfig(), group=pair_group)
        out["mesh21"] = {name: _axis_steps(schema, cfg, start, stores, idx, mesh21) for name, cfg in cfgs.items()}
    d = Path(tmp) / f"rank{rank}"
    cfg = trainer_cfg.replace(results_csv=str(d / "results.csv"),
                              mesh=dataclasses.replace(trainer_cfg.mesh, data_axis=2, model_axis=2))
    keys = np.arange(len(stores["notice"][0])).astype(str)
    from jodalrob_twotower_torch.data.feature_store import FeatureStore
    from jodalrob_twotower_torch.train.trainer import Trainer

    fs = [FeatureStore(schema.side(side), *stores[side], keys) for side in ("notice", "company")]
    res = Trainer(cfg, schema, *fs, mesh=mesh, log_fn=lambda *_: None).train(
        pairs[:64], pairs[64:96], checkpoint_dir=d / "ckpt", corpus_eval=False, n_inner=1)
    out["trainer"] = {"history": res.history, "state": _np({**res.state.params, **res.state.batch_stats}),
                      "files": sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())}
    return out


def mesh_shape(cfg) -> dict:
    """A live mesh of this rank under ``cfg``: its shape, data index and
    model index."""
    mesh = make_mesh(["cpu"] * torch.distributed.get_world_size(), cfg)
    return {"shape": dict(mesh.shape), "rank": mesh.rank, "model_index": mesh.model_index, "is_main": mesh.is_main}
