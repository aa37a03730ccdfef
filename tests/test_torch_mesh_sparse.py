"""Sparse tables on the port's mesh (A12b item 3) against the JAX package
and the port's one-device sparse path, on the CPU, mirroring
tests/test_sharded_sparse.py:88-303: the port's ranks are separate
processes over gloo (``parallel/distributed.launch``, one torch thread
each), the reference's mesh is ``make_mesh(jax.devices()[:2])`` over
conftest's virtual devices, both from the same flax variables; float32
towers without BatchNorm, dropout 0, the materialized loss (the reference's
test config).

* Three mesh sparse steps (``parallel/sharded_sparse.make_sharded_sparse_train``)
  on batches without duplicate rows against the reference's mesh sparse
  steps and against the port's one-device sparse steps: losses rtol 2e-5,
  tables, accumulators (joined from the ranks' blocks) and dense params
  rtol 2e-5 / atol 1e-6 (the reference's tolerances).
* A deferred window of two steps against the reference's mesh window and
  the port's one-device window (the same tolerances).
* On-device sampling on the mesh against the host-fed mesh steps on the
  same draws (rtol 2e-5); a row-sharded store equal to the replicated one
  (rel 1e-6); each rank holding R/2 rows of each table and accumulator;
  the replicated leaves bit-equal across ranks; the mesh's fused CE equal
  to the materialized loss (rtol 1e-5); learning over 20 steps; a model
  built without the mesh trained alike (its tables cut by the state).
* The shard's sentinel: an update whose rows all lie outside a rank's
  block leaves its table and accumulator bit-equal, at the accumulator's
  initial value 0 with eps 0 too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.config import LossConfig as TLossConfig
from jodalrob_twotower_torch.config import MeshConfig as TMeshConfig
from jodalrob_twotower_torch.config import OptimizerConfig as TOptimizerConfig
from jodalrob_twotower_torch.config import TrainConfig as TTrainConfig
from jodalrob_twotower_torch.convert import flax_to_state_dict
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel as TTwoTowerModel
from jodalrob_twotower_torch.parallel.distributed import launch
from jodalrob_twotower_torch.parallel.mesh import make_mesh as t_make_mesh
from jodalrob_twotower_torch.train import sparse_tables as tst
from jodalrob_twotower_torch.train.train_step import SAMPLE_STREAM, step_generator
from jodalrob_twotower_tpu.config import LossConfig as JLossConfig
from jodalrob_twotower_tpu.config import OptimizerConfig as JOptimizerConfig
from jodalrob_twotower_tpu.config import TrainConfig as JTrainConfig
from jodalrob_twotower_tpu.data.types import PairBatch, TowerBatch
from jodalrob_twotower_tpu.models.two_tower import TwoTowerModel as JTwoTowerModel
from jodalrob_twotower_tpu.parallel.mesh import make_mesh as j_make_mesh
from jodalrob_twotower_tpu.parallel.sharded_sparse import make_sharded_sparse_train as j_make_sharded_sparse_train
from jodalrob_twotower_tpu.train import sparse_tables as jst

import torch_mesh_workers as workers
from torch_parity import flax_variables, model_configs, schemas, side_inputs

SPAWN_S = 150
PG_S = 60
N_ROWS = 256
BATCH = 32
STEPS = 3
WINDOW = 2
SAMPLE_SEED = 11
RTOL, ATOL = 2e-5, 1e-6
FIELDS = ("notice_table", "company_table")


def _configs(**over):
    j_mcfg, t_mcfg = model_configs(compute_dtype="float32", use_batch_norm=False)
    loss = dict(temperature=0.5, use_fused_logits=over.pop("fused", False))
    opt = dict(learning_rate=1e-2, embedding_learning_rate=5e-2)
    j_cfg = JTrainConfig(model=j_mcfg, loss=JLossConfig(**loss), optimizer=JOptimizerConfig(**opt),
                         sparse_tables=True, results_csv="")
    t_cfg = TTrainConfig(model=t_mcfg, loss=TLossConfig(**loss), optimizer=TOptimizerConfig(**opt),
                         mesh=TMeshConfig(**over), sparse_tables=True, results_csv="")
    return j_cfg, t_cfg


def _dupe_free_idx(b, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(N_ROWS)[:b], rng.permutation(N_ROWS)[:b]], axis=1).astype(np.int64)


def _jax_mesh_sparse(j_schema, j_cfg, variables, stores, idx, deferred: bool):
    """The reference's mesh sparse steps (one per batch, or one window) from
    ``variables``: (losses, tables {field: (table, acc)}, dense leaves)."""
    mesh = j_make_mesh(jax.devices()[:2])
    model = JTwoTowerModel(j_schema, j_cfg.model)

    def batch(i):
        return PairBatch(TowerBatch(*(x[i[:, 0]] for x in stores["notice"])),
                         TowerBatch(*(x[i[:, 1]] for x in stores["company"])))

    built = j_make_sharded_sparse_train(model, j_cfg, mesh, batch(idx[0]), 10,
                                        n_inner=len(idx) if deferred else None, defer_updates=deferred)
    state, step, put_batch, put_store = built[:4]
    place = lambda x, ref: jax.device_put(jnp.asarray(x), ref.sharding)  # noqa: E731
    dense, tables = jst._split_embeddings(variables["params"])
    from jodalrob_twotower_tpu.train.optimizer import build_optimizer

    dense = jax.tree.map(place, dense, state.dense_params)
    state = state.replace(
        dense_params=dense,
        opt_state=jax.tree.map(place, build_optimizer(j_cfg.optimizer, 10).init(dense), state.opt_state),
        notice_table=jst.SparseTable(place(tables["notice_tower"], state.notice_table.table),
                                     state.notice_table.accumulator),
        company_table=jst.SparseTable(place(tables["company_tower"], state.company_table.table),
                                      state.company_table.accumulator),
    )
    n_store, c_store = (put_store(tuple(jnp.asarray(x) for x in stores[s])) for s in ("notice", "company"))
    if deferred:
        state, m = built[4](state, put_batch(idx.astype(np.int32)), n_store, c_store)
        losses = np.asarray(m["loss"]).tolist()
    else:
        losses = []
        for i in idx:
            state, m = step(state, put_batch(i.astype(np.int32)), n_store, c_store)
            losses.append(float(m["loss"]))
    got = {f: (np.asarray(getattr(state, f).table), np.asarray(getattr(state, f).accumulator)) for f in FIELDS}
    dense = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_leaves_with_path(jax.device_get(state.dense_params))}
    return losses, got, dense


@pytest.fixture(scope="module")
def runs():
    j_schema, t_schema = schemas()
    j_cfg, t_cfg = _configs()
    rng = np.random.default_rng(7)
    variables = flax_variables(JTwoTowerModel(j_schema, j_cfg.model), j_schema, rng)
    stores = {side: side_inputs(j_schema.side(side), rng, N_ROWS) for side in ("notice", "company")}
    t_model = TTwoTowerModel(t_schema, t_cfg.model)
    start = {k: v.numpy() for k, v in flax_to_state_dict(t_model, variables["params"]).items()}
    idx = np.stack([_dupe_free_idx(BATCH, seed=i) for i in range(STEPS)])
    pairs = rng.integers(0, N_ROWS, size=(512, 2)).astype(np.int64)
    draws = np.stack([pairs[torch.randint(0, len(pairs), (BATCH,), generator=step_generator(
        torch.device("cpu"), SAMPLE_SEED, t, SAMPLE_STREAM)).numpy()] for t in range(STEPS)])
    cfgs = {"mesh": t_cfg, "single": t_cfg, "deferred": t_cfg, "single_deferred": t_cfg, "sampled": t_cfg,
            "replay": t_cfg, "rows_store": _configs(store_sharding="rows")[1], "fused": _configs(fused=True)[1],
            "learn": t_cfg, "plain_model": t_cfg}
    batches = {"default": idx, "deferred": idx[:WINDOW], "single_deferred": idx[:WINDOW], "replay": draws,
               "learn": pairs[np.arange(20 * BATCH) % len(pairs)].reshape(20, BATCH, 2)}
    got = spawn(workers.sparse_runs, t_schema, cfgs, start, stores, batches, pairs, SAMPLE_SEED)
    want = {"mesh": _jax_mesh_sparse(j_schema, j_cfg, variables, stores, idx, False),
            "deferred": _jax_mesh_sparse(j_schema, j_cfg, variables, stores, idx[:WINDOW], True)}
    return got, want, start


def spawn(fn, *args):
    return launch(fn, 2, args=args, timeout_s=PG_S, join_timeout_s=SPAWN_S, threads=1)


def _same(got: dict, want: dict, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol)
    for k in want["tables"]:
        np.testing.assert_allclose(got["tables"][k], want["tables"][k], rtol=rtol, atol=atol, err_msg=k)
    for k in want["dense"]:
        np.testing.assert_allclose(got["dense"][k], want["dense"][k], rtol=rtol, atol=atol, err_msg=k)


def _jax_as_port(want, t_start):
    """The reference's result in the port's keys (dense leaves mapped by
    name: <tower>/<layer>/kernel -> <tower>.<layer>.weight, transposed)."""
    losses, tables, dense = want
    out = {"losses": losses, "tables": {}, "dense": {}}
    for f, (t, a) in tables.items():
        out["tables"][f"{f}/table"], out["tables"][f"{f}/accumulator"] = t, a
    for path, v in dense.items():
        *mods, leaf = path.split("/")
        name = ".".join(mods) + (".weight" if leaf == "kernel" else ".bias")
        out["dense"][name] = v.T if leaf == "kernel" else v
    assert set(out["dense"]) == {k for k in t_start if "embeddings" not in k}
    return out


@pytest.mark.parametrize("name", ["mesh", "deferred"])
def test_mesh_sparse_matches_the_reference_mesh(runs, name):
    got, want, start = runs
    for rank in got:
        _same(rank[name], _jax_as_port(want[name], start))


@pytest.mark.parametrize("name", ["mesh", "deferred"])
def test_mesh_sparse_matches_one_device(runs, name):
    for rank in runs[0]:
        single = rank["single" if name == "mesh" else "single_deferred"]
        _same(rank[name], single)
        assert np.any(single["tables"]["notice_table/accumulator"] != np.float32(0.1))


def test_mesh_sampled_sparse_matches_hostfed_replay(runs):
    for rank in runs[0]:
        _same(rank["sampled"], rank["replay"])


def test_mesh_sparse_rows_store_equals_replicated_store(runs):
    for rank in runs[0]:
        np.testing.assert_allclose(rank["rows_store"]["losses"], rank["mesh"]["losses"], rtol=1e-6)
        _same(rank["rows_store"], rank["mesh"])


def test_mesh_sparse_from_a_model_built_without_the_mesh(runs):
    """A model built without the mesh (full tables, as the reference's
    tests pass one): the sparse state cuts each table to the rank's block
    and trains as the row-sharded model does."""
    for rank in runs[0]:
        _same(rank["plain_model"], rank["mesh"], rtol=0, atol=0)
        assert rank["plain_model"]["shard_rows"] == rank["mesh"]["shard_rows"]


def test_mesh_sparse_tables_are_sharded_and_replicas_equal(runs):
    got, _, start = runs
    for rank in got:
        for f, key in zip(FIELDS, tst.TABLE_KEYS):
            rows = start[key].shape[0]
            assert rank["mesh"]["shard_rows"][f"{f}/table"] == rank["mesh"]["shard_rows"][f"{f}/accumulator"] \
                == rows // 2
            assert rank["single"]["shard_rows"][f"{f}/table"] == rows
    for name in ("mesh", "deferred", "sampled", "fused"):
        a, b = got[0][name]["replicated"], got[1][name]["replicated"]
        assert all(np.array_equal(a[k], b[k]) for k in a), name
        assert got[0][name]["losses"] == got[1][name]["losses"], name


def test_fused_ce_on_the_sparse_mesh(runs):
    for rank in runs[0]:
        assert np.isfinite(rank["fused"]["losses"]).all()
        np.testing.assert_allclose(rank["fused"]["losses"], rank["mesh"]["losses"], rtol=1e-5)


def test_mesh_sparse_learns(runs):
    losses = runs[0][0]["learn"]["losses"]
    assert len(losses) == 20 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_the_shards_sentinel_leaves_its_rows_bit_equal():
    """Rows outside rank 1's block of a 2-rank mesh become the shard's
    sentinel: a zero update routed to the shard's last row, which stays
    bit-equal, with the accumulator at its initial 0 and eps 0 (where
    rsqrt(0) is inf) and with a touched row beside it."""
    mesh = t_make_mesh(["cpu"])
    mesh.rank, mesh.size, mesh.shape = 1, 2, {"data": 2, "model": 1}
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(64, 4)).astype(np.float32))
    for acc0, eps, rows in ((0.0, 0.0, [0, 5, 63, 3]), (0.1, 1e-8, [0, 5, 63, 3, 70])):
        st = tst.SparseTable(table.clone(), torch.full((64, 1), acc0))
        before = (st.table.clone(), st.accumulator.clone())
        g = torch.from_numpy(rng.normal(size=(len(rows), 4)).astype(np.float32))
        tst.update_shard(st, torch.tensor(rows), g, mesh, lr=0.1, eps=eps, dedup=True)
        touched = [r - 64 for r in rows if 64 <= r < 128]
        keep = [r for r in range(64) if r not in touched]
        assert torch.equal(st.table[keep], before[0][keep]) and torch.equal(st.accumulator[keep], before[1][keep])
        assert torch.equal(st.table[63], before[0][63])  # the sentinel's row
        if touched:
            assert not torch.equal(st.table[touched], before[0][touched])
