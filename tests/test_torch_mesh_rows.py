"""Row-sharded tables and stores on the port's mesh (A12b items 1-2)
against the JAX package, on the CPU: the port's ranks are separate
processes over gloo (``parallel/distributed.launch``, one torch thread
each), the reference runs on ``make_mesh(jax.devices()[:2])`` over
conftest's virtual devices, both from the same flax variables, dropout 0.

* The row exchange (tests/test_sharded_embedding.py:29-72): the lookup's
  forward equal to ``take`` and to the reference's ``make_sharded_lookup``
  (exactly: each row comes from one rank, the others add zeros), its
  gradient the scatter-add (duplicate id 3's row at 12.0), its shape
  errors; the store gather of float32, int32 and bfloat16 matrices exact,
  and its ragged refusal (tests/test_sharded_store.py:37-72).
* Two mesh steps under "shard_map" and "gspmd_rows" against the reference's
  mesh step of the same mode (tests/test_sharding.py:113-131,
  tests/test_sharded_embedding.py:254): each loss within rtol 1e-5, every
  leaf (the tables joined from the ranks' blocks) within rtol 2e-4 / atol
  1e-6 but for at most ``NOISE_SHARE`` of a leaf (the biases before a
  training-form BatchNorm, as tests/test_torch_mesh_train.py), the
  BatchNorm statistics within 1e-5. The replicated leaves bit-equal across
  the ranks, the table rows no batch touched bit-equal to their start,
  each rank holding R/2 rows of each table and accumulator.
* A row-sharded store step equal to the replicated-store step (loss rtol
  1e-6, params rtol 1e-5 / atol 1e-6, tests/test_sharded_store.py:87-126);
  global-norm clipping on the row-sharded mesh equal to one device's
  (as the mode tolerances).
* The mesh Trainer with row-sharded tables and stores (:153-298): its
  losses within rel 1e-4 of the replicated-store run; device eval equal to
  the host-assembled eval (rtol 1e-4 / atol 1e-6, recall equal, mrr rtol
  1e-5); the corpus encode at a chunk that does not divide the mesh equal
  to the host encode (rtol 1e-4 / atol 1e-5), and at a chunk below the
  mesh size; an eval batch off the mesh multiple refused. A preempted row-sharded run resumed bit-equal to a
  straight run; its checkpoint has one device's keys and shapes and
  restores on one device.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from jodalrob_twotower_torch.config import DataConfig as TDataConfig
from jodalrob_twotower_torch.config import LossConfig as TLossConfig
from jodalrob_twotower_torch.config import MeshConfig as TMeshConfig
from jodalrob_twotower_torch.config import OptimizerConfig as TOptimizerConfig
from jodalrob_twotower_torch.config import TrainConfig as TTrainConfig
from jodalrob_twotower_torch.convert import flax_to_state_dict, state_dict_to_flax
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel as TTwoTowerModel
from jodalrob_twotower_torch.parallel.distributed import launch
from jodalrob_twotower_torch.train.checkpoint import CheckpointManager
from jodalrob_twotower_torch.train.train_step import create_train_state as t_create_train_state
from jodalrob_twotower_tpu.config import LossConfig as JLossConfig
from jodalrob_twotower_tpu.config import MeshConfig as JMeshConfig
from jodalrob_twotower_tpu.config import OptimizerConfig as JOptimizerConfig
from jodalrob_twotower_tpu.config import TrainConfig as JTrainConfig
from jodalrob_twotower_tpu.data.types import PairBatch, TowerBatch
from jodalrob_twotower_tpu.models import build_model as j_build_model
from jodalrob_twotower_tpu.models.two_tower import TwoTowerModel as JTwoTowerModel
from jodalrob_twotower_tpu.parallel.mesh import DATA_AXIS
from jodalrob_twotower_tpu.parallel.mesh import make_mesh as j_make_mesh
from jodalrob_twotower_tpu.parallel.sharded_embedding import make_sharded_lookup as j_make_sharded_lookup
from jodalrob_twotower_tpu.parallel.sharded_train import make_sharded_train as j_make_sharded_train
from jodalrob_twotower_tpu.train.optimizer import build_optimizer as j_build_optimizer

import torch_mesh_workers as workers
from torch_parity import flax_variables, model_configs, schemas, side_inputs

SPAWN_S = 150
PG_S = 60
N_ROWS = 301  # odd: the row-sharded stores pad one row
STEPS = 2
BATCH = 64
LR = 1e-3
NOISE_SHARE = 0.07
MODES = ("shard_map", "gspmd_rows")
TABLES = ("notice_tower.embeddings.table", "company_tower.embeddings.table")


def spawn(fn, *args):
    return launch(fn, 2, args=args, timeout_s=PG_S, join_timeout_s=SPAWN_S, threads=1)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": np.asarray(v)})
    return out


def _close(got, want, rtol, atol, noise_share=0.0):
    bad = ~np.isclose(got, want, rtol=rtol, atol=atol)
    return bad.mean() <= noise_share, float(np.abs(got - want).max())


# -- the exchange ------------------------------------------------------------------


@pytest.fixture(scope="module")
def exchange():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(256, 8)).astype(np.float32)
    rows = np.tile(np.asarray([[3, 3], [250, 0], [3, 9], [100, 100]], np.int32), (2, 1))  # batch 8
    mats = {"f32": rng.normal(size=(63, 8)).astype(np.float32),
            "int32": rng.integers(0, 1000, size=(63, 5)).astype(np.int32),
            "bf16": rng.normal(size=(63, 8)).astype(np.float32)}
    store_rows = rng.integers(0, 63, size=32).astype(np.int64)
    got = spawn(workers.exchange_checks, table, rows, mats, store_rows)
    return table, rows, mats, store_rows, got


def test_row_exchange_lookup_is_take_and_its_gradient_the_scatter_add(exchange):
    table, rows, _, _, got = exchange
    out = np.concatenate([r["lookup"] for r in got])
    np.testing.assert_array_equal(out, table[rows])
    mesh = j_make_mesh(jax.devices()[:2])
    want = jax.jit(j_make_sharded_lookup(mesh))(
        jax.device_put(table, NamedSharding(mesh, P(DATA_AXIS, None))),
        jax.device_put(rows, NamedSharding(mesh, P(DATA_AXIS, None))))
    np.testing.assert_array_equal(out, np.asarray(want))
    grad = np.concatenate([r["grad"] for r in got])  # rank r's block of rows
    ref = np.zeros_like(table)
    np.add.at(ref, rows.reshape(-1), 2.0)
    np.testing.assert_allclose(grad, ref, rtol=1e-6)
    np.testing.assert_allclose(grad[3], np.full(8, 12.0))  # id 3: 3 times per half, tiled twice
    for r in got:
        assert r["grad"].shape == (128, 8)


def test_row_exchange_refuses_shapes_off_the_axis(exchange):
    for r in exchange[-1]:
        assert "must divide" in r["errors"][0]  # 101 rows over 2 ranks
        assert "must divide" in r["errors"][1] and "holding 50 rows (got 64)" in r["errors"][1]


@pytest.mark.parametrize("name", ["f32", "int32", "bf16"])
def test_store_gather_is_exact(exchange, name):
    _, _, mats, store_rows, got = exchange
    want = mats[name][store_rows]
    if name == "bf16":
        want = torch.from_numpy(want).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(np.concatenate([r["stores"][name] for r in got]), want)
    assert all(r["shard_rows"] == 32 for r in got)  # 63 rows padded to 64, 32 a rank


def test_store_gather_refuses_a_ragged_store(exchange):
    for r in exchange[-1]:
        assert "must divide" in r["ragged"] and "put_row_sharded_store" in r["ragged"]


# -- mesh steps --------------------------------------------------------------------


def _configs(mode: str, **over):
    j_mcfg, t_mcfg = model_configs(compute_dtype="float32")
    loss = dict(temperature=0.2, use_fused_logits=False)
    opt = dict(learning_rate=LR, **over.pop("opt", {}))
    mesh = dict(embedding_sharding=mode, **over)
    j_cfg = JTrainConfig(model=j_mcfg, loss=JLossConfig(**loss), optimizer=JOptimizerConfig(**opt),
                         mesh=JMeshConfig(**mesh))
    t_cfg = TTrainConfig(model=t_mcfg, loss=TLossConfig(**loss), optimizer=TOptimizerConfig(**opt),
                         mesh=TMeshConfig(**mesh))
    return j_cfg, t_cfg


def _jax_steps(j_schema, j_cfg, variables, stores, idx):
    mesh = j_make_mesh(jax.devices()[:2], j_cfg.mesh)
    model = j_build_model(j_schema, j_cfg, mesh)

    def batch(i):
        return PairBatch(TowerBatch(*(x[i[:, 0]] for x in stores["notice"])),
                         TowerBatch(*(x[i[:, 1]] for x in stores["company"])))

    state, step, shard_batch = j_make_sharded_train(model, j_cfg, mesh, batch(idx[0]), total_steps=10)
    place = lambda x, ref: jax.device_put(jnp.asarray(x), ref.sharding)  # noqa: E731
    params = jax.tree.map(place, variables["params"], state.params)
    stats = jax.tree.map(place, variables["batch_stats"], state.batch_stats)
    opt = jax.tree.map(place, j_build_optimizer(j_cfg.optimizer, 10).init(params), state.opt_state)
    state = state.replace(params=params, batch_stats=stats, opt_state=opt)
    out = []
    for i in idx:
        state, m = step(state, shard_batch(batch(i)))
        out.append((float(m["loss"]), _leaves(jax.device_get(state.params)),
                    _leaves(jax.device_get(state.batch_stats))))
    return out


@pytest.fixture(scope="module")
def step_runs():
    j_schema, t_schema = schemas()
    rng = np.random.default_rng(21)
    j_cfgs = {mode: _configs(mode)[0] for mode in MODES}
    t_cfgs = {mode: _configs(mode)[1] for mode in MODES}
    t_cfgs["rows_store"] = _configs("gspmd_rows", store_sharding="rows")[1]
    t_cfgs["clip"] = _configs("gspmd_rows", opt=dict(gradient_clip_norm=0.05))[1]
    t_cfgs["single_clip"] = t_cfgs["clip"]
    j_model = JTwoTowerModel(j_schema, j_cfgs["gspmd_rows"].model)
    variables = flax_variables(j_model, j_schema, rng)
    stores = {side: side_inputs(j_schema.side(side), rng, N_ROWS) for side in ("notice", "company")}
    idx = rng.integers(0, N_ROWS, size=(STEPS, BATCH, 2))
    t_model = TTwoTowerModel(t_schema, t_cfgs["gspmd_rows"].model)
    start = {k: v.numpy() for k, v in flax_to_state_dict(t_model, variables["params"],
                                                          variables["batch_stats"]).items()}
    got = spawn(workers.rows_steps, t_schema, t_cfgs, start, stores, idx)
    want = {mode: _jax_steps(j_schema, j_cfgs[mode], variables, stores, idx) for mode in MODES}
    return got, want, t_model, start, stores, idx


def _as_flax(t_model, sd):
    params, stats = state_dict_to_flax(t_model, {k: torch.from_numpy(v) for k, v in sd.items()})
    return _leaves(params), _leaves(stats)


@pytest.mark.parametrize("mode", MODES)
def test_row_sharded_steps_match_the_reference_mesh_step(step_runs, mode):
    got, want, t_model, _, _, _ = step_runs
    for r, rank in enumerate(got):
        run = rank[mode]
        assert run["row_sharded"] == sorted(TABLES)
        for s, (w_loss, w_params, w_stats) in enumerate(want[mode]):
            assert abs(run["losses"][s] - w_loss) <= 1e-5 * abs(w_loss), (mode, r, s)
            params, stats = _as_flax(t_model, run["states"][s])
            assert set(params) == set(w_params) and set(stats) == set(w_stats)
            for k in w_params:
                ok, worst = _close(params[k], w_params[k], 2e-4, 1e-6, NOISE_SHARE)
                assert ok, (mode, s, k, worst)
            for k in w_stats:
                np.testing.assert_allclose(stats[k], w_stats[k], rtol=0, atol=1e-5, err_msg=f"{mode} {k}")


@pytest.mark.parametrize("mode", MODES)
def test_row_sharded_ranks_hold_blocks_and_stay_equal(step_runs, mode):
    got, _, t_model, start, stores, idx = step_runs
    a, b = got[0][mode], got[1][mode]
    for s in range(STEPS):
        assert a["losses"][s] == b["losses"][s]
        assert all(np.array_equal(a["replicated"][s][k], b["replicated"][s][k]) for k in a["replicated"][s])
        assert all(np.array_equal(a["states"][s][k], b["states"][s][k]) for k in a["states"][s])
    for key in TABLES:
        total = start[key].shape[0]
        assert a["shard_shapes"][key] == b["shard_shapes"][key] == (total // 2, start[key].shape[1])
        assert a["acc"][key].shape == (total, 1)
    # rows no batch touched: bit-equal to their start, the accumulator too
    from jodalrob_twotower_torch.models.embedding import absolute_rows

    for side, key in (("notice", TABLES[0]), ("company", TABLES[1])):
        vocabs = t_model.schema.side(side).vocab_sizes
        touched = np.unique(absolute_rows(vocabs, torch.from_numpy(stores[side][1][idx[:, :, 0 if side == "notice"
                                                                                      else 1].reshape(-1)])))
        untouched = np.setdiff1d(np.arange(start[key].shape[0]), touched)
        assert len(untouched) > 0
        np.testing.assert_array_equal(a["states"][-1][key][untouched], start[key][untouched])
        assert np.all(a["acc"][key][untouched] == np.float32(0.1))
        assert not np.array_equal(a["states"][-1][key][touched], start[key][touched])


def test_row_sharded_store_step_equals_the_replicated_store_step(step_runs):
    got = step_runs[0][0]
    rows, rep = got["rows_store"], got["gspmd_rows"]
    assert rows["store_rows"] == (N_ROWS + 1) // 2 and rep["store_rows"] == N_ROWS
    for s in range(STEPS):
        assert rows["losses"][s] == pytest.approx(rep["losses"][s], rel=1e-6)
        for k in rep["states"][s]:
            np.testing.assert_allclose(rows["states"][s][k], rep["states"][s][k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_global_norm_clip_on_the_row_sharded_mesh_equals_one_device(step_runs):
    got = step_runs[0][0]
    mesh, single = got["clip"], got["single_clip"]
    unclipped = got["gspmd_rows"]
    for s in range(STEPS):
        assert abs(mesh["losses"][s] - single["losses"][s]) <= 1e-5 * abs(single["losses"][s])
    for k in single["state"]:
        ok, worst = _close(mesh["states"][-1][k], single["state"][k], 2e-4, 1e-6, NOISE_SHARE)
        assert ok, (k, worst)
    # the clip was active: the clipped tables moved less than the unclipped
    key = TABLES[0]
    start = step_runs[3][key]
    assert np.abs(mesh["states"][-1][key] - start).max() < np.abs(unclipped["states"][-1][key] - start).max()


# -- the mesh trainer ----------------------------------------------------------------

T_BATCH = 32


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    j_schema, t_schema = schemas()
    rng = np.random.default_rng(17)
    cfgs = {}
    for store in ("rows", "replicated"):
        _, t_cfg = _configs("gspmd_rows", store_sharding=store, opt=dict(num_epochs=2))
        cfgs[store] = t_cfg.replace(data=TDataConfig(batch_size=T_BATCH), results_csv="", seed=5)
    j_model = JTwoTowerModel(j_schema, model_configs(compute_dtype="float32")[0])
    variables = flax_variables(j_model, j_schema, rng)
    t_model = TTwoTowerModel(t_schema, cfgs["rows"].model)
    start = {k: v.numpy() for k, v in flax_to_state_dict(t_model, variables["params"],
                                                          variables["batch_stats"]).items()}
    stores = {side: side_inputs(j_schema.side(side), rng, N_ROWS) for side in ("notice", "company")}
    pairs = rng.integers(0, N_ROWS, size=(192, 2)).astype(np.int64)
    tmp = tmp_path_factory.mktemp("mesh_rows")
    got = spawn(workers.rows_trainer, t_schema, cfgs, stores, start, pairs[:128], pairs[128:], str(tmp))
    return got, cfgs, t_model, start, tmp


def test_row_sharded_trainer_matches_the_replicated_store_trainer(trainer_runs):
    got = trainer_runs[0]
    for rank in got:
        rows, rep = rank["rows"], rank["replicated"]
        assert rows["rows_store"] and not rep["rows_store"]
        assert len(rows["history"]) == 2
        for a, b in zip(rows["history"], rep["history"]):
            assert a["train_loss"] == pytest.approx(b["train_loss"], rel=1e-4)
            assert a["val_loss"] == pytest.approx(b["val_loss"], rel=1e-4)
    for a, b in zip(got[0]["rows"]["history"], got[1]["rows"]["history"]):  # the ranks agree
        assert (a["train_loss"], a["val_loss"]) == (b["train_loss"], b["val_loss"])


def test_row_sharded_device_eval_matches_host_eval(trainer_runs):
    for rank in trainer_runs[0]:
        row = rank["rows"]
        for k in ("loss", "accuracy", "mrr", "similarity_gap", "z_gap"):
            np.testing.assert_allclose(row["dev_val"][k], row["host_val"][k], rtol=1e-4, atol=1e-6, err_msg=k)
        assert row["dev_corpus"][0] == row["host_corpus"][0]
        np.testing.assert_allclose(row["dev_corpus"][1], row["host_corpus"][1], rtol=1e-5)
        np.testing.assert_allclose(row["odd_chunk"], row["corpus_emb"], rtol=1e-4, atol=1e-5)
        assert row["odd_chunk"].shape == (N_ROWS, 16)
        assert "multiple" in row["odd_batch"]


def test_a_chunk_below_the_mesh_size_encodes_the_corpus(trainer_runs):
    """A corpus chunk smaller than the mesh (1 of 2 ranks) rounds up to the
    mesh size, as evaluation/evaluator.py:197-199 of the JAX package
    rounds it (ROADMAP C11: the port rounded it down to 0 and looped)."""
    for rank in trainer_runs[0]:
        for store in ("rows", "replicated"):
            row = rank[store]
            np.testing.assert_allclose(row["tiny_chunk"], row["corpus_emb"], rtol=1e-4, atol=1e-5)


def test_row_sharded_resume_is_bit_equal_and_restores_on_one_device(trainer_runs):
    got, cfgs, t_model, start, tmp = trainer_runs
    res = got[0]["resume"]
    assert res["saved_at"] == [2, 4] and res["step"] == 8
    assert res["files"] == ["best", "best.json", "config.json", "epoch_0", "epoch_1", "final", "step.json",
                            "step_a", "step_b", "weights"]
    for k in res["straight"]:
        assert np.array_equal(res["resumed"][k], res["straight"][k]), k
    assert got[1]["resume"]["restored_equal"] and res["restored_equal"]
    for key in TABLES:
        assert res["shard_rows"][key] == start[key].shape[0] // 2
    # the files hold one device's keys and shapes, and restore on one device
    t_model.load_state_dict({k: torch.from_numpy(v) for k, v in start.items()})
    single, _ = t_create_train_state(t_model, cfgs["rows"], 5, 8, device="cpu")
    back = CheckpointManager(tmp / "ckpt").restore("final", single)
    for k, v in back.params.items():
        assert np.array_equal(v.numpy(), res["resumed"][k]), k
    for k in TABLES:
        assert np.array_equal(back.opt_state["acc"][k].numpy(), res["resumed"][f"acc/{k}"]), k
    weights = CheckpointManager(tmp / "ckpt").restore_weights(t_model.state_dict(), device="cpu")
    assert {k: tuple(v.shape) for k, v in weights["params"].items()} == {
        k: tuple(v.shape) for k, v in single.params.items()}
