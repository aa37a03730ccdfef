"""A model axis above 1 on the port's mesh, on the CPU: four gloo ranks
(``parallel/distributed.launch``, one torch thread each) form a (2, 2)
(data, model) mesh, and ranks 0 and 1 also a (2, 1) mesh of their own;
the reference runs ``make_sharded_train`` on
``make_mesh(jax.devices()[:4], MeshConfig(data_axis=2, model_axis=2))``
over conftest's virtual devices, from the same flax variables, dropout 0.

* The layout: rank r at data index r // 2 and model index r % 2 (the
  reference's row-major reshape), ``shape == {"data": 2, "model": 2}``,
  global rank 0 the only main rank.
* Two steps under replicated and "gspmd_rows" tables: each (2, 2) rank's
  losses, summed gradients and states (the row-sharded tables joined from
  the data group's blocks) bit-equal to the (2, 1) rank of its data index,
  so the two ranks of each data index are bit-equal to each other; each
  loss within rtol 1e-5 of the reference's (2, 2) step and the params
  within rtol 2e-4 / atol 1e-6 but for ``NOISE_SHARE`` of a leaf, the
  BatchNorm statistics within 1e-5 (tests/test_torch_mesh_train.py's
  tolerances).
* ``host_shard_pairs`` with the mesh gives the ranks of one data index the
  same pairs; without it, every process its own.
* A (2, 2) mesh ``Trainer`` with checkpoints and a results CSV: only global
  rank 0 writes files, and the four ranks end bit-equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.config import DataConfig as TDataConfig
from jodalrob_twotower_torch.config import LossConfig as TLossConfig
from jodalrob_twotower_torch.config import MeshConfig as TMeshConfig
from jodalrob_twotower_torch.config import OptimizerConfig as TOptimizerConfig
from jodalrob_twotower_torch.config import TrainConfig as TTrainConfig
from jodalrob_twotower_torch.convert import flax_to_state_dict, state_dict_to_flax
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel as TTwoTowerModel
from jodalrob_twotower_torch.parallel.distributed import launch
from jodalrob_twotower_tpu.config import LossConfig as JLossConfig
from jodalrob_twotower_tpu.config import MeshConfig as JMeshConfig
from jodalrob_twotower_tpu.config import OptimizerConfig as JOptimizerConfig
from jodalrob_twotower_tpu.config import TrainConfig as JTrainConfig
from jodalrob_twotower_tpu.data.types import PairBatch, TowerBatch
from jodalrob_twotower_tpu.models import build_model as j_build_model
from jodalrob_twotower_tpu.models.two_tower import TwoTowerModel as JTwoTowerModel
from jodalrob_twotower_tpu.parallel.mesh import make_mesh as j_make_mesh
from jodalrob_twotower_tpu.parallel.sharded_train import make_sharded_train as j_make_sharded_train
from jodalrob_twotower_tpu.train.optimizer import build_optimizer as j_build_optimizer

import torch_mesh_workers as workers
from torch_parity import flax_variables, model_configs, schemas, side_inputs

torch.set_num_threads(1)

SPAWN_S = 180
PG_S = 90
N_ROWS = 300
STEPS = 2
BATCH = 64
LR = 1e-3
NOISE_SHARE = 0.07  # tests/test_torch_mesh_train.py
MODES = ("replicated", "gspmd_rows")


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": np.asarray(v)})
    return out


def _configs(mode: str):
    j_mcfg, t_mcfg = model_configs(compute_dtype="float32")
    loss = dict(temperature=0.2, use_fused_logits=False)
    j_cfg = JTrainConfig(model=j_mcfg, loss=JLossConfig(**loss), optimizer=JOptimizerConfig(learning_rate=LR),
                         mesh=JMeshConfig(embedding_sharding=mode, data_axis=2, model_axis=2))
    t_cfg = TTrainConfig(model=t_mcfg, loss=TLossConfig(**loss), optimizer=TOptimizerConfig(learning_rate=LR),
                         mesh=TMeshConfig(embedding_sharding=mode))
    return j_cfg, t_cfg


def _jax_steps(j_schema, j_cfg, variables, stores, idx):
    mesh = j_make_mesh(jax.devices()[:4], j_cfg.mesh)
    assert mesh.shape == {"data": 2, "model": 2}
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
def runs(tmp_path_factory):
    j_schema, t_schema = schemas()
    rng = np.random.default_rng(31)
    j_cfgs = {mode: _configs(mode)[0] for mode in MODES}
    t_cfgs = {mode: _configs(mode)[1] for mode in MODES}
    j_model = JTwoTowerModel(j_schema, j_cfgs["replicated"].model)
    variables = flax_variables(j_model, j_schema, rng)
    stores = {side: side_inputs(j_schema.side(side), rng, N_ROWS) for side in ("notice", "company")}
    idx = rng.integers(0, N_ROWS, size=(STEPS, BATCH, 2))
    t_model = TTwoTowerModel(t_schema, t_cfgs["replicated"].model)
    start = {k: v.numpy() for k, v in flax_to_state_dict(t_model, variables["params"],
                                                          variables["batch_stats"]).items()}
    trainer_cfg = t_cfgs["replicated"].replace(
        data=TDataConfig(batch_size=32), optimizer=TOptimizerConfig(learning_rate=LR, num_epochs=1))
    pairs = rng.integers(0, N_ROWS, size=(96, 2)).astype(np.int64)
    tmp = tmp_path_factory.mktemp("model_axis")
    got = launch(workers.model_axis_runs, 4, args=(t_schema, t_cfgs, start, stores, idx, trainer_cfg, pairs,
                                                   str(tmp)),
                 timeout_s=PG_S, join_timeout_s=SPAWN_S, threads=1)
    want = {mode: _jax_steps(j_schema, j_cfgs[mode], variables, stores, idx) for mode in MODES}
    return got, want, t_model, pairs


def test_the_ranks_lie_row_major_on_the_data_and_model_axes(runs):
    got = runs[0]
    for r, rank in enumerate(got):
        assert rank["rank"] == r
        assert (rank["data_index"], rank["model_index"]) == (r // 2, r % 2)
        assert rank["data_size"] == 2 and rank["shape"] == {"data": 2, "model": 2}
        assert rank["is_main"] == (r == 0)


@pytest.mark.parametrize("mode", MODES)
def test_model_axis_steps_are_bit_equal_to_the_one_axis_mesh(runs, mode):
    got = runs[0]
    for r, rank in enumerate(got):
        a, b = rank["mesh22"][mode], got[r // 2]["mesh21"][mode]  # the (2, 1) rank of its data index
        assert a["losses"] == b["losses"], (mode, r)
        assert a["row_sharded"] == b["row_sharded"] and a["shard_rows"] == b["shard_rows"]
        for s in range(STEPS):
            for part in ("grads", "states"):
                x, y = a[part][s], b[part][s]
                assert set(x) == set(y) and all(np.array_equal(x[k], y[k]) for k in x), (mode, r, s, part)
    if mode == "gspmd_rows":
        assert got[0]["mesh22"][mode]["row_sharded"] == ["company_tower.embeddings.table",
                                                         "notice_tower.embeddings.table"]
        run = got[0]["mesh22"][mode]
        for k, rows in run["shard_rows"].items():  # each data index holds half of each table's rows
            assert 2 * rows == run["states"][-1][k].shape[0], k


@pytest.mark.parametrize("mode", MODES)
def test_model_axis_steps_match_the_reference_model_axis_step(runs, mode):
    got, want, t_model, _ = runs
    run = got[0]["mesh22"][mode]
    for s, (w_loss, w_params, w_stats) in enumerate(want[mode]):
        assert abs(run["losses"][s] - w_loss) <= 1e-5 * abs(w_loss), (mode, s)
        params, stats = state_dict_to_flax(t_model, {k: torch.from_numpy(v) for k, v in run["states"][s].items()})
        params, stats = _leaves(params), _leaves(stats)
        assert set(params) == set(w_params) and set(stats) == set(w_stats)
        for k in w_params:
            bad = ~np.isclose(params[k], w_params[k], rtol=2e-4, atol=1e-6)
            assert bad.mean() <= NOISE_SHARE, (mode, s, k, float(np.abs(params[k] - w_params[k]).max()))
        for k in w_stats:
            np.testing.assert_allclose(stats[k], w_stats[k], rtol=0, atol=1e-5, err_msg=f"{mode} {k}")


def test_host_shard_pairs_follows_the_data_axis(runs):
    got, _, _, pairs = runs
    for r, rank in enumerate(got):
        np.testing.assert_array_equal(rank["pairs"], pairs[r // 2::2][:len(pairs) // 2])
        np.testing.assert_array_equal(rank["pairs_no_mesh"], pairs[r::4][:len(pairs) // 4])


def test_only_global_rank_0_writes_and_the_trainer_ranks_stay_equal(runs):
    got = runs[0]
    files = got[0]["trainer"]["files"]
    assert "results.csv" in files and "ckpt/config.json" in files
    assert any(f.startswith("ckpt/final/") for f in files) and any(f.startswith("ckpt/epoch_0/") for f in files)
    for rank in got[1:]:
        assert rank["trainer"]["files"] == [], rank["rank"]
    first = got[0]["trainer"]
    for rank in got[1:]:
        assert all(np.array_equal(first["state"][k], rank["trainer"]["state"][k]) for k in first["state"])
        assert [h["train_loss"] for h in rank["trainer"]["history"]] == [h["train_loss"] for h in first["history"]]
