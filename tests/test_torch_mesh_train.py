"""Training on the port's mesh against the JAX package's mesh, on the CPU:
the port's ranks are separate processes over gloo
(``parallel/distributed.launch``), the reference runs on
``make_mesh(jax.devices()[:2])`` over conftest's virtual devices, both from
the same flax variables converted by ``convert.flax_to_state_dict``
(tests/torch_parity.py's schema and widths), dropout 0.

* Two mesh train steps (``parallel/sharded_train.make_sharded_train``)
  against the reference's ``make_sharded_train`` step: float32 towers with
  BatchNorm, the materialized loss ("f32") and the fused loss ("f32-fused":
  the mesh CE's plain versions against the reference's shard_mapped
  kernels in interpret mode). Each step's loss within rtol 1e-5, the params
  within rtol 2e-4 / atol 1e-6 (tests/test_sharding.py:113-131) but for
  the entries whose gradient is rounding noise (the biases before a
  training-form BatchNorm; at most ``NOISE_SHARE`` of a leaf, as in
  tests/test_torch_train_step.py), and the BatchNorm running statistics
  within 1e-5 (that file's float32 tolerance for them). The two ranks' states are bit-equal, and the mesh steps
  agree with the port's single-device steps on the whole batches.
* The mesh ``Trainer`` against the reference's mesh ``Trainer``: per-epoch
  train and validation losses within rtol 1e-4
  (tests/test_trainer_mesh.py:51-64), the same history keys.
* A mesh run preempted after its second mid-epoch checkpoint and resumed
  ends bit-equal to a straight run; rank 0 alone wrote the files.
* The batch divisibility guard raises as the reference's does.

Each spawn gives its ranks one torch thread, a process-group timeout and a
join deadline, so a hung collective fails its test."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from jodalrob_twotower_torch.config import DataConfig as TDataConfig
from jodalrob_twotower_torch.config import LossConfig as TLossConfig
from jodalrob_twotower_torch.config import OptimizerConfig as TOptimizerConfig
from jodalrob_twotower_torch.config import TrainConfig as TTrainConfig
from jodalrob_twotower_torch.convert import flax_to_state_dict, state_dict_to_flax
from jodalrob_twotower_torch.data.parquet_dataset import save_pairs_parquet
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel as TTwoTowerModel
from jodalrob_twotower_torch.parallel.distributed import launch
from jodalrob_twotower_tpu.config import DataConfig as JDataConfig
from jodalrob_twotower_tpu.config import LossConfig as JLossConfig
from jodalrob_twotower_tpu.config import OptimizerConfig as JOptimizerConfig
from jodalrob_twotower_tpu.config import TrainConfig as JTrainConfig
from jodalrob_twotower_tpu.data.feature_store import FeatureStore as JFeatureStore
from jodalrob_twotower_tpu.data.pipeline import assemble_pair_batch
from jodalrob_twotower_tpu.data.types import PairBatch, TowerBatch
from jodalrob_twotower_tpu.models import build_model as j_build_model
from jodalrob_twotower_tpu.models.two_tower import TwoTowerModel as JTwoTowerModel
from jodalrob_twotower_tpu.parallel.mesh import make_mesh as j_make_mesh
from jodalrob_twotower_tpu.parallel.sharded_train import make_sharded_train as j_make_sharded_train
from jodalrob_twotower_tpu.train.train_step import create_train_state
from jodalrob_twotower_tpu.train.trainer import Trainer as JTrainer

import torch_mesh_workers as workers
from torch_parity import flax_variables, model_configs, schemas, side_inputs

SPAWN_S = 150
PG_S = 60
N_ROWS = 300
STEPS = 2
LR = 1e-3
NOISE_SHARE = 0.07
CASES = {  # name: (model overrides, use_fused_logits, global batch)
    "f32": (dict(compute_dtype="float32"), False, 64),
    "f32-fused": (dict(compute_dtype="float32", final_embedding_dim=128), True, 128),
}


def spawn(fn, *args):
    return launch(fn, 2, args=args, timeout_s=PG_S, join_timeout_s=SPAWN_S, threads=1)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": np.asarray(v)})
    return out


def _as_flax(t_model, sd):
    params, stats = state_dict_to_flax(t_model, {k: torch.from_numpy(v) for k, v in sd.items()})
    return _leaves(params), _leaves(stats)


def _step_setup(name):
    model_kw, fused, b = CASES[name]
    j_schema, t_schema = schemas()
    j_mcfg, t_mcfg = model_configs(**model_kw)
    loss = dict(temperature=0.2, use_fused_logits=fused)
    j_cfg = JTrainConfig(model=j_mcfg, loss=JLossConfig(**loss), optimizer=JOptimizerConfig(learning_rate=LR))
    t_cfg = TTrainConfig(model=t_mcfg, loss=TLossConfig(**loss), optimizer=TOptimizerConfig(learning_rate=LR))
    rng = np.random.default_rng(21)
    j_model = JTwoTowerModel(j_schema, j_mcfg)
    variables = flax_variables(j_model, j_schema, rng)
    stores = {side: side_inputs(j_schema.side(side), rng, N_ROWS) for side in ("notice", "company")}
    idx = rng.integers(0, N_ROWS, size=(STEPS, b, 2))
    t_model = TTwoTowerModel(t_schema, t_mcfg)
    start = {k: v.numpy() for k, v in flax_to_state_dict(t_model, variables["params"],
                                                          variables["batch_stats"]).items()}
    return j_schema, j_cfg, variables, stores, idx, t_schema, t_cfg, t_model, start


def _jax_steps(j_schema, j_cfg, variables, stores, idx):
    mesh = j_make_mesh(jax.devices()[:2], j_cfg.mesh)
    model = j_build_model(j_schema, j_cfg, mesh)

    def batch(i):
        return PairBatch(TowerBatch(*(x[i[:, 0]] for x in stores["notice"])),
                         TowerBatch(*(x[i[:, 1]] for x in stores["company"])))

    state, step, shard_batch = j_make_sharded_train(model, j_cfg, mesh, batch(idx[0]), total_steps=10)
    rep = NamedSharding(mesh, P())
    params = jax.device_put(jax.tree.map(jnp.asarray, variables["params"]), rep)
    stats = jax.device_put(jax.tree.map(jnp.asarray, variables["batch_stats"]), rep)
    opt = jax.tree.map(lambda x, ref: jax.device_put(x, ref.sharding), state.opt_state, state.opt_state)
    from jodalrob_twotower_tpu.train.optimizer import build_optimizer

    tx = build_optimizer(j_cfg.optimizer, 10)
    opt = jax.tree.map(lambda x, ref: jax.device_put(x, ref.sharding), tx.init(params), opt)
    state = state.replace(params=params, batch_stats=stats, opt_state=opt)
    out = []
    for i in idx:
        state, m = step(state, shard_batch(batch(i)))
        out.append((float(m["loss"]), _leaves(jax.device_get(state.params)),
                    _leaves(jax.device_get(state.batch_stats))))
    return out


@pytest.fixture(scope="module", params=list(CASES))
def step_runs(request):
    j_schema, j_cfg, variables, stores, idx, t_schema, t_cfg, t_model, start = _step_setup(request.param)
    got = spawn(workers.train_step, t_schema, t_cfg, start, stores, idx, STEPS)
    return request.param, _jax_steps(j_schema, j_cfg, variables, stores, idx), got, t_model


def _close(got, want, rtol, atol, noise_share=0.0):
    bad = ~np.isclose(got, want, rtol=rtol, atol=atol)
    return bad.mean() <= noise_share, float(np.abs(got - want).max())


def test_mesh_steps_match_the_reference_mesh_step(step_runs):
    name, want, got, t_model = step_runs
    for r, rank in enumerate(got):
        for s, (w_loss, w_params, w_stats) in enumerate(want):
            assert abs(rank["losses"][s]["loss"] - w_loss) <= 1e-5 * abs(w_loss), (name, r, s)
            params, stats = _as_flax(t_model, rank["states"][s])
            assert set(params) == set(w_params) and set(stats) == set(w_stats)
            for k in w_params:
                ok, worst = _close(params[k], w_params[k], 2e-4, 1e-6, NOISE_SHARE)
                assert ok, (name, s, k, worst)
            for k in w_stats:
                np.testing.assert_allclose(stats[k], w_stats[k], rtol=0, atol=1e-5, err_msg=f"{name} {k}")


def test_mesh_ranks_stay_equal_and_match_the_single_device_step(step_runs):
    name, _, got, _ = step_runs
    for s in range(STEPS):
        a, b = got[0]["states"][s], got[1]["states"][s]
        assert all(np.array_equal(a[k], b[k]) for k in a), (name, s)
        assert got[0]["losses"][s] == got[1]["losses"][s]
        assert abs(got[0]["losses"][s]["loss"] - got[0]["single_losses"][s]) <= 1e-5 * abs(got[0]["single_losses"][s])
    final, single = got[0]["states"][-1], got[0]["single_state"]
    for k in final:
        ok, worst = _close(final[k], single[k], 2e-4, 1e-6, NOISE_SHARE)
        assert ok, (name, k, worst)
    if name == "f32":  # the materialized loss's in-batch metrics are the global batch's
        assert {"accuracy", "mrr", "recall@10"} <= set(got[0]["losses"][0])


BATCH = 32
N_INNER = 3


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    j_schema, t_schema = schemas()
    j_mcfg, t_mcfg = model_configs(compute_dtype="float32", dropout_rate=0.0)
    common = dict(temperature=0.2, use_fused_logits=False)
    j_cfg = JTrainConfig(model=j_mcfg, loss=JLossConfig(**common),
                         optimizer=JOptimizerConfig(learning_rate=1e-3, num_epochs=2),
                         data=JDataConfig(batch_size=BATCH), results_csv="", seed=5)
    t_cfg = TTrainConfig(model=t_mcfg, loss=TLossConfig(**common),
                         optimizer=TOptimizerConfig(learning_rate=1e-3, num_epochs=2),
                         data=TDataConfig(batch_size=BATCH), results_csv="", seed=5)
    rng = np.random.default_rng(17)
    stores = {side: side_inputs(j_schema.side(side), rng, N_ROWS) for side in ("notice", "company")}
    keys = np.arange(N_ROWS).astype(str)
    j_stores = [JFeatureStore(j_schema.side(s), *stores[s], keys) for s in ("notice", "company")]
    pairs = rng.integers(0, N_ROWS, size=(192, 2)).astype(np.int64)
    train_pairs, val_pairs = pairs[:128], pairs[128:]

    j_model = JTwoTowerModel(j_schema, j_mcfg)
    example = assemble_pair_batch(*j_stores, train_pairs[:BATCH])
    init, _ = create_train_state(j_model, j_cfg, jax.random.PRNGKey(j_cfg.seed), example, 8)
    t_model = TTwoTowerModel(t_schema, t_mcfg)
    start = {k: v.numpy() for k, v in flax_to_state_dict(t_model, jax.device_get(init.params),
                                                          jax.device_get(init.batch_stats)).items()}
    mesh = j_make_mesh(jax.devices()[:2])
    want = JTrainer(j_cfg, j_schema, *j_stores, mesh=mesh, log_fn=lambda *_: None).train(
        train_pairs, val_pairs, corpus_eval=False, n_inner=N_INNER)
    bad = t_cfg.replace(data=dataclasses.replace(t_cfg.data, batch_size=33))
    tmp = tmp_path_factory.mktemp("mesh_trainer")
    save_pairs_parquet(tmp / "pairs.parquet", keys[train_pairs[:, 0]], keys[train_pairs[:, 1]])
    got = spawn(workers.trainer_runs, t_schema, t_cfg, stores, start, train_pairs, val_pairs, N_INNER, str(tmp),
                bad, str(tmp / "pairs.parquet"))
    j_bad = dataclasses.replace(j_cfg, data=JDataConfig(batch_size=33))
    return dict(want=want, got=got, j_bad=(j_bad, j_schema, j_stores, mesh, train_pairs, val_pairs))


def test_mesh_trainer_matches_the_reference_mesh_trainer(trainer_runs):
    want = trainer_runs["want"]
    for rank in trainer_runs["got"]:
        assert len(rank["history"]) == len(want.history) == 2
        for g, w in zip(rank["history"], want.history):
            assert set(g) == set(w) and g["epoch"] == w["epoch"]
            for k in ("train_loss", "val_loss"):
                assert abs(g[k] - w[k]) <= 1e-4 * abs(w[k]), (k, g[k], w[k])
        assert abs(rank["final_val"]["loss"] - want.final_val["loss"]) <= 1e-4 * abs(want.final_val["loss"])
        assert rank["step"] == int(want.state.step) == 8
        recall, mrr = rank["corpus"]
        assert set(recall) == {10, 100} and 0.0 <= mrr <= 1.0
    a, b = (r["state"] for r in trainer_runs["got"])
    assert all(np.array_equal(a[k], b[k]) for k in a)
    h0, h1 = ([{k: v for k, v in e.items() if k != "examples_per_sec"} for e in r["history"]]
              for r in trainer_runs["got"])
    assert h0 == h1  # every metric but each rank's own clock


def test_mesh_resume_is_bit_equal_to_a_straight_run(trainer_runs):
    for rank in trainer_runs["got"]:
        res = rank["resume"]
        assert res["saved_at"] == [2, 4] and res["step"] == 8
        for k, v in res["straight"].items():
            assert np.array_equal(res["resumed"][k], v), k
        assert {"config.json", "step.json", "step_a", "step_b", "epoch_0", "epoch_1", "final", "weights"} \
            <= set(res["files"])


def test_mesh_streaming_trainer_splits_each_chunk_by_rank(trainer_runs):
    """``train_streaming`` on the mesh: rank r streams the rows r::2 of each
    chunk (``host_index`` r of 2) and trains 16 of the global 32 per step;
    both ranks run the epoch's 4 steps, their states stay equal and the
    losses are finite."""
    a, b = (r["streamed"] for r in trainer_runs["got"])
    assert a["step"] == b["step"] == 8
    assert all(np.array_equal(a["state"][k], b["state"][k]) for k in a["state"])
    assert all(np.isfinite([e["train_loss"], e["val_loss"]]).all() for e in a["history"])


def test_mesh_batch_divisibility_guard(trainer_runs):
    for rank in trainer_runs["got"]:
        assert rank["guard"] is not None and "divide" in rank["guard"]
    j_bad, j_schema, j_stores, mesh, train_pairs, val_pairs = trainer_runs["j_bad"]
    with pytest.raises(ValueError, match="divide"):
        JTrainer(j_bad, j_schema, *j_stores, mesh=mesh, log_fn=lambda *_: None).train(
            train_pairs, val_pairs, corpus_eval=False)
