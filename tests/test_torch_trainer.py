"""The port's ``Trainer`` against the JAX package's, on the CPU.

Parity: both trainers run the host-fed indexed path (``n_inner``-step calls
plus single steps for each epoch's remainder, over the same
``epoch_batches``) for 2 epochs on the same stores and pairs, from one flax
``model.init`` (the JAX trainer's own init, converted by
``convert.flax_to_state_dict`` and put in place of the port's
``init_flax``), dropout 0, float32 compute and the materialized loss on both
sides. The per-epoch train and validation losses must agree within 1e-4
relative, the history rows must carry the same keys, and each parameter's
change over the run must match the reference's by relative norm within
0.15, the bound of tests/test_torch_train_step.py's float32 k=3 test.

Then: sampled runs (dense and sparse tables) learn; the results CSV has the
reference's header; the final corpus eval reuses the last epoch's result
instead of encoding the corpus again; sparse tables on a mesh and the
compressed gradient sync raise (ROADMAP A12b; the mesh trainer runs in
tests/test_torch_mesh_train.py) (``train_streaming`` runs in tests/test_torch_streaming_trainer.py);
and the default device is the card, never the CPU.
"""

import csv
import dataclasses

import jax
import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.config import CheckpointConfig as TCheckpointConfig
from jodalrob_twotower_torch.config import DataConfig as TDataConfig
from jodalrob_twotower_torch.config import LossConfig as TLossConfig
from jodalrob_twotower_torch.config import MeshConfig as TMeshConfig
from jodalrob_twotower_torch.config import ModelConfig as TModelConfig
from jodalrob_twotower_torch.config import OptimizerConfig as TOptimizerConfig
from jodalrob_twotower_torch.config import TrainConfig as TTrainConfig
from jodalrob_twotower_torch.convert import flax_to_state_dict, state_dict_to_flax
from jodalrob_twotower_torch.data.feature_store import FeatureStore as TFeatureStore
from jodalrob_twotower_torch.data.synthetic import make_synthetic_dataset
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel as TTwoTowerModel
from jodalrob_twotower_torch.parallel.mesh import make_mesh
from jodalrob_twotower_torch.train import trainer as ttrainer
from jodalrob_twotower_tpu.config import DataConfig as JDataConfig
from jodalrob_twotower_tpu.config import LossConfig as JLossConfig
from jodalrob_twotower_tpu.config import OptimizerConfig as JOptimizerConfig
from jodalrob_twotower_tpu.config import TrainConfig as JTrainConfig
from jodalrob_twotower_tpu.data.feature_store import FeatureStore as JFeatureStore
from jodalrob_twotower_tpu.data.pipeline import assemble_pair_batch
from jodalrob_twotower_tpu.models.two_tower import TwoTowerModel as JTwoTowerModel
from jodalrob_twotower_tpu.train import ledger as jledger
from jodalrob_twotower_tpu.train.train_step import create_train_state
from jodalrob_twotower_tpu.train.trainer import Trainer as JTrainer

from torch_parity import model_configs, schemas, side_inputs

N_ROWS = 300
BATCH = 32
N_INNER = 3  # 4 steps an epoch: one 3-step call and one single step
LOSS_RTOL = 1e-4
CHANGE_TOL = 0.15


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU steps run fastest on one thread, and several test workers
    sharing the cores do not oversubscribe them. Module scope, so that the
    module-scoped runs below take it too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": np.asarray(v)})
    return out


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer_parity")
    j_schema, t_schema = schemas()
    j_mcfg, t_mcfg = model_configs(compute_dtype="float32", embedding_lookup="auto", dropout_rate=0.0)
    common = dict(temperature=0.2, use_fused_logits=False)
    j_cfg = JTrainConfig(model=j_mcfg, loss=JLossConfig(**common),
                         optimizer=JOptimizerConfig(learning_rate=1e-3, num_epochs=2),
                         data=JDataConfig(batch_size=BATCH), results_csv=str(tmp / "jax.csv"), seed=5)
    t_cfg = TTrainConfig(model=t_mcfg, loss=TLossConfig(**common),
                         optimizer=TOptimizerConfig(learning_rate=1e-3, num_epochs=2),
                         data=TDataConfig(batch_size=BATCH), results_csv=str(tmp / "torch.csv"), seed=5)
    rng = np.random.default_rng(17)
    stores = {side: side_inputs(j_schema.side(side), rng, N_ROWS) for side in ("notice", "company")}
    keys = np.arange(N_ROWS).astype(str)
    j_stores = [JFeatureStore(j_schema.side(s), *stores[s], keys) for s in ("notice", "company")]
    t_stores = [TFeatureStore(t_schema.side(s), *stores[s], keys) for s in ("notice", "company")]
    pairs = rng.integers(0, N_ROWS, size=(192, 2)).astype(np.int64)
    train_pairs, val_pairs = pairs[:128], pairs[128:]

    # the JAX trainer's own init: create_train_state from PRNGKey(cfg.seed)
    j_model = JTwoTowerModel(j_schema, j_mcfg)
    example = assemble_pair_batch(*j_stores, train_pairs[:BATCH])
    init, _ = create_train_state(j_model, j_cfg, jax.random.PRNGKey(j_cfg.seed), example, 8)
    params0, stats0 = jax.device_get(init.params), jax.device_get(init.batch_stats)

    want = JTrainer(j_cfg, j_schema, *j_stores, log_fn=lambda *_: None).train(
        train_pairs, val_pairs, corpus_eval=False, n_inner=N_INNER)

    start = flax_to_state_dict(TTwoTowerModel(t_schema, t_mcfg), params0, stats0)

    def init_from_flax(self, generator):
        self.load_state_dict(start)
        return self

    mp = pytest.MonkeyPatch()
    mp.setattr(TTwoTowerModel, "init_flax", init_from_flax)
    try:
        trainer = ttrainer.Trainer(t_cfg, t_schema, *t_stores, device="cpu", log_fn=lambda *_: None)
        got = trainer.train(train_pairs, val_pairs, corpus_eval=False, n_inner=N_INNER)
    finally:
        mp.undo()
    return dict(want=want, got=got, params0=params0, trainer=trainer, tmp=tmp)


def test_per_epoch_losses_match_the_reference(parity):
    want, got = parity["want"], parity["got"]
    assert len(got.history) == len(want.history) == 2
    for g, w in zip(got.history, want.history):
        assert set(g) == set(w)
        assert g["epoch"] == w["epoch"]
        for k in ("train_loss", "val_loss"):
            assert abs(g[k] - w[k]) <= LOSS_RTOL * abs(w[k]), (k, g[k], w[k])
    assert abs(got.final_val["loss"] - want.final_val["loss"]) <= LOSS_RTOL * abs(want.final_val["loss"])
    assert got.num_params == want.num_params
    assert got.state.step == int(want.state.step) == 8


def test_each_leaf_moves_like_the_reference(parity):
    want, got = parity["want"], parity["got"]
    params, _ = state_dict_to_flax(parity["trainer"].model, got.state.state_dict)
    g, w, s = _leaves(params), _leaves(jax.device_get(want.state.params)), _leaves(parity["params0"])
    assert set(g) == set(w)
    for k in w:
        assert _rel(g[k] - s[k], w[k] - s[k]) <= CHANGE_TOL, (k, _rel(g[k] - s[k], w[k] - s[k]))


def test_results_csv_has_the_reference_header(parity):
    tmp = parity["tmp"]
    with (tmp / "torch.csv").open(newline="") as fh:
        got = list(csv.reader(fh))
    with (tmp / "jax.csv").open(newline="") as fh:
        want = list(csv.reader(fh))
    assert got[0] == want[0] == jledger.FIELDS
    assert len(got) == len(want) == 2
    row = dict(zip(got[0], got[1]))
    assert row["epochs"] == "2" and row["batch_size"] == str(BATCH)
    assert row["corpus_recall_at_100"] == ""  # corpus_eval off


def _small_cfg(**kw):
    return TTrainConfig(
        model=TModelConfig(categorical_embedding_dim=8, dense_projection_dim=32, tower_hidden_dims=(64, 32),
                           final_embedding_dim=32, compute_dtype="float32"),
        loss=TLossConfig(temperature=0.1),
        optimizer=TOptimizerConfig(learning_rate=3e-3, num_epochs=3),
        data=TDataConfig(batch_size=128, sample_on_device=True),
        checkpoint=TCheckpointConfig(),
        results_csv="",
        **kw,
    )


@pytest.fixture(scope="module")
def small_dataset():
    return make_synthetic_dataset(n_notices=1000, n_companies=1000, n_pairs=4000, n_clusters=16, seed=2)


@pytest.mark.parametrize("kw", [{}, {"sparse_tables": True}, {"sparse_tables": True, "sparse_defer_updates": True}],
                         ids=["dense", "sparse", "sparse_deferred"])
def test_sampled_runs_learn(small_dataset, kw):
    ds = small_dataset
    cfg = _small_cfg(**kw)
    train_pairs, val_pairs = ds.split(0.2)
    res = ttrainer.Trainer(cfg, ds.schema, ds.notice_store, ds.company_store, device="cpu",
                           log_fn=lambda *_: None).train(train_pairs, val_pairs, n_inner=4)
    losses = [h["train_loss"] for h in res.history]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert res.state.step == cfg.optimizer.num_epochs * (len(train_pairs) // cfg.data.batch_size)
    # 10x random recall@100 over the 1,000-company corpus
    assert res.corpus.recall[100] >= 10 * 100 / len(ds.company_store), res.corpus.recall


@pytest.mark.parametrize("epoch_corpus_eval", [True, False])
def test_final_corpus_eval_reuses_the_last_epoch(small_dataset, monkeypatch, epoch_corpus_eval):
    ds = small_dataset
    cfg = dataclasses.replace(_small_cfg(), optimizer=TOptimizerConfig(num_epochs=2))
    calls = []
    orig = ttrainer.Trainer.corpus_eval

    def counted(self, state, val_pairs, ks=(10, 100)):
        calls.append(orig(self, state, val_pairs, ks))
        return calls[-1]

    monkeypatch.setattr(ttrainer.Trainer, "corpus_eval", counted)
    train_pairs, val_pairs = ds.split(0.2)
    res = ttrainer.Trainer(cfg, ds.schema, ds.notice_store, ds.company_store, device="cpu",
                           log_fn=lambda *_: None).train(train_pairs, val_pairs, epoch_corpus_eval=epoch_corpus_eval)
    assert len(calls) == (2 if epoch_corpus_eval else 1)
    assert res.corpus is calls[-1]
    if epoch_corpus_eval:
        assert res.history[-1]["corpus_recall@100"] == res.corpus.recall[100]


def test_unported_modes_raise(small_dataset):
    """Sparse tables on a mesh train (A12b item 3; a mesh of one rank
    trains as one device does, bit for bit); the compressed sync off a
    mesh is ignored, as the reference's trainer ignores it: one device's
    run (the compressed mesh: tests/test_torch_compressed.py)."""
    ds = small_dataset
    args = (ds.schema, ds.notice_store, ds.company_store)
    cfg = _small_cfg().replace(sparse_tables=True)
    quiet = dict(log_fn=lambda *_: None)
    on_mesh = ttrainer.Trainer(cfg, *args, mesh=make_mesh(["cpu"]), **quiet).train(
        ds.pairs[:512], ds.pairs[512:640], corpus_eval=False)
    alone = ttrainer.Trainer(cfg, *args, device="cpu", **quiet).train(ds.pairs[:512], ds.pairs[512:640],
                                                                     corpus_eval=False)
    assert [h["train_loss"] for h in on_mesh.history] == [h["train_loss"] for h in alone.history]
    cfg = _small_cfg().replace(mesh=TMeshConfig(grad_compression="int16"), sparse_tables=True)
    compressed = ttrainer.Trainer(cfg, *args, device="cpu", **quiet).train(ds.pairs[:512], ds.pairs[512:640],
                                                                          corpus_eval=False)
    assert [h["train_loss"] for h in compressed.history] == [h["train_loss"] for h in alone.history]


def test_default_device_is_the_card(small_dataset, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = small_dataset
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.Trainer(_small_cfg(), ds.schema, ds.notice_store, ds.company_store)
