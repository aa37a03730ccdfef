"""The port's ``Trainer.train_streaming`` against the JAX package's, on the
CPU.

Parity: both trainers start from one flax ``model.init`` (the JAX trainer's
own init, converted and put in place of the port's ``init_flax``), dropout
0, float32 compute and the materialized loss (as tests/test_torch_trainer.py
sets them up), and stream the same two parquet pair files, in chunks of 50
rows joined to the stores' keys, for 2 epochs of 4 host-fed steps (one
3-step call and a single step). The per-epoch train and validation losses
must agree within 1e-4 relative, and both must run the same steps.

Then: a streaming run with mid-epoch checkpoints, stopped right after its
first one and resumed, ends bit for bit where an uninterrupted streaming run
ends (dropout on, keyed by the global step); and a device-sampled config
with a batch source raises ``ValueError`` in both packages."""

import json

import jax
import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.config import CheckpointConfig as TCheckpointConfig
from jodalrob_twotower_torch.config import DataConfig as TDataConfig
from jodalrob_twotower_torch.config import LossConfig as TLossConfig
from jodalrob_twotower_torch.config import OptimizerConfig as TOptimizerConfig
from jodalrob_twotower_torch.config import TrainConfig as TTrainConfig
from jodalrob_twotower_torch.convert import flax_to_state_dict
from jodalrob_twotower_torch.data.feature_store import FeatureStore as TFeatureStore
from jodalrob_twotower_torch.data.parquet_dataset import save_pairs_parquet
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel as TTwoTowerModel
from jodalrob_twotower_torch.train import trainer as ttrainer
from jodalrob_twotower_torch.train.checkpoint import CheckpointManager, state_payload
from jodalrob_twotower_tpu.config import DataConfig as JDataConfig
from jodalrob_twotower_tpu.config import LossConfig as JLossConfig
from jodalrob_twotower_tpu.config import OptimizerConfig as JOptimizerConfig
from jodalrob_twotower_tpu.config import TrainConfig as JTrainConfig
from jodalrob_twotower_tpu.data.feature_store import FeatureStore as JFeatureStore
from jodalrob_twotower_tpu.data.pipeline import assemble_pair_batch
from jodalrob_twotower_tpu.models.two_tower import TwoTowerModel as JTwoTowerModel
from jodalrob_twotower_tpu.train.train_step import create_train_state
from jodalrob_twotower_tpu.train.trainer import Trainer as JTrainer

from torch_parity import model_configs, schemas, side_inputs

N_ROWS = 300
BATCH = 32
N_INNER = 3
CHUNK_ROWS = 50  # chunks of 50, 20, 50, 8 rows: 4 batches an epoch, carried across chunks
STEPS_PER_EPOCH = 4
LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU steps run fastest on one thread, and several test workers
    sharing the cores do not oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("streaming")
    j_schema, t_schema = schemas()
    rng = np.random.default_rng(29)
    stores = {side: side_inputs(j_schema.side(side), rng, N_ROWS) for side in ("notice", "company")}
    keys = np.asarray([f"k{i}" for i in range(N_ROWS)])
    j_stores = [JFeatureStore(j_schema.side(s), *stores[s], keys) for s in ("notice", "company")]
    t_stores = [TFeatureStore(t_schema.side(s), *stores[s], keys) for s in ("notice", "company")]
    pairs = rng.integers(0, N_ROWS, size=(192, 2)).astype(np.int64)
    train_pairs, val_pairs = pairs[:128], pairs[128:]
    files = [tmp / "pairs_0.parquet", tmp / "pairs_1.parquet"]
    for path, part in zip(files, (train_pairs[:70], train_pairs[70:])):
        save_pairs_parquet(path, keys[part[:, 0]], keys[part[:, 1]])
    return dict(tmp=tmp, schemas=(j_schema, t_schema), j_stores=j_stores, t_stores=t_stores,
                train_pairs=train_pairs, val_pairs=val_pairs, files=files)


@pytest.fixture(scope="module")
def parity(setup):
    j_schema, t_schema = setup["schemas"]
    j_mcfg, t_mcfg = model_configs(compute_dtype="float32", embedding_lookup="auto", dropout_rate=0.0)
    common = dict(temperature=0.2, use_fused_logits=False)
    j_cfg = JTrainConfig(model=j_mcfg, loss=JLossConfig(**common),
                         optimizer=JOptimizerConfig(learning_rate=1e-3, num_epochs=2),
                         data=JDataConfig(batch_size=BATCH), results_csv="", seed=5)
    t_cfg = TTrainConfig(model=t_mcfg, loss=TLossConfig(**common),
                         optimizer=TOptimizerConfig(learning_rate=1e-3, num_epochs=2),
                         data=TDataConfig(batch_size=BATCH), results_csv="", seed=5)
    kw = dict(steps_per_epoch=STEPS_PER_EPOCH, chunk_rows=CHUNK_ROWS, corpus_eval=False, n_inner=N_INNER)

    j_model = JTwoTowerModel(j_schema, j_mcfg)
    example = assemble_pair_batch(*setup["j_stores"], setup["train_pairs"][:BATCH])
    init, _ = create_train_state(j_model, j_cfg, jax.random.PRNGKey(j_cfg.seed), example, 8)
    params0, stats0 = jax.device_get(init.params), jax.device_get(init.batch_stats)
    want = JTrainer(j_cfg, j_schema, *setup["j_stores"], log_fn=lambda *_: None).train_streaming(
        setup["files"], setup["val_pairs"], **kw)

    start = flax_to_state_dict(TTwoTowerModel(t_schema, t_mcfg), params0, stats0)

    def init_from_flax(self, generator):
        self.load_state_dict(start)
        return self

    mp = pytest.MonkeyPatch()
    mp.setattr(TTwoTowerModel, "init_flax", init_from_flax)
    try:
        got = ttrainer.Trainer(t_cfg, t_schema, *setup["t_stores"], device="cpu",
                               log_fn=lambda *_: None).train_streaming(setup["files"], setup["val_pairs"], **kw)
    finally:
        mp.undo()
    return dict(want=want, got=got)


def test_streaming_per_epoch_losses_match_the_reference(parity):
    want, got = parity["want"], parity["got"]
    assert len(got.history) == len(want.history) == 2
    for g, w in zip(got.history, want.history):
        assert set(g) == set(w) and g["epoch"] == w["epoch"]
        for k in ("train_loss", "val_loss"):
            assert abs(g[k] - w[k]) <= LOSS_RTOL * abs(w[k]), (k, g[k], w[k])
    assert abs(got.final_val["loss"] - want.final_val["loss"]) <= LOSS_RTOL * abs(want.final_val["loss"])
    assert got.state.step == int(want.state.step) == 2 * STEPS_PER_EPOCH


def _flat(payload, prefix=""):
    out = {}
    for k, v in payload.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def test_streaming_resume_mid_epoch_is_bit_identical(setup, tmp_path, monkeypatch):
    _, t_schema = setup["schemas"]
    _, t_mcfg = model_configs(compute_dtype="float32", dropout_rate=0.1)  # dropout keyed by the global step
    cfg = TTrainConfig(model=t_mcfg, loss=TLossConfig(temperature=0.2),
                       optimizer=TOptimizerConfig(learning_rate=1e-3, num_epochs=2),
                       data=TDataConfig(batch_size=BATCH), checkpoint=TCheckpointConfig(save_every_steps=2),
                       results_csv="", seed=3)
    kw = dict(steps_per_epoch=STEPS_PER_EPOCH, chunk_rows=CHUNK_ROWS, corpus_eval=False, n_inner=2)

    def run(directory, **extra):
        trainer = ttrainer.Trainer(cfg, t_schema, *setup["t_stores"], device="cpu", log_fn=logs.append)
        return trainer.train_streaming(setup["files"], setup["val_pairs"], checkpoint_dir=directory, **kw, **extra)

    logs: list[str] = []
    base = run(tmp_path / "base")

    orig_save = CheckpointManager.save_step
    calls = {"n": 0}

    def dying_save(self, state, epoch, batch_in_epoch):
        orig_save(self, state, epoch, batch_in_epoch)
        calls["n"] += 1
        if calls["n"] == 3:  # epoch 1, after its second batch
            raise KeyboardInterrupt("simulated preemption")

    monkeypatch.setattr(CheckpointManager, "save_step", dying_save)
    with pytest.raises(KeyboardInterrupt):
        run(tmp_path / "preempted")
    monkeypatch.setattr(CheckpointManager, "save_step", orig_save)
    meta = json.loads((tmp_path / "preempted" / "step.json").read_text())
    assert (meta["epoch"], meta["step"], meta["batch"]) == (1, 6, 2)

    logs.clear()
    res = run(tmp_path / "preempted", resume=True)
    assert any("resumed mid-epoch 1 at step 6 (skipping 2" in line for line in logs), logs[:5]
    assert res.state.step == base.state.step == 2 * STEPS_PER_EPOCH
    fa, fb = _flat(state_payload(res.state)), _flat(state_payload(base.state))
    assert set(fa) == set(fb)
    for k, v in fa.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == fb[k].dtype and torch.equal(v, fb[k]), k
        else:
            assert v == fb[k], k
    assert res.final_val == base.final_val


def test_sampling_on_the_device_refuses_a_batch_source(setup):
    j_schema, t_schema = setup["schemas"]
    j_mcfg, t_mcfg = model_configs()
    pairs = setup["train_pairs"]

    def source(epoch):
        return iter([pairs[:BATCH]])

    j_cfg = JTrainConfig(model=j_mcfg, data=JDataConfig(batch_size=BATCH, sample_on_device=True), results_csv="")
    t_cfg = TTrainConfig(model=t_mcfg, data=TDataConfig(batch_size=BATCH, sample_on_device=True), results_csv="")
    with pytest.raises(ValueError, match="sample_on_device"):
        JTrainer(j_cfg, j_schema, *setup["j_stores"], log_fn=lambda *_: None).train(
            np.empty((0, 2), np.int64), setup["val_pairs"], batch_source=source, steps_per_epoch=1)
    with pytest.raises(ValueError, match="sample_on_device"):
        ttrainer.Trainer(t_cfg, t_schema, *setup["t_stores"], device="cpu", log_fn=lambda *_: None).train(
            np.empty((0, 2), np.int64), setup["val_pairs"], batch_source=source, steps_per_epoch=1)
