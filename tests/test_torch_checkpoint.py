"""Checkpoints and exact resume of the port (port of tests/test_step_resume.py,
``:59``, ``:113``, ``:133``), on the CPU.

* k steps, ``save_step``, a restore into a freshly built state and k more
  steps equal 2k uninterrupted steps bit for bit: every parameter, moment,
  accumulator, table and BatchNorm statistic, the step and the optimizer
  count; dense and sparse (per step and deferred), with dropout on and the
  batches sampled on the device (both keyed by the global step);
* a trainer run killed right after its second mid-epoch save and resumed
  ends bit for bit where an uninterrupted run ends (host-fed and sampled);
* a completed epoch outranks a step checkpoint;
* ``keep_n`` pruning, ``best.json``, an interrupted save ignored, and
  ``restore_weights`` (the serving entry point) with its shape check.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.config import (
    CheckpointConfig,
    DataConfig,
    LossConfig,
    ModelConfig,
    OptimizerConfig,
    TrainConfig,
)
from jodalrob_twotower_torch.data.synthetic import make_synthetic_dataset
from jodalrob_twotower_torch.models import build_model
from jodalrob_twotower_torch.train import sparse_tables
from jodalrob_twotower_torch.train.checkpoint import CheckpointManager, state_payload
from jodalrob_twotower_torch.train.train_step import create_train_state, device_store, make_sampled_train_steps
from jodalrob_twotower_torch.train.trainer import Trainer

MODES = {  # name: (sparse_tables, sparse_defer_updates)
    "dense": (False, False),
    "sparse": (True, False),
    "sparse_deferred": (True, True),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU steps run fastest on one thread, and several test workers
    sharing the cores do not oversubscribe them. Module scope, so that the
    module-scoped runs below take it too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(mode="dense", sampled=False, **ckpt_kw):
    sparse, deferred = MODES[mode]
    return TrainConfig(
        model=ModelConfig(
            categorical_embedding_dim=8,
            dense_projection_dim=16,
            tower_hidden_dims=(32, 16),
            final_embedding_dim=8,
            dropout_rate=0.1,  # exercises the per-step dropout generator
            compute_dtype="float32",
        ),
        loss=LossConfig(temperature=0.2),
        optimizer=OptimizerConfig(num_epochs=2),
        data=DataConfig(batch_size=64, test_split=0.2, sample_on_device=sampled),
        checkpoint=CheckpointConfig(**ckpt_kw),
        results_csv="",
        sparse_tables=sparse,
        sparse_defer_updates=deferred,
    )


@pytest.fixture(scope="module")
def dataset():
    return make_synthetic_dataset(n_notices=400, n_companies=400, n_pairs=800, n_clusters=8, seed=3)


def _split(ds, cfg):
    perm = np.random.default_rng(cfg.data.shuffle_seed).permutation(len(ds.pairs))
    n_test = int(round(len(ds.pairs) * cfg.data.test_split))
    return ds.pairs[perm[n_test:]], ds.pairs[perm[:n_test]]


def _flat(payload, prefix=""):
    out = {}
    for k, v in payload.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def assert_states_equal(a, b):
    fa, fb = _flat(state_payload(a)), _flat(state_payload(b))
    assert set(fa) == set(fb)
    for k, v in fa.items():
        if isinstance(v, torch.Tensor):
            assert v.dtype == fb[k].dtype and torch.equal(v, fb[k]), k
        else:
            assert v == fb[k], k


def _fresh(mode, cfg, ds, seed):
    model = build_model(ds.schema, cfg).init_flax(torch.Generator().manual_seed(seed))
    if MODES[mode][0]:
        state, tx = sparse_tables.create_sparse_train_state(model, cfg, cfg.seed, 100, device="cpu")
        make = sparse_tables.make_sampled_deferred_sparse_steps if MODES[mode][1] else \
            sparse_tables.make_sampled_sparse_steps
        steps = make(model, cfg, tx, 100, 2, cfg.data.batch_size)
    else:
        state, tx = create_train_state(model, cfg, cfg.seed, 100, device="cpu")
        steps = make_sampled_train_steps(model, cfg, tx, 2, cfg.data.batch_size)
    return state, steps


@pytest.mark.parametrize("mode", list(MODES))
def test_k_steps_save_restore_k_steps_equal_2k_steps(dataset, tmp_path, mode):
    cfg = _cfg(mode)
    stores = [device_store(fs, device="cpu") for fs in (dataset.notice_store, dataset.company_store)]
    pairs = torch.from_numpy(dataset.pairs.astype(np.int64))

    def run(state, steps, calls):
        for _ in range(calls):
            state, _ = steps(state, 11, pairs, *stores)
        return state

    straight = run(*_fresh(mode, cfg, dataset, 0), calls=4)
    first, steps = _fresh(mode, cfg, dataset, 0)
    first = run(first, steps, calls=2)
    ckpt = CheckpointManager(tmp_path)
    ckpt.save_step(first, epoch=0, batch_in_epoch=4)
    # the target is built from other weights: everything must come from the file
    target, steps = _fresh(mode, cfg, dataset, 1)
    restored, epoch, step, batch = ckpt.restore_step(target)
    assert (epoch, step, batch) == (0, 4, 4) and restored.step == 4 and type(restored) is type(first)
    assert_states_equal(restored, first)
    resumed = run(restored, steps, calls=2)
    assert resumed.step == straight.step == 8
    assert_states_equal(resumed, straight)


@pytest.mark.parametrize("mode,sampled", [("dense", False), ("dense", True), ("sparse", False),
                                          ("sparse_deferred", False), ("sparse_deferred", True)])
def test_preempted_run_resumes_bit_identical(dataset, tmp_path, monkeypatch, mode, sampled):
    cfg = _cfg(mode, sampled, save_every_steps=2)
    train_pairs, val_pairs = _split(dataset, cfg)

    def trainer(log=lambda *_: None):
        return Trainer(cfg, dataset.schema, dataset.notice_store, dataset.company_store, device="cpu", log_fn=log)

    base = trainer().train(train_pairs, val_pairs, checkpoint_dir=tmp_path / "base", corpus_eval=False, n_inner=2)

    d = tmp_path / "preempted"
    orig_save = CheckpointManager.save_step
    calls = {"n": 0}

    def dying_save(self, state, epoch, batch_in_epoch):
        orig_save(self, state, epoch, batch_in_epoch)
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt("simulated preemption")

    monkeypatch.setattr(CheckpointManager, "save_step", dying_save)
    with pytest.raises(KeyboardInterrupt):
        trainer().train(train_pairs, val_pairs, checkpoint_dir=d, corpus_eval=False, n_inner=2)
    monkeypatch.setattr(CheckpointManager, "save_step", orig_save)

    meta = json.loads((d / "step.json").read_text())
    assert meta == {"dir": "step_b", "epoch": 0, "step": 4, "batch": 4}
    # an interrupted epoch save leaves a directory without its state file
    (d / "epoch_1").mkdir()
    (d / "epoch_1" / "state.pt.tmp").write_bytes(b"partial")

    logs: list[str] = []
    res = trainer(logs.append).train(train_pairs, val_pairs, checkpoint_dir=d, resume=True, corpus_eval=False,
                                     n_inner=2)
    assert any("resumed mid-epoch 0 at step 4" in line for line in logs), logs[:5]
    steps_per_epoch = len(train_pairs) // cfg.data.batch_size
    assert res.state.step == base.state.step == steps_per_epoch * cfg.optimizer.num_epochs
    assert_states_equal(res.state, base.state)
    assert res.final_val == base.final_val


def test_completed_epoch_outranks_step_checkpoint(dataset, tmp_path):
    cfg = _cfg(save_every_steps=3)
    train_pairs, val_pairs = _split(dataset, cfg)
    d = tmp_path / "run"
    first = Trainer(cfg, dataset.schema, dataset.notice_store, dataset.company_store, device="cpu",
                    log_fn=lambda *_: None).train(train_pairs, val_pairs, checkpoint_dir=d, corpus_eval=False,
                                                  n_inner=2)
    # the run completed: its last step.json is from the final epoch, which
    # also has an epoch checkpoint -> resume takes the epoch and trains nothing
    assert json.loads((d / "step.json").read_text())["epoch"] == 1
    logs: list[str] = []
    res = Trainer(cfg, dataset.schema, dataset.notice_store, dataset.company_store, device="cpu",
                  log_fn=logs.append).train(train_pairs, val_pairs, checkpoint_dir=d, resume=True,
                                            corpus_eval=False, n_inner=2)
    assert any("resumed from epoch 1" in line for line in logs)
    steps_per_epoch = len(train_pairs) // cfg.data.batch_size
    assert res.state.step == steps_per_epoch * cfg.optimizer.num_epochs
    assert res.history == []
    assert_states_equal(res.state, first.state)


def test_keep_n_best_and_restore_weights(dataset, tmp_path):
    cfg = _cfg("sparse", keep_n=2)
    state, _ = _fresh("sparse", cfg, dataset, 0)
    ckpt = CheckpointManager(tmp_path, cfg.checkpoint)
    for epoch, metric in enumerate([3.0, 2.0, 2.5, 1.5]):
        state.step = epoch
        ckpt.save_epoch(state, epoch, metric=metric)
    assert [p.name for p in sorted(tmp_path.glob("epoch_*"))] == ["epoch_2", "epoch_3"]
    assert ckpt.latest_epoch() == 3
    assert json.loads((tmp_path / "best.json").read_text()) == {"epoch": 3, "metric": 1.5}
    # a new manager over the same directory keeps the best metric
    again = CheckpointManager(tmp_path, cfg.checkpoint)
    state.step = 9
    again.save_epoch(state, 4, metric=1.7)
    assert json.loads((tmp_path / "best.json").read_text())["epoch"] == 3
    assert ckpt.restore("best", state).step == 3
    restored, epoch = ckpt.restore_latest(state)
    assert epoch == 4 and restored.step == 9

    ckpt.finalize(state)
    assert all((tmp_path / d / "state.pt").exists() for d in ("best", "final", "weights", "epoch_3", "epoch_4"))
    model = build_model(dataset.schema, cfg)
    weights = ckpt.restore_weights(model.state_dict(), device="cpu")
    merged = sparse_tables.merged_params(state)
    assert set(weights["params"]) == set(merged) and set(weights["batch_stats"]) == set(state.batch_stats)
    for k, v in merged.items():
        assert torch.equal(weights["params"][k], v), k
    model.load_state_dict({**weights["params"], **weights["batch_stats"]})

    other = build_model(dataset.schema, dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, final_embedding_dim=16)))
    with pytest.raises(ValueError, match="does not fit"):
        ckpt.restore_weights(other.state_dict(), device="cpu")
    dense_state, _ = _fresh("dense", _cfg("dense"), dataset, 0)
    with pytest.raises(ValueError, match="cannot restore"):
        ckpt.restore("best", dense_state)
