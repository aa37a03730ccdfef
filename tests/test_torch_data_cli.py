"""The port's CLIs on a parquet dataset directory, in-process on the CPU: a
tiny dataset written with ``save_dataset``; ``python -m
jodalrob_twotower_torch.train --force-cpu --data-dir D`` and the same with
``--stream`` (pairs.parquet streamed through ``Trainer.train_streaming``);
then the port's eval CLI and the JAX package's (``scripts/eval.py``, called
in-process) on ``--data-dir D`` and the run's weights (exported in the
reference's weights-only format): the same report keys, the same validation
split, and metrics within bf16 resolution of each other (both run the
default bf16 towers, rounded at other places)."""

import csv
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jodalrob_twotower_torch import eval as teval
from jodalrob_twotower_torch import train as ttrain
from jodalrob_twotower_torch.config import TrainConfig
from jodalrob_twotower_torch.convert import state_dict_to_flax
from jodalrob_twotower_torch.data.parquet_dataset import load_dataset, save_dataset
from jodalrob_twotower_torch.data.synthetic import make_synthetic_dataset
from jodalrob_twotower_torch.models import build_model
from jodalrob_twotower_torch.schema import tiny_synthetic_schema
from jodalrob_twotower_torch.train.checkpoint import CheckpointManager
from jodalrob_twotower_torch.train.cli import split_pairs

REPO = Path(__file__).resolve().parent.parent
N_PAIRS = 2400
BATCH = 128
METRIC_ATOL = 0.02  # bf16 towers on both sides, as tests/test_torch_cli.py


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU steps run fastest on one thread, and several test workers
    sharing the cores do not oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_eval_main(argv):
    spec = importlib.util.spec_from_file_location("jax_eval_cli", REPO / "scripts" / "eval.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main(argv)


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_keys(v) for v in tree]
    return None


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data_cli") / "ds"
    ds = make_synthetic_dataset(tiny_synthetic_schema(n_categorical=4, vocab_size=64, n_numeric=8),
                                n_notices=600, n_companies=600, n_pairs=N_PAIRS, n_clusters=8, seed=4)
    save_dataset(d, ds.schema, ds.notice_store, ds.company_store, ds.pairs)
    return d


def _train(dataset_dir, out, *extra):
    argv = ["--force-cpu", "--data-dir", str(dataset_dir), "--epochs", "2", "--batch-size", str(BATCH),
            "--output-dir", str(out), "--results-csv", str(out / "results.csv"), *extra]
    assert ttrain.main(argv) == 0
    with (out / "results.csv").open(newline="") as fh:
        return list(csv.DictReader(fh))[-1]


@pytest.fixture(scope="module")
def run(dataset_dir):
    out = dataset_dir.parent / "run"
    out.mkdir()
    return SimpleNamespace(out=out, row=_train(dataset_dir, out))


def test_train_on_a_data_dir(run, capsys):
    final = torch.load(run.out / "final" / "state.pt", weights_only=True)
    n_train = N_PAIRS - int(round(N_PAIRS * 0.2))
    assert final["step"] == 2 * (n_train // BATCH)
    assert float(run.row["corpus_recall_at_100"]) > 100 / 600  # above random over the 600 companies
    assert TrainConfig.from_json(run.out / "config.json").data.batch_size == BATCH


def test_train_streaming_from_a_data_dir(dataset_dir, capsys):
    out = dataset_dir.parent / "stream"
    out.mkdir()
    row = _train(dataset_dir, out, "--stream", "--metrics-jsonl", str(out / "metrics.jsonl"))
    printed = capsys.readouterr().out
    assert f"data: {dataset_dir} ({N_PAIRS:,} pairs)" in printed
    assert f"{N_PAIRS // BATCH} steps/epoch" in printed
    final = torch.load(out / "final" / "state.pt", weights_only=True)
    # every epoch streams the whole pairs file: one chunk, N_PAIRS // BATCH full batches
    assert final["step"] == 2 * (N_PAIRS // BATCH)
    epochs = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [e["step"] for e in epochs] == [N_PAIRS // BATCH, 2 * (N_PAIRS // BATCH)]
    assert all(np.isfinite([e["train_loss"], e["val_loss"]]).all() for e in epochs)
    assert float(row["corpus_recall_at_100"]) > 100 / 600


def test_stream_refuses_sampling_on_the_device(dataset_dir, tmp_path):
    with pytest.raises(SystemExit, match="incompatible with --stream"):
        ttrain.main(["--force-cpu", "--data-dir", str(dataset_dir), "--stream", "--sample-on-device",
                     "--output-dir", str(tmp_path)])


def test_eval_on_a_data_dir_matches_the_jax_cli(run, dataset_dir):
    report_path = run.out.parent / "eval.json"
    assert teval.main(["--model-dir", str(run.out), "--data-dir", str(dataset_dir), "--force-cpu",
                       "--demo-queries", "2", "--output", str(report_path)]) == 0
    got = json.loads(report_path.read_text())

    from jodalrob_twotower_tpu.config import CheckpointConfig as JCheckpointConfig
    from jodalrob_twotower_tpu.data.feature_store import FeatureStore as JFeatureStore
    from jodalrob_twotower_tpu.data.parquet_dataset import load_pairs_parquet as j_load_pairs
    from jodalrob_twotower_tpu.schema import TwoTowerSchema as JSchema
    from jodalrob_twotower_tpu.train.checkpoint import CheckpointManager as JCheckpointManager

    cfg = TrainConfig.from_json(run.out / "config.json")
    schema, _, _, pairs = load_dataset(dataset_dir)
    model = build_model(schema, cfg)
    weights = CheckpointManager(run.out).restore_weights(model.state_dict(), device="cpu")
    params, stats = state_dict_to_flax(model, {**weights["params"], **weights["batch_stats"]})
    jdir = run.out.parent / "jax_run"
    JCheckpointManager(jdir, JCheckpointConfig(save_final=False)).finalize(
        SimpleNamespace(params=params, batch_stats=stats))
    (jdir / "config.json").write_text((run.out / "config.json").read_text())
    want_path = run.out.parent / "jax_eval.json"
    assert _jax_eval_main(["--model-dir", str(jdir), "--data-dir", str(dataset_dir), "--demo-queries", "2",
                           "--output", str(want_path)]) == 0
    want = json.loads(want_path.read_text())

    # the validation split: the reference CLIs' rule on the reference's join
    # of the same files
    j_schema = JSchema.from_json(dataset_dir / "schema.json")
    j_pairs = j_load_pairs(dataset_dir / "pairs.parquet",
                           JFeatureStore.from_parquet(j_schema.notice, dataset_dir / "notice.parquet"),
                           JFeatureStore.from_parquet(j_schema.company, dataset_dir / "company.parquet"))
    perm = np.random.default_rng(cfg.data.shuffle_seed).permutation(len(j_pairs))
    n_test = int(round(len(j_pairs) * cfg.data.test_split))
    np.testing.assert_array_equal(split_pairs(pairs, cfg)[1], j_pairs[perm[:n_test]])

    assert _keys({k: v for k, v in got.items() if k != "model_dir"}) == \
        _keys({k: v for k, v in want.items() if k != "model_dir"})
    assert got["num_val_pairs"] == want["num_val_pairs"] == n_test
    assert got["corpus"]["num_queries"] == want["corpus"]["num_queries"] == n_test
    assert got["random_baselines"] == want["random_baselines"]
    for k, v in want["in_batch"].items():
        assert abs(got["in_batch"][k] - v) <= METRIC_ATOL * max(1.0, abs(v)), (k, got["in_batch"][k], v)
    for k, v in want["corpus"].items():
        assert abs(got["corpus"][k] - v) <= METRIC_ATOL * max(1.0, abs(v)), (k, got["corpus"][k], v)
    assert [d["query"] for d in got["demo"]] == [d["query"] for d in want["demo"]]

    # the eval CLI scores the run's weights as the trainer's final validation did
    assert abs(got["in_batch"]["loss"] - float(run.row["val_loss"])) <= 1e-6
    assert abs(got["corpus"]["recall@100"] - float(run.row["corpus_recall_at_100"])) <= 1e-6
