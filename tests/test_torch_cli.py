"""The port's CLIs in-process on the CPU (``--force-cpu``), at the tiny
synthetic scale: ``train.main`` then ``eval.main`` on its output directory,
the eval report against the JAX package's eval CLI (``scripts/eval.py``,
called in-process) on the same weights (exported in the reference's
weights-only format): the same keys at every level, the same validation
split, and the metrics within bf16 resolution of each other (both run the
default bf16 towers, rounded at other places). Then ``--resume`` of a
finished run trains nothing and keeps its weights, the headline script's
smoke holds its gate, and the mesh flags without ``--mesh-devices`` exit
as scripts/train.py does; ``--mesh-devices`` itself runs in
tests/test_torch_mesh_cli.py. The parquet
``--data-dir`` and ``--stream`` run in tests/test_torch_data_cli.py."""

import csv
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from jodalrob_twotower_torch import eval as teval
from jodalrob_twotower_torch import train as ttrain
from jodalrob_twotower_torch import train_headline
from jodalrob_twotower_torch.train import cli as tcli
from jodalrob_twotower_torch.config import TrainConfig
from jodalrob_twotower_torch.convert import state_dict_to_flax
from jodalrob_twotower_torch.models import build_model
from jodalrob_twotower_torch.schema import tiny_synthetic_schema
from jodalrob_twotower_torch.train.checkpoint import CheckpointManager

REPO = Path(__file__).resolve().parent.parent
TRAIN_ARGS = ["--force-cpu", "--synthetic", "--epochs", "2", "--pair-limit", "2000", "--save-every-steps", "4"]
METRIC_ATOL = 0.02  # bf16 towers on both sides: loss ~5, similarities ~1, shares of 400 rows


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU steps run fastest on one thread, and several test workers
    sharing the cores do not oversubscribe them. Module scope, so that the
    module-scoped runs below take it too."""
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
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    out = tmp / "run"
    argv = TRAIN_ARGS + ["--output-dir", str(out), "--results-csv", str(tmp / "results.csv"),
                         "--metrics-jsonl", str(tmp / "metrics.jsonl")]
    assert ttrain.main(argv) == 0
    return SimpleNamespace(tmp=tmp, out=out, argv=argv)


def test_train_writes_checkpoints_metrics_and_results(run):
    assert {"config.json", "best.json", "step.json", "epoch_0", "epoch_1", "best", "final", "weights",
            "step_a", "step_b"} <= {p.name for p in run.out.iterdir()}
    epochs = [json.loads(line) for line in (run.tmp / "metrics.jsonl").read_text().splitlines()]
    assert [e["epoch"] for e in epochs] == [0, 1] and [e["step"] for e in epochs] == [6, 12]
    with (run.tmp / "results.csv").open(newline="") as fh:
        rows = list(csv.DictReader(fh))
    assert len(rows) == 1 and float(rows[0]["corpus_recall_at_100"]) > 0.01
    assert TrainConfig.from_json(run.out / "config.json").data.pair_limit == 2000


def test_eval_report_matches_the_jax_cli(run):
    report_path = run.tmp / "eval.json"
    assert teval.main(["--model-dir", str(run.out), "--force-cpu", "--demo-queries", "2",
                       "--output", str(report_path)]) == 0
    got = json.loads(report_path.read_text())

    # the same weights in the reference's format, beside the same config
    from jodalrob_twotower_tpu.config import CheckpointConfig as JCheckpointConfig
    from jodalrob_twotower_tpu.train.checkpoint import CheckpointManager as JCheckpointManager

    cfg = TrainConfig.from_json(run.out / "config.json")
    model = build_model(tiny_synthetic_schema(), cfg)
    weights = CheckpointManager(run.out).restore_weights(model.state_dict(), device="cpu")
    params, stats = state_dict_to_flax(model, {**weights["params"], **weights["batch_stats"]})
    jdir = run.tmp / "jax_run"
    JCheckpointManager(jdir, JCheckpointConfig(save_final=False)).finalize(
        SimpleNamespace(params=params, batch_stats=stats))
    (jdir / "config.json").write_text((run.out / "config.json").read_text())
    want_path = run.tmp / "jax_eval.json"
    assert _jax_eval_main(["--model-dir", str(jdir), "--demo-queries", "2", "--output", str(want_path)]) == 0
    want = json.loads(want_path.read_text())

    assert _keys({k: v for k, v in got.items() if k != "model_dir"}) == \
        _keys({k: v for k, v in want.items() if k != "model_dir"})
    assert got["num_val_pairs"] == want["num_val_pairs"] == 400
    assert got["random_baselines"] == want["random_baselines"]
    for k, v in want["in_batch"].items():
        assert abs(got["in_batch"][k] - v) <= METRIC_ATOL * max(1.0, abs(v)), (k, got["in_batch"][k], v)
    for k, v in want["corpus"].items():
        assert abs(got["corpus"][k] - v) <= METRIC_ATOL * max(1.0, abs(v)), (k, got["corpus"][k], v)
    assert [d["query"] for d in got["demo"]] == [d["query"] for d in want["demo"]]

    # the eval CLI scores the run's weights as the trainer's final validation did
    with (run.tmp / "results.csv").open(newline="") as fh:
        row = list(csv.DictReader(fh))[-1]
    assert abs(got["in_batch"]["loss"] - float(row["val_loss"])) <= 1e-6
    assert abs(got["corpus"]["recall@100"] - float(row["corpus_recall_at_100"])) <= 1e-6


def test_resume_of_a_finished_run_trains_nothing(run, capsys):
    before = torch.load(run.out / "final" / "state.pt", weights_only=True)
    assert ttrain.main(run.argv + ["--resume"]) == 0
    assert "resumed from epoch 1 (step 12)" in capsys.readouterr().out
    after = torch.load(run.out / "final" / "state.pt", weights_only=True)
    assert after["step"] == before["step"] == 12
    for k, v in before["params"].items():
        assert torch.equal(after["params"][k], v), k


def test_headline_smoke_holds_its_gate(tmp_path):
    assert train_headline.main(["--smoke", "--epochs", "2", "--output-dir", str(tmp_path)]) == 0
    summary = json.loads((tmp_path / "summary.json").read_text())
    assert summary["learned"] is True and summary["torch"]["epochs"] == 2
    assert summary["torch"]["final_corpus_recall_at_100"] >= 0.1
    assert {"train_results.csv", "metrics.jsonl"} <= {p.name for p in tmp_path.iterdir()}


@pytest.mark.parametrize("flag", [["--mesh-devices", "2", "--store-sharding", "rows"], ["--grad-compression", "int16"],
                                  ["--store-sharding", "rows"], ["--compressed-negatives", "global"]])
def test_unported_train_flags_raise(flag):
    """The mesh flags exit without ``--mesh-devices`` as
    scripts/train.py:214-237 does: ``--grad-compression`` other than "none"
    needs it, ``--compressed-negatives global`` needs
    ``--grad-compression``, ``--store-sharding`` needs ``--mesh-devices``;
    with it ``--store-sharding`` sets the store placement (the mesh runs:
    tests/test_torch_mesh_cli.py)."""
    if "--grad-compression" in flag:
        with pytest.raises(SystemExit, match="--grad-compression requires --mesh-devices"):
            ttrain.main(["--force-cpu"] + flag)
        cfg = tcli.configure(tcli.parse_args(["--force-cpu", "--grad-compression", "none"]))
        assert cfg.mesh.grad_compression == "none"
    elif "--compressed-negatives" in flag:
        with pytest.raises(SystemExit, match="--compressed-negatives requires --grad-compression"):
            ttrain.main(["--force-cpu"] + flag)
        cfg = tcli.configure(tcli.parse_args(["--force-cpu", "--mesh-devices", "2", "--grad-compression", "int16"]
                                             + flag))
        assert (cfg.mesh.grad_compression, cfg.mesh.compressed_negatives) == ("int16", "global")
    elif "--mesh-devices" not in flag:
        with pytest.raises(SystemExit, match="--store-sharding requires --mesh-devices"):
            ttrain.main(["--force-cpu"] + flag)
    else:
        cfg = tcli.configure(tcli.parse_args(["--force-cpu"] + flag))
        assert cfg.mesh.store_sharding == "rows"


def test_unported_eval_flags_raise(tmp_path):
    """``--store-sharding`` without ``--mesh-devices`` exits before reading
    anything, as scripts/eval.py:126-127 does; with it the flag parses (the
    mesh eval runs in tests/test_torch_mesh_cli.py)."""
    with pytest.raises(SystemExit, match="--store-sharding requires --mesh-devices"):
        teval.main(["--model-dir", str(tmp_path), "--store-sharding", "rows"])
    args = teval.parse_args(["--model-dir", str(tmp_path), "--mesh-devices", "2", "--store-sharding", "rows"])
    assert (args.mesh_devices, args.store_sharding) == (2, "rows")
    assert not list(tmp_path.iterdir())
