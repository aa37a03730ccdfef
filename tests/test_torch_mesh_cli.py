"""The port's three CLIs with ``--mesh-devices 2 --force-cpu`` (two gloo
ranks spawned by ``parallel/distributed.launch``, called in-process) against
the JAX package's CLIs with ``--mesh-devices 2`` (``scripts/*.py``, called
in-process on conftest's virtual devices).

* train: the same train/validation split, the results CSV's columns and
  the metrics JSONL's keys; rank 0 alone wrote the run's files.
* eval and serve, on the same float32 weights (flax variables drawn from
  numpy, converted with ``convert.flax_to_state_dict`` and written as a port
  run beside the reference's weights-only export): the eval reports' keys at
  every level and their split, metrics within 1e-4 and the corpus recall
  equal, through the indexed eval and ``--host-eval``; the serve JSONL naming the same companies in the same order,
  scores within 1e-5 (tests/test_torch_serve.py's tolerance), from the int8
  and the exact ShardedIndex.
* ``--store-sharding rows`` (A12b item 2): the training CLI's run on the
  mesh bit-equal to its replicated-store run (the exchange reads exact
  rows), the eval CLI's report against the reference CLI's with the same
  flag (the tolerances above).
* ``--grad-compression int16`` (A12b item 4): the training CLI on the mesh
  trains with the compressed sync and checkpoints, its final weights
  restoring on one device; ``--compressed-negatives global`` without
  ``--grad-compression`` exits, as does ``--grad-compression`` without
  ``--mesh-devices`` (scripts/train.py:214-237). A mesh larger than the
  visible cards is refused as the reference refuses it."""

import contextlib
import csv
import importlib.util
import io
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jodalrob_twotower_torch import eval as teval
from jodalrob_twotower_torch import serve
from jodalrob_twotower_torch import train as ttrain
from jodalrob_twotower_torch.config import CheckpointConfig, DataConfig, ModelConfig, TrainConfig
from jodalrob_twotower_torch.convert import flax_to_state_dict
from jodalrob_twotower_torch.models import build_model
from jodalrob_twotower_torch.schema import tiny_synthetic_schema
from jodalrob_twotower_torch.train.checkpoint import CheckpointManager
from jodalrob_twotower_torch.train.train_step import create_train_state
from jodalrob_twotower_tpu import config as j_config
from jodalrob_twotower_tpu.models import build_model as j_build_model
from jodalrob_twotower_tpu.schema import tiny_synthetic_schema as j_tiny_schema
from jodalrob_twotower_tpu.train.checkpoint import CheckpointManager as JCheckpointManager

from torch_parity import MODEL_KW, flax_variables

REPO = Path(__file__).resolve().parent.parent
MESH = ["--mesh-devices", "2"]
TRAIN_ARGS = ["--synthetic", "--epochs", "1", "--pair-limit", "1000", "--batch-size", "128"]
EVAL_ARGS = ["--synthetic", "--pair-limit", "256", "--batch-size", "64", "--ks", "10,100"]
QUERIES = ["--synthetic", "--queries", "64", "--k", "10"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread here and (launch_cli's share of it) in each rank."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}_cli", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


def _quiet(main, argv):
    with contextlib.redirect_stderr(io.StringIO()), contextlib.redirect_stdout(io.StringIO()) as out:
        assert main([str(a) for a in argv]) == 0
    return out.getvalue()


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_keys(v) for v in tree]
    return None


def _csv_header(path):
    with Path(path).open(newline="") as fh:
        return next(csv.reader(fh))


def test_train_cli_on_the_mesh_matches_the_reference_cli(tmp_path, capfd):
    got_dir, want_dir = tmp_path / "port", tmp_path / "jax"
    assert ttrain.main([str(a) for a in ["--force-cpu", *TRAIN_ARGS, *MESH, "--output-dir", got_dir, "--results-csv",
                                         tmp_path / "port.csv", "--metrics-jsonl", tmp_path / "port.jsonl"]]) == 0
    got_out = capfd.readouterr().out
    want_out = _quiet(_script("train"), ["--force-cpu", *TRAIN_ARGS, *MESH, "--output-dir", want_dir,
                                         "--results-csv", tmp_path / "jax.csv",
                                         "--metrics-jsonl", tmp_path / "jax.jsonl"])
    split = [line for line in want_out.splitlines() if line.startswith("pairs:")]
    assert split and [line for line in got_out.splitlines() if line.startswith("pairs:")] == split
    assert got_out.count("pairs:") == 1  # rank 0 alone reports
    assert _csv_header(tmp_path / "port.csv") == _csv_header(tmp_path / "jax.csv")
    got_m = [json.loads(x) for x in (tmp_path / "port.jsonl").read_text().splitlines()]
    want_m = [json.loads(x) for x in (tmp_path / "jax.jsonl").read_text().splitlines()]
    assert len(got_m) == len(want_m) == 1 and set(got_m[0]) == set(want_m[0])
    assert {"config.json", "weights", "final", "epoch_0"} <= {p.name for p in got_dir.iterdir()}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_cli")
    kw = {**MODEL_KW, "compute_dtype": "float32"}
    t_cfg = TrainConfig(model=ModelConfig(**kw), data=DataConfig(pair_limit=2000))
    j_model = j_build_model(j_tiny_schema(), j_config.TrainConfig(model=j_config.ModelConfig(**kw)))
    variables = flax_variables(j_model, j_tiny_schema(), np.random.default_rng(21))
    t_model = build_model(tiny_synthetic_schema(), t_cfg)
    sd = flax_to_state_dict(t_model, variables["params"], variables["batch_stats"])
    buffers = {k for k, _ in t_model.named_buffers()}
    port = tmp / "port"
    ckpt = CheckpointManager(port, CheckpointConfig(save_final=False))
    ckpt.save_config(t_cfg)
    ckpt.finalize(SimpleNamespace(params={k: v for k, v in sd.items() if k not in buffers},
                                  batch_stats={k: v for k, v in sd.items() if k in buffers}))
    ref = tmp / "jax"
    JCheckpointManager(ref, j_config.CheckpointConfig(save_final=False)).finalize(
        SimpleNamespace(params=variables["params"], batch_stats=variables["batch_stats"]))
    (ref / "config.json").write_text((port / "config.json").read_text())
    return SimpleNamespace(tmp=tmp, port=port, ref=ref)


@pytest.mark.parametrize("host_eval", [[], ["--host-eval"]])
def test_eval_cli_on_the_mesh_matches_the_reference_cli(dirs, host_eval):
    tag = "host" if host_eval else "indexed"
    got_path, want_path = dirs.tmp / f"port_eval_{tag}.json", dirs.tmp / f"jax_eval_{tag}.json"
    assert teval.main([str(a) for a in ["--model-dir", dirs.port, "--force-cpu", *EVAL_ARGS, *MESH, *host_eval,
                                        "--output", got_path]]) == 0
    _quiet(_script("eval"), ["--model-dir", dirs.ref, *EVAL_ARGS, *MESH, *host_eval, "--output", want_path])
    got, want = json.loads(got_path.read_text()), json.loads(want_path.read_text())
    assert _keys({k: v for k, v in got.items() if k != "model_dir"}) == \
        _keys({k: v for k, v in want.items() if k != "model_dir"})
    assert got["num_val_pairs"] == want["num_val_pairs"] == 256
    # the global batch's size, as the reference's sharded arrays keep it
    assert got["in_batch"]["assessment_batch_size"] == want["in_batch"]["assessment_batch_size"] == 64
    assert got["random_baselines"] == want["random_baselines"]
    for k, v in want["in_batch"].items():
        assert abs(got["in_batch"][k] - v) <= 1e-4 * max(1.0, abs(v)), (k, got["in_batch"][k], v)
    assert got["corpus"] == want["corpus"]


def _lines(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


@pytest.mark.parametrize("index", ["int8", "exact"])
def test_serve_cli_on_the_mesh_matches_the_reference_cli(dirs, index):
    got_path, want_path = dirs.tmp / f"port_{index}.jsonl", dirs.tmp / f"jax_{index}.jsonl"
    assert serve.main([str(a) for a in ["--model-dir", dirs.port, "--force-cpu", "--index", index, *QUERIES,
                                        *MESH, "--output", got_path]]) == 0
    _quiet(_script("serve"), ["--model-dir", dirs.ref, "--index", index, *QUERIES, *MESH, "--output", want_path])
    got, want = _lines(got_path), _lines(want_path)
    assert len(got) == len(want) == 64
    for g, w in zip(got, want):
        assert g["notice"] == w["notice"]
        assert [h["company"] for h in g["top_k"]] == [h["company"] for h in w["top_k"]], g["notice"]
        np.testing.assert_allclose([h["score"] for h in g["top_k"]], [h["score"] for h in w["top_k"]],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("main,flags", [
    (ttrain.main, ["--store-sharding", "rows"]),
    (ttrain.main, ["--grad-compression", "int16"]),
    (ttrain.main, ["--compressed-negatives", "global"]),
    (teval.main, ["--model-dir", "missing", "--store-sharding", "rows"]),
])
def test_a12b_flags_still_raise(main, flags, request):
    """The A12b flags on the mesh: ``--grad-compression int16`` trains
    with the compressed sync (item 4) and checkpoints, its weights finite
    and restoring on one device; ``--compressed-negatives global`` alone
    exits as the reference CLI exits; ``--store-sharding rows`` runs (items
    1-2): training bit-equal to the replicated-store run, the eval report
    as the reference CLI's."""
    tmp = request.getfixturevalue("tmp_path")
    if "--compressed-negatives" in flags:
        with pytest.raises(SystemExit, match="--compressed-negatives requires --grad-compression"):
            main(["--force-cpu", *MESH, *flags])
        return
    if "--grad-compression" in flags:
        capfd = request.getfixturevalue("capfd")
        out = tmp / "int16"
        assert main([str(a) for a in ["--force-cpu", *TRAIN_ARGS, *MESH, *flags, "--output-dir", out,
                                      "--results-csv", tmp / "int16.csv", "--no-corpus-eval",
                                      "--save-every-steps", "4"]]) == 0
        assert "gradients int16 with local negatives" in capfd.readouterr().out
        assert {"final", "weights", "best", "epoch_0", "config.json"} <= {p.name for p in out.iterdir()}
        cfg = TrainConfig.from_json(out / "config.json")
        assert (cfg.mesh.grad_compression, cfg.mesh.compressed_negatives) == ("int16", "local")
        one = build_model(tiny_synthetic_schema(), cfg)
        state, _ = create_train_state(one, cfg, cfg.seed, 10, device="cpu")
        restored = CheckpointManager(out, cfg.checkpoint).restore("final", state)
        assert all(torch.isfinite(v).all() for v in restored.params.values())
        assert any(not torch.equal(restored.params[k], v) for k, v in state.params.items())
        with open(tmp / "int16.csv") as f:
            assert len(list(csv.DictReader(f))) == 1
        return
    if "--store-sharding" not in flags:
        raise AssertionError(flags)
    if main is ttrain.main:
        runs, capfd = {}, request.getfixturevalue("capfd")
        for tag, extra in (("replicated", []), ("rows", flags)):
            out = tmp / tag
            assert main([str(a) for a in ["--force-cpu", *TRAIN_ARGS, *MESH, *extra, "--output-dir", out,
                                          "--results-csv", tmp / f"{tag}.csv", "--no-corpus-eval"]]) == 0
            runs[tag] = torch.load(out / "final" / "state.pt", weights_only=True)
        assert "stores rows" in capfd.readouterr().out
        for k, v in runs["replicated"]["params"].items():
            assert torch.equal(runs["rows"]["params"][k], v), k
        return
    dirs = request.getfixturevalue("dirs")
    got_path, want_path = tmp / "port_rows.json", tmp / "jax_rows.json"
    argv = ["--model-dir", dirs.port, "--force-cpu", *EVAL_ARGS, *MESH, *flags[2:], "--output", got_path]
    assert main([str(a) for a in argv]) == 0
    _quiet(_script("eval"), ["--model-dir", dirs.ref, *EVAL_ARGS, *MESH, *flags[2:], "--output", want_path])
    got, want = json.loads(got_path.read_text()), json.loads(want_path.read_text())
    for k, v in want["in_batch"].items():
        assert abs(got["in_batch"][k] - v) <= 1e-4 * max(1.0, abs(v)), (k, got["in_batch"][k], v)
    assert got["corpus"] == want["corpus"]


@pytest.mark.parametrize("flags,message", [
    (["--grad-compression", "int16"], "--grad-compression requires --mesh-devices"),
    ([*MESH, "--compressed-negatives", "global"], "--compressed-negatives requires --grad-compression"),
])
def test_compressed_flags_exit_before_any_rank_starts(flags, message, monkeypatch):
    """scripts/train.py:214-237's exits, taken before the launcher runs."""
    from jodalrob_twotower_torch.parallel import distributed

    def no_launch(*_, **__):
        raise AssertionError("a rank started")

    monkeypatch.setattr(distributed, "launch_cli", no_launch)
    with pytest.raises(SystemExit, match=message):
        ttrain.main(["--force-cpu", *flags])


def test_a_mesh_beyond_the_visible_cards_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--mesh-devices 2 but only 1 device"):
        ttrain.main(MESH)
    with pytest.raises(SystemExit, match="cannot be combined with --load-index"):
        serve.main(["--model-dir", "missing", *MESH, "--load-index", "x.npz"])
