"""The port's serve CLI (``python -m jodalrob_twotower_torch.serve``) in-process
on the CPU against the JAX package's (``scripts/serve.py``, called in-process:
its subprocess tests fail where the package is not installed) on the same
weights: tiny flax variables, every leaf drawn from numpy, converted with
``convert.flax_to_state_dict`` and written as a port training run beside the
reference's weights-only export. Both serve the tiny synthetic dataset at
float32 compute, so their JSONL must name the same companies in the same
order, scores within 1e-5 (float32 towers summed in another order, rounded to
6 decimals). Then the index round trips (the port's file and the
reference's), the measured auto-configuration's pick and recalls, the host
corpus rule, the reference's conflict errors and ``--data-dir``."""

import contextlib
import importlib.util
import io
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jodalrob_twotower_torch import serve
from jodalrob_twotower_torch.config import CheckpointConfig, ModelConfig, TrainConfig
from jodalrob_twotower_torch.convert import flax_to_state_dict
from jodalrob_twotower_torch.models import build_model
from jodalrob_twotower_torch.schema import tiny_synthetic_schema
from jodalrob_twotower_torch.serving import autoconfig as t_auto
from jodalrob_twotower_torch.train.checkpoint import CheckpointManager
from jodalrob_twotower_tpu import config as j_config
from jodalrob_twotower_tpu.models import build_model as j_build_model
from jodalrob_twotower_tpu.schema import tiny_synthetic_schema as j_tiny_schema
from jodalrob_twotower_tpu.train.checkpoint import CheckpointManager as JCheckpointManager

from torch_parity import MODEL_KW, flax_variables

REPO = Path(__file__).resolve().parent.parent
SCORE_ATOL = 1e-5
QUERIES = ["--queries", "100", "--k", "10"]


@pytest.fixture(autouse=True)
def one_thread():
    """Small CPU work runs fastest on one thread, and several test workers
    sharing the cores do not oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_main(argv):
    spec = importlib.util.spec_from_file_location("jax_serve_cli", REPO / "scripts" / "serve.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main(argv)


def _run(main, argv) -> str:
    """Runs a CLI's main in-process; returns its stderr (stdout is echoed)."""
    err, out = io.StringIO(), io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(out):
        assert main([str(a) for a in argv]) == 0
    print(out.getvalue())
    return err.getvalue()


def _lines(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def _assert_same_results(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["notice"] == w["notice"]
        assert [h["company"] for h in g["top_k"]] == [h["company"] for h in w["top_k"]], g["notice"]
        np.testing.assert_allclose([h["score"] for h in g["top_k"]], [h["score"] for h in w["top_k"]],
                                   rtol=0, atol=SCORE_ATOL)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    kw = {**MODEL_KW, "compute_dtype": "float32"}
    t_cfg = TrainConfig(model=ModelConfig(**kw))
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
    # the reference CLI's int8 answers and saved index, which two tests read
    _run(_reference_main, ["--model-dir", ref, "--synthetic", *QUERIES, "--output", tmp / "ref_int8.jsonl",
                           "--save-index", tmp / "ref_int8.npz"])
    return SimpleNamespace(tmp=tmp, port=port, ref=ref)


@pytest.mark.parametrize("flags", [
    ["--index", "int8"],
    ["--index", "exact", "--corpus-chunk", "4096"],
    ["--index", "int8", "--approx-recall", "0.9", "--rescore-depth", "50", "--rescore-dtype", "bfloat16"],
], ids=["int8", "exact-chunked", "int8-approx-bf16-rescore"])
def test_jsonl_matches_the_reference_cli(dirs, flags):
    got, want = dirs.tmp / "got.jsonl", dirs.tmp / "want.jsonl"
    err = _run(serve.main, ["--model-dir", dirs.port, "--force-cpu", "--synthetic", *flags, *QUERIES,
                            "--output", got])
    if flags == ["--index", "int8"]:  # the fixture's reference run
        want = dirs.tmp / "ref_int8.jsonl"
    else:
        _run(_reference_main, ["--model-dir", dirs.ref, "--synthetic", *flags, *QUERIES, "--output", want])
    _assert_same_results(_lines(got), _lines(want))
    assert f"index: {flags[1]} over 10,000 companies" in err.splitlines()


def test_saved_indexes_serve_the_same(dirs):
    """``--save-index`` then ``--load-index`` answers line for line as the
    build did; an index saved by the reference's CLI serves its answers."""
    t = dirs.tmp
    _run(serve.main, ["--model-dir", dirs.port, "--force-cpu", *QUERIES, "--output", t / "a.jsonl",
                      "--save-index", t / "port.npz"])
    _run(serve.main, ["--model-dir", dirs.port, "--force-cpu", *QUERIES, "--output", t / "b.jsonl",
                      "--load-index", t / "port.npz", "--qps-bench"])
    assert (t / "a.jsonl").read_text() == (t / "b.jsonl").read_text()
    _run(serve.main, ["--model-dir", dirs.port, "--force-cpu", *QUERIES, "--output", t / "c.jsonl",
                      "--load-index", t / "ref_int8.npz"])
    _assert_same_results(_lines(t / "c.jsonl"), _lines(t / "ref_int8.jsonl"))


# the two CLIs calibrate on their own towers' embeddings, which differ in the
# last float32 bits: a near-tie at rank k may fall the other way for a query,
# one overlap in the 2048 x 10 counted, 4.9e-5; the lines print 4 decimals
RECALL_ATOL = 2e-4


def _auto_line(stderr: str) -> tuple[str, dict[str, float]]:
    """The auto-config line without its measured recalls, and the recalls."""
    (line,) = [x for x in stderr.splitlines() if x.startswith("auto-config")]
    head, rest = line.split(" — measured recall@")
    recalls, flags = rest.split("; equivalent to ")
    k, recalls = recalls.split(" ", 1)
    measured = dict(item.rsplit(": ", 1) for item in recalls.split(", "))
    return f"{head} recall@{k}; {flags}", {name: float(r) for name, r in measured.items()}


def _assert_same_pick(got: str, want: str) -> None:
    (g, g_recalls), (w, w_recalls) = _auto_line(got), _auto_line(want)
    assert g == w and g_recalls.keys() == w_recalls.keys()
    for name, r in w_recalls.items():
        assert abs(g_recalls[name] - r) <= RECALL_ATOL, (name, g_recalls[name], r)


def test_target_recall_picks_what_the_reference_picks(dirs):
    t = dirs.tmp
    err = _run(serve.main, ["--model-dir", dirs.port, "--force-cpu", "--target-recall", "0.95", *QUERIES,
                            "--output", t / "auto.jsonl"])
    ref_err = _run(_reference_main, ["--model-dir", dirs.ref, "--target-recall", "0.95", *QUERIES,
                                     "--output", t / "auto_ref.jsonl"])
    _assert_same_pick(err, ref_err)
    assert _auto_line(err)[0].endswith("--index int8 --approx-recall 0.9 --rescore-depth 400 --rescore-dtype bfloat16")
    _assert_same_results(_lines(t / "auto.jsonl"), _lines(t / "auto_ref.jsonl"))


def test_host_corpus_streams_and_an_exact_pick_exits(dirs, monkeypatch):
    """A corpus that does not fit beside the candidates moves to the host:
    the calibration streams it and picks as from the device. Where the pick
    is then the exact scan, the CLI exits instead of putting the whole f32
    corpus on the device (``scripts/serve.py:235`` builds it)."""
    t = dirs.tmp
    monkeypatch.setattr(serve, "corpus_fits", lambda corpus_emb, corpus_chunk: False)
    err = _run(serve.main, ["--model-dir", dirs.port, "--force-cpu", "--target-recall", "0.95", *QUERIES,
                            "--output", t / "host.jsonl"])
    assert "moved to the host" in err
    device_err = _run(serve.main, ["--model-dir", dirs.port, "--force-cpu", "--target-recall", "0.95", "--k", "10"])
    assert _auto_line(err) == _auto_line(device_err)  # the same embeddings: the same recalls

    def exact_pick(target, corpus_emb, query_emb, **kw):
        assert isinstance(corpus_emb, np.ndarray)
        return t_auto.EXACT, {"exact": 1.0}

    monkeypatch.setattr(t_auto, "calibrate_serving_config", exact_pick)
    with pytest.raises(SystemExit, match="moved to the host"):
        serve.main(["--model-dir", str(dirs.port), "--force-cpu", "--target-recall", "0.95"])


@pytest.mark.parametrize("flags", [
    ["--target-recall", "0.9", "--index", "exact"],
    ["--target-recall", "0.9", "--approx-recall", "0.9", "--rescore-depth", "8"],
    ["--target-recall", "0.9", "--load-index", "{index}"],
    ["--load-index", "{index}", "--corpus-chunk", "100", "--rescore-dtype", "bfloat16"],
], ids=["target-index", "target-knobs", "target-load", "load-knobs"])
def test_conflicting_flags_fail_as_in_the_reference(dirs, flags):
    index = dirs.tmp / "conflict.npz"
    if not index.exists():
        _run(serve.main, ["--model-dir", dirs.port, "--force-cpu", "--save-index", index])
    argv = [f.format(index=index) for f in flags]
    with pytest.raises(SystemExit) as want:
        _reference_main(["--model-dir", str(dirs.ref), *argv])
    with pytest.raises(SystemExit) as got:
        serve.main(["--model-dir", str(dirs.port), "--force-cpu", *argv])
    assert str(got.value) == str(want.value)


def test_data_dir_serves_parquet_written_by_the_port(dirs):
    from jodalrob_twotower_torch.train.cli import synthetic_data

    t = dirs.tmp
    data = t / "ds"
    data.mkdir()
    schema, notice_store, company_store, _ = synthetic_data("tiny", TrainConfig().seed)
    schema.to_json(data / "schema.json")
    notice_store.to_parquet(data / "notice.parquet")
    company_store.to_parquet(data / "company.parquet")
    _run(serve.main, ["--model-dir", dirs.port, "--force-cpu", "--data-dir", data, *QUERIES,
                      "--output", t / "parquet.jsonl"])
    _run(serve.main, ["--model-dir", dirs.port, "--force-cpu", "--synthetic", *QUERIES,
                      "--output", t / "synthetic.jsonl"])
    assert (t / "parquet.jsonl").read_text() == (t / "synthetic.jsonl").read_text()


def test_mesh_devices_is_not_ported(tmp_path, monkeypatch):
    """A mesh beyond the visible cards is refused before anything runs, as
    the reference refuses it (the mesh serves in tests/test_torch_mesh_cli.py)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(SystemExit, match="--mesh-devices 2 but only 0 device"):
        serve.main(["--model-dir", str(tmp_path), "--mesh-devices", "2"])
    assert not list(tmp_path.iterdir())
