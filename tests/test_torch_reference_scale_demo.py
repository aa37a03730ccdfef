"""The port's ``reference_scale_demo`` on the CPU, beside the JAX package's
``scripts/reference_scale_demo.py`` run in this process on the same
metadata directory: a reference-format ``metadata.csv`` (29 numeric and 32
categorical notice columns and the title as text, 1 numeric and 6
categorical company columns) and config JSONs of the form
tests/test_reference_configs.py:16-33 uses.

* The two print the same schema and config lines, build the same schema
  and the same planted stores and pairs, bit for bit, and split them into
  the same training and validation pairs (the reference's trainer is
  replaced by one that records what it is given: the training is held by
  the trainer tests).
* The port's run trains at batch 64 on 600 rows a side: the results CSV
  and metrics JSONL written, its last line's recall@k, MRR and AUC finite,
  validation recall@10 above the random baseline."""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from jodalrob_twotower_torch import reference_scale_demo as demo
from jodalrob_twotower_tpu.train import trainer as jtrainer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--rows", "600", "--pairs", "3000", "--batch-size", "64"]
NUMERIC = {"bdgtamt": {"fill": "median", "log1p": True, "scale": "zscore", "add_flag": True, "clip": [0.5, 99.5]},
           "indstrytyevlrt": {"fill": 0, "log1p": False, "scale": "none", "add_flag": True,
                              "clip_abs": [0.0, 100.0]},
           "totprdprcnum": {"fill": "mode", "log1p": False, "scale": "none", "add_flag": True}}
CATEGORICAL = {"bidmethdnm": {"encoding_method": "label"},
               "ntceinsttcd": {"encoding_method": "label", "rare_threshold": 0.5}}
TEXT = {"bidntcenm": {"use": True, "embedding_model": "some/model", "max_length": 32, "normalize": True,
                      "add_flag": True, "null_strategy": "empty"},
        "skipped": {"use": False}}


@pytest.fixture(scope="module")
def meta(tmp_path_factory):
    d = tmp_path_factory.mktemp("meta")
    rows = ["테이블명,컬럼명,타입,사용 여부,PK,범주형 여부,범주 갯수",
            "notice,bidntceno,character varying(40),Y,Y,,", "notice,bidntceord,character varying(3),Y,Y,,"]
    rows += [f"notice,num_{i},numeric,Y,,," for i in range(29)]
    rows += [f"notice,cat_{i},character varying(100),Y,,Y,{50 + i}" for i in range(32)]
    rows += ["notice,bidntcenm,text,Y,,,", "notice,rgstdt,timestamp,N,,,",
             "company,bizno,character varying(10),Y,Y,,", "company,num_0,numeric,Y,,,"]
    rows += [f"company,cat_{i},character varying(100),Y,,Y,{30 + i}" for i in range(6)]
    (d / "metadata.csv").write_text("\n".join(rows) + "\n", encoding="utf-8")
    for name, cfg in (("numeric", NUMERIC), ("categorical", CATEGORICAL), ("text", TEXT)):
        (d / f"notice_{name}_config.json").write_text(json.dumps(cfg))
    return d


class _Recorder:
    """Stands in for the reference's Trainer: records what it is given."""
    seen: dict = {}

    def __init__(self, cfg, schema, notice_store, company_store, **kw):
        _Recorder.seen.update(cfg=cfg, schema=schema, stores=(notice_store, company_store))

    def train(self, train_pairs, val_pairs, **kw):
        _Recorder.seen.update(train=train_pairs, val=val_pairs)


@pytest.fixture(scope="module")
def runs(meta, tmp_path_factory):
    spec = importlib.util.spec_from_file_location("j_reference_scale_demo", ROOT / "scripts/reference_scale_demo.py")
    j_demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_demo)
    mp = pytest.MonkeyPatch()
    mp.setattr(jtrainer, "Trainer", _Recorder)
    j_out, t_out = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(j_out):
            assert j_demo.main(["--meta", str(meta), *ARGS, "--workdir", str(tmp_path_factory.mktemp("jax"))]) == 0
    finally:
        mp.undo()
    work = tmp_path_factory.mktemp("port")
    with contextlib.redirect_stdout(t_out):
        assert demo.main(["--meta", str(meta), *ARGS, "--workdir", str(work), "--force-cpu"]) == 0
    return j_out.getvalue().splitlines(), t_out.getvalue().splitlines(), dict(_Recorder.seen), work


def test_the_demo_builds_the_reference_schema_stores_and_split(runs, meta):
    j_lines, t_lines, seen, _ = runs
    for prefix in ("schema:", "reference configs:"):
        assert [x for x in t_lines if x.startswith(prefix)] == [x for x in j_lines if x.startswith(prefix)]
    assert "schema: notice 29 num / 32 cat / 1 text; company 1 / 6 / 0" in t_lines
    assert "reference configs: 3 numeric, 2 categorical adapted" in t_lines
    from jodalrob_twotower_torch.schema import schema_from_metadata_csv

    schema = schema_from_metadata_csv(meta / "metadata.csv", notice_text_columns=["bidntcenm"],
                                      company_text_columns=())
    assert schema.to_dict() == seen["schema"].to_dict()
    notice, company, pairs, rng = demo.planted_stores(schema, 600, 3000)
    for got, want in zip((notice, company), seen["stores"]):
        np.testing.assert_array_equal(got.dense, np.asarray(want.dense))
        np.testing.assert_array_equal(got.cat_ids, np.asarray(want.cat_ids))
    perm = rng.permutation(len(pairs))
    n_val = len(pairs) // 5
    np.testing.assert_array_equal(pairs[perm[n_val:]], seen["train"])
    np.testing.assert_array_equal(pairs[perm[:n_val]][:4096], seen["val"])
    assert seen["cfg"].data.batch_size == 64 and seen["cfg"].loss.temperature == 1.0
    assert seen["cfg"].optimizer.learning_rate == 1e-3


def test_the_demo_trains_and_writes_its_ledger(runs):
    _, t_lines, _, work = runs
    assert (work / "train_results.csv").exists() and (work / "metrics.jsonl").exists()
    out = json.loads(t_lines[-1])
    assert out["bench"] == "reference_scale_demo" and out["batch"] == 64 and out["steps"] == 2400 // 64
    assert all(np.isfinite([out["mrr"], out["auc"], out["recall@10"], out["corpus_mrr"]]))
    assert out["recall@10"] > 10 / 64  # the random baseline of recall@10 at B = 64
