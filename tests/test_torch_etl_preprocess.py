"""The port's ETL preprocessors (``etl/numeric.py``, ``etl/categorical.py``,
``etl/text.py``'s hash embedder, ``etl/reference_configs.py``) against the
JAX package's on the same numpy inputs from a seed: outputs bit-equal over
every fill / clip / log1p / scale mode and over the categorical specials,
rare values, max vocab and unseen values; each package loads the other's
JSON state and transforms identically."""

import dataclasses
import itertools
import json

import numpy as np
import pytest

from jodalrob_twotower_torch.etl import categorical as tcat
from jodalrob_twotower_torch.etl import numeric as tnum
from jodalrob_twotower_torch.etl import reference_configs as tref
from jodalrob_twotower_torch.etl import text as ttext
from jodalrob_twotower_tpu.etl import categorical as jcat
from jodalrob_twotower_tpu.etl import numeric as jnum
from jodalrob_twotower_tpu.etl import reference_configs as jref
from jodalrob_twotower_tpu.etl import text as jtext


def assert_columns_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def numeric_table(seed: int, n: int = 500) -> dict:
    rng = np.random.default_rng(seed)
    a = rng.lognormal(3.0, 1.5, n)
    a[rng.random(n) < 0.1] = np.nan
    b = rng.normal(-2.0, 5.0, n)
    b[::17] = np.nan
    b[5], b[6] = np.inf, -np.inf  # data, not nulls: they flow into the clip
    c = rng.integers(-3, 4, n).astype(np.float64)  # ties, for the mode
    return {"a": a, "b": b, "c": c, "empty": np.full(n, np.nan)}


FILLS = [{"fill": "median"}, {"fill": "mean"}, {"fill": "mode"}, {"fill": "constant", "fill_constant": -7.5}]
CLIPS = [{}, {"clip_percentiles": (1.0, 99.0)}, {"clip_values": (-4.0, None)}, {"clip_values": (None, 20.0)},
         {"clip_percentiles": (5.0, 95.0), "clip_to_null": True}, {"clip_values": (-1.0, 1.0), "clip_to_null": True}]
SCALES = ["zscore", "minmax", "none"]


@pytest.mark.parametrize("fill, clip, log1p, scale", list(itertools.product(FILLS, CLIPS, [False, True], SCALES)),
                         ids=lambda v: json.dumps(v, sort_keys=True))
def test_numeric_modes_bit_equal_to_the_reference(fill, clip, log1p, scale):
    cfg = {**fill, **clip, "log1p": log1p, "scale": scale, "null_flag": bool(log1p)}
    table = numeric_table(3)
    cols = list(table)
    got = tnum.NumericPreprocessor({c: cfg for c in cols}).fit(table, cols)
    want = jnum.NumericPreprocessor({c: cfg for c in cols}).fit(table, cols)
    assert got.to_dict() == want.to_dict()
    fresh = numeric_table(4, 200)
    assert_columns_equal(got.transform(fresh), want.transform(fresh))
    assert got.output_columns == want.output_columns


def test_numeric_state_loads_across_packages(tmp_path):
    cfg = {"a": {"fill": "mean", "clip_percentiles": (2.0, 98.0), "log1p": True, "scale": "minmax"},
           "b": {"fill": "constant", "fill_constant": 3.0, "clip_values": (-10.0, 10.0), "clip_to_null": True},
           "c": {"fill": "mode", "scale": "none", "null_flag": False}}
    table = numeric_table(5)
    fresh = numeric_table(6, 100)
    for fit_pkg, load_pkg in ((tnum, jnum), (jnum, tnum)):
        fitted = fit_pkg.NumericPreprocessor(cfg).fit(table, ["a", "b", "c"])
        fitted.save(tmp_path / "numeric.json")
        loaded = load_pkg.NumericPreprocessor.load(tmp_path / "numeric.json")
        assert_columns_equal(loaded.transform(fresh), fitted.transform(fresh))


def test_numeric_errors_match_the_reference():
    for pkg in (tnum, jnum):
        with pytest.raises(RuntimeError, match="fit"):
            pkg.NumericPreprocessor().transform({"a": np.zeros(2)})
        with pytest.raises(ValueError, match="unknown fill"):
            pkg.NumericPreprocessor({"a": {"fill": "bogus"}}).fit({"a": np.zeros(2)})
        with pytest.raises(ValueError, match="unknown scale"):
            pkg.NumericPreprocessor({"a": {"scale": "bogus"}}).fit({"a": np.zeros(2)})
        with pytest.raises(KeyError, match="missing"):
            pkg.NumericPreprocessor().fit({"a": np.zeros(2)}).transform({"b": np.zeros(2)})


def categorical_table(seed: int, n: int = 600) -> dict:
    rng = np.random.default_rng(seed)
    values = np.asarray([f"v{i}" for i in rng.zipf(1.6, n) % 40], object)
    values[rng.random(n) < 0.08] = None
    values[3], values[4], values[5], values[6] = "", "NaN", "null", float("nan")
    mixed = np.asarray([" Seoul ", "seoul", "BUSAN", "busan ", None, 7, 7.0, "7"] * (n // 8), object)
    return {"a": values, "mixed": mixed}


CATEGORICAL_CONFIGS = [
    {},
    {"rare_threshold": 3},
    {"rare_threshold_fraction": 0.02},
    {"max_vocab": 5},
    {"rare_threshold": 2, "max_vocab": 3, "null_flag": False},
    {"lowercase": True},
    {"strip": False, "lowercase": True},
]


@pytest.mark.parametrize("cfg", CATEGORICAL_CONFIGS, ids=lambda v: json.dumps(v, sort_keys=True))
def test_categorical_bit_equal_to_the_reference(cfg):
    table = categorical_table(7)
    got = tcat.CategoricalPreprocessor({c: cfg for c in table}).fit(table)
    want = jcat.CategoricalPreprocessor({c: cfg for c in table}).fit(table)
    assert got.to_dict() == want.to_dict()
    assert got.input_dims() == want.input_dims() and got.model_spec() == want.model_spec()
    # unseen values -> [UNKNOWN], seen-but-rare -> [RARE], nulls -> [NULL]
    fresh = categorical_table(8, 240)
    fresh["a"][:3] = ["never-seen", "v39", None]
    out = got.transform(fresh)
    assert_columns_equal(out, want.transform(fresh))
    assert out["a"][0] == tcat.UNKNOWN_ID and out["a"][2] == tcat.NULL_ID


def test_categorical_special_ids_match_the_reference():
    assert (tcat.NULL_TOKEN, tcat.RARE_TOKEN, tcat.UNKNOWN_TOKEN) == (jcat.NULL_TOKEN, jcat.RARE_TOKEN,
                                                                       jcat.UNKNOWN_TOKEN)
    assert (tcat.NULL_ID, tcat.RARE_ID, tcat.UNKNOWN_ID) == (jcat.NULL_ID, jcat.RARE_ID, jcat.UNKNOWN_ID)


def test_categorical_state_loads_across_packages(tmp_path):
    cfg = {"a": {"rare_threshold": 2, "max_vocab": 10}, "mixed": {"lowercase": True}}
    table, fresh = categorical_table(9), categorical_table(10, 160)
    for fit_pkg, load_pkg in ((tcat, jcat), (jcat, tcat)):
        fitted = fit_pkg.CategoricalPreprocessor(cfg).fit(table)
        fitted.save(tmp_path / "categorical.json")
        loaded = load_pkg.CategoricalPreprocessor.load(tmp_path / "categorical.json")
        assert_columns_equal(loaded.transform(fresh), fitted.transform(fresh))


def texts(seed: int, n: int = 60) -> list:
    rng = np.random.default_rng(seed)
    words = ["공사", "notice", "Road", "road", "bridge", "용역", "", "x"]
    out = [" ".join(rng.choice(words, rng.integers(0, 9))) for _ in range(n)]
    return out + ["  Leading and trailing  ", "ALL CAPS words", "", "one"]


@pytest.mark.parametrize("cfg", [{}, {"lowercase": True}, {"strip": False}, {"max_length": 3},
                                 {"normalize": False}], ids=lambda v: json.dumps(v, sort_keys=True))
def test_hash_embedder_bit_equal_to_the_reference(cfg):
    got = ttext.HashTextEmbedder(48).encode(texts(11), ttext.TextColumnConfig(**cfg))
    want = jtext.HashTextEmbedder(48).encode(texts(11), jtext.TextColumnConfig(**cfg))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_text_preprocessor_with_the_hash_embedder_matches_the_reference():
    table = {"title": np.asarray(["road works", None, float("nan"), "", "bridge 용역"], object),
             "body": np.asarray(["a", "b b", "c", "d", "e"], object)}
    cfg = {"title": {"add_flag": True, "max_length": 2}, "body": {}}
    got = ttext.TextPreprocessor(cfg, embedder=ttext.HashTextEmbedder(16)).transform(table)
    want = jtext.TextPreprocessor(cfg, embedder=jtext.HashTextEmbedder(16)).transform(table)
    assert_columns_equal(got, want)
    with pytest.raises(ValueError, match="null_strategy"):
        ttext.TextPreprocessor({"t": {"null_strategy": "zero"}}, embedder=ttext.HashTextEmbedder(4)).transform(
            {"t": np.asarray(["a"], object)})


REF_NUMERIC = {
    "bdgtamt": {"fill": "median", "log1p": True, "scale": "zscore", "add_flag": True, "clip": [0.5, 99.5]},
    "indstrytyevlrt": {"fill": 0, "log1p": False, "scale": "none", "add_flag": True, "clip_abs": [0.0, 100.0]},
    "totprdprcnum": {"fill": "mode", "log1p": False, "scale": "none", "add_flag": False, "clip_to_null": True},
}
REF_CATEGORICAL = {"bidmethdnm": {"encoding_method": "label"},
                   "ntceinsttcd": {"encoding_method": "label", "rare_threshold": 0.5, "add_flag": False}}
REF_TEXT = {"bidntcenm": {"use": True, "embedding_model": "some/model", "max_length": 16, "normalize": True,
                          "add_flag": True, "null_strategy": "empty"},
            "skipped": {"use": False}}


def test_reference_config_adapters_match_the_reference(tmp_path):
    def asdicts(cfgs):
        return {k: dataclasses.asdict(v) for k, v in cfgs.items()}

    path = tmp_path / "numeric.json"
    path.write_text(json.dumps(REF_NUMERIC))
    for src in (REF_NUMERIC, path):
        assert asdicts(tref.numeric_configs_from_reference(src)) == asdicts(jref.numeric_configs_from_reference(src))
    assert asdicts(tref.categorical_configs_from_reference(REF_CATEGORICAL)) == asdicts(
        jref.categorical_configs_from_reference(REF_CATEGORICAL))
    got, got_model = tref.text_configs_from_reference(REF_TEXT)
    want, want_model = jref.text_configs_from_reference(REF_TEXT)
    assert asdicts(got) == asdicts(want) and got_model == want_model == "some/model"
    for pkg in (tref, jref):
        with pytest.raises(ValueError, match="unsupported encoding_method"):
            pkg.categorical_configs_from_reference({"c": {"encoding_method": "onehot"}})
        with pytest.raises(ValueError, match="conflicting embedding_model"):
            pkg.text_configs_from_reference({"a": {"embedding_model": "m1"}, "b": {"embedding_model": "m2"}})
