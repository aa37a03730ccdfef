"""The port's data layer and retrieval service against the JAX package's:
schema and config JSON forms, the synthetic dataset bit for bit, and
``RetrievalService.search_keys`` end to end with converted weights (float32
compute, so both packages rank the same companies); plus the device rules
of the port's entry points."""

import dataclasses

import numpy as np
import pytest
import torch

from jodalrob_twotower_torch import config as t_config
from jodalrob_twotower_torch import resolve_device
from jodalrob_twotower_torch.convert import flax_to_state_dict
from jodalrob_twotower_torch.data.synthetic import make_synthetic_dataset as t_make_dataset
from jodalrob_twotower_torch.models import build_model as t_build_model
from jodalrob_twotower_torch.schema import reference_shaped_schema as t_reference_schema
from jodalrob_twotower_torch.schema import tiny_synthetic_schema as t_tiny_schema
from jodalrob_twotower_torch.serving import service as t_service
from jodalrob_twotower_torch.serving.index import BruteForceIndex, load_index, save_index
from jodalrob_twotower_torch.parallel.mesh import make_mesh
from jodalrob_twotower_tpu import config as j_config
from jodalrob_twotower_tpu.data.synthetic import make_synthetic_dataset as j_make_dataset
from jodalrob_twotower_tpu.models import build_model as j_build_model
from jodalrob_twotower_tpu.schema import reference_shaped_schema as j_reference_schema
from jodalrob_twotower_tpu.schema import tiny_synthetic_schema as j_tiny_schema
from jodalrob_twotower_tpu.serving import service as j_service

from torch_parity import MODEL_KW, flax_variables, schemas

DATA_KW = dict(n_notices=200, n_companies=300, n_pairs=500, n_clusters=8, seed=3)


def test_schema_json_forms_match_reference(tmp_path):
    j_schema, t_schema = schemas()
    assert t_schema.to_dict() == j_schema.to_dict()
    assert type(t_schema).from_dict(j_schema.to_dict()) == t_schema
    for t_fn, j_fn in ((t_reference_schema, j_reference_schema), (t_tiny_schema, j_tiny_schema)):
        assert t_fn().to_dict() == j_fn().to_dict()
    j_schema.to_json(tmp_path / "s.json")
    assert type(t_schema).from_json(tmp_path / "s.json") == t_schema


def test_config_json_forms_match_reference(tmp_path):
    cfg = j_config.TrainConfig(model=j_config.ModelConfig(tower_hidden_dims=(64, 32)), seed=5)
    cfg.to_json(tmp_path / "c.json")
    ported = t_config.TrainConfig.from_json(tmp_path / "c.json")
    assert ported.to_dict() == cfg.to_dict()
    assert t_config.TrainConfig().to_dict() == j_config.TrainConfig().to_dict()
    with pytest.raises(KeyError, match="unknown ModelConfig field"):
        t_config.TrainConfig.from_dict({"model": {"nope": 1}})


@pytest.mark.parametrize(
    "section,field,value",
    [
        ("ModelConfig", "compute_dtype", "float16"),
        ("ModelConfig", "embedding_lookup", "pallas"),
        ("ModelConfig", "embedding_grad", "sparse"),
        ("ModelConfig", "dropout_rng_impl", "philox"),
        ("LossConfig", "use_fused_logits", "yes"),
        ("OptimizerConfig", "adam_moment_dtype", "float16"),
        ("OptimizerConfig", "sparse_duplicate_handling", "none"),
        ("DataConfig", "device_store_dtype", "int8"),
        ("MeshConfig", "embedding_sharding", "rows"),
        ("MeshConfig", "store_sharding", "cols"),
        ("MeshConfig", "grad_compression", "int4"),
        ("MeshConfig", "compressed_negatives", "none"),
    ],
)
def test_config_validation_matches_reference(section, field, value):
    for module in (j_config, t_config):
        with pytest.raises(ValueError):
            getattr(module, section)(**{field: value})


def test_synthetic_dataset_bit_equal_to_reference():
    j_schema, t_schema = schemas()
    want = j_make_dataset(j_schema, **DATA_KW)
    got = t_make_dataset(t_schema, **DATA_KW)
    for name in ("pairs", "notice_cluster", "company_cluster"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for side in ("notice_store", "company_store"):
        g, w = getattr(got, side), getattr(want, side)
        for field in ("dense", "cat_ids", "keys"):
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field))
            assert getattr(g, field).dtype == getattr(w, field).dtype
        rows = np.array([5, 0, 199, 5])
        for a, b in zip(g.gather(rows), w.gather(rows)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(g.rows_for_keys(["3", "1"]), w.rows_for_keys(["3", "1"]))
    for a, b in zip(got.split(0.2, seed=1), want.split(0.2, seed=1)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def services():
    j_schema, t_schema = schemas()
    kw = {**MODEL_KW, "compute_dtype": "float32"}
    j_cfg = j_config.TrainConfig(model=j_config.ModelConfig(**kw))
    t_cfg = t_config.TrainConfig(model=t_config.ModelConfig(**kw))
    j_ds, t_ds = j_make_dataset(j_schema, **DATA_KW), t_make_dataset(t_schema, **DATA_KW)
    j_model, t_model = j_build_model(j_schema, j_cfg), t_build_model(t_schema, t_cfg)
    variables = flax_variables(j_model, j_schema, np.random.default_rng(21))
    j_state = j_service.FrozenState(params=variables["params"], batch_stats=variables["batch_stats"])
    t_state = t_service.FrozenState(
        flax_to_state_dict(t_model, variables["params"], variables["batch_stats"])
    )
    return (j_model, j_cfg, j_state, j_ds), (t_model, t_cfg, t_state, t_ds)


@pytest.mark.parametrize(
    "kw",
    [
        dict(index_kind="exact"),
        dict(index_kind="int8", corpus_chunk=128, rescore_depth=30, rescore_dtype="bfloat16"),
    ],
    ids=["exact", "int8-chunked-bf16-rescore"],
)
def test_search_keys_match_reference(services, kw, tmp_path):
    (j_model, j_cfg, j_state, j_ds), (t_model, t_cfg, t_state, t_ds) = services
    j_svc = j_service.RetrievalService(j_model, j_cfg, j_state, j_ds.company_store, **kw)
    t_svc = t_service.RetrievalService(t_model, t_cfg, t_state, t_ds.company_store, device="cpu", **kw)
    rows = np.arange(0, 200, 7)
    want = j_svc.search_keys(j_ds.notice_store.gather(rows), k=5)
    got = t_svc.search_keys(t_ds.notice_store.gather(rows), k=5)
    assert [[key for key, _ in r] for r in got] == [[key for key, _ in r] for r in want]
    np.testing.assert_allclose(
        [[s for _, s in r] for r in got], [[s for _, s in r] for r in want], rtol=1e-5, atol=1e-6
    )
    # the corpus encode equals the reference's, chunked differently
    corpus = t_svc._evaluator.encode_corpus(
        t_svc.state, t_ds.company_store.dense, t_ds.company_store.cat_ids, batch_size=64
    )
    ref = j_svc._evaluator.encode_corpus(j_state, j_ds.company_store.dense, j_ds.company_store.cat_ids)
    np.testing.assert_allclose(corpus.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    out = t_service.qps_bench(t_svc, t_ds.notice_store, k=5, batch_size=16, n_batches=3)
    assert out["qps"] > 0 and out["corpus_size"] == len(t_ds.company_store)
    # a saved index serves the same answers through prebuilt_index
    save_index(t_svc.index, tmp_path / "idx.npz")
    again = t_service.RetrievalService(
        t_model, t_cfg, t_state, t_ds.company_store, device="cpu",
        prebuilt_index=load_index(tmp_path / "idx.npz", device="cpu"),
    )
    assert again.search_keys(t_ds.notice_store.gather(rows), k=5) == got


def test_entry_points_default_to_cuda_and_raise_without_it(services, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, (t_model, t_cfg, t_state, t_ds) = services
    corpus = np.eye(4, dtype=np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BruteForceIndex(corpus)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_service.RetrievalService(t_model, t_cfg, t_state, t_ds.company_store)
    assert resolve_device("cpu") == torch.device("cpu")


def test_service_rejects_mesh_and_foreign_index(services):
    _, (t_model, t_cfg, t_state, t_ds) = services
    mesh = make_mesh(["cpu"])
    with pytest.raises(ValueError, match="prebuilt_index cannot be combined with a mesh"):
        t_service.RetrievalService(t_model, t_cfg, t_state, t_ds.company_store, mesh=mesh,
                                   prebuilt_index=BruteForceIndex(np.eye(4, dtype=np.float32), device="cpu"))
    with pytest.raises(ValueError, match="corpus_chunk is not supported with a mesh"):
        t_service.RetrievalService(t_model, t_cfg, t_state, t_ds.company_store, mesh=mesh, corpus_chunk=64)
    with pytest.raises(ValueError, match="index_kind"):
        t_service.RetrievalService(t_model, t_cfg, t_state, t_ds.company_store, index_kind="ivf", device="cpu")
    index = BruteForceIndex(np.eye(4, dtype=np.float32), device="cpu")
    index.device = torch.device("meta")
    with pytest.raises(ValueError, match="prebuilt_index lives on"):
        t_service.RetrievalService(
            t_model, t_cfg, t_state, t_ds.company_store, prebuilt_index=index, device="cpu"
        )
    state = t_service.FrozenState.from_model(t_model)
    assert set(state.state_dict) == set(t_model.state_dict()) and state.device == torch.device("cpu")
    assert dataclasses.is_dataclass(state)
