"""The ETL slice as a whole on the CPU: raw tables (``chip_smoke``'s
generator of the card's ``etl`` phase, at a tiny size) -> both ETLs (the
JAX package's parquet ``run_pipeline`` + ``feature_store_from_pipeline``;
the port's in-memory ETL, the card's path) -> both stores, equal -> the JAX
``Trainer`` and the port's ``Trainer(device="cpu")`` from one flax init
carried over by ``convert.py``, dropout 0: the per-epoch train and
validation losses agree within 1e-4 relative, as
tests/test_torch_streaming_trainer.py requires."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from jodalrob_twotower_torch.config import DataConfig as TDataConfig
from jodalrob_twotower_torch.config import LossConfig as TLossConfig
from jodalrob_twotower_torch.config import OptimizerConfig as TOptimizerConfig
from jodalrob_twotower_torch.config import TrainConfig as TTrainConfig
from jodalrob_twotower_torch.convert import flax_to_state_dict
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel as TTwoTowerModel
from jodalrob_twotower_torch.schema import TwoTowerSchema as TTwoTowerSchema
from jodalrob_twotower_torch.train import trainer as ttrainer
from jodalrob_twotower_tpu.config import DataConfig as JDataConfig
from jodalrob_twotower_tpu.config import LossConfig as JLossConfig
from jodalrob_twotower_tpu.config import OptimizerConfig as JOptimizerConfig
from jodalrob_twotower_tpu.config import TrainConfig as JTrainConfig
from jodalrob_twotower_tpu.data.pipeline import assemble_pair_batch
from jodalrob_twotower_tpu.etl.pipeline import run_pipeline as j_run_pipeline
from jodalrob_twotower_tpu.etl.text import HashTextEmbedder as JHash
from jodalrob_twotower_tpu.etl.to_feature_store import feature_store_from_pipeline as j_store_from_pipeline
from jodalrob_twotower_tpu.models.two_tower import TwoTowerModel as JTwoTowerModel
from jodalrob_twotower_tpu.schema import TwoTowerSchema as JTwoTowerSchema
from jodalrob_twotower_tpu.schema import classify_columns as j_classify
from jodalrob_twotower_tpu.train.train_step import create_train_state
from jodalrob_twotower_tpu.train.trainer import Trainer as JTrainer

from torch_parity import model_configs

N_NOTICES, N_COMPANIES, N_PAIRS = 240, 200, 400
N_CATEGORIES, N_CLUSTERS, TEXT_DIM, CHUNK_ROWS = 12, 8, 16, 64
BATCH, N_INNER, EPOCHS = 32, 3, 2
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
def etl(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("etl_slice")
    metadata = chip_smoke.etl_metadata_csv(tmp / "metadata.csv", n_notice_numeric=3, n_notice_categorical=2,
                                           n_company_categorical=2, n_categories=N_CATEGORIES)
    ported = chip_smoke.etl_stores(metadata, N_NOTICES, N_COMPANIES, N_PAIRS, chunk_rows=CHUNK_ROWS,
                                   text_dim=TEXT_DIM, n_categories=N_CATEGORIES, n_clusters=N_CLUSTERS)
    reference = {}
    for name, table in zip(("notice", "company"), ported["raw"]):
        cls = j_classify(name, metadata)
        n = len(table[cls["pk"][0]])
        chunks = [{k: v[lo : lo + CHUNK_ROWS] for k, v in table.items()} for lo in range(0, n, CHUNK_ROWS)]
        j_run_pipeline(name, chunks, tmp / "jax", fit_table=table, pk_columns=cls["pk"],
                       numeric_columns=cls["numeric"], categorical_columns=[c for c, _ in cls["categorical"]],
                       text_columns=cls["text"] or None, text_embedder=JHash(TEXT_DIM))
        reference[name] = j_store_from_pipeline(tmp / "jax", name)
    return ported, reference


def test_both_etls_build_the_same_stores(etl):
    ported, reference = etl
    for name in ("notice", "company"):
        j_schema, j_store = reference[name]
        t_store = ported[name]["store"]
        assert ported[name]["schema"].to_dict() == j_schema.to_dict()
        np.testing.assert_array_equal(t_store.keys, j_store.keys)
        np.testing.assert_array_equal(t_store.dense, j_store.dense)
        np.testing.assert_array_equal(t_store.cat_ids, j_store.cat_ids)
    assert ported["notice"]["store"].dense.shape == (N_NOTICES, 2 * 3 + TEXT_DIM)
    assert ported["schema"].notice.vocab_sizes == (N_CATEGORIES + 3 + 10,) * 2


@pytest.fixture(scope="module")
def trained(etl):
    ported, reference = etl
    j_schema = JTwoTowerSchema(notice=reference["notice"][0], company=reference["company"][0])
    t_schema = TTwoTowerSchema.from_dict(j_schema.to_dict())
    j_stores = [reference[side][1] for side in ("notice", "company")]
    t_stores = [ported[side]["store"] for side in ("notice", "company")]
    pairs = ported["pairs"]
    train_pairs, val_pairs = pairs[:320], pairs[320:]
    j_mcfg, t_mcfg = model_configs(compute_dtype="float32", embedding_lookup="auto", dropout_rate=0.0)
    common = dict(temperature=0.2, use_fused_logits=False)
    j_cfg = JTrainConfig(model=j_mcfg, loss=JLossConfig(**common),
                         optimizer=JOptimizerConfig(learning_rate=3e-3, num_epochs=EPOCHS),
                         data=JDataConfig(batch_size=BATCH), results_csv="", seed=3)
    t_cfg = TTrainConfig(model=t_mcfg, loss=TLossConfig(**common),
                         optimizer=TOptimizerConfig(learning_rate=3e-3, num_epochs=EPOCHS),
                         data=TDataConfig(batch_size=BATCH), results_csv="", seed=3)
    kw = dict(corpus_eval=False, n_inner=N_INNER)

    j_model = JTwoTowerModel(j_schema, j_mcfg)
    example = assemble_pair_batch(*j_stores, train_pairs[:BATCH])
    init, _ = create_train_state(j_model, j_cfg, jax.random.PRNGKey(j_cfg.seed), example, 8)
    params0, stats0 = jax.device_get(init.params), jax.device_get(init.batch_stats)
    want = JTrainer(j_cfg, j_schema, *j_stores, log_fn=lambda *_: None).train(train_pairs, val_pairs, **kw)
    start = flax_to_state_dict(TTwoTowerModel(t_schema, t_mcfg), params0, stats0)

    def init_from_flax(self, generator):
        self.load_state_dict(start)
        return self

    mp = pytest.MonkeyPatch()
    mp.setattr(TTwoTowerModel, "init_flax", init_from_flax)
    try:
        got = ttrainer.Trainer(t_cfg, t_schema, *t_stores, device="cpu", log_fn=lambda *_: None).train(
            train_pairs, val_pairs, **kw)
    finally:
        mp.undo()
    return want, got


@pytest.mark.parametrize("key", ["train_loss", "val_loss"])
def test_per_epoch_losses_match_the_reference(trained, key):
    want, got = trained
    assert len(got.history) == len(want.history) == EPOCHS
    w = np.asarray([h[key] for h in want.history])
    g = np.asarray([h[key] for h in got.history])
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, w, rtol=LOSS_RTOL)


def test_the_slice_learns(trained):
    _, got = trained
    assert got.history[-1]["train_loss"] < got.history[0]["train_loss"]
    assert int(got.state.step) == EPOCHS * (320 // BATCH)
