"""Bench-vs-product parity guard for the port's headline bench
(``python -m jodalrob_twotower_torch.bench``), as tests/test_bench_config.py
guards the reference's bench.py: the benched config is a plain
``TrainConfig()`` whose "auto" knobs resolve on CUDA to the kernel path, and
it is the reference's default config field for field."""

import dataclasses

import torch

from jodalrob_twotower_torch import bench
from jodalrob_twotower_torch.config import TrainConfig
from jodalrob_twotower_torch.models.embedding import EmbeddingCollection, resolve_lookup_mode, table_layout
from jodalrob_twotower_torch.schema import reference_shaped_schema
from jodalrob_twotower_torch.train.loss import resolve_use_fused
from jodalrob_twotower_torch.train.train_step import resolve_dropout_rng_impl, resolve_store_dtype
from jodalrob_twotower_tpu.config import TrainConfig as JaxTrainConfig


def test_bench_flagship_config_is_the_default_config():
    assert bench.flagship_config() == TrainConfig()
    assert bench.flagship_config().to_dict() == JaxTrainConfig().to_dict()


def test_bench_workload_is_the_reference_bench_workload():
    """bench.py:58-90: B=8192, 16 steps per call, 100k x 100k, 400k pairs."""
    assert (bench.BATCH_SIZE, bench.N_INNER) == (8192, 16)
    assert (bench.N_NOTICES, bench.N_COMPANIES, bench.N_PAIRS, bench.N_CLUSTERS) == (100_000, 100_000, 400_000, 256)


def test_auto_knobs_resolve_to_the_kernel_path_on_cuda():
    cfg = TrainConfig()
    assert resolve_store_dtype(cfg) is torch.bfloat16
    assert resolve_use_fused(cfg.loss, "cuda") is True
    assert resolve_use_fused(cfg.loss, "cpu") is False
    assert resolve_dropout_rng_impl(cfg.model) == "threefry"
    assert resolve_lookup_mode(cfg.model) == "auto"
    schema = reference_shaped_schema()
    for side in (schema.notice, schema.company):
        _, rows = table_layout(side.vocab_sizes)
        assert rows <= EmbeddingCollection.DENSE_GRAD_MAX_ROWS  # within the dense envelope
    f32 = cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    assert resolve_lookup_mode(f32.model) == "gather" and resolve_store_dtype(f32) is None
