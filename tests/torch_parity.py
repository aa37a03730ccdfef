"""Shared inputs for the parity tests of the PyTorch port against the JAX
package (tests/test_torch_*.py): a small schema with numeric, text and
categorical features, both packages' models at small width, and flax
variables with every leaf (BatchNorm statistics included) drawn from numpy,
so that a wrong map in the converter cannot hide behind init values."""

from __future__ import annotations

import dataclasses
import threading

import jax
import numpy as np

from jodalrob_twotower_torch import schema as torch_schema
from jodalrob_twotower_torch.config import ModelConfig as TorchModelConfig
from jodalrob_twotower_tpu import schema as jax_schema
from jodalrob_twotower_tpu.config import ModelConfig as JaxModelConfig

SCHEMA_DICT = {
    "notice": {
        "table": "notice",
        "pk": ["bidntceno", "bidntceord"],
        "numeric": ["n0", "n1", "n2", "n3"],
        "categorical": [
            {"name": "c0", "vocab_size": 5},
            {"name": "c1", "vocab_size": 130},
            {"name": "c2", "vocab_size": 1000},
        ],
        "text": [{"name": "title", "embed_dim": 12}],
    },
    "company": {
        "table": "company",
        "pk": ["bizno"],
        "numeric": ["m0", "m1"],
        "categorical": [{"name": "d0", "vocab_size": 9}, {"name": "d1", "vocab_size": 300}],
    },
}

MODEL_KW = dict(
    categorical_embedding_dim=8,
    dense_projection_dim=16,
    tower_hidden_dims=(64, 32),
    final_embedding_dim=16,
    dropout_rate=0.0,
)


def schemas():
    return (
        jax_schema.TwoTowerSchema.from_dict(SCHEMA_DICT),
        torch_schema.TwoTowerSchema.from_dict(SCHEMA_DICT),
    )


def model_configs(**overrides):
    kw = {**MODEL_KW, **overrides}
    return JaxModelConfig(**kw), TorchModelConfig(**kw)


def side_inputs(side, rng: np.random.Generator, n: int, *, out_of_range: bool = False):
    """(dense [n, dense_dim] f32, cat_ids [n, K] i32) for one side."""
    dense = rng.normal(size=(n, side.dense_dim)).astype(np.float32)
    hi = [v * 2 if out_of_range else v for v in side.vocab_sizes]
    lo = -3 if out_of_range else 0
    cat = np.stack([rng.integers(lo, h, size=n) for h in hi], axis=1).astype(np.int32)
    return dense, cat


def flax_variables(jax_model, jax_schema_, rng: np.random.Generator):
    """Init the flax model, then redraw every leaf from numpy: params
    N(0, 1/fan) and BatchNorm statistics with random means and variances."""
    from jodalrob_twotower_tpu.data.types import PairBatch, TowerBatch

    def batch(side):
        dense, cat = side_inputs(side, rng, 4)
        return TowerBatch(dense=dense, cat_ids=cat)

    variables = jax_model.init(
        jax.random.PRNGKey(0), PairBatch(batch(jax_schema_.notice), batch(jax_schema_.company))
    )

    def redraw(path, leaf):
        name = path[-1].key
        shape = np.shape(leaf)
        if name == "var":
            return (0.5 + rng.random(shape)).astype(np.float32)
        if name in ("mean", "bias"):
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        return (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(redraw, jax.device_get(variables))
    return {k: dict(v) for k, v in variables.items()}


def replace_cfg(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


DRAIN_TIMEOUT_S = 60


def drain(items, timeout: float = DRAIN_TIMEOUT_S) -> list:
    """Every item of ``items``, consumed on a thread that gets ``timeout``
    seconds: a hung worker or reader thread fails the test instead of
    running into the suite's clock. The consumer's exception is re-raised
    here."""
    out, err = [], []

    def consume():
        try:
            out.extend(items)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            err.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"not drained within {timeout} s"
    if err:
        raise err[0]
    return out
