"""The port's from-scratch init (``TwoTowerModel.init_flax``) against the
reference's ``model.init`` (through ``create_train_state``) at the reference
shapes: ``TrainConfig()`` on ``reference_shaped_schema()``.

* every Dense kernel and table: the port's sample std within 3% of flax's,
  or, for a leaf too small for a 3% comparison of two samples to be
  meaningful, within four standard errors of the difference of two sample
  stds (sqrt(1/n) of the std for n entries: the company tower's 1 x 128
  numeric projection has 128 entries, whose sample std scatters by 6%); both
  means within four standard errors of 0;
* the truncation: no kernel entry past two of the pre-truncation std
  (sqrt(1/fan_in) / 0.87962566) on either side, and the pooled standardized
  kernels of all layers within 1% of each other in std (0.87962566 x the
  pre-truncation std, flax's variance-preserving factor);
* biases, BatchNorm scale and bias, running mean and variance exactly 0, 1,
  0 and 1 on both sides; tables untruncated N(0, 1/D).
"""

import jax
import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.config import TrainConfig as TTrainConfig
from jodalrob_twotower_torch.convert import state_dict_to_flax
from jodalrob_twotower_torch.models import build_model
from jodalrob_twotower_torch.schema import reference_shaped_schema as t_reference_schema
from jodalrob_twotower_tpu.config import TrainConfig as JTrainConfig
from jodalrob_twotower_tpu.data.types import PairBatch, TowerBatch
from jodalrob_twotower_tpu.models.two_tower import TwoTowerModel as JTwoTowerModel
from jodalrob_twotower_tpu.schema import reference_shaped_schema as j_reference_schema
from jodalrob_twotower_tpu.train.train_step import create_train_state

TRUNC = 0.87962566103423978
STD_RTOL = 0.03


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def both():
    schema = j_reference_schema()
    cfg = JTrainConfig()

    def example(side):
        return TowerBatch(np.zeros((2, side.dense_dim), np.float32), np.zeros((2, side.num_categorical), np.int32))

    state, _ = create_train_state(JTwoTowerModel(schema, cfg.model), cfg, jax.random.PRNGKey(42),
                                  PairBatch(example(schema.notice), example(schema.company)), 10)
    model = build_model(t_reference_schema(), TTrainConfig()).init_flax(torch.Generator().manual_seed(42))
    params, stats = state_dict_to_flax(model, model.state_dict())
    j_params, j_stats = jax.device_get(state.params), jax.device_get(state.batch_stats)
    return (_leaves(j_params), _leaves(j_stats)), (_leaves(params), _leaves(stats))


def test_leaf_names_and_shapes_match(both):
    (jp, js), (tp, ts) = both
    assert {k: v.shape for k, v in jp.items()} == {k: v.shape for k, v in tp.items()}
    assert {k: v.shape for k, v in js.items()} == {k: v.shape for k, v in ts.items()}


def test_kernels_and_tables_have_flax_statistics(both):
    (jp, _), (tp, _) = both
    weights = [k for k in jp if k.endswith("/kernel") or k.endswith("/table")]
    assert len(weights) == 11  # 9 Dense kernels and 2 tables
    for k in weights:
        n = jp[k].size
        # two sample stds of n entries each differ by about std * sqrt(1/n)
        tol = max(STD_RTOL, 4.0 / np.sqrt(n))
        assert abs(tp[k].std() - jp[k].std()) <= tol * jp[k].std(), (k, tp[k].std(), jp[k].std(), tol)
        for w in (jp[k], tp[k]):
            assert abs(w.mean()) <= 4.0 * w.std() / np.sqrt(n), (k, w.mean())
        fan_in = jp[k].shape[0]
        if k.endswith("/table"):  # N(0, 1/D), not truncated: some entry lies past 2 sigma
            want = 1.0 / np.sqrt(jp[k].shape[1])
            assert abs(tp[k].std() - want) <= STD_RTOL * want, k
            assert np.abs(tp[k]).max() > 3 * want, k
        else:
            sigma = np.sqrt(1.0 / fan_in) / TRUNC
            for w in (jp[k], tp[k]):
                assert np.abs(w).max() <= 2.0 * sigma * (1 + 1e-6), (k, np.abs(w).max() / sigma)


def test_pooled_kernels_are_flax_truncated_normal(both):
    (jp, _), (tp, _) = both

    def pooled(leaves):
        return np.concatenate([
            (w / (np.sqrt(1.0 / w.shape[0]) / TRUNC)).ravel()
            for k, w in sorted(leaves.items()) if k.endswith("/kernel")
        ])

    zj, zt = pooled(jp), pooled(tp)
    assert zj.size == zt.size > 900_000
    assert abs(zt.std() - zj.std()) <= 0.01 * zj.std(), (zt.std(), zj.std())
    assert abs(zt.std() - TRUNC) <= 0.01 * TRUNC, zt.std()
    assert np.abs(zt).max() <= 2.0 + 1e-6 and np.abs(zj).max() <= 2.0 + 1e-6
    assert np.abs(zt).max() > 1.99  # the draw fills the truncated range


def test_biases_and_batchnorm_are_exact(both):
    (jp, js), (tp, ts) = both
    for k in jp:
        if k.endswith("/bias"):
            assert not tp[k].any() and not jp[k].any(), k
        elif k.endswith("/scale"):
            assert (tp[k] == 1).all() and (jp[k] == 1).all(), k
    assert js and set(js) == set(ts)
    for k in js:
        want = 1.0 if k.endswith("/var") else 0.0
        assert (ts[k] == want).all() and (js[k] == want).all(), k


def test_init_is_a_function_of_the_seed():
    cfg = TTrainConfig()

    def init(seed):
        return build_model(t_reference_schema(), cfg).init_flax(torch.Generator().manual_seed(seed)).state_dict()

    a, b, c = init(3), init(3), init(4)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["notice_tower.head.weight"], c["notice_tower.head.weight"])
