"""The port's evaluation path against the reference's, from the same flax
variables (every leaf drawn from numpy), stores and pairs: the eval step,
``Evaluator.evaluate`` / ``evaluate_indexed`` / ``encode_corpus_device``,
``corpus_retrieval_eval`` (flat and chunked), ``demonstrate_predictions``,
``qualitative_assessment``; the eval step with and without label
smoothing. (The label-smoothed loss's gradients against the reference's
kernels: tests/test_torch_fused_logits.py and test_torch_fused_stats.py.)

Tolerances:
* materialized float32 eval (both sides form S in f32): every metric 1e-5.
* fused eval (the port's statistics path: the plain versions of the
  kernels, bf16 operands) against the reference's eval step, which on the
  CPU takes its materialized float32 path: the loss 5e-4 and the
  similarities 2e-2 (S's operands rounded to bf16, 2^-9 relative, at
  1/tau = 5), as in tests/test_torch_train_step.py's f32-fused case; and
  against the reference's stats kernel in interpret mode on the same
  embeddings (bf16 on both sides): the rank metrics equal, similarities 1e-5.
* embeddings 1e-5; corpus ranks equal (recall and MRR equal).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.config import LossConfig as TLossConfig
from jodalrob_twotower_torch.config import TrainConfig as TTrainConfig
from jodalrob_twotower_torch.convert import flax_to_state_dict
from jodalrob_twotower_torch.data.types import PairBatch as TPairBatch
from jodalrob_twotower_torch.data.types import TowerBatch as TTowerBatch
from jodalrob_twotower_torch.evaluation import evaluator as tev
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel as TTwoTowerModel
from jodalrob_twotower_torch.serving.service import FrozenState
from jodalrob_twotower_torch.train import train_step as tts
from jodalrob_twotower_tpu.config import LossConfig as JLossConfig
from jodalrob_twotower_tpu.config import TrainConfig as JTrainConfig
from jodalrob_twotower_tpu.data.types import PairBatch, TowerBatch
from jodalrob_twotower_tpu.evaluation import evaluator as jev
from jodalrob_twotower_tpu.models.two_tower import TwoTowerModel as JTwoTowerModel
from jodalrob_twotower_tpu.ops import fused_logits as jfl
from jodalrob_twotower_tpu.train import train_step as jts

from torch_parity import flax_variables, model_configs, schemas, side_inputs

N_ROWS = 300
TAU = 0.2
RANK_METRICS = ("accuracy", "mrr", "auc", "recall@5", "recall@10")
SIM_METRICS = ("positive_similarity", "negative_similarity", "similarity_gap")


def _setup(*, fused, label_smoothing=0.0, final_dim=16):
    j_schema, t_schema = schemas()
    j_mcfg, t_mcfg = model_configs(compute_dtype="float32", final_embedding_dim=final_dim)
    j_cfg = JTrainConfig(model=j_mcfg, loss=JLossConfig(temperature=TAU, label_smoothing=label_smoothing,
                                                        use_fused_logits=fused))
    t_cfg = TTrainConfig(model=t_mcfg, loss=TLossConfig(temperature=TAU, label_smoothing=label_smoothing,
                                                        use_fused_logits=fused))
    rng = np.random.default_rng(31)
    j_model = JTwoTowerModel(j_schema, j_mcfg)
    variables = flax_variables(j_model, j_schema, rng)
    stores = {side: side_inputs(j_schema.side(side), rng, N_ROWS) for side in ("notice", "company")}
    example = PairBatch(
        TowerBatch(stores["notice"][0][:4], stores["notice"][1][:4]),
        TowerBatch(stores["company"][0][:4], stores["company"][1][:4]),
    )
    j_state, _ = jts.create_train_state(j_model, j_cfg, jax.random.PRNGKey(0), example, 10)
    j_state = j_state.replace(
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
    )
    t_model = TTwoTowerModel(t_schema, t_mcfg)
    t_state = FrozenState(flax_to_state_dict(t_model, variables["params"], variables["batch_stats"]))
    return dict(j_model=j_model, j_cfg=j_cfg, j_state=j_state, variables=variables,
                t_model=t_model, t_cfg=t_cfg, t_state=t_state, stores=stores)


def _batches(stores, idx):
    """(reference PairBatch, port PairBatch) of the pairs ``idx`` [B, 2]."""
    def side(name, col, tower, cast):
        return tower(cast(stores[name][0][idx[:, col]]), cast(stores[name][1][idx[:, col]]))

    return (
        PairBatch(side("notice", 0, TowerBatch, jnp.asarray), side("company", 1, TowerBatch, jnp.asarray)),
        TPairBatch(side("notice", 0, TTowerBatch, torch.from_numpy), side("company", 1, TTowerBatch, torch.from_numpy)),
    )


def _as_floats(m):
    return {k: float(v) for k, v in m.items()}


def test_eval_step_materialized_f32_matches_the_reference():
    s = _setup(fused=False)
    idx = np.random.default_rng(1).integers(0, N_ROWS, size=(64, 2))
    j_batch, t_batch = _batches(s["stores"], idx)
    want = _as_floats(jts.make_eval_step(s["j_model"], s["j_cfg"], jit=False)(s["j_state"], j_batch))
    got = _as_floats(tts.make_eval_step(s["t_model"], s["t_cfg"])(s["t_state"], t_batch))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_eval_step_fused_matches_the_reference(label_smoothing):
    """D = 128 and B = 128, inside the kernels' envelope: the port takes the
    statistics path (K8 + K5's plain versions) for its metrics."""
    s = _setup(fused=True, label_smoothing=label_smoothing, final_dim=128)
    idx = np.random.default_rng(2).integers(0, N_ROWS, size=(128, 2))
    j_batch, t_batch = _batches(s["stores"], idx)
    want = _as_floats(jts.make_eval_step(s["j_model"], s["j_cfg"], jit=False)(s["j_state"], j_batch))
    got = _as_floats(tts.make_eval_step(s["t_model"], s["t_cfg"])(s["t_state"], t_batch))
    assert set(got) == set(want)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=0, atol=5e-4)
    for k in SIM_METRICS:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-2, err_msg=k)
    # bf16 on both sides: the reference's stats kernel on its own embeddings
    n_emb, c_emb = s["j_model"].apply(s["variables"], j_batch, train=False)
    kernel = _as_floats(jfl.fused_in_batch_metrics(n_emb, c_emb, temperature=TAU, interpret=True))
    assert 0 < kernel["recall@10"] < 1  # the ranks spread: the check has teeth
    for k in RANK_METRICS:
        assert got[k] == pytest.approx(kernel[k], abs=1e-6), k
    for k in SIM_METRICS:
        np.testing.assert_allclose(got[k], kernel[k], rtol=0, atol=1e-5, err_msg=k)


def test_evaluate_and_evaluate_indexed_match_the_reference():
    """Five batches of 32: ``evaluate`` on host batches, and
    ``evaluate_indexed`` over the stores with stacks of 2, whose final stack
    starts early (batches 3-4 after 0-1 and 2-3) and drops its covered head."""
    s = _setup(fused=False)
    pairs = np.random.default_rng(3).integers(0, N_ROWS, size=(5 * 32 + 7, 2))
    j_ev, t_ev = jev.Evaluator(s["j_model"], s["j_cfg"]), tev.Evaluator(s["t_model"], s["t_cfg"])
    batches = [_batches(s["stores"], pairs[i * 32 : (i + 1) * 32]) for i in range(5)]
    want = j_ev.evaluate(s["j_state"], [b[0] for b in batches])
    got = t_ev.evaluate(s["t_state"], [b[1] for b in batches])
    assert set(got) == set(want) and got["num_batches"] == 5
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5, err_msg=k)

    j_stores = [tuple(jnp.asarray(x) for x in s["stores"][side]) for side in ("notice", "company")]
    t_stores = [tuple(torch.from_numpy(x) for x in s["stores"][side]) for side in ("notice", "company")]
    want_idx = j_ev.evaluate_indexed(s["j_state"], pairs, *j_stores, batch_size=32, stack=2)
    got_idx = t_ev.evaluate_indexed(s["t_state"], pairs, *t_stores, batch_size=32, stack=2)
    assert set(got_idx) == set(want_idx) and got_idx["num_batches"] == 5
    for k in want_idx:
        np.testing.assert_allclose(got_idx[k], want_idx[k], rtol=0, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got_idx[k], got[k], rtol=0, atol=1e-6, err_msg=k)  # the same five batches


def test_encode_corpus_device_matches_the_reference():
    """300 rows in chunks of 128: the third chunk starts at 172 and its
    overlapping head is dropped; 290 of the 300 rows are kept."""
    s = _setup(fused=False)
    j_ev, t_ev = jev.Evaluator(s["j_model"], s["j_cfg"]), tev.Evaluator(s["t_model"], s["t_cfg"])
    store = s["stores"]["company"]
    want = np.asarray(j_ev.encode_corpus_device(s["j_state"], tuple(jnp.asarray(x) for x in store), 290, chunk=128))
    got = t_ev.encode_corpus_device(s["t_state"], tuple(torch.from_numpy(x) for x in store), 290, chunk=128)
    assert got.shape == want.shape == (290, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    host = t_ev.encode_corpus(s["t_state"], *store, batch_size=64)[:290]
    np.testing.assert_allclose(got.numpy(), host.numpy(), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def retrieval():
    rng = np.random.default_rng(4)
    corpus = rng.normal(size=(700, 16)).astype(np.float32)
    positives = rng.integers(0, 700, size=96)
    # queries near their positive, at distances that spread the ranks
    queries = corpus[positives] + rng.uniform(0.5, 6.0, size=(96, 1)) * rng.normal(size=(96, 16))
    return queries.astype(np.float32), corpus, positives


@pytest.mark.parametrize("corpus_chunk", [None, 256], ids=["flat", "chunked"])
def test_corpus_retrieval_eval_matches_the_reference(retrieval, corpus_chunk):
    queries, corpus, positives = retrieval
    ks = (1, 10, 100)
    want = jev.corpus_retrieval_eval(jnp.asarray(queries), jnp.asarray(corpus), positives, ks=ks,
                                     query_chunk=40, corpus_chunk=corpus_chunk)
    got = tev.corpus_retrieval_eval(torch.from_numpy(queries), torch.from_numpy(corpus), positives, ks=ks,
                                    query_chunk=40, corpus_chunk=corpus_chunk)
    assert 0 < want.recall[10] < want.recall[100] < 1  # the ranks spread
    assert got.recall == want.recall and got.mrr == pytest.approx(want.mrr, abs=1e-12)
    assert (got.num_queries, got.corpus_size) == (want.num_queries, want.corpus_size) == (96, 700)
    flat = tev.corpus_retrieval_eval(queries, corpus, positives, ks=ks)  # numpy in, one query chunk
    assert flat.recall == got.recall and flat.mrr == pytest.approx(got.mrr, abs=1e-12)


def test_demonstrate_predictions_matches_the_reference(retrieval):
    queries, corpus, _ = retrieval
    keys = [f"company-{i}" for i in range(len(corpus))]
    want = jev.demonstrate_predictions(jnp.asarray(queries[:5]), jnp.asarray(corpus), k=7, corpus_keys=keys)
    got = tev.demonstrate_predictions(torch.from_numpy(queries[:5]), torch.from_numpy(corpus), k=7, corpus_keys=keys)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g["query"] == w["query"]
        assert [x["candidate"] for x in g["top_k"]] == [x["candidate"] for x in w["top_k"]]
        np.testing.assert_allclose([x["score"] for x in g["top_k"]], [x["score"] for x in w["top_k"]], rtol=1e-6)


@pytest.mark.parametrize(
    "metrics",
    [
        {"accuracy": 0.5, "similarity_gap": 0.9},
        {"accuracy": 0.05, "similarity_gap": 0.1},
        {"accuracy": 0.02},
        {"accuracy": 0.001, "similarity_gap": -0.2},
    ],
    ids=["excellent", "good", "weak", "random"],
)
def test_qualitative_assessment_matches_the_reference(metrics):
    assert tev.qualitative_assessment(metrics, 128) == jev.qualitative_assessment(metrics, 128)
