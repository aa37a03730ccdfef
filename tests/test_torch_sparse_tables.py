"""The port's sparse-table training (train/sparse_tables.py) against the
reference's, mirroring tests/test_sparse_tables.py: the rowwise Adagrad
update on unique and duplicate rows, both branches of the duplicate sums,
the sparse step against the reference's sparse step from a converted state,
the sparse step against the port's dense step, deferred windows, and
training that learns. Inputs are numpy arrays handed to both packages;
float32 compute, dropout 0, no BatchNorm, the scatter table gradient (the
reference's sparse test config).

Tolerances: the update functions 2e-6 relative (float32 on both sides, the
same operations; rsqrt may differ in the last bit, 1.2e-6 of a value near
0.5); the prefix-sum branch
2e-4 relative and 1e-5 absolute against the scatter branch, as the
reference holds it (differences of prefix sums over 512 rows). Steps: the
loss 1e-5 relative, tables 1e-6 absolute (values ~0.35, updates ~1e-3),
accumulators 1e-5 relative, dense params 1e-6 absolute after two Adam steps
of 1e-3 (float32 towers summed in another order; no entry's gradient is
near zero without BatchNorm).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.config import LossConfig as TLossConfig
from jodalrob_twotower_torch.config import ModelConfig as TModelConfig
from jodalrob_twotower_torch.config import OptimizerConfig as TOptimizerConfig
from jodalrob_twotower_torch.config import TrainConfig as TTrainConfig
from jodalrob_twotower_torch.convert import flax_to_sparse_state, state_dict_to_flax
from jodalrob_twotower_torch.models.embedding import absolute_rows as t_absolute_rows
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel as TTwoTowerModel
from jodalrob_twotower_torch.schema import tiny_synthetic_schema as t_tiny_schema
from jodalrob_twotower_torch.train import sparse_tables as tst
from jodalrob_twotower_torch.train import train_step as tts
from jodalrob_twotower_tpu.config import LossConfig, ModelConfig, OptimizerConfig, TrainConfig
from jodalrob_twotower_tpu.data.pipeline import assemble_pair_batch
from jodalrob_twotower_tpu.data.synthetic import make_synthetic_dataset
from jodalrob_twotower_tpu.models.two_tower import TwoTowerModel
from jodalrob_twotower_tpu.schema import tiny_synthetic_schema
from jodalrob_twotower_tpu.train import sparse_tables as jst
from jodalrob_twotower_tpu.train.train_step import device_store

_MODEL_KW = dict(
    categorical_embedding_dim=8,
    dense_projection_dim=16,
    tower_hidden_dims=(32, 16),
    final_embedding_dim=8,
    dropout_rate=0.0,
    use_batch_norm=False,
    compute_dtype="float32",
    embedding_grad="scatter",
)
_CFG = TrainConfig(
    model=ModelConfig(**_MODEL_KW),
    loss=LossConfig(temperature=0.2),
    optimizer=OptimizerConfig(learning_rate=1e-3, warmup_ratio=0.0),
)
_T_CFG = TTrainConfig(
    model=TModelConfig(**_MODEL_KW),
    loss=TLossConfig(temperature=0.2),
    optimizer=TOptimizerConfig(learning_rate=1e-3, warmup_ratio=0.0),
)


def _t_stores(ds):
    return tuple(
        (torch.from_numpy(np.ascontiguousarray(s.dense)), torch.from_numpy(np.ascontiguousarray(s.cat_ids)))
        for s in (ds.notice_store, ds.company_store)
    )


def _t_model(schema_args, seed=0):
    return TTwoTowerModel(t_tiny_schema(**schema_args), _T_CFG.model).init_weights(torch.Generator().manual_seed(seed))


_TINY = dict(n_categorical=4, vocab_size=50, n_numeric=8)  # tests/conftest.py tiny_dataset
_UNIQUE = dict(n_categorical=3, vocab_size=512, n_numeric=6)


@pytest.fixture(scope="module")
def unique_id_dataset():
    """Categorical ids distinct per feature within any 64-row batch (id ==
    row), so the per-occurrence update is exactly the dense update."""
    ds = make_synthetic_dataset(
        tiny_synthetic_schema(**_UNIQUE), n_notices=512, n_companies=512, n_pairs=2048, n_clusters=16, seed=3
    )
    for store in (ds.notice_store, ds.company_store):
        store.cat_ids[:] = np.arange(512)[:, None]
    return ds


def test_absolute_rows():
    ids = np.asarray([[0, 0], [49, 199], [100, 500], [-3, -1]], np.int32)
    got = t_absolute_rows((50, 200), torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, [[0, 128], [49, 128 + 199], [49, 128 + 199], [0, 128]])
    np.testing.assert_array_equal(got, np.asarray(jst.absolute_rows((50, 200), jnp.asarray(ids))))


def _both_updates(table, acc, rows, g, *, lr, eps, dedup):
    want = jst.sparse_rowwise_adagrad_update(
        jst.SparseTable(table=jnp.asarray(table), accumulator=jnp.asarray(acc)),
        jnp.asarray(rows), jnp.asarray(g), lr=lr, eps=eps, dedup=dedup,
    )
    st = tst.SparseTable(torch.from_numpy(table.copy()), torch.from_numpy(acc.copy()))
    got = tst.sparse_rowwise_adagrad_update(st, torch.from_numpy(rows), torch.from_numpy(g), lr=lr, eps=eps,
                                            dedup=dedup)
    assert got is st  # in place
    return got, want


def test_sparse_adagrad_update_exact_unique():
    table, acc = np.ones((64, 4), np.float32), np.full((64, 1), 0.1, np.float32)
    rows = np.asarray([3, 10], np.int32)
    g = np.asarray([[1.0, 1, 1, 1], [2, 0, 0, 0]], np.float32)
    got, want = _both_updates(table, acc, rows, g, lr=0.5, eps=0.0, dedup=True)
    np.testing.assert_allclose(float(got.accumulator[3, 0]), 1.1, rtol=1e-6)
    np.testing.assert_allclose(got.table[3].numpy(), 1.0 - 0.5 / np.sqrt(1.1), rtol=1e-6)
    np.testing.assert_allclose(float(got.accumulator[10, 0]), 0.1 + 1.0, rtol=1e-6)
    np.testing.assert_array_equal(got.table[0].numpy(), np.ones(4))  # untouched rows unchanged
    np.testing.assert_allclose(float(got.accumulator[0, 0]), 0.1)
    np.testing.assert_allclose(got.table.numpy(), np.asarray(want.table), rtol=2e-6)
    np.testing.assert_allclose(got.accumulator.numpy(), np.asarray(want.accumulator), rtol=2e-6)


@pytest.mark.parametrize("branch", ["segment_sum", "cumsum"])
def test_segment_sum_duplicates_matches_reference(monkeypatch, branch):
    """Both branches (the prefix-sum one forced by lowering the threshold
    on both sides): the same unique rows in the same slots, the same sums
    to the stated tolerance, zero grads in the sentinel slots."""
    if branch == "cumsum":
        monkeypatch.setattr(jst, "_DEDUP_CUMSUM_MIN_ROWS", 1)
        monkeypatch.setattr(tst, "_DEDUP_CUMSUM_MIN_ROWS", 1)
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 64, size=512).astype(np.int32)
    g = rng.normal(size=(512, 8)).astype(np.float32)
    u_want, g_want = (np.asarray(x) for x in jst.segment_sum_duplicates(jnp.asarray(rows), jnp.asarray(g), sentinel=256))
    u_got, g_got = (x.numpy() for x in tst.segment_sum_duplicates(torch.from_numpy(rows), torch.from_numpy(g), 256))
    np.testing.assert_array_equal(u_got, u_want)
    valid = u_got < 256
    dense = np.zeros((64, 8), np.float32)
    np.add.at(dense, rows, g)
    np.testing.assert_allclose(g_got[valid], dense[u_got[valid]], rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(g_got[valid], g_want[valid], rtol=2e-4, atol=1e-5)
    assert np.all(g_got[~valid] == 0.0) and valid.sum() == len(np.unique(rows))


def test_segment_sum_duplicates_small():
    rows = torch.tensor([5, 3, 5, 5, 9, 3], dtype=torch.int32)
    g = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    urows, gsum = tst.segment_sum_duplicates(rows, g, sentinel=64)
    got = {int(r): gsum[i].tolist() for i, r in enumerate(urows) if r != 64}
    assert got == {3: [2 + 10, 3 + 11], 5: [0 + 4 + 6, 1 + 5 + 7], 9: [8.0, 9.0]}
    pad = urows == 64
    assert int(pad.sum()) == 3 and bool((gsum[pad] == 0).all())


@pytest.mark.parametrize("dedup", [True, False], ids=["exact", "per_occurrence"])
def test_sparse_adagrad_update_with_duplicates(dedup):
    """dedup=True on a duplicate-heavy batch is the dense rowwise Adagrad of
    the summed gradient; both modes match the reference's update."""
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 16, size=48).astype(np.int32)
    g = rng.normal(size=(48, 4)).astype(np.float32)
    table = rng.normal(size=(64, 4)).astype(np.float32)
    acc = np.full((64, 1), 0.1, np.float32)
    got, want = _both_updates(table, acc, rows, g, lr=0.5, eps=1e-10, dedup=dedup)
    np.testing.assert_allclose(got.accumulator.numpy(), np.asarray(want.accumulator), rtol=2e-6)
    np.testing.assert_allclose(got.table.numpy(), np.asarray(want.table), rtol=2e-6, atol=1e-7)
    if dedup:
        summed = np.zeros((64, 4), np.float32)
        np.add.at(summed, rows, g)
        acc_want = 0.1 + (summed**2).mean(axis=1, keepdims=True)
        np.testing.assert_allclose(got.accumulator.numpy(), acc_want, rtol=1e-5)
        np.testing.assert_allclose(got.table.numpy(), table - 0.5 * summed / np.sqrt(acc_want + 1e-10),
                                   rtol=1e-5, atol=1e-7)


def _pairs(kind):
    if kind == "duplicates":  # vocab 50 across 64 rows, repeated store rows on both sides
        return np.stack([np.arange(64) % 40, 64 + (np.arange(64) % 48)], axis=1).astype(np.int32)
    return np.stack([np.arange(64), np.arange(64, 128)], axis=1).astype(np.int32)


def _converted(ds, schema_args):
    """The reference's fresh sparse state and the port's, converted from it."""
    model = TwoTowerModel(ds.schema, _CFG.model)
    batch = assemble_pair_batch(ds.notice_store, ds.company_store, ds.pairs[:64])
    j_state, j_tx = jst.create_sparse_train_state(model, _CFG, jax.random.PRNGKey(_CFG.seed), batch, 100)
    tables = {
        tower: (np.asarray(t.table), np.asarray(t.accumulator))
        for tower, t in (("notice_tower", j_state.notice_table), ("company_tower", j_state.company_table))
    }
    t_model = TTwoTowerModel(t_tiny_schema(**schema_args), _T_CFG.model)
    t_state, t_tx = flax_to_sparse_state(
        t_model, _T_CFG, jax.device_get(j_state.dense_params), jax.device_get(j_state.batch_stats), tables, 100,
        device="cpu",
    )
    return model, j_state, j_tx, t_model, t_state, t_tx


def _dense_leaves(t_model, t_state):
    params, _ = state_dict_to_flax(t_model, t_state.state_dict)
    return {f"{tw}/{k}/{p}": v for tw, layers in params.items() for k, ps in layers.items() if k != "embeddings"
            for p, v in ps.items()}


@pytest.mark.parametrize("kind", ["duplicates", "unique"])
def test_sparse_steps_match_the_reference(request, kind):
    """Two sparse steps from one converted state on the same pair indices:
    losses, tables, accumulators and dense params."""
    ds, schema_args = ((request.getfixturevalue("tiny_dataset"), _TINY) if kind == "duplicates"
                       else (request.getfixturevalue("unique_id_dataset"), _UNIQUE))
    model, j_state, j_tx, t_model, t_state, t_tx = _converted(ds, schema_args)
    idx = _pairs(kind)
    j_step = jst.make_sparse_train_step(model, _CFG, j_tx, 100, donate=False)
    t_step = tst.make_sparse_train_step(t_model, _T_CFG, t_tx, 100)
    n_store, c_store = device_store(ds.notice_store), device_store(ds.company_store)
    t_n, t_c = _t_stores(ds)
    for i in range(2):
        shifted = (idx + 7 * i) % 512 if kind == "unique" else idx
        j_state, j_m = j_step(j_state, jnp.asarray(shifted), n_store, c_store)
        t_state, t_m = t_step(t_state, torch.from_numpy(shifted.astype(np.int64)), t_n, t_c)
        np.testing.assert_allclose(float(t_m["loss"]), float(j_m["loss"]), rtol=1e-5)
    assert t_state.step == int(j_state.step) == 2
    for side in ("notice_table", "company_table"):
        got, want = getattr(t_state, side), getattr(j_state, side)
        np.testing.assert_allclose(got.table.numpy(), np.asarray(want.table), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.accumulator.numpy(), np.asarray(want.accumulator), rtol=1e-5)
        assert np.any(got.accumulator.numpy() != np.float32(_CFG.optimizer.adagrad_init_accumulator))
    got = _dense_leaves(t_model, t_state)
    want = {f"{tw}/{k}/{p}": np.asarray(v) for tw, layers in jax.device_get(j_state.dense_params).items()
            for k, ps in layers.items() for p, v in ps.items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind", ["duplicates", "unique"])
def test_sparse_step_matches_dense_step(request, kind):
    """The port's sparse step against its own dense step (the gather's
    scatter and rowwise Adagrad over the whole table) from the same weights:
    equal on a batch with duplicate ids too, thanks to the exact dedup."""
    ds, schema_args = ((request.getfixturevalue("tiny_dataset"), _TINY) if kind == "duplicates"
                       else (request.getfixturevalue("unique_id_dataset"), _UNIQUE))
    t_model = _t_model(schema_args)
    idx = torch.from_numpy(_pairs(kind).astype(np.int64))
    t_n, t_c = _t_stores(ds)
    if kind == "duplicates":
        rows = t_absolute_rows(t_model.schema.notice.vocab_sizes, t_n[1][idx[:, 0]]).reshape(-1)
        assert len(torch.unique(rows)) < len(rows)  # the batch really repeats rows
    dense, d_tx = tts.create_train_state(t_model, _T_CFG, 0, 100, device="cpu")
    dense, d_m = tts.make_indexed_train_step(t_model, _T_CFG, d_tx, with_metrics=False)(dense, idx, t_n, t_c)
    sparse, s_tx = tst.create_sparse_train_state(t_model, _T_CFG, 0, 100, device="cpu")
    sparse, s_m = tst.make_sparse_train_step(t_model, _T_CFG, s_tx, 100)(sparse, idx, t_n, t_c)
    np.testing.assert_allclose(float(s_m["loss"]), float(d_m["loss"]), rtol=1e-6)
    for key, side in tst.TABLE_KEYS.items():
        np.testing.assert_allclose(getattr(sparse, side).table.numpy(), dense.params[key].numpy(), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(getattr(sparse, side).accumulator.numpy(),
                                   dense.opt_state["acc"][key].numpy(), rtol=1e-5)
    for k, v in sparse.dense_params.items():
        np.testing.assert_allclose(v.numpy(), dense.params[k].numpy(), rtol=1e-5, atol=1e-7, err_msg=k)


def test_deferred_window_of_one_matches_per_step(unique_id_dataset):
    ds = unique_id_dataset
    t_model = _t_model(_UNIQUE)
    idx = torch.from_numpy(_pairs("unique").astype(np.int64))
    t_n, t_c = _t_stores(ds)
    s1, tx1 = tst.create_sparse_train_state(t_model, _T_CFG, 0, 100, device="cpu")
    s1, m1 = tst.make_sparse_train_step(t_model, _T_CFG, tx1, 100)(s1, idx, t_n, t_c)
    s2, tx2 = tst.create_sparse_train_state(t_model, _T_CFG, 0, 100, device="cpu")
    s2, m2 = tst.make_deferred_sparse_steps(t_model, _T_CFG, tx2, 100, 1)(s2, idx[None], t_n, t_c)
    assert set(m2) == {"loss"} and m2["loss"].shape == (1,)
    assert float(m2["loss"][0]) == float(m1["loss"])
    for side in ("notice_table", "company_table"):
        for field in ("table", "accumulator"):
            torch.testing.assert_close(getattr(getattr(s2, side), field), getattr(getattr(s1, side), field),
                                       rtol=0, atol=0)


def test_sampled_deferred_matches_hostfed_deferred(tiny_dataset):
    """The window's step-seeded draws, replayed host-side through the
    host-fed deferred window, give the same losses and tables, and the same
    seed replays them bit for bit."""
    ds = tiny_dataset
    t_model = _t_model(_TINY)
    b, w = 64, 3
    t_n, t_c = _t_stores(ds)
    pairs = torch.from_numpy(ds.pairs.astype(np.int64))
    s1, tx1 = tst.create_sparse_train_state(t_model, _T_CFG, 0, 100, device="cpu")
    sampled = tst.make_sampled_deferred_sparse_steps(t_model, _T_CFG, tx1, 100, w, b)
    s1, m1 = sampled(s1, 13, pairs, t_n, t_c)
    assert s1.step == w
    idx = torch.stack([
        pairs[torch.randint(0, len(pairs), (b,), generator=tts.step_generator(torch.device("cpu"), 13, i,
                                                                                tts.SAMPLE_STREAM))]
        for i in range(w)
    ])
    s2, tx2 = tst.create_sparse_train_state(t_model, _T_CFG, 0, 100, device="cpu")
    s2, m2 = tst.make_deferred_sparse_steps(t_model, _T_CFG, tx2, 100, w)(s2, idx, t_n, t_c)
    assert m1["loss"].tolist() == m2["loss"].tolist()
    for side in ("notice_table", "company_table"):
        torch.testing.assert_close(getattr(s1, side).table, getattr(s2, side).table, rtol=0, atol=0)
    s3, tx3 = tst.create_sparse_train_state(t_model, _T_CFG, 0, 100, device="cpu")
    _, m3 = tst.make_sampled_deferred_sparse_steps(t_model, _T_CFG, tx3, 100, w, b)(s3, 13, pairs, t_n, t_c)
    assert m3["loss"].tolist() == m1["loss"].tolist()


def test_deferred_updates_learn(tiny_dataset):
    """Windowed table updates still learn the planted clusters, and the
    tables change once per window."""
    ds = tiny_dataset
    cfg = dataclasses.replace(_T_CFG, optimizer=TOptimizerConfig(learning_rate=3e-3, warmup_ratio=0.0))
    t_model = _t_model(_TINY)
    b, n_inner = 64, 4
    state, tx = tst.create_sparse_train_state(t_model, cfg, 0, 400, device="cpu")
    steps = tst.make_deferred_sparse_steps(t_model, cfg, tx, 400, n_inner)
    t_n, t_c = _t_stores(ds)
    rng = np.random.default_rng(0)
    init_table = state.notice_table.table.clone()
    losses = []
    for _ in range(20):
        idx = torch.from_numpy(ds.pairs[rng.integers(0, len(ds.pairs), size=(n_inner, b))].astype(np.int64))
        state, m = steps(state, idx, t_n, t_c)
        losses.extend(m["loss"].tolist())
    assert state.step == 20 * n_inner
    assert np.mean(losses[-8:]) < np.mean(losses[:8]) - 0.3
    assert not torch.equal(state.notice_table.table, init_table)


def test_sparse_training_learns_and_merges(tiny_dataset):
    """100 per-step sparse steps learn, and the state drives the standard
    eval step with its tables merged back."""
    ds = tiny_dataset
    t_model = _t_model(_TINY)
    tr, va = ds.split(0.2, seed=0)
    state, tx = tst.create_sparse_train_state(t_model, _T_CFG, 0, 200, device="cpu")
    step = tst.make_sparse_train_step(t_model, _T_CFG, tx, 200)
    t_n, t_c = _t_stores(ds)
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(100):
        state, m = step(state, torch.from_numpy(tr[rng.integers(0, len(tr), 64)].astype(np.int64)), t_n, t_c)
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) * 0.8
    merged = tst.merged_params(state)
    assert set(merged) == set(t_model.state_dict()) - {k for k, _ in t_model.named_buffers()}
    val = torch.from_numpy(va[:64].astype(np.int64))
    batch = tts.PairBatch(tts.default_tower_gather(t_n, val[:, 0]), tts.default_tower_gather(t_c, val[:, 1]))
    metrics = tts.make_eval_step(t_model, _T_CFG)(state, batch)
    assert float(metrics["accuracy"]) > 3.0 / 64


def test_sparse_state_needs_rowwise_adagrad():
    cfg = dataclasses.replace(_T_CFG, optimizer=TOptimizerConfig(embedding_optimizer="adamw"))
    with pytest.raises(ValueError, match="rowwise Adagrad"):
        tst.create_sparse_train_state(_t_model(_TINY), cfg, 0, 10, device="cpu")
