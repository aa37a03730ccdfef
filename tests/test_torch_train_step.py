"""The port's train step against ``make_indexed_train_step`` of the
reference, from the same flax variables (every leaf drawn from numpy), the
same stores and the same pair indices, dropout 0: the first step's gradients
leaf by leaf, then k=3 steps, with the loss of every step and every
parameter and BatchNorm statistic after them.

Configurations and tolerances:
* "f32": float32 compute, materialized loss, gather lookup. Gradients 1e-5
  (relative norm per leaf; float32 on both sides, sums in another order),
  losses 1e-5, statistics 1e-5, params 2e-6 - except the few entries whose
  gradient is zero up to rounding, the biases of a layer that feeds a
  training-form BatchNorm (which removes any shift of its input wherever the
  ReLU passes the whole batch): Adam's first step divides such an entry by
  its own magnitude, so it is noise on both sides.
* "bf16-onehot": bfloat16 compute with ``embedding_lookup="onehot"``; the
  reference runs the lookup and the table gradient as Pallas kernels in
  interpret mode, the port their plain versions. The two frameworks round
  bf16 products at other places, and the reference's own bf16 gradients lie
  up to 15% (relative norm) from its float32 ones at this width. So each
  port gradient must lie no farther from the reference's float32 gradient
  than twice the reference's bf16 gradient does, plus 0.02; losses 1e-2
  (bf16 activations scaled by 1/tau = 5); statistics 1e-4.
* "f32-fused": float32 compute, the port's fused loss (the plain versions
  of the CE kernels, bf16 operands) against the reference's materialized
  float32 loss: gradients 1e-2 (bf16 rounding of S's operands, 2^-9
  relative, about 3e-3 measured), losses 5e-4, statistics 5e-5.
After three steps every parameter lies within three Adam steps of either
sign of the reference's (2 * 3 * lr): past the first step, Adam's
normalized update moves with the gradient's rounding in the two bf16
configurations. Each leaf's change over the three steps must also match
the reference's change by relative norm, within 0.15 (f32), 0.35
(bf16-onehot) and 0.25 (f32-fused), 1.5 to 2 times the largest measured
on any leaf (0.074, 0.23, 0.14: a bias before a training-form BatchNorm, whose
update is rounding noise): a leaf that does not move scores 1, one that
moves the wrong way 2.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.config import LossConfig as TLossConfig
from jodalrob_twotower_torch.config import OptimizerConfig as TOptimizerConfig
from jodalrob_twotower_torch.config import TrainConfig as TTrainConfig
from jodalrob_twotower_torch.convert import flax_to_state_dict, state_dict_to_flax
from jodalrob_twotower_torch.data.types import PairBatch as TPairBatch
from jodalrob_twotower_torch.data.types import TowerBatch as TTowerBatch
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel as TTwoTowerModel
from jodalrob_twotower_torch.serving.service import FrozenState
from jodalrob_twotower_torch.train import train_step as tts
from jodalrob_twotower_tpu.config import LossConfig as JLossConfig
from jodalrob_twotower_tpu.config import OptimizerConfig as JOptimizerConfig
from jodalrob_twotower_tpu.config import TrainConfig as JTrainConfig
from jodalrob_twotower_tpu.data.types import PairBatch, TowerBatch
from jodalrob_twotower_tpu.models.two_tower import TwoTowerModel as JTwoTowerModel
from jodalrob_twotower_tpu.train import train_step as jts

from torch_parity import flax_variables, model_configs, schemas, side_inputs

N_ROWS = 300
STEPS = 3
TOTAL_STEPS = 10  # warmup over one update: lr 1e-3 from the first step
LR = 1e-3

CASES = {
    # name: (model overrides, port's use_fused_logits, batch, grad tol, loss tol, stats tol, change tol)
    "f32": (dict(compute_dtype="float32", embedding_lookup="auto"), False, 64, 1e-5, 1e-5, 1e-5, 0.15),
    "bf16-onehot": (dict(compute_dtype="bfloat16", embedding_lookup="onehot"), "auto", 64, None, 1e-2, 1e-4, 0.35),
    "f32-fused": (dict(compute_dtype="float32", final_embedding_dim=128), True, 128, 1e-2, 5e-4, 5e-5, 0.25),
}
# f32: the share of a leaf's entries allowed past 2e-6 (the noise-floor
# biases before a training-form BatchNorm: 2 of 32 entries here)
NOISE_SHARE = 0.07


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small CPU steps run fastest on one thread, and several test workers
    sharing the cores do not oversubscribe them. Module scope, so that the
    module-scoped runs below take it too."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _setup(model_kw, use_fused_t, temperature=0.2, dropout=0.0):
    j_schema, t_schema = schemas()
    j_mcfg, t_mcfg = model_configs(**{**model_kw, "dropout_rate": dropout})
    j_cfg = JTrainConfig(
        model=j_mcfg, loss=JLossConfig(temperature=temperature, use_fused_logits=False),
        optimizer=JOptimizerConfig(learning_rate=LR),
    )
    t_cfg = TTrainConfig(
        model=t_mcfg, loss=TLossConfig(temperature=temperature, use_fused_logits=use_fused_t),
        optimizer=TOptimizerConfig(learning_rate=LR),
    )
    rng = np.random.default_rng(21)
    j_model = JTwoTowerModel(j_schema, j_mcfg)
    variables = flax_variables(j_model, j_schema, rng)
    stores = {side: side_inputs(j_schema.side(side), rng, N_ROWS) for side in ("notice", "company")}
    t_model = TTwoTowerModel(t_schema, t_mcfg)
    t_model.load_state_dict(flax_to_state_dict(t_model, variables["params"], variables["batch_stats"]))
    return j_model, j_cfg, variables, t_model, t_cfg, stores


def _run_jax(j_model, j_cfg, variables, stores, pair_idx):
    example = PairBatch(
        TowerBatch(stores["notice"][0][:4], stores["notice"][1][:4]),
        TowerBatch(stores["company"][0][:4], stores["company"][1][:4]),
    )
    state, tx = jts.create_train_state(j_model, j_cfg, jax.random.PRNGKey(0), example, TOTAL_STEPS)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = state.replace(
        params=params, batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params),
    )
    step = jts.make_indexed_train_step(j_model, j_cfg, tx, jit=False, with_metrics=False)
    ns = tuple(jnp.asarray(x) for x in stores["notice"])
    cs = tuple(jnp.asarray(x) for x in stores["company"])
    losses = []
    for idx in pair_idx:
        state, m = step(state, jnp.asarray(idx), ns, cs)
        losses.append(float(m["loss"]))
    return losses, jax.device_get(state.params), jax.device_get(state.batch_stats)


def _run_torch(t_model, t_cfg, stores, pair_idx, *, seed=0):
    state, tx = tts.create_train_state(t_model, t_cfg, seed, TOTAL_STEPS, device="cpu")
    step = tts.make_indexed_train_step(t_model, t_cfg, tx, with_metrics=False)
    ns = tuple(torch.from_numpy(x) for x in stores["notice"])
    cs = tuple(torch.from_numpy(x) for x in stores["company"])
    losses = []
    for idx in pair_idx:
        state, m = step(state, torch.from_numpy(idx.astype(np.int64)), ns, cs)
        losses.append(float(m["loss"]))
    return losses, state


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else {f"{prefix}{k}": np.asarray(v)})
    return out


def _first_step_grads(j_model, j_cfg, variables, t_model, t_cfg, stores, idx):
    """(reference grads, port grads) of one training-form step, as flat
    {flax path: array} maps."""
    def j_batch(side, col):
        return TowerBatch(jnp.asarray(stores[side][0][idx[:, col]]), jnp.asarray(stores[side][1][idx[:, col]]))

    batch = PairBatch(j_batch("notice", 0), j_batch("company", 1))

    def j_loss(params):
        return jts._forward_loss(
            j_model, j_cfg, params, variables["batch_stats"], batch, jax.random.PRNGKey(0), train=True
        )[0]

    want = jax.grad(j_loss)(jax.tree.map(jnp.asarray, variables["params"]))

    def t_batch(side, col):
        return TTowerBatch(torch.from_numpy(stores[side][0][idx[:, col]]), torch.from_numpy(stores[side][1][idx[:, col]]))

    state, _ = tts.create_train_state(t_model, t_cfg, 0, TOTAL_STEPS, device="cpu")
    _, _, grads = tts.loss_and_grads(t_model, t_cfg, state, TPairBatch(t_batch("notice", 0), t_batch("company", 1)))
    got, _ = state_dict_to_flax(t_model, {**grads, **state.batch_stats})
    return _leaves(jax.device_get(want)), _leaves(got)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("case", list(CASES))
def test_first_step_gradients_match_the_reference(case):
    model_kw, use_fused_t, b, grad_tol, _, _, _ = CASES[case]
    setup = _setup(model_kw, use_fused_t)
    idx = np.random.default_rng(5).integers(0, N_ROWS, size=(b, 2))
    want, got = _first_step_grads(*setup, idx)
    assert set(got) == set(want)
    if grad_tol is not None:
        for k in want:
            assert _rel(got[k], want[k]) <= grad_tol, (k, _rel(got[k], want[k]))
        return
    # bf16: measured against the reference's own float32 gradients
    want32, _ = _first_step_grads(*_setup({**model_kw, "compute_dtype": "float32"}, use_fused_t), idx)
    for k in want:
        budget = 2 * _rel(want[k], want32[k]) + 0.02
        assert _rel(got[k], want32[k]) <= budget, (k, _rel(got[k], want32[k]), budget)


@pytest.mark.parametrize("case", list(CASES))
def test_indexed_steps_match_the_reference(case):
    model_kw, use_fused_t, b, _, loss_tol, stats_tol, change_tol = CASES[case]
    j_model, j_cfg, variables, t_model, t_cfg, stores = _setup(model_kw, use_fused_t)
    rng = np.random.default_rng(5)
    pair_idx = [rng.integers(0, N_ROWS, size=(b, 2)).astype(np.int32) for _ in range(STEPS)]
    want_losses, want_params, want_stats = _run_jax(j_model, j_cfg, variables, stores, pair_idx)
    got_losses, state = _run_torch(t_model, t_cfg, stores, pair_idx)
    assert state.step == STEPS
    np.testing.assert_allclose(got_losses, want_losses, rtol=0, atol=loss_tol)
    params, stats = state_dict_to_flax(t_model, state.state_dict)
    got, want = _leaves(params), _leaves(want_params)
    start = _leaves(variables["params"])
    assert set(got) == set(want)
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 2 * STEPS * LR + 1e-6, (k, diff.max())
        change = _rel(got[k] - start[k], want[k] - start[k])
        assert change <= change_tol, (k, change)
        if case == "f32":
            assert (diff > 2e-6).mean() <= NOISE_SHARE, (k, (diff > 2e-6).mean())
    got, want = _leaves(stats), _leaves(want_stats)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=stats_tol, err_msg=k)


def test_batchnorm_running_statistics_after_one_step():
    """flax's update: biased batch variance, running = 0.99 running + 0.01
    batch, in f32."""
    j_model, j_cfg, variables, t_model, t_cfg, stores = _setup(
        dict(compute_dtype="float32", embedding_lookup="auto"), False
    )
    idx = [np.random.default_rng(6).integers(0, N_ROWS, size=(32, 2)).astype(np.int32)]
    _, _, want_stats = _run_jax(j_model, j_cfg, variables, stores, idx)
    _, state = _run_torch(t_model, t_cfg, stores, idx)
    _, stats = state_dict_to_flax(t_model, state.state_dict)
    got, want = _leaves(stats), _leaves(want_stats)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    before = _leaves(variables["batch_stats"])
    assert all(not np.allclose(got[k], before[k]) for k in want)


def _sampled(t_model, t_cfg, stores, n_inner, calls, *, seed, sample_seed=7, b=32):
    state, tx = tts.create_train_state(t_model, t_cfg, seed, 100, device="cpu")
    steps = tts.make_sampled_train_steps(t_model, t_cfg, tx, n_inner, b)
    ns = tuple(torch.from_numpy(x) for x in stores["notice"])
    cs = tuple(torch.from_numpy(x) for x in stores["company"])
    pairs = torch.from_numpy(np.random.default_rng(8).integers(0, N_ROWS, size=(500, 2)))
    losses = []
    for _ in range(calls):
        state, m = steps(state, sample_seed, pairs, ns, cs)
        assert m["loss"].shape == (n_inner,)
        losses.extend(m["loss"].tolist())
    return losses, state


def test_one_call_of_n_inner_steps_equals_n_single_calls():
    _, _, _, t_model, t_cfg, stores = _setup(dict(compute_dtype="float32"), "auto", dropout=0.1)
    losses4, s4 = _sampled(t_model, t_cfg, stores, 4, 1, seed=3)
    losses1, s1 = _sampled(t_model, t_cfg, stores, 1, 4, seed=3)
    assert losses4 == losses1 and s4.step == s1.step == 4
    for k, v in s4.state_dict.items():
        torch.testing.assert_close(v, s1.state_dict[k], rtol=0, atol=0)


def test_dropout_runs_are_replayable_from_the_seed():
    _, _, _, t_model, t_cfg, stores = _setup(dict(compute_dtype="bfloat16"), True, dropout=0.3)
    losses_a, a = _sampled(t_model, t_cfg, stores, 2, 2, seed=11)
    losses_b, b = _sampled(t_model, t_cfg, stores, 2, 2, seed=11)
    losses_c, _ = _sampled(t_model, t_cfg, stores, 2, 2, seed=12)
    assert losses_a == losses_b and losses_a != losses_c
    assert all(np.isfinite(losses_a))
    for k, v in a.state_dict.items():
        torch.testing.assert_close(v, b.state_dict[k], rtol=0, atol=0)


def test_dropout_needs_a_generator_in_training_form():
    _, _, _, t_model, _, stores = _setup(dict(compute_dtype="float32"), False, dropout=0.1)
    batch = TTowerBatch(torch.from_numpy(stores["company"][0][:4]), torch.from_numpy(stores["company"][1][:4]))
    with pytest.raises(ValueError, match="torch.Generator"):
        t_model.company_tower(batch, train=True)
    out = t_model.company_tower(batch, train=True, generator=torch.Generator().manual_seed(0))
    assert out.shape == (4, 16) and torch.isfinite(out).all()


def test_resolutions_follow_the_reference_contract():
    cfg = TTrainConfig()
    assert tts.resolve_store_dtype(cfg) is torch.bfloat16
    assert tts.resolve_store_dtype(cfg.replace(model=dataclasses.replace(cfg.model, compute_dtype="float32"))) is None
    assert tts.resolve_dropout_rng_impl(cfg.model) == "threefry"
    assert tts.resolve_dropout_rng_impl(dataclasses.replace(cfg.model, dropout_rng_impl="rbg")) == "rbg"


def test_scanned_and_host_fed_steps_equal_indexed_steps():
    """One call of make_scanned_train_steps over a [3, B, 2] stack, and three
    make_train_step calls on host-assembled PairBatches, equal three indexed
    steps bit for bit; with_metrics adds the in-batch metrics on the
    materialized loss."""
    _, _, _, t_model, t_cfg, stores = _setup(dict(compute_dtype="float32"), False)
    idx = np.random.default_rng(9).integers(0, N_ROWS, size=(STEPS, 32, 2))
    ns = tuple(torch.from_numpy(x) for x in stores["notice"])
    cs = tuple(torch.from_numpy(x) for x in stores["company"])
    want_losses, want = _run_torch(t_model, t_cfg, stores, list(idx))

    state, tx = tts.create_train_state(t_model, t_cfg, 0, TOTAL_STEPS, device="cpu")
    state, m = tts.make_scanned_train_steps(t_model, t_cfg, tx, STEPS)(state, torch.from_numpy(idx), ns, cs)
    assert m["loss"].tolist() == want_losses

    host, tx = tts.create_train_state(t_model, t_cfg, 0, TOTAL_STEPS, device="cpu")
    step = tts.make_train_step(t_model, t_cfg, tx)
    for i in range(STEPS):
        rows = torch.from_numpy(idx[i])
        batch = TPairBatch(
            TTowerBatch(ns[0][rows[:, 0]], ns[1][rows[:, 0]]), TTowerBatch(cs[0][rows[:, 1]], cs[1][rows[:, 1]])
        )
        host, metrics = step(host, batch)
        assert metrics["loss"].item() == want_losses[i]
        assert {"accuracy", "mrr", "recall@10", "similarity_gap"} <= set(metrics)
    for k, v in want.state_dict.items():
        torch.testing.assert_close(state.state_dict[k], v, rtol=0, atol=0)
        torch.testing.assert_close(host.state_dict[k], v, rtol=0, atol=0)


ENCODE_CHUNK = 64
ENCODE_ATOL = 1e-5  # float32 towers on both sides (tests/test_torch_model.py's float32 encode tolerance)


@pytest.mark.parametrize("start", [0, N_ROWS - ENCODE_CHUNK, N_ROWS - ENCODE_CHUNK + 1, N_ROWS - 1])
def test_device_encode_clamps_its_start_like_the_reference(start):
    """``make_device_encode_fn`` against the reference's (jit=False) on the
    same converted weights and store: a start past N - chunk is clamped to
    N - chunk by the reference's dynamic slice, so every call returns
    ``chunk`` rows, the last ``chunk`` of the store."""
    j_model, _, variables, t_model, _, stores = _setup(dict(compute_dtype="float32"), False)
    t_state = FrozenState(flax_to_state_dict(t_model, variables["params"], variables["batch_stats"]))
    j_state = SimpleNamespace(params=jax.tree.map(jnp.asarray, variables["params"]),
                              batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
    for side in ("notice", "company"):
        want = np.asarray(jts.make_device_encode_fn(j_model, side, ENCODE_CHUNK, jit=False)(
            j_state, tuple(jnp.asarray(x) for x in stores[side]), start))
        got = tts.make_device_encode_fn(t_model, side, ENCODE_CHUNK)(
            t_state, tuple(torch.from_numpy(x) for x in stores[side]), start)
        assert got.shape == want.shape == (ENCODE_CHUNK, 16), side
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ENCODE_ATOL, err_msg=side)
