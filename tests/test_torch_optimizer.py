"""The port's optimizer against the reference's ``build_optimizer`` (optax):
three updates from identical params and grads, every parameter and every
moment compared after each.

Tolerance: 2e-7 absolute on params of magnitude <= 1 and moments (about two
f32 ulps): both sides run the same f32 formulas; only ``pow``, ``sqrt`` and
``rsqrt`` may round one ulp apart. With ``adam_moment_dtype="bfloat16"`` the
stored first moment is compared at bf16's resolution (one ulp, 2^-8 of
itself), since a value on a rounding boundary may round either way."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jodalrob_twotower_torch.config import OptimizerConfig as TorchOptimizerConfig
from jodalrob_twotower_torch.train import optimizer as topt
from jodalrob_twotower_tpu.config import OptimizerConfig as JaxOptimizerConfig
from jodalrob_twotower_tpu.train import optimizer as jopt

SHAPES = {
    "notice_tower.mlp_0.weight": (6, 5),
    "notice_tower.mlp_0.bias": (6,),
    "notice_tower.bn_0.weight": (6,),
    "notice_tower.bn_0.bias": (6,),
    "notice_tower.embeddings.table": (16, 4),
    "company_tower.embeddings.table": (8, 4),
}
ATOL = 2e-7
TOTAL_STEPS = 40  # warmup over max(int(40 * 0.05), 1) = 2 updates

CASES = {
    "default": {},
    "clip": dict(gradient_clip_norm=0.5),
    "bf16_mu": dict(adam_moment_dtype="bfloat16"),
    "tables_adamw": dict(embedding_optimizer="adamw", embedding_learning_rate=3e-3),
    "emb_lr": dict(embedding_learning_rate=1e-2, weight_decay=0.1, learning_rate=3e-3),
}


def _tree(flat):
    out = {}
    for name, v in flat.items():
        node = out
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_three_updates_match_optax(case):
    kw = CASES[case]
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=s).astype(np.float32) * 0.5 for k, s in SHAPES.items()}
    grads = [
        {k: (rng.normal(size=s) * (2.0 if case == "clip" else 0.1)).astype(np.float32) for k, s in SHAPES.items()}
        for _ in range(3)
    ]
    for g in grads:  # rows untouched by the batch have zero gradient
        g["notice_tower.embeddings.table"][::3] = 0.0

    tx = jopt.build_optimizer(JaxOptimizerConfig(**kw), TOTAL_STEPS)
    j_params = jax.tree.map(jnp.asarray, _tree(params))
    j_state = tx.init(j_params)

    t_opt = topt.build_optimizer(TorchOptimizerConfig(**kw), TOTAL_STEPS)
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    t_state = t_opt.init(t_params)

    for g in grads:
        updates, j_state = tx.update(jax.tree.map(jnp.asarray, _tree(g)), j_state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        t_opt.update(t_params, {k: torch.from_numpy(v) for k, v in g.items()}, t_state)
        want = _flat(j_params)
        for k in SHAPES:
            np.testing.assert_allclose(t_params[k].numpy(), want[k], rtol=0, atol=ATOL, err_msg=k)

    # the moments: optax's state is (clip) -> multi_transform inner states
    inner = j_state[-1] if case == "clip" else j_state
    dense_adam = inner.inner_states["dense"].inner_state[0]
    mu = _flat(dense_adam.mu)
    for k, v in t_state["mu"].items():
        if not topt.is_embedding_table(k):
            assert v.dtype == (torch.bfloat16 if case == "bf16_mu" else torch.float32)
            tol = 2.0**-8 * np.abs(mu[k]).max() if case == "bf16_mu" else ATOL
            np.testing.assert_allclose(v.float().numpy(), mu[k].astype(np.float32), rtol=0, atol=tol, err_msg=k)
            np.testing.assert_allclose(
                t_state["nu"][k].numpy(), _flat(dense_adam.nu)[k], rtol=1e-6, atol=1e-12, err_msg=k
            )
    if case != "tables_adamw":
        acc = _flat(inner.inner_states["table"].inner_state[0].accumulator)
        assert set(t_state["acc"]) == {k for k in SHAPES if "embeddings" in k}
        for k, v in t_state["acc"].items():
            assert v.shape == (SHAPES[k][0], 1)
            np.testing.assert_allclose(v.numpy(), acc[k], rtol=1e-6, atol=0, err_msg=k)
    assert t_state["count"] == 3


def test_warmup_schedule_is_one_indexed_like_the_reference():
    j = jopt.warmup_constant_schedule(1e-3, 1000, 0.05)
    t = topt.warmup_constant_schedule(1e-3, 1000, 0.05)
    for count in [0, 1, 7, 48, 49, 50, 51, 500]:
        assert t(count) == float(j(jnp.int32(count))), count
    assert t(0) > 0.0 and t(49) == t(500) == np.float32(1e-3)


def test_tables_are_the_embeddings_leaves():
    assert topt.is_embedding_table("notice_tower.embeddings.table")
    assert not topt.is_embedding_table("notice_tower.mlp_0.weight")
    assert not topt.is_embedding_table("notice_tower.embeddings_proj.weight")
    opt = topt.build_optimizer(TorchOptimizerConfig(), 10)
    state = opt.init({k: torch.zeros(s) for k, s in SHAPES.items()})
    assert set(state["acc"]) == {"notice_tower.embeddings.table", "company_tower.embeddings.table"}
    assert float(state["acc"]["notice_tower.embeddings.table"][0, 0]) == np.float32(0.1)
    assert "notice_tower.bn_0.bias" in state["mu"]  # weight decay reaches BN leaves too


def test_unknown_embedding_optimizer_raises():
    with pytest.raises(ValueError, match="embedding_optimizer"):
        topt.build_optimizer(dataclasses.replace(TorchOptimizerConfig(), embedding_optimizer="sgd"), 10)
