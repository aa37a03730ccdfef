"""The port's materialized losses, metrics and the fused-loss resolution
against ``jodalrob_twotower_tpu/train/loss.py`` and ``train/metrics.py`` on
the same numpy embeddings.

Tolerance: 1e-6 on losses, gradients and metrics: float32 on both sides,
only the order of the sums differs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jodalrob_twotower_torch.config import LossConfig as TorchLossConfig
from jodalrob_twotower_torch.train import loss as tloss
from jodalrob_twotower_torch.train import metrics as tmetrics
from jodalrob_twotower_tpu.train import loss as jloss
from jodalrob_twotower_tpu.train import metrics as jmetrics

ATOL = 1e-6


def _emb(seed, b=48, d=16):
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(b, d)).astype(np.float32)
    c = (n + 0.7 * rng.normal(size=(b, d))).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    return n, c


@pytest.mark.parametrize("eps", [0.0, 0.1])
@pytest.mark.parametrize("tau", [1.0, 0.05])
def test_materialized_ce_matches_jax(eps, tau):
    n, c = _emb(1)

    def j_loss(nn_, cc):
        return jloss.bidirectional_ce_loss(nn_, cc, temperature=tau, label_smoothing=eps)[0]

    want, (want_dn, want_dc) = jax.value_and_grad(j_loss, argnums=(0, 1))(jnp.asarray(n), jnp.asarray(c))
    n_t = torch.from_numpy(n).requires_grad_(True)
    c_t = torch.from_numpy(c).requires_grad_(True)
    loss, sim = tloss.bidirectional_ce_loss(n_t, c_t, temperature=tau, label_smoothing=eps)
    assert sim.shape == (48, 48)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=0, atol=ATOL * 10)
    np.testing.assert_allclose(n_t.grad.numpy(), np.asarray(want_dn), rtol=0, atol=ATOL)
    np.testing.assert_allclose(c_t.grad.numpy(), np.asarray(want_dc), rtol=0, atol=ATOL)


@pytest.mark.parametrize("margin", [0.0, 0.3])
def test_cosine_loss_matches_jax(margin):
    n, c = _emb(2)
    want, want_sim = jloss.compute_loss("cosine_embedding", jnp.asarray(n), jnp.asarray(c), margin=margin)
    got, sim = tloss.compute_loss("cosine_embedding", torch.from_numpy(n), torch.from_numpy(c), margin=margin)
    np.testing.assert_allclose(got.item(), float(want), rtol=0, atol=ATOL)
    np.testing.assert_allclose(sim.numpy(), np.asarray(want_sim), rtol=0, atol=ATOL)


def test_unknown_loss_type_raises():
    n, c = _emb(3)
    with pytest.raises(ValueError, match="unknown loss_type"):
        tloss.compute_loss("hinge", torch.from_numpy(n), torch.from_numpy(c))


def test_in_batch_metrics_match_jax():
    n, c = _emb(4)
    sim = (n @ c.T / 0.1).astype(np.float32)
    want = jmetrics.in_batch_metrics(jnp.asarray(sim))
    got = tmetrics.in_batch_metrics(torch.from_numpy(sim))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6, atol=ATOL, err_msg=k)
    np.testing.assert_array_equal(
        tmetrics.diagonal_ranks(torch.from_numpy(sim)).numpy(), np.asarray(jmetrics.diagonal_ranks(jnp.asarray(sim)))
    )
    assert tmetrics.random_baselines(48) == jmetrics.random_baselines(48)


@pytest.mark.parametrize(
    "use,loss_type,device,want",
    [
        ("auto", "cross_entropy", "cuda", True),
        ("auto", "cross_entropy", "cpu", False),
        ("auto", "cosine_embedding", "cuda", False),
        (True, "cross_entropy", "cpu", True),
        (False, "cross_entropy", "cuda", False),
    ],
)
def test_resolve_use_fused(use, loss_type, device, want):
    cfg = dataclasses.replace(TorchLossConfig(), use_fused_logits=use, loss_type=loss_type)
    assert tloss.resolve_use_fused(cfg, device) is want
