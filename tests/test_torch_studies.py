"""The one-device studies of the port on the CPU, through the kernels'
plain versions, at small sizes:

* ``onehot_rowsharded_study``: its inputs through K1's wrapper (the plain
  version on CPU tensors) against the reference's ``dense_table_lookup_t``
  in Pallas interpret mode, bit-exact (a bf16 rounding of the same f32
  rows), at the study's three (vocab, batch) ratios with small batches;
  the verdict's wire bytes (16,777,216 at B = 8192, K = D = 32).
* ``embgrad_microbench``: its inputs through K2's and K3's wrappers
  against the reference's ``_dense_table_grad(transposed=True)`` and
  ``dense_table_grad_bmajor`` in interpret mode, within 1e-5
  (tests/test_torch_embedding_grad.py's tolerance), K3 equal to K2
  transposed bit for bit.
* ``topk_microbench``: each variant against the reference script's
  expression in ``jnp`` on the same inputs (the script builds its arrays
  at the full size when imported, so its expressions are restated here):
  products within 1e-5 relative, the top-k sets equal, the bf16 product
  within bf16 rounding.
* ``scatter_microbench``: every variant's tables after one call held to
  its group's first within its ATOL, the unsafe put only on rows that occur
  once (it differs where rows repeat), and ``baseline`` and
  ``one_scatter`` against the reference's ``.at[].add`` arithmetic in
  ``jnp``.
* Each study's entry point refuses to time without a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jodalrob_twotower_torch import embgrad_microbench as emb
from jodalrob_twotower_torch import onehot_rowsharded_study as onehot
from jodalrob_twotower_torch import scatter_microbench as scatter
from jodalrob_twotower_torch import topk_microbench as topk
from jodalrob_twotower_torch.ops.embedding_grad import dense_table_grad, dense_table_grad_bmajor, dense_table_lookup
from jodalrob_twotower_tpu.ops import embedding_grad as jeg

torch.set_num_threads(1)


@pytest.mark.parametrize("name,vocab,batch", [(n, v, b // 64) for n, v, b in onehot.SHAPES])
def test_onehot_study_inputs_through_k1_match_the_reference_lookup(name, vocab, batch):
    table, rows, tf = onehot.lookup_inputs(vocab, batch, "cpu")
    got = dense_table_lookup(table, rows, tf)
    want = jeg.dense_table_lookup_t(jnp.asarray(table.numpy()), jnp.asarray(rows.numpy()),
                                    total_rows=table.shape[0], tile_feature=tuple(tf.tolist()), interpret=True)
    assert got.shape == (batch, onehot.K, onehot.D) and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)).transpose(2, 0, 1))


def test_onehot_verdict_counts_the_row_sharded_sum():
    rows = {name: {"ms_per_call": ms} for name, ms in zip((n for n, _, _ in onehot.SHAPES), (0.3, 0.1, 0.2))}
    v = onehot.verdict(rows)
    assert v["extra_wire_bytes_per_step"] == 16_777_216
    assert v["row_sharded_kernel_saving_ms"] == pytest.approx(0.1) and v["full_ms"] == 0.3


def test_embgrad_inputs_through_k2_and_k3_match_the_reference_kernels():
    rows, g, tf = emb.grad_inputs(batch=96, features=4, dim=emb.D, vocab=130, device="cpu")
    total = tf.shape[0] * 128
    k2, k3 = dense_table_grad(rows, g, tf), dense_table_grad_bmajor(rows, g, tf)
    assert torch.equal(k3, k2.t())
    kw = dict(total_rows=total, tile_feature=tuple(tf.tolist()), interpret=True)
    want_t = jeg._dense_table_grad(jnp.asarray(rows.numpy()), jnp.asarray(g.numpy()), transposed=True, **kw)
    want_b = jeg.dense_table_grad_bmajor(jnp.asarray(rows.numpy()), jnp.asarray(g.numpy()), **kw)
    for want in (want_t, want_b):
        assert want.shape == (emb.D, total)
        np.testing.assert_allclose(k3.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def topk_inputs():
    return topk.inputs(q=16, c=512, d=32, device="cpu")


def test_topk_variants_match_the_reference_expressions(topk_inputs):
    q, corpus, ci8 = topk_inputs
    jq, jc, ji8 = (jnp.asarray(x.numpy()) for x in topk_inputs)
    sims = np.asarray(jnp.dot(jq, jc.T, preferred_element_type=jnp.float32))
    np.testing.assert_allclose(topk.mm_only(q, corpus).numpy(), sims, rtol=1e-5, atol=1e-5)
    k = 10
    s, i = topk.mm_topk(q, corpus, k)
    ws, wi = jax.lax.top_k(jnp.asarray(sims), k)
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-5, atol=1e-5)
    assert all(set(a) == set(b) for a, b in zip(i.numpy(), np.asarray(wi)))
    s, gi = topk.mm_maxpool_topk(q, corpus, k, pool=8)
    pooled = jnp.asarray(sims).reshape(16, 512 // 8, 8).max(axis=-1)
    ws, wi = jax.lax.top_k(pooled, k)
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), rtol=1e-5, atol=1e-5)
    assert all(set(a) == set(b) for a, b in zip(gi.numpy(), np.asarray(wi)))
    want = np.asarray(jnp.dot(jq.astype(jnp.bfloat16), ji8.T.astype(jnp.bfloat16), preferred_element_type=jnp.float32))
    got = topk.mm_int8(q, ci8).numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-3)  # torch rounds the product to bf16


@pytest.fixture(scope="module")
def scatter_runs():
    r, d, n = 1000, 8, 512  # ~130 repeated rows
    rows, grads = scatter.inputs(n=n, r=r, d=d, device="cpu")
    refs, out = {}, {}
    for name in (*scatter.UPDATE_VARIANTS, *scatter.SCATTER_VARIANTS):
        state = scatter.tables(r=r, d=d, device="cpu")
        scatter.call(name, state, rows, grads)
        if name == scatter.group_first(name):
            refs[name] = state
        out[name] = (state, scatter.agreement(name, state, refs[scatter.group_first(name)], rows))
    return rows, grads, r, d, out


@pytest.mark.parametrize("name", [*scatter.UPDATE_VARIANTS, *scatter.SCATTER_VARIANTS])
def test_scatter_variants_agree_with_their_group(scatter_runs, name):
    rows, _, _, _, out = scatter_runs
    state, check = out[name]
    assert check["within_tolerance"], check
    assert check["rows_repeated"] > 0  # the inputs repeat rows, as the full size's do
    if name in scatter.UNSAFE:  # it keeps one of each repeated row's updates
        touched, counts = torch.unique(rows, return_counts=True)
        rep = touched[counts > 1]
        want = scatter.result("one_scatter", out["one_scatter"][0])[0]
        assert not torch.allclose(state["table"][rep], want[rep], atol=scatter.ATOL)


def test_scatter_baselines_match_the_reference_arithmetic(scatter_runs):
    rows, grads, r, d, out = scatter_runs
    jr, jg = jnp.asarray(rows.numpy().astype(np.int32)), jnp.asarray(grads.numpy())
    gsq = jnp.mean(jnp.square(jg), axis=-1, keepdims=True)
    acc = jnp.full((r, 1), 0.1, jnp.float32).at[jr].add(gsq)
    denom = jax.lax.rsqrt(jnp.take(acc, jr, axis=0) + 1e-8)
    table = jnp.zeros((r, d), jnp.float32).at[jr].add(-0.01 * jg * denom)
    got_table, got_acc = scatter.result("baseline", out["baseline"][0])
    np.testing.assert_allclose(got_table.numpy(), np.asarray(table), rtol=1e-5, atol=scatter.ATOL)
    np.testing.assert_allclose(got_acc.numpy(), np.asarray(acc), rtol=1e-6)
    one = jnp.zeros((r, d), jnp.float32).at[jr].add(jg)
    np.testing.assert_allclose(out["one_scatter"][0]["table"].numpy(), np.asarray(one), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("module", [onehot, emb, topk, scatter], ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_the_studies_refuse_to_time_without_a_card(module):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])
